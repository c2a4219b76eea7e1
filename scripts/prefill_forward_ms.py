#!/usr/bin/env python3
"""Time one checkout's attention kernels on one GPU, alone and in the model:
the kernels, a fresh prefill forward, and a paged decode step.

    python3 scripts/prefill_forward_ms.py [--root DIR]

* kernels: K1 (``paged_decode_attention``, bf16 pool) and K1q
  (``paged_decode_attention_kvq``, the same draws quantized to an int8
  pool) at the serve shape (8 slots, positions 4095 .. 5, 16-token
  blocks), and K2 (``flash_attention``), K3 (``flash_attention_chunk``)
  and K4 (``flash_attention_chunk_kvq``, int8 cache) at every row of
  ``chip_smoke.py``'s kernel phase, on the inputs it draws from seed 0;
  each by ``chip_smoke.cuda_ms`` (CUDA events around calls queued behind
  a device-side sleep).
* host: the host microseconds a call of the K2, K3 and K4 wrappers takes
  (their first kernel-phase row): 200 calls queued behind a device-side
  sleep, so none waits on the card, timed on the host clock; the least of
  five runs, and all five.
* prefill: random bf16 weights at Meta-Llama-3-8B's published widths
  (``chip_smoke.LLAMA3_8B``; sigma 0.02, seeded), all 32 layers, made on
  the card; ``models.llama.forward`` runs one fresh prefill of 1024 and of
  4096 tokens (batch 1, prompt-end logits only, as the batcher's
  ``prefill_full`` does), with K2 as served (``kernels``) and with an
  attention op that returns q unchanged (``no_attention``), so the
  difference is the attention's share of the prefill (``cuda_ms``).
* decode: one paged decode step (``forward_decode_paged`` and a greedy
  pick) of 8 slots at 512 tokens over the same weights, once with a bf16
  pool (K1) and once with an int8 one (K1q), profiled by
  ``chip_smoke.decode_profile``: device ms a step and the paged attention
  kernels' share (decode and split merge) from ``torch.profiler``, wall ms
  a step on the host clock.

Every tool named here is the ``chip_smoke.py`` beside this script.
``--root`` imports ``nats_llm_studio_tpu_torch`` from another checkout (an
unpacked parent commit, say), so two versions are timed by one yardstick:
run parent, this tree, this tree, parent back to back on one card. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
LAYERS = 32
TOKENS = (1024, 4096)
SEED = 0


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_params(torch, cfg, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def w(*shape):
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        for i in range(shape[0]):  # one layer at a time: f32 draws stay small
            out[i] = (torch.randn(shape[1:], generator=g, device="cuda") * 0.02).to(out.dtype)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device="cuda")

    blocks = {"attn_norm": ones(L, d), "ffn_norm": ones(L, d), "wq": w(L, d, qd),
              "wk": w(L, d, kvd), "wv": w(L, d, kvd), "wo": w(L, qd, d),
              "w_gate": w(L, d, ff), "w_up": w(L, d, ff), "w_down": w(L, ff, d)}
    return {"embed": w(1, cfg.vocab_size, d)[0], "out_norm": ones(d),
            "lm_head": w(1, d, cfg.vocab_size)[0], "blocks": blocks}


def kernel_times(torch, smoke) -> None:
    from nats_llm_studio_tpu_torch.ops import flash_attention as fa
    from nats_llm_studio_tpu_torch.ops import paged_attention as pa

    c = smoke.LLAMA3_8B
    cases = (("paged_decode_attention serve shape", smoke.k1_inputs, pa.paged_decode_attention),
             ("paged_decode_attention_kvq serve shape", smoke.k1q_inputs,
              pa.paged_decode_attention_kvq),
             ("flash_attention T=512", smoke.k2_inputs, fa.flash_attention),
             ("flash_attention T=4096", smoke.k2_long_inputs, fa.flash_attention),
             ("flash_attention B=4 T=256", smoke.k2_group_inputs, fa.flash_attention),
             ("flash_attention_chunk start=1024 KW=2048", smoke.k3_inputs,
              fa.flash_attention_chunk),
             ("flash_attention_chunk start=3840 KW=4096", smoke.k3_long_inputs,
              fa.flash_attention_chunk),
             ("flash_attention_chunk B=4 start=256 KW=512", smoke.k3_group_inputs,
              fa.flash_attention_chunk),
             ("flash_attention_chunk start=512 after a fill", smoke.k3_fill_inputs,
              fa.flash_attention_chunk),
             ("flash_attention_chunk_kvq start=1024 KW=2048", smoke.k4_inputs,
              fa.flash_attention_chunk_kvq),
             ("flash_attention_chunk_kvq start=3840 KW=4096", smoke.k4_long_inputs,
              fa.flash_attention_chunk_kvq),
             ("flash_attention_chunk_kvq B=4 start=256 KW=512", smoke.k4_group_inputs,
              fa.flash_attention_chunk_kvq),
             ("flash_attention_chunk_kvq start=512 after a fill", smoke.k4_fill_inputs,
              fa.flash_attention_chunk_kvq))
    for name, make, kern in cases:
        args = make(torch, torch.Generator(device="cuda").manual_seed(SEED), c)["args"]
        print(f"kernel {name}: {smoke.cuda_ms(torch, lambda: kern(*args)):.4f} ms", flush=True)
        del args
        torch.cuda.empty_cache()


def host_times(torch, smoke, calls: int = 200, runs: int = 5) -> None:
    from nats_llm_studio_tpu_torch.ops import flash_attention as fa

    c = smoke.LLAMA3_8B
    for name, make, kern in (("flash_attention T=512", smoke.k2_inputs, fa.flash_attention),
                             ("flash_attention_chunk start=1024 KW=2048", smoke.k3_inputs,
                              fa.flash_attention_chunk),
                             ("flash_attention_chunk_kvq start=1024 KW=2048", smoke.k4_inputs,
                              fa.flash_attention_chunk_kvq)):
        args = make(torch, torch.Generator(device="cuda").manual_seed(SEED), c)["args"]
        kern(*args)
        us = []
        for _ in range(runs):
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            t0 = time.perf_counter()
            for _ in range(calls):
                kern(*args)
            us.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        print(f"host {name}: {min(us):.2f} us a call "
              f"({', '.join(f'{u:.2f}' for u in us)})", flush=True)
        del args
        torch.cuda.empty_cache()


def model_config(smoke):
    from nats_llm_studio_tpu_torch.models.config import ModelConfig

    w = smoke.LLAMA3_8B
    return ModelConfig(vocab_size=w["vocab"], d_model=w["d_model"], n_heads=w["n_heads"],
                       n_kv_heads=w["n_kv_heads"], head_dim=w["head_dim"], d_ff=w["d_ff"],
                       rope_theta=w["rope_theta"], rms_eps=w["rms_eps"], n_layers=LAYERS,
                       max_seq_len=max(TOKENS))


def prefill_times(torch, smoke, cfg, params) -> None:
    from nats_llm_studio_tpu_torch.models.llama import KERNELS, AttentionOps, forward, make_cache

    no_attention = AttentionOps(lambda q, k, v, scale: q, KERNELS.chunk, KERNELS.chunk_kvq,
                                KERNELS.paged)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    for t in TOKENS:
        toks = torch.randint(0, cfg.vocab_size, (1, t), generator=g, dtype=torch.int32).cuda()
        k_cache, v_cache = make_cache(cfg, 1, t, device="cuda")
        pos0 = torch.zeros((1,), dtype=torch.int32)
        last = torch.tensor([t - 1])
        times = {}
        for name, attn in (("kernels", KERNELS), ("no_attention", no_attention)):
            times[name] = smoke.cuda_ms(
                torch, lambda attn=attn: forward(params, cfg, toks, k_cache, v_cache, pos0,
                                                 logit_positions=last, fresh_prefill=True,
                                                 attn=attn),
                warmup=2, iters=5)
        share = times["kernels"] - times["no_attention"]
        print(f"prefill T={t}: kernels {times['kernels']:.3f} ms; no_attention "
              f"{times['no_attention']:.3f} ms; attention {share:.3f} ms "
              f"({share / times['kernels']:.1%})", flush=True)
        del k_cache, v_cache


def decode_times(torch, smoke, cfg, params) -> None:
    """``chip_smoke.decode_profile`` of one decode step, 8 slots at 512
    tokens, with a bf16 pool and with an int8 one."""
    for kv in ("none", "int8"):
        eng = types.SimpleNamespace(cfg=cfg.with_(kv_quant=kv),
                                    batcher=types.SimpleNamespace(params=params))
        prof = smoke.decode_profile(torch, eng)
        print(f"decode (kv {kv}) 8 slots x 512 tokens: device "
              f"{prof['device_ms_per_step']:.3f} ms a step, of which paged attention "
              f"{prof['attention_ms_per_step']:.3f} ms; wall {prof['wall_ms_per_step']:.2f} ms "
              f"a step", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose nats_llm_studio_tpu_torch is timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prefill_forward_ms: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    smoke = load_chip_smoke()
    print(f"card: {smoke.card_line()}; root {args.root}; {LAYERS} layers", flush=True)
    kernel_times(torch, smoke)
    host_times(torch, smoke)
    cfg = model_config(smoke)
    params = random_params(torch, cfg, SEED)
    prefill_times(torch, smoke, cfg, params)
    decode_times(torch, smoke, cfg, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
