#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. build   — compile the CUDA kernels under nats_llm_studio_tpu_torch/csrc
             (one nvcc per source, started together) into build/torch_kernels.
2. kernels — hold K1 (paged decode), K1q (the same over an int8 pool), K2
             (flash prefill), K3 (chunk prefill) and K4 (the same over an
             int8 cache) against their plain PyTorch versions on the card in
             bf16 at Llama-3-8B shapes (on each of four input draws, max abs
             error <= 2e-2, and each output row's L2 error <= 1e-2 of its
             norm), and time each beside its bound and a
             scaled_dot_product_attention yardstick; K2, K3 and K4 also at
             the main path's longest calls (a 4096-token fresh prefill, and
             the last 256-token chunk of a 4096-token prompt), at the
             batched admits' shapes (@B4: four rows of 256 tokens, K3/K4 at
             start 256) and, K3/K4, on a partial prefix hit (@fill: start 512
             right after two cached chunks were copied in, exactly); K1 and
             K1q also at a speculative verify's width (@W7: 7 query rows a
             slot, a 28-row bundle a kv head, held by one CTA). Each row
             names the body that ran (body=wgmma: the Hopper body of
             K2/K3/K4 at head dim 128; mma: mma.sync tiles, which K1/K1q
             run at head dim 128; fma: f32 FMAs), read from the wrapper's
             per-body launch counter, and each K1/K1q row has a line of
             its own with the device time of the decode kernel and of its
             split merge (torch.profiler); over the phases below every
             bf16 flash launch must take the Hopper body (the float32
             logits gates run the FMA body), and every bf16 K1 and K1q
             launch the mma.sync body.
3. model   — write a bf16 GGUF at Meta-Llama-3-8B's published widths (the
             meta-llama/Meta-Llama-3-8B config.json: vocab 128256, d_model
             4096, 32 heads, 8 kv heads, head_dim 128, d_ff 14336,
             rope_theta 500000, rms_eps 1e-5; 32 layers) with random weights
             (sigma 0.02) from --seed and a byte-level gpt2 tokenizer, to a
             staging dir outside the models dir; a worker brings it into the
             models dir by pull_model over NATS with its file:// URL
             (URL_PULL_SCHEMES=file).
Then, once with the bf16 KV cache and once with the int8 one
(TPU_KV_QUANT=int8), each through TorchRegistry(ModelStore(models dir),
device="cuda", kv_quant=), whose default decodes through speculative
verifies (k = 6 prompt-lookup drafts at 1-4 live slots):
4. gate    — compare logits of the kernel path with the plain path, for a
             512-token fresh prefill and for the same prompt in two chunks
             followed by one paged decode step (float32: relative L2 <= 2e-2;
             bf16: no more than 1.25 x the plain path's distance to float32).
   Also the group gate: the prompt-end logits of each row of a 4-row
             chunked group prefill against the same prompt prefilled
             alone, and the verify gate: on that pool, one W = 7 forward
             (K1 or K1q at W = 7) against seven W = 1 plain steps over the
             same tokens, by the same two limits. A profile of a decode
             step, of a verify against its seven steps (4 slots x 512
             tokens) and of spec_accept_rows at [8, 7, 128256].
5. serve   — spec on: an embedded broker and the port's Worker answer
             list_models, a short greedy chat twice (identical text), a
             seeded sampled chat twice (identical text), a ~700-token chat
             into the idle batcher (prefill_full), a long chat beside a live
             stream (prefill1, so K3 or K4 runs between decode bursts) and a
             streamed chat; then the spec phase: two greedy chats, one that
             asks for a ~300-token passage back and one a run of 1500 equal
             characters (on which the random model repeats its own tokens),
             twice each (identical texts; verifies ran and accepted drafts;
             the peak device memory over the phase within the load
             estimate). Then, in a registry built
             under SPEC_DECODE=0: the same two chats once (no verify; tok/s
             and text equality against spec on recorded), the prefix cache
             (64 blocks, the registry's default) and group admits
             (prefix_phase): a ~700-token chat
             twice beside a live stream (the second a partial hit with the
             miss's text), a 512-token id prompt twice (the second a full hit
             with the same ids and no prefill program), a wave of four
             ~700-token chats twice (one chunked group admit each, the same
             texts, every pool block free after drop_prefix_cache between
             them), eight short chats (batched short admits) and the
             copy-on-write count; under the bf16 KV cache the ext phase: a
             json_schema chat at temperature 0.9 (JSON that meets the
             schema), a logprobs chat (one entry a token, the top entry the
             chosen token), an n=2 chat over a >256-token prompt (two
             choices, a prefix hit) and a greedy stream beside a
             constrained chat (its text alone). Every envelope must be ok;
             bf16 KV must launch K1, K2 and K3 and not K1q or K4, int8 KV
             K1q, K2 and K4 and not K1 or K3.
5b. tier   — once with each KV cache, SPEC_DECODE=0 (tier_phase): eight
             greedy streams (~240-token prompts, 304 tokens each, ~272
             blocks in all) staggered into an ample pool give each
             stream's text; then a registry built with KV_POOL_BLOCKS=150
             (about half) over the host KV tier: the same eight streams as
             X-Priority: batch (growth parks streams to host memory, admits
             suspend victims) and a ~1200-token premium chat whose admit
             preempts batch streams (reason preempted); every text equal to
             its ample-pool text; then a ~600-token chat hit, demoted by an
             evictor and promoted back (the first hit's text, promoted
             chunks > 0). Gates also: suspended > 0, resumed = suspended, no
             kv_pool shed, the pool free at the end, the KV mode's kernels.
             Recorded: suspend and resume ms a slot, the host tier's bytes,
             the phase's seconds.
6. overload — bf16 KV, 8 slots, the Worker over NATS with the supervisor
             (every 0.5 s) and the debug subjects, a registry with
             ADMIT_QUEUE_LIMIT 16, a 1 s brownout dwell, a DRR quantum of 16
             tokens and max_restarts 1 (overload_phase): deadlines (shed at
             submit with no admit program, shed while queued, aborted
             mid-decode with the pool's blocks back), premium admitted
             before a batch chat queued ahead of it, a burst past the queue
             bound (every chat answered, depth and shed-only sheds, the
             brownout events, gauge and no verify at level >= 1), the
             heartbeat over a ~4000-token chunked prefill, profile naming
             paged_decode_mma_kernel, debug.snapshot and debug.dump, the
             loop's cost with the recorder and the efficiency plane on and
             off, a crash injected into
             a decode program (restart, the same greedy text, memory within
             1%), and a 2-layer model poisoned by two crashes and reset by
             delete_model + pull_model; K1, K2 and K3 must launch, K1q and K4
             must not.
6b. cluster — bf16 KV, 8 slots, SPEC_DECODE=0, two port workers on one
             broker: A in this process and B a ``python -m
             nats_llm_studio_tpu_torch serve`` subprocess over the same models
             dir, each with its own TPU_HBM_BUDGET_BYTES (36 GB: two workers
             share this card only in the smoke), adverts every 0.5 s; the
             port's RouterProcess with the fleet aggregator embedded and the
             port's gateway on a local port (cluster_phase): both adverts
             within two intervals (slots 8, the model, not draining,
             headroom in (0, 1]); A, B, the gateway (unary and SSE) and
             route.chat_model give the same greedy text; a repeated prompt
             is steered to the worker whose heads hold it; A bounces a chat
             whose X-Excluded-Workers names it and the router's RetryPolicy
             serves it on B; the merged exposition carries both workers'
             lmstudio_mfu / lmstudio_mbu; prefill MFU and decode MBU on A (raw
             rates) in (0, 1.05]; admin.drain (deadline 1 s) with three
             streams live on A cuts at least one, each cut stream ends in
             the retryable draining envelope and its retry is served by B
             with B's undrained text, A's next
             advert says draining and its memory_allocated is back at its
             value before the load within 1% of the engine; A's device-time
             ledger sums to dispatch_ms_total within 10% and its served
             tokens equal the tokens delivered; K1, K2 and K3 launched, K1q
             and K4 not; no hbm_drift event in this process through the
             serve, spec, prefix, overload and cluster phases, nor in B.
             Recorded: the advert spacing, TTFT through the gateway and
             direct, the drain's seconds and cut streams, MFU/MBU, and the
             analytic bytes of a decode step over decode_profile's device ms.
7. lifecycle — bf16 KV, an embedded broker with the object-store module and
             a worker whose ModelStore reaches the bucket: (a) a 2-layer GGUF
             at the same widths is published with ModelStore.publish_model
             and brought in by sync_model_from_bucket (sha256 must match the
             published digest); (b) with the budget read from the card, the
             32-layer model loads (the rise in memory_allocated must match
             the estimate's params + pool, the prefix blocks included,
             within 1%), and a ~4000-token chat into the idle batcher, then
             four concurrent ~4000-token chats (one chunked group admit),
             must peak within the estimate (parallel/memory.py
             estimate_load_bytes); (c) under a budget of the 32-layer
             estimate plus half the 2-layer one a chat to the 2-layer model
             is refused with "insufficient device memory" while a stream
             holds the 32-layer engine (the stream finishes intact; the
             shrink tier drops the 32-layer engine's prefix cache first),
             and evicts it once idle (its pool all free at the eviction,
             >= 98% of its params + pool returned); (d)
             delete_model of the loaded 2-layer model returns >= 98% of its
             bytes, after which a chat to it is "model not found" and
             list_models omits it; the 32-layer model leaves by delete_model.

Kernel bounds use the card's peaks from the port's table
(obs/roofline.py resolve_chip_peaks of torch.cuda.get_device_name), the
same the efficiency plane's MFU/MBU use. The second-to-last lines are the
kernels JSON and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (peak dense bf16 FLOP/s, peak HBM bytes/s) of the card, from the port's
# table (obs/roofline.py resolve_chip_peaks), which the efficiency plane's
# MFU/MBU read too; main() sets it before the kernel phase
PEAKS: tuple[float, float] | None = None
# the staged file's name: a file:// pull files it under downloads/<stem>
STAGED = "llama3-8b-random.gguf"
MID = "downloads/llama3-8b-random"
MID2 = "smoke/llama3-8b-2layer"  # the lifecycle phase's bucket model
FREED_SHARE = 0.98  # of an engine's params + pool, returned on evict and delete
BF16_DRIFT = 1.25  # bf16 kernel path's distance to f32, over the plain path's

# Meta-Llama-3-8B's published widths (meta-llama/Meta-Llama-3-8B config.json)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                 d_ff=14336, rope_theta=500000.0, rms_eps=1e-5, context=8192, n_layers=32)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a device-side sleep (~50 ms), so the calls run back to
    back on the card however long the host takes to launch them; without
    it a kernel of a few tens of microseconds times its wrapper's host
    cost. A call that waits on the card only drains the queue early."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_us(torch, fn, reps: int = 50) -> dict[str, float]:
    """{kernel name: device µs a call of ``fn``} as torch.profiler sees
    them over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0}


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    peak_flops, peak_bytes = PEAKS
    t_bytes = bytes_moved / peak_bytes * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels --------------------------------------------------------


ERR_SEEDS = 4  # the error check draws inputs from seed, seed + 1, ...
ABS_LIMIT = 2e-2  # max abs error: the bf16 tolerance of tests/test_flash_attention.py:184
# Each output row's (one query row of one head) L2 error over its norm. With
# thousands of live keys a row's values are ~1e-2, the size of ABS_LIMIT, so
# only a limit scaled to the row sees a dropped key tile or a shifted
# diagonal in the late rows of the long shapes.
ROW_REL_LIMIT = 1e-2


def row_rel_err(got, want) -> float:
    """The largest L2 error of an output row over that row's L2 norm."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def k1_inputs(torch, g, c: dict, quant: bool = False, w: int = 1) -> dict:
    """K1 at the serving shape: B=8 slots, mixed contexts up to 4096,
    16-token blocks in a shuffled pool, layer 7, ``w`` query rows a slot
    (a verify's k + 1), each slot's positions leaving room for its w fresh
    rows. With ``quant`` (K1q) the pool is ``quantize_rows`` of the same
    draws: int8 codes, f32 scales."""
    from nats_llm_studio_tpu_torch.ops.kvcache import quantize_rows

    hq, hkv, d, L = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["n_layers"]
    dev, bf = "cuda", torch.bfloat16
    T, nbt, layer = 16, 4096 // 16, 7
    pos_l = [min(p, 4096 - w) for p in (4095, 3001, 2048, 1500, 777, 300, 64, 5)]
    B = len(pos_l)
    need = [(p + w - 1) // T + 1 for p in pos_l]
    nb = 1 + sum(need)
    kp = torch.randn((nb, L, hkv, T, d), generator=g, device=dev, dtype=bf)
    vp = torch.randn((nb, L, hkv, T, d), generator=g, device=dev, dtype=bf)
    perm = (torch.randperm(nb - 1, generator=g, device=dev) + 1).tolist()
    tbl = torch.zeros((B, nbt), dtype=torch.int32)
    o = 0
    for i, n in enumerate(need):
        tbl[i, :n] = torch.tensor(perm[o:o + n], dtype=torch.int32)
        o += n
    q = torch.randn((B, w, hq, d), generator=g, device=dev, dtype=bf)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    if quant:
        kp, vp = quantize_rows(kp), quantize_rows(vp)
    return dict(args=(q, kp, vp, tbl.to(dev), pos, layer, d ** -0.5),
                shape=f"q[{B},{w},{hq},{d}] bf16 pool[{nb},{L},{hkv},{T},{d}] "
                      f"{'int8 + f32 scales' if quant else 'bf16'} pos={pos_l} layer={layer}")


def k1q_inputs(torch, g, c: dict) -> dict:
    return k1_inputs(torch, g, c, quant=True)


SPEC_K = 6  # the registry's default draft length: a verify is W = k + 1 rows a slot


def k1_verify_inputs(torch, g, c: dict) -> dict:
    """K1 at a speculative verify's width: W = 7 rows a slot, 28 rows a kv
    head with Llama-3's group of 4 (two m16 tiles, one CTA)."""
    return k1_inputs(torch, g, c, w=SPEC_K + 1)


def k1q_verify_inputs(torch, g, c: dict) -> dict:
    return k1_inputs(torch, g, c, quant=True, w=SPEC_K + 1)


def k2_inputs(torch, g, c: dict, t: int = 512) -> dict:
    """K2: a fresh ``t``-token prefill."""
    hq, hkv, d = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    q = torch.randn((1, t, hq, d), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((1, t, hkv, d), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((1, t, hkv, d), generator=g, device="cuda", dtype=torch.bfloat16)
    return dict(args=(q, k, v, d ** -0.5), shape=f"q[1,{t},{hq},{d}] k/v[1,{t},{hkv},{d}] bf16")


def k3_inputs(torch, g, c: dict, start: int = 1024, kw: int = 2048) -> dict:
    """K3: chunk C=256 at ``start`` over the window bucket ``kw`` of a
    4096-token row cache, read in place as a strided view."""
    hq, hkv, d, L = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["n_layers"]
    C, S, layer = 256, 4096, 7
    kc = torch.randn((1, L, hkv, S, d), generator=g, device="cuda", dtype=torch.bfloat16)
    vc = torch.randn((1, L, hkv, S, d), generator=g, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, C, hq, d), generator=g, device="cuda", dtype=torch.bfloat16)
    return dict(args=(q, kc[:, layer, :, :kw], vc[:, layer, :, :kw], d ** -0.5, start),
                shape=f"q[1,{C},{hq},{d}] slab[1,{hkv},{kw},{d}] of cache[1,{L},{hkv},{S},{d}] "
                      f"start={start}")


def k2_long_inputs(torch, g, c: dict) -> dict:
    """K2 at the max_seq bucket: a fresh 4096-token prefill."""
    return k2_inputs(torch, g, c, t=4096)


def k3_long_inputs(torch, g, c: dict) -> dict:
    """K3 on the last 256-token chunk of a 4096-token prompt."""
    return k3_inputs(torch, g, c, start=3840, kw=4096)


def k4_inputs(torch, g, c: dict, start: int = 1024, kw: int = 2048) -> dict:
    """K4: K3's chunk over strided views of an int8 row cache, codes
    [1, L, Hkv, 4096, D] and scales [1, L, Hkv, 4096] quantized from bf16
    draws."""
    from nats_llm_studio_tpu_torch.ops.kvcache import quantize_rows

    hq, hkv, d, L = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["n_layers"]
    C, S, layer = 256, 4096, 7
    kc = quantize_rows(torch.randn((1, L, hkv, S, d), generator=g, device="cuda",
                                   dtype=torch.bfloat16))
    vc = quantize_rows(torch.randn((1, L, hkv, S, d), generator=g, device="cuda",
                                   dtype=torch.bfloat16))
    q = torch.randn((1, C, hq, d), generator=g, device="cuda", dtype=torch.bfloat16)
    return dict(args=(q, kc.q[:, layer, :, :kw], kc.s[:, layer, :, :kw],
                      vc.q[:, layer, :, :kw], vc.s[:, layer, :, :kw], d ** -0.5, start),
                shape=f"q[1,{C},{hq},{d}] bf16 codes[1,{hkv},{kw},{d}] int8 + scales "
                      f"[1,{hkv},{kw}] f32 of cache[1,{L},{hkv},{S},{d}] start={start}")


def k4_long_inputs(torch, g, c: dict) -> dict:
    """K4 on the last 256-token chunk of a 4096-token prompt."""
    return k4_inputs(torch, g, c, start=3840, kw=4096)


def k2_group_inputs(torch, g, c: dict) -> dict:
    """K2 at a batched short admit's shape: four fresh 256-token prompts."""
    hq, hkv, d = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    q = torch.randn((4, 256, hq, d), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((4, 256, hkv, d), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((4, 256, hkv, d), generator=g, device="cuda", dtype=torch.bfloat16)
    return dict(args=(q, k, v, d ** -0.5), shape=f"q[4,256,{hq},{d}] k/v[4,256,{hkv},{d}] bf16")


def k3_group_inputs(torch, g, c: dict, quant: bool = False) -> dict:
    """K3 (K4 with ``quant``) at a batched chunked admit's second chunk:
    q[4, 256] at start 256 over the window [:512] of a 4-row, 4096-token
    row cache (the group's [mpad, L, Hkv, max_seq, D] transient)."""
    from nats_llm_studio_tpu_torch.ops.kvcache import quantize_rows

    hq, hkv, d, L = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["n_layers"]
    B, C, S, kw, start, layer = 4, 256, 4096, 512, 256, 7
    q = torch.randn((B, C, hq, d), generator=g, device="cuda", dtype=torch.bfloat16)
    kc, vc = (torch.randn((B, L, hkv, S, d), generator=g, device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    shape = f"q[{B},{C},{hq},{d}] slab[{B},{hkv},{kw},{d}] of cache[{B},{L},{hkv},{S},{d}]"
    if not quant:
        return dict(args=(q, kc[:, layer, :, :kw], vc[:, layer, :, :kw], d ** -0.5, start),
                    shape=f"{shape} start={start}")
    kc, vc = quantize_rows(kc), quantize_rows(vc)
    return dict(args=(q, kc.q[:, layer, :, :kw], kc.s[:, layer, :, :kw], vc.q[:, layer, :, :kw],
                      vc.s[:, layer, :, :kw], d ** -0.5, start),
                shape=f"{shape} int8 + f32 scales start={start}")


def k4_group_inputs(torch, g, c: dict) -> dict:
    return k3_group_inputs(torch, g, c, quant=True)


def k3_fill_inputs(torch, g, c: dict, quant: bool = False) -> dict:
    """K3 (K4 with ``quant``) on a partial prefix hit: two cached 256-token
    chunks (16-token pool blocks in a shuffled pool) copied into a fresh
    4096-token row cache by the batcher's ``fill_row_chunk`` ops
    (``kv_pool_read_blocks`` + ``kv_copy_slice``), then the suffix chunk
    at start 512 over the window [:1024]. The fill must be exact."""
    from nats_llm_studio_tpu_torch.ops.kvcache import (
        is_quantized,
        kv_copy_slice,
        kv_pool_read_blocks,
        kv_pool_zeros,
        quantize_rows,
    )

    hq, hkv, d, L = c["n_heads"], c["n_kv_heads"], c["head_dim"], c["n_layers"]
    C, S, T, kw, start, layer = 256, 4096, 16, 1024, 512, 7
    nb = 1 + 2 * C // T
    pools = [torch.randn((nb, L, hkv, T, d), generator=g, device="cuda", dtype=torch.bfloat16)
             for _ in range(2)]
    if quant:
        pools = [quantize_rows(p) for p in pools]
    perm = (torch.randperm(nb - 1, generator=g, device="cuda") + 1).int().cpu()
    rows = [kv_pool_zeros((1, L, hkv, S, d), torch.bfloat16, "cuda", quant=quant)
            for _ in range(2)]
    for j in range(2):
        bids = perm[j * C // T:(j + 1) * C // T]
        for row, pool in zip(rows, pools):
            kv_copy_slice(row, kv_pool_read_blocks(pool, bids), (0, 0, 0, j * C, 0))
    # exact: the row's [0, 512) is the gathered blocks, bit for bit
    for row, pool in zip(rows, pools):
        for r, p in ((row.q, pool.q), (row.s, pool.s)) if is_quantized(row) else ((row, pool),):
            want = p[perm.long()].movedim(0, 2).flatten(2, 3)[None]
            if not torch.equal(r[:, :, :, :2 * C], want):
                raise AssertionError("fill_row_chunk: the row does not hold the cached blocks")
    q = torch.randn((1, C, hq, d), generator=g, device="cuda", dtype=torch.bfloat16)
    shape = (f"q[1,{C},{hq},{d}] slab[1,{hkv},{kw},{d}] of cache[1,{L},{hkv},{S},{d}] "
             f"start={start} after two cached chunks")
    kr, vr = rows
    if not quant:
        return dict(args=(q, kr[:, layer, :, :kw], vr[:, layer, :, :kw], d ** -0.5, start),
                    shape=shape)
    return dict(args=(q, kr.q[:, layer, :, :kw], kr.s[:, layer, :, :kw], vr.q[:, layer, :, :kw],
                      vr.s[:, layer, :, :kw], d ** -0.5, start),
                shape=shape.replace("] start", "] int8 + f32 scales start"))


def k4_fill_inputs(torch, g, c: dict) -> dict:
    return k3_fill_inputs(torch, g, c, quant=True)


def dense_pool_kv(torch, pool, tbl, layer: int, dtype):
    """The [B, Hkv, NB*T, D] K or V of each slot gathered through its
    table, dequantized to ``dtype`` from a KVQ pool (not timed)."""
    from nats_llm_studio_tpu_torch.ops.kvcache import KVQ, dequantize, is_quantized

    idx = tbl.long()
    x = (dequantize(KVQ(pool.q[idx, layer], pool.s[idx, layer]), dtype)
         if is_quantized(pool) else pool[idx, layer])
    b, nb, hkv, t, d = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * t, d)


def kernel_phase(torch, seed: int) -> dict[str, dict]:
    """Each kernel against its plain version on ERR_SEEDS input draws (the
    gates are the largest max abs error and the largest row error over its
    row's norm), then timed on the first draw
    beside its bound and a scaled_dot_product_attention yardstick. Keys are
    row names; K2, K3 and K4 have a second row at the main path's longest
    call (``@T4096``, ``@KW4096``), and each row's ``kern`` is the wrapper
    whose launch counter it reports."""
    import torch.nn.functional as F

    from nats_llm_studio_tpu_torch.ops import flash_attention as fa
    from nats_llm_studio_tpu_torch.ops import paged_attention as pa
    from nats_llm_studio_tpu_torch.ops.kvcache import KVQ, dequantize

    c = LLAMA3_8B
    hq, hkv, d = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    group = hq // hkv
    dev = "cuda"
    cases = {
        "paged_decode_attention": (k1_inputs, pa.paged_decode_attention,
                                   pa.paged_decode_attention_plain),
        "paged_decode_attention_kvq": (k1q_inputs, pa.paged_decode_attention_kvq,
                                       pa.paged_decode_attention_plain),
        # the speculative verify's width
        "paged_decode_attention@W7": (k1_verify_inputs, pa.paged_decode_attention,
                                      pa.paged_decode_attention_plain),
        "paged_decode_attention_kvq@W7": (k1q_verify_inputs, pa.paged_decode_attention_kvq,
                                          pa.paged_decode_attention_plain),
        "flash_attention": (k2_inputs, fa.flash_attention, fa.flash_attention_plain),
        "flash_attention@T4096": (k2_long_inputs, fa.flash_attention,
                                  fa.flash_attention_plain),
        "flash_attention_chunk": (k3_inputs, fa.flash_attention_chunk,
                                  fa.flash_attention_chunk_plain),
        "flash_attention_chunk@KW4096": (k3_long_inputs, fa.flash_attention_chunk,
                                         fa.flash_attention_chunk_plain),
        "flash_attention_chunk_kvq": (k4_inputs, fa.flash_attention_chunk_kvq,
                                      fa.flash_attention_chunk_kvq_plain),
        "flash_attention_chunk_kvq@KW4096": (k4_long_inputs, fa.flash_attention_chunk_kvq,
                                             fa.flash_attention_chunk_kvq_plain),
        # the prefix cache's and the group admits' shapes
        "flash_attention@B4": (k2_group_inputs, fa.flash_attention, fa.flash_attention_plain),
        "flash_attention_chunk@B4": (k3_group_inputs, fa.flash_attention_chunk,
                                     fa.flash_attention_chunk_plain),
        "flash_attention_chunk_kvq@B4": (k4_group_inputs, fa.flash_attention_chunk_kvq,
                                         fa.flash_attention_chunk_kvq_plain),
        "flash_attention_chunk@fill": (k3_fill_inputs, fa.flash_attention_chunk,
                                       fa.flash_attention_chunk_plain),
        "flash_attention_chunk_kvq@fill": (k4_fill_inputs, fa.flash_attention_chunk_kvq,
                                           fa.flash_attention_chunk_kvq_plain),
    }
    results: dict[str, dict] = {}
    for name, (make, kern, plain) in cases.items():
        errs, rel = [], []
        # the body the wrapper ran, read from its per-body launch counter
        bodies = kern.body_launches
        for i in range(ERR_SEEDS):
            x = make(torch, torch.Generator(device=dev).manual_seed(seed + i), c)
            before = dict(bodies)
            got, want = kern(*x["args"]), plain(*x["args"])
            if i == 0:
                body = "+".join(k for k in bodies if bodies[k] != before[k])
            errs.append(float((got.float() - want.float()).abs().max()))
            rel.append(row_rel_err(got, want))
            if i == 0:
                first = x
            del x, got, want
        results[name] = dict(max_abs_err=max(errs), errs=errs, max_row_rel_err=max(rel),
                             rels=rel, shape=first["shape"], args=first["args"], kern=kern,
                             plain=plain, body=body)
        torch.cuda.empty_cache()

    # K1, K1q: bytes of each slot's live K/V rows, read once (bf16 rows of D
    # elements, or D int8 codes and one f32 scale); operations of every
    # query row over the keys up to its position. SDPA over the same K/V
    # already gathered dense (and dequantized to bf16 for K1q; neither is
    # timed), ragged lengths and the rows' causal fronts as a boolean mask
    for name, row_bytes in (("paged_decode_attention", d * 2),
                            ("paged_decode_attention_kvq", d + 4),
                            ("paged_decode_attention@W7", d * 2),
                            ("paged_decode_attention_kvq@W7", d + 4)):
        r = results[name]
        q, kp, vp, tbl, pos, layer, scale = r["args"]
        B, w = q.shape[:2]
        keys = int((pos.long() + w).sum())
        pairs = int((w * pos.long() + w * (w + 1) // 2).sum())
        r["bound"] = bound(2 * keys * hkv * row_bytes + 2 * q.numel() * 2 + tbl.numel() * 4
                           + B * 4, 4 * pairs * hq * d)
        kd = dense_pool_kv(torch, kp, tbl, layer, q.dtype).repeat_interleave(group, dim=1)
        vd = dense_pool_kv(torch, vp, tbl, layer, q.dtype).repeat_interleave(group, dim=1)
        front = pos[:, None] + torch.arange(w, device=dev)[None, :]  # [B, W]
        mask = (torch.arange(kd.shape[2], device=dev)[None, None, :]
                <= front[:, :, None])[:, None]  # [B, 1, W, S]
        r["library"] = (lambda qs=q.transpose(1, 2), kd=kd, vd=vd, mask=mask, scale=scale:
                        F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask,
                                                       scale=scale))

    # K2: q, k, v read once, out written once; the causal pairs' flops
    for name in ("flash_attention", "flash_attention@T4096", "flash_attention@B4"):
        r = results[name]
        q, k, v, scale = r["args"]
        B, t = q.shape[:2]
        r["bound"] = bound((2 * q.numel() + 2 * k.numel()) * 2,
                           4 * B * (t * (t + 1) // 2) * hq * d)
        qs2, ks2, vs2 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ks2, vs2 = ks2.repeat_interleave(group, dim=1), vs2.repeat_interleave(group, dim=1)
        r["library"] = (lambda qs2=qs2, ks2=ks2, vs2=vs2, scale=scale:
                        F.scaled_dot_product_attention(qs2, ks2, vs2, is_causal=True,
                                                       scale=scale))

    # K3: the live keys [0, start + C) of each row's slab, read once
    for name in ("flash_attention_chunk", "flash_attention_chunk@KW4096",
                 "flash_attention_chunk@B4", "flash_attention_chunk@fill"):
        r = results[name]
        q, ksl, vsl, scale, start = r["args"]
        B, C, kw = q.shape[0], q.shape[1], ksl.shape[2]
        pairs = B * sum(start + i + 1 for i in range(C))
        r["bound"] = bound((2 * q.numel() + 2 * B * (start + C) * hkv * d) * 2,
                           4 * pairs * hq * d)
        qs3 = q.transpose(1, 2)
        kd3, vd3 = ksl.repeat_interleave(group, dim=1), vsl.repeat_interleave(group, dim=1)
        cmask = (torch.arange(kw, device=dev)[None, :]
                 <= (start + torch.arange(C, device=dev))[:, None])
        r["library"] = (lambda qs3=qs3, kd3=kd3, vd3=vd3, cmask=cmask, scale=scale:
                        F.scaled_dot_product_attention(qs3, kd3, vd3, attn_mask=cmask,
                                                       scale=scale))

    # K4: K3's operations; its bytes are D int8 codes and a f32 scale per
    # key row. SDPA over the slabs already dequantized to bf16 (not timed)
    for name in ("flash_attention_chunk_kvq", "flash_attention_chunk_kvq@KW4096",
                 "flash_attention_chunk_kvq@B4", "flash_attention_chunk_kvq@fill"):
        r = results[name]
        q, kq, ks, vq, vs, scale, start = r["args"]
        B, C, kw = q.shape[0], q.shape[1], kq.shape[2]
        pairs = B * sum(start + i + 1 for i in range(C))
        r["bound"] = bound(2 * q.numel() * 2 + 2 * B * (start + C) * hkv * (d + 4),
                           4 * pairs * hq * d)
        kd4 = dequantize(KVQ(kq, ks), q.dtype).repeat_interleave(group, dim=1)
        vd4 = dequantize(KVQ(vq, vs), q.dtype).repeat_interleave(group, dim=1)
        cmask4 = (torch.arange(kw, device=dev)[None, :]
                  <= (start + torch.arange(C, device=dev))[:, None])
        r["library"] = (lambda qs4=q.transpose(1, 2), kd4=kd4, vd4=vd4, cmask4=cmask4,
                        scale=scale:
                        F.scaled_dot_product_attention(qs4, kd4, vd4, attn_mask=cmask4,
                                                       scale=scale))

    for name, r in results.items():
        args, kern, plain = r.pop("args"), r["kern"], r.pop("plain")
        r["ms"] = cuda_ms(torch, lambda: kern(*args))
        r["plain_ms"] = cuda_ms(torch, lambda: plain(*args), iters=5)
        r["library_ms"] = cuda_ms(torch, r.pop("library"))
        if name.startswith("paged_"):
            r["kernels_us"] = kernel_us(torch, lambda: kern(*args))
        del args
        torch.cuda.empty_cache()
    for name, r in results.items():
        log(f"kernel {name}: body={r['body']}: {r['shape']}: max_abs_err={r['max_abs_err']:.3e} over "
            f"{ERR_SEEDS} draws {[f'{e:.3e}' for e in r['errs']]}, max_row_rel_err="
            f"{r['max_row_rel_err']:.3e} {[f'{e:.3e}' for e in r['rels']]} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) "
            f"library_ms={r['library_ms']:.4f}")
        if "kernels_us" in r:
            ks = r["kernels_us"]
            merge = sum(us for k, us in ks.items() if "combine" in k)
            log(f"kernel {name}: device time a call (torch.profiler): decode "
                f"{(sum(ks.values()) - merge) / 1e3:.4f} ms, split merge {merge / 1e3:.4f} ms "
                f"({', '.join(f'{k[:60]} {us:.2f} us' for k, us in ks.items())})")
        if not r["max_abs_err"] <= ABS_LIMIT:
            raise AssertionError(f"{name}: max abs error {r['max_abs_err']} > {ABS_LIMIT}")
        if not r["max_row_rel_err"] <= ROW_REL_LIMIT:
            raise AssertionError(f"{name}: row error over row norm {r['max_row_rel_err']} > "
                                 f"{ROW_REL_LIMIT}")
    return results


# -- phase 3: model ----------------------------------------------------------


def write_gguf(torch, path: Path, n_layers: int, seed: int, widths: dict = LLAMA3_8B,
               device: str = "cuda") -> None:
    """A bf16 GGUF at ``widths`` (Llama-3-8B's), random weights drawn on
    ``device``."""
    from nats_llm_studio_tpu_torch.gguf.constants import GGMLType, TokenType
    from nats_llm_studio_tpu_torch.gguf.tokenizer import _byte_to_unicode
    from nats_llm_studio_tpu_torch.gguf.writer import GGUFWriter

    c = widths
    d, ff, v = c["d_model"], c["d_ff"], c["vocab"]
    qd, kvd = c["n_heads"] * c["head_dim"], c["n_kv_heads"] * c["head_dim"]
    g = torch.Generator(device=device).manual_seed(seed)
    w = GGUFWriter(path)
    b2u = _byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    tokens += [f"<filler_{i}>" for i in range(256, v - 1)] + ["<|eot|>"]
    w.add_dict({
        "general.architecture": "llama",
        "general.name": MID,
        "llama.block_count": n_layers,
        "llama.embedding_length": d,
        "llama.attention.head_count": c["n_heads"],
        "llama.attention.head_count_kv": c["n_kv_heads"],
        "llama.attention.key_length": c["head_dim"],
        "llama.attention.value_length": c["head_dim"],
        "llama.feed_forward_length": ff,
        "llama.rope.freq_base": c["rope_theta"],
        "llama.attention.layer_norm_rms_epsilon": c["rms_eps"],
        "llama.context_length": c["context"],
        "llama.vocab_size": v,
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": [int(TokenType.NORMAL)] * (v - 1) + [int(TokenType.CONTROL)],
        "tokenizer.ggml.merges": [],
        "tokenizer.ggml.eos_token_id": v - 1,
        "tokenizer.ggml.add_bos_token": False,
    })

    def rand(name, *shape):  # GGUF [out, in] logical order
        x = (torch.randn(shape, generator=g, device=device) * 0.02).to(torch.bfloat16)
        w.add_tensor_bytes(name, shape, GGMLType.BF16,
                           x.reshape(-1).view(torch.uint8).cpu().numpy())

    def ones(name, n):
        w.add_tensor_bytes(name, (n,), GGMLType.F32,
                           torch.ones(n, dtype=torch.float32).view(torch.uint8).numpy())

    rand("token_embd.weight", v, d)
    ones("output_norm.weight", d)
    rand("output.weight", v, d)
    for i in range(n_layers):
        p = f"blk.{i}"
        ones(f"{p}.attn_norm.weight", d)
        ones(f"{p}.ffn_norm.weight", d)
        rand(f"{p}.attn_q.weight", qd, d)
        rand(f"{p}.attn_k.weight", kvd, d)
        rand(f"{p}.attn_v.weight", kvd, d)
        rand(f"{p}.attn_output.weight", d, qd)
        rand(f"{p}.ffn_gate.weight", ff, d)
        rand(f"{p}.ffn_up.weight", ff, d)
        rand(f"{p}.ffn_down.weight", d, ff)
    w.write()


def model_phase(torch, registry, seed: int) -> dict:
    """Logits of the full-width model through the kernel path and the
    plain path, in two measurements:

    * ``prefill``: prompt-end logits of a 512-token fresh prefill (K2);
    * ``decode``: the same prompt prefilled in two 256-token chunks (K2,
      then K3, or K4 over the int8 cache), its rows written into a paged
      pool, then one decode step over the pool (K1, or K1q);
    * ``verify``: on that pool, a speculative verify's forward (one
      ``forward_decode_paged`` of W = 7 tokens, K1 or K1q at W = 7, the
      kernel path) against seven W = 1 steps over the same tokens (the plain
      path), all seven positions' logits.

    Two gates each. In float32 (the bf16 weights upcast exactly) the paths
    differ only in the attention arithmetic: relative L2 <= 2e-2. In bf16,
    the dtype the card serves, both paths also round every activation of 32
    layers, and that rounding dominates their distance; so the bf16 kernel
    path may be no further from the f32 plain path than BF16_DRIFT times
    the bf16 plain path's distance. Returns the engine and the bf16
    kernel-path logits."""
    from nats_llm_studio_tpu_torch.device import torch_dtype
    from nats_llm_studio_tpu_torch.models.llama import (
        KERNELS,
        PLAIN,
        forward,
        forward_decode_paged,
        make_cache,
    )
    from nats_llm_studio_tpu_torch.ops.kvcache import kv_pool_write_row, kv_pool_zeros

    eng = asyncio.run(registry.get_engine(MID))
    cfg, params = eng.cfg, eng.batcher.params
    dev = params["embed"].device
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    n, T = 512, 16
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g, dtype=torch.int32).to(dev)
    nxt = torch.randint(0, cfg.vocab_size, (1, 1), generator=g, dtype=torch.int32).to(dev)
    bundle = torch.randint(0, cfg.vocab_size, (1, 7), generator=g, dtype=torch.int32).to(dev)

    def prefill(p, c, attn):
        k1, v1 = make_cache(c, 1, n, device=dev)
        logits, _, _ = forward(p, c, toks, k1, v1, torch.zeros((1,), dtype=torch.int32),
                               logit_positions=torch.tensor([n - 1]), fresh_prefill=True,
                               attn=attn)
        return logits[0, 0].float()

    def prompt_pool(p, c, attn):
        """The prompt in two chunks, its rows in a paged pool of blocks
        1..n/T; blocks n/T + 1 and + 2 take the rows after it."""
        k1, v1 = make_cache(c, 1, n, device=dev)
        C = n // 2
        for start in (0, C):
            forward(p, c, toks[:, start:start + C], k1, v1,
                    torch.full((1,), start, dtype=torch.int32), attn_window=n,
                    logit_positions=torch.tensor([C - 1]), uniform_start=True, attn=attn)
        nb = n // T
        shape = (nb + 3, c.n_layers, c.n_kv_heads, T, c.head_dim)
        quant = c.kv_quant == "int8"
        kp = kv_pool_zeros(shape, torch_dtype(c.dtype), dev, quant=quant)
        vp = kv_pool_zeros(shape, torch_dtype(c.dtype), dev, quant=quant)
        bids = torch.arange(1, nb + 1, dtype=torch.int32)
        kv_pool_write_row(kp, k1, bids)
        kv_pool_write_row(vp, v1, bids)
        return kp, vp, torch.arange(1, nb + 3, dtype=torch.int32, device=dev)[None]

    def at(i: int):
        return torch.tensor([n + i], dtype=torch.int32, device=dev)

    def decode(p, c, attn):
        kp, vp, tbl = prompt_pool(p, c, attn)
        logits, _, _ = forward_decode_paged(p, c, nxt, kp, vp, tbl, at(0), attn=attn)
        return logits[0, 0].float()

    def verify(p, c, width: int):
        """Logits [7, V] of the 7 draft-bundle tokens after the prompt: one
        W = 7 forward on the kernel path (width 7), or seven W = 1 steps on
        the plain path (width 1), over the same prompt pool."""
        kp, vp, tbl = prompt_pool(p, c, PLAIN)
        if width > 1:
            logits, _, _ = forward_decode_paged(p, c, bundle, kp, vp, tbl, at(0), attn=KERNELS)
            return logits[0].float()
        return torch.cat([forward_decode_paged(p, c, bundle[:, i:i + 1], kp, vp, tbl, at(i),
                                               attn=PLAIN)[0][0] for i in range(7)]).float()

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    c32 = cfg.with_(dtype="float32")
    out = {"engine": eng}
    for name, fn in (("prefill", prefill), ("decode", decode)):
        bf_k, bf_p = fn(params, cfg, KERNELS), fn(params, cfg, PLAIN)
        f_k, f_p = fn(p32, c32, KERNELS), fn(p32, c32, PLAIN)
        if not (torch.isfinite(bf_k).all() and torch.isfinite(f_k).all()):
            raise AssertionError(f"{name}: kernel-path logits are not finite")
        r32, dk, dp = rel(f_k, f_p), rel(bf_k, f_p), rel(bf_p, f_p)
        log(f"model (kv {cfg.kv_quant}) {name}: logits of a {n}-token prompt"
            f"{' then one decode step' if name == 'decode' else ''}, kernel path vs plain "
            f"path: float32 relative L2 {r32:.3e} (limit 2e-2); bf16 {rel(bf_k, bf_p):.3e}; "
            f"distance to the f32 plain path: bf16 kernel path {dk:.3e}, bf16 plain path "
            f"{dp:.3e} (limit {BF16_DRIFT} x, ratio {dk / dp if dp else float('nan'):.4f})")
        if not r32 <= 2e-2:
            raise AssertionError(f"{name}: relative L2 {r32} > 2e-2")
        if not dk <= BF16_DRIFT * dp:
            raise AssertionError(f"{name}: bf16 kernel path {dk} from f32, > {BF16_DRIFT} x "
                                 f"the plain path's {dp}")
        out[name] = bf_k.cpu()
    # the verify: W = 7 on the kernel path against seven W = 1 plain steps
    bf_k, bf_p = verify(params, cfg, 7), verify(params, cfg, 1)
    f_k, f_p = verify(p32, c32, 7), verify(p32, c32, 1)
    if not (torch.isfinite(bf_k).all() and torch.isfinite(f_k).all()):
        raise AssertionError("verify: kernel-path logits are not finite")
    r32, dk, dp = rel(f_k, f_p), rel(bf_k, f_p), rel(bf_p, f_p)
    out["verify"] = dict(f32=r32, bf16_kernels=dk, bf16_plain=dp,
                         same_argmax_bf16=int((bf_k.argmax(-1) == bf_p.argmax(-1)).sum()))
    log(f"model (kv {cfg.kv_quant}) verify: logits of 7 tokens after a {n}-token prompt, one "
        f"W=7 forward (kernel path) vs seven W=1 steps (plain path): float32 relative L2 "
        f"{r32:.3e} (limit 2e-2); distance to the f32 W=1 path: bf16 W=7 kernel path "
        f"{dk:.3e}, bf16 W=1 plain path {dp:.3e} (limit {BF16_DRIFT} x, ratio "
        f"{dk / dp if dp else float('nan'):.4f}); bf16 argmax equal at "
        f"{out['verify']['same_argmax_bf16']} of 7 positions")
    if not r32 <= 2e-2:
        raise AssertionError(f"verify: relative L2 {r32} > 2e-2")
    if cfg.dtype != "float32" and not dk <= BF16_DRIFT * dp:
        raise AssertionError(f"verify: bf16 W=7 kernel path {dk} from f32, > {BF16_DRIFT} x "
                             f"the W=1 plain path's {dp}")
    out["group"] = group_gate(torch, p32, c32, params, cfg, g)
    del p32
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def group_gate(torch, p32, c32, params, cfg, g, ns=(700, 513, 650, 300), C: int = 256) -> dict:
    """The prompt-end logits of each row of a 4-row chunked group admit
    (``prefill_chunk_group``'s forward: [4, C] chunks at one start, K2 then
    K3, or K4 over the int8 cache) against the same prompt admitted alone
    in [1, C] chunks (``prefill1``'s), by the model gate: in float32 on the
    plain path relative L2 <= 2e-2; in bf16 the kernel path's group no
    further from the float32 plain path's single admit than BF16_DRIFT x
    the bf16 plain path's single admit is. The GEMMs of B=4 and B=1 may
    round differently, so tokens are not compared."""
    from nats_llm_studio_tpu_torch.models.llama import KERNELS, PLAIN, forward, make_cache

    dev = params["embed"].device
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g, dtype=torch.int32).to(dev)
               for n in ns]
    S = 1 << (max(ns) - 1).bit_length()  # the row caches' length: the last window

    def run(p, c, attn, rows):
        km, vm = make_cache(c, len(rows), S, device=dev)
        out = [None] * len(rows)
        for start in range(0, max(ns[i] for i in rows), C):
            toks = torch.zeros((len(rows), C), dtype=torch.int32, device=dev)
            for r, i in enumerate(rows):
                seg = prompts[i][start:start + C]
                toks[r, :len(seg)] = seg
            last = torch.tensor([min(max(ns[i] - 1 - start, 0), C - 1) for i in rows])
            logits, km, vm = forward(p, c, toks, km, vm,
                                     torch.full((len(rows),), start, dtype=torch.int32),
                                     attn_window=min(1 << (start + C - 1).bit_length(), S),
                                     logit_positions=last, uniform_start=True, attn=attn)
            for r, i in enumerate(rows):
                if (ns[i] - 1) // C == start // C:
                    out[r] = logits[r, 0].float()
        return out

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    alone32 = [run(p32, c32, PLAIN, [i])[0] for i in range(len(ns))]
    group32 = run(p32, c32, PLAIN, list(range(len(ns))))
    alone_bf = [run(params, cfg, PLAIN, [i])[0] for i in range(len(ns))]
    group_bf = run(params, cfg, KERNELS, list(range(len(ns))))
    rows = []
    for i in range(len(ns)):
        if not torch.isfinite(group_bf[i]).all():
            raise AssertionError(f"group row {i}: kernel-path logits are not finite")
        r32, dk, dp = (rel(group32[i], alone32[i]), rel(group_bf[i], alone32[i]),
                       rel(alone_bf[i], alone32[i]))
        rows.append(dict(prompt=ns[i], f32=r32, bf16_group_kernels=dk, bf16_alone_plain=dp))
        log(f"group (kv {cfg.kv_quant}): row {i} of a 4-row chunked group ({ns[i]} tokens) vs "
            f"the prompt alone: float32 relative L2 {r32:.3e} (limit 2e-2); distance to the "
            f"f32 alone: bf16 group kernel path {dk:.3e}, bf16 alone plain path {dp:.3e} "
            f"(limit {BF16_DRIFT} x, ratio {dk / dp if dp else float('nan'):.4f})")
        if not r32 <= 2e-2:
            raise AssertionError(f"group row {i}: relative L2 {r32} > 2e-2")
        # (a float32 rehearsal on the CPU has no bf16 path to hold)
        if cfg.dtype != "float32" and not dk <= BF16_DRIFT * dp:
            raise AssertionError(f"group row {i}: bf16 group {dk} from f32, > {BF16_DRIFT} x "
                                 f"the plain path's {dp}")
    return {"rows": rows}


def decode_profile(torch, eng, ctx: int = 512, steps: int = 4) -> dict:
    """Where one decode step's time goes: 8 slots at ``ctx`` tokens through
    forward_decode_paged and a greedy pick on a pool of random K/V (int8
    codes quantized from the same draws under ``kv_quant == "int8"``). Wall
    time per step (host clock around synchronized steps) beside the device
    time the profiler sees, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from nats_llm_studio_tpu_torch.models.llama import forward_decode_paged
    from nats_llm_studio_tpu_torch.ops.kvcache import quantize_rows

    cfg, params = eng.cfg, eng.batcher.params
    dev = params["embed"].device
    B, T = 8, 16
    nbt = (ctx + steps) // T + 1
    nb = 1 + B * nbt
    shape = (nb, cfg.n_layers, cfg.n_kv_heads, T, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(7)
    kp = torch.randn(shape, generator=g, device=dev, dtype=params["embed"].dtype)
    vp = torch.randn(shape, generator=g, device=dev, dtype=params["embed"].dtype)
    if cfg.kv_quant == "int8":
        kp, vp = quantize_rows(kp), quantize_rows(vp)
    tbl = torch.arange(1, nb, dtype=torch.int32, device=dev).reshape(B, nbt)
    pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)

    def step(i):
        logits, _, _ = forward_decode_paged(params, cfg, tok[:, None], kp, vp, tbl, pos + i)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # the paged attention kernels (decode and split merge, both KV modes)
    attn = [e for e in kernels if "paged_" in e.key]
    out = {"kv_quant": cfg.kv_quant, "ctx": ctx, "slots": B, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": dev_us / 1e3 / steps if dev_us else None,
           "launches_per_step": sum(e.count for e in kernels) / steps if kernels else None,
           "attention_ms_per_step": sum(e.self_device_time_total for e in attn) / 1e3 / steps,
           "top": [(e.key[:60], e.self_device_time_total / 1e3 / steps, e.count // steps)
                   for e in top]}
    if out["device_ms_per_step"] is None:
        log("profile: the profiler saw no device time (not measured)")
    else:
        out["device_idle_share"] = 1.0 - out["device_ms_per_step"] / wall_ms
        log(f"profile (kv {cfg.kv_quant}): decode step, {B} slots at {ctx} tokens: wall "
            f"{wall_ms:.2f} ms, device "
            f"{out['device_ms_per_step']:.2f} ms ({out['launches_per_step']:.0f} kernels), "
            f"device idle {out['device_idle_share']:.1%}; paged attention kernels "
            f"{out['attention_ms_per_step']:.3f} ms")
        for name, ms, cnt in out["top"]:
            log(f"profile:   {ms:8.3f} ms/step  x{cnt:<4d} {name}")
    # the restricted-sampling pick on this step's logits (T 0.8, top-k 40,
    # top-p 0.95): all of _pick, and the stable full-vocab sort that takes
    # its candidates beside torch.topk of as many (device ms each)
    from nats_llm_studio_tpu_torch.engine import sampling

    logits = forward_decode_paged(params, cfg, tok[:, None], kp, vp, tbl, pos)[0][:, -1]
    gumbel = -torch.log(-torch.log(torch.rand(logits.shape, generator=g, device=dev)
                                   .clamp_min(1e-30)))
    samp = (torch.full((B,), 0.8, device=dev), torch.full((B,), 40, device=dev),
            torch.full((B,), 0.95, device=dev))
    c = sampling.CANDIDATES
    out["pick_ms"] = cuda_ms(torch, lambda: sampling._pick(logits, gumbel, *samp))
    out["pick_sort_ms"] = cuda_ms(torch, lambda: sampling._candidates(logits, c))
    out["pick_topk_ms"] = cuda_ms(torch, lambda: torch.topk(logits, c, dim=-1))
    log(f"profile (kv {cfg.kv_quant}): _pick at [{B}, {logits.shape[1]}] {out['pick_ms']:.4f} "
        f"ms, of which the stable sort's {c} candidates {out['pick_sort_ms']:.4f} ms "
        f"(torch.topk of {c}: {out['pick_topk_ms']:.4f} ms)")
    out.update(verify_profile(torch, eng, kp, vp, tbl, pos, prof_steps=steps))
    del kp, vp, logits, gumbel
    torch.cuda.empty_cache()
    return out


def device_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(device ms, kernels) per call of ``fn`` as the profiler sees them
    over ``reps`` synchronized calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and getattr(e, "self_device_time_total", 0) > 0]
    return (sum(e.self_device_time_total for e in ev) / 1e3 / reps,
            sum(e.count for e in ev) / reps)


def verify_profile(torch, eng, kp, vp, tbl, pos, prof_steps: int, slots: int = 4) -> dict:
    """A speculative verify against the steps it stands for, on the
    profile's pool: ``slots`` slots at its context, one W = k + 1 forward
    (device ms, kernels) against k + 1 W = 1 forwards; and
    ``spec_accept_rows`` at [8, k + 1, V] on that verify's logits tiled to 8
    rows, greedy (no noise drawn) and sampled (T 0.8, top-p 0.95: a
    generator and a [V] draw per row and position), in device ms (the
    profiler's kernel time) and in wall ms of a synchronized call (with the
    host's noise loop)."""
    from nats_llm_studio_tpu_torch.engine import sampling
    from nats_llm_studio_tpu_torch.models.llama import forward_decode_paged

    cfg, params = eng.cfg, eng.batcher.params
    dev = params["embed"].device
    w = SPEC_K + 1
    tb, pb = tbl[:slots], pos[:slots]
    toks = torch.randint(0, cfg.vocab_size, (slots, w), device=dev, dtype=torch.int32)

    def verify():
        return forward_decode_paged(params, cfg, toks, kp, vp, tb, pb)[0]

    def steps():
        for i in range(w):
            forward_decode_paged(params, cfg, toks[:, i:i + 1], kp, vp, tb, pb + i)

    for _ in range(2):
        verify()
        steps()
    v_ms, v_k = device_ms(torch, verify, prof_steps)
    s_ms, s_k = device_ms(torch, steps, prof_steps)
    logits = verify().repeat(8 // slots, 1, 1)  # [8, k + 1, V]
    drafts = logits[:, :SPEC_K].argmax(-1).int()
    dlen = [SPEC_K] * 8
    seeds, stp = list(range(8)), [0] * 8
    acc = {}
    for name, temp in (("greedy", 0.0), ("sampled", 0.8)):
        def accept(temp=temp):
            return sampling.spec_accept_rows(logits, drafts, dlen, seeds, stp, [temp] * 8, 0,
                                             0.95 if temp else 1.0)
        acc[f"accept_{name}_ms"] = device_ms(torch, accept, 5)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            accept()
        torch.cuda.synchronize()
        acc[f"accept_{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    out = {"verify_slots": slots, "verify_device_ms": v_ms, "verify_kernels": v_k,
           "steps_device_ms": s_ms, "steps_kernels": s_k, **acc}
    log(f"profile (kv {cfg.kv_quant}): verify of {slots} slots at {int(pos[0])} tokens: one W={w} "
        f"forward {v_ms:.3f} ms device ({v_k:.0f} kernels) against {w} W=1 forwards {s_ms:.3f} "
        f"ms ({s_k:.0f} kernels); spec_accept_rows at [8, {w}, {logits.shape[-1]}]: greedy "
        f"{acc['accept_greedy_ms']:.4f} ms device, {acc['accept_greedy_wall_ms']:.3f} ms wall; "
        f"sampled {acc['accept_sampled_ms']:.4f} ms device, {acc['accept_sampled_wall_ms']:.3f} "
        f"ms wall")
    return out


# -- phase 4: serve ----------------------------------------------------------


class Served:
    """An embedded broker, the port's Worker over ``registry`` and a client:
    ``chat`` (unary, any extra body fields) and ``stream`` (greedy,
    streamed) over ``lmstudio.chat_model``."""

    def __init__(self, registry, store: bool = False, **config):
        self.registry = registry
        self.store = store  # the object-store module on the broker
        self.config = config  # WorkerConfig fields beyond the broker's URL

    async def __aenter__(self):
        from nats_llm_studio_tpu_torch.config import WorkerConfig
        from nats_llm_studio_tpu_torch.serve.worker import Worker
        from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, connect

        self.broker = await EmbeddedBroker().start()
        if self.store:
            from nats_llm_studio_tpu_torch.store import JetStreamStoreModule

            JetStreamStoreModule(self.broker).install()
        self.worker = Worker(WorkerConfig(nats_url=self.broker.url, **self.config),
                             self.registry)
        await self.worker.start()
        self.nc = await connect(self.broker.url)
        return self

    async def __aexit__(self, *exc):
        await self.nc.close()
        await self.worker.drain()
        await self.broker.stop()

    async def chat(self, content: str, max_tokens: int, timeout: float = 300.0,
                   system: str | None = None, **fields) -> dict:
        messages = [{"role": "user", "content": content}]
        if system is not None:
            messages.insert(0, {"role": "system", "content": system})
        body = {"model": MID, "messages": messages,
                "temperature": 0, "max_tokens": max_tokens, **fields}
        t0 = time.perf_counter()
        msg = await self.nc.request("lmstudio.chat_model", json.dumps(body).encode(),
                                    timeout=timeout)
        env = json.loads(msg.payload)
        if not env.get("ok"):
            raise AssertionError(f"chat failed: {env}")
        resp = env["data"]["response"]
        resp["_wall_s"] = time.perf_counter() - t0
        return resp

    async def stream(self, content: str, max_tokens: int, first: asyncio.Event | None = None):
        body = {"model": MID, "messages": [{"role": "user", "content": content}],
                "temperature": 0, "max_tokens": max_tokens, "stream": True}
        t0 = time.perf_counter()
        ttft, parts, final = None, [], None
        async for msg in self.nc.request_stream("lmstudio.chat_model",
                                                json.dumps(body).encode(), timeout=300.0):
            env = json.loads(msg.payload)
            if not env.get("ok"):
                raise AssertionError(f"stream failed: {env}")
            if msg.headers and "Nats-Stream-Done" in msg.headers:
                final = env["data"]["response"]
            else:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                    if first is not None:
                        first.set()
                parts.append(env["data"]["chunk"]["choices"][0]["delta"]["content"])
        if final is None or final["choices"][0]["message"]["content"] != "".join(parts):
            raise AssertionError("stream chunks do not add up to the final completion")
        return final, ttft, time.perf_counter() - t0


async def serve_chats(h: Served, registry, seed: int) -> dict:
    nc, chat, stream = h.nc, h.chat, h.stream
    out: dict = {}
    env = json.loads((await nc.request("lmstudio.list_models", b"{}", timeout=30)).payload)
    if not env.get("ok") or MID not in [m["id"] for m in env["data"]["models"]["data"]]:
        raise AssertionError(f"list_models: {env}")
    log("serve: list_models ok")

    a = await chat("Say something about the sea.", 32)
    b = await chat("Say something about the sea.", 32)
    ta = a["choices"][0]["message"]["content"]
    if ta != b["choices"][0]["message"]["content"]:
        raise AssertionError("two greedy runs of one short chat differ")
    out["short"] = a
    log(f"serve: short greedy chat x2 identical: prompt {a['usage']['prompt_tokens']} "
        f"tokens, {a['usage']['completion_tokens']} out, stats {a['stats']}, "
        f"wall {a['_wall_s']:.3f} s")

    # the default sampling path (temperature > 0, top-p), seeded: the
    # same seed must give the same text
    sa = await chat("Name three colours.", 16, temperature=0.8, top_p=0.95, seed=1234)
    sb = await chat("Name three colours.", 16, temperature=0.8, top_p=0.95, seed=1234)
    if sa["choices"][0]["message"]["content"] != sb["choices"][0]["message"]["content"]:
        raise AssertionError("two seeded sampled runs of one chat differ")
    log(f"serve: seeded sampled chat x2 identical: {sa['usage']['completion_tokens']} "
        f"tokens, stats {sa['stats']}")

    long_text = ("The history of the harbour town begins with fishermen. " * 13)[:700]
    c = await chat(long_text, 16)
    if c["usage"]["prompt_tokens"] <= 256:
        raise AssertionError("the long prompt fits one serving chunk")
    out["long_idle"] = c
    log(f"serve: long chat into the idle batcher: prompt {c['usage']['prompt_tokens']} "
        f"tokens, stats {c['stats']}, wall {c['_wall_s']:.3f} s")

    first = asyncio.Event()
    live = asyncio.ensure_future(stream("Count slowly from one to fifty.", 128, first))
    await asyncio.wait_for(first.wait(), 300)
    d = await chat("Beside a live stream: " + long_text, 8)
    fin, _, _ = await live
    out["beside"] = d
    log(f"serve: long chat beside a live stream: prompt {d['usage']['prompt_tokens']} "
        f"tokens, stats {d['stats']}; live stream {fin['usage']['completion_tokens']} tokens")

    fin, ttft, wall = await stream("Tell me a short story.", 32)
    n_out = fin["usage"]["completion_tokens"]
    out["stream"] = dict(ttft_s=ttft, wall_s=wall, tokens=n_out,
                         decode_tok_s=(n_out - 1) / (wall - ttft) if n_out > 1 else 0.0)
    log(f"serve: streamed chat: {n_out} tokens, client TTFT {ttft * 1e3:.1f} ms, "
        f"decode {out['stream']['decode_tok_s']:.2f} tok/s")
    eng = registry.loaded_engines()[MID]
    log(f"serve: batcher {json.dumps(eng.batcher.stats.snapshot())}")
    return out


async def prefix_phase(registry, chat, stream, seed: int) -> dict:
    """The prefix cache and the group admits through the engine already
    loaded (the registry's default 64-block cache):

    1. a ~700-token chat (a system prompt longer than two serving chunks)
       sent twice, each beside a live stream: the first misses and is
       prefilled in chunks, the second takes a partial hit (two cached
       chunks copied into its row by fill_row_chunk, then K3 or K4 over the
       suffix chunk at start 512). Both run the suffix chunk on the same
       inputs, so their greedy texts must be equal; TTFTs are printed;
    2. a chunk-aligned 512-token id prompt submitted twice to the batcher:
       the second is a full hit (token 0 from the stored chunk-end logits),
       with identical greedy ids and no prefill program;
    3. a wave of four ~700-token chats into the idle batcher, none sharing a
       chunk with a cached prompt: one batched chunked admit. Then
       drop_prefix_cache must leave every pool block free, and the same
       wave again must give the same texts;
    4. eight concurrent short chats of one bucket: batched short admits;
    5. copy-on-write copies (0 expected: sharing is chunk-aligned)."""
    import torch

    from nats_llm_studio_tpu_torch.engine.generator import SamplingParams

    b = registry.loaded_engines()[MID].batcher
    pc = b.prefix_cache
    if pc is None:
        raise AssertionError("the serving registry built no prefix cache")
    C, kv = b.prefill_chunk, b.cfg.kv_quant
    out: dict = {}

    # 1. partial hit, miss and hit each beside a live stream
    system = ("You keep the harbour master's log: arrivals, departures, cargo and the "
              "state of the tide. " * 8)[:620]
    texts, ttfts, prompt_tokens = [], [], 0
    for i in range(2):
        first = asyncio.Event()
        live = asyncio.ensure_future(stream(f"Count slowly from one to {40 + i}.", 96, first))
        await asyncio.wait_for(first.wait(), 300)
        before = pc.counters()
        r = await chat("Which ships are due in on the morning tide?", 24, system=system)
        await live
        texts.append(r["choices"][0]["message"]["content"])
        ttfts.append(r["stats"]["time_to_first_token"])
        prompt_tokens = r["usage"]["prompt_tokens"]
    after = pc.counters()
    hits, hit_tokens = after["hits"] - before["hits"], after["hit_tokens"] - before["hit_tokens"]
    out["partial"] = dict(prompt_tokens=prompt_tokens, hits=hits, hit_tokens=hit_tokens,
                          ttft_miss_s=ttfts[0], ttft_hit_s=ttfts[1], same_text=texts[0] == texts[1])
    log(f"prefix (kv {kv}): a {prompt_tokens}-token chat twice beside a live stream: the "
        f"second hit {hits} time(s) for {hit_tokens} tokens; TTFT miss {ttfts[0] * 1e3:.1f} ms, "
        f"hit {ttfts[1] * 1e3:.1f} ms; greedy texts equal: {texts[0] == texts[1]}")
    if prompt_tokens <= 2 * C or hits < 1 or hit_tokens < 2 * C:
        raise AssertionError(f"partial hit: {out['partial']}")
    if texts[0] != texts[1]:
        raise AssertionError(f"the hit's text differs from the miss's: {texts}")

    # 2. full hit of a chunk-aligned id prompt
    g = torch.Generator().manual_seed(seed + 3)
    ids = torch.randint(0, b.cfg.vocab_size - 1, (2 * C,), generator=g).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    runs = []
    for _ in range(2):
        calls0, full0 = dict(b.stats.program_calls), pc.counters()["full_hits"]
        toks = [t async for t in b.submit(ids, sp)]
        calls = {k: v - calls0.get(k, 0) for k, v in b.stats.program_calls.items()
                 if v != calls0.get(k, 0)}
        runs.append((toks, calls, pc.counters()["full_hits"] - full0))
    prefill = {"admit_fused_paged", "admit_many_fused_paged", "prefill_full", "prefill1",
               "prefill_chunk_group", "fill_row_chunk"}
    out["full"] = dict(full_hits=runs[1][2], same_ids=runs[0][0] == runs[1][0],
                       programs_of_the_hit=runs[1][1])
    log(f"prefix (kv {kv}): a {2 * C}-token id prompt twice: full hits {runs[1][2]}, ids equal "
        f"{runs[0][0] == runs[1][0]}; programs of the miss {runs[0][1]}, of the hit "
        f"{runs[1][1]}")
    if runs[1][2] < 1 or runs[0][0] != runs[1][0] or prefill & set(runs[1][1]) \
            or "sample_first" not in runs[1][1]:
        raise AssertionError(f"full hit: {out['full']}")

    # 3. a wave of four long chats, twice, the cache dropped between
    body = ("The tide tables for the northern pier list every berth, its depth at low "
            "water and the ships that may use it. " * 8)[:690]
    wave = [f"Chat {i}: {body}" for i in range(4)]
    waves = []
    for w in range(2):
        g0 = b.stats.chunked_group_admits
        rs = await asyncio.gather(*[chat(t, 16) for t in wave])
        waves.append(([r["choices"][0]["message"]["content"] for r in rs],
                      b.stats.chunked_group_admits - g0))
        if w == 0:
            dropped = b.drop_prefix_cache()
            st = b.pool_stats()
            log(f"prefix (kv {kv}): drop_prefix_cache evicted {dropped} blocks; pool "
                f"{st['blocks_free']} of {st['blocks_total']} blocks free")
            if st["blocks_free"] != st["blocks_total"]:
                raise AssertionError(f"blocks still held after drop_prefix_cache: {st}")
    out["group"] = dict(prompt_tokens=rs[0]["usage"]["prompt_tokens"],
                        chunked_group_admits=[n for _, n in waves],
                        same_texts=waves[0][0] == waves[1][0])
    log(f"prefix (kv {kv}): two waves of four {out['group']['prompt_tokens']}-token chats: "
        f"chunked group admits {out['group']['chunked_group_admits']}, texts equal "
        f"{out['group']['same_texts']}")
    if sum(n for _, n in waves) < 4 or waves[0][0] != waves[1][0]:
        raise AssertionError(f"group admit: {out['group']}")

    # 4. eight short chats of one bucket
    g0 = b.stats.grouped_admits
    rs = await asyncio.gather(*[chat(f"Short question {i}: how deep is the harbour?", 8)
                                for i in range(8)])
    out["short_group"] = dict(grouped_admits=b.stats.grouped_admits - g0,
                              prompt_tokens=sorted({r["usage"]["prompt_tokens"] for r in rs}))
    log(f"prefix (kv {kv}): eight short chats: grouped admits {out['short_group']}")
    if out["short_group"]["grouped_admits"] < 2:
        raise AssertionError(f"short group admit: {out['short_group']}")

    # 5. copy-on-write
    out["cow_copies"] = b.pool_stats()["cow_copies"]
    out["prefix_cache"] = pc.stats()
    log(f"prefix (kv {kv}): cow_copies {out['cow_copies']} (0 expected); prefix cache "
        f"{json.dumps(out['prefix_cache'])}")
    return out


# -- phase 5, continued: speculative decoding and the ext path ----------------

# the spec phase's traffic, two greedy chats (a byte-level vocab: one token
# a byte). The first asks for a ~300-token passage back, what prompt lookup
# serves in real chat traffic; random weights do not copy, so it drafts
# (almost) nothing and decodes as plain bursts. The second is a long run of
# one character: under so uniform a context this model's greedy output
# settles on a few tokens of its own, which prompt lookup can draft
# (scripts/spec_traffic_probe.py compares such prompts).
SPEC_CHATS = [
    "Repeat this passage word for word:\n\n"
    "The harbour master keeps a ledger of every ship that enters the port: its name, its "
    "flag, its cargo, the berth it takes and the hour of the tide when it arrives. Each "
    "evening the clerk copies the day's entries into the great book, and each spring the "
    "book is bound and carried to the archive above the customs house on the hill.",
    "a" * 1500,
]
SPEC_MAX_TOKENS = 128
# integer/enum-only properties (tests/test_gateway_e2e.py): a length-bounded
# language, so max_tokens cannot truncate the document
EXT_SCHEMA = {"type": "object",
              "properties": {"age": {"type": "integer"}, "tag": {"enum": ["alpha", "beta"]}}}


def record_ids(batcher, sink: list) -> None:
    """Tee every request's prompt and generated ids into ``sink`` as
    (prompt ids, ids): the worker replies with text, and a byte-level
    vocab's filler tokens do not encode back to their ids."""
    orig = batcher.submit_batched

    async def tee(prompt_ids, sp, **kw):
        got: list = []
        sink.append((list(prompt_ids), got))
        async for batch in orig(prompt_ids, sp, **kw):
            got.extend(t[0] if isinstance(t, tuple) else t for t in batch)
            yield batch

    batcher.submit_batched = tee


async def spec_chats(h: Served, registry, runs: int, sink: list) -> dict:
    """Each SPEC_CHATS chat ``runs`` times, one at a time, greedy: texts,
    ids, decode tok/s, and the batcher's spec counters over them."""
    b = registry.loaded_engines()[MID].batcher
    c0 = b.stats.spec_counters()
    chats = []
    for content in SPEC_CHATS:
        rs, ids = [], []
        for _ in range(runs):
            rs.append(await h.chat(content, SPEC_MAX_TOKENS))
            ids.append(sink[-1])
        chats.append(dict(prompt_tokens=rs[0]["usage"]["prompt_tokens"],
                          completion_tokens=[r["usage"]["completion_tokens"] for r in rs],
                          texts=[r["choices"][0]["message"]["content"] for r in rs],
                          ids=ids, tok_s=[r["stats"]["tokens_per_second"] for r in rs]))
    c1 = b.stats.spec_counters()
    spec = {k: c1[k] - c0[k] for k in c1}
    spec["accept_rate"] = spec["accepted"] / spec["drafted"] if spec["drafted"] else 0.0
    return {"chats": chats, "spec": spec, "spec_accept_ewma": b.stats.spec_accept_ewma}


async def spec_phase(torch, h: Served, registry, base: int, sink: list) -> dict:
    """Speculative decoding on (the registry's default): the SPEC_CHATS
    twice each, alone. The prefix cache is dropped first, so both runs of a
    chat admit alike (a cached prompt would take a partial hit the second
    time: a different prefill). Gates: verifies ran and accepted drafts,
    each chat's two texts equal, and the peak device memory over the phase
    within the load estimate."""
    cuda = torch.cuda.is_available() and registry.device.type == "cuda"
    b = registry.loaded_engines()[MID].batcher
    if b.spec_cfg is None or b.spec_cfg.k != SPEC_K:
        raise AssertionError(f"the registry's default is not k={SPEC_K}: {b.spec_cfg}")
    b.drop_prefix_cache()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = await spec_chats(h, registry, 2, sink)
    cm = registry.store.lookup(MID)
    out["estimate_total"] = registry._estimate([str(f) for f in cm.files])["total"]
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(torch) - base) if cuda else 0
    kv = b.cfg.kv_quant
    for i, c in enumerate(out["chats"]):
        log(f"spec (kv {kv}): chat {i} ({c['prompt_tokens']}-token prompt) x2, spec on: "
            f"{c['completion_tokens']} tokens, decode {c['tok_s']} tok/s, texts equal "
            f"{c['texts'][0] == c['texts'][1]}; text {c['texts'][0][:80]!r}")
    log(f"spec (kv {kv}): {json.dumps(out['spec'])}, accept ewma "
        f"{out['spec_accept_ewma']:.3f}; peak over the phase {out['peak_bytes']} bytes "
        f"(estimate {out['estimate_total']})")
    if out["spec"]["verifies"] <= 0 or out["spec"]["accepted"] <= 0:
        raise AssertionError(f"spec on: no verify or no accepted draft: {out['spec']}")
    for c in out["chats"]:
        if c["texts"][0] != c["texts"][1]:
            raise AssertionError(f"spec on: two greedy runs of one chat differ: {c['texts']}")
    if cuda and not out["peak_bytes"] <= out["estimate_total"]:
        raise AssertionError(f"spec phase peak {out['peak_bytes']} above the estimate "
                             f"{out['estimate_total']}")
    return out


def divergence(torch, eng, prompt_ids, ids_a, ids_b) -> dict | None:
    """Where two greedy id streams of one prompt first differ, and the
    logit margin there (the two tokens' logits, and the top two) of a fresh
    prefill of the prompt and the common ids through ``eng``'s model."""
    from nats_llm_studio_tpu_torch.models.llama import forward, make_cache

    j = next((i for i, (x, y) in enumerate(zip(ids_a, ids_b)) if x != y), None)
    if j is None:
        return None if len(ids_a) == len(ids_b) else {"position": min(len(ids_a), len(ids_b)),
                                                      "lengths": [len(ids_a), len(ids_b)]}
    seq = list(prompt_ids) + list(ids_a[:j])
    n = len(seq)
    width = 1 << (n - 1).bit_length()
    cfg, params = eng.cfg, eng.batcher.params
    dev = params["embed"].device
    k1, v1 = make_cache(cfg, 1, width, device=dev)
    toks = torch.tensor([seq + [0] * (width - n)], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, _, _ = forward(params, cfg, toks, k1, v1, torch.zeros((1,), dtype=torch.int32),
                               logit_positions=torch.tensor([n - 1]), fresh_prefill=True)
    row = logits[0, 0].float()
    top = torch.topk(row, 2).values.tolist()
    return {"position": j, "tokens": [int(ids_a[j]), int(ids_b[j])],
            "logits": [float(row[ids_a[j]]), float(row[ids_b[j]])], "top2": top,
            "top2_margin": top[0] - top[1]}


async def spec_off_phase(torch, h: Served, registry, on: dict, sink: list) -> dict:
    """The SPEC_CHATS once each with SPEC_DECODE=0 (information: decode tok/s
    against spec on, and whether the texts equal spec on's; where they
    differ, the first divergent position and its logit margin). Gate: no
    verify ran."""
    b = registry.loaded_engines()[MID].batcher
    if b.spec_cfg is not None:
        raise AssertionError("SPEC_DECODE=0 left speculative decoding on")
    out = await spec_chats(h, registry, 1, sink)
    eng = registry.loaded_engines()[MID]
    kv = b.cfg.kv_quant
    for i, (c, con) in enumerate(zip(out["chats"], on["chats"])):
        (prompt, ids_off), (_, ids_on) = c["ids"][0], con["ids"][0]
        c["same_text_as_spec_on"] = c["texts"][0] == con["texts"][0]
        c["divergence"] = divergence(torch, eng, prompt, ids_on, ids_off)
        log(f"spec (kv {kv}): chat {i} spec off: {c['completion_tokens']} tokens, decode "
            f"{c['tok_s']} tok/s (spec on {con['tok_s']}); text equal to spec on's: "
            f"{c['same_text_as_spec_on']}; divergence {c['divergence']}")
    if any(out["spec"][k] for k in ("verifies", "drafted", "accepted")):
        raise AssertionError(f"SPEC_DECODE=0 still verified: {out['spec']}")
    for c in out["chats"] + on["chats"]:
        c.pop("ids")
    return out


async def ext_phase(h: Served, registry) -> dict:
    """Schema constraints, logprobs and n choices through the worker (the
    SPEC_DECODE=0 registry: the ride-along gate compares a stream beside
    the ext regime's single steps with the same stream alone, and both
    must run the same single-token forward). Gates: a json_schema chat at
    temperature 0.9 returns JSON that meets EXT_SCHEMA; a logprobs chat
    with top_logprobs=3 at temperature 0 has one entry a token, its top
    entry the chosen token; an n=2 chat over a >256-token prompt returns two
    choices and the prefix cache's hits grew; a greedy stream beside a
    constrained chat gives its text alone."""
    b = registry.loaded_engines()[MID].batcher
    out: dict = {}
    rf = {"type": "json_schema", "json_schema": {"name": "person", "schema": EXT_SCHEMA}}

    def meets_schema(text: str) -> dict:
        doc = json.loads(text)
        if not (isinstance(doc, dict) and set(doc) <= {"age", "tag"}
                and (type(doc.get("age", 0)) is int) and doc.get("tag", "alpha") in
                ("alpha", "beta")):
            raise AssertionError(f"the constrained output does not meet the schema: {text!r}")
        return doc

    calls0 = b.stats.program_calls.get("decode_pos_pallas_ext", 0)
    r = await h.chat("Describe a harbour pilot as JSON.", 80, temperature=0.9, seed=7,
                     response_format=rf)
    text = r["choices"][0]["message"]["content"]
    out["schema"] = dict(text=text, doc=meets_schema(text), tokens=r["usage"]["completion_tokens"],
                         finish=r["choices"][0]["finish_reason"],
                         ext_steps=b.stats.program_calls.get("decode_pos_pallas_ext", 0) - calls0)
    log(f"ext: json_schema chat at temperature 0.9: {text!r} ({out['schema']['tokens']} tokens, "
        f"finish {out['schema']['finish']}, {out['schema']['ext_steps']} ext steps)")

    r = await h.chat("Say something about the sea.", 16, logprobs=True, top_logprobs=3)
    content = r["choices"][0]["logprobs"]["content"]
    n_out = r["usage"]["completion_tokens"]
    if len(content) != n_out or any(len(e["top_logprobs"]) != 3
                                    or e["top_logprobs"][0]["token"] != e["token"]
                                    for e in content):
        raise AssertionError(f"logprobs: {n_out} tokens, entries {content}")
    out["logprobs"] = dict(tokens=n_out, first=content[0])
    log(f"ext: logprobs chat at temperature 0: {n_out} tokens, one entry each, the top entry "
        f"the chosen token; first {json.dumps(content[0])[:200]}")

    hits0 = b.prefix_cache.counters()["hits"]
    long_text = ("The pilot boards each ship outside the breakwater and brings it in to "
                 "its berth. " * 6)[:480]
    r = await h.chat(long_text, 12, n=2)
    hits = b.prefix_cache.counters()["hits"] - hits0
    out["n2"] = dict(prompt_tokens=r["usage"]["prompt_tokens"], choices=len(r["choices"]),
                     hits=hits, same_text=len({c["message"]["content"]
                                               for c in r["choices"]}) == 1)
    log(f"ext: n=2 chat: {json.dumps(out['n2'])}")
    if r["usage"]["prompt_tokens"] <= 256 or len(r["choices"]) != 2 or hits < 1:
        raise AssertionError(f"n=2: {out['n2']}")

    rider = "Count slowly from one to thirty."
    alone, _, _ = await h.stream(rider, 64)
    first = asyncio.Event()
    live = asyncio.ensure_future(h.stream(rider, 64, first))
    await asyncio.wait_for(first.wait(), 300)
    calls0 = b.stats.program_calls.get("decode_pos_pallas_ext", 0)
    c = await h.chat("Describe a harbour pilot as JSON.", 80, temperature=0.9, seed=8,
                     response_format=rf)
    beside, _, _ = await live
    meets_schema(c["choices"][0]["message"]["content"])
    ta, tb = (x["choices"][0]["message"]["content"] for x in (alone, beside))
    out["ride_along"] = dict(same_text=ta == tb, tokens=beside["usage"]["completion_tokens"],
                             ext_steps=b.stats.program_calls.get("decode_pos_pallas_ext", 0)
                             - calls0)
    log(f"ext: a greedy stream beside a constrained chat: {json.dumps(out['ride_along'])}")
    if ta != tb:
        raise AssertionError(f"the stream beside a constrained chat differs from alone: "
                             f"{ta!r} vs {tb!r}")
    return out


# which kernel each KV mode's serve phase must launch, and must not
EXPECTED = {
    "none": (("paged_decode_attention", "flash_attention", "flash_attention_chunk"),
             ("paged_decode_attention_kvq", "flash_attention_chunk_kvq")),
    "int8": (("paged_decode_attention_kvq", "flash_attention", "flash_attention_chunk_kvq"),
             ("paged_decode_attention", "flash_attention_chunk")),
}


def allocated(torch) -> int:
    if not torch.cuda.is_available():
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def serve_path(torch, model_root: Path, kv_quant: str, seed: int, counters,
               device: str = "cuda") -> dict:
    """Load the GGUF with the KV cache ``kv_quant`` (speculative decoding
    on: the registry's default), gate its logits, profile a decode step and
    a verify, then serve with every launch counter set to 0 just before and
    read just after: the serve chats and the spec phase with spec on, then,
    in a registry built under SPEC_DECODE=0 (the first closed), the spec
    phase's chats once, under the bf16 KV cache the ext phase, and the
    prefix-cache phase (its gates compare a prefix hit with its miss beside
    a live stream, whose steps must take the same forward). Closes the
    engines and frees the card before it returns."""
    import gc

    from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
    from nats_llm_studio_tpu_torch.store import ModelStore

    def make_registry():
        return TorchRegistry(ModelStore(model_root), device=device, max_seq_len=4096,
                             max_batch_slots=8, kv_quant=kv_quant)

    base = allocated(torch)
    registry = make_registry()
    t0 = time.perf_counter()
    gate = model_phase(torch, registry, seed)
    eng = gate.pop("engine")
    pool = eng.batcher.pool_stats()
    log(f"model (kv {kv_quant}): {eng.cfg.n_layers} layers at Llama-3-8B widths, loaded and "
        f"checked in {time.perf_counter() - t0:.1f} s; max_seq {eng.batcher.max_seq}, "
        f"pool {pool}")
    prof = decode_profile(torch, eng) if device == "cuda" else {}
    sink: list = []
    record_ids(eng.batcher, sink)
    del eng
    for f in counters:
        f.launches = 0

    async def spec_on():
        async with Served(registry) as h:
            return await serve_chats(h, registry, seed), await spec_phase(torch, h, registry,
                                                                          base, sink)

    served, spec = asyncio.run(spec_on())
    asyncio.run(registry.close())
    del registry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    os.environ["SPEC_DECODE"] = "0"
    try:
        registry = make_registry()
    finally:
        os.environ.pop("SPEC_DECODE")

    async def spec_off():
        async with Served(registry) as h:
            record_ids((await registry.get_engine(MID)).batcher, sink)
            off = await spec_off_phase(torch, h, registry, spec, sink)
            ext = await ext_phase(h, registry) if kv_quant == "none" else None
            # last: it ends by dropping the prefix cache for good
            prefix = await prefix_phase(registry, h.chat, h.stream, seed)
            return off, prefix, ext

    spec_off, prefix, ext = asyncio.run(spec_off())
    served["prefix"] = prefix
    launches = {f.__name__: f.launches for f in counters}
    log(f"serve (kv {kv_quant}): kernel launches {launches}")
    must, must_not = EXPECTED[kv_quant]
    for name in must:
        if device == "cuda" and launches[name] <= 0:
            raise AssertionError(f"kv {kv_quant}: {name} was not launched on the main path")
    for name in must_not:
        if launches[name] != 0:
            raise AssertionError(f"kv {kv_quant}: {name} was launched on the main path")
    asyncio.run(registry.close())
    del registry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(gate=gate, pool=pool, prof=prof, served=served, launches=launches,
                spec=dict(on=spec, off=spec_off), ext=ext)


# -- phase 5b: swap-don't-shed ---------------------------------------------------

TIER_STREAMS = 8
# ~240-token prompts (each admitted in one dispatch, so the eight overlap
# when staggered) and 304 tokens: ~544 tokens, 34 blocks a stream, 272 for
# the eight
TIER_TOKENS = 304
TIER_POOL_BLOCKS = 150  # about half of what the eight streams need


def tier_content(k: int, n: int = 700) -> str:
    """``n`` bytes of user text (with the chat template, n + ~20 tokens),
    distinct from its first characters: no two share a cached chunk."""
    words = " ".join(f"wave {k}.{i} breaks on the reef" for i in range(n // 20 + 1))
    return f"Voyage {k}: {words}"[:n]


async def start_staggered(h: Served, contents: list, n: int, headers=None) -> list:
    """Greedy streams, each sent once the one before has its first chunk,
    so each admits alone beside the live ones: the same prefill in every
    run it is compared with. Returns the tasks (stream_env results)."""
    tasks = []
    for c in contents:
        first = asyncio.Event()
        tasks.append(asyncio.ensure_future(stream_env(h, chat_body(c, n), headers=headers,
                                                      first=first)))
        await asyncio.wait_for(first.wait(), 300.0)
    return tasks


def tier_phase(torch, model_root: Path, kv_quant: str, counters,
               device: str = "cuda") -> dict:
    """Swap-don't-shed at full width, SPEC_DECODE=0 (a stream's text must not
    depend on its neighbours). Eight streams (~240-token prompts, 304 tokens
    each) staggered into an ample pool give each stream's text. Then, in a
    registry built with KV_POOL_BLOCKS=150 (launch counters at 0 just
    before, read just after): (A) the same eight streams, staggered alike,
    as X-Priority: batch: their growth parks streams to host memory and
    admits suspend victims; right after the last one's first chunk a
    ~1200-token premium chat, whose admit preempts batch streams (reason
    ``preempted``); (C) a ~600-token chat three times around an evictor:
    its first hit's text, its chunks demoted to the host tier by the
    evictor's insert, then promoted back (K3 or K4 continue from them)
    with the same text. Gates: every stream's text equal to its ample-pool
    text (the first differing position and its logit margin in the
    error), a ``preempted`` suspend, suspended > 0 and resumed =
    suspended, no kv_pool shed, promoted chunks > 0, the pool fully free at
    the end, and the KV mode's kernels. Recorded: suspend and resume ms a
    slot (the readback and the restore, host clock), the bytes a suspended
    slot holds, the host tier's counters, the phase's seconds."""
    import gc

    from nats_llm_studio_tpu_torch.obs import events
    from nats_llm_studio_tpu_torch.parallel.memory import kv_pool_block_bytes
    from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
    from nats_llm_studio_tpu_torch.store import ModelStore

    t_phase = time.perf_counter()
    contents = [tier_content(k, 220) for k in range(TIER_STREAMS)]
    probe, evictor = tier_content(90, 600), tier_content(91, 1100)

    def make_registry(pool_blocks: int = 0):
        env = {"SPEC_DECODE": "0", "KV_POOL_BLOCKS": str(pool_blocks)}
        os.environ.update(env)
        try:
            return TorchRegistry(ModelStore(model_root), device=device, max_seq_len=4096,
                                 max_batch_slots=8, kv_quant=kv_quant)
        finally:
            for k in env:
                os.environ.pop(k)

    def release(registry) -> None:
        asyncio.run(registry.close())
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    ample_ids: list = []
    registry = make_registry()

    async def ample_run():
        async with Served(registry) as h:
            record_ids((await registry.get_engine(MID)).batcher, ample_ids)
            return await asyncio.gather(*await start_staggered(h, contents, TIER_TOKENS))

    want = asyncio.run(ample_run())
    release(registry)
    if not all(r["ok"] for r in want):
        raise AssertionError(f"tier (kv {kv_quant}): an ample-pool stream failed: "
                             f"{[r['error'] for r in want]}")

    registry = make_registry(TIER_POOL_BLOCKS)
    tight_ids: list = []
    out: dict = {}

    async def tight_run():
        async with Served(registry) as h:
            eng = await registry.get_engine(MID)
            b = eng.batcher
            record_ids(b, tight_ids)
            pool = b.pool_stats()
            if pool["blocks_total"] != TIER_POOL_BLOCKS or b.kv_tiers is None or not b.kv_suspend:
                raise AssertionError(f"tier: KV_POOL_BLOCKS / the host tier did not reach the "
                                     f"batcher: {pool}, tiers {b.kv_tiers}")
            for f in counters:
                f.launches = 0
            seq0 = events.EVENTS.emitted
            t0 = time.perf_counter()
            tasks = await start_staggered(h, contents, TIER_TOKENS, {"X-Priority": "batch"})
            seq_p = events.EVENTS.emitted
            prem = await stream_env(h, chat_body(tier_content(92, 1180), 16),
                                    headers={"X-Priority": "premium"})
            got = await asyncio.gather(*tasks)
            await wait_for(lambda: b.idle, "the storm to drain")
            out["storm_s"] = time.perf_counter() - t0
            if not prem["ok"]:
                raise AssertionError(f"tier (kv {kv_quant}): the premium chat failed: "
                                     f"{prem['error']}")
            for i, r in enumerate(got):
                if not r["ok"]:
                    raise AssertionError(f"tier (kv {kv_quant}): stream {i} failed: "
                                         f"{r['error']}")
                if r["text"] != want[i]["text"]:
                    prompt, ids = ample_ids[i]
                    mine = next(x for p, x in tight_ids if p == prompt)
                    raise AssertionError(
                        f"tier (kv {kv_quant}): stream {i}'s text departs from its "
                        f"ample-pool text: {divergence(torch, eng, prompt, ids, mine)}")
            out["after_storm"] = {**b.tier_stats(), "pool": b.pool_stats()}
            # C: a first hit, its chunks demoted by an evictor, then promoted
            texts, hits = [], []
            for content in (probe, probe, evictor, probe):
                h0, p0 = b.prefix_cache.hit_tokens, b.tier_stats()["promoted_chunks"]
                r = await h.chat(content, 16)
                texts.append(r["choices"][0]["message"]["content"])
                hits.append((b.prefix_cache.hit_tokens - h0,
                             b.tier_stats()["promoted_chunks"] - p0))
            out["promote"] = {"hits": hits, "same_text": texts[3] == texts[1]}
            if hits[1][0] <= 0 or hits[3][0] <= 0 or hits[3][1] <= 0:
                raise AssertionError(f"tier (kv {kv_quant}): no hit or no promotion: "
                                     f"(hit tokens, promoted chunks) {hits}")
            if texts[3] != texts[1]:
                raise AssertionError(f"tier (kv {kv_quant}): the promoted prefix's text "
                                     f"departs from its first hit's: {texts[1]!r} vs "
                                     f"{texts[3]!r}")
            out["launches"] = {f.__name__: f.launches for f in counters}
            b.drop_prefix_cache()  # the pool must be all free now
            evs = [e for e in events.EVENTS.snapshot() if e["seq"] >= seq0
                   and e["kind"] in ("slot_suspend", "slot_resume")]
            preempted = [e for e in evs if e["seq"] >= seq_p and e["reason"] == "preempted"]
            if not preempted:
                raise AssertionError(f"tier (kv {kv_quant}): the premium admit preempted "
                                     f"no batch stream")
            return (b.tier_stats(), b.pool_stats(), b.stats.shed_cause_counts(), evs,
                    kv_pool_block_bytes(b.cfg, b.kv_block_tokens))

    st, pool, sheds, evs, block = asyncio.run(tight_run())
    release(registry)
    sus = [e for e in evs if e["kind"] == "slot_suspend"]
    res = [e for e in evs if e["kind"] == "slot_resume"]
    out.update(
        suspended_total=st["suspended_total"], resumed_total=st["resumed_total"],
        reasons={r: sum(e["reason"] == r for e in sus) for r in {e["reason"] for e in sus}},
        suspend_ms=[e["ms"] for e in sus], resume_ms=[e["ms"] for e in res],
        suspended_bytes=[e["blocks"] * block for e in sus],
        host_tier={k: st[k] for k in ("host_bytes", "host_entries", "demoted_chunks",
                                      "promoted_chunks", "demoted_blocks", "host_hits")},
        sheds=sheds, pool=pool, seconds=time.perf_counter() - t_phase)
    log(f"tier (kv {kv_quant}): {json.dumps(out)}")
    if not (st["suspended_total"] > 0 and st["resumed_total"] == st["suspended_total"]):
        raise AssertionError(f"tier (kv {kv_quant}): suspended {st['suspended_total']}, "
                             f"resumed {st['resumed_total']}")
    if sheds.get("kv_pool", 0):
        raise AssertionError(f"tier (kv {kv_quant}): kv_pool sheds {sheds}")
    if pool["blocks_free"] != pool["blocks_total"]:
        raise AssertionError(f"tier (kv {kv_quant}): the pool is not free at the end: {pool}")
    must, must_not = EXPECTED[kv_quant]
    for name in must:
        if device == "cuda" and out["launches"][name] <= 0:
            raise AssertionError(f"tier (kv {kv_quant}): {name} was not launched")
    for name in must_not:
        if out["launches"][name] != 0:
            raise AssertionError(f"tier (kv {kv_quant}): {name} was launched")
    return out


# -- phase 6: overload control and supervision -----------------------------------

MIDP = "downloads/smoke-2layer"  # the overload phase's poison model (file:// pull)
PROM_LINE = (r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+'
             r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})? '
             r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|Inf|NaN))$')
ADMIT_PROGRAMS = ("admit_fused_paged", "admit_many_fused_paged", "prefill_full", "prefill1",
                  "prefill_chunk_group", "sample_first")


class InjectedCrash(BaseException):
    """A fault that escapes the owner loop's dispatch handlers (they catch
    Exception): the loop ends, as on a real pump crash."""


def arm_crash(b) -> None:
    """Make the next decode dispatch of batcher ``b`` (a burst or a verify)
    raise InjectedCrash once; the programs are restored before it raises,
    so nothing of the fault stays on the batcher."""
    names = ("_decode_pos_pallas", "_spec_verify_pallas")
    orig = {n: getattr(b, n) for n in names}

    def faulty(*a, **kw):
        for n, f in orig.items():
            setattr(b, n, f)
        raise InjectedCrash("injected into a decode program")

    for n in names:
        setattr(b, n, faulty)


async def stream_env(h, body: dict, headers: dict | None = None,
                     first: asyncio.Event | None = None,
                     stop: asyncio.Event | None = None,
                     subject: str = "lmstudio.chat_model") -> dict:
    """One streamed chat (on ``h.nc``) to its terminal envelope: {ok, error,
    text, t_first, t_end, chunks} (monotonic times); a set ``stop`` closes
    the stream after the next chunk (the worker then cancels the request)."""
    out = {"ok": False, "error": None, "text": "", "t_first": None, "chunks": 0}
    agen = h.nc.request_stream(subject, json.dumps({**body, "stream": True}).encode(),
                               timeout=300.0, headers=headers)
    try:
        async for msg in agen:
            env = json.loads(msg.payload)
            done = bool(msg.headers and "Nats-Stream-Done" in msg.headers) or (
                env.get("ok") and "response" in env.get("data", {}))
            if not env.get("ok"):
                out["error"] = env.get("error")
                out["retryable"] = env.get("retryable")
                break
            if done:
                out["ok"] = True
                out["final"] = env["data"]["response"]
                break
            if out["t_first"] is None:
                out["t_first"] = time.monotonic()
                if first is not None:
                    first.set()
            out["chunks"] += 1
            out["text"] += env["data"]["chunk"]["choices"][0]["delta"]["content"]
            if stop is not None and stop.is_set():
                out["error"] = "closed by the client"
                break
    finally:
        await agen.aclose()
        if first is not None:
            first.set()  # an error before the first chunk ends the wait too
    out["t_end"] = time.monotonic()
    return out


def chat_body(content: str, n: int, **kw) -> dict:
    return {"model": MID, "messages": [{"role": "user", "content": content}],
            "temperature": 0, "max_tokens": n, **kw}


async def chat_env(h: Served, body: dict, headers: dict | None = None,
                   timeout: float = 120.0) -> dict:
    msg = await h.nc.request("lmstudio.chat_model", json.dumps(body).encode(),
                             timeout=timeout, headers=headers)
    return json.loads(msg.payload)


async def subject(h: Served, name: str, body=None, timeout: float = 30.0):
    msg = await h.nc.request(f"lmstudio.{name}", json.dumps(body or {}).encode(),
                             timeout=timeout)
    return msg.payload if name == "metrics.prom" else json.loads(msg.payload)


async def live_streams(h: Served, n: int, tokens, content: str = "Tell a long story about "
                       "the sea and the ships on it.") -> tuple[list, list]:
    """``n`` greedy streams (``tokens`` each, or a list), returned once every
    one has its first chunk: (tasks, stop events)."""
    tokens = tokens if isinstance(tokens, list) else [tokens] * n
    firsts = [asyncio.Event() for _ in range(n)]
    stops = [asyncio.Event() for _ in range(n)]
    tasks = [asyncio.ensure_future(stream_env(h, chat_body(content, tokens[i]),
                                              first=firsts[i], stop=stops[i]))
             for i in range(n)]
    await asyncio.wait_for(asyncio.gather(*(f.wait() for f in firsts)), 300.0)
    failed = [t.result()["error"] for t in tasks if t.done() and not t.result()["ok"]]
    if failed:
        raise AssertionError(f"overload: live streams failed: {failed}")
    return tasks, stops


async def wait_for(pred, what: str, timeout: float = 60.0, step: float = 0.02):
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"overload: timed out waiting for {what}")
        await asyncio.sleep(step)


async def settle(h: Served, b) -> None:
    """Wait for an idle batcher at brownout level 0. The owner loop ticks
    the controller only while it has work, so a trickle of short chats
    carries it through the dwell."""
    await wait_for(lambda: b.idle, "an idle batcher")
    t_end = time.monotonic() + 30.0
    while b.brownout_level != 0:
        if time.monotonic() > t_end:
            raise AssertionError("overload: the level did not come back to normal")
        await chat_env(h, chat_body("calm", 4))
        await asyncio.sleep(0.1)


async def overload_phase(torch, model_root: Path, staging: Path, seed: int,
                         device: str = "cuda") -> dict:
    """Overload control and supervision through the Worker over NATS, bf16
    KV, 8 slots, the 32-layer model (speculative decoding on, as served):

    deadlines: with 8 streams live, a chat whose X-Deadline-Ms has passed is
    shed at submit (no admit or prefill program runs), a queued chat whose
    300 ms deadline passes before a slot frees is shed before prefill, and
    a lone stream whose 2 s deadline passes mid-decode ends retryably with
    ``deadline exceeded mid-decode`` (deadline to terminal envelope
    recorded); the pool's free blocks come back. QoS (DRR quantum 16): with
    one slot freeing, a premium chat queued after a batch one is admitted
    first. Queue bounds and brownout (ADMIT_QUEUE_LIMIT 16, dwell 1 s): 8
    live streams and a burst of 24 chats, then 4 more once SHED_ONLY is
    reached: depth and fair-share sheds past the bound, brownout sheds, every chat gets a terminal
    envelope (served + shed = sent), the SHED_ONLY edge parks live streams
    (resumed once the level drops), the events ring shows brownout ->
    shed_only -> ... -> normal under a trickle, a drafting stream sent once
    the queued chats are answered starts at level >= 1 and no verify runs
    at level >= 1, and the lmstudio_brownout_level gauge follows the level. A ~4000-token
    prompt prefilled in chunks beside a live stream (K3): the largest
    heartbeat age, and no hang declared; meanwhile profile (a Chrome trace
    naming paged_decode_mma_kernel), debug.snapshot (slot refcounts = the
    pool's) and debug.dump (a file under OBS_DUMP_DIR). Supervision: a
    crash injected into a decode program, the supervisor's restart, the
    same greedy text, memory_allocated within 1% of before the crash; on a
    2-layer model at the same widths, pulled by file:// URL, two crashes
    poison it (max_restarts 1), chats get the retryable envelope, health
    names it, delete_model + pull_model reset it. metrics names the card,
    every line of metrics.prom parses, events hold the brownout and
    engine_supervisor transitions, a chat's stats.trace holds its stages in
    order. The loop's cost: wall ms per decode step at 8 slots with the
    recorder on and off, and with the efficiency plane on and off."""
    import gc
    import re

    from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
    from nats_llm_studio_tpu_torch.store import ModelStore
    from nats_llm_studio_tpu_torch.transport.envelope import deadline_header_value

    out: dict = {}
    dumps = staging.parent / "dumps"
    knobs = {"BROWNOUT_DWELL_S": "1.0"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        registry = TorchRegistry(ModelStore(model_root), device=device, max_seq_len=4096,
                                 max_batch_slots=8, kv_quant="none", admit_queue_limit=16,
                                 restart_backoff_s=0.5, max_restarts=1,
                                 obs_recorder_interval_ms=50.0, obs_dump_dir=str(dumps),
                                 qos_quantum_tokens=16)
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.update({k: v})

    def batcher():
        return registry.loaded_engines()[MID].batcher

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            raise AssertionError(f"overload: {msg}")

    async with Served(registry, store=True, supervise_interval_s=0.5,
                      debug_subjects=True) as h:
        t_phase = time.perf_counter()
        # 0. the lone greedy chat every supervision gate compares against,
        # and its stage waterfall
        sea = chat_body("Say something about the sea.", 32)
        env = await chat_env(h, sea)
        gate(env.get("ok"), f"first chat: {env}")
        text0 = env["data"]["response"]["choices"][0]["message"]["content"]
        tr = env["data"]["response"]["stats"]["trace"]
        order = ["recv", "enqueue", "admit", "prefill", "first_token", "decode_done", "publish"]
        gate(list(tr["marks_ms"]) == order
             and [tr["marks_ms"][k] for k in order] == sorted(tr["marks_ms"].values())
             and env.get("trace_id") == tr["trace_id"], f"stats.trace out of order: {tr}")
        out["trace"] = tr
        free0 = batcher().pool_stats()["blocks_free"]
        log(f"overload: load + first chat {time.perf_counter() - t_phase:.1f} s; trace {tr}")

        # 1. deadlines
        b = batcher()
        tasks, _ = await live_streams(h, 8, 100)
        req0, admits0 = b.stats.requests, {k: b.stats.program_calls.get(k, 0)
                                           for k in ADMIT_PROGRAMS}
        env = await chat_env(h, chat_body("late", 8),
                             {"X-Deadline-Ms": deadline_header_value(-1.0)})
        gate(not env["ok"] and env.get("retryable") is True
             and "deadline already expired at submit (shed_cause=deadline)" in env["error"],
             f"expired deadline: {env}")
        gate({k: b.stats.program_calls.get(k, 0) for k in ADMIT_PROGRAMS} == admits0
             and b.stats.requests == req0, "the expired chat ran an admit or prefill program")
        t_send = time.monotonic()
        env = await chat_env(h, chat_body("queued", 8),
                             {"X-Deadline-Ms": deadline_header_value(0.3)})
        queued_ms = (time.monotonic() - t_send - 0.3) * 1e3
        gate(not env["ok"] and env.get("retryable") is True and "(shed_cause=deadline)" in env["error"]
             and ("queued" in env["error"] or "skipped prefill" in env["error"]),
             f"queued deadline: {env}")
        gate(b.stats.requests == req0, "the queued chat was admitted")
        streams = await asyncio.gather(*tasks)
        gate(all(s["ok"] for s in streams), f"live streams: {[s['error'] for s in streams]}")
        t_send = time.monotonic()
        s = await stream_env(h, chat_body("Tell an endless story.", 3000),
                             {"X-Deadline-Ms": deadline_header_value(2.0)})
        abort_ms = (s["t_end"] - t_send - 2.0) * 1e3
        gate(not s["ok"] and s.get("retryable") is True
             and "deadline exceeded mid-decode after" in (s["error"] or ""),
             f"mid-decode deadline: {s}")
        await wait_for(lambda: b.idle, "the aborted slot to free")
        await wait_for(lambda: b.pool_stats()["blocks_free"] == free0,
                       "the pool's free blocks to come back", timeout=5.0)
        out["deadline"] = {"queued_shed_after_deadline_ms": queued_ms,
                           "abort_after_deadline_ms": abort_ms,
                           "abort_tokens": s["chunks"], "shed_causes": b.stats.shed_cause_counts(),
                           "queued_error": env["error"]}
        log(f"overload: deadlines: shed at submit; queued shed {queued_ms:.0f} ms after its "
            f"deadline; mid-decode abort's terminal envelope {abort_ms:.0f} ms after its "
            f"deadline ({s['chunks']} chunks); free blocks back to {free0}")

        # 2. QoS: one slot frees with a batch and a premium chat queued
        tasks, stops = await live_streams(h, 8, [400] * 7 + [24])
        hdr = {"lowco": {"X-Tenant": "lowco", "X-Priority": "batch"},
               "bigco": {"X-Tenant": "bigco", "X-Priority": "premium"}}
        ask = "Describe the harbour at dawn, the boats, the gulls and the fishermen."
        qos = {"lowco": asyncio.ensure_future(stream_env(h, chat_body(ask, 8), hdr["lowco"]))}
        await wait_for(lambda: b.queue_depth >= 1, "the batch chat to queue")
        qos["bigco"] = asyncio.ensure_future(stream_env(h, chat_body(ask, 8), hdr["bigco"]))
        await wait_for(lambda: b.queue_depth >= 2, "the premium chat to queue")
        prem = await qos["bigco"]
        for st in stops:
            st.set()
        low = await qos["lowco"]
        await asyncio.gather(*tasks)
        gate(prem["ok"] and low["ok"], f"qos chats: {prem['error']} / {low['error']}")
        gate(prem["t_first"] < low["t_first"], "the batch chat was admitted before the premium")
        tenants = b.tenant_stats.snapshot()
        gate(all(tenants.get(t, {}).get("served", 0) >= 1 for t in ("lowco", "bigco")),
             f"tenant stats: {tenants}")
        out["qos"] = {"premium_first_by_s": low["t_first"] - prem["t_first"],
                      "tenants": {t: tenants[t] for t in ("lowco", "bigco")}}
        log(f"overload: qos: premium admitted {out['qos']['premium_first_by_s']:.2f} s before "
            f"the batch chat queued ahead of it; tenants {out['qos']['tenants']}")
        await settle(h, b)

        # 3. queue bounds and brownout
        verify_levels: list = []
        verify = b._spec_verify_pallas

        def spy(*a, **kw):
            verify_levels.append(b.brownout_level)
            return verify(*a, **kw)

        b._spec_verify_pallas = spy
        ev0 = (await subject(h, "events", {"limit": 1}))["data"]["emitted_total"]
        tasks, _ = await live_streams(h, 8, 120)
        sent = 8
        burst = [asyncio.ensure_future(chat_env(h, chat_body(f"burst {i}", 8)))
                 for i in range(24)]
        sent += 24
        gauges = []
        late: list = []
        t_end = time.monotonic() + 120.0
        # until the queued chats are answered (the live streams, half of
        # them parked on the SHED_ONLY edge until the level drops, may still
        # be decoding)
        while not (all(f.done() for f in burst + late)
                   and (late or all(t.done() for t in tasks))):
            lvl0 = b.brownout_level
            text = (await subject(h, "metrics.prom")).decode()
            m = re.search(r'^lmstudio_brownout_level\{[^}]*model="%s"[^}]*\} (\d+)$'
                          % re.escape(MID), text, re.M)
            gauges.append((lvl0, int(m.group(1)), b.brownout_level))
            if b.brownout_level == 2 and not late:
                late = [asyncio.ensure_future(chat_env(h, chat_body(f"late {i}", 8)))
                        for i in range(4)]
                sent += 4
            gate(time.monotonic() < t_end, "the storm did not drain")
            await asyncio.sleep(0.05)
        # a premium stream that drafts (a run of one character, PERF.md
        # §4) while the level steps down: paused verifies at level >= 1,
        # verifies once it is back at 0 and the live streams have ended
        lvl = b.brownout_level
        s = await stream_env(h, chat_body("a" * 1500, 200), {"X-Priority": "premium"})
        await asyncio.gather(*tasks)
        results = [f.result() for f in burst + late] + [t.result() for t in tasks]
        served = sum(1 for r in results if r.get("ok"))
        shed = [r["error"] for r in results if not r.get("ok")]
        gate(all(r.get("retryable") is True and "shed_cause=" in e for r, e in
                 zip([r for r in results if not r.get("ok")], shed)), f"sheds: {shed}")
        causes = {c: sum(f"shed_cause={c}" in e for e in shed)
                  for c in ("depth", "fair_share", "brownout")}
        gate(served + len(shed) == sent, f"served {served} + shed {len(shed)} != sent {sent}")
        gate(causes["depth"] + causes["fair_share"] > 0 and late and all(not f.result()["ok"] and "brownout shed-only"
                                                   in f.result()["error"] for f in late),
             f"storm sheds: {causes}, late {[f.result() for f in late]}")
        gate(all(g[1] in (g[0], g[2]) for g in gauges) and max(g[1] for g in gauges) == 2,
             f"the brownout gauge left the level: {gauges}")
        gate(lvl >= 1 and s["ok"], f"the drafting stream at level {lvl}: {s['error']}")
        await settle(h, b)  # back to normal under a trickle
        evs = [e for e in (await subject(h, "events", {"kind": "brownout", "limit": 100})
                           )["data"]["events"] if e["seq"] >= ev0]
        names = [e["level_name"] for e in evs]
        gate("brownout" in names and "shed_only" in names and names[-1] == "normal"
             and names.index("brownout") < names.index("shed_only"), f"brownout events {names}")
        text = (await subject(h, "metrics.prom")).decode()
        gate(re.search(r'^lmstudio_brownout_level\{[^}]*model="%s"[^}]*\} 0$'
                       % re.escape(MID), text, re.M) is not None, "the gauge did not return to 0")
        b._spec_verify_pallas = verify
        gate(verify_levels and all(lvl == 0 for lvl in verify_levels),
             f"verifies ran at levels {verify_levels}")
        out["brownout"] = {"sent": sent, "served": served, "shed": len(shed), "causes": causes,
                           "events": names, "verifies_at_level0": len(verify_levels),
                           "gauge_samples": len(gauges), "suspends": dict(b._suspend_stats)}
        log(f"overload: storm: sent {sent}, served {served}, shed {len(shed)} {causes}; "
            f"levels {names}; a drafting stream from level {lvl}: {len(verify_levels)} "
            f"verifies, all at level 0; suspends {out['brownout']['suspends']}")

        # 4. the loop's cost at 8 slots, recorder on and off (on, off, off,
        # on), then the efficiency plane off (twice) and on
        async def loop_cost(on: bool, tokens: int, eff: bool = True) -> dict:
            """Wall ms a decode step of 8 streams, from their first chunks
            to their ends (the admits left out). The kernels a step are
            decode_profile's (serve_path, the same registry settings):
            profiler sessions on two threads of one process lost their
            kernels in some orders on the card, so the loop is not
            profiled here."""
            b.recorder.enabled = on
            b._efficiency = eff
            tasks, _ = await live_streams(h, 8, tokens, "count the waves")
            steps0, t0 = b.stats.steps, time.perf_counter()
            await asyncio.gather(*tasks)
            steps = b.stats.steps - steps0
            return {"recorder": on, "efficiency": eff, "steps": steps,
                    "wall_ms_per_step": (time.perf_counter() - t0) * 1e3 / steps}

        cost = [await loop_cost(on, 40, eff) for on, eff in (
            (True, True), (False, True), (False, True), (True, True), (True, False),
            (True, False), (True, True))]
        b.recorder.enabled = True
        b._efficiency = True
        out["loop_cost"] = cost
        for c in cost:
            log(f"overload: 8 streams, recorder {'on ' if c['recorder'] else 'off'}, "
                f"efficiency plane {'on ' if c['efficiency'] else 'off'}: "
                f"{c['wall_ms_per_step']:.2f} ms wall a decode step ({c['steps']} steps)")

        # 5. a ~4000-token prompt prefilled in chunks beside a live stream:
        # the heartbeat; then, beside a stream, profile and the debug subjects
        await settle(h, b)
        tasks, stops = await live_streams(h, 1, 600)
        hb = [0.0]
        long_chat = asyncio.ensure_future(chat_env(h, chat_body("a" * 3990, 4)))
        while not long_chat.done():
            hb[0] = max(hb[0], b.heartbeat_age_s())
            await asyncio.sleep(0.005)
        env = long_chat.result()
        gate(env["ok"] and env["data"]["response"]["usage"]["prompt_tokens"] > 3900,
             f"long chat: {env.get('error')}")
        n_long = env["data"]["response"]["usage"]["prompt_tokens"]
        snap = (await subject(h, "debug.snapshot", {"model": MID}))["data"]["engines"][MID]
        gate(bool(snap["slots"]) and all(
            e["block_refcounts"] == [b._pool.refcount(x) for x in e["blocks"]]
            for e in snap["slots"].values()), f"debug.snapshot slots: {snap['slots']}")
        dump = await subject(h, "debug.dump", {"model": MID})
        gate(dump["ok"] and dump["data"]["dumps"][MID].startswith(str(dumps))
             and Path(dump["data"]["dumps"][MID]).exists(), f"debug.dump: {dump}")
        prof = await subject(h, "profile", {"seconds": 1.0}, timeout=120.0)
        gate(prof["ok"] and prof["data"].get("bucket") == "profiles", f"profile: {prof}")
        trace_text = Path(prof["data"]["trace_file"]).read_text()
        gate(device != "cuda" or "paged_decode_mma_kernel" in trace_text,
             "the profile trace does not name paged_decode_mma_kernel")
        stops[0].set()
        await asyncio.gather(*tasks)
        hung = [e for e in (await subject(h, "events", {"kind": "engine_supervisor",
                                                        "limit": 100}))["data"]["events"]
                if "hung" in e["state"]]
        gate(not hung, f"the supervisor declared the engine hung: {hung}")
        out["heartbeat_max_age_s"] = hb[0]
        out["profile"] = {"trace_bytes": len(trace_text), "bucket": prof["data"].get("bucket")}
        log(f"overload: heartbeat age at most {hb[0]:.3f} s over a {n_long}-token chunked "
            f"prefill beside a stream; profile trace {len(trace_text)} bytes names "
            f"paged_decode_mma_kernel; debug.dump {dump['data']['dumps'][MID]}")

        del b, verify, spy

        # 6. crash, supervised restart, the same text, the memory back
        await settle(h, batcher())
        gc.collect()
        mem_before = allocated(torch)
        arm_crash(batcher())
        t_crash = time.monotonic()
        env = await chat_env(h, sea)
        gate(not env["ok"] and env.get("retryable") is True
             and "engine crashed (InjectedCrash: injected into a decode program)" in env["error"],
             f"crash envelope: {env}")
        await wait_for(lambda: registry.engine_restarts_total == 1, "the restart", 300.0)
        t_restarted = time.monotonic()
        evs = (await subject(h, "events", {"limit": 500}))["data"]["events"]
        crash_ev = [e for e in evs if e["kind"] == "engine_crash"][-1]
        sup_ev = [e for e in evs if e["kind"] == "engine_supervisor" and e["state"] == "crashed"
                  and e["model"] == MID][-1]
        detect_s = sup_ev["mono"] - crash_ev["mono"]
        gate(detect_s <= 0.5 + 0.5, f"the supervisor saw the crash after {detect_s:.2f} s")
        gc.collect()
        mem_after = allocated(torch)
        gate(abs(mem_after - mem_before) <= 0.01 * mem_before,
             f"memory after the restart {mem_after} vs {mem_before} before the crash")
        env = await chat_env(h, sea)
        gate(env["ok"] and env["data"]["response"]["choices"][0]["message"]["content"] == text0,
             "the greedy text after the restart differs")
        out["restart"] = {"detect_s": detect_s, "crash_to_restarted_s": t_restarted - t_crash,
                          "restart_ms": registry.restart_latency_ms.snapshot().total,
                          "mem_before": mem_before, "mem_after": mem_after,
                          "kernel_build_s": registry.kernel_build_s}
        log(f"overload: crash seen by the supervisor after {detect_s:.2f} s, restarted "
            f"{t_restarted - t_crash:.1f} s after the crash (restart_engine "
            f"{out['restart']['restart_ms']:.0f} ms, kernels built in "
            f"{registry.kernel_build_s:.2f} s); memory {mem_before} -> {mem_after} bytes; "
            f"same greedy text")

        # 7. poison on a 2-layer model at the same widths, and its reset
        staged = staging / "smoke-2layer.gguf"
        write_gguf(torch, staged, 2, seed + 7, device=device)
        url = {"identifier": f"file://{staged}"}
        gate((await subject(h, "pull_model", url, timeout=300.0))["ok"], "pull of the 2-layer")
        small = dict(chat_body("Say something about the sea.", 8), model=MIDP)
        for i in range(2):
            gate((await chat_env(h, small))["ok"], f"2-layer chat before crash {i + 1}")
            arm_crash(registry.loaded_engines()[MIDP].batcher)
            env = await chat_env(h, small)
            gate(not env["ok"] and "engine crashed" in env["error"], f"2-layer crash: {env}")
            if i == 0:
                await wait_for(lambda: registry.engine_restarts_total == 2, "the 2-layer restart")
        await wait_for(lambda: MIDP in registry.poisoned_models(), "the poison")
        env = await chat_env(h, small)
        gate(not env["ok"] and env.get("retryable") is True and env["error"].startswith(
            f"error in chat: model {MIDP} is poisoned (2 crashes in 120s (last: crashed)); "
            f"delete or pull it to reset"), f"poisoned envelope: {env}")
        health = (await subject(h, "health"))["data"]
        gate(health.get("poisoned") == [MIDP] and health["poisoned_reasons"][MIDP].startswith(
            "2 crashes in 120s"), f"health.poisoned: {health.get('poisoned')}")
        gate((await subject(h, "delete_model", {"model_id": MIDP}))["ok"], "delete")
        gate((await subject(h, "pull_model", url, timeout=300.0))["ok"], "pull after delete")
        gate(not registry.poisoned_models() and (await chat_env(h, small))["ok"],
             "the 2-layer model still refused after delete + pull")
        gate((await subject(h, "delete_model", {"model_id": MIDP}))["ok"], "final delete")
        staged.unlink()
        out["poison"] = {"error": env["error"]}

        # 8. the remaining observability gates
        metrics = (await subject(h, "metrics"))["data"]
        gate(device != "cuda" or metrics["devices"][0] == {
            "id": 0, "platform": "gpu", "kind": torch.cuda.get_device_name(0)},
            f"metrics.devices: {metrics['devices']}")
        text = (await subject(h, "metrics.prom")).decode()
        bad = [ln for ln in text.splitlines() if ln and not re.match(PROM_LINE, ln)]
        gate(not bad, f"metrics.prom lines that do not parse: {bad[:3]}")
        kinds = {e["kind"] for e in (await subject(h, "events", {"limit": 500}))["data"]["events"]}
        gate({"brownout", "engine_supervisor", "engine_restart", "engine_poisoned"} <= kinds,
             f"event kinds: {sorted(kinds)}")
        out["prom_lines"] = len(text.splitlines())
        out["seconds"] = time.perf_counter() - t_phase
    await registry.close()
    del registry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"overload: phase ok in {out['seconds']:.1f} s")
    return out


# -- phase 6b: cluster membership and the efficiency plane ------------------------

CLUSTER_BUDGET = 36_000_000_000  # each worker's TPU_HBM_BUDGET_BYTES on the shared card
ADVERT_S = 0.5  # CLUSTER_ADVERT_INTERVAL_S of both workers
DRAIN_STREAMS = 3
DRAIN_TOKENS = 128


async def http_chat(port: int, body: dict) -> tuple[int, bytes, float | None]:
    """POST /v1/chat/completions to the gateway: (status, body, seconds to
    the first SSE data line, None when unary). The gateway closes the
    connection after the response."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    t0 = time.perf_counter()
    writer.write(f"POST /v1/chat/completions HTTP/1.1\r\nHost: smoke\r\n"
                 f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
                 f"Connection: close\r\n\r\n".encode() + data)
    await writer.drain()
    raw, t_first = b"", None
    while chunk := await reader.read(65536):
        raw += chunk
        if t_first is None and b"\r\n\r\ndata: " in raw:
            t_first = time.perf_counter() - t0
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload, t_first


def sse_text(payload: bytes) -> str:
    parts = []
    for line in payload.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            parts.append(json.loads(line[6:])["choices"][0].get("delta", {}).get("content") or "")
    return "".join(parts)


async def cluster_phase(torch, model_root: Path, work: Path, counters, prof: dict | None,
                        device: str = "cuda") -> dict:
    """Two port workers on one broker: A in this process, B a
    ``python -m nats_llm_studio_tpu_torch serve`` subprocess over the same
    models dir (each with its own TPU_HBM_BUDGET_BYTES; bf16 KV, 8 slots,
    SPEC_DECODE=0 so a row's step is the same forward on either worker),
    the port's RouterProcess with the fleet aggregator embedded and the
    port's gateway on a local port. Gates: both adverts within two
    intervals (slots 8, the model, not draining, headroom in (0, 1]); the
    same greedy text from A, B, the gateway (unary and SSE) and
    route.chat_model; a repeated prompt steered to the worker whose heads
    hold it; the excluded-workers bounce, then the router's RetryPolicy
    serves it on B; the merged exposition carries both workers' MFU/MBU;
    prefill MFU and decode MBU (raw rates before the clamp) in (0, 1.05];
    a drain with three streams live on A (deadline 1 s): at least one is
    cut, every cut stream ends in the retryable draining envelope and its
    retry is served by B with the text B gave it undrained (a stream done
    before the deadline has that text), A's next advert says draining, and A's
    memory_allocated comes back to its value before the load within 1% of
    the engine; the device-time ledger's categories sum to
    dispatch_ms_total within 10% and its served tokens equal the tokens
    delivered; no hbm_drift on worker B (this process's are counted by
    main); K1, K2 and K3 ran in A, K1q and K4 did not."""
    import gc
    import re
    import signal

    from nats_llm_studio_tpu_torch.config import WorkerConfig
    from nats_llm_studio_tpu_torch.gateway import Gateway
    from nats_llm_studio_tpu_torch.obs import Aggregator
    from nats_llm_studio_tpu_torch.obs.roofline import ForwardCost, chip_peaks
    from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
    from nats_llm_studio_tpu_torch.serve.router import RouterProcess, prompt_head_hash
    from nats_llm_studio_tpu_torch.serve.worker import Worker
    from nats_llm_studio_tpu_torch.store import ModelStore
    from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, RetryPolicy, connect
    from nats_llm_studio_tpu_torch.transport import protocol as p

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            raise AssertionError(f"cluster: {msg}")

    def text_of(env: dict) -> str:
        gate(bool(env.get("ok")), f"chat failed: {env}")
        return env["data"]["response"]["choices"][0]["message"]["content"]

    out: dict = {}
    t_phase = time.perf_counter()
    on_a = "lmstudio.worker.w-a.chat_model"
    saved = os.environ.get("TPU_HBM_BUDGET_BYTES")
    os.environ["TPU_HBM_BUDGET_BYTES"] = str(CLUSTER_BUDGET)
    broker = await EmbeddedBroker().start()
    registry = TorchRegistry(ModelStore(model_root), device=device, max_seq_len=4096,
                             max_batch_slots=8, kv_quant="none", spec_decode_k=0)
    wa = Worker(WorkerConfig(nats_url=broker.url, worker_id="w-a",
                             cluster_advert_interval_s=ADVERT_S), registry)
    log_b = open(work / "worker-b.log", "wb")
    env_b = {**os.environ, "NATS_URL": broker.url, "LMSTUDIO_MODELS_DIR": str(model_root),
             "WORKER_ID": "w-b", "CLUSTER_ADVERT_INTERVAL_S": str(ADVERT_S),
             "SPEC_DECODE": "0", "MAX_SEQ_LEN": "4096", "MAX_BATCH_SLOTS": "8",
             "TPU_KV_QUANT": "none", "PYTHONPATH": str(ROOT)}
    proc_b = subprocess.Popen([sys.executable, "-m", "nats_llm_studio_tpu_torch", "serve",
                               "--device", device], cwd=ROOT, env=env_b, stdout=log_b,
                              stderr=subprocess.STDOUT)
    nc = router = agg = gw = None
    try:
        base = allocated(torch)
        await wa.start()
        nc = await connect(broker.url)
        router = RouterProcess(nc, retry=RetryPolicy(max_attempts=3, backoff_s=0.05))
        agg = Aggregator(nc, scrape_interval_s=0.5)
        gw = Gateway(nc, port=0)
        for x in (router, agg, gw):
            await x.start()

        async def req(subject, body, headers=None, timeout=300.0, retry=None):
            msg = await nc.request(subject, json.dumps(body).encode(), timeout=timeout,
                                   headers=headers, retry=retry)
            return json.loads(msg.payload), msg

        client = types.SimpleNamespace(nc=nc)  # what stream_env reads

        # B comes up: its health answers once its connection is made
        t_end = time.monotonic() + 180.0
        while True:
            gate(proc_b.poll() is None, f"worker B exited ({proc_b.returncode}); "
                 f"see {work / 'worker-b.log'}")
            try:
                await req("lmstudio.worker.w-b.health", {}, timeout=1.0)
                break
            except asyncio.TimeoutError:
                gate(time.monotonic() < t_end, "worker B did not come up")
        out["b_up_s"] = time.perf_counter() - t_phase

        # the same greedy text from each worker (each loads on this chat)
        chat = chat_body("Tell me about the harbour and its ships.", 32)
        for f in counters:
            f.launches = 0
        t_a = text_of((await req(on_a, chat))[0])
        loaded = allocated(torch)
        t0 = time.perf_counter()
        t_b = text_of((await req("lmstudio.worker.w-b.chat_model", chat))[0])
        out["b_load_and_chat_s"] = time.perf_counter() - t0
        gate(t_a == t_b, f"A and B give different greedy texts: {t_a!r} vs {t_b!r}")
        log(f"cluster: A and B loaded ({(loaded - base) / 1e9:.2f} GB in A), the same "
            f"greedy text; B up in {out['b_up_s']:.1f} s, its load and chat "
            f"{out['b_load_and_chat_s']:.1f} s")

        # adverts: both within two intervals, then their spacing
        arrivals: dict[str, list] = {"w-a": [], "w-b": []}
        adverts: dict[str, dict] = {}

        async def on_advert(msg):
            d = json.loads(msg.payload)
            if d.get("worker_id") in arrivals:
                arrivals[d["worker_id"]].append(time.monotonic())
                adverts[d["worker_id"]] = d

        sub = await nc.subscribe("lmstudio.cluster.adverts", cb=on_advert)
        t_sub = time.monotonic()
        await asyncio.sleep(6 * ADVERT_S)
        await sub.unsubscribe()
        for wid, ts in arrivals.items():
            gate(bool(ts) and ts[0] - t_sub <= 2 * ADVERT_S, f"{wid}: no advert within "
                 f"two intervals ({[round(t - t_sub, 3) for t in ts]})")
            ad = adverts[wid]
            gate(ad["slots"] == 8 and ad["models"] == [MID] and ad["draining"] is False
                 and 0.0 < ad["hbm_headroom"] <= 1.0, f"{wid} advert: {ad}")
        gaps = [b - a for ts in arrivals.values() for a, b in zip(ts, ts[1:])]
        out["advert"] = {"interval_s": ADVERT_S, "headroom": {w: a["hbm_headroom"]
                                                              for w, a in adverts.items()},
                         "jitter_max_s": max(abs(g - ADVERT_S) for g in gaps),
                         "gap_min_s": min(gaps), "gap_max_s": max(gaps)}
        log(f"cluster: adverts {json.dumps(out['advert'])}")

        # routing: gateway (unary, SSE), route.chat_model, TTFT against direct
        status, body, _ = await http_chat(gw.port, chat)
        gate(status == 200, f"gateway unary: {status} {body[:300]!r}")
        gate(json.loads(body)["choices"][0]["message"]["content"] == t_a,
             "the gateway's unary text differs")
        status, body, ttft_gw = await http_chat(gw.port, {**chat, "stream": True})
        gate(status == 200 and sse_text(body) == t_a, "the gateway's SSE text differs")
        t0 = time.perf_counter()
        ttft_direct = None
        async for _ in nc.request_stream("lmstudio.chat_model",
                                         json.dumps({**chat, "stream": True}).encode(),
                                         timeout=300.0):
            if ttft_direct is None:
                ttft_direct = time.perf_counter() - t0
        gate(text_of((await req("lmstudio.route.chat_model", chat))[0]) == t_a,
             "route.chat_model's text differs")
        out["ttft_s"] = {"gateway_sse": ttft_gw, "direct_stream": ttft_direct}
        log(f"cluster: gateway unary and SSE and route.chat_model give the direct text; "
            f"TTFT through the gateway {ttft_gw * 1e3:.1f} ms, direct "
            f"{ttft_direct * 1e3:.1f} ms")

        # locality: a prompt B served is steered back to B
        local = chat_body("Only the second worker has heard this question about tides.", 8)
        await req("lmstudio.worker.w-b.chat_model", local)
        head = prompt_head_hash(MID, local["messages"])
        await wait_for(lambda: head in router.router._members["w-b"].heads, "B's heads")
        msg = await router.router.request_chat(local, timeout=300.0)
        gate((msg.headers or {}).get(p.WORKER_HEADER) == "w-b"
             and router.router.stats.locality_total >= 1, "the repeat was not steered to B")

        # the excluded-workers bounce, then the router's retry on B
        env, msg = await req(on_a, chat,
                             {p.EXCLUDED_WORKERS_HEADER: "w-a"})
        gate(not env["ok"] and env.get("retryable") and env["data"].get("excluded_bounce"),
             f"bounce: {env}")
        msg = await router.router.request_chat(
            chat, headers={p.EXCLUDED_WORKERS_HEADER: "w-a"}, timeout=300.0,
            retry=RetryPolicy(max_attempts=3, backoff_s=0.05))
        gate((msg.headers or {}).get(p.WORKER_HEADER) == "w-b"
             and text_of(json.loads(msg.payload)) == t_a, "the bounced chat's retry")
        log("cluster: a repeat steered to the worker whose heads hold it; A bounced a chat "
            "excluding it and the router's retry was served by B with the same text")

        # efficiency on A: a chunked prefill beside a stream, then 8 streams
        b = registry.loaded_engines()[MID].batcher
        pf, pb = chip_peaks(b.device)
        first = asyncio.Event()
        live = asyncio.ensure_future(stream_env(client, chat_body("Count slowly to ninety.", 96),
                                                first=first, subject=on_a))
        await asyncio.wait_for(first.wait(), 300.0)  # chunked beside it: K3
        long_text = ("The harbour log lists every ship, its cargo and the tide. " * 70)[:3500]
        await req(on_a, chat_body(long_text, 4))
        fl, by = b.stats.util_prefill.rates()
        await live
        await asyncio.gather(*[stream_env(client, chat_body(f"Story {i} of the sea.", 128),
                                          subject=on_a) for i in range(8)])
        dfl, dby = b.stats.util_decode.rates()
        out["efficiency"] = {"prefill_mfu_raw": fl / pf, "prefill_mbu_raw": by / pb,
                             "decode_mfu_raw": dfl / pf, "decode_mbu_raw": dby / pb,
                             "utilization": b.stats.utilization(), "peaks": [pf, pb]}
        if prof and prof.get("device_ms_per_step"):
            step_bytes = ForwardCost(b.cfg)(8, 1, [prof["ctx"]] * 8, 8)[1]
            out["efficiency"]["decode_step_bytes"] = step_bytes
            out["efficiency"]["decode_step_hbm_share_by_device_time"] = (
                step_bytes / (prof["device_ms_per_step"] / 1e3) / pb)
        log(f"cluster: efficiency on A {json.dumps(out['efficiency'])}")
        if device == "cuda":
            for k in ("prefill_mfu_raw", "decode_mbu_raw"):
                v = out["efficiency"][k]
                gate(0.0 < v <= 1.05, f"{k} {v} outside (0, 1.05]")

        # the aggregator: both workers scraped, their roofline gauges merged
        t_end = time.monotonic() + 60.0
        while True:
            texts = dict(agg._last_texts)
            if all(w in texts and "lmstudio_mfu{" in texts[w] and "lmstudio_mbu{" in texts[w]
                   for w in ("w-a", "w-b")):
                break
            gate(time.monotonic() < t_end, f"the aggregator scraped {sorted(texts)}")
            await asyncio.sleep(0.2)
        merged = (await nc.request("lmstudio.cluster.metrics.prom", b"", timeout=30)
                  ).payload.decode()
        gate(re.search(r"^lmstudio_cluster_workers 2$", merged, re.M) is not None
             and "lmstudio_mfu{" in merged and "lmstudio_mbu{" in merged,
             "the merged exposition lacks the cluster's roofline gauges")
        drift_b = re.search(r"^lmstudio_hbm_drift_events_total\{[^}]*\} (\S+)$",
                            texts["w-b"], re.M)
        gate(drift_b is not None and float(drift_b.group(1)) == 0.0,
             f"worker B's hbm_drift events: {drift_b and drift_b.group(0)}")
        log("cluster: the aggregator scraped both workers; the merged exposition carries "
            "lmstudio_mfu and lmstudio_mbu; worker B fired no hbm_drift")

        # the drain: texts B gives undrained, then streams cut on A
        bodies = [chat_body(f"Drain story {i}: the night the harbour lights failed.",
                            DRAIN_TOKENS) for i in range(DRAIN_STREAMS)]
        want = [text_of((await req("lmstudio.worker.w-b.chat_model", bd))[0]) for bd in bodies]
        firsts = [asyncio.Event() for _ in bodies]
        cut = [asyncio.ensure_future(stream_env(client, bd, first=f, subject=on_a))
               for bd, f in zip(bodies, firsts)]
        await asyncio.wait_for(asyncio.gather(*(f.wait() for f in firsts)), 300.0)
        t0 = time.perf_counter()
        env, _ = await req("lmstudio.admin.drain", {"worker_id": "w-a", "deadline_s": 1})
        drain_s = time.perf_counter() - t0
        gate(env["ok"] and env["data"]["stopped_engines"] == [MID], f"drain: {env}")
        ends = await asyncio.gather(*cut)
        got = []
        for bd, e in zip(bodies, ends):
            if e["ok"]:  # done before the deadline: not cut
                got.append(e["text"])
                continue
            gate(e.get("retryable") and "worker draining" in (e["error"] or ""),
                 f"a cut stream ended with {e}")
            renv, msg = await req("lmstudio.chat_model", bd,
                                  retry=RetryPolicy(max_attempts=4, backoff_s=0.05))
            gate((msg.headers or {}).get(p.WORKER_HEADER) == "w-b", "a retry missed B")
            got.append(text_of(renv))
        n_cut = sum(not e["ok"] for e in ends)
        gate(n_cut >= 1, "the drain cut no stream")
        gate(got == want, "a stream's text (retried on B if cut) differs from B's undrained "
             "text")
        await wait_for(lambda: router.router._members["w-a"].draining, "A's draining advert")
        gc.collect()
        drained = allocated(torch)
        out["drain"] = {"seconds": drain_s, "streams": len(ends), "cut_streams": n_cut,
                        "finished_in_time": env["data"]["finished_in_time"],
                        "chunks_before_cut": [e["chunks"] for e in ends],
                        "allocated_before_load": base, "allocated_loaded": loaded,
                        "allocated_after_drain": drained}
        log(f"cluster: drain {json.dumps(out['drain'])}")
        if device == "cuda":
            gate(abs(drained - base) <= 0.01 * (loaded - base),
                 f"A's memory after the drain {drained} vs {base} before the load")

        # the device-time ledger on A
        dt = b.stats.device_time_snapshot()
        total = b.stats.dispatch_ms_total
        out["ledger"] = {"device_ms": dt["ms"], "device_tokens": dt["tokens"],
                         "dispatch_ms_total": total, "tokens_delivered": b.stats.tokens,
                         "goodput_tokens_per_device_s": b.stats.goodput_tokens_per_device_s()}
        log(f"cluster: device-time ledger on A {json.dumps(out['ledger'])}")
        gate(abs(sum(dt["ms"].values()) - total) <= 0.10 * total,
             "the ledger's categories do not sum to dispatch_ms_total within 10%")
        gate(dt["tokens"]["served"] == b.stats.tokens,
             "the ledger's served tokens differ from the tokens delivered")
        out["launches"] = {f.__name__: f.launches for f in counters}
        log(f"cluster (kv none): kernel launches {out['launches']}")
        if device == "cuda":
            for name in EXPECTED["none"][0]:
                gate(out["launches"][name] > 0, f"{name} was not launched")
            for name in EXPECTED["none"][1]:
                gate(out["launches"][name] == 0, f"{name} was launched under bf16 KV")
        out["seconds"] = time.perf_counter() - t_phase
    finally:
        for x in (gw, agg, router):
            if x is not None:
                await x.stop()
        if nc is not None:
            await nc.close()
        await wa.drain()
        await registry.close()
        proc_b.send_signal(signal.SIGTERM)
        try:
            proc_b.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc_b.kill()
            proc_b.wait()
        log_b.close()
        await broker.stop()
        if saved is None:
            os.environ.pop("TPU_HBM_BUDGET_BYTES", None)
        else:
            os.environ["TPU_HBM_BUDGET_BYTES"] = saved
    del registry, b
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"cluster: phase ok in {out['seconds']:.1f} s")
    return out


# -- phases 3 and 7: the model lifecycle ---------------------------------------


class Lifecycle:
    """An embedded broker with the object-store module, a Worker whose
    TorchRegistry keeps ``model_root`` through the serving ModelStore
    (``__main__.make_store``: the bucket, URL_PULL_SCHEMES), and a client."""

    def __init__(self, model_root: Path, device: str = "cuda", store_dir: Path | None = None):
        self.model_root, self.device, self.store_dir = model_root, device, store_dir

    async def __aenter__(self):
        from nats_llm_studio_tpu_torch.__main__ import make_store
        from nats_llm_studio_tpu_torch.config import WorkerConfig
        from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
        from nats_llm_studio_tpu_torch.serve.worker import Worker
        from nats_llm_studio_tpu_torch.store import JetStreamStoreModule
        from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, connect

        self.broker = await EmbeddedBroker().start()
        JetStreamStoreModule(self.broker, store_dir=self.store_dir).install()
        self.cfg = WorkerConfig(nats_url=self.broker.url, models_dir=self.model_root)
        self.store_nc = await connect(self.broker.url)
        # brownout off: the admission gates below hold the budget at the
        # estimate on purpose, where the headroom signal would shed chats
        self.registry = TorchRegistry(make_store(self.cfg, self.store_nc), device=self.device,
                                      max_seq_len=4096, max_batch_slots=8, brownout=False)
        self.worker = Worker(self.cfg, self.registry)
        await self.worker.start()
        self.nc = await connect(self.broker.url)
        return self

    async def __aexit__(self, *exc):
        await self.nc.close()
        await self.worker.drain()
        await self.registry.close()
        await self.store_nc.close()
        await self.broker.stop()

    async def req(self, op: str, body: dict, timeout: float = 600.0) -> dict:
        msg = await self.nc.request(f"lmstudio.{op}", json.dumps(body).encode(),
                                    timeout=timeout)
        return json.loads(msg.payload)

    async def chat(self, model: str, content: str, max_tokens: int) -> dict:
        return await self.req("chat_model", {
            "model": model, "messages": [{"role": "user", "content": content}],
            "temperature": 0, "max_tokens": max_tokens})

    async def stream(self, model: str, content: str, max_tokens: int, first: asyncio.Event):
        """A streamed greedy chat: (ok, chunks add up to the final text,
        tokens)."""
        body = {"model": model, "messages": [{"role": "user", "content": content}],
                "temperature": 0, "max_tokens": max_tokens, "stream": True}
        parts, final = [], None
        async for msg in self.nc.request_stream("lmstudio.chat_model",
                                                json.dumps(body).encode(), timeout=300.0):
            env = json.loads(msg.payload)
            if not env.get("ok"):
                raise AssertionError(f"stream failed: {env}")
            if msg.headers and "Nats-Stream-Done" in msg.headers:
                final = env["data"]["response"]
            else:
                first.set()
                parts.append(env["data"]["chunk"]["choices"][0]["delta"]["content"])
        intact = final is not None and final["choices"][0]["message"]["content"] == "".join(parts)
        return intact, final["usage"]["completion_tokens"] if final else 0


def ok(env: dict, what: str) -> dict:
    if not env.get("ok"):
        raise AssertionError(f"{what}: {env}")
    return env["data"]


async def pull_phase(staged: Path, model_root: Path, device: str = "cuda") -> dict:
    """Bring the staged GGUF into the models dir the way a client would:
    pull_model over NATS with its file:// URL."""
    os.environ["URL_PULL_SCHEMES"] = "file"
    size = staged.stat().st_size
    async with Lifecycle(model_root, device) as h:
        t0 = time.perf_counter()
        data = ok(await h.req("pull_model", {"identifier": staged.as_uri()}), "pull_model")
        dt = time.perf_counter() - t0
        if [m["id"] for m in ok(await h.req("list_models", {}), "list")["models"]["data"]] \
                != [MID]:
            raise AssertionError(f"after the pull the cache does not list {MID} alone")
    log(f"lifecycle: pull_model {staged.as_uri()} -> {MID}: {size} bytes in {dt:.2f} s "
        f"({size / dt / 1e6:.1f} MB/s); {data['output'].splitlines()[-1]}")
    return {"pull_bytes": size, "pull_s": dt, "pull_MBps": size / dt / 1e6}


def sha256_b64(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return "SHA-256=" + base64.urlsafe_b64encode(h.digest()).decode()


async def lifecycle_phase(torch, model_root: Path, work: Path, seed: int,
                          device: str = "cuda", widths: dict = LLAMA3_8B) -> dict:
    """(a) bucket publish and sync, (b) the card's budget, load and peak
    against the estimate over a long prefill and a 4-wide group-chunked
    admit, (c) refusal while busy (after the shrink tier dropped the busy
    engine's prefix cache) and eviction when idle under a budget override
    derived from the two models' estimates (the larger one and half the
    smaller), (d) delete of a loaded model; the 32-layer model leaves by
    delete_model. The memory gates need the card: on the CPU (a rehearsal
    at tiny widths) they are skipped."""
    from nats_llm_studio_tpu_torch.models.config import ModelConfig
    from nats_llm_studio_tpu_torch.parallel.memory import estimate_load_bytes
    from nats_llm_studio_tpu_torch.serve.registry import _prefix_cache_blocks_env
    from nats_llm_studio_tpu_torch.store import ModelStore
    from nats_llm_studio_tpu_torch.transport.jetstream import ObjectStore

    cuda = device == "cuda"

    def estimate(n_layers: int) -> dict:
        c = widths
        cfg = ModelConfig(vocab_size=c["vocab"], d_model=c["d_model"], n_layers=n_layers,
                          n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
                          head_dim=c["head_dim"], d_ff=c["d_ff"], max_seq_len=c["context"],
                          dtype="bfloat16" if cuda else "float32")
        return estimate_load_bytes(cfg, 8, 4096, prefix_cache_blocks=_prefix_cache_blocks_env())

    def gate(cond: bool, msg: str) -> None:
        if cuda and not cond:
            raise AssertionError(msg)

    out: dict = {}
    os.environ.pop("TPU_HBM_BUDGET_BYTES", None)
    big, small = estimate(widths["n_layers"]), estimate(2)
    budget_override = big["total"] + small["total"] // 2  # fits either model, not both
    async with Lifecycle(model_root, device, store_dir=work / "store") as h:
        # (a) publish a 2-layer model to the bucket, sync it into the cache
        pub_dir = work / "publisher"
        src = pub_dir / MID2 / "model.gguf"
        src.parent.mkdir(parents=True)
        write_gguf(torch, src, 2, seed + 1, widths=widths, device=device)
        size = src.stat().st_size
        publisher = ModelStore(pub_dir, objstore=ObjectStore(h.nc), bucket=h.cfg.bucket)
        t0 = time.perf_counter()
        obj = await publisher.publish_model(MID2)
        out["publish_MBps"] = size / (time.perf_counter() - t0) / 1e6
        t0 = time.perf_counter()
        data = ok(await h.req("sync_model_from_bucket", {"object_name": obj}), "sync")
        out["sync_MBps"] = size / (time.perf_counter() - t0) / 1e6
        digest = (await ObjectStore(h.nc).info(h.cfg.bucket, obj)).digest
        local = Path(data["local_path"])
        if not sha256_b64(src) == digest == sha256_b64(local):
            raise AssertionError(f"sync: {local} does not hold the published bytes")
        shutil.rmtree(pub_dir)
        log(f"lifecycle: published {obj} ({size} bytes) at {out['publish_MBps']:.1f} MB/s, "
            f"sync_model_from_bucket -> {local} at {out['sync_MBps']:.1f} MB/s, sha256 "
            f"matches the published digest")

        # (b) the card's budget; load, then the worst prefill, against the estimate
        out["budget_bytes"] = h.registry.budget_bytes()
        log(f"lifecycle: admission budget read from the card: {out['budget_bytes']} bytes; "
            f"estimate for {MID}: {big}")
        base = allocated(torch)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        await h.registry.get_engine(MID)
        out["load_s"] = time.perf_counter() - t0
        resident = allocated(torch) - base
        out.update(estimate=big, resident_bytes=resident)
        gate(abs(resident - big["params"] - big["kv_pool"]) <= 0.01 * (big["params"]
                                                                       + big["kv_pool"]),
             f"load: memory_allocated rose {resident}, estimate's params + pool "
             f"{big['params'] + big['kv_pool']}")
        ok(await h.chat(MID, "hello", 4), "short chat")
        long_text = ("The harbour town kept its records in a long ledger. " * 80)[:3980]
        data = ok(await h.chat(MID, long_text, 4), "long chat")
        out["long_prompt_tokens"] = data["response"]["usage"]["prompt_tokens"]
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(torch) - base) if cuda else 0
        log(f"lifecycle: {MID} loaded in {out['load_s']:.2f} s; resident {resident} bytes "
            f"(estimate params + pool {big['params'] + big['kv_pool']}); peak over the load "
            f"and a {out['long_prompt_tokens']}-token chat {out['peak_bytes']} bytes (estimate "
            f"total {big['total']}, workspace term {big['workspace']})")
        gate(out["peak_bytes"] <= big["total"],
             f"peak {out['peak_bytes']} above the estimate {big['total']}")
        # a 4-wide group-chunked admit of ~4000-token prompts: the [4, L,
        # Hkv, max_seq, D] transient pair, [4, C] chunks, the kept logits
        batcher = h.registry.loaded_engines()[MID].batcher
        g0 = batcher.stats.chunked_group_admits
        wave = [f"Ledger {i}: " + long_text[:3960] for i in range(4)]
        # when each chat reaches the batcher: a group forms from arrivals
        # within the admit top-up window (50 ms) of the first
        enq, enqueue = [], batcher._enqueue

        def timed_enqueue(*a, **kw):
            enq.append(time.monotonic())
            return enqueue(*a, **kw)

        batcher._enqueue = timed_enqueue
        # the earlier long chat's chunks may still be spilling to the
        # object store over the worker's event loop, beside these arrivals
        tiers = batcher.kv_tiers
        spill0 = tiers.stats() if tiers is not None else {}
        rs = await asyncio.gather(*[h.chat(MID, t, 4) for t in wave])
        batcher._enqueue = enqueue
        out["group_spill_pending"] = spill0.get("spill_pending")
        out["group_spilled_blobs"] = ((tiers.stats()["spilled_blobs"] - spill0["spilled_blobs"])
                                      if tiers is not None else None)
        for r in rs:
            ok(r, "group chat")
        out["group_arrivals_ms"] = [round((t - enq[0]) * 1e3, 2) for t in enq]
        out["group_admits"] = batcher.stats.chunked_group_admits - g0
        out["group_prompt_tokens"] = [r["data"]["response"]["usage"]["prompt_tokens"] for r in rs]
        out["group_peak_bytes"] = (torch.cuda.max_memory_allocated(torch) - base) if cuda else 0
        log(f"lifecycle: four concurrent chats of {out['group_prompt_tokens']} tokens, "
            f"arriving at the batcher at {out['group_arrivals_ms']} ms, "
            f"{out['group_admits']} admitted by one chunked group (KV tier: "
            f"{out['group_spill_pending']} spills pending as the wave was sent, "
            f"{out['group_spilled_blobs']} blobs spilled during it); peak over the load and "
            f"every chat {out['group_peak_bytes']} bytes (estimate total {big['total']})")
        if out["group_admits"] < 4:
            raise AssertionError(f"the four long chats were not admitted as one group: "
                                 f"{out['group_admits']}")
        gate(out["group_peak_bytes"] <= big["total"],
             f"group peak {out['group_peak_bytes']} above the estimate {big['total']}")

        # (c) refused while busy, evicted when idle, under a budget override
        os.environ["TPU_HBM_BUDGET_BYTES"] = str(budget_override)
        first = asyncio.Event()
        live = asyncio.ensure_future(h.stream(MID, "Count slowly from one to fifty.", 96,
                                              first))
        await asyncio.wait_for(first.wait(), 300)
        env = await h.chat(MID2, "hello", 4)
        if env.get("ok") or "insufficient device memory" not in env.get("error", ""):
            raise AssertionError(f"a chat to {MID2} beside a live {MID} stream: {env}")
        intact, n_live = await live
        if not intact:
            raise AssertionError("the live stream did not finish intact")
        log(f"lifecycle: under TPU_HBM_BUDGET_BYTES={budget_override}, a chat to {MID2} "
            f"beside a live stream was refused: {env['error']!r}; the stream finished "
            f"intact ({n_live} tokens)")
        eng = h.registry.loaded_engines()[MID]
        unload, freed = eng.unload, {}

        async def measured_unload():
            # the refused load's shrink tier dropped this engine's prefix
            # cache before any eviction: its blocks are back in the pool
            freed["pool"] = eng.batcher.pool_stats()
            freed["prefix_blocks"] = eng.batcher.prefix_cache.blocks
            before = allocated(torch)
            await unload()
            freed["evict"] = before - allocated(torch)

        eng.unload = measured_unload
        ok(await h.chat(MID2, "hello", 4), f"chat to {MID2} once {MID} idles")
        del eng
        if set(h.registry.loaded_engines()) != {MID2}:
            raise AssertionError(f"after the eviction: {set(h.registry.loaded_engines())}")
        pool = freed["pool"]
        out["evicted_pool"] = pool
        log(f"lifecycle: at its eviction {MID}'s prefix cache held {freed['prefix_blocks']} "
            f"blocks and its pool {pool['blocks_free']} of {pool['blocks_total']} free")
        if freed["prefix_blocks"] or pool["blocks_free"] != pool["blocks_total"]:
            raise AssertionError("the shrink tier did not return the prefix blocks before "
                                 "the eviction")
        out["evict_freed_bytes"] = freed.get("evict", 0)
        log(f"lifecycle: the same chat evicted idle {MID} and was served; freed "
            f"{out['evict_freed_bytes']} bytes of params + pool "
            f"{big['params'] + big['kv_pool']}")
        gate(out["evict_freed_bytes"] >= FREED_SHARE * (big["params"] + big["kv_pool"]),
             "eviction returned too few bytes")

        # (d) delete_model of the loaded model frees it; the model is gone
        before = allocated(torch)
        ok(await h.req("delete_model", {"model_id": MID2}), "delete_model")
        out["delete_freed_bytes"] = before - allocated(torch)
        env = await h.chat(MID2, "hello", 4)
        if env.get("ok") or "model not found" not in env.get("error", ""):
            raise AssertionError(f"a chat after delete_model: {env}")
        listed = [m["id"] for m in ok(await h.req("list_models", {}), "list")["models"]["data"]]
        if MID2 in listed:
            raise AssertionError(f"list_models still lists {MID2}: {listed}")
        log(f"lifecycle: delete_model {MID2} freed {out['delete_freed_bytes']} bytes of "
            f"params + pool {small['params'] + small['kv_pool']}; a chat to it: "
            f"{env['error']!r}; list_models: {listed}")
        gate(out["delete_freed_bytes"] >= FREED_SHARE * (small["params"] + small["kv_pool"]),
             "delete_model returned too few bytes")
        data = ok(await h.req("delete_model", {"model_id": MID}), "delete_model")
        if ok(await h.req("list_models", {}), "list")["models"]["data"]:
            raise AssertionError("the cache is not empty after both deletes")
        log(f"lifecycle: delete_model {MID} removed {data['deleted_dir']}")
    os.environ.pop("TPU_HBM_BUDGET_BYTES", None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights and inputs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from nats_llm_studio_tpu_torch.ops import _build
        from nats_llm_studio_tpu_torch.ops import flash_attention as fa
        from nats_llm_studio_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    global PEAKS
    from nats_llm_studio_tpu_torch.obs import events
    from nats_llm_studio_tpu_torch.obs.roofline import _CPU_PEAKS, resolve_chip_peaks

    name = torch.cuda.get_device_name(0)
    PEAKS = resolve_chip_peaks(name)
    if PEAKS == _CPU_PEAKS or ("H100 80GB HBM3" in name and PEAKS != (989e12, 3.35e12)):
        raise AssertionError(f"peaks of {name!r}: {PEAKS}")
    log(f"peaks: {name} -> {PEAKS[0]:.4g} FLOP/s bf16, {PEAKS[1]:.4g} B/s (obs/roofline.py)")
    # every hbm_drift the HBM ledgers of this process fire, by phase
    drifts: list = []
    emit = events.EVENTS.emit

    def counting_emit(kind, **fields):
        if kind == "hbm_drift":
            drifts.append(fields)
        return emit(kind, **fields)

    events.EVENTS.emit = counting_emit

    t0 = time.perf_counter()
    rep = _build.build_all(verbose=True)
    log_path = _build.BUILD_DIR / "build.log"
    log_path.write_text("\n".join(f"== {n}\n{r['log']}" for n, r in rep.items()))
    log(f"build: {', '.join(rep)} in {time.perf_counter() - t0:.1f} s (nvcc log: {log_path})")

    kernels = kernel_phase(torch, args.seed)
    torch.cuda.empty_cache()

    work = ROOT / "build" / "smoke"
    model_root = work / "models"
    shutil.rmtree(work, ignore_errors=True)
    staged = work / "staging" / STAGED
    staged.parent.mkdir(parents=True)
    t0 = time.perf_counter()
    write_gguf(torch, staged, LLAMA3_8B["n_layers"], args.seed)
    log(f"model: bf16 GGUF {staged.stat().st_size / 2**30:.2f} GiB written in "
        f"{time.perf_counter() - t0:.1f} s; disk: {shutil.disk_usage(work)}")
    lifecycle = asyncio.run(pull_phase(staged, model_root))
    staged.unlink()
    # the pulled copy is the served model from here on; the staging dir
    # stays for the overload phase's 2-layer model

    counters = (pa.paged_decode_attention, pa.paged_decode_attention_kvq, fa.flash_attention,
                fa.flash_attention_chunk, fa.flash_attention_chunk_kvq)
    # the flash wrappers' launches by body over every phase from here on
    # (the main path: serve, tier, overload, cluster, lifecycle)
    flash = (fa.flash_attention, fa.flash_attention_chunk, fa.flash_attention_chunk_kvq)
    body0 = {f.__name__: dict(f.body_launches) for f in flash}
    # and the paged wrappers' bf16 launches by body
    paged = (pa.paged_decode_attention, pa.paged_decode_attention_kvq)
    paged0 = {f.__name__: dict(f.bf16_body_launches) for f in paged}
    paths = {kv: serve_path(torch, model_root, kv, args.seed, counters)
             for kv in ("none", "int8")}
    tier = {kv: tier_phase(torch, model_root, kv, counters) for kv in ("none", "int8")}
    for f in counters:
        f.launches = 0
    overload = asyncio.run(overload_phase(torch, model_root, staged.parent, args.seed))
    overload["launches"] = {f.__name__: f.launches for f in counters}
    log(f"overload (kv none): kernel launches {overload['launches']}")
    for name in EXPECTED["none"][0]:
        if overload["launches"][name] <= 0:
            raise AssertionError(f"overload: {name} was not launched")
    for name in EXPECTED["none"][1]:
        if overload["launches"][name] != 0:
            raise AssertionError(f"overload: {name} was launched under the bf16 KV cache")
    cluster = asyncio.run(cluster_phase(torch, model_root, work, counters,
                                        paths["none"]["prof"]))
    if drifts:
        raise AssertionError(f"hbm_drift fired in the serve, tier, overload or cluster "
                             f"phases: {drifts}")
    log("hbm ledger: no hbm_drift in the serve, spec, prefix, tier, overload and cluster "
        "phases")
    for f in counters:
        f.launches = 0
    lifecycle.update(asyncio.run(lifecycle_phase(torch, model_root, work, args.seed)))
    launches = {f.__name__: f.launches for f in counters}
    log(f"lifecycle (kv none): kernel launches {launches}")
    for name in ("paged_decode_attention", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"lifecycle: {name} was not launched")
    for name in EXPECTED["none"][1]:
        if launches[name] != 0:
            raise AssertionError(f"lifecycle: {name} was launched under the bf16 KV cache")
    lifecycle["launches"] = launches
    bodies = {f.__name__: {k: n - body0[f.__name__][k] for k, n in f.body_launches.items()}
              for f in flash}
    log(f"flash launches by body over the main path (serve, tier, overload, cluster, "
        f"lifecycle): {bodies}")
    for name, by in bodies.items():
        # Llama-3-8B at head_dim 128: every bf16 launch takes the Hopper body
        # (the FMA body's launches are the float32 logits gates')
        if by["wgmma"] <= 0 or by["mma"]:
            raise AssertionError(f"{name}: the main path's bf16 launches ran bodies {by}, "
                                 f"not only wgmma")
    paged_bodies = {f.__name__: {k: n - paged0[f.__name__][k]
                                 for k, n in f.bf16_body_launches.items()} for f in paged}
    log(f"paged bf16 launches by body over the main path (serve, tier, overload, cluster, "
        f"lifecycle): {paged_bodies}")
    for name, by in paged_bodies.items():
        # head_dim 128: every bf16 K1 and K1q launch takes the tensor-core
        # body
        if by["mma"] <= 0 or by["fma"]:
            raise AssertionError(f"{name}: the main path's bf16 launches ran bodies {by}, "
                                 f"not only mma")
    shutil.rmtree(work, ignore_errors=True)
    for name in ("prefill", "decode"):
        a, b = paths["int8"]["gate"][name], paths["none"]["gate"][name]
        log(f"model: {name} logits with the int8 KV cache vs the bf16 one (kernel paths, "
            f"information only): relative L2 {float((a - b).norm() / b.norm()):.3e}")
    pb, pq = paths["none"]["pool"], paths["int8"]["pool"]
    if pb["blocks_total"] != pq["blocks_total"]:
        raise AssertionError("the two pools hold different block counts")
    log(f"pool: {pb['blocks_total']} blocks: bf16 {pb['bytes']} bytes, int8 {pq['bytes']} "
        f"bytes ({pq['bytes'] / pb['bytes']:.4f} x)")

    # per wrapper: its source and the TPU kernel it replaces; per row the
    # body that ran (wgmma: the Hopper body; mma: mma.sync tensor-core tiles)
    src = {
        "paged_decode_attention": ("nats_llm_studio_tpu_torch/csrc/paged_attention.cu",
                                   "nats_llm_studio_tpu/ops/paged_attention.py:205"),
        "paged_decode_attention_kvq": ("nats_llm_studio_tpu_torch/csrc/paged_attention.cu",
                                       "nats_llm_studio_tpu/ops/paged_attention.py:205"),
        "flash_attention": ("nats_llm_studio_tpu_torch/csrc/flash_attention.cu",
                            "nats_llm_studio_tpu/ops/flash_attention.py:143"),
        "flash_attention_chunk": ("nats_llm_studio_tpu_torch/csrc/flash_attention.cu",
                                  "nats_llm_studio_tpu/ops/flash_attention.py:288"),
        "flash_attention_chunk_kvq": ("nats_llm_studio_tpu_torch/csrc/flash_attention.cu",
                                      "nats_llm_studio_tpu/ops/flash_attention.py:438"),
    }
    rows = []
    for name, r in kernels.items():
        wrapper = r["kern"].__name__
        rows.append({
            "name": name, "route": "cuda", "source": src[wrapper][0],
            "replaces": src[wrapper][1], "design": r["body"], "shape": r["shape"],
            # the wrapper's launches over both serve and tier phases, the
            # overload, the cluster and the lifecycle phases (K2 serves both
            # KV modes), at whatever shapes they ran: a second row of one
            # wrapper (@T4096, @KW4096, @W7, ...) reports the same counter,
            # named by launches_of
            "launches": sum(p["launches"][wrapper] for p in paths.values())
            + sum(t["launches"][wrapper] for t in tier.values())
            + overload["launches"][wrapper] + cluster["launches"][wrapper]
            + lifecycle["launches"][wrapper],
            "launches_of": wrapper,
            "launches_by_body": bodies.get(wrapper) or paged_bodies.get(wrapper),
            "max_abs_err": r["max_abs_err"], "max_row_rel_err": r["max_row_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    summary = {}
    for kv, p in paths.items():
        short = p["served"]["short"]["stats"]
        summary[kv] = {
            "serve": {"ttft_s_short": short["time_to_first_token"],
                      "decode_tok_s_short": short["tokens_per_second"],
                      "stream": p["served"]["stream"]},
            "pool_bytes": p["pool"]["bytes"],
            "decode_profile": {k: v for k, v in p["prof"].items() if k != "top"},
            "prefix": p["served"]["prefix"],
            "group_gate": p["gate"]["group"],
            "verify_gate": p["gate"]["verify"],
            "spec": p["spec"],
            "ext": p["ext"],
        }
    summary["tier"] = tier
    summary["overload"] = overload
    summary["cluster"] = cluster
    summary["lifecycle"] = lifecycle
    summary["hbm_drift_events"] = {"before_lifecycle": 0, "lifecycle": len(drifts)}
    log(json.dumps(summary))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any phase failing fails the run
        traceback.print_exc()
        sys.exit(1)
