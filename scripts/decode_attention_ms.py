#!/usr/bin/env python3
"""Time one checkout's paged decode attention (K1 and K1q) on one GPU:
the kernels, their split merge, their wrappers' host cost, and the model's
decode step and verify.

    python3 scripts/decode_attention_ms.py [--root DIR] [--ab DIR] [--breakdown N [N ...]]
                                           [--no-model]

* rows: K1 (``paged_decode_attention``, bf16 pool) and K1q
  (``paged_decode_attention_kvq``, the same draws quantized to an int8
  pool) at ``chip_smoke.py``'s kernel-phase shapes (8 slots at positions
  4095 .. 5, 16-token blocks, a 256-entry table, Llama-3-8B's 32 / 8 heads
  at head_dim 128), W = 1 and W = 7, on the inputs it draws from seed 0;
  each by ``chip_smoke.cuda_ms`` (CUDA events around calls queued behind a
  device-side sleep: kernels back to back, gaps included).
* kernels: the same calls under ``torch.profiler``: the device time a
  call of each kernel the wrapper launched (the decode kernel and the
  split merge, named ``*combine*``), so the merge's share and the gaps
  between launches (``cuda_ms`` less the kernels' sum) show apart.
* host: the host microseconds a wrapper call takes at each row: 200 calls
  queued behind a device-side sleep, so none waits on the card, timed on
  the host clock, the garbage collector off; the median and the least of
  20 runs. With ``--ab DIR`` the wrappers of the checkout DIR are imported
  beside this one's (as the package ``other_tree``, its library built
  from DIR's sources) and the two trees' runs alternate in one process,
  so a difference of a few µs shows above the host's drift: the median
  of the 20 paired differences.
* ``--breakdown N ...``: the same rows with the library's split count
  forced to each N (``paged_decode_attention`` of the checkout's kernel
  library called on scratch of the size the wrapper gives that count:
  B x Hkv x N x bundle rows; at this 64-tile table 32 / 16 / 8 splits are
  2 / 4 / 8 tiles a split), each under the profiler; and W = 7 with a GQA
  group of 2 (16 q heads over the 8 kv heads: a 14-row bundle) beside the
  28-row bundle, the same K/V bytes.
* model (unless ``--no-model``): random bf16 weights at Meta-Llama-3-8B's
  published widths, 32 layers (``prefill_forward_ms.random_params``), and
  ``chip_smoke.decode_profile`` over a bf16 and an int8 pool: device ms of
  one decode step of 8 slots at 512 tokens, the paged attention kernels'
  part of it, and a W = 7 verify of 4 slots against its seven steps.

``--root`` imports ``nats_llm_studio_tpu_torch`` from another checkout (an
unpacked parent commit, say), so two versions are timed by one yardstick:
run parent, this tree, this tree, parent back to back on one card. Every
tool named here is the ``chip_smoke.py`` beside this script. Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import statistics
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 0


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rows(smoke, pa):
    """(name, inputs, wrapper) of the kernel phase's K1 and K1q rows."""
    return (("K1 W=1", smoke.k1_inputs, pa.paged_decode_attention),
            ("K1q W=1", smoke.k1q_inputs, pa.paged_decode_attention_kvq),
            ("K1 W=7", smoke.k1_verify_inputs, pa.paged_decode_attention),
            ("K1q W=7", smoke.k1q_verify_inputs, pa.paged_decode_attention_kvq))


def describe(torch, smoke, name: str, fn) -> None:
    ms = smoke.cuda_ms(torch, fn)
    ks = smoke.kernel_us(torch, fn)
    merge = sum(us for k, us in ks.items() if "combine" in k)
    total = sum(ks.values())
    parts = "; ".join(f"{k[:48]} {us:.2f} us" for k, us in sorted(ks.items(), key=lambda x: -x[1]))
    print(f"row {name}: {ms:.4f} ms a call; kernels {total / 1e3:.4f} ms (merge "
          f"{merge / 1e3:.4f} ms), gaps {ms - total / 1e3:.4f} ms; {parts}", flush=True)


def row_times(torch, smoke, pa) -> None:
    for name, make, kern in rows(smoke, pa):
        args = make(torch, torch.Generator(device="cuda").manual_seed(SEED), smoke.LLAMA3_8B)
        bodies = getattr(kern, "body_launches", None)
        before = dict(bodies) if bodies else {}
        kern(*args["args"])
        body = "+".join(k for k in bodies if bodies[k] != before[k]) if bodies else "-"
        describe(torch, smoke, f"{name} body={body}", lambda: kern(*args["args"]))
        del args
        torch.cuda.empty_cache()


def host_run(torch, kern, args, calls: int) -> float:
    """Host µs a call over ``calls`` calls queued behind a device-side sleep."""
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        kern(*args)
    return (time.perf_counter() - t0) / calls * 1e6


def other_tree(root: Path):
    """(paged_attention, kvcache) of the checkout at ``root``, imported as
    the package ``other_tree`` beside this process's own, its kernel
    library built from that checkout's sources into that checkout."""
    pkg = root.resolve() / "nats_llm_studio_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_tree", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules["other_tree"] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    importlib.import_module("other_tree.ops._build").build_all(("paged_attention",))
    return (importlib.import_module("other_tree.ops.paged_attention"),
            importlib.import_module("other_tree.ops.kvcache"))


def host_times(torch, smoke, pa, other=None, calls: int = 200, runs: int = 20) -> None:
    """Each row's host µs a call, ``runs`` runs of ``calls``. With ``other``
    (``other_tree``'s pair) the two checkouts' runs alternate in this one
    process (this, other, other, this, ...) and the median of the paired
    differences is printed too."""
    from nats_llm_studio_tpu_torch.ops.kvcache import is_quantized

    for name, make, kern in rows(smoke, pa):
        args = make(torch, torch.Generator(device="cuda").manual_seed(SEED),
                    smoke.LLAMA3_8B)["args"]
        sides = [("this", kern, args)]
        if other is not None:
            opa, okv = other
            oargs = tuple(okv.KVQ(a.q, a.s) if is_quantized(a) else a for a in args)
            sides.append(("other", getattr(opa, kern.__name__), oargs))
        for _, k, a in sides:
            k(*a)
        us = {tag: [] for tag, _, _ in sides}
        gc.disable()  # no collection inside a timed run
        for i in range(runs):
            for tag, k, a in sides if i % 2 == 0 else sides[::-1]:
                us[tag].append(host_run(torch, k, a, calls))
        gc.enable()
        torch.cuda.synchronize()
        for tag, v in us.items():
            print(f"host {name} ({tag} tree): median {statistics.median(v):.2f} us a call, "
                  f"least {min(v):.2f} ({', '.join(f'{u:.2f}' for u in v)})", flush=True)
        if other is not None:
            d = [a - b for a, b in zip(us["this"], us["other"])]
            print(f"host {name}: this tree less the other, median of {runs} paired runs "
                  f"{statistics.median(d):+.2f} us a call", flush=True)
        del args, sides
        torch.cuda.empty_cache()


def forced(torch, pa, args, n_splits: int):
    """A call of the checkout's library with ``n_splits`` forced, on the
    scratch the wrapper would allocate for that count."""
    from nats_llm_studio_tpu_torch.ops import _build
    from nats_llm_studio_tpu_torch.ops.kvcache import is_quantized

    q, kp, vp, tbl, pos, layer, scale = args
    ks = vs = None
    if is_quantized(kp):
        kp, ks, vp, vs = kp.q, kp.s, vp.q, vp.s
    b, w, hq, d = q.shape
    hkv, t, n_layers = kp.shape[2], kp.shape[3], kp.shape[1]
    n = b * hkv * n_splits * (hq // hkv) * w
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _build.load_library("paged_attention")

    def call():
        rc = lib.paged_decode_attention(
            _build.dtype_code(q.dtype), _build.dtype_code(kp.dtype), q.data_ptr(),
            kp.data_ptr(), vp.data_ptr(), ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None, tbl.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part[:n * d].data_ptr(), part[n * d:].data_ptr(), b, w, hq, hkv, d,
            t, n_layers, tbl.shape[1], int(layer), n_splits, float(scale),
            _build.current_stream(q.device))
        _build.check_launch("paged_decode_attention", rc)
        return out

    return call


def breakdown(torch, smoke, pa, splits) -> None:
    g = torch.Generator(device="cuda")
    for name, make, kern in rows(smoke, pa):
        args = make(torch, g.manual_seed(SEED), smoke.LLAMA3_8B)["args"]
        want = pa.paged_decode_attention_plain(*args)
        for n in splits:
            call = forced(torch, pa, args, n)
            err = float((call().float() - want.float()).abs().max())
            describe(torch, smoke, f"{name} n_splits={n}; max abs err {err:.3e}", call)
        if name.endswith("W=7"):
            c = dict(smoke.LLAMA3_8B, n_heads=16)
            a2 = make(torch, g.manual_seed(SEED), c)["args"]
            describe(torch, smoke, f"{name} group 2 (a 14-row bundle, the same K/V)",
                     lambda: kern(*a2))
            del a2
        del args, want
        torch.cuda.empty_cache()


def model_times(torch, smoke) -> None:
    pf = load("prefill_forward_ms", HERE / "scripts" / "prefill_forward_ms.py")
    cfg = pf.model_config(smoke)
    params = pf.random_params(torch, cfg, SEED)
    for kv in ("none", "int8"):
        eng = types.SimpleNamespace(cfg=cfg.with_(kv_quant=kv),
                                    batcher=types.SimpleNamespace(params=params))
        prof = smoke.decode_profile(torch, eng)
        print(f"decode (kv {kv}) 8 slots x 512 tokens: device "
              f"{prof['device_ms_per_step']:.3f} ms a step, of which paged attention "
              f"{prof['attention_ms_per_step']:.3f} ms; wall {prof['wall_ms_per_step']:.2f} ms "
              f"a step; W=7 verify of {prof['verify_slots']} slots {prof['verify_device_ms']:.3f} "
              f"ms device against {prof['steps_device_ms']:.3f} ms for its steps", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose nats_llm_studio_tpu_torch is timed")
    ap.add_argument("--breakdown", type=int, nargs="+", metavar="N",
                    help="also force the split count to each N, and time W=7 at a 14-row "
                         "bundle")
    ap.add_argument("--no-model", action="store_true", help="skip the 32-layer decode profile")
    ap.add_argument("--ab", type=Path, metavar="DIR",
                    help="time the host µs a call against DIR's wrappers in this process, "
                         "runs alternating")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("decode_attention_ms: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    smoke = load("chip_smoke", HERE / "chip_smoke.py")
    from nats_llm_studio_tpu_torch.ops import _build
    from nats_llm_studio_tpu_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    _build.build_all(("paged_attention",))
    print(f"card: {smoke.card_line()}; root {args.root}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    row_times(torch, smoke, pa)
    host_times(torch, smoke, pa, other_tree(args.ab) if args.ab else None)
    if args.breakdown:
        breakdown(torch, smoke, pa, args.breakdown)
    if not args.no_model:
        model_times(torch, smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
