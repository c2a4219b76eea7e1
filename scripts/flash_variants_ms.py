#!/usr/bin/env python3
"""Time variants of the flash attention kernels (K2, K3, K4) on one GPU in
one call.

    python3 scripts/flash_variants_ms.py [--variants hopper,no_turns] [--rows "K2,K4 B4"]

Each variant is a copy of ``nats_llm_studio_tpu_torch`` under the
gitignored ``build/variants/<name>/`` whose ``csrc/flash_attention.cu`` has
text edits applied. The copies build in parallel (each into its own
``build/torch_kernels``), then each is timed in a subprocess of its own on
the same card, in the order given and then back again, so that variants
compare without two calls' cards between them. The edits are pinned to
the source's text: one that no longer matches stops the script, naming
it. Variants:

* ``hopper``: the source as it stands;
* ``one_tile_a_cta``: the Hopper body without its persistent grid (bf16
  launches one CTA a work tile, as int8 does);
* ``round_robin``: the persistent grid walking the tiles in plain rounds
  (CTA j takes tiles j, j + grid, ...) instead of the snake order;
* ``no_turns``: the consumers without their turns at the tensor cores;
* ``no_softmax``: the softmax of every key tile after the first skipped
  (wrong results: the share of the time the softmax sets);
* ``half_s``: S = Q K^T over half of the head dim (wrong results: the
  share the tensor work sets).

Rows are ``chip_smoke.py``'s kernel rows on its seed-0 inputs; a row prefix
list (``--rows "K2,K4 B4"``) picks some. Each is timed three times by
``chip_smoke.cuda_ms`` (CUDA events behind a device-side sleep; the least
is reported) beside its max abs error against the plain version. Needs a
CUDA card and nvcc. The mma.sync body that the Hopper body replaced is
timed from a checkout of an earlier commit instead
(``scripts/prefill_forward_ms.py --root``).
"""

from __future__ import annotations

import argparse
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "variants"
SRC = "flash_attention.cu"
TURNS = ("named_bar_sync(BAR_TURN + c, 256);",
         "if (c == 0 || n < n_kt - 1) named_bar_arrive(BAR_TURN + 1 - c, 256);",
         "if (c == 0 || n_kt > 1) named_bar_arrive(BAR_TURN + 1 - c, 256);",
         "if (c == 1) named_bar_arrive(BAR_TURN, 256);")
VARIANTS = {
    "hopper": [],
    "one_tile_a_cta": [("grid = min(n_tiles, sms);", "grid = n_tiles + 0 * sms;")],
    "round_robin": [("((i & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x)",
                     "(int)blockIdx.x")],
    "no_turns": [(t, "") for t in TURNS],
    "no_softmax": [("        softmax(n);\n        rescale_o();",
                    "        corr[0] = corr[1] = 1.f;\n        rescale_o();")],
    "half_s": [("for (int kk = 0; kk < WG_D / 16; ++kk) {\n          const int off",
                "for (int kk = 0; kk < WG_D / 32; ++kk) {\n          const int off")],
}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_rows(root: Path, rows: str) -> None:
    """Time the kernel rows with the package under ``root`` (a subprocess
    per variant: each imports its own copy)."""
    import torch

    sys.path.insert(0, str(root))
    from nats_llm_studio_tpu_torch.ops import flash_attention as fa

    smoke = load_chip_smoke()
    c = smoke.LLAMA3_8B
    k2, k3, k4 = fa.flash_attention, fa.flash_attention_chunk, fa.flash_attention_chunk_kvq
    cases = (("K2 T512", smoke.k2_inputs, k2), ("K2 T4096", smoke.k2_long_inputs, k2),
             ("K2 B4", smoke.k2_group_inputs, k2), ("K3", smoke.k3_inputs, k3),
             ("K3 KW4096", smoke.k3_long_inputs, k3), ("K3 B4", smoke.k3_group_inputs, k3),
             ("K3 fill", smoke.k3_fill_inputs, k3), ("K4", smoke.k4_inputs, k4),
             ("K4 KW4096", smoke.k4_long_inputs, k4), ("K4 B4", smoke.k4_group_inputs, k4),
             ("K4 fill", smoke.k4_fill_inputs, k4))
    plain = {k2: fa.flash_attention_plain, k3: fa.flash_attention_chunk_plain,
             k4: fa.flash_attention_chunk_kvq_plain}
    for name, make, kern in cases:
        if rows != "all" and not any(name.startswith(r) for r in rows.split(",")):
            continue
        args = make(torch, torch.Generator(device="cuda").manual_seed(0), c)["args"]
        err = float((kern(*args).float() - plain[kern](*args).float()).abs().max())
        ms = [smoke.cuda_ms(torch, lambda: kern(*args)) for _ in range(3)]
        print(f"  {name}: ms={min(ms):.4f} ({', '.join(f'{m:.4f}' for m in ms)}) "
              f"max_abs_err={err:.2e}", flush=True)
        del args
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="hopper,no_turns",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--rows", default="all", help="row-name prefixes, comma-separated")
    ap.add_argument("--time-root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_root is not None:
        time_rows(args.time_root, args.rows)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_variants_ms: no CUDA device is available", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    shutil.rmtree(OUT, ignore_errors=True)
    builds = {}
    for name in names:
        pkg = OUT / name / "nats_llm_studio_tpu_torch"
        shutil.copytree(HERE / "nats_llm_studio_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = pkg / "csrc" / SRC
        text = src.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: edit no longer matches {SRC}: {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
        code = (f"import sys; sys.path.insert(0, {str(OUT / name)!r}); "
                "from nats_llm_studio_tpu_torch.ops import _build; "
                "_build.build_all(('flash_attention',))")
        builds[name] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: build failed:\n{log}")
    smoke = load_chip_smoke()
    print(f"card: {smoke.card_line()}", flush=True)
    for name in names + names[::-1]:
        print(f"== {name}", flush=True)
        r = subprocess.run([sys.executable, __file__, "--time-root", str(OUT / name),
                            "--rows", args.rows], capture_output=True, text=True, timeout=900)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            raise SystemExit(f"variant {name}: timing failed:\n{r.stderr[-3000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
