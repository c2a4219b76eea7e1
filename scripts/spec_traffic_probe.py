#!/usr/bin/env python3
"""Which greedy traffic gives prompt-lookup drafts to the random-weight
Llama-3-8B-width model of chip_smoke.py, on one NVIDIA H100.

    python3 scripts/spec_traffic_probe.py [--tokens 384] [--seed 0]

Speculative decoding drafts from a request's own history, so drafts are
accepted only where the model repeats what came before the same n-gram. A
trained model copies from its prompt; random weights do not. For each KV
mode this writes the 32-layer model (chip_smoke.write_gguf, --seed), then
sends each prompt below alone to the port's batcher (spec on, k = 6,
greedy) and prints the spec counters (verifies, drafted, accepted), the
distinct tokens of the output and its tok/s:

* a chat asking for a ~300-token passage back, and the same passage eight
  times over;
* prompts that hold the model's own greedy output again: the prompt, its
  first 128 output tokens, the prompt again and the first 96 (a verify
  would draft tokens 96.. from the first copy);
* runs of one character (400, 1500 and 3000 "a", 1000 spaces).

The last line is a JSON object of every run's counters, keyed by KV mode
and prompt name. Writes under build/probe (removed at the end).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


async def probe(torch, root: Path, kv: str, tokens: int) -> dict:
    import chip_smoke as cs
    from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
    from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
    from nats_llm_studio_tpu_torch.store import ModelStore

    reg = TorchRegistry(ModelStore(root), device="cuda", max_seq_len=4096, max_batch_slots=8,
                        kv_quant=kv, spec_decode_k=cs.SPEC_K)
    eng = await reg.get_engine(cs.MID)
    b = eng.batcher
    out: dict = {}

    def enc(text: str) -> list[int]:
        return eng._encode_prompt({"messages": [{"role": "user", "content": text}]})

    async def run(name: str, ids: list[int], n: int) -> list[int]:
        c0 = b.stats.spec_counters()
        t0 = time.perf_counter()
        got = [t async for t in b.submit(ids, SamplingParams(temperature=0.0, max_tokens=n))]
        dt = time.perf_counter() - t0
        c1 = b.stats.spec_counters()
        r = {k: c1[k] - c0[k] for k in c1}
        r.update(prompt=len(ids), out=len(got), distinct=len(set(got)),
                 tok_s=len(got) / dt)
        out[name] = r
        print(f"probe (kv {kv}) {name}: {json.dumps(r)}; first ids {got[:8]}", flush=True)
        return got

    passage = cs.SPEC_CHATS[0]
    p = enc(passage)
    o = await run("passage", p, tokens)
    await run("passage*8", enc(passage.split("\n\n", 1)[1] * 8), tokens)
    await run("copy: P+O[:128]+P+O[:96]", p + o[:128] + p + o[:96], 32)
    for name, text in (("a*400", "a" * 400), ("a*1500", "a" * 1500), ("a*3000", "a" * 3000),
                       ("space*1000", " " * 1000)):
        await run(name, enc(text), tokens)
    await reg.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=384, help="greedy tokens a run")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("spec_traffic_probe: no CUDA device is available", file=sys.stderr)
        return 1
    work = ROOT / "build" / "probe"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "models"
    path = root / cs.MID / "model.gguf"
    path.parent.mkdir(parents=True)
    cs.write_gguf(torch, path, cs.LLAMA3_8B["n_layers"], args.seed)
    print(cs.card_line(), flush=True)
    result = {}
    for kv in ("none", "int8"):
        result[kv] = asyncio.run(probe(torch, root, kv, args.tokens))
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
