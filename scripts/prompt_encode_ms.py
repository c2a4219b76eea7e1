"""Host ms to turn one chat of ``chip_smoke.py``'s group wave into token
ids: the chat format chosen and the prompt rendered, then tokenized, at
the smoke model's 128,256-token byte-level vocabulary.

Two ways, each the least of ``--reps`` runs over the wave's four prompts:

* ``per_chat``: the format chosen anew for every chat (``chat_renderer``
  built per call, which builds a set of the whole vocabulary) and the
  tokenizer's piece cache emptied first, as a chat was encoded before
  the engine kept its renderer and the tokenizer its cache;
* ``engine``: one renderer, the cache warm from earlier chats, as the
  engine runs now.

The worker does this on its event loop, in front of each arrival, so the
wave's arrivals at the batcher are spaced by about this much.

    python scripts/prompt_encode_ms.py [--reps 20]

Prints one JSON line. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nats_llm_studio_tpu_torch.gguf.constants import TokenType  # noqa: E402
from nats_llm_studio_tpu_torch.gguf.tokenizer import (  # noqa: E402
    GGUFTokenizer,
    _byte_to_unicode,
)
from nats_llm_studio_tpu_torch.serve.template import chat_renderer  # noqa: E402

VOCAB = 128256  # chip_smoke.LLAMA3_8B's, with write_gguf's token list


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    b2u = _byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    tokens += [f"<filler_{i}>" for i in range(256, VOCAB - 1)] + ["<|eot|>"]
    md = {"tokenizer.ggml.tokens": tokens}
    tok = GGUFTokenizer("gpt2", tokens, merges=[], eos_id=VOCAB - 1, add_bos=False,
                        token_types=[int(TokenType.NORMAL)] * (VOCAB - 1)
                        + [int(TokenType.CONTROL)])
    long_text = ("The harbour town kept its records in a long ledger. " * 80)[:3980]
    wave = [[{"role": "user", "content": f"Ledger {i}: " + long_text[:3960]}]
            for i in range(4)]

    def per_chat(msgs):
        tok._piece_ids.clear()
        return tok.encode(chat_renderer(md)(msgs))

    render = chat_renderer(md)

    def engine(msgs):
        return tok.encode(render(msgs))

    out = {"vocab": VOCAB, "prompt_tokens": len(engine(wave[0]))}
    for name, fn in (("per_chat", per_chat), ("engine", engine)):
        best = float("inf")
        for _ in range(args.reps):
            for msgs in wave:
                t0 = time.perf_counter()
                fn(msgs)
                best = min(best, (time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms"] = best
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
