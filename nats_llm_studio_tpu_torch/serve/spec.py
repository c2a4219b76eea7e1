"""Self-speculative decoding: prompt-lookup (n-gram) draft proposal.

Copy of the jax-free ``nats_llm_studio_tpu/serve/spec.py``
(``SpecConfig``, ``NGramIndex``, ``SpecSlot``, ``make_slot``).

A decode step at low occupancy is memory-bound: it reads every weight to
emit one token a slot. Speculative decoding (Leviathan et al.) guesses a
short continuation and verifies all of it in one width-``k+1`` forward.
The draft source is *prompt lookup* (Saxena): chat traffic re-emits spans
of its own prompt, so the request's own token history is the draft model,
with no second model and no draft forward.

This module is the host-side half: a per-slot incremental n-gram index
over prompt + generated tokens that proposes up to ``k`` draft tokens in
O(max_ngram) per call. The device-side half (the verify forward and the
acceptance rule) lives in serve/batcher.py and engine/sampling.py.

Why no KV rollback is needed on rejection: the paged pool holds each
slot's token at its sequence position. A verify writes k+1 rows at
positions pos..pos+k; if only ``a`` drafts are accepted, the slot's
position moves to pos+a+1 and the rows above it are stale. Decode
attention masks by position (``key_pos <= query position``), so they are
never read, and the slot's next write lands at pos+a+1, on top of the
first stale row.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (config.py env contract: SPEC_DECODE_*)."""

    k: int = 6  # max draft tokens per slot per verify (verify width = k+1)
    max_ngram: int = 3  # longest lookup key (matched first)
    min_ngram: int = 1  # shortest lookup key tried
    # verify dispatches stop above this many active slots: wide batches are
    # compute-bound (the weight read is already amortized over the batch),
    # so burning k× lm_head + attention FLOPs per slot on drafts stops
    # paying — decode falls back to plain bursts until occupancy drops
    max_active: int = 4


class NGramIndex:
    """Incremental n-gram → last-occurrence index over one slot's tokens.

    For each n in [min_ngram, max_ngram] the index maps every n-gram to its
    two most recent END positions. ``propose`` takes the current tail
    n-gram (which always has its latest occurrence at the tail itself) and
    drafts the tokens that followed its PREVIOUS occurrence — longest n
    first, so a 3-gram match beats a 1-gram match. Append is O(max_ngram);
    memory is O(len(history) * ngram orders), bounded by max_seq.
    """

    def __init__(
        self,
        token_ids: list[int],
        max_ngram: int = 3,
        min_ngram: int = 1,
    ):
        self.max_ngram = max(1, max_ngram)
        self.min_ngram = max(1, min(min_ngram, self.max_ngram))
        self.hist: list[int] = []
        # per order n: ngram tuple -> (latest end pos, previous end pos|None)
        self._maps: dict[int, dict[tuple, tuple[int, int | None]]] = {
            n: {} for n in range(self.min_ngram, self.max_ngram + 1)
        }
        for t in token_ids:
            self.append(t)

    def append(self, tok: int) -> None:
        """Register ``tok`` and every n-gram that now ends at it."""
        self.hist.append(tok)
        i = len(self.hist) - 1
        for n, m in self._maps.items():
            if i + 1 < n:
                continue
            g = tuple(self.hist[i - n + 1 : i + 1])
            old = m.get(g)
            m[g] = (i, old[0] if old is not None else None)

    def extend(self, toks) -> None:
        for t in toks:
            self.append(t)

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the current tail, or []."""
        L = len(self.hist)
        if k <= 0 or L < self.min_ngram + 1:
            return []
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if L < n:
                continue
            g = tuple(self.hist[L - n :])
            ent = self._maps[n].get(g)
            if ent is None:
                continue
            last, prev = ent
            # the tail itself is always the latest occurrence; draft from
            # the one before it (an earlier span that continued past g)
            src = prev if last == L - 1 else last
            if src is None or src >= L - 1:
                continue
            return self.hist[src + 1 : src + 1 + k]
        return []


@dataclass
class SpecSlot:
    """Per-slot speculative state the batcher owner thread maintains:
    the n-gram index doubles as the slot's token history (prompt + every
    delivered token, INCLUDING the one still riding the device carry)."""

    index: NGramIndex
    drafted: int = 0
    accepted: int = 0


def make_slot(prompt_ids: list[int], first_token: int, cfg: SpecConfig) -> SpecSlot:
    """Slot state right after an admit: history = prompt + the admit's
    sampled first token (on device in ``tok_dev``, not yet written to KV —
    the same invariant the ring batcher keeps host-side)."""
    idx = NGramIndex(prompt_ids, cfg.max_ngram, cfg.min_ngram)
    idx.append(first_token)
    return SpecSlot(index=idx)
