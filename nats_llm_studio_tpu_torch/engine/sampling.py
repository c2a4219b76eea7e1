"""Token sampling: temperature / top-k / top-p, vectorized per row.

Port of ``nats_llm_studio_tpu/engine/sampling.py`` (``_pick`` and
``sample_rows``; speculative acceptance is not ported yet). As in the
reference, greedy is ``argmax``, unrestricted sampling is Gumbel-max over
the full vocab, and top-k / top-p rows draw from the top ``CANDIDATES``
logits, taken in ``jax.lax.top_k``'s order: value descending, the lower
index first among equals (``_candidates``).

Randomness: row i's Gumbel noise comes from a ``torch.Generator`` seeded
from ``(seeds[i], steps[i])`` alone, so a row's draw never depends on what
else is in the batch (the reference's rule). The bits are not JAX's
threefry bits: the tests feed both packages the same numpy noise through
``_pick``.
"""

from __future__ import annotations

import torch

CANDIDATES = 64  # candidate cap for restricted (top-k/top-p) rows
_MASK64 = (1 << 64) - 1


def _candidates(logits, c: int):
    """The top ``c`` logits per row and their indices, value descending
    and the lower index first among equal values, as ``jax.lax.top_k``
    orders them. ``torch.topk`` leaves the order of ties unspecified, and
    which tied tokens make the cut depends on every element equal to the
    c-th value, so the candidates come from a stable sort of the whole
    row."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :c], idx[:, :c]


def _pick(logits, gumbel, temperature, top_k, top_p, mask=None) -> torch.Tensor:
    """Shared selection. logits: [B, V] f32; gumbel: [B, V] standard Gumbel
    noise; temperature/top_k/top_p: [B] tensors or scalars; ``mask`` (bool
    [B, V], False bans) applies before truncation. Returns int32 [B]."""
    neg_inf = float("-inf")
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    b, v = logits.shape
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(b)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    safe_t = torch.clamp(temperature, min=1e-6)[:, None]

    greedy = torch.argmax(logits, dim=-1)
    # exact unrestricted sampling: argmax(logits/T + G) ~ softmax(logits/T)
    full_pick = torch.argmax(logits / safe_t + gumbel, dim=-1)

    c = min(CANDIDATES, v)
    cand, cand_idx = _candidates(logits, c)  # sorted descending, ties by index
    ranks = torch.arange(c, device=dev)[None, :]
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, c), torch.clamp(top_k, max=c))
    keep = ranks < k_eff[:, None]
    # top-p over the candidate softmax; the first token that crosses p is
    # always kept, so the nucleus is never empty
    probs = torch.softmax(cand / safe_t, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p[:, None]
    g_cand = torch.gather(gumbel, 1, cand_idx)
    masked = torch.where(keep, cand / safe_t, neg_inf)
    drawn = torch.argmax(masked + g_cand, dim=-1)
    cand_pick = torch.gather(cand_idx, 1, drawn[:, None])[:, 0]

    restricted = ((top_k > 0) & (top_k < v)) | (top_p < 1.0)
    pick = torch.where(restricted, cand_pick, full_pick)
    return torch.where(temperature <= 0.0, greedy, pick).to(torch.int32)


def _row_seed(seed: int, step: int) -> int:
    """splitmix64 of (seed, step): one generator seed per (row seed, step)."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF)) & _MASK64
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def row_gumbel(seed: int, step: int, v: int, device) -> torch.Tensor:
    """Standard Gumbel noise [v] for one row, a function of (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(_row_seed(seed, step))
    u = torch.rand(v, generator=g, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_rows(logits, seeds, steps, temperature=0.8, top_k=0, top_p=1.0,
                mask=None) -> torch.Tensor:
    """Per-row deterministic sampling: logits [B, V] f32; seeds, steps:
    [B] ints (lists or tensors). Greedy rows (temperature <= 0) draw no
    noise — their pick does not read it. An all-greedy batch is _pick's
    argmax alone: no noise and no per-row tensors are built."""
    b, v = logits.shape
    dev = logits.device
    temps = torch.as_tensor(temperature, dtype=torch.float32).expand(b).tolist()
    if all(t <= 0.0 for t in temps):
        if mask is not None:
            logits = torch.where(mask, logits, float("-inf"))
        return torch.argmax(logits, dim=-1).to(torch.int32)
    seeds = torch.as_tensor(seeds).tolist()
    steps = torch.as_tensor(steps).tolist()
    gumbel = torch.zeros((b, v), dtype=torch.float32, device=dev)
    for i in range(b):
        if temps[i] > 0.0:
            gumbel[i] = row_gumbel(seeds[i], steps[i], v, dev)
    return _pick(logits, gumbel, temperature, top_k, top_p, mask=mask)
