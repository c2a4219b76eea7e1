"""Token sampling: temperature / top-k / top-p, vectorized per row, and
the speculative-decoding acceptance rule.

Port of ``nats_llm_studio_tpu/engine/sampling.py`` (``_pick``,
``sample_rows``, ``_log_weights``, ``spec_accept_rows``) plus the logprob
readback of the reference batcher's ext programs (``logprob_rows``). As in
the reference, greedy is ``argmax``, unrestricted sampling is Gumbel-max
over the full vocab, and top-k / top-p rows draw from the top
``CANDIDATES`` logits, taken in ``jax.lax.top_k``'s order: value
descending, the lower index first among equals (``_candidates``).

Randomness: row i's Gumbel noise comes from a ``torch.Generator`` seeded
from ``(seeds[i], steps[i])`` alone, so a row's draw never depends on what
else is in the batch (the reference's rule). The bits are not JAX's
threefry bits: the tests feed both packages the same numpy noise through
``_pick`` and ``spec_accept_from_noise``.
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


# ---------------------------------------------------------------------------
# speculative decoding: rejection-sampling acceptance (serve/spec.py design)
# ---------------------------------------------------------------------------


def _log_weights(logits, temperature, top_k, top_p, mask=None) -> torch.Tensor:
    """Full-vocab log-weights ``w`` with softmax(w) equal to the
    distribution ``_pick`` draws from for temperature > 0 rows: the same
    candidate cap, the same top-k / top-p truncation, token for token.
    Tokens that cannot be drawn sit at -inf. ``mask`` bans tokens before
    truncation, as in ``_pick``. logits: [B, V] f32. Greedy rows are the
    caller's job (a point mass at argmax)."""
    neg_inf = float("-inf")
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    b, v = logits.shape
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(b)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    safe_t = torch.clamp(temperature, min=1e-6)[:, None]

    c = min(CANDIDATES, v)
    cand, cand_idx = _candidates(logits, c)
    ranks = torch.arange(c, device=dev)[None, :]
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, c), torch.clamp(top_k, max=c))
    keep = ranks < k_eff[:, None]
    probs = torch.softmax(cand / safe_t, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p[:, None]
    # the kept candidates scattered back onto the full vocab axis
    masked = torch.full((b, v), neg_inf, device=dev).scatter(
        1, cand_idx, torch.where(keep, cand / safe_t, neg_inf))
    restricted = (((top_k > 0) & (top_k < v)) | (top_p < 1.0))[:, None]
    return torch.where(restricted, masked, logits / safe_t)


def spec_accept_from_noise(logits, drafts, draft_len, u, gumbel, temperature=0.8,
                           top_k=0, top_p=1.0, mask=None):
    """The acceptance rule of ``spec_accept_rows`` on given noise.

    logits: [B, T, V] f32 verify logits (T = k + 1); drafts: [B, k] int;
    draft_len: [B] valid drafts per row; u: [B, T] uniforms; gumbel:
    [B, T, V] standard Gumbel noise (both None only when every row is
    greedy: greedy rows never read them, and nothing is drawn for them);
    mask: [B, T, V] bool, False bans.

    Position j's distribution p_j is what the plain sampler draws from
    (``_log_weights``; a point mass at argmax for greedy rows). Draft d_j is
    accepted with probability p_j(d_j); at the first rejection the extra
    token is drawn from p_j with d_j removed, and when every valid draft is
    accepted it is a plain sample from the next position. Greedy rows so
    accept while the draft equals argmax. Returns ``(tokens [B, T] int32,
    n_emit [B] int32)``: row b emits ``tokens[b, :n_emit[b]]``; positions
    past n_emit hold zeros."""
    neg_inf = float("-inf")
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    b, t, v = logits.shape
    kd = t - 1
    dev = logits.device
    drafts = torch.as_tensor(drafts, device=dev).long()
    draft_len = torch.as_tensor(draft_len, device=dev).long()
    temp_b = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)
    is_greedy = temp_b <= 0.0
    greedy_tok = torch.argmax(logits, dim=-1)  # [B, T]
    j_draft = torch.arange(kd, device=dev)[None, :]
    sampled = u is not None
    if sampled:
        def per_row(x):  # a [B] setting for each of the T position-major rows
            return torch.as_tensor(x, device=dev).expand(b).repeat(t)

        rows = logits.transpose(0, 1).reshape(t * b, v)
        w = _log_weights(rows, per_row(temperature), per_row(top_k), per_row(top_p))
        w = w.reshape(t, b, v).transpose(0, 1)  # [B, T, V]
        p = torch.softmax(w, dim=-1)
        p_draft = torch.gather(p[:, :kd], 2, drafts[..., None])[..., 0]
        ok = torch.where(is_greedy[:, None], drafts == greedy_tok[:, :kd],
                         u[:, :kd] < p_draft)
    else:
        ok = drafts == greedy_tok[:, :kd]
    ok &= j_draft < draft_len[:, None]
    # accepted = the length of the all-accepted prefix
    a = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # [B] in 0..kd
    greedy_a = torch.gather(greedy_tok, 1, a[:, None])[:, 0]
    extra = greedy_a
    if sampled:
        # a rejection resamples the residual (the draft masked out), full
        # acceptance samples plainly
        w_a = torch.gather(w, 1, a[:, None, None].expand(b, 1, v))[:, 0]
        g_a = torch.gather(gumbel, 1, a[:, None, None].expand(b, 1, v))[:, 0]
        d_a = torch.gather(drafts, 1, torch.clamp(a, max=kd - 1)[:, None])[:, 0]
        rejected = a < draft_len
        w_res = torch.where(
            rejected[:, None] & (torch.arange(v, device=dev)[None, :] == d_a[:, None]),
            neg_inf, w_a)
        pick = torch.argmax(w_res + g_a, dim=-1)
        extra = torch.where(is_greedy, greedy_a, pick)
    j = torch.arange(t, device=dev)[None, :]
    drafts_pad = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype, device=dev)], 1)
    out = torch.where(j < a[:, None], drafts_pad, torch.zeros_like(drafts_pad))
    out = torch.where(j == a[:, None], extra[:, None], out)
    return out.to(torch.int32), (a + 1).to(torch.int32)


def spec_accept_rows(logits, drafts, draft_len, seeds, steps, temperature=0.8, top_k=0,
                     top_p=1.0, mask=None):
    """Rejection-sampling acceptance of prompt-lookup drafts, with the noise
    drawn per row: position j of row b draws from the stream
    ``(seeds[b], steps[b] + j)``, one generator that gives first the
    acceptance uniform and then the residual/bonus Gumbel vector, so every
    position's noise is independent of the others and of the batch.
    Greedy rows draw nothing, and a sampled row draws only the positions
    its drafts can reach (0..draft_len): no other position's noise is read.
    Callers advance the step counter by T per verify. Returns
    ``spec_accept_from_noise``'s ``(tokens [B, T], n_emit [B])``."""
    b, t, v = logits.shape
    dev = logits.device
    temps = torch.as_tensor(temperature, dtype=torch.float32).expand(b).tolist()
    u = gumbel = None
    if any(x > 0.0 for x in temps):
        seeds = torch.as_tensor(seeds).tolist()
        steps = torch.as_tensor(steps).tolist()
        dlen = torch.as_tensor(draft_len).tolist()
        u = torch.zeros((b, t), dtype=torch.float32, device=dev)
        gumbel = torch.zeros((b, t, v), dtype=torch.float32, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        for i in range(b):
            if temps[i] <= 0.0:
                continue
            for j in range(min(int(dlen[i]), t - 1) + 1):
                g = torch.Generator(device=dev)
                g.manual_seed(_row_seed(seeds[i], steps[i] + j))
                x = torch.rand(v + 1, generator=g, device=dev, dtype=torch.float32)
                u[i, j] = x[0]
                gumbel[i, j] = -torch.log(-torch.log(torch.clamp(x[1:], min=tiny)))
    return spec_accept_from_noise(logits, drafts, draft_len, u, gumbel, temperature, top_k,
                                  top_p, mask=mask)


def logprob_rows(logits, chosen, k: int):
    """The ext programs' readback: f32 ``log_softmax`` of logits [B, V],
    the chosen tokens' logprobs [B], and the top ``k`` (ids [B, k], logprobs
    [B, k]) in ``jax.lax.top_k``'s order."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lp = torch.gather(logp, 1, chosen.long()[:, None])[:, 0]
    top_lp, top_ids = _candidates(logp, min(k, logp.shape[-1]))
    return lp, top_ids.to(torch.int32), top_lp
