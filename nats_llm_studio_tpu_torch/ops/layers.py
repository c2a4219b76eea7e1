"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU.

Port of ``nats_llm_studio_tpu/ops/layers.py``. Numerics policy is the
reference's: inputs and weights may be bf16; norms and softmax reduce in f32
and cast back. Weights are [d_in, d_out] and applied as ``x @ w``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """Root-mean-square layer norm (no mean subtraction, no bias).
    ``plus_one`` applies gemma's ``x * (1 + w)`` convention."""
    xf = x.float()
    rrms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = (xf * rrms).to(x.dtype)
    return y * (weight + 1) if plus_one else y * weight


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding: positions int [...] ->
    (cos, sin) each [..., head_dim // 2] f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (first half, second half); GGUF's interleaved
    pairs are permuted away by the weight loader. x: [B, T, H, D];
    cos/sin: [B, T, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def gqa_attention_hmajor(q: torch.Tensor, k, v, mask: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Dense GQA attention over a heads-major cache (the oracle every
    attention kernel is held against).

    q: [B, T, Hq, D]; k, v: [B, Hkv, S, D] in q's dtype, or int8 ``KVQ``
    slabs (ops/kvcache.py); mask: bool [B, T, S] (True = may attend).
    Scores and softmax in f32, probabilities cast to v's dtype before the
    PV product. On a KVQ slab the scales fold outside the products, as in
    the reference: K's onto the scores after the QK dot, V's into the
    probabilities before the PV dot (so this rounds at other points than
    the kernels, which dequantize each tile). Returns [B, T, Hq, D] in
    q.dtype."""
    from .kvcache import is_quantized

    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, d)
    if is_quantized(k):
        logits = torch.einsum("bthgd,bhsd->bhgts", qg.float(),
                              k.q.to(q.dtype).float()) * k.s[:, :, None, None, :]
    else:
        logits = torch.einsum("bthgd,bhsd->bhgts", qg.float(), k.float())
    logits = logits * scale
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    if is_quantized(v):
        pv = (probs * v.s[:, :, None, None, :]).to(q.dtype)
        out = torch.einsum("bhgts,bhsd->bthgd", pv.float(), v.q.to(q.dtype).float())
    else:
        out = torch.einsum("bhgts,bhsd->bthgd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype).reshape(b, t, hq, d)


def softmax_pv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v rounded where the attention kernels round: the
    unnormalized exp(s - rowmax) is cast to v's dtype before an f32 PV
    product, the row sum is taken unrounded in f32, and the product is
    divided by max(sum, 1e-30) at the end.

    s: f32 [B, Hkv, G, Q, S] masked scores; v: [B, Hkv, S, D]. Returns f32
    [B, Q, Hkv, G, D]."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhgqs,bhsd->bhgqd", p.to(v.dtype).float(), v.float())
    return (acc / l).permute(0, 3, 1, 2, 4)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Unquantized ``x @ w`` (the JAX package leaves this product to XLA;
    here it is PyTorch's matmul)."""
    return torch.matmul(x, w)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, act: str = "silu") -> torch.Tensor:
    """Gated MLP: down(act(x @ gate) * (x @ up)); "silu" (SwiGLU) or
    "gelu" (gemma GeGLU, tanh approximation)."""
    g = mm(x, w_gate)
    gate = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return mm(gate * mm(x, w_up), w_down)
