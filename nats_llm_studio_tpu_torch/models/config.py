"""Model hyperparameters, readable from GGUF metadata.

Key names follow the public GGUF conventions (``<arch>.block_count`` etc.)
that conversion tools write; ``from_gguf`` therefore loads any
llama/granite/mixtral-family file without sidecar config.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

KV_QUANT_MODES = ("none", "int8")


def check_kv_quant(mode: str) -> str:
    """``mode`` if it names a KV cache storage the port serves, else raise."""
    if mode not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant must be one of {KV_QUANT_MODES}, got {mode!r}")
    return mode


@dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14336
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # MoE (Mixtral-style); 0 experts = dense
    n_experts: int = 0
    n_experts_used: int = 0
    # Granite-3.x multipliers (all 1.0 / None for llama)
    embedding_scale: float = 1.0
    residual_scale: float = 1.0
    attention_scale: float | None = None  # None -> 1/sqrt(head_dim)
    logit_scale: float = 1.0
    # Qwen2-family: QKV projections carry biases
    attn_bias: bool = False
    # Gemma-family: GELU MLP and RMSNorm computing x * (1 + w)
    mlp_act: str = "silu"  # "silu" | "gelu"
    norm_plus_one: bool = False
    dtype: str = "bfloat16"  # "bfloat16" (the card) or "float32" (the CPU, tests)
    # KV cache storage: "none" (the compute dtype) or "int8" (KVQ codes plus
    # f32 scales, ops/kvcache.py; TPU_KV_QUANT)
    kv_quant: str = "none"

    def __post_init__(self) -> None:
        check_kv_quant(self.kv_quant)

    @property
    def attn_scale(self) -> float:
        return self.attention_scale if self.attention_scale is not None else self.head_dim**-0.5

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def with_(self, **kw: Any) -> "ModelConfig":
        return replace(self, **kw)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_gguf_metadata(cls, md: dict[str, Any]) -> "ModelConfig":
        arch = str(md.get("general.architecture", "llama"))

        def g(key: str, default: Any = None) -> Any:
            return md.get(f"{arch}.{key}", default)

        n_heads = int(g("attention.head_count", 32))
        d_model = int(g("embedding_length", 4096))
        head_dim = int(g("attention.key_length", d_model // n_heads))
        vocab = md.get(f"{arch}.vocab_size")
        if vocab is None:
            toks = md.get("tokenizer.ggml.tokens")
            vocab = len(toks) if toks is not None else 32000
        # architecture-family quirks beyond the metadata keys (the same
        # special-casing llama.cpp's build_* graph constructors apply).
        # Families whose topology this model does NOT implement are rejected
        # loudly — half-running them (dropped shared experts, missing
        # post-norms/softcapping) would load fine and produce garbage.
        if arch in ("gemma2", "gemma3", "qwen2moe"):
            raise NotImplementedError(
                f"architecture {arch!r} needs topology this model does not "
                "implement (post-norms/softcapping or shared experts)"
            )
        family: dict[str, Any] = {}
        if arch == "qwen2":
            family["attn_bias"] = True
        elif arch == "gemma":
            # NOTE: no norm_plus_one here — llama.cpp's GGUF converter folds
            # gemma's (1+w) into the stored norm weights, so GGUF-loaded
            # models use the plain multiply. The flag exists for checkpoints
            # that keep the HF convention.
            family |= {
                "mlp_act": "gelu",
                "tie_embeddings": True,
                # gemma scales embeddings by sqrt(d_model)
                "embedding_scale": float(d_model) ** 0.5,
            }
        kwargs: dict[str, Any] = dict(
            arch=arch,
            vocab_size=int(vocab),
            d_model=d_model,
            n_layers=int(g("block_count", 32)),
            n_heads=n_heads,
            n_kv_heads=int(g("attention.head_count_kv", n_heads)),
            head_dim=head_dim,
            d_ff=int(g("feed_forward_length", 4 * d_model)),
            rope_theta=float(g("rope.freq_base", 10000.0)),
            rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
            max_seq_len=int(g("context_length", 8192)),
            n_experts=int(g("expert_count", 0) or 0),
            n_experts_used=int(g("expert_used_count", 0) or 0),
            embedding_scale=float(g("embedding_scale", 1.0)),
            residual_scale=float(g("residual_scale", 1.0)),
            attention_scale=(
                float(g("attention.scale")) if g("attention.scale") is not None else None
            ),
            # GGUF stores granite's logit scale as a divisor (engines multiply
            # final logits by 1/f_logit_scale); internally we keep a multiplier
            logit_scale=1.0 / float(g("logit_scale", 1.0)),
        )
        kwargs.update(family)  # family quirks win over absent metadata keys
        return cls(**kwargs)

    @classmethod
    def tiny(cls, **kw: Any) -> "ModelConfig":
        """A 4-layer toy config for CPU tests."""
        base = dict(
            vocab_size=512,
            d_model=64,
            n_layers=4,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            max_seq_len=256,
            dtype="float32",
        )
        base.update(kw)
        return cls(**base)
