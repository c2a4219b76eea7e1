"""Compute-efficiency plane: roofline accounting and HBM ledger reconciliation.

Port of ``nats_llm_studio_tpu/obs/roofline.py``. Three host-side pieces that
the batcher, registry and worker wire together into MFU / MBU / goodput
metrics:

* **Program costs** — ``ForwardCost`` counts the flops and bytes of one
  dispatch analytically, from the ``ModelConfig`` and the dispatch's shapes
  (query rows, tokens a row, each row's context, rows that produce logits,
  steps in a burst; the KV dtype comes from the config). It never reads a
  timing or which attention body ran, so the same work counts the same on
  the CPU's plain path, on the card's kernels and on a later redesign of
  them. (The reference reads XLA's ``cost_analysis``, which eager PyTorch
  does not have.)
* **Peak table** — ``resolve_chip_peaks`` looks up peak dense bf16 FLOP/s and
  HBM bytes/s for a ``torch.cuda.get_device_name`` string (the H100 parts),
  overridable with ``TPU_PEAK_FLOPS`` / ``TPU_HBM_GBPS``, with the reference's
  modest CPU fallback so CPU runs still report nonzero MFU / MBU.
* **HBM ledger** — ``HbmLedger`` reconciles the sum of priced memory
  components (weights and pool, prefix cache, workspace slack) against the
  allocator's bytes in use (``torch.cuda.memory_stats``) on every
  flight-recorder tick and fires one ``hbm_drift`` event when unexplained
  bytes grow monotonically past a threshold: a leak detector for the pool,
  copy-on-write and drain paths. Inert on the CPU.

The port's program names (``serve/batcher.py``): prefill class
``admit_fused_paged``, ``admit_many_fused_paged``, ``prefill_full``,
``prefill1``, ``prefill_chunk_group``, ``select_end``,
``finish_admit_paged``, ``finish_admit_group_paged``, ``sample_first``,
``fill_row_chunk``; decode class ``decode_pos_pallas``,
``decode_pos_pallas_ext``, ``spec_verify_pallas`` (the spec program);
``pool_copy_block`` is "other". The reference's names stay in the sets, so
one classification serves both packages' program names.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable

__all__ = [
    "PREFILL_PROGRAMS",
    "DECODE_PROGRAMS",
    "SPEC_PROGRAMS",
    "WASTE_CATEGORIES",
    "classify_program",
    "program_base",
    "program_family",
    "efficiency_enabled",
    "chip_peaks",
    "resolve_chip_peaks",
    "ForwardCost",
    "RollingUtilization",
    "HbmLedger",
]

# -- program classification ----------------------------------------------------
#
# Names must match the keys the batcher passes to ``BatcherStats.record_program``.
# Prefill programs are compute-bound (MFU is the headline); decode programs are
# bandwidth-bound (MBU is the headline). Anything else (CoW block copies) lands
# in "other".

PREFILL_PROGRAMS = frozenset(
    {
        "prefill1",
        "prefill_full",
        "admit_fused",
        "admit_many_fused",
        "finish_admit",
        "prefill_chunk_group",
        "select_end",
        "finish_admit_group",
        "write_prefix_block",
        "sample_first",
        "admit_fused_paged",
        "admit_many_fused_paged",
        "finish_admit_paged",
        "finish_admit_group_paged",
        "fill_row_chunk",
    }
)

DECODE_PROGRAMS = frozenset(
    {
        "decode",
        "decode_pos",
        "decode_pos_ext",
        "decode_pos_paged",
        "decode_pos_paged_ext",
        "decode_pallas",
        "decode_pallas_ext",
        "decode_pos_pallas",
        "decode_pos_pallas_ext",
        "spec_verify",
        "spec_verify_paged",
        "spec_verify_pallas",
    }
)

SPEC_PROGRAMS = frozenset(
    {"spec_verify", "spec_verify_paged", "spec_verify_pallas"}
)

# Outcome categories for the device-time ledger. "other" absorbs dispatches
# with no request context (CoW copies outside a charged burst).
WASTE_CATEGORIES = (
    "served",
    "shed_after_prefill",
    "cancelled",
    "deadline_abort",
    "spec_rejected",
    "disagg_fallback_reprefill",
    "other",
)

# Program-family suffixes (``_ring`` for the sp ring prefill, ``_moe`` for
# routed experts): classification strips them. The port has neither yet;
# the helpers stay so the names classify as the reference's do.
_FAMILY_SUFFIXES = ("_ring", "_moe")


def program_base(name: str) -> str:
    """Strip family suffixes: ``prefill_full_moe_ring`` -> ``prefill_full``."""
    changed = True
    while changed:
        changed = False
        for sfx in _FAMILY_SUFFIXES:
            if name.endswith(sfx) and name[: -len(sfx)]:
                name = name[: -len(sfx)]
                changed = True
    return name


def program_family(name: str) -> str:
    """Coarse family tag for a recorded program name: ``ring_prefill`` when
    the dispatch ran the sequence-parallel ring, ``moe_routed`` when the
    forward used routed experts, ``dense`` otherwise."""
    if name.endswith("_ring") or "_ring_" in name:
        return "ring_prefill"
    if name.endswith("_moe") or "_moe_" in name:
        return "moe_routed"
    return "dense"


def classify_program(name: str) -> str:
    name = program_base(name)
    if name in PREFILL_PROGRAMS:
        return "prefill"
    if name in DECODE_PROGRAMS:
        return "decode"
    return "other"


def efficiency_enabled() -> bool:
    """EFFICIENCY=0|false|off kills the whole plane (costs + ledger)."""
    return os.environ.get("EFFICIENCY", "1").strip().lower() not in ("0", "false", "off", "no")


# -- peak table ----------------------------------------------------------------
#
# (substring of torch.cuda.get_device_name, peak dense bf16 FLOP/s, peak HBM
# bytes/s), from NVIDIA's H100 data sheet (dense rates, no sparsity).
# Matched case-insensitively, first hit wins, so the PCIe and NVL parts come
# before the SXM part ("NVIDIA H100 80GB HBM3").

_CHIP_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),
)

# CPU fallback so CPU runs still produce nonzero (if not meaningful)
# MFU/MBU: ~0.5 TFLOP/s, 50 GB/s, as the reference's.
_CPU_PEAKS = (5e11, 5e10)


def resolve_chip_peaks(device_kind: str) -> tuple[float, float]:
    """Pure lookup: (peak_flops_per_s, peak_hbm_bytes_per_s) for a device name.

    Env overrides win over the table; unknown names get the CPU fallback.
    ``TPU_PEAK_FLOPS`` is raw FLOP/s; ``TPU_HBM_GBPS`` is GB/s (decimal).
    """
    flops = bw = 0.0
    kind = (device_kind or "").lower()
    for sub, f, b in _CHIP_PEAKS:
        if sub in kind:
            flops, bw = f, b
            break
    else:
        flops, bw = _CPU_PEAKS
    try:
        env_f = os.environ.get("TPU_PEAK_FLOPS")
        if env_f:
            flops = float(env_f)
    except ValueError:
        pass
    try:
        env_b = os.environ.get("TPU_HBM_GBPS")
        if env_b:
            bw = float(env_b) * 1e9
    except ValueError:
        pass
    return (max(flops, 1.0), max(bw, 1.0))


def chip_peaks(device=None) -> tuple[float, float]:
    """Peaks of ``device`` (a ``torch.device``, or None for the CPU); never
    raises. The batcher reads them once, when it is built."""
    kind = ""
    if device is not None and getattr(device, "type", str(device)) == "cuda":
        try:
            import torch

            kind = torch.cuda.get_device_name(device)
        except Exception:  # noqa: BLE001 — peaks are best-effort
            kind = ""
    return resolve_chip_peaks(kind)


# -- analytic program costs ----------------------------------------------------

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


class ForwardCost:
    """(flops, bytes) of the dense Llama-family forward the batcher's
    programs run, from the config and a dispatch's shapes only.

    * flops: ``2 · matmul params · tokens`` (q, k, v, o and the three FFN
      projections), plus attention's ``4 · L · H · D`` per (query token ×
      key it attends, causally, itself included), plus the LM head
      (``2 · d · V``) for each row that produces logits;
    * bytes: the matmul weights read once a forward (the LM head's too when
      any row produces logits), each row's K/V read over the keys it
      attends and written for its new tokens (int8 codes plus an f32 scale
      per token and head under ``kv_quant="int8"``), and the f32 logits
      written.

    ``rows`` rows of ``tokens`` query tokens each; ``ctx`` holds each row's
    context before the dispatch (the position of its first query token);
    ``steps`` single-width steps of a decode burst, each row advancing
    ``tokens`` positions a step. The part that does not depend on ``ctx``
    is cached per (rows, tokens, logit_rows, steps)."""

    def __init__(self, cfg):
        L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
        hq, hkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        isz = _DTYPE_BYTES.get(str(cfg.dtype), 2)
        self.mm_params = L * (2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * ff)
        self.head_params = d * V
        self.isz = isz
        kv_elem = (hd + 4) if cfg.kv_quant == "int8" else hd * isz
        self.kv_token_bytes = L * hkv * 2 * kv_elem  # K and V, every layer
        self.attn_pair_flops = 4 * L * hq * hd
        self.vocab = V
        self._static: dict[tuple, tuple[float, float]] = {}

    def _static_part(self, rows: int, tokens: int, logit_rows: int,
                     steps: int) -> tuple[float, float]:
        key = (rows, tokens, logit_rows, steps)
        hit = self._static.get(key)
        if hit is not None:
            return hit
        q = rows * tokens * steps
        flops = 2.0 * self.mm_params * q + 2.0 * self.head_params * logit_rows * steps
        # causal pairs among a step's own tokens, and the positions earlier
        # steps of the burst added, per row
        own = tokens * (tokens + 1) / 2 * steps + tokens * tokens * steps * (steps - 1) / 2
        flops += self.attn_pair_flops * rows * own
        w = self.mm_params + (self.head_params if logit_rows else 0)
        by = float(w) * self.isz * steps
        # keys read past ctx: the step's own tokens and the burst's earlier ones
        by += self.kv_token_bytes * rows * tokens * steps * (steps + 1) / 2
        by += self.kv_token_bytes * q  # K/V written
        by += 4.0 * self.vocab * logit_rows * steps  # f32 logits written
        self._static[key] = (flops, by)
        return flops, by

    def __call__(self, rows: int, tokens: int, ctx, logit_rows: int,
                 steps: int = 1) -> tuple[float, float]:
        flops, by = self._static_part(rows, tokens, logit_rows, steps)
        ctx_sum = float(sum(ctx))
        flops += self.attn_pair_flops * tokens * ctx_sum * steps
        by += self.kv_token_bytes * ctx_sum * steps
        return flops, by


# -- rolling utilization -------------------------------------------------------


class RollingUtilization:
    """Flops/bytes over a rolling wall-clock window -> achieved rates.

    ``add`` is called from the batcher owner thread per dispatch; ``rates`` /
    ``utilization`` from scrape threads, hence the lock. The denominator is
    wall time spanned by the retained samples (standard MFU definition), not
    summed host dispatch time.
    """

    def __init__(self, window_s: float = 10.0, clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.clock = clock
        self._dq: deque[tuple[float, float, float]] = deque()
        self._lock = threading.Lock()

    def add(self, flops: float, bytes_: float) -> None:
        now = self.clock()
        with self._lock:
            self._dq.append((now, float(flops), float(bytes_)))
            cutoff = now - self.window_s
            while self._dq and self._dq[0][0] < cutoff:
                self._dq.popleft()

    def rates(self) -> tuple[float, float]:
        """(flops_per_s, bytes_per_s) over the window; zeros when idle."""
        now = self.clock()
        with self._lock:
            cutoff = now - self.window_s
            while self._dq and self._dq[0][0] < cutoff:
                self._dq.popleft()
            if not self._dq:
                return (0.0, 0.0)
            span = now - self._dq[0][0]
            if span <= 0.0:
                return (0.0, 0.0)
            fl = sum(s[1] for s in self._dq)
            by = sum(s[2] for s in self._dq)
        return (fl / span, by / span)

    def utilization(self, peaks: tuple[float, float] | None = None) -> tuple[float, float]:
        """(mfu, mbu) in [0, 1] against the peaks (clamped at 1.0)."""
        pf, pb = peaks if peaks is not None else chip_peaks()
        rf, rb = self.rates()
        return (min(rf / max(pf, 1.0), 1.0), min(rb / max(pb, 1.0), 1.0))


# -- HBM ledger ----------------------------------------------------------------


def _default_bytes_in_use(device=None) -> int | None:
    """The caching allocator's allocated bytes on ``device``; None on the
    CPU (and without a card), so the ledger stays inert there."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        if device is not None and getattr(device, "type", "cuda") != "cuda":
            return None
        v = torch.cuda.memory_stats(device).get("allocated_bytes.all.current")
        return int(v) if v is not None else None
    except Exception:  # noqa: BLE001 — the ledger never raises
        return None


class HbmLedger:
    """Reconcile priced device-memory components against the allocator's
    bytes in use.

    ``components`` maps a name to a zero-arg callable returning its current
    priced bytes. ``tick()`` (called per flight-recorder frame) samples the
    allocator, computes ``unexplained = bytes_in_use - sum(priced)``, and fires
    one ``hbm_drift`` event when unexplained bytes grow monotonically above
    ``drift_threshold_bytes`` (vs. the running baseline) for ``sustain_ticks``
    consecutive samples — then re-baselines so a stable-but-larger footprint
    doesn't alarm forever. Where the allocator has no stats (the CPU) every
    sample is zeros and no event can fire.
    """

    def __init__(
        self,
        components: dict[str, Callable[[], int]],
        *,
        bytes_in_use_fn: Callable[[], int | None] | None = None,
        drift_threshold_bytes: int | None = None,
        sustain_ticks: int = 4,
        emit_fn: Callable[..., Any] | None = None,
    ):
        self.components = dict(components)
        self.bytes_in_use_fn = bytes_in_use_fn or _default_bytes_in_use
        if drift_threshold_bytes is None:
            try:
                drift_threshold_bytes = int(
                    os.environ.get("HBM_DRIFT_THRESHOLD_BYTES", str(64 << 20))
                )
            except ValueError:
                drift_threshold_bytes = 64 << 20
        self.drift_threshold_bytes = int(drift_threshold_bytes)
        self.sustain_ticks = max(int(sustain_ticks), 1)
        self.emit_fn = emit_fn
        self.drift_events = 0
        self._baseline: int | None = None
        self._last_unexplained: int | None = None
        self._grow_ticks = 0
        self._last: dict[str, Any] = {}
        self._lock = threading.Lock()

    def last_sample(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._last)

    def tick(self) -> int:
        """Sample + reconcile; returns current drift-above-baseline bytes (>= 0)."""
        priced: dict[str, int] = {}
        for name, fn in self.components.items():
            try:
                priced[name] = int(fn() or 0)
            except Exception:
                priced[name] = 0
        total = sum(priced.values())
        try:
            in_use = self.bytes_in_use_fn()
        except Exception:
            in_use = None
        if in_use is None:
            sample = {
                "bytes_in_use": 0,
                "priced_bytes": total,
                "unexplained_bytes": 0,
                "drift_bytes": 0,
                "components": priced,
            }
            with self._lock:
                self._last = sample
            return 0
        unexplained = int(in_use) - total
        fire = False
        with self._lock:
            if self._baseline is None:
                self._baseline = unexplained
            growth = unexplained - self._baseline
            monotone = self._last_unexplained is None or unexplained >= self._last_unexplained
            if growth > self.drift_threshold_bytes and monotone:
                self._grow_ticks += 1
            elif not monotone:
                self._grow_ticks = 0
            self._last_unexplained = unexplained
            if self._grow_ticks >= self.sustain_ticks:
                fire = True
                self.drift_events += 1
                self._baseline = unexplained
                self._grow_ticks = 0
            drift = max(growth, 0)
            self._last = {
                "bytes_in_use": int(in_use),
                "priced_bytes": total,
                "unexplained_bytes": unexplained,
                "drift_bytes": drift,
                "components": priced,
            }
        if fire and self.emit_fn is not None:
            try:
                self.emit_fn(
                    "hbm_drift",
                    bytes_in_use=int(in_use),
                    priced_bytes=total,
                    unexplained_bytes=unexplained,
                    growth_bytes=growth,
                )
            except Exception:
                pass
        return drift
