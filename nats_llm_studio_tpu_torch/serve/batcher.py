"""Continuous batcher, paged-KV core: concurrent requests share one
fixed-width decode step over one refcounted block pool.

Port of the paged core of ``nats_llm_studio_tpu/serve/batcher.py``
``ContinuousBatcher``: the same surface the engine calls (``submit``,
``submit_batched``, ``start``, ``stop``, ``idle``, ``pool_stats``,
``drop_prefix_cache``), the same program names in ``stats.program_ms`` and
the same admit regimes:

* a prompt of at most one serving chunk prefills fresh (K2) into a
  bucket-length transient row, whose blocks are written into the pool
  (``admit_fused_paged``); a burst of such prompts of one bucket prefills
  as one [m, bucket] batch (``admit_many_fused_paged``);
* a longer prompt into an idle batcher prefills in one fresh dispatch
  (``prefill_full``, K2) and a longer prompt beside live slots prefills in
  serving chunks (``prefill1``, K2 for the first chunk and K3 after),
  with one decode burst between chunks so live streams keep flowing; both
  end in ``finish_admit_paged``. A run of long prompts prefills as [m, C]
  chunks (``prefill_chunk_group``, ``select_end``) and ends in one
  ``finish_admit_group_paged``;
* with ``prefix_cache_blocks`` > 0 the prompt's full serving chunks stay
  in the pool after the admit, held by a radix cache of block ids
  (``serve/prefix_cache.py``). A later prompt that starts with them takes
  the cached blocks into its table by refcount: a full hit samples its
  first token from the stored chunk-end logits (``sample_first``) with no
  prefill; a partial hit copies the cached chunks into its transient row
  (``fill_row_chunk``) and prefills only the suffix. The shared blocks are
  never written: ``finish_admit_paged`` skips them, and a decode write
  into a block that is still shared copies it first (``pool_copy_block``);
* decode runs bursts of single-token ``forward_decode_paged`` steps (K1)
  plus ``sample_rows`` (``decode_pos_pallas``), with each slot's block
  table grown ahead of the burst;
* with ``spec_decode_k`` > 0 and 1..``spec_max_active`` live slots, decode
  verifies prompt-lookup drafts instead (``serve/spec.py``): one
  ``forward_decode_paged`` of width k+1 (K1 with W = k+1 query rows a
  slot) and ``spec_accept_rows`` (``spec_verify_pallas``), emitting up to
  k+1 tokens a slot a dispatch. Rejected drafts' pool rows are stale by
  position and are overwritten by the slot's next writes;
* while a constrained (``response_format``) or logprob request is live,
  every slot decodes one masked step a dispatch (``decode_pos_pallas_ext``):
  the mask of a constrained row comes from its ``TokenDFA`` state
  (``serve/constrain.py``), advanced on the host at readback, and each step
  reads back the chosen token's logprob and the top ``LOGPROBS_K``. Such a
  request's admit drops its first token and steps back one position, so
  token 0 is sampled under the mask too (the rewind).

Under ``cfg.kv_quant == "int8"`` the pool and the transient row caches are
KVQ pairs (int8 codes + f32 scales): rows are quantized as they are
written, later chunks run K4 instead of K3, decode runs K1q, and cached
blocks hold the codes a prefill wrote.

One owner thread drives the device; asyncio callers talk to it through
thread-safe queues. PyTorch runs eagerly, so a burst is a Python loop of
steps (the reference scans them on device); kernel launches queue on the
current stream in program order, and the host reads tokens back one burst
behind.

Overload control, as the reference's: ``max_queue`` bounds the admit queue
at submit (``shed_cause=depth``) and ``max_queue_age_ms`` sheds waiters that
stayed slot-starved too long (``shed_cause=age``). A request's
``deadline`` (monotonic, from the client's ``X-Deadline-Ms``) sheds it at
submit when already past, before prefill when it passes in the queue or the
live rate estimates say it cannot make ``deadline_min_tokens`` tokens in
time, and aborts it at the next readback once it passes mid-decode; all
three are retryable and cause-tagged ``deadline``. ``brownout``
(``serve/brownout.py``) is ticked once per owner-loop pass from host-side
signals only (queue depth and age, and ``hbm_headroom_fn``, which the
registry computes from its admission ledger): from BROWNOUT on it sheds
the lower priority classes at submit, tightens the queue limit, halves the
decode burst, pauses verifies and prefix-cache inserts; SHED_ONLY also
sheds standard traffic and runs single steps. Admission order is deficit
round-robin over tenants (``serve/qos.py``), weighted by priority class;
a single tenant admits in FIFO order. The owner loop stamps ``heartbeat``
once per pass; a crash fails every request retryably, keeps the error's
type and text in ``crashed`` and drops its frames (which hold the pool and
the row caches), so the registry's restart gives the memory back. The
flight recorder samples host-side frames; ``debug_snapshot`` reads the
slot view the loop publishes.

The efficiency plane (``obs/roofline.py``), as the reference's: every
dispatch's flops and bytes come from the analytic ``ForwardCost`` of its
shapes (no timing, no kernel choice), summed per program and into rolling
MFU/MBU windows per class; its host ms is shared over the owner thread's
charge context (the requests the dispatch serves) and resolved, when a
request leaves, into a device-time ledger category (``served``,
``shed_after_prefill``, ``cancelled``, ``deadline_abort``, ``failed``); a
verify's rejected-draft share moves to ``spec_rejected`` at its readback,
and dispatches outside any context go to ``other``. ``EFFICIENCY=0`` turns
it off. The time is the host time of the call, as in the reference: eager
launches return when queued, so a prefill chunk that queues ahead of the
device reads low.

Swap-don't-shed, as the reference's: when the pool runs dry an allocation
first reclaims unpinned prefix-cache chunks, demoting them to the host KV
tier (``serve/kv_tiers.py``, attached as ``kv_tiers``: a byte-budgeted
host LRU with an Object Store spill below it) instead of discarding them;
then suspends a victim slot (``KV_SUSPEND``, on): its blocks are read back
to host memory with its position, rng step, seed, carry token and spec
state, the slot frees, and it resumes later into fresh blocks, decoding
exactly what it would have decoded; only then sheds. A higher-class admit
first preempts strictly lower classes (``QOS_PREEMPT``, on; reason
``preempted``). A decode burst whose table growth finds no block parks
the growing slot (reason ``growth``) when it can ever resume, and sheds
it alone otherwise, with no pool reset. Brownout's SHED_ONLY edge suspends
the youngest streams of the lowest class down to ``suspend_target``; they
resume once the level drops. A long prompt's admit first promotes
host-tier chunks that extend its cached prefix back into the pool, and
between bursts cold cache chunks demote ahead of demand to keep
``demote_free_frac`` of the pool free. A suspended request's deadline
keeps running. The readback and the restore are eager copies outside the
programs, as in the reference: not dispatches of the device-time ledger.

Not ported yet: the legacy contiguous-KV layout.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import queue as _queue
import random
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import AsyncIterator

import numpy as np
import torch

from ..device import torch_dtype
from ..engine.generator import SamplingParams, default_buckets
from ..engine.sampling import logprob_rows, sample_rows, spec_accept_rows
from ..models.config import ModelConfig
from ..models.llama import (
    ensure_lm_head,
    forward,
    forward_decode_paged,
    make_cache,
)
from ..obs import LogHistogram, Trace
from ..obs import emit as obs_emit
from ..obs.roofline import (
    SPEC_PROGRAMS,
    WASTE_CATEGORIES,
    ForwardCost,
    RollingUtilization,
    chip_peaks,
    classify_program,
    efficiency_enabled,
    program_base,
)
from ..ops.kvcache import (
    KVQ,
    is_quantized,
    kv_copy_slice,
    kv_from_host,
    kv_nbytes,
    kv_pool_copy_block,
    kv_pool_read_blocks,
    kv_pool_write_row,
    kv_pool_zeros,
    kv_to_host,
)
from ..parallel.memory import KV_BLOCK_TOKENS, PREFILL_CHUNK, serving_geometry
from ..transport import faults as _faults
from .block_pool import BlockPool
from .brownout import LEVEL_NAMES, SHED_ONLY, BrownoutConfig, BrownoutController
from .prefix_cache import PrefixCache
from .qos import (
    ANON_TENANT,
    DEFAULT_PRIORITY,
    DrrScheduler,
    TenantStats,
    class_rank,
    class_weight,
)
from .spec import SpecConfig, SpecSlot, make_slot

log = logging.getLogger(__name__)

# placeholder for a slot whose admit is in progress: decode steps during a
# chunked admit must neither deliver tokens for it nor hand it to another
# admit
_RESERVED = object()

# how many top-logprob (id, logprob) pairs the ext program reads back a
# step; OpenAI caps top_logprobs requests below this
LOGPROBS_K = 8

# the text of CUDA errors that leave the context unusable: every later call
# in the process fails too, so neither a pool reset nor an engine reload
# can recover (check_launch reports codes 700, 710, 715, 716 and 719 by
# number)
_CONTEXT_LOST = (
    "illegal memory access", "device-side assert", "misaligned address",
    "illegal instruction", "unspecified launch failure",
    "CUDA error 700", "CUDA error 710", "CUDA error 715", "CUDA error 716",
    "CUDA error 719",
)


def cuda_context_lost(err) -> bool:
    """Whether ``err`` (an exception or its text) is a CUDA error after
    which the process's context is unusable."""
    text = str(err)
    return any(m in text for m in _CONTEXT_LOST)


def _drop_frames(err: BaseException) -> None:
    """Release the frames an exception keeps, and those of the exceptions
    chained to it: their locals (the loop's pool, row caches, logits) stay
    allocated for as long as the exception is referenced. Type and text
    stay."""
    stack, seen = [err], set()
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if e.__traceback__ is not None:
            traceback.clear_frames(e.__traceback__)
            e.__traceback__ = None
        stack += [e.__cause__, e.__context__]


class BatcherStopped(RuntimeError):
    """Submit raced a shutdown (the request was never queued), or a drain
    ended the request."""


# what a drained batcher fails its requests with (retryable by its text)
DRAIN_ERROR = "worker draining, retry on another worker"


class BatcherOverloaded(RuntimeError):
    """The request cannot be served here now; retry on another worker."""


class _PoolExhausted(BatcherOverloaded):
    """The block pool ran dry. Raised before any device write, so only the
    one request is shed."""


def _env_on(name: str) -> bool:
    """A switch that is on unless the environment says 0/false/off."""
    return os.environ.get(name, "1").strip().lower() not in ("0", "false", "off")


class _Suspended:
    """A slot parked on the host tier (swap-don't-shed): the host copies of
    its KV blocks and everything a resume needs to decode exactly what it
    would have: position, rng step and seed, the spec-decode n-gram state
    (by reference: its history already holds every delivered token), and
    the request itself (whose ``emitted`` tail re-seeds the carry token).
    Owner thread only."""

    __slots__ = ("req", "k", "v", "n_blocks", "min_blocks", "pos", "steps",
                 "seed", "spec", "t_suspend", "reason")

    def __init__(self, req, k, v, n_blocks, pos, steps, seed, spec, t_suspend, reason,
                 min_blocks=None):
        self.req = req
        self.k = k
        self.v = v
        self.n_blocks = n_blocks
        # resume gate: no re-admit until this many blocks are free. A slot
        # parked by a failed decode growth needs its table plus the growth
        # it could not take: resuming at exactly n_blocks would fail the
        # same growth and park again, starving the slots the parking was
        # meant to unblock
        self.min_blocks = n_blocks if min_blocks is None else min_blocks
        self.pos = pos
        self.steps = steps
        self.seed = seed
        self.spec = spec
        self.t_suspend = t_suspend
        self.reason = reason


@dataclass
class _Request:
    prompt_ids: list[int]
    sp: SamplingParams
    loop: asyncio.AbstractEventLoop
    out: asyncio.Queue  # (kind, value): ("tok", id) | ("end", reason) | ("err", exc)
    slot: int = -1
    pos: int = 0
    generated: int = 0
    t_enq: float = 0.0  # monotonic enqueue time (queue-delay metric)
    t_admit: float = 0.0  # monotonic admit-dispatch time (prefill metric)
    trace: Trace | None = None  # per-request stage marks (obs/trace.py)
    cancelled: bool = False
    # absolute monotonic deadline from the client's budget (None = none);
    # past it the request is shed before prefill or aborted mid-decode
    deadline: float | None = None
    # a deadline abort, as opposed to a consumer-gone cancel
    deadline_hit: bool = False
    # -- the ext regime: a TokenDFA when response_format asks for schema-
    # constrained output, with its current state (advanced on the host at
    # readback; the device sees only the state's vocab mask), and the
    # logprob readback
    constrain: object | None = None
    cstate: int = 0
    want_logprobs: bool = False
    top_logprobs: int = 0
    # the rewind: an ext admit drops its first token, steps back one
    # position and re-runs prompt[-1] through the masked ext program
    rewound: bool = False
    # token ids delivered to the consumer, in order
    emitted: list = field(default_factory=list)
    # -- multi-tenant QoS (serve/qos.py): the X-Tenant / X-Priority
    # identity; raw-NATS callers default to the anonymous standard tenant.
    # ``weight`` overrides the class weight in DRR when set (0 = class)
    tenant: str = ANON_TENANT
    priority: str = DEFAULT_PRIORITY
    weight: float = 0.0
    # -- device-time ledger accrual (obs/roofline.py): dispatch ms charged
    # while this request was in the owner's charge context, resolved into
    # an outcome category when it leaves (_ledger_finalize); dev_spec_ms is
    # the last verify's share, read back to move its rejected drafts
    dev_prefill_ms: float = 0.0
    dev_decode_ms: float = 0.0
    dev_spec_ms: float = 0.0

    @property
    def rank(self) -> int:
        """0 = batch (shed first) .. 2 = premium (shed last)."""
        return class_rank(self.priority)

    @property
    def drr_weight(self) -> float:
        return self.weight if self.weight > 0 else float(class_weight(self.priority))

    @property
    def is_ext(self) -> bool:
        return self.constrain is not None or self.want_logprobs

    def emit(self, kind: str, value) -> None:
        self.loop.call_soon_threadsafe(self.out.put_nowait, (kind, value))


@dataclass
class BatcherStats:
    requests: int = 0
    tokens: int = 0
    steps: int = 0
    peak_active: int = 0
    cancelled: int = 0  # consumer-gone requests whose slot/queue entry was freed
    shed: int = 0  # requests refused or dropped by an overload bound
    # requests admitted through a batched short / batched chunked admit
    grouped_admits: int = 0
    chunked_group_admits: int = 0
    # in-flight requests failed with a retryable error by an owner-thread
    # crash (the registry keeps the total past the batcher at a restart)
    inflight_failed_retryable: int = 0
    # speculative decoding: verify dispatches, draft tokens sent to them and
    # drafts the model's own distribution kept; the per-verify accepted
    # share (0 clamped to the bottom bucket) and its moving average
    spec_verifies: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_accept_rate: LogHistogram = field(
        default_factory=lambda: LogHistogram(lo=0.01, hi=1.0, growth=1.25))
    spec_accept_ewma: float = 0.0
    # bounded log-bucket histograms (obs/histogram.py), recorded on the
    # owner thread and snapshotted by the metrics handlers
    admit_delay_ms: LogHistogram = field(default_factory=LogHistogram)
    ttft_ms: LogHistogram = field(default_factory=LogHistogram)  # enqueue -> first token
    prefill_ms: LogHistogram = field(default_factory=LogHistogram)  # admit -> first token
    decode_step_ms: LogHistogram = field(default_factory=LogHistogram)  # per step, at readback
    tokens_per_step: LogHistogram = field(
        default_factory=lambda: LogHistogram(lo=1.0, hi=4096.0, growth=1.25))
    # "depth" | "age" | "deadline" | "brownout" | "fair_share" | "kv_pool" -> count
    shed_causes: dict = field(default_factory=dict)
    cancel_causes: dict = field(default_factory=dict)  # where the cancel landed
    # per-program host dispatch time (ms) and tokens a dispatch, keyed by
    # the reference's program names, and dispatch counts
    program_ms: dict = field(default_factory=dict)  # name -> LogHistogram
    program_tokens: dict = field(default_factory=dict)  # name -> LogHistogram
    program_calls: dict = field(default_factory=dict)
    # -- compute-efficiency plane (obs/roofline.py) -----------------------
    # cumulative per-program flops / bytes from the analytic count; keys
    # materialize on the first costed dispatch of each program
    program_flops: dict = field(default_factory=dict)  # name -> float
    program_bytes: dict = field(default_factory=dict)  # name -> float
    # device-time ledger: outcome category -> accumulated dispatch ms, and
    # tokens delivered (tokens accrue only under "served")
    device_ms: dict = field(default_factory=dict)
    device_tokens: dict = field(default_factory=dict)
    # exact sum of every dispatch's ms: the ledger's categories must sum to
    # it (within the accrual of requests still in flight)
    dispatch_ms_total: float = 0.0
    # rolling flops/bytes windows per program class -> MFU/MBU gauges,
    # against the peaks of the batcher's device
    util_prefill: RollingUtilization = field(default_factory=RollingUtilization)
    util_decode: RollingUtilization = field(default_factory=RollingUtilization)
    peaks: tuple | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record_program(self, name: str, ms: float) -> None:
        self.dispatch_ms_total += ms  # owner-thread single writer
        h = self.program_ms.get(name)
        if h is None:
            with self._lock:
                h = self.program_ms.setdefault(name, LogHistogram())
        h.record(ms)
        self.program_calls[name] = self.program_calls.get(name, 0) + 1

    def record_tokens(self, name: str, tokens: float) -> None:
        """Tokens one dispatch of ``name`` moved."""
        if tokens <= 0:
            return
        ht = self.program_tokens.get(name)
        if ht is None:
            with self._lock:
                ht = self.program_tokens.setdefault(
                    name, LogHistogram(lo=1.0, hi=1e6, growth=1.25))
        ht.record(float(tokens))

    def program_histograms(self) -> dict[str, LogHistogram]:
        with self._lock:
            return dict(self.program_ms)

    def program_token_histograms(self) -> dict[str, LogHistogram]:
        with self._lock:
            return dict(self.program_tokens)

    def record_dispatch_cost(self, name: str, cost: tuple | None) -> None:
        """Fold one dispatch's (flops, bytes) into the per-program totals and
        the rolling roofline windows. ``cost`` is None for a program the
        analytic count does not cover (no forward in it): not costed."""
        if not cost:
            return
        fl, by = cost
        with self._lock:
            self.program_flops[name] = self.program_flops.get(name, 0.0) + fl
            self.program_bytes[name] = self.program_bytes.get(name, 0.0) + by
        cls = classify_program(name)
        if cls == "prefill":
            self.util_prefill.add(fl, by)
        elif cls == "decode":
            self.util_decode.add(fl, by)

    def attribute_device_time(self, category: str, ms: float, tokens: int = 0) -> None:
        """Ledger entry: ``ms`` of dispatch time resolved to an outcome
        ``category`` (roofline.WASTE_CATEGORIES, plus "failed" for crash
        paths). Tokens count only toward goodput ("served")."""
        with self._lock:
            self.device_ms[category] = self.device_ms.get(category, 0.0) + ms
            if tokens:
                self.device_tokens[category] = self.device_tokens.get(category, 0) + tokens

    def device_time_snapshot(self) -> dict:
        """{"ms": {category: ms}, "tokens": {category: n}}: the standard
        categories are always present (zero-filled), so the exposition and
        the cluster rollup see stable families."""
        with self._lock:
            ms = {c: 0.0 for c in WASTE_CATEGORIES}
            ms.update(self.device_ms)
            tok = {c: 0 for c in WASTE_CATEGORIES}
            tok.update(self.device_tokens)
        return {"ms": ms, "tokens": tok}

    def goodput_tokens_per_device_s(self) -> float:
        """Served tokens per second of all attributed dispatch time: waste
        in any category drags it below the raw decode rate."""
        with self._lock:
            total_ms = sum(self.device_ms.values())
            served = self.device_tokens.get("served", 0)
        return served / (total_ms / 1e3) if total_ms > 0 else 0.0

    def cost_counters(self) -> tuple[dict, dict]:
        """(program_flops, program_bytes) copies for the exposition."""
        with self._lock:
            return dict(self.program_flops), dict(self.program_bytes)

    def utilization(self, peaks: tuple | None = None) -> dict:
        """Rolling MFU/MBU per program class against the device's peaks."""
        peaks = peaks or self.peaks or chip_peaks()
        pf_mfu, pf_mbu = self.util_prefill.utilization(peaks)
        dc_mfu, dc_mbu = self.util_decode.utilization(peaks)
        return {"prefill": {"mfu": pf_mfu, "mbu": pf_mbu},
                "decode": {"mfu": dc_mfu, "mbu": dc_mbu}}

    def record_admit_delay(self, ms: float) -> None:
        """Queue delay (enqueue -> admit dispatch), ms."""
        self.admit_delay_ms.record(ms)

    def record_shed(self, cause: str = "depth", waited_ms: float | None = None) -> None:
        """Sheds happen on two threads (submit-side bounds on the caller's
        event loop, the age and deadline sweeps on the owner thread), so
        the counts move under the lock."""
        with self._lock:
            self.shed += 1
            self.shed_causes[cause] = self.shed_causes.get(cause, 0) + 1
        ev = {"cause": cause}
        if waited_ms is not None:
            ev["waited_ms"] = round(waited_ms, 1)
        obs_emit("shed", **ev)

    def record_cancel(self, where: str = "active") -> None:
        """A consumer-gone (or deadline-aborted) request reclaimed, tagged
        with where the cancel landed."""
        self.cancelled += 1
        self.cancel_causes[where] = self.cancel_causes.get(where, 0) + 1
        obs_emit("cancel", where=where)

    def shed_cause_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self.shed_causes)

    def histograms(self) -> dict[str, LogHistogram]:
        """Name -> histogram, for the Prometheus exposition."""
        return {
            "admit_queue_delay_ms": self.admit_delay_ms,
            "ttft_ms": self.ttft_ms,
            "prefill_ms": self.prefill_ms,
            "decode_step_ms": self.decode_step_ms,
            "tokens_per_step": self.tokens_per_step,
            "spec_accept_rate": self.spec_accept_rate,
        }

    def spec_counters(self) -> dict[str, int]:
        """Speculative-decoding counters (the ``lmstudio_spec_*_total``
        families)."""
        return {
            "verifies": self.spec_verifies,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
        }

    def counters(self) -> dict[str, int]:
        """Monotonic counters, for the Prometheus exposition (the
        reference's, less the legacy ring's ``ring_compactions`` and XLA's
        ``decode_recompiles``)."""
        return {
            "requests": self.requests,
            "tokens": self.tokens,
            "decode_steps": self.steps,
            "grouped_admits": self.grouped_admits,
            "chunked_group_admits": self.chunked_group_admits,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "inflight_failed_retryable": self.inflight_failed_retryable,
        }

    def record_spec(self, drafted: int, accepted: int) -> None:
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        rate = accepted / drafted
        self.spec_accept_rate.record(max(rate, 0.01))
        prev = self.spec_accept_ewma
        self.spec_accept_ewma = rate if prev == 0.0 else 0.8 * prev + 0.2 * rate

    def snapshot(self) -> dict:
        adm = self.admit_delay_ms.snapshot()
        ttft = self.ttft_ms.snapshot()
        pre = self.prefill_ms.snapshot()
        dec = self.decode_step_ms.snapshot()
        with self._lock:
            shed_causes = dict(self.shed_causes)
            programs = dict(self.program_ms)
        return {
            "requests": self.requests,
            "tokens": self.tokens,
            "decode_steps": self.steps,
            "peak_active_slots": self.peak_active,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "shed_causes": shed_causes,
            "inflight_failed_retryable": self.inflight_failed_retryable,
            "grouped_admits": self.grouped_admits,
            "chunked_group_admits": self.chunked_group_admits,
            "spec_verifies": self.spec_verifies,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_ewma": round(self.spec_accept_ewma, 3),
            "tokens_per_step_avg": round(self.tokens / self.steps, 2) if self.steps else 0.0,
            "admit_queue_delay_p50_ms": round(adm.percentile(0.5), 1),
            "admit_queue_delay_p95_ms": round(adm.percentile(0.95), 1),
            "admit_queue_delay_max_ms": round(adm.vmax or 0.0, 1),
            "ttft_p50_ms": round(ttft.percentile(0.5), 1),
            "ttft_p95_ms": round(ttft.percentile(0.95), 1),
            "prefill_p50_ms": round(pre.percentile(0.5), 1),
            "prefill_p95_ms": round(pre.percentile(0.95), 1),
            "decode_step_p50_ms": round(dec.percentile(0.5), 1),
            "decode_step_p95_ms": round(dec.percentile(0.95), 1),
            "program_calls": dict(self.program_calls),
            "program_ms": {k: round(h.snapshot().total, 3) for k, h in programs.items()},
            "goodput_tokens_per_device_s": round(self.goodput_tokens_per_device_s(), 2),
            "device_ms": {
                k: round(v, 1) for k, v in self.device_time_snapshot()["ms"].items()
            },
        }


def _row(cache, i: int):
    """Row i of a batched row cache as a [1, ...] view (per leaf on KVQ)."""
    if is_quantized(cache):
        return KVQ(cache.q[i:i + 1], cache.s[i:i + 1])
    return cache[i:i + 1]


class ContinuousBatcher:
    """Owns the device loop for one loaded model.

    The constructor takes the reference's names and defaults:
    ``prefill_chunk`` (256, halved until it divides max_seq; the class
    attribute ``PREFILL_CHUNK`` when not given), ``decode_burst`` (8),
    ``admit_coalesce_ms`` (3.0: how long an idle batcher waits after a first
    arrival for more, so a burst admits as one batch), ``max_group_admit``
    (8 short prompts a batched admit), ``max_group_long`` (4 long prompts a
    batched chunked admit), ``prefix_cache_blocks`` (0 = no prefix cache;
    the registry passes 64), ``kv_pool_blocks`` (0 = every slot at
    max_seq plus the prefix budget), ``spec_decode_k`` (0 = no speculative
    decoding; the registry passes 6) and ``spec_max_active`` (4: verify
    dispatches run at 1..4 live slots); the overload knobs ``max_queue`` (0
    = no depth bound), ``max_queue_age_ms`` (0 = no age bound),
    ``brownout`` (a ``BrownoutConfig``, None = off), ``hbm_headroom_fn``
    (the free fraction of the device-memory budget, or None), and
    ``deadline_min_tokens`` (1); ``recorder`` (a ``FlightRecorder``, None =
    off) and ``qos_quantum_tokens`` (256: the DRR quantum in prompt tokens);
    ``kv_block_tokens`` (16, halved until it divides the serving chunk);
    ``kv_tiers`` (a ``KVTierManager``, None = no host tier; it may also be
    attached as ``kv_tiers`` before the first submit); ``kv_suspend`` and
    ``qos_preempt`` (None reads ``KV_SUSPEND`` / ``QOS_PREEMPT``, both on;
    preemption rides suspend)."""

    # the reference's serving defaults: 256-token prefill chunks, decode
    # bursts of 8 steps, 16-token KV blocks
    PREFILL_CHUNK = PREFILL_CHUNK
    DECODE_BURST = 8
    KV_BLOCK_TOKENS = KV_BLOCK_TOKENS

    def __init__(self, params, cfg: ModelConfig, max_slots: int = 8,
                 max_seq_len: int | None = None, prefill_chunk: int | None = None,
                 decode_burst: int | None = None, admit_coalesce_ms: float = 3.0,
                 max_group_admit: int = 8, max_group_long: int = 4,
                 prefix_cache_blocks: int = 0, kv_pool_blocks: int = 0,
                 spec_decode_k: int = 0, spec_max_active: int = 4,
                 max_queue: int = 0, max_queue_age_ms: float = 0.0,
                 brownout: BrownoutConfig | None = None, hbm_headroom_fn=None,
                 deadline_min_tokens: int = 1, recorder=None,
                 qos_quantum_tokens: int = 256, kv_block_tokens: int | None = None,
                 kv_tiers=None, kv_suspend: bool | None = None,
                 qos_preempt: bool | None = None):
        self.params = ensure_lm_head(params)
        self.cfg = cfg
        self.device = self.params["embed"].device
        self.max_slots = max_slots
        self.max_seq = min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len)
        self.buckets = default_buckets(self.max_seq)
        # the serving chunk divides max_seq, so the zero-padded last chunk
        # never writes past the row cache; the block size divides the chunk,
        # so a cached chunk is whole blocks
        chunk = max(8, prefill_chunk if prefill_chunk is not None else self.PREFILL_CHUNK)
        self.prefill_chunk, T = serving_geometry(
            self.max_seq, chunk,
            max(1, kv_block_tokens if kv_block_tokens is not None else self.KV_BLOCK_TOKENS))
        if self.max_seq % self.prefill_chunk:
            raise ValueError(
                f"max_seq_len={self.max_seq} must be divisible by a prefill "
                f"chunk >= 8; use a power-of-two max_seq_len"
            )
        self.decode_burst = max(1, decode_burst if decode_burst is not None
                                else self.DECODE_BURST)
        self.admit_coalesce_ms = max(0.0, admit_coalesce_ms)
        self.max_group_admit = max(1, max_group_admit)
        self.max_group_long = max(1, max_group_long)
        # overload bounds (0 = off): depth sheds at submit, age at admit
        self.max_queue = max(0, max_queue)
        self.max_queue_age_ms = max(0.0, max_queue_age_ms)
        self.kv_block_tokens = T
        self.blocks_per_row = self.max_seq // T
        # every slot at max_seq plus the prefix budget, +1 for the null
        # block 0 (parallel/memory.py estimate_load_bytes prices this pool)
        usable = (kv_pool_blocks if kv_pool_blocks > 0
                  else max_slots * self.blocks_per_row + max(0, prefix_cache_blocks))
        self._pool = BlockPool(usable + 1, T)
        # the pool pair [NB, L, Hkv, T, D], written in place by every program
        self._kv = self._new_kv_pool()
        self.stats = BatcherStats(peaks=chip_peaks(self.device))
        # the efficiency plane: analytic dispatch costs and the device-time
        # ledger, whose charge context (the requests the current dispatch
        # serves) only the owner thread sets
        self._efficiency = efficiency_enabled()
        self._forward_cost = ForwardCost(cfg)
        self._charge_ctx: tuple | None = None
        # the next dispatch's shapes for its analytic cost (see _timed)
        self._shape: tuple | None = None
        self.spec_cfg: SpecConfig | None = (
            SpecConfig(k=spec_decode_k, max_active=max(1, spec_max_active))
            if spec_decode_k > 0 else None)
        # the prefix cache's nodes hold (pool epoch, block ids) payloads: a
        # harvest is an incref, an eviction a decref, and payloads minted
        # before a pool reset free as no-ops
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache_blocks > 0:
            pool = self._pool

            def _pc_acquire(payload):
                ep, ids = payload
                if ep == pool.epoch:
                    pool.incref(ids)

            def _pc_release(payload):
                ep, ids = payload
                pool.decref(ids, epoch=ep)

            self.prefix_cache = PrefixCache(
                self.prefill_chunk, prefix_cache_blocks,
                node_blocks=self.prefill_chunk // T,
                acquire_fn=_pc_acquire, free_fn=_pc_release,
            )

        # adaptive brownout, ticked by the owner loop (None = off); the
        # headroom probe is the registry's admission ledger, host state only
        self.brownout: BrownoutController | None = (
            BrownoutController(brownout) if brownout is not None else None)
        self.hbm_headroom_fn = hbm_headroom_fn
        # deadline feasibility floor: a waiter that cannot make this many
        # tokens before its deadline (by the live rate EWMAs) is shed
        # before prefill instead of being aborted mid-stream
        self.deadline_min_tokens = max(1, deadline_min_tokens)
        self._prefill_rate_ewma = 0.0  # prompt tokens/s, at first token
        self._decode_spt_ewma = 0.0  # seconds a decode step, at readback
        self.recorder = recorder
        # the host KV tier under the prefix cache (its demotion source and
        # promotion target, so only meaningful with one); the owner loop
        # reads it when it starts
        self.kv_tiers = kv_tiers
        # slot suspend (swap-don't-shed) and QoS preemption, which rides it
        self.kv_suspend = bool(_env_on("KV_SUSPEND") if kv_suspend is None else kv_suspend)
        self.qos_preempt = self.kv_suspend and bool(
            _env_on("QOS_PREEMPT") if qos_preempt is None else qos_preempt)
        # suspended-slot records (the owner thread mutates; len() is read
        # from any thread) and lifetime suspend counters
        self._suspended: list[_Suspended] = []
        self._suspend_stats = {
            "suspended_total": 0,
            "resumed_total": 0,
            "suspend_failures": 0,
            "suspended_deadline_expired": 0,
        }
        self._drr = DrrScheduler(quantum=max(1, int(qos_quantum_tokens)))
        self.tenant_stats = TenantStats()
        # the live slots' positions and tables for debug_snapshot(),
        # replaced wholesale by the owner loop (a GIL-atomic swap)
        self._slot_view: dict[int, dict] = {}

        self._admit_fused_paged = self._timed("admit_fused_paged", self._admit_fused_paged_fn)
        self._admit_many_fused_paged = self._timed("admit_many_fused_paged",
                                                   self._admit_many_fused_paged_fn)
        self._prefill_full = self._timed("prefill_full", self._prefill_full_fn)
        self._prefill1 = self._timed("prefill1", self._prefill1_fn)
        self._prefill_chunk_group = self._timed("prefill_chunk_group",
                                                self._prefill_chunk_group_fn)
        self._select_end = self._timed("select_end", self._select_end_fn)
        self._finish_admit_paged = self._timed("finish_admit_paged", self._finish_admit_paged_fn)
        self._finish_admit_group_paged = self._timed("finish_admit_group_paged",
                                                     self._finish_admit_group_paged_fn)
        self._sample_first = self._timed("sample_first", self._sample_first_fn)
        self._fill_row_chunk = self._timed("fill_row_chunk", self._fill_row_chunk_fn)
        self._pool_copy_block = self._timed("pool_copy_block", self._pool_copy_block_fn)
        self._decode_pos_pallas = self._timed("decode_pos_pallas", self._decode_pos_pallas_fn)
        self._decode_pos_pallas_ext = self._timed("decode_pos_pallas_ext",
                                                  self._decode_pos_pallas_ext_fn)
        self._spec_verify_pallas = self._timed("spec_verify_pallas",
                                               self._spec_verify_pallas_fn)

        self._inbox: _queue.Queue = _queue.Queue()
        self._cancels: _queue.Queue = _queue.Queue()
        self._slots: list = [None] * max_slots
        self._submit_lock = threading.Lock()
        self._stopping = False
        self._started = False
        self._thread: threading.Thread | None = None
        self._wl_len = 0
        self._waitlist: list[_Request] = []
        # supervision surface: the owner loop stamps ``heartbeat`` once per
        # pass; ``crashed`` holds the exception that ended it (type and
        # text, its frames dropped)
        self.heartbeat = time.monotonic()
        self.crashed: BaseException | None = None
        # what stop() ends requests with: None = "shutdown"
        self._stop_error: str | None = None

    # -- programs ----------------------------------------------------------

    def _sample_token0(self, logits, seeds, samps):
        """Token 0 of m admits from their prompt-end logits [m, 1, V]: rng
        step 0 of each row's seed."""
        temps, topks, topps = samps
        return sample_rows(logits[:, 0], seeds, [0] * len(seeds), temps, topks, topps)

    def _sample_first_fn(self, logits, seed, samp):
        """Full-prefix-hit admit: no prefill and no KV copy (the slot's
        table already references the cached blocks); token 0 from the
        stored prompt-end logits."""
        temp, topk, topp = samp
        return self._sample_token0(logits, [seed], ([temp], [topk], [topp]))

    def _admit_fused_paged_fn(self, KP, VP, tokens, n, bids, seed, samp):
        """Short-prompt admit: prefill a bucket-length transient row (K2),
        write its blocks into the pool at ``bids`` (null-padded), sample
        token 0."""
        k1, v1 = make_cache(self.cfg, 1, tokens.shape[1], device=self.device)
        logits, k1, v1 = forward(
            self.params, self.cfg, tokens, k1, v1,
            start_pos=torch.zeros((1,), dtype=torch.int32),
            logit_positions=torch.tensor([n - 1]), fresh_prefill=True,
        )
        kv_pool_write_row(KP, k1, bids)
        kv_pool_write_row(VP, v1, bids)
        return self._sample_first_fn(logits, seed, samp)

    def _admit_many_fused_paged_fn(self, KP, VP, tokens, ns, bid_rows, seeds, samps):
        """Batched short admit: one [m, bucket] fresh prefill (K2), then
        each row's blocks into its own table entries. Pad rows repeat row 0
        with all-null bids, so they write nothing the pool keeps."""
        m, bucket = tokens.shape
        km, vm = make_cache(self.cfg, m, bucket, device=self.device)
        logits, km, vm = forward(
            self.params, self.cfg, tokens, km, vm,
            start_pos=torch.zeros((m,), dtype=torch.int32),
            logit_positions=torch.tensor([n - 1 for n in ns]), fresh_prefill=True,
        )
        for i in range(m):
            kv_pool_write_row(KP, _row(km, i), bid_rows[i])
            kv_pool_write_row(VP, _row(vm, i), bid_rows[i])
        return self._sample_token0(logits, seeds, samps)

    def _prefill_full_fn(self, tokens, k1, v1, n):
        """A whole long prompt in one fresh dispatch (idle batcher)."""
        logits, k1, v1 = forward(
            self.params, self.cfg, tokens, k1, v1,
            start_pos=torch.zeros((1,), dtype=torch.int32),
            logit_positions=torch.tensor([n - 1]), fresh_prefill=True,
        )
        return logits

    def _prefill1_fn(self, tokens, k1, v1, start, last_pos, window):
        """One [1, C] chunk at ``start``: K2 when start is 0, K3 over the
        cache window after."""
        logits, k1, v1 = forward(
            self.params, self.cfg, tokens, k1, v1,
            start_pos=torch.tensor([start], dtype=torch.int32),
            logit_positions=torch.tensor([last_pos]), uniform_start=True,
            attn_window=window,
        )
        return logits

    def _prefill_chunk_group_fn(self, tokens, km, vm, start, last_pos, window):
        """One [m, C] chunk of a batched chunked admit, every row at
        ``start`` (K2 at 0, K3/K4 over the rows' cache window after); the
        logits row of each prompt at ``last_pos``."""
        m = tokens.shape[0]
        logits, km, vm = forward(
            self.params, self.cfg, tokens, km, vm,
            start_pos=torch.full((m,), start, dtype=torch.int32),
            logit_positions=torch.tensor(last_pos), uniform_start=True,
            attn_window=window,
        )
        return logits

    def _select_end_fn(self, final, logits, is_end):
        """Keep each row's logits from the chunk its prompt ends in."""
        return torch.where(is_end[:, None, None], logits, final)

    def _finish_admit_paged_fn(self, KP, VP, k1, v1, logits, bids, seed, samp):
        """Long-prompt tail: write the row's blocks into the pool (null
        entries — shared prefix blocks and the junk tail — skipped) and
        sample token 0."""
        kv_pool_write_row(KP, k1, bids)
        kv_pool_write_row(VP, v1, bids)
        return self._sample_first_fn(logits, seed, samp)

    def _finish_admit_group_paged_fn(self, KP, VP, km, vm, final, bid_rows, seeds, samps):
        """Batched chunked tail: each row's blocks into its table entries
        (pad rows carry all-null bids) and token 0 of every row."""
        for i in range(final.shape[0]):
            kv_pool_write_row(KP, _row(km, i), bid_rows[i])
            kv_pool_write_row(VP, _row(vm, i), bid_rows[i])
        return self._sample_token0(final, seeds, samps)

    def _fill_row_chunk_fn(self, k1, v1, KP, VP, bids, start):
        """Copy one cached chunk's pool blocks ``bids`` into the transient
        row at ``start`` (partial-prefix-hit admit), where a chunked
        prefill would have written them; the pool is only read. Queued on
        the stream before the suffix chunks that read the row."""
        idx = (0, 0, 0, start, 0)
        kv_copy_slice(k1, kv_pool_read_blocks(KP, bids), idx)
        kv_copy_slice(v1, kv_pool_read_blocks(VP, bids), idx)

    def _pool_copy_block_fn(self, KP, VP, dst, src):
        """Copy-on-write: duplicate one shared block before a write."""
        kv_pool_copy_block(KP, dst, src)
        kv_pool_copy_block(VP, dst, src)

    def _decode_pos_pallas_fn(self, tok, KP, VP, tbl, pos, seeds, steps, temp, topk,
                              topp, n):
        """Decode burst: n single-token paged forwards (K1), each sampled;
        the next token stays on the device. Returns (tokens [B, n], tok)."""
        out = []
        for i in range(n):
            logits, KP, VP = forward_decode_paged(
                self.params, self.cfg, tok[:, None], KP, VP, tbl, pos + i,
            )
            tok = sample_rows(logits[:, -1, :], seeds, [s + i for s in steps],
                              temp, topk, topp)
            out.append(tok)
        return torch.stack(out, dim=1), tok

    def _decode_pos_pallas_ext_fn(self, tok, KP, VP, tbl, pos, seeds, steps, temp, topk,
                                  topp, mask):
        """One masked single-token step (K1) with the logprob readback.
        Returns (tokens [B], chosen logprobs [B], top ids [B, LOGPROBS_K],
        top logprobs [B, LOGPROBS_K]); the tokens are the next carry."""
        logits, KP, VP = forward_decode_paged(
            self.params, self.cfg, tok[:, None], KP, VP, tbl, pos,
        )
        raw = logits[:, -1, :]
        nxt = sample_rows(raw, seeds, steps, temp, topk, topp, mask=mask)
        lp, top_ids, top_lp = logprob_rows(raw, nxt, LOGPROBS_K)
        return nxt, lp, top_ids, top_lp

    def _spec_verify_pallas_fn(self, tok, KP, VP, tbl, pos, drafts, dlen, seeds, steps,
                               temp, topk, topp):
        """Verify: the carry token and the k drafts as one width-(k+1)
        paged forward (K1 with W = k+1 query rows a slot), then the
        acceptance rule (``dlen``: each row's valid drafts, a host list like
        the seeds, steps and sampling settings). Returns (tokens [B, k+1],
        n_emit [B], the next carry [B]); row b's next position is
        pos + n_emit."""
        toks_in = torch.cat([tok[:, None], drafts], dim=1)
        logits, KP, VP = forward_decode_paged(
            self.params, self.cfg, toks_in, KP, VP, tbl, pos,
        )
        out, n_emit = spec_accept_rows(logits, drafts, dlen, seeds, steps, temp, topk, topp)
        new_tok = torch.gather(out, 1, (n_emit.long() - 1)[:, None])[:, 0]
        return out, n_emit, new_tok

    def _timed(self, name: str, fn):
        """Record every dispatch's host time under the program ``name``
        (the call sites record the tokens it moved, ``record_tokens``).

        With the efficiency plane on, a forward-bearing call site stages its
        shapes in ``self._shape`` just before the call, as ``(rows, tokens,
        ctx, logit_rows[, steps])``, which ``ForwardCost`` turns into
        (flops, bytes) for the roofline counters; the call's arguments stay
        the program's own, so a wrapper around a program sees them as they
        were. The dispatch's ms is shared over the owner thread's charge
        context (prefill programs into ``dev_prefill_ms``, the others into
        ``dev_decode_ms``, a verify's share also into ``dev_spec_ms``), or
        booked to ``other`` when the context is empty. The time is the host
        time of the call: no sync, no event."""
        stats = self.stats
        count = self._forward_cost
        is_prefill = classify_program(name) == "prefill"
        is_spec = program_base(name) in SPEC_PROGRAMS

        def run(*args, **kwargs):
            shape, self._shape = self._shape, None
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            ms = (time.monotonic() - t0) * 1e3
            stats.record_program(name, ms)
            if self._efficiency:
                stats.record_dispatch_cost(name, count(*shape) if shape else None)
                ctx = self._charge_ctx
                if ctx:
                    share = ms / len(ctx)
                    for r in ctx:
                        if is_prefill:
                            r.dev_prefill_ms += share
                        else:
                            r.dev_decode_ms += share
                            if is_spec:
                                r.dev_spec_ms = share
                else:
                    stats.attribute_device_time("other", ms)
            return out

        run.__name__ = f"timed_{name}"
        return run

    def _ledger_finalize(self, req, category: str) -> None:
        """Resolve a request's accrued dispatch time into an outcome
        ``category`` (roofline.WASTE_CATEGORIES, or "failed" for crash
        paths); a served request's tokens count toward goodput."""
        if not self._efficiency:
            return
        pre, dec = req.dev_prefill_ms, req.dev_decode_ms
        if pre <= 0.0 and dec <= 0.0:
            return
        req.dev_prefill_ms = req.dev_decode_ms = req.dev_spec_ms = 0.0
        if category == "served":
            self.stats.attribute_device_time("served", pre + dec, req.generated)
        else:
            self.stats.attribute_device_time(category, pre + dec)

    def _charged(self, reqs) -> tuple | None:
        """Make ``reqs`` the charge context; returns the previous one, for
        the caller to put back (decode bursts run inside chunked admits)."""
        prev = self._charge_ctx
        self._charge_ctx = tuple(reqs)
        return prev

    # -- block ownership (owner thread) --------------------------------------

    def _try_alloc(self, k: int) -> list[int] | None:
        """Take k fresh pool blocks; on shortage, reclaim unpinned
        prefix-cache blocks (the evictable tier: demoted to the host tier
        when the owner loop has wired one, discarded otherwise) first. None
        when that is not enough."""
        pool, pc = self._pool, self.prefix_cache
        got = pool.alloc(k)
        if got is None and pc is not None:
            pc.reclaim(k - pool.free_blocks, demote=True)
            got = pool.alloc(k)
        return got

    def _exhausted(self, k: int) -> _PoolExhausted:
        return _PoolExhausted(
            f"kv block pool exhausted ({k} blocks needed, "
            f"{self._pool.free_blocks} free) (shed_cause=kv_pool); "
            f"retry on another worker"
        )

    def _alloc_blocks(self, k: int) -> list[int]:
        """A decode write's growth: ``_try_alloc`` or _PoolExhausted, raised
        before any device write and counted by the caller, which may park
        the slot instead of shedding it."""
        got = self._try_alloc(k)
        if got is None:
            raise self._exhausted(k)
        return got

    def _ensure_private(self, tbl: list[int], lo: int, hi: int) -> int:
        """Copy-on-write: every block of ``tbl`` that a write to positions
        [lo, hi) would touch and that is still shared (refcount > 1) is
        copied into a fresh block, which replaces it in ``tbl``. Returns
        the number of copies. Chunk-aligned sharing means decode writes
        start past every shared block, so this almost never copies; it
        keeps correctness independent of that layout argument."""
        if not tbl or hi <= lo:
            return 0
        pool, T = self._pool, self.kv_block_tokens
        KP, VP = self._kv
        copies = 0
        for b in range(lo // T, min((min(hi, self.max_seq) - 1) // T, len(tbl) - 1) + 1):
            bid = tbl[b]
            if bid != 0 and pool.refcount(bid) > 1:
                nid = self._alloc_blocks(1)[0]
                self._pool_copy_block(KP, VP, nid, bid)
                pool.decref([bid])
                pool.cow_copies += 1
                tbl[b] = nid
                copies += 1
        return copies

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._started or self._stopping:
            return
        self._started = True
        self._thread = threading.Thread(target=self._run_guarded, name="batcher",
                                        daemon=True)
        self._thread.start()

    def _run_guarded(self) -> None:
        """Owner-thread entry: an escape from the loop fails every request
        retryably and leaves the crash for the supervisor. The exception's
        frames hold the loop's locals (the pool, row caches, logits): they
        are logged as text and dropped, so a restart can free the memory."""
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — watchdogs need everything
            log.error("batcher pump loop crashed\n%s", "".join(traceback.format_exception(e)))
            _drop_frames(e)
            self.crashed = e
            error = f"{type(e).__name__}: {e}"
            n = self._fail_inflight_retryable(e)
            obs_emit("engine_crash", error=error, inflight_failed=n)
            if self.recorder is not None:
                self.recorder.dump("engine_crash", extra={"error": error, "inflight_failed": n})
        finally:
            if self.prefix_cache is not None:
                # the demotion hook closes over the loop's pool: unwired, so
                # a stopped or crashed batcher holds no device memory
                self.prefix_cache.demote_fn = None

    def _fail_inflight_retryable(self, cause: BaseException) -> int:
        """Fail every in-flight and queued request with a BatcherStopped
        that carries the retryable marker. Returns the count."""
        with self._submit_lock:
            self._stopping = True  # no new submits past this point
        err = BatcherStopped(
            f"engine crashed ({type(cause).__name__}: {cause}); "
            f"retry on another worker"
        )
        n = 0

        def fail(req: _Request) -> None:
            # count BEFORE emit: the consumer may read the counter at once
            nonlocal n
            n += 1
            self.stats.inflight_failed_retryable += 1
            self._ledger_finalize(req, "failed")
            req.emit("err", err)

        for req in self._waitlist:
            fail(req)
        self._waitlist.clear()
        self._wl_len = 0
        for i, req in enumerate(self._slots):
            if isinstance(req, _Request):
                fail(req)
            self._slots[i] = None
        for rec in self._suspended:
            fail(rec.req)  # parked streams are live requests too
        self._suspended = []
        self._slot_view = {}
        while True:
            try:
                req = self._inbox.get_nowait()
            except _queue.Empty:
                break
            if req is not None:
                fail(req)
        return n

    @property
    def brownout_level(self) -> int:
        """0 normal / 1 brownout / 2 shed-only; 0 when the controller is off."""
        return self.brownout.level if self.brownout is not None else 0

    @property
    def queue_depth(self) -> int:
        """Waitlist + unread inbox (two GIL-atomic reads; any thread)."""
        return self._wl_len + self._inbox.qsize()

    def _headroom(self) -> float | None:
        if self.hbm_headroom_fn is None:
            return None
        try:
            return self.hbm_headroom_fn()
        except Exception:  # noqa: BLE001 — the probe is best-effort
            return None

    def _recorder_frame(self, depth: int, n_active: int) -> dict:
        """One flight-recorder frame (owner thread): host-side state only,
        so sampling adds no device sync to the loop."""
        st = self.stats
        fr = {
            "queue_depth": depth,
            "active_slots": n_active,
            "brownout_level": self.brownout_level,
            "decode_spt_ewma_ms": round(self._decode_spt_ewma * 1e3, 3),
            "spec_accept_ewma": round(st.spec_accept_ewma, 3),
            "requests": st.requests,
            "tokens": st.tokens,
            "shed": st.shed,
            "cancelled": st.cancelled,
            "inflight_failed_retryable": st.inflight_failed_retryable,
        }
        hr = self._headroom()
        if hr is not None:
            fr["hbm_headroom_frac"] = round(hr, 4)
        ps = self._pool.stats()
        fr["pool_blocks_free"] = ps["blocks_free"]
        fr["pool_blocks_live"] = ps["blocks_live"]
        fr["pool_blocks_shared"] = ps["blocks_shared"]
        if self._suspended or self._suspend_stats["suspended_total"]:
            fr["suspended_slots"] = len(self._suspended)
            fr["suspended_total"] = self._suspend_stats["suspended_total"]
        if self.kv_tiers is not None:
            ts = self.kv_tiers.stats()
            fr["tier_host_bytes"] = ts["host_bytes"]
            fr["tier_host_entries"] = ts["host_entries"]
            fr["tier_demoted_chunks"] = ts["demoted_chunks"]
            fr["tier_promoted_chunks"] = ts["promoted_chunks"]
        return fr

    def debug_snapshot(self) -> dict:
        """The ``lmstudio.debug.snapshot`` view: each live slot's position
        and block table with refcounts, the pool and prefix-cache
        summaries, the brownout state and the recorder's tail. Safe from
        any thread: reads the slot view the owner loop swaps wholesale and
        the pool's host-side counters."""
        pool = self._pool
        slots: dict[int, dict] = {}
        for i, ent in sorted(self._slot_view.items()):
            e = dict(ent)
            if e.get("blocks"):
                e["block_refcounts"] = [pool.refcount(b) for b in e["blocks"]]
            slots[i] = e
        snap: dict = {
            "max_slots": self.max_slots,
            "max_seq": self.max_seq,
            "paged": True,
            "kv_quant": self.cfg.kv_quant,
            "kv_block_tokens": self.kv_block_tokens,
            "queue_depth": self.queue_depth,
            "slots": slots,
            "decode_spt_ewma_ms": round(self._decode_spt_ewma * 1e3, 3),
            "spec_accept_ewma": round(self.stats.spec_accept_ewma, 3),
            "pool": pool.stats(),
        }
        bo = self.brownout
        if bo is not None:
            snap["brownout"] = {"level": bo.level, "level_name": LEVEL_NAMES[bo.level],
                                "transitions": bo.transitions}
        if self.prefix_cache is not None:
            snap["prefix_cache"] = self.prefix_cache.stats()
        if self.recorder is not None:
            snap["recorder_tail"] = self.recorder.tail(20)
            snap["recorder_frames_sampled"] = self.recorder.frames_sampled
        return snap

    def _note_prefill_rate(self, tokens: int, seconds: float) -> None:
        if seconds <= 0 or tokens <= 0:
            return
        rate = tokens / seconds
        prev = self._prefill_rate_ewma
        self._prefill_rate_ewma = rate if prev == 0.0 else 0.8 * prev + 0.2 * rate

    def _note_decode_spt(self, step_seconds: float) -> None:
        if step_seconds <= 0:
            return
        prev = self._decode_spt_ewma
        self._decode_spt_ewma = step_seconds if prev == 0.0 else 0.8 * prev + 0.2 * step_seconds

    def _estimate_serve_s(self, req: _Request) -> float:
        """Seconds to prefill ``req`` and decode its feasibility floor of
        tokens, from the live rate EWMAs (0.0 while cold: then only the
        already-expired are shed)."""
        est = 0.0
        if self._prefill_rate_ewma > 0.0:
            est += len(req.prompt_ids) / self._prefill_rate_ewma
        min_tok = max(1, min(self.deadline_min_tokens, req.sp.max_tokens))
        return est + min_tok * self._decode_spt_ewma

    def _tenant_served(self, req: _Request) -> None:
        """Per-tenant completion accounting: generated tokens and queue age."""
        age_ms = max(0.0, (req.t_admit - req.t_enq) * 1e3)
        self.tenant_stats.record_served(req.tenant, req.generated, age_ms)

    def heartbeat_age_s(self) -> float:
        """Seconds since the owner loop last topped its pass. Meaningful only
        while the batcher is not idle: an idle owner blocks on its inbox."""
        return time.monotonic() - self.heartbeat

    @property
    def alive(self) -> bool:
        """True while the owner thread runs and has not crashed."""
        return self.crashed is None and self._thread is not None and self._thread.is_alive()

    def stop(self, error: str | None = None) -> None:
        """End the owner thread and every request, then drop the device
        tensors (params, the K/V pool and the prefix cache's logits rows),
        so their memory goes back to the allocator even while something
        still holds this batcher or its engine. Requests end with
        "shutdown"; with ``error`` (the worker's drain passes
        ``DRAIN_ERROR``) every live, queued and waiting request fails with a
        ``BatcherStopped`` of that text instead, streams that already have
        tokens included, so the client retries it on a peer as the
        reference's drain does."""
        with self._submit_lock:
            running = self._started and not self._stopping
            self._stopping = True
            self._stop_error = error
            if running:
                self._inbox.put(None)
        if self._thread is not None:
            # a crashed owner may still be writing its crash dump
            self._thread.join(timeout=30.0)
        if running:
            self._drain_all("shutdown")
        if self._thread is not None and self._thread.is_alive():
            log.warning("batcher thread still running after stop; its device "
                        "tensors stay allocated")
            return
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        if self.kv_tiers is not None:
            # flush pending spills so the Object Store tier is complete,
            # then stop the spill thread
            self.kv_tiers.close()
        self.params = None
        self._kv = None

    @property
    def idle(self) -> bool:
        """Nothing served, suspended or queued (approximate; any thread)."""
        return (
            not any(s is not None for s in self._slots)
            and not self._suspended
            and self._inbox.qsize() == 0
            and self._wl_len == 0
        )

    def _new_kv_pool(self) -> tuple:
        cfg = self.cfg
        shape = (self._pool.n_blocks, cfg.n_layers, cfg.n_kv_heads, self.kv_block_tokens,
                 cfg.head_dim)
        return tuple(kv_pool_zeros(shape, torch_dtype(cfg.dtype), self.device,
                                   quant=cfg.kv_quant == "int8") for _ in range(2))

    def pool_stats(self) -> dict:
        """Block counters (``cow_copies`` among them), the KV mode and the
        device bytes of the K and V pools (0 once stopped)."""
        kv = self._kv or (None, None)
        return {**self._pool.stats(), "kv_quant": self.cfg.kv_quant,
                "bytes": kv_nbytes(kv[0]) + kv_nbytes(kv[1])}

    def tier_stats(self) -> dict | None:
        """KV tier and slot-suspend counters (the ``lmstudio_kv_tier_*``
        families), or None when neither tiering nor suspend is on. Safe
        from any thread."""
        if self.kv_tiers is None and not self.kv_suspend:
            return None
        out = dict(self._suspend_stats)
        out["suspended"] = len(self._suspended)
        if self.kv_tiers is not None:
            out.update(self.kv_tiers.stats())
        if self.prefix_cache is not None:
            c = self.prefix_cache.counters()
            out["demoted_blocks"] = c.get("demoted_blocks", 0)
            out["demote_failures"] = out.get("demote_failures", 0) + c.get("demote_failures", 0)
        return out

    def drop_prefix_cache(self) -> int:
        """Evict every cached prefix block and zero the budget (the
        registry's memory-pressure tier). Safe from any thread: blocks
        pinned by an admit in flight are detached now and freed when that
        admit releases them. Returns the number of blocks evicted."""
        pc = self.prefix_cache
        return pc.resize(0) if pc is not None else 0

    # -- submission ----------------------------------------------------------

    def _enqueue(self, prompt_ids: list[int], sp: SamplingParams, trace: Trace | None = None,
                 deadline: float | None = None, constrain=None, want_logprobs: bool = False,
                 top_logprobs: int = 0, tenant: str = ANON_TENANT,
                 priority: str = DEFAULT_PRIORITY, weight: float = 0.0) -> _Request:
        if not prompt_ids:
            raise ValueError("empty prompt")
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(f"prompt of {len(prompt_ids)} tokens >= max_seq {self.max_seq}")
        req = _Request(
            prompt_ids=list(prompt_ids), sp=sp, loop=asyncio.get_running_loop(),
            out=asyncio.Queue(), t_enq=time.monotonic(), trace=trace, deadline=deadline,
            constrain=constrain, cstate=constrain.start if constrain is not None else 0,
            want_logprobs=bool(want_logprobs), top_logprobs=int(top_logprobs),
            tenant=str(tenant or ANON_TENANT), priority=priority,
            weight=max(0.0, float(weight)),
        )
        self.tenant_stats.record_request(req.tenant)
        if trace is not None:
            trace.mark("enqueue", req.t_enq)
        # expired before it was queued: shed at submit, no device work
        if deadline is not None and req.t_enq >= deadline:
            self.stats.record_shed("deadline")
            self.tenant_stats.record_shed(req.tenant)
            raise BatcherOverloaded(
                "deadline already expired at submit (shed_cause=deadline); "
                "retry on another worker"
            )
        bo = self.brownout
        with self._submit_lock:
            if self._stopping:
                raise BatcherStopped("batcher is stopped; retry on another worker")
            if bo is not None and bo.level >= SHED_ONLY and self.idle:
                # the owner loop ticks the controller only while it has
                # work; a drained pipeline parks it on the inbox, so tick
                # from here with the current (calm) signals, or the level
                # would stay at shed-only for good
                bo.update(depth_frac=self._inbox.qsize() / (self.max_queue or 4 * self.max_slots),
                          age_p95_ms=0.0, hbm_headroom_frac=self._headroom())
            if bo is not None and bo.level > req.rank:
                # the level is the lowest class still admitted: BROWNOUT
                # sheds batch, SHED_ONLY batch and standard; premium only
                # meets the depth bound below
                self.stats.record_shed("brownout")
                self.tenant_stats.record_shed(req.tenant)
                if bo.level >= SHED_ONLY:
                    msg = ("brownout shed-only: worker saturated "
                           "(shed_cause=brownout); retry on another worker")
                else:
                    msg = (f"brownout: {req.priority} class shed first "
                           f"(shed_cause=brownout); retry on another worker")
                raise BatcherOverloaded(msg)
            limit = bo.effective_queue_limit(self.max_queue) if bo is not None else self.max_queue
            if limit:
                # premium rides a 50% depth grace past the bound; the owner
                # loop displaces the lowest-fair-share waiters instead
                eff = limit + (limit >> 1) + 1 if req.rank >= 2 else limit
                if self._inbox.qsize() + self._wl_len >= eff:
                    self.stats.record_shed("depth")
                    self.tenant_stats.record_shed(req.tenant)
                    raise BatcherOverloaded(
                        f"admit queue full ({limit} waiting) "
                        f"(shed_cause=depth); retry on another worker"
                    )
            self._inbox.put(req)
        return req

    def cancel(self, req: _Request) -> None:
        req.cancelled = True
        self._cancels.put(req)

    async def submit(self, prompt_ids: list[int], sp: SamplingParams,
                     info: dict | None = None, trace: Trace | None = None,
                     deadline: float | None = None, constrain=None,
                     want_logprobs: bool = False, top_logprobs: int = 0,
                     tenant: str = ANON_TENANT, priority: str = DEFAULT_PRIORITY,
                     weight: float = 0.0) -> AsyncIterator[int]:
        """Yield generated token ids for one request; ``info`` receives the
        end reason ("stop" / "length" / "shutdown") as ``finish_reason``.
        ``deadline`` is an absolute ``time.monotonic()`` value: past it the
        request is shed before prefill or aborted mid-decode. ``tenant``,
        ``priority`` and ``weight`` place it in the fair-share admission.
        See ``submit_batched`` for the ext options."""
        async for batch in self.submit_batched(
                prompt_ids, sp, info=info, trace=trace, deadline=deadline,
                constrain=constrain, want_logprobs=want_logprobs,
                top_logprobs=top_logprobs, tenant=tenant, priority=priority, weight=weight):
            for tok in batch:
                yield tok

    async def submit_batched(self, prompt_ids: list[int], sp: SamplingParams,
                             info: dict | None = None, trace: Trace | None = None,
                             deadline: float | None = None, constrain=None,
                             want_logprobs: bool = False, top_logprobs: int = 0,
                             tenant: str = ANON_TENANT, priority: str = DEFAULT_PRIORITY,
                             weight: float = 0.0) -> AsyncIterator[list]:
        """Like ``submit`` but yields lists: everything delivered since the
        consumer last woke (a decode burst) comes out as one batch.

        ``constrain`` is a ``serve/constrain.py`` TokenDFA (schema-constrained
        decoding); with ``want_logprobs`` each item is a ``(tok, logprob,
        top_ids, top_logprobs)`` tuple instead of a bare id. Either option
        routes the request through the masked single-step ext program."""
        if not self._started:
            self.start()
        if not prompt_ids:
            return
        req = self._enqueue(prompt_ids, sp, trace=trace, deadline=deadline, constrain=constrain,
                            want_logprobs=want_logprobs, top_logprobs=top_logprobs,
                            tenant=tenant, priority=priority, weight=weight)
        done = False
        try:
            while True:
                kind, value = await req.out.get()
                batch: list[int] = []
                while True:
                    if kind == "tok":
                        batch.append(value)
                    elif kind == "end":
                        done = True
                        if batch:
                            yield batch
                        if info is not None:
                            info["finish_reason"] = value
                        return
                    else:
                        done = True
                        if batch:
                            yield batch
                        raise value
                    try:
                        kind, value = req.out.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                yield batch
        finally:
            if not done:  # consumer left early: free the slot
                self.cancel(req)

    # -- device loop (owner thread) ------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_seq

    def _win_bucket(self, n: int) -> int:
        """Power-of-two attention window >= n, clamped to max_seq: a chunk
        reads only the live prefix of the row cache."""
        w = 1 << max(0, n - 1).bit_length()
        return min(w, self.max_seq)

    def _run(self) -> None:
        cfg = self.cfg
        B = self.max_slots
        C = self.prefill_chunk
        pool = self._pool
        pc = self.prefix_cache
        T = self.kv_block_tokens
        MB = self.blocks_per_row
        dev = self.device
        KP, VP = self._kv
        coalesce_s = self.admit_coalesce_ms / 1e3
        spec = self.spec_cfg
        # each live slot's n-gram index over prompt + delivered tokens,
        # made at its admit's readback and dropped with the slot
        spec_slots: list[SpecSlot | None] = [None] * B
        tables: list[list[int]] = [[] for _ in range(B)]
        tbl_dev = torch.zeros((B, MB), dtype=torch.int32, device=dev)
        table_dirty = False
        # device-resident next-token carry: burst k+1 starts from burst k's
        # last sampled token without a readback
        tok_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        # host counters, advanced at dispatch time
        host_pos = [0] * B
        host_steps = [0] * B
        host_seed = [0] * B
        # dispatches not read back yet: ("decode", toks, n, rows) |
        # ("spec", toks, n_emit, [(slot, req, drafted), ...]) |
        # ("ext", toks, logprobs, top_ids, top_logprobs, rows) |
        # ("admit", firsts, [(row in firsts, slot, req), ...])
        inflight: collections.deque = collections.deque()
        waitlist = self._waitlist
        # the host KV tier (under the prefix cache only) and slot suspend
        tier = self.kv_tiers if pc is not None else None
        suspend_on = self.kv_suspend

        def alloc_blocks(k: int, for_req: _Request | None = None) -> list[int]:
            """Take k fresh pool blocks for an admit. On shortage: reclaim
            (demote) the evictable cache; for a higher-class admit
            (``for_req``) preempt strictly lower classes; suspend victim
            slots (swap-don't-shed); shed only when every lever is spent.
            Raises _PoolExhausted before any device write, so the caller
            sheds one request instead of resetting the cache. Growth and
            opportunistic allocations (promotion, resume) never suspend:
            they call ``_alloc_blocks`` / ``_try_alloc``."""
            got = self._try_alloc(k)
            if got is None and suspend_on:
                if self.qos_preempt and for_req is not None and for_req.rank > 0:
                    # a premium admit never parks a premium peer
                    while got is None and suspend_victim(below_rank=for_req.rank,
                                                         reason="preempted"):
                        got = self._try_alloc(k)
                while got is None and suspend_victim():
                    got = self._try_alloc(k)
            if got is None:
                self.stats.record_shed("kv_pool")
                if self.recorder is not None:
                    # rate-limited: a starved pool sheds every admit attempt
                    self.recorder.dump("kv_pool_exhausted",
                                       extra={"needed": k, "free": pool.free_blocks})
                raise self._exhausted(k)
            return got

        def ensure_blocks(i: int, upto: int) -> None:
            nonlocal table_dirty
            need = min(-(-min(upto, self.max_seq) // T), MB)
            if len(tables[i]) < need:
                tables[i].extend(self._alloc_blocks(need - len(tables[i])))
                table_dirty = True

        def ensure_private(i: int, lo: int, hi: int) -> None:
            nonlocal table_dirty
            if self._ensure_private(tables[i], lo, hi):
                table_dirty = True

        def refresh_tables() -> None:
            """Mirror the live slots' tables to the device. A reserved or
            empty slot gets a null row: the decode step computes its row as
            junk, and that junk must land in the null block, never in the
            shared prefix blocks a partial-hit admit has already put in its
            table."""
            nonlocal tbl_dev, table_dirty
            if not table_dirty:
                return
            arr = torch.zeros((B, MB), dtype=torch.int32)
            for i, t in enumerate(tables):
                if t and isinstance(self._slots[i], _Request):
                    arr[i, : len(t)] = torch.tensor(t, dtype=torch.int32)
            tbl_dev = arr.to(dev)
            table_dirty = False

        def active() -> list[int]:
            return [i for i, r in enumerate(self._slots) if isinstance(r, _Request)]

        def rebuild_slot_view() -> None:
            """Publish the live slots' host-side state for debug_snapshot()
            (copies, swapped in wholesale)."""
            view: dict[int, dict] = {}
            for i, r in enumerate(self._slots):
                if not isinstance(r, _Request):
                    continue
                ent = {"pos": host_pos[i], "prompt_tokens": len(r.prompt_ids),
                       "generated": r.generated, "max_tokens": r.sp.max_tokens,
                       "cancelled": r.cancelled, "blocks": list(tables[i])}
                if r.trace is not None:
                    ent["trace_id"] = r.trace.trace_id
                view[i] = ent
            self._slot_view = view

        def ext_live() -> bool:
            """A live constrained or logprob slot puts every slot in the ext
            regime: the burst and verify programs advance every row, so an
            ext slot cannot sit one out."""
            return any(isinstance(r, _Request) and r.is_ext for r in self._slots)

        def finish_slot(i: int) -> None:
            nonlocal table_dirty
            self._slots[i] = None
            spec_slots[i] = None
            # keep the cross-thread view honest even when the loop is about
            # to block idle on the inbox
            self._slot_view.pop(i, None)
            host_pos[i] = 0
            host_steps[i] = 0
            if tables[i]:
                pool.decref(tables[i])
                tables[i] = []
            table_dirty = True

        def deliver_all(req: _Request, slot: int, ids, advance: bool = True) -> None:
            st = spec_slots[slot]
            try:
                for t in ids:
                    if advance:  # decode tokens move the slot's position
                        req.pos += 1
                    if st is not None:
                        st.index.append(int(t))
                    reason = self._deliver(req, int(t))
                    if reason is not None:
                        self._ledger_finalize(req, "served")
                        self._tenant_served(req)
                        finish_slot(slot)  # free BEFORE the end event
                        req.emit("end", reason)
                        return
            except Exception:  # noqa: BLE001 — dead client
                log.exception("delivery failed; dropping slot %d", slot)
                self._ledger_finalize(req, "cancelled")
                finish_slot(slot)

        def deliver_ext(req: _Request, slot: int, t: int, lp: float, top_ids, top_lps) -> None:
            """One masked step's token: the DFA advances, and a document the
            DFA can extend no further ends with "stop"."""
            st = spec_slots[slot]
            try:
                req.pos += 1
                if st is not None:
                    st.index.append(t)  # an unconstrained slot riding along
                dead = False
                if req.constrain is not None:
                    nstate = req.constrain.advance(req.cstate, t)
                    if nstate is not None:
                        # (None only for an EOS outside an accept state,
                        # which the mask forbids; _deliver maps stop ids)
                        req.cstate = nstate
                    dead = not req.constrain.live(req.cstate)
                if req.want_logprobs:
                    reason = self._deliver(req, t, logprob=lp, top_ids=top_ids,
                                           top_lps=top_lps)
                else:
                    reason = self._deliver(req, t)
                if reason is None and dead:
                    reason = "stop"
                if reason is not None:
                    self._ledger_finalize(req, "served")
                    self._tenant_served(req)
                    finish_slot(slot)  # free BEFORE the end event
                    req.emit("end", reason)
            except Exception:  # noqa: BLE001 — dead client
                log.exception("delivery failed; dropping slot %d", slot)
                self._ledger_finalize(req, "cancelled")
                finish_slot(slot)

        def gone(slot: int, req: _Request, where: str = "decode") -> bool:
            """Whether a record's row no longer needs delivering: the slot
            moved on, or the consumer left or its deadline passed (its slot
            and blocks are freed here)."""
            if self._slots[slot] is not req:
                return True
            if req.cancelled:
                self._ledger_finalize(req, "deadline_abort" if req.deadline_hit
                                      else "cancelled")
                finish_slot(slot)
                self.stats.record_cancel("deadline" if req.deadline_hit else where)
                return True
            return False

        def note_step(t_disp: float, n: int) -> None:
            """A decode record's per-step latency, dispatch to readable
            tokens (pipeline wait included: what a stream sees)."""
            step_s = (time.monotonic() - t_disp) / n
            self.stats.decode_step_ms.record(step_s * 1e3)
            self._note_decode_spt(step_s)

        def process_record(rec) -> None:
            if rec[0] == "decode":
                _, toks, n, rows, t_disp = rec
                ids = toks.cpu()  # ONE [B, n] readback per burst
                note_step(t_disp, n)
                for slot, req in rows:
                    if not gone(slot, req):
                        deliver_all(req, slot, ids[slot].tolist())
            elif rec[0] == "spec":
                _, toks, nacc, rows, t_disp = rec
                ids, nacc = toks.cpu(), nacc.cpu()
                self.stats.decode_step_ms.record((time.monotonic() - t_disp) * 1e3)
                for slot, req, dlen in rows:
                    if self._slots[slot] is not req:
                        continue
                    n_emit = int(nacc[slot])
                    # host pos catches up here: a verify's advance depends
                    # on the data (host_steps moved by k+1 at dispatch)
                    host_pos[slot] += n_emit
                    if dlen > 0:
                        self.stats.record_spec(dlen, n_emit - 1)
                        if self._efficiency and req.dev_spec_ms > 0.0:
                            # the rejected drafts' share of this verify moves
                            # out of the request's accrual now: it can never
                            # serve a token, whatever the request's outcome
                            waste = min(req.dev_spec_ms * (dlen + 1 - n_emit) / (dlen + 1),
                                        req.dev_decode_ms)
                            if waste > 0.0:
                                req.dev_decode_ms -= waste
                                self.stats.attribute_device_time("spec_rejected", waste)
                            req.dev_spec_ms = 0.0
                    if not gone(slot, req):
                        deliver_all(req, slot, ids[slot, :n_emit].tolist())
            elif rec[0] == "ext":
                _, toks, lps, tids, tlps, rows, t_disp = rec
                ids, lps, tids, tlps = toks.cpu(), lps.cpu(), tids.cpu(), tlps.cpu()
                note_step(t_disp, 1)
                for slot, req in rows:
                    if not gone(slot, req):
                        deliver_ext(req, slot, int(ids[slot]), float(lps[slot]),
                                    tids[slot].tolist(), tlps[slot].tolist())
            else:
                _, firsts, rows = rec
                ids = firsts.cpu()  # one readback for the whole admit
                for j, slot, req in rows:
                    if gone(slot, req, "admit"):
                        continue
                    if req.is_ext and not req.rewound:
                        # the rewind: the admit sampled token 0 with no mask
                        # and no logprobs. Drop it, step the slot back one
                        # position and put prompt[-1] back on the carry: the
                        # next ext step re-runs prompt[-1] at n-1 (the write
                        # repeats the prefill's row; ensure_private copies a
                        # shared block first) and samples the real token 0
                        # under the mask, at rng step 0
                        req.rewound = True
                        host_pos[slot] -= 1
                        host_steps[slot] = 0
                        tok_dev[slot] = req.prompt_ids[-1]
                        continue
                    first = int(ids[j])
                    deliver_all(req, slot, [first], advance=False)
                    if spec is not None and self._slots[slot] is req:
                        # history = prompt + the first token (on the carry,
                        # not yet written to the pool)
                        spec_slots[slot] = make_slot(req.prompt_ids, first, spec)

        def pump(depth: int = 1) -> None:
            while len(inflight) > depth or (inflight and not active()):
                process_record(inflight.popleft())

        def drain_cancels() -> None:
            while True:
                try:
                    req = self._cancels.get_nowait()
                except _queue.Empty:
                    return
                if 0 <= req.slot < B and self._slots[req.slot] is req:
                    self._ledger_finalize(req, "cancelled")
                    finish_slot(req.slot)
                    self.stats.record_cancel("active")
                elif req in waitlist:
                    waitlist.remove(req)
                    self.stats.record_cancel("waitlist")

        # -- swap-don't-shed: the host tier, suspend and resume -----------------

        def read_blocks(ids: list[int]) -> tuple:
            """Host copies (``kv_to_host``) of the K and V pool blocks
            ``ids``: one gather and one readback a pool."""
            bids = torch.tensor(ids, dtype=torch.int32)
            return (kv_to_host(kv_pool_read_blocks(KP, bids)),
                    kv_to_host(kv_pool_read_blocks(VP, bids)))

        def write_blocks(ids: list[int], k_host, v_host) -> None:
            """Host K and V copies into the pool blocks ``ids``, queued on
            the stream ahead of every later dispatch that reads them."""
            bids = torch.tensor(ids, dtype=torch.int32)
            kv_pool_write_row(KP, kv_from_host(k_host, dev), bids)
            kv_pool_write_row(VP, kv_from_host(v_host, dev), bids)

        if tier is not None:
            def demote_chunk(token_ids, payload, logits) -> bool:
                """Prefix-cache eviction hook (owner thread, the cache's
                lock held): read the node's pool blocks back to host and
                hand them to the tier, so eviction becomes demotion. False
                (plain eviction) for a payload minted before a pool reset:
                its ids name recycled blocks."""
                ep, ids = payload
                if ep != pool.epoch:
                    return False
                k_host, v_host = read_blocks(ids)
                lg = None if logits is None else logits.float().cpu()
                return tier.demote(token_ids, k_host, v_host, lg)

            pc.demote_fn = demote_chunk

        def suspend_slot(i: int, reason: str, min_blocks: int | None = None) -> bool:
            """Move slot i (its KV blocks and full resume state) to the host
            side and free the slot. False with the slot untouched when it
            is not suspendable (mid-admit, a state the resume could not
            rebuild, a failed readback): the caller sheds instead. Chaos
            hook: a ``raise`` rule at SUSPEND is a worker dying
            mid-suspend; any other kind aborts the suspend before any state
            has moved."""
            if not suspend_on:
                return False
            req = self._slots[i]
            if not isinstance(req, _Request) or req.cancelled:
                return False
            if _faults.ACTIVE is not None:
                f = _faults.ACTIVE.check(_faults.SUSPEND)
                if f is not None:
                    self._suspend_stats["suspend_failures"] += 1
                    if f.kind == "raise":
                        raise f.exception()
                    return False
            # drain every dispatch in flight first: delivered tokens,
            # positions and rng steps must agree before the state is frozen
            # (a pending burst would deliver tokens the copy does not hold)
            pump(0)
            req = self._slots[i]
            if not isinstance(req, _Request) or req.cancelled:
                return False  # finished or cancelled during the drain
            if len(req.prompt_ids) + len(req.emitted) != host_pos[i] + 1 or not tables[i]:
                self._suspend_stats["suspend_failures"] += 1
                return False
            t0 = time.monotonic()
            try:
                k_host, v_host = read_blocks(tables[i])
            except Exception:  # noqa: BLE001 — readback failed; the slot stays
                log.exception("suspend readback failed; slot %d stays", i)
                self._suspend_stats["suspend_failures"] += 1
                return False
            rec = _Suspended(req=req, k=k_host, v=v_host, n_blocks=len(tables[i]),
                             pos=host_pos[i], steps=host_steps[i], seed=host_seed[i],
                             spec=spec_slots[i], t_suspend=time.monotonic(), reason=reason,
                             min_blocks=min_blocks)
            finish_slot(i)  # decrefs the blocks; the host copy owns the KV
            self._suspended.append(rec)
            self._suspend_stats["suspended_total"] += 1
            if reason == "preempted":
                # parked, not lost: counts preemptions per tenant, not sheds
                self.tenant_stats.record_preempted(req.tenant)
            obs_emit("slot_suspend", slot=i, reason=reason, pos=rec.pos,
                     generated=req.generated, blocks=rec.n_blocks,
                     ms=round((rec.t_suspend - t0) * 1e3, 3))
            return True

        def suspend_victim(below_rank: int | None = None, reason: str = "kv_pool") -> bool:
            """Suspend the slot whose demotion frees the most blocks, lowest
            priority class first (falling through candidates a drain
            disqualifies); ``below_rank`` keeps only strictly lower classes
            (preemption for a higher-class admit). False when nothing is
            suspendable."""
            cand = sorted(
                (i for i, r in enumerate(self._slots)
                 if isinstance(r, _Request) and not r.cancelled and tables[i]
                 and (below_rank is None or r.rank < below_rank)),
                key=lambda i: (self._slots[i].rank, -len(tables[i])))
            return any(suspend_slot(i, reason) for i in cand)

        def resume_suspended() -> None:
            """Re-admit suspended slots, oldest first, while slots and
            blocks allow: the host copies go into fresh blocks, the
            position, rng step, seed and spec state come back, and the
            carry token is the last delivered one (the prompt's last when
            nothing was delivered), so the next step computes what it
            would have computed unsuspended."""
            nonlocal tok_dev, table_dirty
            bo = self.brownout
            if not self._suspended or (bo is not None and bo.level >= SHED_ONLY):
                return  # nothing parked, or still inside the incident window
            pending = self._suspended
            while pending and None in self._slots:
                rec = pending[0]
                req = rec.req
                if req.cancelled:
                    pending.pop(0)
                    self._ledger_finalize(req, "deadline_abort" if req.deadline_hit
                                          else "cancelled")
                    self.stats.record_cancel("active")
                    continue
                if pool.free_blocks < rec.min_blocks and pc is not None:
                    pc.reclaim(rec.min_blocks - pool.free_blocks, demote=True)
                if pool.free_blocks < rec.min_blocks:
                    return  # the pool is still tight: next pass
                # never suspends another slot (thrash) nor sheds: a full
                # pool defers the resume
                ids = self._try_alloc(rec.n_blocks)
                if ids is None:
                    return
                slot = self._slots.index(None)
                t0 = time.monotonic()
                try:
                    write_blocks(ids, rec.k, rec.v)
                except Exception as e:  # noqa: BLE001 — the host copy is unusable
                    log.exception("resume failed; slot of %d tokens dropped", req.generated)
                    pool.decref(ids)
                    pending.pop(0)
                    self._suspend_stats["suspend_failures"] += 1
                    self._ledger_finalize(req, "failed")
                    req.emit("err", BatcherOverloaded(
                        f"resume failed after {req.generated} tokens ({e}); "
                        f"retry on another worker"))
                    continue
                pending.pop(0)
                tables[slot] = list(ids)
                table_dirty = True
                req.slot = slot
                self._slots[slot] = req
                host_pos[slot] = rec.pos
                host_steps[slot] = rec.steps
                host_seed[slot] = rec.seed
                spec_slots[slot] = rec.spec
                tok_dev = tok_dev.clone()  # an in-flight record may hold the carry
                tok_dev[slot] = req.emitted[-1] if req.emitted else req.prompt_ids[-1]
                self._suspend_stats["resumed_total"] += 1
                now = time.monotonic()
                obs_emit("slot_resume", slot=slot, reason=rec.reason, pos=rec.pos,
                         generated=req.generated,
                         suspended_ms=round((now - rec.t_suspend) * 1e3, 1),
                         ms=round((now - t0) * 1e3, 3))

        def promote_from_tier(prompt_ids) -> None:
            """Pull host-tier chunks that extend this prompt's cached prefix
            back into the pool and the radix cache (promotion-on-hit), at
            most ``tier.promote_chunks`` an admit. A full pool or any
            failure leaves the cache as it was: fresh blocks are dropped,
            the cache's own references keep what it inserted."""
            if tier is None or tier.promote_chunks <= 0 or pc.capacity <= 0:
                return  # nothing to promote into (a dropped cache inserts nothing)
            n_full = len(prompt_ids) // C
            have = pc.peek(prompt_ids) // C
            if n_full <= have:
                return
            nbc = C // T
            token_ids = [int(t) for t in prompt_ids[: n_full * C]]
            payloads: list = [None] * have
            logits_list: list = [None] * have
            alloc: list[int] = []
            found = 0
            try:
                for j in range(have, min(n_full, have + tier.promote_chunks)):
                    ent = tier.lookup(tuple(token_ids[: (j + 1) * C]))
                    if ent is None:
                        break
                    ids = self._try_alloc(nbc)
                    if ids is None:
                        break  # promote what fit; the admit decides the rest
                    alloc.extend(ids)
                    write_blocks(ids, ent.k, ent.v)
                    payloads.append((pool.epoch, list(ids)))
                    logits_list.append(None if ent.logits is None else
                                       torch.from_numpy(np.array(ent.logits, np.float32)).to(dev))
                    found += 1
            except Exception:  # noqa: BLE001 — promotion is best-effort
                log.exception("tier promotion failed; continuing without")
                found = 0
            if found:
                pc.insert(token_ids[: (have + found) * C], payloads, logits_list)
                tier.note_promoted(found)
            if alloc:
                # the cache's acquire holds the inserted chunks' references
                pool.decref(alloc)

        def grow_for_burst(act: list[int], width: int, prev_ctx) -> bool:
            """Grow each row's table over the next ``width`` writes and
            privatize any still-shared block in the write range, before any
            dispatch. A row the pool cannot grow ends the round: it is
            parked on the host tier when parking can ever succeed (its full
            extent fits the pool and another slot will release blocks; it
            resumes and regrows once they free) and shed alone otherwise;
            the other streams keep their tokens and the pool is not reset.
            False when the caller must skip the round (the slot list is
            stale)."""
            i = -1
            try:
                for i in act:
                    ensure_blocks(i, host_pos[i] + width)
                    ensure_private(i, host_pos[i], host_pos[i] + width)
                return True
            except _PoolExhausted as e:
                self._charge_ctx = prev_ctx
                r = self._slots[i]
                fits = isinstance(r, _Request) and min(
                    -(-(len(r.prompt_ids) + r.sp.max_tokens) // T), MB) <= pool.n_blocks - 1
                others = any(j != i and isinstance(self._slots[j], _Request) for j in range(B))
                need = min(-(-min(host_pos[i] + width, self.max_seq) // T), MB)
                if fits and others and suspend_slot(i, "growth", min_blocks=need):
                    return False
                r = self._slots[i]  # the suspend's drain may have finished it
                if isinstance(r, _Request):
                    self.stats.record_shed("kv_pool")
                    self._ledger_finalize(r, "shed_after_prefill")
                    finish_slot(i)
                    r.emit("err", e)
                return False

        def sampling_lists():
            live = [r if isinstance(r, _Request) else None for r in self._slots]
            return ([r.sp.temperature if r else 0.0 for r in live],
                    [r.sp.top_k if r else 0 for r in live],
                    [r.sp.top_p if r else 1.0 for r in live])

        def decode_ext_once() -> None:
            """ONE masked single-step dispatch over every active slot (the
            ext regime): a constrained row carries its DFA state's vocab
            mask, every other row bans nothing. One step at a time, because
            the next mask is a host-side DFA walk over this step's token;
            the caller drains before and after."""
            act = active()
            if not act:
                return
            # charge the step (and its CoW copies) to the live requests
            prev = self._charged(self._slots[i] for i in act)
            try:
                if grow_for_burst(act, 1, prev):
                    ext_dispatch(act)
            finally:
                self._charge_ctx = prev

        def ext_dispatch(act: list[int]) -> None:
            nonlocal tok_dev
            mask = None
            if any(self._slots[i].constrain is not None for i in act):
                m = np.ones((B, cfg.vocab_size), dtype=bool)
                for i in act:
                    r = self._slots[i]
                    if r.constrain is not None:
                        dm = r.constrain.mask(r.cstate)
                        m[i, :] = False
                        m[i, : dm.shape[0]] = dm
                mask = torch.from_numpy(m).to(dev)
            refresh_tables()
            pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
            self._shape = (B, 1, host_pos, B)
            toks, lps, tids, tlps = self._decode_pos_pallas_ext(
                tok_dev, KP, VP, tbl_dev, pos, list(host_seed), list(host_steps),
                *sampling_lists(), mask,
            )
            self.stats.record_tokens("decode_pos_pallas_ext", len(act))
            tok_dev = toks
            self.stats.steps += 1
            self.stats.tokens_per_step.record(float(len(act)))
            for i in act:
                host_pos[i] += 1
                host_steps[i] += 1
            inflight.append(("ext", toks, lps, tids, tlps, [(i, self._slots[i]) for i in act],
                             time.monotonic()))

        def spec_once() -> bool:
            """ONE verify dispatch when a live slot has a prompt-lookup
            draft. False (the caller runs a plain burst) when nothing
            drafted, a row is too close to the cache end for a width-(k+1)
            write, or no slot is active. The caller drains first (the
            proposals read each slot's whole history) and after (host pos
            catches up at the readback)."""
            nonlocal tok_dev
            act = active()
            if not act:
                return False
            k = spec.k
            if max(host_pos[i] for i in act) + k + 1 >= self.max_seq:
                return False
            drafts = [[0] * k for _ in range(B)]
            dlens = [0] * B
            for i in act:
                st = spec_slots[i]
                d = st.index.propose(k) if st is not None else []
                if d:
                    drafts[i][: len(d)] = d
                    dlens[i] = len(d)
            if not any(dlens):
                return False  # nothing to verify: a plain burst is cheaper
            # the verify writes k+1 rows a slot; the rows past the accepted
            # ones are stale by position, but may land in a block the prefix
            # cache still shares, so the whole range is privatized
            prev = self._charged(self._slots[i] for i in act)
            try:
                if not grow_for_burst(act, k + 1, prev):
                    return False  # a row was parked or shed: the burst re-scans
                refresh_tables()
                pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
                self._shape = (B, k + 1, host_pos, B * (k + 1))
                out, nacc, tok_dev = self._spec_verify_pallas(
                    tok_dev, KP, VP, tbl_dev, pos,
                    torch.tensor(drafts, dtype=torch.int32, device=dev), dlens,
                    list(host_seed), list(host_steps), *sampling_lists(),
                )
            finally:
                self._charge_ctx = prev
            self.stats.record_tokens("spec_verify_pallas", len(act) * (k + 1))
            self.stats.steps += 1
            self.stats.spec_verifies += 1
            self.stats.tokens_per_step.record(float(len(act)))
            for i in act:
                host_steps[i] += k + 1  # host_pos moves at the readback
            inflight.append(("spec", out, nacc, [(i, self._slots[i], dlens[i]) for i in act],
                             time.monotonic()))
            return True

        def decode_once() -> None:
            nonlocal tok_dev
            act = active()
            if not act:
                return
            # no row may run past the cache: near capacity, single steps;
            # brownout shortens the burst (a shed or abort lands sooner)
            headroom = self.max_seq - 1 - max(host_pos[i] for i in act)
            burst = (self.brownout.effective_burst(self.decode_burst)
                     if self.brownout is not None else self.decode_burst)
            n = burst if headroom >= burst else 1
            # charge the burst (and its CoW copies) to the live requests; put
            # the previous context back, since bursts run inside chunked admits
            prev = self._charged(self._slots[i] for i in act)
            try:
                if not grow_for_burst(act, n, prev):
                    return
                refresh_tables()
                pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
                self._shape = (B, 1, host_pos, B, n)
                toks, tok_dev = self._decode_pos_pallas(
                    tok_dev, KP, VP, tbl_dev, pos, list(host_seed), list(host_steps),
                    *sampling_lists(), n,
                )
            finally:
                self._charge_ctx = prev
            self.stats.record_tokens("decode_pos_pallas", len(act) * n)
            self.stats.steps += n
            self.stats.tokens_per_step.record(float(len(act)))
            for i in act:
                host_pos[i] += n
                host_steps[i] += n
            inflight.append(("decode", toks, n, [(i, self._slots[i]) for i in act],
                             time.monotonic()))

        def harvest_prefix(prompt_ids, chunk_logits, slot: int, skip_chunks: int = 0) -> None:
            """Insert the prompt's full chunks into the prefix cache with no
            copy: each node holds the slot's pool block ids (an incref)
            tagged with the pool's epoch. ``skip_chunks`` leading chunks
            were themselves hits, so their nodes exist already."""
            if pc is None:
                return
            if self.brownout is not None and self.brownout.pause_prefix_harvest:
                return  # browned out: admits stop filling the cache
            n_full = len(prompt_ids) // C
            if n_full <= skip_chunks:
                return
            nbc = C // T
            tbl = tables[slot]
            payloads: list = [None] * skip_chunks
            for j in range(skip_chunks, n_full):
                ids = tbl[j * nbc : (j + 1) * nbc]
                payloads.append((pool.epoch, list(ids)) if len(ids) == nbc else None)
            pc.insert(list(prompt_ids[: n_full * C]), payloads, chunk_logits)

        def chunk_loop(req: _Request, n: int, k1, v1, start0: int, chunk_logits):
            """Serving-chunk prefill of positions [start0, n) beside live
            slots, one decode burst between chunks; the end row of every
            full chunk goes into ``chunk_logits`` (a ragged last chunk's
            prompt-end row is not a chunk's). Returns the prompt-end
            logits."""
            logits = None
            for start in range(start0, n, C):
                chunk = req.prompt_ids[start : start + C]
                chunk = chunk + [0] * (C - len(chunk))
                self._shape = (1, C, (start,), 1)
                logits = self._prefill1(
                    torch.tensor([chunk], dtype=torch.int32, device=dev), k1, v1,
                    start, min(n - 1 - start, C - 1), self._win_bucket(start + C),
                )
                self.stats.record_tokens("prefill1", min(C, n - start))
                if chunk_logits is not None and start + C <= n:
                    chunk_logits[start // C] = logits
                if start + C < n and not ext_live():
                    decode_once()
                    pump()
            return logits

        def admit_paged(req: _Request, slot: int, n: int, seed: int, samp):
            nonlocal table_dirty
            if n <= C:
                bucket = self._bucket(n)
                ids = alloc_blocks(-(-n // T), for_req=req)
                tables[slot] = ids
                table_dirty = True
                bids = ids + [0] * (max(1, bucket // T) - len(ids))
                tokens = torch.tensor([req.prompt_ids + [0] * (bucket - n)],
                                      dtype=torch.int32, device=dev)
                self.stats.record_tokens("admit_fused_paged", n)
                self._shape = (1, bucket, (0,), 1)
                return self._admit_fused_paged(
                    KP, VP, tokens, n, torch.tensor(bids, dtype=torch.int32), seed, samp,
                )
            # long prompt: a prefix hit resumes from cached pool blocks
            n_full = n // C
            nbc = C // T
            chunk_logits = [None] * n_full if pc is not None else None
            # promotion-on-hit: chunks the cache demoted to the host tier
            # come back into the pool first, so the match below covers the
            # deepest tier-resident prefix
            promote_from_tier(req.prompt_ids)
            hit = pc.match(req.prompt_ids) if pc is not None else None
            if hit is not None and any(p is None or p[0] != pool.epoch
                                       for p in hit.payloads):
                # minted before a pool reset: the ids name recycled blocks
                pc.release(hit)
                hit = None
            if hit is not None and not active() and 2 * hit.tokens < n:
                # one fresh dispatch beats resuming a short cached prefix
                # through per-chunk dispatches
                pc.release(hit)
                hit = None
            try:
                if hit is not None:
                    p = hit.tokens
                    prefix_ids = [b for _, ids in hit.payloads for b in ids]
                    pool.incref(prefix_ids)
                    tables[slot] = list(prefix_ids)
                    table_dirty = True
                    obs_emit("prefix_hit", tokens=p, prompt=n, full=(p == n))
                    if p == n:
                        # full hit: no block copy and no prefill
                        return self._sample_first(hit.end_logits, seed, samp)
                    k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                    for j in range(p // C):
                        self._fill_row_chunk(
                            k1, v1, KP, VP,
                            torch.tensor(prefix_ids[j * nbc : (j + 1) * nbc],
                                         dtype=torch.int32),
                            j * C,
                        )
                    logits = chunk_loop(req, n, k1, v1, p, chunk_logits)
                    skip = p // C
                elif not active():
                    k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                    wb = self._win_bucket(n)
                    tokens = torch.tensor([req.prompt_ids + [0] * (wb - n)],
                                          dtype=torch.int32, device=dev)
                    self._shape = (1, wb, (0,), 1)
                    logits = self._prefill_full(tokens, k1, v1, n)
                    self.stats.record_tokens("prefill_full", n)
                    # only the prompt-end row exists here
                    if chunk_logits is not None and n % C == 0:
                        chunk_logits[n_full - 1] = logits
                    skip = 0
                else:
                    k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                    logits = chunk_loop(req, n, k1, v1, 0, chunk_logits)
                    skip = 0
            finally:
                if hit is not None:
                    pc.release(hit)
            # extend the table over the freshly prefilled suffix, then
            # harvest (host bookkeeping; the pool write below is queued
            # before any later admit's read of these ids)
            total = -(-n // T)
            bstart = len(tables[slot])
            tables[slot].extend(alloc_blocks(total - bstart, for_req=req))
            table_dirty = True
            harvest_prefix(req.prompt_ids, chunk_logits, slot, skip_chunks=skip)
            # a full [max_seq/T] bid row: NULL for the shared prefix blocks
            # (the write must not touch the cache's copies) and the junk tail
            bids = [0] * MB
            bids[bstart:total] = tables[slot][bstart:total]
            return self._finish_admit_paged(
                KP, VP, k1, v1, logits, torch.tensor(bids, dtype=torch.int32), seed, samp,
            )

        def install(rows, firsts, seeds, ns) -> None:
            """Make admitted requests live: their slots, positions and rng
            state, and one in-flight record for their first tokens."""
            nonlocal table_dirty
            out = []
            for j, (slot, req) in enumerate(rows):
                if req.trace is not None:
                    req.trace.mark("prefill")  # prefill dispatched; first token next
                req.slot = slot
                req.pos = ns[j]
                self._slots[slot] = req
                self.stats.requests += 1
                host_pos[slot] = ns[j]
                host_steps[slot] = 1  # the admit sampled at rng step 0
                host_seed[slot] = seeds[j]
                tok_dev[slot] = firsts[j]
                out.append((j, slot, req))
            table_dirty = True
            inflight.append(("admit", firsts, out))

        def release_slots(slots: list[int]) -> None:
            nonlocal table_dirty
            for s in slots:
                if tables[s]:
                    pool.decref(tables[s])
                    tables[s] = []
                self._slots[s] = None
            table_dirty = True

        def start_admit(reqs) -> None:
            """Queue delay ends where the admit starts (a chunked prefill's
            seconds are prefill, not queueing)."""
            t_admit = time.monotonic()
            for r in reqs:
                r.t_admit = t_admit
                self.stats.record_admit_delay((t_admit - r.t_enq) * 1e3)
                if r.trace is not None:
                    r.trace.mark("admit", t_admit)

        def admit_one(req: _Request) -> None:
            start_admit([req])
            slot = self._slots.index(None)
            n = len(req.prompt_ids)
            sp = req.sp
            seed = sp.seed if sp.seed is not None else random.getrandbits(31)
            samp = (float(sp.temperature), int(sp.top_k), float(sp.top_p))
            self._slots[slot] = _RESERVED  # not idle while the admit runs
            # every dispatch until the finish (the interleaved decode bursts
            # re-scope their own) charges this request
            prev = self._charged((req,))
            try:
                first = admit_paged(req, slot, n, seed, samp)
            except BaseException as e:
                release_slots([slot])
                self._ledger_finalize(req, "shed_after_prefill"
                                      if isinstance(e, _PoolExhausted) else "failed")
                raise
            finally:
                self._charge_ctx = prev
            install([(slot, req)], first, [seed], [n])

        def group_fits(ns: list[int]) -> bool:
            """A group allocates all or nothing: reclaim toward the whole
            need first; a shortfall admits one by one, where only what does
            not fit is shed."""
            need = sum(-(-n // T) for n in ns)
            if need > pool.free_blocks and pc is not None:
                pc.reclaim(need - pool.free_blocks, demote=True)
            return need <= pool.free_blocks

        def group_args(reqs: list[_Request]):
            """(pad index, seeds, sampling lists) of a batched admit: the
            row count pads to a power of two by repeating row 0."""
            m = len(reqs)
            mpad = 1 << (m - 1).bit_length()
            idx = list(range(m)) + [0] * (mpad - m)
            seeds = [r.sp.seed if r.sp.seed is not None else random.getrandbits(31)
                     for r in reqs]
            samps = ([float(reqs[i].sp.temperature) for i in idx],
                     [int(reqs[i].sp.top_k) for i in idx],
                     [float(reqs[i].sp.top_p) for i in idx])
            return idx, seeds, samps

        def admit_group(reqs: list[_Request], bucket: int) -> bool:
            """Admit m same-bucket short prompts in one batched prefill.
            False when the pool cannot take the whole group (the caller
            admits them one by one)."""
            nonlocal table_dirty
            ns = [len(r.prompt_ids) for r in reqs]
            if not group_fits(ns):
                return False
            start_admit(reqs)
            slots: list[int] = []
            prev = self._charged(reqs)
            try:
                for _ in reqs:
                    s = self._slots.index(None)
                    self._slots[s] = _RESERVED
                    slots.append(s)
                idx, seeds, samps = group_args(reqs)
                for j, s in enumerate(slots):
                    tables[s] = alloc_blocks(-(-ns[j] // T), for_req=reqs[j])
                table_dirty = True
                nblk = max(1, bucket // T)
                null = [0] * nblk
                bid_rows = torch.tensor(
                    [tables[slots[i]] + [0] * (nblk - len(tables[slots[i]]))
                     if k < len(reqs) else null for k, i in enumerate(idx)],
                    dtype=torch.int32)
                tokens = torch.tensor(
                    [reqs[i].prompt_ids + [0] * (bucket - ns[i]) for i in idx],
                    dtype=torch.int32, device=dev)
                self._shape = (len(idx), bucket, (0,) * len(idx), len(idx))
                firsts = self._admit_many_fused_paged(
                    KP, VP, tokens, [ns[i] for i in idx], bid_rows,
                    [seeds[i] for i in idx], samps,
                )
                self.stats.record_tokens("admit_many_fused_paged", sum(ns[i] for i in idx))
            except BaseException:
                release_slots(slots)
                raise
            finally:
                self._charge_ctx = prev
            self.stats.grouped_admits += len(reqs)
            install(list(zip(slots, reqs)), firsts, seeds, ns)
            return True

        def admit_group_chunked(reqs: list[_Request]) -> None:
            """Admit m long prompts through shared [m, C] chunk dispatches
            and one batched finish, with a decode burst between chunks.
            The reserved slots hold _RESERVED during the loop (their decode
            rows are junk into the null block)."""
            nonlocal table_dirty
            ns = [len(r.prompt_ids) for r in reqs]
            if not group_fits(ns):
                for r in reqs:
                    try:
                        admit_one(r)
                    except _PoolExhausted as e:
                        r.emit("err", e)
                return
            m = len(reqs)
            start_admit(reqs)
            slots: list[int] = []
            prev = self._charged(reqs)
            try:
                for _ in reqs:
                    s = self._slots.index(None)
                    self._slots[s] = _RESERVED
                    slots.append(s)
                idx, seeds, samps = group_args(reqs)
                mpad = len(idx)
                km, vm = make_cache(cfg, mpad, self.max_seq, device=dev)
                final = torch.zeros((mpad, 1, cfg.vocab_size), dtype=torch.float32,
                                    device=dev)
                end_chunk = torch.tensor([(ns[i] - 1) // C for i in idx], device=dev)
                # per-chunk [mpad, 1, V] logits, kept while the prefix cache
                # is on: full chunks' end rows become the nodes' logits
                glogits: list | None = [] if pc is not None else None
                for j in range(-(-max(ns) // C)):
                    start = j * C
                    rows = []
                    for i in idx:
                        chunk = reqs[i].prompt_ids[start : start + C]
                        rows.append(chunk + [0] * (C - len(chunk)))
                    last_pos = [min(max(ns[i] - 1 - start, 0), C - 1) for i in idx]
                    self._shape = (mpad, C, (start,) * mpad, mpad)
                    logits = self._prefill_chunk_group(
                        torch.tensor(rows, dtype=torch.int32, device=dev), km, vm,
                        start, last_pos, self._win_bucket(start + C),
                    )
                    self.stats.record_tokens("prefill_chunk_group", mpad * C)
                    final = self._select_end(final, logits, end_chunk == j)
                    if glogits is not None:
                        glogits.append(logits)
                    if start + C < max(ns) and not ext_live():
                        decode_once()
                        pump()
                # tables before the harvest, which records their block ids
                for j, s in enumerate(slots):
                    tables[s] = alloc_blocks(-(-ns[j] // T), for_req=reqs[j])
                table_dirty = True
                if glogits is not None:
                    for j in range(m):
                        # a copy, so the [mpad, 1, V] chunk buffers can free
                        cl = [glogits[t][j : j + 1].clone() for t in range(ns[j] // C)]
                        harvest_prefix(reqs[j].prompt_ids, cl, slots[j])
                    glogits = None
                bid_rows = torch.zeros((mpad, MB), dtype=torch.int32)
                for j in range(m):
                    t = tables[slots[j]]
                    bid_rows[j, : len(t)] = torch.tensor(t, dtype=torch.int32)
                firsts = self._finish_admit_group_paged(
                    KP, VP, km, vm, final, bid_rows, [seeds[i] for i in idx], samps,
                )
            except BaseException:
                release_slots(slots)
                raise
            finally:
                self._charge_ctx = prev
            self.stats.chunked_group_admits += m
            install(list(zip(slots, reqs)), firsts, seeds, ns)

        def reset_after_failed_dispatch(cause: Exception) -> None:
            """A failed dispatch may have left the pool half written: fail
            the live streams and start over with a fresh pool. The epoch
            bump makes every prefix-cache payload minted before it free as
            a no-op. A CUDA error that kills the context is re-raised: no
            fresh pool can be made in this process, so the loop ends and
            the supervisor takes over."""
            nonlocal KP, VP, tok_dev, table_dirty
            if cuda_context_lost(cause):
                raise cause
            inflight.clear()
            self._charge_ctx = None  # drop any context the failed call left
            err = RuntimeError("batcher cache reset after a failed device dispatch")
            for i, r in enumerate(self._slots):
                if isinstance(r, _Request):
                    self._ledger_finalize(r, "failed")
                    r.emit("err", err)
                self._slots[i] = None
                spec_slots[i] = None
                host_pos[i] = 0
                host_steps[i] = 0
                tables[i] = []
            pool.reset()
            if pc is not None:
                pc.clear()
            table_dirty = True
            KP, VP = self._kv = self._new_kv_pool()
            tok_dev = torch.zeros((B,), dtype=torch.int32, device=dev)

        def peek_hit(r: _Request) -> bool:
            """A long prompt with a usable cached prefix is admitted alone:
            the group program prefills every row from position 0 and would
            throw the hit away (a peek pins nothing)."""
            return (pc is not None and len(r.prompt_ids) > C
                    and pc.peek(r.prompt_ids) >= C)

        def take(item) -> bool:
            """Whether an inbox item is a live request (a cancelled one is
            counted and dropped)."""
            if item.cancelled:
                self.stats.record_cancel("inbox")
                return False
            return True

        def fail_all(reqs: list[_Request], e: BaseException) -> None:
            for r in reqs:
                if isinstance(e, _PoolExhausted):
                    self.tenant_stats.record_shed(r.tenant)
                self._ledger_finalize(r, "shed_after_prefill"
                                      if isinstance(e, _PoolExhausted) else "failed")
                r.emit("err", e)

        def admit_waiters() -> None:
            """Bursts of short same-bucket prompts admit as one batch, runs
            of long prompts (none with a cached prefix) as one batched
            chunked admit, the rest one by one."""
            while waitlist and None in self._slots:
                free = self._slots.count(None)
                head_long = len(waitlist[0].prompt_ids) > C
                group: list[_Request] = []
                if head_long:
                    cap = min(free, self.max_group_long)
                    head_hit = peek_hit(waitlist[0])
                    group.append(waitlist.pop(0))
                    while (not head_hit and waitlist and len(group) < cap
                           and len(waitlist[0].prompt_ids) > C
                           and not peek_hit(waitlist[0])):
                        group.append(waitlist.pop(0))
                    if (not head_hit and len(group) < cap and not waitlist and coalesce_s > 0
                            and not ext_live()):
                        # a chunked admit costs far more than a short wait:
                        # top up with long prompts arriving right behind
                        # (as a decode burst when streams are live)
                        if active():
                            try:
                                decode_once()
                                pump()
                            except Exception as e:  # noqa: BLE001 — the pool may be half written
                                log.exception("decode dispatch failed")
                                fail_all(group, e)
                                reset_after_failed_dispatch(e)
                                continue
                            topup(group, cap, None)
                        else:
                            topup(group, cap, time.monotonic() + max(coalesce_s, 0.05))
                    self._wl_len = len(waitlist)
                    if len(group) > 1:
                        try:
                            admit_group_chunked(group)
                        except _PoolExhausted as e:
                            fail_all(group, e)  # raised before any device write
                        except Exception as e:  # noqa: BLE001 — surface to callers
                            log.exception("group admit failed")
                            fail_all(group, e)
                            reset_after_failed_dispatch(e)
                        continue
                else:
                    head_bucket = self._bucket(len(waitlist[0].prompt_ids))
                    while (waitlist and len(group) < min(free, self.max_group_admit)
                           and len(waitlist[0].prompt_ids) <= C
                           and self._bucket(len(waitlist[0].prompt_ids)) == head_bucket):
                        group.append(waitlist.pop(0))
                    self._wl_len = len(waitlist)
                    if len(group) > 1:
                        try:
                            if admit_group(group, head_bucket):
                                continue
                        except _PoolExhausted as e:
                            fail_all(group, e)
                            continue
                        except Exception as e:  # noqa: BLE001 — surface to callers
                            log.exception("group admit failed")
                            fail_all(group, e)
                            reset_after_failed_dispatch(e)
                            continue
                self._wl_len = len(waitlist)
                for req in group:
                    try:
                        admit_one(req)
                    except _PoolExhausted as e:
                        self.tenant_stats.record_shed(req.tenant)
                        req.emit("err", e)
                    except Exception as e:  # noqa: BLE001 — surface to the caller
                        log.exception("admit failed")
                        req.emit("err", e)
                        reset_after_failed_dispatch(e)
            self._wl_len = len(waitlist)

        def topup(group: list[_Request], cap: int, deadline: float | None) -> None:
            """Pull queued long prompts into ``group`` (waiting until
            ``deadline`` for arrivals when one is given); the first item
            that does not join goes to the waitlist and ends the top-up."""
            while len(group) < cap:
                try:
                    if deadline is None:
                        nxt = self._inbox.get_nowait()
                    else:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            return
                        nxt = self._inbox.get(timeout=left)
                except _queue.Empty:
                    return
                if nxt is None:
                    self._inbox.put(None)  # shutdown: the intake sees it next
                    return
                if not take(nxt):
                    continue
                if len(nxt.prompt_ids) > C and not peek_hit(nxt):
                    group.append(nxt)
                else:
                    waitlist.append(nxt)
                    return

        def overload_tick(now: float) -> None:
            """Once a pass, on host-side state only: the recorder's frame,
            the brownout controller, the deadline sweeps (queued waiters
            shed before any prefill, live slots aborted at their next
            readback) and the fair-share order of the waitlist."""
            depth = len(waitlist) + self._inbox.qsize()
            rebuild_slot_view()
            rec = self.recorder
            if rec is not None and rec.due(now):
                rec.sample(self._recorder_frame(depth=depth, n_active=len(active())), now=now)
            bo = self.brownout
            if bo is not None:
                # queue depth as a fraction of the (configured, or nominal
                # 4x-slots) limit, queue-age p95 over the waiters, headroom
                before = bo.level
                limit = self.max_queue or 4 * self.max_slots
                ages = sorted((now - r.t_enq) * 1e3 for r in waitlist)
                age_p95 = ages[max(0, int(len(ages) * 0.95) - 1)] if ages else 0.0
                headroom = self._headroom()
                bo.update(depth_frac=depth / limit, age_p95_ms=age_p95,
                          hbm_headroom_frac=headroom, now=now)
                if bo.level == SHED_ONLY and before < SHED_ONLY:
                    if rec is not None:
                        rec.dump("shed_only_entry",
                                 extra={"depth": depth, "age_p95_ms": round(age_p95, 1),
                                        "hbm_headroom_frac": headroom})
                    # swap-don't-shed on the incident edge: park the
                    # youngest streams of the lowest class on the host tier
                    # so the survivors keep full decode width; they resume
                    # once the level drops below SHED_ONLY
                    target = bo.suspend_target(self.max_slots)
                    while suspend_on:
                        live = active()
                        if len(live) <= target:
                            break
                        victim = min(live, key=lambda i: (self._slots[i].rank,
                                                          -self._slots[i].t_admit))
                        if not suspend_slot(victim, "brownout"):
                            break
            if tier is not None:
                # proactive demotion: keep ~demote_free_frac of the pool free
                # by demoting cold cache chunks between bursts, so admits
                # stop paying the reclaim at the worst moment
                floor_blocks = int(pool.n_blocks * tier.demote_free_frac)
                if pool.free_blocks < floor_blocks:
                    pc.reclaim(floor_blocks - pool.free_blocks, demote=True)
            if waitlist and any(r.deadline is not None for r in waitlist):
                kept = []
                for r in waitlist:
                    left = None if r.deadline is None else r.deadline - now
                    if left is None or (left > 0 and self._estimate_serve_s(r) <= left):
                        kept.append(r)
                        continue
                    waited_ms = (now - r.t_enq) * 1e3
                    self.stats.record_shed("deadline", waited_ms=waited_ms)
                    self.tenant_stats.record_shed(r.tenant)
                    msg = (
                        f"deadline infeasible (~{self._estimate_serve_s(r) * 1e3:.0f} ms "
                        f"needed, {left * 1e3:.0f} ms left) "
                        f"(shed_cause=deadline); skipped prefill; "
                        if left > 0
                        else f"deadline expired after {waited_ms:.0f} ms "
                        f"queued (shed_cause=deadline); "
                    )
                    r.emit("err", BatcherOverloaded(msg + "retry on another worker"))
                waitlist[:] = kept
                self._wl_len = len(waitlist)
            for r in self._slots:
                if (isinstance(r, _Request) and r.deadline is not None
                        and not r.cancelled and now > r.deadline):
                    r.deadline_hit = True
                    r.cancelled = True
                    r.emit("err", BatcherOverloaded(
                        f"deadline exceeded mid-decode after {r.generated} "
                        f"tokens (shed_cause=deadline); retry on another worker"))
            if self._suspended:
                # a parked slot's clock keeps running: an expired one fails
                # here with the same retryable cause (it holds no blocks),
                # a cancelled one is dropped
                kept_s = []
                for srec in self._suspended:
                    r = srec.req
                    if r.cancelled:
                        self._ledger_finalize(r, "deadline_abort" if r.deadline_hit
                                              else "cancelled")
                        self.stats.record_cancel("active")
                    elif r.deadline is not None and now > r.deadline:
                        r.deadline_hit = True
                        self.stats.record_shed("deadline", waited_ms=(now - r.t_enq) * 1e3)
                        self._suspend_stats["suspended_deadline_expired"] += 1
                        self._ledger_finalize(r, "deadline_abort")
                        self.tenant_stats.record_shed(r.tenant)
                        r.emit("err", BatcherOverloaded(
                            f"deadline exceeded while suspended after {r.generated} "
                            f"tokens (shed_cause=deadline); retry on another worker"))
                    else:
                        kept_s.append(srec)
                self._suspended = kept_s
            if len(waitlist) > 1:
                # deficit round-robin over tenants, prompt tokens as cost,
                # class (or key) weight as share; one tenant keeps FIFO
                waitlist[:] = self._drr.order(
                    waitlist, tenant_of=lambda r: r.tenant,
                    cost_of=lambda r: len(r.prompt_ids), weight_of=lambda r: r.drr_weight)
                # the premium depth grace at submit can leave the queue over
                # its bound: displace the excess from the back of the DRR
                # order, lowest class first
                limit = bo.effective_queue_limit(self.max_queue) if bo is not None \
                    else self.max_queue
                if limit and len(waitlist) > limit:
                    order = {id(r): i for i, r in enumerate(waitlist)}
                    victims = sorted(waitlist, key=lambda r: (r.rank, -order[id(r)]))
                    vset = {id(r) for r in victims[: len(waitlist) - limit]}
                    for r in waitlist:
                        if id(r) in vset:
                            self.stats.record_shed("fair_share",
                                                   waited_ms=(now - r.t_enq) * 1e3)
                            self.tenant_stats.record_shed(r.tenant)
                            r.emit("err", BatcherOverloaded(
                                "displaced by weighted fair share "
                                "(shed_cause=fair_share); retry on another worker"))
                    waitlist[:] = [r for r in waitlist if id(r) not in vset]
            self._wl_len = len(waitlist)

        def age_sweep() -> None:
            """Waiters still slot-starved after admission had its chance and
            older than the bound are shed with an honest error instead of
            queueing invisibly."""
            if not (self.max_queue_age_ms and waitlist):
                return
            now = time.monotonic()
            kept = []
            for r in waitlist:
                waited_ms = (now - r.t_enq) * 1e3
                if waited_ms > self.max_queue_age_ms:
                    self.stats.record_shed("age", waited_ms=waited_ms)
                    self.tenant_stats.record_shed(r.tenant)
                    r.emit("err", BatcherOverloaded(
                        f"shed after {waited_ms:.0f} ms queued "
                        f"(> {self.max_queue_age_ms:.0f} ms bound) "
                        f"(shed_cause=age); retry on another worker"))
                else:
                    kept.append(r)
            waitlist[:] = kept
            self._wl_len = len(waitlist)

        while True:
            self.heartbeat = time.monotonic()  # supervisor liveness stamp
            if _faults.ACTIVE is not None:  # chaos harness; off ⇒ one attr read
                f = _faults.ACTIVE.check(_faults.PUMP)
                if f is not None and f.kind == "raise":
                    raise f.exception()
            act = active()
            self.stats.peak_active = max(self.stats.peak_active, len(act))
            # suspended slots keep their deadline clocks running, so with
            # any parked the idle wait becomes a bounded poll; when a resume
            # is possible now, no wait at all
            bo = self.brownout
            can_resume = bool(self._suspended and None in self._slots
                              and (bo is None or bo.level < SHED_ONLY))
            block = not act and not waitlist and not inflight and not can_resume
            poll_s = 0.05 if (block and self._suspended) else None
            first_intake = block
            while True:
                try:
                    item = self._inbox.get(block=block, timeout=poll_s)
                except _queue.Empty:
                    break
                block = False
                if item is None:
                    self._drain_all("shutdown", waitlist)
                    return
                if not take(item):
                    continue
                waitlist.append(item)
                self._wl_len = len(waitlist)
                if first_intake and coalesce_s > 0:
                    # the batcher was idle and one request just arrived:
                    # concurrent arrivals are a few scheduler ticks apart,
                    # and a short wait admits them as one batch
                    first_intake = False
                    deadline = time.monotonic() + coalesce_s
                    while (left := deadline - time.monotonic()) > 0:
                        try:
                            nxt = self._inbox.get(timeout=left)
                        except _queue.Empty:
                            break
                        if nxt is None:
                            self._drain_all("shutdown", waitlist)
                            return
                        if take(nxt):
                            waitlist.append(nxt)
                            self._wl_len = len(waitlist)
            drain_cancels()
            overload_tick(time.monotonic())
            # parked slots are older work that already has its first
            # tokens: they resume before new waiters are admitted
            resume_suspended()
            admit_waiters()
            age_sweep()
            bo = self.brownout
            try:
                # an admit's first token is read back before the next burst
                # is queued behind it, so TTFT does not wait a whole burst
                if any(rec[0] == "admit" for rec in inflight):
                    pump(0)
                if ext_live():
                    # pump(0) first, so an ext admit's rewind lands before
                    # its first masked step; after, so the DFA state moves
                    # before the next mask is built
                    pump(0)
                    decode_ext_once()
                    pump(0)
                elif (spec is not None and 0 < len(active()) <= spec.max_active
                      and not (bo is not None and bo.pause_spec)):
                    # low occupancy: drain (proposals read the whole
                    # history), verify, drain again (host pos catches up at
                    # the readback); a plain burst when nothing drafted
                    pump(0)
                    if spec_once():
                        pump(0)
                    else:
                        decode_once()
                        pump()
                else:
                    decode_once()
                    pump()
            except Exception as e:  # noqa: BLE001 — the pool may be half written
                log.exception("decode dispatch failed")
                reset_after_failed_dispatch(e)

    def _deliver(self, req: _Request, tok_id: int, logprob: float | None = None,
                 top_ids: list | None = None, top_lps: list | None = None) -> str | None:
        """Push one token; returns the end reason when the request just
        finished (the caller frees the slot, then emits the end). A
        ``want_logprobs`` request receives ``(tok, logprob, top_ids,
        top_logprobs)`` tuples (the ext readback supplies the fields)."""
        if tok_id in req.sp.stop_ids:
            if req.trace is not None:
                req.trace.mark("decode_done")
            return "stop"
        req.generated += 1
        self.stats.tokens += 1
        if req.generated == 1:
            # the first token closes both latency halves: TTFT (enqueue ->
            # token) and prefill (admit dispatch -> token)
            now = time.monotonic()
            self.stats.ttft_ms.record((now - req.t_enq) * 1e3)
            if req.t_admit:
                self.stats.prefill_ms.record((now - req.t_admit) * 1e3)
                self._note_prefill_rate(len(req.prompt_ids), now - req.t_admit)
            if req.trace is not None:
                req.trace.mark("first_token", now)
        if req.want_logprobs:
            req.emit("tok", (tok_id, logprob, top_ids, top_lps))
        else:
            req.emit("tok", tok_id)
        req.emitted.append(int(tok_id))
        if req.generated >= req.sp.max_tokens or req.pos + 1 >= self.max_seq:
            if req.trace is not None:
                req.trace.mark("decode_done")
            return "length"
        return None

    def _drain_all(self, reason: str, waitlist: list[_Request] = ()) -> None:
        err = self._stop_error
        self._wl_len = 0
        self._slot_view = {}

        def end(req: _Request) -> None:
            if err is None:
                req.emit("end", reason)
            else:
                req.emit("err", BatcherStopped(err))

        for req in waitlist:
            end(req)
        if isinstance(waitlist, list):
            waitlist.clear()
        for i, req in enumerate(self._slots):
            if isinstance(req, _Request):
                # what streamed before the shutdown was served; the ledger
                # keeps its tokens so goodput stays honest across drains
                self._ledger_finalize(req, "served")
                end(req)
            self._slots[i] = None
        for rec in self._suspended:
            # parked streams end like active slots: what streamed before
            # was served, the rest retries elsewhere
            self._ledger_finalize(rec.req, "served")
            end(rec.req)
        self._suspended = []
        while True:
            try:
                req = self._inbox.get_nowait()
            except _queue.Empty:
                return
            if req is not None:
                end(req)
