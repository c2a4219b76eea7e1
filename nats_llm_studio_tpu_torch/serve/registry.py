"""TorchRegistry: the model lifecycle -> loaded engines, for the port's
worker.

Port of ``nats_llm_studio_tpu/serve/registry.py``: ``TorchRegistry`` keeps
``LocalRegistry``'s lifecycle over a ``store/manager.py`` ``ModelStore``
(the ``<models_dir>/<publisher>/<name>/*.gguf`` cache plus the Object Store
bucket): ``list_models``, ``pull``, ``delete`` (unload first, then remove
the directory), ``sync_from_bucket`` and ``get_engine`` behind device-memory
admission (``_admit_hbm``): a load is priced before it touches the card
(``parallel/memory.py estimate_load_bytes``), another engine's prefix cache
is dropped first (``_shrink_prefix_caches``), then idle engines are evicted
least recently used first to make room, and a load that still does not fit
is refused with an error instead of running the card out of memory in the
middle of serving another model. Every batcher gets the prefix cache
(``PREFIX_CACHE_BLOCKS``, 64 blocks by default; ``PREFIX_CACHE=0`` turns
it off) and speculative decoding (``SPEC_DECODE_K``, 6 drafts by default,
at up to ``SPEC_DECODE_MAX_ACTIVE`` = 4 live slots; ``SPEC_DECODE=0``
turns it off). ``TorchChatEngine`` keeps ``JaxChatEngine``'s ``chat`` /
``chat_stream`` / ``_completion`` reply shapes over the port's batcher,
with its OpenAI extensions: ``response_format`` (schema-constrained
decoding, ``serve/constrain.py``), ``logprobs`` / ``top_logprobs`` and
``n`` choices (siblings admitted over the prefix cache), validated with the
reference's error strings.

Overload and supervision, as the reference's: every batcher gets the admit
queue bounds (the serve command passes ``WorkerConfig``'s
``ADMIT_QUEUE_LIMIT``, 4 x the slots when unset, and ``ADMIT_MAX_AGE_MS``,
30 s), the brownout controller (``BROWNOUT``, on;
``BROWNOUT_*`` thresholds) fed by ``_hbm_headroom_frac`` (the budget less
what the admission ledger has committed, from host state: no CUDA call),
the deadline floor (``DEADLINE_MIN_TOKENS``), the DRR quantum
(``QOS_QUANTUM_TOKENS``) and a flight recorder (``OBS_RECORDER``,
``OBS_RECORDER_INTERVAL_MS``, ``OBS_DUMP_DIR``). ``TorchChatEngine`` passes
the worker's trace, deadline, tenant and priority through ``submit``.
``restart_engine`` (the worker's supervisor calls it) unloads a crashed or
hung engine and reloads it after a capped backoff; more than
``max_restarts`` crashes inside ``restart_window_s``, or one CUDA error that
leaves the context unusable, poison the model until ``delete`` or ``pull``
resets it. On the card ``_load`` builds the kernels before the batcher
starts, so the first prefill never stalls the owner loop on ``nvcc``.
``set_draining`` (the worker's drain) stops ``restart_engine`` from
reviving an engine the drain is stopping.

The HBM ledger (``obs/roofline.py HbmLedger``), ticked by every flight
recorder frame: the weights and pool, the prefix cache's logits rows (from
the estimate ``_admit_hbm`` commits) and ``HBM_WORKSPACE_SLACK_BYTES``
against ``torch.cuda.memory_stats``; an ``hbm_drift`` event when the
unexplained bytes keep growing. Inert on the CPU. ``EFFICIENCY=0`` turns it
off.

The paged pool and swap-don't-shed, as the reference's: ``KV_BLOCK_TOKENS``
(16) and ``KV_POOL_BLOCKS`` (0 = every slot at max_seq plus the prefix
budget) size each batcher's pool, and the admission estimate prices that
pool. With ``KV_HOST_POOL_BYTES`` > 0 (256 MiB) and a prefix cache, each
engine gets a ``KVTierManager`` (the host tier, ``KV_PROMOTE_CHUNKS``,
``KV_DEMOTE_FREE_FRAC``, ``KV_SPILL_MAX_OBJECTS``) over the worker's
``kv_spill_factory`` (an Object Store spill, late-bound by the worker);
its bytes are host memory, outside the admission ledger. Batchers suspend
slots (``KV_SUSPEND``) and preempt for higher classes (``QOS_PREEMPT``);
the batcher's ``stop`` closes the tier on evict, delete and restart.

Not ported yet: the mesh gate and precompile at pull time, and the
restart's warm import of spilled prefixes (``warm_exports`` into
``import_prefix_blocks``), which waits for the KV import.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import replace as dc_replace
from pathlib import Path
from typing import Any, AsyncIterator

import torch

from ..device import default_dtype, resolve_device
from ..engine.generator import GenStats, SamplingParams
from ..gguf.reader import is_split_shard, open_gguf
from ..gguf.tokenizer import GGUFTokenizer
from ..models.config import ModelConfig, check_kv_quant
from ..models.llama import ensure_lm_head, load_params_from_gguf
from ..parallel.memory import estimate_load_bytes
from ..store.manager import ModelStore, StoreError
from ..obs import FlightRecorder, LogHistogram
from ..obs import emit as obs_emit
from ..obs.roofline import HbmLedger, _default_bytes_in_use, efficiency_enabled
from ..utils.nuid import next_nuid
from .api import ChatEngine, EngineError, ModelNotFound, Registry
from . import constrain as constrain_mod
from .batcher import (
    LOGPROBS_K,
    BatcherOverloaded,
    BatcherStopped,
    ContinuousBatcher,
    cuda_context_lost,
)
from .brownout import BrownoutConfig
from .qos import ANON_TENANT, DEFAULT_PRIORITY, parse_priority_header
from .constrain import ConstraintError, compile_token_dfa, validate_response_format
from .template import chat_renderer, stop_token_ids

log = logging.getLogger(__name__)


def _prefix_cache_blocks_env(default: int = 64) -> int:
    """Per-engine prefix-cache budget in pool blocks (serve/prefix_cache.py).
    ``PREFIX_CACHE=0`` (or false/off) is the hard off-switch; otherwise
    ``PREFIX_CACHE_BLOCKS`` sizes the radix cache (0 also disables)."""
    if os.environ.get("PREFIX_CACHE", "").strip().lower() in ("0", "false", "off"):
        return 0
    env = os.environ.get("PREFIX_CACHE_BLOCKS", "").strip()
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            log.warning("ignoring non-integer PREFIX_CACHE_BLOCKS=%r", env)
    return default


def _env_int(name: str, default: int, lo: int = 0) -> int:
    env = os.environ.get(name, "").strip()
    if env:
        try:
            return max(lo, int(env))
        except ValueError:
            log.warning("ignoring non-integer %s=%r", name, env)
    return default


def _kv_tier_policy_env() -> tuple[int, float, int]:
    """(promote_chunks, demote_free_frac, spill_max_objects): the
    KVTierManager policy knobs (``KV_PROMOTE_CHUNKS``,
    ``KV_DEMOTE_FREE_FRAC``, ``KV_SPILL_MAX_OBJECTS``)."""
    frac = min(max(_env_float("KV_DEMOTE_FREE_FRAC", 0.10), 0.0), 0.9)
    return (_env_int("KV_PROMOTE_CHUNKS", 64, lo=1), frac,
            _env_int("KV_SPILL_MAX_OBJECTS", 512, lo=1))


def _spec_decode_env(default_k: int = 6) -> tuple[int, int]:
    """(spec_decode_k, spec_max_active) from the env (serve/spec.py).
    ``SPEC_DECODE=0`` (or false/off) is the hard off-switch; otherwise
    ``SPEC_DECODE_K`` sizes the draft (0 also disables) and
    ``SPEC_DECODE_MAX_ACTIVE`` bounds the occupancy at which verify
    dispatches still run."""
    k = default_k
    if os.environ.get("SPEC_DECODE", "").strip().lower() in ("0", "false", "off"):
        k = 0
    else:
        env = os.environ.get("SPEC_DECODE_K", "").strip()
        if env:
            try:
                k = max(0, int(env))
            except ValueError:
                log.warning("ignoring non-integer SPEC_DECODE_K=%r", env)
    max_active = 4
    env = os.environ.get("SPEC_DECODE_MAX_ACTIVE", "").strip()
    if env:
        try:
            max_active = max(1, int(env))
        except ValueError:
            log.warning("ignoring non-integer SPEC_DECODE_MAX_ACTIVE=%r", env)
    return k, max_active


def _env_float(name: str, default: float) -> float:
    env = os.environ.get(name, "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            log.warning("ignoring non-numeric %s=%r", name, env)
    return default


def _brownout_env(enabled: bool | None = None) -> BrownoutConfig | None:
    """Adaptive-brownout config from the env (serve/brownout.py), or None
    when disabled. ``BROWNOUT=0`` (or false/off) is the hard off-switch
    (default on); the BROWNOUT_* threshold knobs tune the hysteresis."""
    if enabled is None:
        enabled = os.environ.get("BROWNOUT", "").strip().lower() not in ("0", "false", "off")
    if not enabled:
        return None
    return BrownoutConfig(
        depth_hi=_env_float("BROWNOUT_DEPTH_HI", 0.75),
        depth_lo=_env_float("BROWNOUT_DEPTH_LO", 0.40),
        age_hi_ms=_env_float("BROWNOUT_AGE_HI_MS", 1500.0),
        age_lo_ms=_env_float("BROWNOUT_AGE_LO_MS", 500.0),
        hbm_lo_frac=_env_float("BROWNOUT_HBM_LO", 0.05),
        dwell_s=_env_float("BROWNOUT_DWELL_S", 2.0),
    )


def _deadline_min_tokens_env(default: int = 1) -> int:
    """Feasibility floor for deadline-aware admission: a request that cannot
    deliver this many tokens before its deadline skips prefill and is shed
    retryably (DEADLINE_MIN_TOKENS, default 1 = just the first token)."""
    env = os.environ.get("DEADLINE_MIN_TOKENS", "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            log.warning("ignoring non-integer DEADLINE_MIN_TOKENS=%r", env)
    return default


class TorchChatEngine(ChatEngine):
    """One loaded model: tokenizer + continuous batcher."""

    def __init__(self, model_id: str, batcher: ContinuousBatcher,
                 tokenizer: GGUFTokenizer, cfg: ModelConfig, meta: dict[str, Any],
                 quantization: str = ""):
        self.model_id = model_id
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.meta = meta
        self.quantization = quantization
        self._stop_ids = stop_token_ids(tokenizer)
        self._render = chat_renderer(meta)

    def _sampling(self, payload: dict) -> SamplingParams:
        return SamplingParams(
            temperature=float(payload.get("temperature", 0.8)),
            top_p=float(payload.get("top_p", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            max_tokens=int(payload.get("max_tokens") or payload.get("max_completion_tokens") or 256),
            seed=payload.get("seed"),
            stop_ids=self._stop_ids,
        )

    def _encode_prompt(self, payload: dict) -> list[int]:
        messages = payload.get("messages") or []
        return self.tokenizer.encode(self._render(messages, add_generation_prompt=True))

    def _parse_ext(self, payload: dict):
        """The engine-layer OpenAI extensions of a payload: (token_dfa,
        want_logprobs, top_logprobs, n_choices). Raises EngineError with a
        client-facing message on bad values."""
        try:
            schema = validate_response_format(payload.get("response_format"))
        except ValueError as e:
            raise EngineError(f"invalid response_format: {e}") from e
        dfa = None
        if schema is not None:
            if not constrain_mod.enabled():
                raise EngineError(
                    "invalid response_format: constrained decoding is "
                    "disabled on this worker (CONSTRAIN=0)"
                )
            try:
                dfa = compile_token_dfa(schema, self.tokenizer, self.cfg.vocab_size,
                                        eos_ids=self._stop_ids)
            except ConstraintError as e:
                raise EngineError(f"invalid response_format: {e}") from e
        try:
            top_n = int(payload.get("top_logprobs") or 0)
            n_choices = int(payload.get("n") or 1)
        except (TypeError, ValueError) as e:
            raise EngineError(f"invalid request: {e}") from e
        if not 0 <= top_n <= LOGPROBS_K:
            raise EngineError(
                f"invalid top_logprobs: must be between 0 and {LOGPROBS_K}"
            )
        want_lp = bool(payload.get("logprobs")) or top_n > 0
        if not 1 <= n_choices <= self.batcher.max_slots:
            raise EngineError(
                f"invalid n: must be between 1 and {self.batcher.max_slots}"
            )
        return dfa, want_lp, top_n, n_choices

    def _lp_entry(self, item: tuple, top_n: int) -> dict:
        """One OpenAI ``logprobs.content`` element from a batcher
        (tok, logprob, top_ids, top_logprobs) tuple."""
        tok, lp, top_ids, top_lps = item
        s = self.tokenizer.decode([int(tok)])
        entry: dict[str, Any] = {
            "token": s,
            "logprob": float(lp) if lp is not None else 0.0,
            "bytes": list(s.encode("utf-8")),
            "top_logprobs": [],
        }
        if top_n and top_ids:
            for tid, tlp in list(zip(top_ids, top_lps))[:top_n]:
                ts = self.tokenizer.decode([int(tid)])
                entry["top_logprobs"].append({
                    "token": ts,
                    "logprob": float(tlp),
                    "bytes": list(ts.encode("utf-8")),
                })
        return entry

    def _completion(self, text: str, n_prompt: int, n_out: int, finish: str,
                    stats=None, logprobs=None) -> dict:
        """OpenAI-style body with LM Studio's stats block."""
        choice: dict[str, Any] = {
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish,
        }
        if logprobs is not None:
            choice["logprobs"] = logprobs
        out: dict[str, Any] = {
            "id": f"chatcmpl-{next_nuid()[:12].lower()}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_id,
            "choices": [choice],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_out,
                "total_tokens": n_prompt + n_out,
            },
        }
        if stats is not None:
            out["stats"] = {
                "tokens_per_second": round(stats.decode_tok_s, 2),
                "time_to_first_token": round(stats.ttft_s, 4),
                "generation_time": round(stats.total_s, 4),
            }
        return out

    async def chat(self, payload: dict) -> dict:
        parts = []
        final = None
        async for chunk in self.chat_stream(payload):
            if chunk.get("object") == "chat.completion":
                final = chunk
            else:
                parts.append(chunk["choices"][0]["delta"].get("content", ""))
        return final if final is not None else self._completion("".join(parts), 0, 0, "stop")

    async def _stream_one(self, index: int, prompt_ids: list[int], sp: SamplingParams,
                          trace, deadline, dfa, want_lp: bool, top_n: int,
                          result: dict, qos: tuple | None = None) -> AsyncIterator[dict]:
        """Drive ONE choice through the batcher: yields chunk dicts tagged
        with choice ``index`` and fills ``result`` with the aggregate (text,
        finish, stats, logprobs) on a clean completion."""
        stats = GenStats(prompt_tokens=len(prompt_ids))
        t0 = time.perf_counter()
        toks: list[int] = []
        lp_entries: list[dict] = []
        pending_lp: list[dict] = []  # entries held with incomplete UTF-8 text
        emitted = 0
        end_info: dict = {}
        tenant, priority, weight = qos or (ANON_TENANT, DEFAULT_PRIORITY, 0.0)
        async for tok_batch in self.batcher.submit_batched(
            prompt_ids, sp, info=end_info, trace=trace, deadline=deadline, constrain=dfa,
            want_logprobs=want_lp, top_logprobs=top_n, tenant=tenant, priority=priority,
            weight=weight,
        ):
            if not toks:
                stats.ttft_s = time.perf_counter() - t0
            if want_lp:
                # ext deliveries are (tok, logprob, top_ids, top_lps) tuples
                entries = [self._lp_entry(t, top_n) for t in tok_batch]
                lp_entries.extend(entries)
                pending_lp.extend(entries)
                tok_batch = [t[0] for t in tok_batch]
            toks.extend(tok_batch)
            stats.completion_tokens += len(tok_batch)
            # emit only completed UTF-8 text
            text = self.tokenizer.decode(toks)
            if len(text) > emitted and not text.endswith("�"):
                choice: dict[str, Any] = {
                    "index": index,
                    "delta": {"role": "assistant", "content": text[emitted:]},
                    "finish_reason": None,
                }
                if want_lp:
                    choice["logprobs"] = {"content": pending_lp}
                    pending_lp = []
                yield {"object": "chat.completion.chunk", "model": self.model_id,
                       "choices": [choice]}
                emitted = len(text)
        stats.total_s = time.perf_counter() - t0
        text = self.tokenizer.decode(toks)
        if len(text) > emitted or pending_lp:
            # flush text held back by the incomplete-UTF-8 guard
            choice = {
                "index": index,
                "delta": {"role": "assistant", "content": text[emitted:]},
                "finish_reason": None,
            }
            if want_lp:
                choice["logprobs"] = {"content": pending_lp}
            yield {"object": "chat.completion.chunk", "model": self.model_id,
                   "choices": [choice]}
        reason = end_info.get("finish_reason", "stop")
        if reason == "shutdown" and not toks:
            raise EngineError("worker draining, retry on another worker")
        result.update(
            text=text,
            n_out=len(toks),
            finish=reason if reason in ("length", "shutdown") else "stop",
            stats=stats,
            logprobs={"content": lp_entries} if want_lp else None,
        )

    async def chat_stream(self, payload: dict) -> AsyncIterator[dict]:
        # what the worker injects from the request's headers, popped so the
        # payload stays the verbatim OpenAI body: the trace the batcher
        # stamps, the monotonic deadline, the tenant and priority class
        trace = payload.pop("_trace", None)
        deadline = payload.pop("_deadline", None)
        tenant = str(payload.pop("_tenant", None) or ANON_TENANT)
        priority, weight = parse_priority_header(payload.pop("_priority", None))
        qos = (tenant, priority, weight)
        prompt_ids = self._encode_prompt(payload)
        sp = self._sampling(payload)
        dfa, want_lp, top_n, n_choices = self._parse_ext(payload)
        results = [dict() for _ in range(n_choices)]
        try:
            if n_choices == 1:
                async for chunk in self._stream_one(0, prompt_ids, sp, trace, deadline, dfa,
                                                    want_lp, top_n, results[0], qos=qos):
                    yield chunk
            else:
                async for chunk in self._stream_n(prompt_ids, sp, trace, deadline, dfa, want_lp,
                                                  top_n, results, qos=qos):
                    yield chunk
        except BatcherOverloaded as e:
            raise EngineError(f"overloaded: {e}") from e
        except BatcherStopped as e:
            raise EngineError(str(e)) from e
        except ValueError as e:  # e.g. prompt longer than max_seq
            raise EngineError(str(e)) from e
        r0 = results[0]
        out = self._completion(r0["text"], len(prompt_ids), sum(r["n_out"] for r in results),
                               r0["finish"], r0["stats"], logprobs=r0.get("logprobs"))
        for i, r in enumerate(results[1:], start=1):
            choice: dict[str, Any] = {
                "index": i,
                "message": {"role": "assistant", "content": r["text"]},
                "finish_reason": r["finish"],
            }
            if r.get("logprobs") is not None:
                choice["logprobs"] = r["logprobs"]
            out["choices"].append(choice)
        yield out

    async def _stream_n(self, prompt_ids, sp, trace, deadline, dfa, want_lp, top_n,
                        results, qos: tuple | None = None) -> AsyncIterator[dict]:
        """n>1 fan-out: each choice is its own batcher request. Choice 0
        launches alone; the rest launch after its first chunk, when choice
        0's admit has put the prompt's full chunks into the prefix cache, so
        the siblings admit over the cached blocks (shared by refcount)
        instead of n prefills. Chunks of all choices interleave on one
        stream, tagged by ``choices[0].index``."""
        done = object()
        queue: asyncio.Queue = asyncio.Queue()
        started = asyncio.Event()

        def sp_for(i: int) -> SamplingParams:
            # distinct seeds keep seeded choices distinct and replayable
            if i == 0 or sp.seed is None:
                return sp
            return dc_replace(sp, seed=sp.seed + i)

        async def drive(i: int) -> None:
            try:
                async for chunk in self._stream_one(i, prompt_ids, sp_for(i),
                                                    trace if i == 0 else None, deadline,
                                                    dfa, want_lp, top_n, results[i], qos=qos):
                    await queue.put(chunk)
                    if i == 0:
                        started.set()
            except Exception as e:  # noqa: BLE001 — re-raised by the merger
                results[i]["error"] = e
            finally:
                if i == 0:
                    started.set()
                await queue.put(done)

        tasks = [asyncio.ensure_future(drive(0))]
        try:
            await started.wait()
            tasks += [asyncio.ensure_future(drive(i)) for i in range(1, len(results))]
            finished = 0
            while finished < len(results):
                item = await queue.get()
                if item is done:
                    finished += 1
                    continue
                yield item
        finally:
            for t in tasks:
                t.cancel()
        for r in results:
            if "error" in r:
                # a missing choice makes the whole completion wrong
                raise r["error"]

    def info(self) -> dict:
        return {
            "id": self.model_id,
            "object": "model",
            "type": "llm",
            "publisher": self.model_id.split("/")[0] if "/" in self.model_id else "local",
            "arch": self.cfg.arch,
            "quantization": self.quantization,
            "state": "loaded",
            "max_context_length": self.cfg.max_seq_len,
            "loaded_context_length": self.batcher.max_seq,
            "batch_slots": self.batcher.max_slots,
            "kv_quant": self.cfg.kv_quant,
        }

    async def unload(self) -> None:
        await asyncio.to_thread(self.batcher.stop)


def card_budget_bytes(device: torch.device) -> int | None:
    """What the allocator can reach on ``device``: the card's free bytes
    plus what PyTorch's caching allocator already holds (its total would
    also count the CUDA context). None on the CPU, which has no budget."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free) + int(torch.cuda.memory_reserved(device))


class TorchRegistry(Registry):
    """Model lifecycle over a ``ModelStore`` + PyTorch engines.

    ``device`` defaults to "cuda" and raises when no card is visible; the
    CPU is used only when the caller passes ``device="cpu"``. The compute
    dtype follows the device: bf16 on the card, f32 on the CPU.
    ``kv_quant`` ("none" or "int8", ``TPU_KV_QUANT``) picks the KV cache's
    storage for every model loaded.

    The admission budget is ``TPU_HBM_BUDGET_BYTES`` when that is a positive
    integer (read at each admission, as the reference does); otherwise, on
    the card, what the allocator could reach when the registry was built
    (``card_budget_bytes``); on the CPU, no budget and no check.

    ``prefix_cache_blocks`` is each batcher's prefix-cache budget in pool
    blocks; None reads ``PREFIX_CACHE`` / ``PREFIX_CACHE_BLOCKS``
    (``_prefix_cache_blocks_env``). ``spec_decode_k`` and
    ``spec_max_active`` are each batcher's speculative-decoding draft length
    (0 = off) and occupancy bound; None reads ``SPEC_DECODE`` /
    ``SPEC_DECODE_K`` / ``SPEC_DECODE_MAX_ACTIVE`` (``_spec_decode_env``).

    The overload knobs go to every batcher: ``admit_queue_limit`` and
    ``admit_max_age_ms`` (0 = off; the serve command passes
    ``ADMIT_QUEUE_LIMIT`` / ``ADMIT_MAX_AGE_MS``), ``brownout`` (None reads ``BROWNOUT`` and the
    ``BROWNOUT_*`` thresholds), ``deadline_min_tokens`` (None reads
    ``DEADLINE_MIN_TOKENS``), ``qos_quantum_tokens`` (None reads
    ``QOS_QUANTUM_TOKENS``) and the flight recorder's ``obs_recorder``,
    ``obs_recorder_interval_ms``, ``obs_dump_dir`` (None reads
    ``OBS_RECORDER`` / ``OBS_RECORDER_INTERVAL_MS`` / ``OBS_DUMP_DIR``).
    ``restart_backoff_s``, ``restart_backoff_max_s``, ``max_restarts`` and
    ``restart_window_s`` shape ``restart_engine``."""

    def __init__(self, store: ModelStore, device: str = "cuda",
                 max_seq_len: int | None = None, max_batch_slots: int = 8,
                 kv_quant: str = "none", prefix_cache_blocks: int | None = None,
                 spec_decode_k: int | None = None, spec_max_active: int | None = None,
                 admit_queue_limit: int = 0, admit_max_age_ms: float = 0.0,
                 restart_backoff_s: float = 0.5, restart_backoff_max_s: float = 30.0,
                 max_restarts: int = 3, restart_window_s: float = 120.0,
                 brownout: bool | None = None, deadline_min_tokens: int | None = None,
                 obs_recorder: bool | None = None,
                 obs_recorder_interval_ms: float | None = None,
                 obs_dump_dir: str | None = None, worker_id: str = "",
                 qos_quantum_tokens: int | None = None, kv_block_tokens: int | None = None,
                 kv_pool_blocks: int | None = None, kv_host_pool_bytes: int | None = None,
                 kv_spill_factory=None, kv_suspend: bool | None = None,
                 qos_preempt: bool | None = None):
        self.kv_quant = check_kv_quant(kv_quant)
        self.prefix_cache_blocks = (prefix_cache_blocks if prefix_cache_blocks is not None
                                    else _prefix_cache_blocks_env())
        env_k, env_ma = _spec_decode_env()
        self.spec_decode_k = spec_decode_k if spec_decode_k is not None else env_k
        self.spec_max_active = spec_max_active if spec_max_active is not None else env_ma
        # the paged pool: tokens a block (the batcher snaps it to divide the
        # serving chunk) and the population (0 = every slot at max_seq plus
        # the prefix budget)
        self.kv_block_tokens = (kv_block_tokens if kv_block_tokens is not None
                                else _env_int("KV_BLOCK_TOKENS", 16, lo=1))
        self.kv_pool_blocks = (kv_pool_blocks if kv_pool_blocks is not None
                               else _env_int("KV_POOL_BLOCKS", 0))
        # the host KV tier's budget (0 = no tier), its policy knobs and the
        # Object Store spill factory the worker binds once it has a
        # connection (None = host tier only)
        self.kv_host_pool_bytes = (kv_host_pool_bytes if kv_host_pool_bytes is not None
                                   else _env_int("KV_HOST_POOL_BYTES", 256 << 20))
        self.kv_spill_factory = kv_spill_factory
        (self.kv_promote_chunks, self.kv_demote_free_frac,
         self.kv_spill_max_objects) = _kv_tier_policy_env()
        # None: each batcher reads KV_SUSPEND / QOS_PREEMPT
        self.kv_suspend = kv_suspend
        self.qos_preempt = qos_preempt
        self.device = resolve_device(device)
        self.store = store
        self.dtype = default_dtype(self.device)
        self.max_seq_len = max_seq_len
        self.max_batch_slots = max_batch_slots
        self.card_budget_bytes = card_budget_bytes(self.device)
        self._engines: dict[str, TorchChatEngine] = {}
        self._load_lock = asyncio.Lock()
        self._requests = 0
        # admission bookkeeping: estimated device bytes committed by each
        # loaded engine, and last-use times for the eviction order. An
        # engine targeted within evict_grace_s is never evicted
        # (_pick_idle_victim)
        self._hbm_committed: dict[str, int] = {}
        # the part of an engine's committed bytes its prefix cache holds
        # outside the pool (its chunk-end logits rows): what dropping that
        # cache gives back (_shrink_prefix_caches). Its blocks live in the
        # pool, which stays allocated, so they are not credited
        self._prefix_bytes: dict[str, int] = {}
        # the resident part of each committed estimate (params + pool): what
        # a loaded engine holds between dispatches, priced by the HBM ledger
        self._hbm_resident: dict[str, int] = {}
        self._last_used: dict[str, float] = {}
        self.evict_grace_s = 1.0
        # overload bounds handed to every batcher (0 = off); the serve
        # command passes WorkerConfig's ADMIT_QUEUE_LIMIT / ADMIT_MAX_AGE_MS
        self.admit_queue_limit = admit_queue_limit
        self.admit_max_age_ms = admit_max_age_ms
        self.brownout_cfg = _brownout_env(brownout)
        self.deadline_min_tokens = (deadline_min_tokens if deadline_min_tokens is not None
                                    else _deadline_min_tokens_env())
        self.qos_quantum_tokens = (qos_quantum_tokens if qos_quantum_tokens is not None
                                   else int(_env_float("QOS_QUANTUM_TOKENS", 256)))
        # engine supervision: capped exponential backoff between restarts;
        # more than max_restarts crashes inside restart_window_s poison the
        # model (get_engine refuses, retryably, until delete or pull)
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self._crash_times: dict[str, list[float]] = {}
        self._poisoned: dict[str, str] = {}  # model_id -> reason
        self.engine_restarts_total = 0
        # taken from crashed batchers' stats at restart, so the total
        # outlives the batcher object
        self.inflight_failed_retryable = 0
        self.restart_latency_ms = LogHistogram()
        # seconds the last load spent building kernels (0 when built)
        self.kernel_build_s = 0.0
        self.obs_recorder = (obs_recorder if obs_recorder is not None
                             else os.environ.get("OBS_RECORDER", "1").strip().lower()
                             not in ("0", "false", "off"))
        self.obs_recorder_interval_ms = (obs_recorder_interval_ms
                                         if obs_recorder_interval_ms is not None
                                         else _env_float("OBS_RECORDER_INTERVAL_MS", 250.0))
        self.obs_dump_dir = (obs_dump_dir if obs_dump_dir is not None
                             else os.environ.get("OBS_DUMP_DIR", "").strip())
        self.worker_id = worker_id
        # process counters merged into every recorder frame (the worker
        # adds its own); each is a host-side read
        self.recorder_counters: dict[str, Any] = {
            "engine_restarts": lambda: self.engine_restarts_total,
        }
        # HBM ledger: the admission ledger's priced components against the
        # allocator's bytes on every recorder tick. HBM_WORKSPACE_SLACK_BYTES
        # prices what the estimate leaves to transients; the ledger's
        # baseline absorbs whatever constant slack stays unpriced
        try:
            slack = int(os.environ.get("HBM_WORKSPACE_SLACK_BYTES", "0") or 0)
        except ValueError:
            slack = 0
        self.hbm_ledger = HbmLedger(
            {
                "engines": lambda: sum(self._hbm_resident.values()),
                "prefix_cache": lambda: sum(self._prefix_bytes.values()),
                "workspace_slack": lambda: slack,
            },
            bytes_in_use_fn=lambda: _default_bytes_in_use(self.device),
            emit_fn=obs_emit,
        )
        # the tick rides each recorder frame; EFFICIENCY=0 kills the plane
        if efficiency_enabled():
            self.recorder_counters["hbm_drift_bytes"] = self.hbm_ledger.tick
        # the drain flag (serve/worker.py begin_drain -> set_draining): while
        # set, restart_engine refuses to relaunch engines
        self.draining = False

    # -- Registry ------------------------------------------------------------

    async def list_models(self) -> dict:
        entries = []
        for cm in self.store.cached():
            eng = self._engines.get(cm.model_id)
            if eng is not None:
                entries.append(eng.info())
            else:
                entries.append({
                    "id": cm.model_id,
                    "object": "model",
                    "type": "llm",
                    "publisher": cm.publisher,
                    "state": "not-loaded",
                    "size_bytes": cm.size,
                })
        return {"object": "list", "data": entries}

    async def pull(self, identifier: str) -> str:
        try:
            path, transcript = await self.store.pull(identifier)
        except StoreError as e:
            raise EngineError(str(e)) from None
        # a fresh pull is the other operator reset path for a poisoned
        # model: the one the identifier names and the one whose directory
        # the files landed in (an object name or a URL is not a model id;
        # the reference resets only the identifier)
        for mid in {identifier, self._pulled_model_id(path, identifier)}:
            self._poisoned.pop(mid, None)
            self._crash_times.pop(mid, None)
        return transcript

    def _pulled_model_id(self, path, identifier: str) -> str:
        """The ``publisher/model`` cache directory a pulled file lies in."""
        try:
            rel = Path(path).resolve().relative_to(self.store.models_dir.resolve())
        except ValueError:
            return identifier
        return "/".join(rel.parts[:2])

    async def delete(self, model_id: str) -> str:
        eng = self._engines.pop(model_id, None)
        self._uncommit(model_id)
        self._last_used.pop(model_id, None)
        # operator reset path for a poisoned engine
        self._poisoned.pop(model_id, None)
        self._crash_times.pop(model_id, None)
        if eng is not None:
            await eng.unload()
            obs_emit("engine_unload", model=model_id, reason="delete")
        try:
            return self.store.delete_local(model_id)
        except StoreError as e:
            err = EngineError(str(e))
            err.dir = e.dir  # surfaced in the error envelope
            raise err from None

    async def sync_from_bucket(self, name: str, model_id: str | None = None) -> str:
        try:
            path, _ = await self.store.pull(name, model_id=model_id)
        except StoreError as e:
            raise EngineError(str(e)) from None
        return str(path)

    async def get_engine(self, model_id: str) -> ChatEngine:
        self._requests += 1
        poisoned = self._poisoned.get(model_id)
        if poisoned is not None:
            # refuse until reset; the retryable marker lets a queue-group
            # peer (whose copy may be healthy) take the retry
            raise EngineError(
                f"model {model_id} is poisoned ({poisoned}); delete or pull "
                f"it to reset — retry on another worker"
            )
        eng = self._engines.get(model_id)
        if eng is not None:
            self._last_used[model_id] = time.monotonic()
            return eng
        async with self._load_lock:
            eng = self._engines.get(model_id)
            if eng is not None:
                self._last_used[model_id] = time.monotonic()
                return eng
            cm = self.store.lookup(model_id)
            if cm is None:
                raise ModelNotFound(model_id)
            paths = [str(f) for f in cm.files]
            await self._admit_hbm(cm.model_id, paths)
            try:
                eng = await asyncio.to_thread(self._load, cm.model_id, paths)
            except BaseException:
                # a failed load must not leave phantom committed bytes that
                # refuse every later load
                self._uncommit(cm.model_id)
                raise
            self._engines[cm.model_id] = eng
            self._last_used[cm.model_id] = time.monotonic()
            return eng

    # -- device-memory admission ---------------------------------------------

    def budget_bytes(self) -> int | None:
        """The admission budget (see the class docstring)."""
        env = os.environ.get("TPU_HBM_BUDGET_BYTES", "").strip()
        if env and int(env) > 0:
            return int(env)
        return self.card_budget_bytes

    async def _admit_hbm(self, model_id: str, paths: list[str]) -> None:
        """Refuse (or free room for) a load that would exceed the budget,
        before it touches the device. The cheapest tier goes first: another
        engine's prefix cache is dropped (no unload); then idle engines are
        evicted least recently used first; an engine serving a request is
        never evicted."""
        budget = self.budget_bytes()
        if budget is None:
            return
        est = await asyncio.to_thread(self._estimate, paths)
        need, pbytes = est["total"], est["prefix"]
        self._uncommit(model_id)  # reloading: don't double count
        while sum(self._hbm_committed.values()) + need > budget:
            if self._shrink_prefix_caches(exclude=model_id):
                continue
            victim = self._pick_idle_victim()
            if victim is None:
                # an idle engine inside the eviction grace may become
                # evictable within a second: wait the remainder out rather
                # than bounce the load
                wait = self._grace_remaining_s()
                if wait is not None and wait <= 1.5:
                    await asyncio.sleep(wait + 0.05)
                    victim = self._pick_idle_victim()
            if victim is None:
                committed = sum(self._hbm_committed.values())
                raise EngineError(
                    f"insufficient device memory to load {model_id}: needs "
                    f"~{need >> 20} MiB, {committed >> 20} MiB committed to "
                    f"{sorted(self._hbm_committed)} of {budget >> 20} MiB "
                    f"budget, and no loaded engine is idle to evict"
                )
            log.info("evicting idle engine %s to fit %s", victim, model_id)
            self._uncommit(victim)
            eng = self._engines.pop(victim)
            self._last_used.pop(victim, None)
            await eng.unload()
        self._hbm_committed[model_id] = need
        self._hbm_resident[model_id] = est["params"] + est["kv_pool"]
        if pbytes:
            self._prefix_bytes[model_id] = pbytes

    def _uncommit(self, model_id: str) -> None:
        """Drop a model's entries from the admission ledger."""
        self._hbm_committed.pop(model_id, None)
        self._prefix_bytes.pop(model_id, None)
        self._hbm_resident.pop(model_id, None)

    def _shrink_prefix_caches(self, exclude: str | None = None) -> bool:
        """Reclaim device memory by dropping the least recently used
        engine's prefix cache: no unload, serving state untouched; its
        blocks go back to that engine's pool, and blocks pinned by an admit
        in flight are freed when that admit releases them. Returns True
        when committed bytes decreased, so the admit loop checks the budget
        again before it evicts a whole engine."""
        cands = [mid for mid in self._engines
                 if mid != exclude and self._prefix_bytes.get(mid, 0) > 0]
        if not cands:
            return False
        mid = min(cands, key=lambda m: self._last_used.get(m, 0.0))
        freed = self._prefix_bytes.pop(mid, 0)
        self._hbm_committed[mid] = max(0, self._hbm_committed.get(mid, 0) - freed)
        dropped = self._engines[mid].batcher.drop_prefix_cache()
        log.info("dropped %s prefix cache under memory pressure (%d blocks, ~%d KiB)",
                 mid, dropped, freed >> 10)
        return True

    @staticmethod
    def _open(paths: list[str]):
        """A reader over a model's GGUF file, or its split set."""
        split = sorted(p for p in paths if is_split_shard(p))
        return open_gguf(split[0] if split else paths[0])

    def _serving_config(self, reader) -> ModelConfig:
        return ModelConfig.from_gguf_metadata(reader.metadata).with_(
            dtype=self.dtype, kv_quant=self.kv_quant)

    def _estimate(self, paths: list[str]) -> dict[str, int]:
        """``estimate_load_bytes`` of serving this GGUF with this registry's
        settings."""
        with self._open(paths) as reader:
            cfg = self._serving_config(reader)
        return estimate_load_bytes(cfg, self.max_batch_slots, self.max_seq_len,
                                   prefix_cache_blocks=self.prefix_cache_blocks,
                                   kv_block_tokens=self.kv_block_tokens,
                                   kv_pool_blocks=self.kv_pool_blocks)

    def _estimate_load_bytes(self, paths: list[str]) -> int:
        """Device bytes of serving this GGUF with this registry's settings."""
        return self._estimate(paths)["total"]

    def _estimate_prefix_bytes(self, paths: list[str]) -> int:
        """The part of that which the prefix cache holds outside the pool
        (the estimate's ``prefix`` term: its chunk-end logits rows), which
        dropping the cache gives back."""
        return self._estimate(paths)["prefix"]

    def _hbm_headroom_frac(self) -> float | None:
        """Free fraction of the admission budget (the brownout signal), or
        None when no budget is known: the budget less what the admission
        ledger has committed. Called by every owner loop on every pass, so
        it reads host state only (the card's budget was read once, when the
        registry was built)."""
        budget = self.budget_bytes()
        if not budget:
            return None
        committed = sum(self._hbm_committed.values())
        return max(0.0, (budget - committed) / budget)

    def _pick_idle_victim(self) -> str | None:
        # grace window: an engine targeted within the last evict_grace_s is
        # never evicted even if its batcher looks idle. get_engine bumps
        # _last_used before the caller submits, so this closes the gap
        # where a request is on its way to a momentarily idle batcher
        now = time.monotonic()
        idle = [
            mid for mid, eng in self._engines.items()
            if eng.batcher.idle and now - self._last_used.get(mid, 0.0) > self.evict_grace_s
        ]
        if not idle:
            return None
        return min(idle, key=lambda mid: self._last_used.get(mid, 0.0))

    def _grace_remaining_s(self) -> float | None:
        """Shortest time until some idle engine leaves the eviction grace
        (None when no idle engine is inside it)."""
        now = time.monotonic()
        waits = [
            self.evict_grace_s - (now - self._last_used.get(mid, 0.0))
            for mid, eng in self._engines.items()
            if eng.batcher.idle
        ]
        waits = [w for w in waits if w > 0]
        return min(waits) if waits else None

    def _load(self, model_id: str, paths: list[str]) -> TorchChatEngine:
        t0 = time.perf_counter()
        reader = self._open(paths)
        try:
            cfg = self._serving_config(reader)
            if cfg.is_moe:
                raise EngineError(f"{model_id}: MoE models are not served by this worker")
            tokenizer = GGUFTokenizer.from_metadata(reader.metadata)
            quant = {t.ggml_type.name for t in reader.tensors.values()}
            params = ensure_lm_head(
                load_params_from_gguf(reader, cfg, device=self.device))
            meta = dict(reader.metadata)
        finally:
            reader.close()
        if self.device.type == "cuda":
            # build (or find built) every kernel the engine launches now,
            # before its owner loop starts: a cold nvcc inside the first
            # prefill would stall the heartbeat the supervisor watches
            from ..ops import _build

            tb = time.perf_counter()
            report = _build.build_all()
            for name in _build.SOURCES:
                _build.load_library(name)
            self.kernel_build_s = time.perf_counter() - tb
            built = sorted(n for n, r in report.items() if not r["cached"])
            obs_emit("kernel_build", model=model_id, built=built,
                     seconds=round(self.kernel_build_s, 2))
        recorder = FlightRecorder(
            enabled=self.obs_recorder, interval_ms=self.obs_recorder_interval_ms,
            dump_dir=self.obs_dump_dir, engine=model_id, worker_id=self.worker_id,
            counter_fns=dict(self.recorder_counters),
        )
        batcher = ContinuousBatcher(params, cfg, max_slots=self.max_batch_slots,
                                    max_seq_len=self.max_seq_len,
                                    prefix_cache_blocks=self.prefix_cache_blocks,
                                    spec_decode_k=self.spec_decode_k,
                                    spec_max_active=self.spec_max_active,
                                    max_queue=self.admit_queue_limit,
                                    max_queue_age_ms=self.admit_max_age_ms,
                                    brownout=self.brownout_cfg,
                                    hbm_headroom_fn=self._hbm_headroom_frac,
                                    deadline_min_tokens=self.deadline_min_tokens,
                                    recorder=recorder,
                                    qos_quantum_tokens=self.qos_quantum_tokens,
                                    kv_block_tokens=self.kv_block_tokens,
                                    kv_pool_blocks=self.kv_pool_blocks,
                                    kv_suspend=self.kv_suspend,
                                    qos_preempt=self.qos_preempt)
        if batcher.brownout is not None:
            batcher.brownout.engine = model_id
        if self.kv_host_pool_bytes > 0 and batcher.prefix_cache is not None:
            # keyed by whole prefix-cache chunks, so attached after the
            # batcher has settled its (possibly halved) serving chunk
            batcher.kv_tiers = self._tier_manager(model_id, batcher.prefill_chunk)
        batcher.start()
        load_s = time.perf_counter() - t0
        log.info("loaded %s in %.1fs (%s, %s, kv %s, %s)", model_id, load_s, cfg.arch,
                 self.dtype, cfg.kv_quant, self.device)
        obs_emit("engine_load", model=model_id, seconds=round(load_s, 2), arch=cfg.arch,
                 dtype=self.dtype)
        return TorchChatEngine(model_id, batcher, tokenizer, cfg, meta,
                               quantization="/".join(sorted(quant)))

    def _tier_manager(self, model_id: str, chunk_tokens: int):
        """The host KV tier of one engine, over the Object Store spill when
        the worker bound a factory (a spill that cannot be made leaves the
        host tier alone)."""
        from .kv_tiers import KVTierManager

        spill = None
        if self.kv_spill_factory is not None:
            try:
                spill = self.kv_spill_factory()
            except Exception:  # noqa: BLE001 — the cold tier is optional
                log.warning("kv spill store unavailable for %s; host tier only", model_id,
                            exc_info=True)
        return KVTierManager(
            self.kv_host_pool_bytes, chunk_tokens=chunk_tokens, spill=spill,
            namespace=f"kv/{model_id}", max_spill_objects=self.kv_spill_max_objects,
            promote_chunks=self.kv_promote_chunks, demote_free_frac=self.kv_demote_free_frac,
        )

    # -- engine supervision ----------------------------------------------------

    async def restart_engine(self, model_id: str, reason: str = "crash") -> str:
        """Tear down and relaunch one engine (the worker supervisor's action
        on a crashed or hung batcher). Returns "restarted", "poisoned" (too
        many crashes inside the window, or a CUDA error that left the
        context unusable: refuse until reset) or "gone" (already unloaded by
        a concurrent delete or eviction). A reload failure propagates as
        EngineError after the teardown."""
        if self.draining:
            return "draining"
        t0 = time.monotonic()
        async with self._load_lock:
            eng = self._engines.pop(model_id, None)
            if eng is None:
                return "gone"
            self._uncommit(model_id)
            self._last_used.pop(model_id, None)
            b = eng.batcher
            # the total outlives this batcher object
            self.inflight_failed_retryable += b.stats.inflight_failed_retryable
            # its recorder holds the pre-crash timeline: kept past the
            # unload for the restart dump below
            recorder = b.recorder
            crash = b.crashed
            await eng.unload()
            obs_emit("engine_unload", model=model_id, reason=reason)
            now = time.monotonic()
            times = [t for t in self._crash_times.get(model_id, [])
                     if now - t <= self.restart_window_s]
            times.append(now)
            self._crash_times[model_id] = times
            why = None
            if crash is not None and cuda_context_lost(crash):
                # every reload in this process would fail too: poison now
                # instead of spending the restarts on reloading the weights
                why = f"CUDA context lost ({type(crash).__name__}: {crash})"
            elif len(times) > self.max_restarts:
                why = f"{len(times)} crashes in {self.restart_window_s:.0f}s (last: {reason})"
            if why is not None:
                self._poisoned[model_id] = why
                log.error("engine %s poisoned: %s", model_id, why)
                obs_emit("engine_poisoned", model=model_id, reason=why)
                return "poisoned"
            backoff = min(self.restart_backoff_s * (2 ** (len(times) - 1)),
                          self.restart_backoff_max_s)
        # backoff and reload outside the load lock: get_engine takes it
        await asyncio.sleep(backoff)
        if self.draining:
            # the drain began during the backoff: a worker being taken out
            # of service must not get its engine back
            return "draining"
        await self.get_engine(model_id)
        self.engine_restarts_total += 1
        latency_ms = (time.monotonic() - t0) * 1e3
        self.restart_latency_ms.record(latency_ms)
        log.info("engine %s restarted in %.0f ms (reason: %s)", model_id, latency_ms, reason)
        obs_emit("engine_restart", model=model_id, reason=reason, ms=round(latency_ms, 1))
        # after the emit, so the dump's event tail holds the restart; forced
        # past the rate limit the crash dump just used
        recorder.dump("engine_restart", force=True,
                      extra={"model": model_id, "restart_reason": reason,
                             "restart_ms": round(latency_ms, 1)})
        return "restarted"

    def engine_health(self) -> dict[str, dict[str, Any]]:
        """Per-engine liveness for the health subject: ``alive`` (owner
        thread running, no crash), ``ready`` (alive and accepting),
        ``idle``, ``heartbeat_age_s`` (only meaningful when not idle),
        ``crashed`` (the crash's type and text, or None) and
        ``brownout_level``."""
        out: dict[str, dict[str, Any]] = {}
        for mid, eng in self._engines.items():
            b = eng.batcher
            out[mid] = {
                "alive": bool(b.alive),
                "ready": bool(b.alive and not b._stopping),
                "idle": bool(b.idle),
                "heartbeat_age_s": round(b.heartbeat_age_s(), 3),
                "crashed": (f"{type(b.crashed).__name__}: {b.crashed}"
                            if b.crashed is not None else None),
                "brownout_level": int(b.brownout_level),
            }
        return out

    def set_draining(self, flag: bool = True) -> None:
        """Raise (or clear) the drain flag: while set, ``restart_engine``
        refuses to relaunch engines, so a supervisor restart racing a drain
        cannot revive the worker's engine."""
        self.draining = bool(flag)

    def poisoned_models(self) -> dict[str, str]:
        return dict(self._poisoned)

    def loaded_engines(self) -> dict[str, Any]:
        return dict(self._engines)

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "models_cached": len(self.store.cached()),
            "models_loaded": len(self._engines),
            "engine_requests": self._requests,
            "backend": self.device.type,
            "hbm_committed_bytes": sum(self._hbm_committed.values()),
            "hbm_ledger": self.hbm_ledger.last_sample(),
        }
        if self.engine_restarts_total:
            out["engine_restarts"] = self.engine_restarts_total
        if self._poisoned:
            out["poisoned"] = dict(self._poisoned)
        if self._engines:
            out["batcher"] = {m: e.batcher.stats.snapshot() for m, e in self._engines.items()}
            prefix = {m: e.batcher.prefix_cache.stats() for m, e in self._engines.items()
                      if e.batcher.prefix_cache is not None}
            if prefix:
                out["prefix_cache"] = prefix
        return out

    async def close(self) -> None:
        for eng in list(self._engines.values()):
            await eng.unload()
        self._engines.clear()
        self._hbm_committed.clear()
        self._prefix_bytes.clear()
        self._hbm_resident.clear()
        self._last_used.clear()
