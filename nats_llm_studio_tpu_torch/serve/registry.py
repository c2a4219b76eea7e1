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

Not ported yet: the mesh gate and precompile at pull time, engine
supervision and restarts, deadlines, KV tiers and QoS.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import replace as dc_replace
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
from ..utils.nuid import next_nuid
from .api import ChatEngine, EngineError, ModelNotFound, Registry
from . import constrain as constrain_mod
from .batcher import LOGPROBS_K, BatcherOverloaded, BatcherStopped, ContinuousBatcher
from .constrain import ConstraintError, compile_token_dfa, validate_response_format
from .template import render_chat_template, stop_token_ids

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
        prompt = render_chat_template(self.meta, messages, add_generation_prompt=True)
        return self.tokenizer.encode(prompt)

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
                          dfa, want_lp: bool, top_n: int,
                          result: dict) -> AsyncIterator[dict]:
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
        async for tok_batch in self.batcher.submit_batched(
            prompt_ids, sp, info=end_info, constrain=dfa, want_logprobs=want_lp,
            top_logprobs=top_n,
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
        prompt_ids = self._encode_prompt(payload)
        sp = self._sampling(payload)
        dfa, want_lp, top_n, n_choices = self._parse_ext(payload)
        results = [dict() for _ in range(n_choices)]
        try:
            if n_choices == 1:
                async for chunk in self._stream_one(0, prompt_ids, sp, dfa, want_lp, top_n,
                                                    results[0]):
                    yield chunk
            else:
                async for chunk in self._stream_n(prompt_ids, sp, dfa, want_lp, top_n,
                                                  results):
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

    async def _stream_n(self, prompt_ids, sp, dfa, want_lp, top_n,
                        results) -> AsyncIterator[dict]:
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
                async for chunk in self._stream_one(i, prompt_ids, sp_for(i), dfa, want_lp,
                                                    top_n, results[i]):
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
    ``SPEC_DECODE_K`` / ``SPEC_DECODE_MAX_ACTIVE`` (``_spec_decode_env``)."""

    def __init__(self, store: ModelStore, device: str = "cuda",
                 max_seq_len: int | None = None, max_batch_slots: int = 8,
                 kv_quant: str = "none", prefix_cache_blocks: int | None = None,
                 spec_decode_k: int | None = None, spec_max_active: int | None = None):
        self.kv_quant = check_kv_quant(kv_quant)
        self.prefix_cache_blocks = (prefix_cache_blocks if prefix_cache_blocks is not None
                                    else _prefix_cache_blocks_env())
        env_k, env_ma = _spec_decode_env()
        self.spec_decode_k = spec_decode_k if spec_decode_k is not None else env_k
        self.spec_max_active = spec_max_active if spec_max_active is not None else env_ma
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
        self._last_used: dict[str, float] = {}
        self.evict_grace_s = 1.0

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
            _, transcript = await self.store.pull(identifier)
        except StoreError as e:
            raise EngineError(str(e)) from None
        return transcript

    async def delete(self, model_id: str) -> str:
        eng = self._engines.pop(model_id, None)
        self._hbm_committed.pop(model_id, None)
        self._prefix_bytes.pop(model_id, None)
        self._last_used.pop(model_id, None)
        if eng is not None:
            await eng.unload()
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
                self._hbm_committed.pop(cm.model_id, None)
                self._prefix_bytes.pop(cm.model_id, None)
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
        need = await asyncio.to_thread(self._estimate_load_bytes, paths)
        pbytes = await asyncio.to_thread(self._estimate_prefix_bytes, paths)
        self._hbm_committed.pop(model_id, None)  # reloading: don't double count
        self._prefix_bytes.pop(model_id, None)
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
            self._hbm_committed.pop(victim, None)
            self._prefix_bytes.pop(victim, None)
            eng = self._engines.pop(victim)
            self._last_used.pop(victim, None)
            await eng.unload()
        self._hbm_committed[model_id] = need
        if pbytes:
            self._prefix_bytes[model_id] = pbytes

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
                                   prefix_cache_blocks=self.prefix_cache_blocks)

    def _estimate_load_bytes(self, paths: list[str]) -> int:
        """Device bytes of serving this GGUF with this registry's settings."""
        return self._estimate(paths)["total"]

    def _estimate_prefix_bytes(self, paths: list[str]) -> int:
        """The part of that which the prefix cache holds outside the pool
        (the estimate's ``prefix`` term: its chunk-end logits rows), which
        dropping the cache gives back."""
        return self._estimate(paths)["prefix"]

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
        batcher = ContinuousBatcher(params, cfg, max_slots=self.max_batch_slots,
                                    max_seq_len=self.max_seq_len,
                                    prefix_cache_blocks=self.prefix_cache_blocks,
                                    spec_decode_k=self.spec_decode_k,
                                    spec_max_active=self.spec_max_active)
        batcher.start()
        log.info("loaded %s in %.1fs (%s, %s, kv %s, %s)", model_id,
                 time.perf_counter() - t0, cfg.arch, self.dtype, cfg.kv_quant, self.device)
        return TorchChatEngine(model_id, batcher, tokenizer, cfg, meta,
                               quantization="/".join(sorted(quant)))

    def engine_health(self) -> dict[str, dict[str, Any]]:
        return {
            mid: {"alive": bool(eng.batcher.alive), "idle": bool(eng.batcher.idle)}
            for mid, eng in self._engines.items()
        }

    def loaded_engines(self) -> dict[str, Any]:
        return dict(self._engines)

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "models_cached": len(self.store.cached()),
            "models_loaded": len(self._engines),
            "engine_requests": self._requests,
            "backend": self.device.type,
            "hbm_committed_bytes": sum(self._hbm_committed.values()),
        }
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
        self._last_used.clear()
