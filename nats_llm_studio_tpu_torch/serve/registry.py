"""TorchRegistry: models on disk -> loaded engines, for the port's worker.

Port of the serving core of ``nats_llm_studio_tpu/serve/registry.py``:
``TorchRegistry`` lists and loads GGUF models from a models directory laid
out as ``<models_dir>/<publisher>/<name>/*.gguf`` (the layout
``store/manager.py`` ``ModelStore`` keeps), and ``TorchChatEngine`` keeps
``JaxChatEngine``'s ``chat`` / ``chat_stream`` / ``_completion`` reply
shapes over the port's batcher.

Not ported yet: pulls from the Object Store or a URL, HBM admission and
eviction, engine supervision and restarts, prefix cache, spec decode, KV
tiers and QoS. A chat that asks for a feature this port does not serve
(``response_format``, ``logprobs``, ``top_logprobs``, ``n`` > 1) gets an
error naming the field instead of having it ignored.
"""

from __future__ import annotations

import asyncio
import logging
import time
from pathlib import Path
from typing import Any, AsyncIterator

from ..device import default_dtype, resolve_device
from ..engine.generator import GenStats, SamplingParams
from ..gguf.reader import is_split_shard, open_gguf
from ..gguf.tokenizer import GGUFTokenizer
from ..models.config import ModelConfig, check_kv_quant
from ..models.llama import ensure_lm_head, load_params_from_gguf
from ..utils.nuid import next_nuid
from .api import ChatEngine, EngineError, ModelNotFound, Registry
from .batcher import BatcherOverloaded, BatcherStopped, ContinuousBatcher
from .template import render_chat_template, stop_token_ids

log = logging.getLogger(__name__)

# request fields of features this port does not serve yet
UNSUPPORTED_FIELDS = ("response_format", "logprobs", "top_logprobs")


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

    @staticmethod
    def _check_supported(payload: dict) -> None:
        for f in UNSUPPORTED_FIELDS:
            if payload.get(f) not in (None, False, 0):
                raise EngineError(f"unsupported field {f!r}: not served by this worker")
        try:
            n = int(payload.get("n") or 1)
        except (TypeError, ValueError) as e:
            raise EngineError(f"invalid request: {e}") from e
        if n != 1:
            raise EngineError("unsupported field 'n': only n=1 is served by this worker")

    def _completion(self, text: str, n_prompt: int, n_out: int, finish: str,
                    stats=None) -> dict:
        """OpenAI-style body with LM Studio's stats block."""
        out: dict[str, Any] = {
            "id": f"chatcmpl-{next_nuid()[:12].lower()}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_id,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish,
            }],
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

    async def chat_stream(self, payload: dict) -> AsyncIterator[dict]:
        self._check_supported(payload)
        prompt_ids = self._encode_prompt(payload)
        sp = self._sampling(payload)
        stats = GenStats(prompt_tokens=len(prompt_ids))
        t0 = time.perf_counter()
        toks: list[int] = []
        emitted = 0
        end_info: dict = {}
        try:
            async for tok_batch in self.batcher.submit_batched(prompt_ids, sp, info=end_info):
                if not toks:
                    stats.ttft_s = time.perf_counter() - t0
                toks.extend(tok_batch)
                stats.completion_tokens += len(tok_batch)
                # emit only completed UTF-8 text
                text = self.tokenizer.decode(toks)
                if len(text) > emitted and not text.endswith("�"):
                    yield {
                        "object": "chat.completion.chunk",
                        "model": self.model_id,
                        "choices": [{
                            "index": 0,
                            "delta": {"role": "assistant", "content": text[emitted:]},
                            "finish_reason": None,
                        }],
                    }
                    emitted = len(text)
        except BatcherOverloaded as e:
            raise EngineError(f"overloaded: {e}") from e
        except BatcherStopped as e:
            raise EngineError(str(e)) from e
        except ValueError as e:  # e.g. prompt longer than max_seq
            raise EngineError(str(e)) from e
        stats.total_s = time.perf_counter() - t0
        text = self.tokenizer.decode(toks)
        if len(text) > emitted:
            # flush text held back by the incomplete-UTF-8 guard
            yield {
                "object": "chat.completion.chunk",
                "model": self.model_id,
                "choices": [{
                    "index": 0,
                    "delta": {"role": "assistant", "content": text[emitted:]},
                    "finish_reason": None,
                }],
            }
        reason = end_info.get("finish_reason", "stop")
        if reason == "shutdown" and not toks:
            raise EngineError("worker draining, retry on another worker")
        finish = reason if reason in ("length", "shutdown") else "stop"
        yield self._completion(text, len(prompt_ids), len(toks), finish, stats)

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


def _cached_models(models_dir: Path) -> list[tuple[str, str, list[Path]]]:
    """(model_id, publisher, gguf files) for every ``<publisher>/<name>``
    directory holding GGUF files (names may nest: ``pub/a/b``)."""
    out = []
    if not models_dir.is_dir():
        return out
    for pub_dir in sorted(p for p in models_dir.iterdir() if p.is_dir()):
        for d in sorted({f.parent for f in pub_dir.rglob("*.gguf")}):
            files = sorted(d.glob("*.gguf"))
            mid = d.relative_to(models_dir).as_posix()
            out.append((mid, pub_dir.name, files))
    return out


class TorchRegistry(Registry):
    """Model lifecycle over a models directory + PyTorch engines.

    ``device`` defaults to "cuda" and raises when no card is visible; the
    CPU is used only when the caller passes ``device="cpu"``. The compute
    dtype follows the device: bf16 on the card, f32 on the CPU.
    ``kv_quant`` ("none" or "int8", ``TPU_KV_QUANT``) picks the KV cache's
    storage for every model loaded."""

    def __init__(self, models_dir: str | Path, device: str = "cuda",
                 max_seq_len: int | None = None, max_batch_slots: int = 8,
                 kv_quant: str = "none"):
        self.kv_quant = check_kv_quant(kv_quant)
        self.device = resolve_device(device)
        self.models_dir = Path(models_dir).expanduser()
        self.dtype = default_dtype(self.device)
        self.max_seq_len = max_seq_len
        self.max_batch_slots = max_batch_slots
        self._engines: dict[str, TorchChatEngine] = {}
        self._load_lock = asyncio.Lock()
        self._requests = 0

    async def list_models(self) -> dict:
        entries = []
        for mid, pub, files in _cached_models(self.models_dir):
            eng = self._engines.get(mid)
            if eng is not None:
                entries.append(eng.info())
            else:
                entries.append({
                    "id": mid,
                    "object": "model",
                    "type": "llm",
                    "publisher": pub,
                    "state": "not-loaded",
                    "size_bytes": sum(f.stat().st_size for f in files),
                })
        return {"object": "list", "data": entries}

    async def pull(self, identifier: str) -> str:
        raise EngineError("pull_model is not served by this worker")

    async def delete(self, model_id: str) -> str:
        raise EngineError("delete_model is not served by this worker")

    async def get_engine(self, model_id: str) -> ChatEngine:
        self._requests += 1
        eng = self._engines.get(model_id)
        if eng is not None:
            return eng
        async with self._load_lock:
            eng = self._engines.get(model_id)
            if eng is not None:
                return eng
            found = [m for m in _cached_models(self.models_dir) if m[0] == model_id]
            if not found:
                raise ModelNotFound(model_id)
            paths = [str(f) for f in found[0][2]]
            eng = await asyncio.to_thread(self._load, model_id, paths)
            self._engines[model_id] = eng
            return eng

    def _load(self, model_id: str, paths: list[str]) -> TorchChatEngine:
        t0 = time.perf_counter()
        split = sorted(p for p in paths if is_split_shard(p))
        reader = open_gguf(split[0] if split else paths[0])
        try:
            cfg = ModelConfig.from_gguf_metadata(reader.metadata).with_(
                dtype=self.dtype, kv_quant=self.kv_quant)
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
                                    max_seq_len=self.max_seq_len)
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
            "models_cached": len(_cached_models(self.models_dir)),
            "models_loaded": len(self._engines),
            "engine_requests": self._requests,
            "backend": self.device.type,
        }
        if self._engines:
            out["batcher"] = {m: e.batcher.stats.snapshot() for m, e in self._engines.items()}
        return out

    async def close(self) -> None:
        for eng in list(self._engines.values()):
            await eng.unload()
        self._engines.clear()
