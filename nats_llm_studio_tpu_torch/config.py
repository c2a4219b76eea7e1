"""Environment-variable configuration for the port's worker.

Copy of the ``WorkerConfig`` fields of ``nats_llm_studio_tpu/config.py``
that the port's serving path reads, with the same environment names and
defaults.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path


def _env(name: str, default: str) -> str:
    v = os.environ.get(name, "").strip()
    return v or default


@dataclass
class WorkerConfig:
    nats_url: str = field(default_factory=lambda: _env("NATS_URL", "nats://127.0.0.1:4222"))
    models_dir: Path = field(
        default_factory=lambda: Path(
            _env("LMSTUDIO_MODELS_DIR", str(Path.home() / ".lmstudio" / "models"))
        ).expanduser()
    )
    # Object Store bucket that publish / pull_model / sync_model_from_bucket use
    bucket: str = field(default_factory=lambda: _env("MODEL_BUCKET", "llm-models"))
    # comma-separated URL schemes pull_model may fetch directly; https-only
    # by default (a bus client must not drive the worker to read its local
    # files or internal endpoints)
    url_pull_schemes: str = field(default_factory=lambda: _env("URL_PULL_SCHEMES", "https"))
    # ceiling on one pull_model URL download (disk-fill guard), 100 GiB
    max_url_pull_bytes: int = field(
        default_factory=lambda: int(_env("MAX_URL_PULL_BYTES", str(100 << 30)))
    )
    queue_group: str = field(default_factory=lambda: _env("NATS_QUEUE_GROUP", "lmstudio-workers"))
    subject_prefix: str = field(default_factory=lambda: _env("SUBJECT_PREFIX", "lmstudio"))
    max_batch_slots: int = field(default_factory=lambda: int(_env("MAX_BATCH_SLOTS", "8")))
    max_seq_len: int = field(default_factory=lambda: int(_env("MAX_SEQ_LEN", "4096")))
    # "none" or "int8": the serving KV cache in the compute dtype, or as int8
    # codes with f32 scales (ops/kvcache.py KVQ) — about half the bytes
    kv_quant_mode: str = field(default_factory=lambda: _env("TPU_KV_QUANT", "none"))
    max_reconnects: int = field(
        default_factory=lambda: int(_env("NATS_MAX_RECONNECTS", "60"))
    )
    reconnect_wait_s: float = field(
        default_factory=lambda: float(_env("NATS_RECONNECT_WAIT_S", "0.05"))
    )
    reconnect_max_wait_s: float = field(
        default_factory=lambda: float(_env("NATS_RECONNECT_MAX_WAIT_S", "2.0"))
    )
    ping_interval_s: float = field(
        default_factory=lambda: float(_env("NATS_PING_INTERVAL_S", "30"))
    )
    worker_id: str = field(default_factory=lambda: _env("WORKER_ID", ""))

    def __post_init__(self) -> None:
        if not self.worker_id:
            from .utils import next_nuid

            self.worker_id = f"w-{next_nuid()[-8:].lower()}"

    # timeout ladder — mirrors the reference's per-op deadlines
    list_timeout_s: float = 30.0
    pull_timeout_s: float = 600.0
    delete_timeout_s: float = 120.0
    chat_timeout_s: float = 120.0

    def subject(self, op: str) -> str:
        return f"{self.subject_prefix}.{op}"
