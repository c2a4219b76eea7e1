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
    # overload bounds on the batcher admit queue (0 disables either).
    # Depth: chat_model sheds immediately past this many queued requests.
    # Age: waiters older than this are shed at admit time. Shedding replies
    # with an honest error envelope so queue-group peers absorb the overflow;
    # without bounds the reference's r4 bench measured 38.6 s of silent
    # queueing. Unset ADMIT_QUEUE_LIMIT derives 4 x MAX_BATCH_SLOTS; an
    # explicit 0 disables the depth bound.
    admit_queue_limit: int = field(
        default_factory=lambda: int(_env("ADMIT_QUEUE_LIMIT", "-1"))
    )
    admit_max_age_ms: float = field(
        default_factory=lambda: float(_env("ADMIT_MAX_AGE_MS", "30000"))
    )
    # -- engine supervision (serve/worker.py + serve/registry.py) ------------
    # watchdog poll period over loaded batchers; 0 disables supervision
    supervise_interval_s: float = field(
        default_factory=lambda: float(_env("SUPERVISE_INTERVAL_S", "2"))
    )
    # a NON-idle batcher whose owner loop hasn't stamped its heartbeat for
    # this long is declared hung and restarted. The port builds its kernels
    # when the engine loads, before the batcher starts, so the first
    # prefill does not stall the loop on nvcc. 0 disables the hang check
    # (crash detection stays).
    engine_heartbeat_timeout_s: float = field(
        default_factory=lambda: float(_env("ENGINE_HEARTBEAT_TIMEOUT_S", "120"))
    )
    engine_restart_backoff_s: float = field(
        default_factory=lambda: float(_env("ENGINE_RESTART_BACKOFF_S", "0.5"))
    )
    engine_restart_backoff_max_s: float = field(
        default_factory=lambda: float(_env("ENGINE_RESTART_BACKOFF_MAX_S", "30"))
    )
    # more than this many crashes inside the window poisons the model:
    # get_engine refuses (retryable envelope) until a delete/pull resets it
    engine_max_restarts: int = field(
        default_factory=lambda: int(_env("ENGINE_MAX_RESTARTS", "3"))
    )
    engine_restart_window_s: float = field(
        default_factory=lambda: float(_env("ENGINE_RESTART_WINDOW_S", "120"))
    )
    # -- overload robustness (serve/brownout.py + serve/batcher.py) ----------
    # end-to-end deadline propagation: the worker converts X-Deadline-Ms to
    # a monotonic deadline (capped by chat_timeout_s) so the batcher can
    # shed expired requests before prefill and abort mid-decode slots whose
    # caller gave up. DEADLINE_PROPAGATION=0/false/off disables it.
    # DEADLINE_MIN_TOKENS and the BROWNOUT_* thresholds parse in
    # serve/registry.py.
    deadline_propagation: bool = field(
        default_factory=lambda: _env("DEADLINE_PROPAGATION", "1").strip().lower()
        not in ("0", "false", "off")
    )
    # adaptive brownout controller: NORMAL -> BROWNOUT -> SHED_ONLY with
    # hysteresis on queue depth, queue age p95, and device-memory headroom.
    # BROWNOUT=0/false/off disables it (the depth/age sheds stay).
    brownout: bool = field(
        default_factory=lambda: _env("BROWNOUT", "1").strip().lower()
        not in ("0", "false", "off")
    )
    # -- flight recorder + debug subjects (obs/recorder.py) ------------------
    # bounded ring of periodic batcher state frames, sampled by the owner
    # loop; anomaly dumps (engine crash and restart, SHED_ONLY entry, slow
    # requests) write frames + event tail + trace to OBS_DUMP_DIR.
    # OBS_RECORDER=0 disables sampling and dumps; an empty OBS_DUMP_DIR
    # keeps the in-memory ring but writes nothing to disk.
    obs_recorder: bool = field(
        default_factory=lambda: _env("OBS_RECORDER", "1").strip().lower()
        not in ("0", "false", "off")
    )
    obs_recorder_interval_ms: float = field(
        default_factory=lambda: float(_env("OBS_RECORDER_INTERVAL_MS", "250"))
    )
    obs_dump_dir: str = field(default_factory=lambda: _env("OBS_DUMP_DIR", "").strip())
    # deep-introspection subjects (lmstudio.debug.snapshot / .dump): off by
    # default — they expose slot tables and can force disk writes
    debug_subjects: bool = field(
        default_factory=lambda: _env("DEBUG_SUBJECTS", "0").strip().lower()
        in ("1", "true", "on")
    )
    # cross-process span emission on {prefix}.obs.spans; OBS_SPANS=0 turns
    # it off (Traceparent headers still flow)
    obs_spans: bool = field(
        default_factory=lambda: _env("OBS_SPANS", "1").strip().lower()
        not in ("0", "false", "off")
    )
    # -- the paged KV pool (serve/block_pool.py) -----------------------------
    # KV_BLOCK_TOKENS is tokens per block (snapped down to divide the
    # prefill chunk); KV_POOL_BLOCKS=0 auto-sizes for zero starvation
    # (every slot at max_seq + the prefix budget); deployments
    # under-provision it to pack more slots into the same device memory
    kv_block_tokens: int = field(
        default_factory=lambda: int(_env("KV_BLOCK_TOKENS", "16"))
    )
    kv_pool_blocks: int = field(
        default_factory=lambda: int(_env("KV_POOL_BLOCKS", "0"))
    )
    # -- hierarchical KV tiers (serve/kv_tiers.py) ---------------------------
    # host-RAM tier budget in bytes under the device block pool: evicted/
    # reclaimed prefix-cache chunks demote here (and spill onward to the
    # Object Store) instead of being dropped. 0 disables tiering entirely.
    kv_host_pool_bytes: int = field(
        default_factory=lambda: int(_env("KV_HOST_POOL_BYTES", str(256 << 20)))
    )
    # spill host-tier evictions to the JetStream Object Store as KVX1 blobs
    # (bucket "kv-tier"); the cold tier survives process death
    kv_spill_objstore: bool = field(
        default_factory=lambda: _env("KV_SPILL_OBJSTORE", "1").strip().lower()
        not in ("0", "false", "off")
    )
    # seconds one Object Store call of the cold tier may take
    kv_transfer_timeout_s: float = field(
        default_factory=lambda: float(_env("KV_TRANSFER_TIMEOUT_S", "10"))
    )
    # slot suspend/resume (swap-don't-shed): under pool exhaustion or
    # SHED_ONLY brownout, move a victim slot's KV + resume state to host
    # RAM and continue it later bit-identically instead of shedding it.
    # KV_SUSPEND=0 is the kill switch (shed on exhaustion).
    kv_suspend: bool = field(
        default_factory=lambda: _env("KV_SUSPEND", "1").strip().lower()
        not in ("0", "false", "off")
    )
    # proactive demotion low-water mark: each owner tick with the pool's
    # free fraction below this, cold cache chunks demote to the host tier
    kv_demote_free_frac: float = field(
        default_factory=lambda: float(_env("KV_DEMOTE_FREE_FRAC", "0.10"))
    )
    # promotion-on-hit ceiling: at most this many tiered chunks re-enter the
    # pool per admit
    kv_promote_chunks: int = field(
        default_factory=lambda: int(_env("KV_PROMOTE_CHUNKS", "64"))
    )
    # cold-tier object-count cap; shallowest chains purge first
    kv_spill_max_objects: int = field(
        default_factory=lambda: int(_env("KV_SPILL_MAX_OBJECTS", "512"))
    )
    # -- multi-tenant QoS (serve/qos.py) -------------------------------------
    # deficit-round-robin quantum in prompt tokens per round per unit of
    # class weight
    qos_quantum_tokens: int = field(
        default_factory=lambda: int(_env("QOS_QUANTUM_TOKENS", "256"))
    )
    # premium preempt-to-host-tier: a higher-class admit that finds the KV
    # pool full suspends the lowest-class victim slot to host RAM (resumed
    # bit-identically when pressure clears) before ever shedding. Off
    # restores class-blind victim selection (largest slot first).
    qos_preempt: bool = field(
        default_factory=lambda: _env("QOS_PREEMPT", "1").strip().lower()
        not in ("0", "false", "off")
    )
    # tenant-label cardinality cap for the Prometheus exposition: the top-K
    # tenants by volume keep their own rows, the rest roll up into
    # tenant="other". 0 disables the cap.
    qos_tenant_topk: int = field(
        default_factory=lambda: int(_env("QOS_TENANT_TOPK", "8"))
    )
    # -- cluster membership + failover routing (serve/router.py) -------------
    # period between lmstudio.cluster.adverts publishes; 0 disables the
    # advert loop (single-worker deployments lose nothing)
    cluster_advert_interval_s: float = field(
        default_factory=lambda: float(_env("CLUSTER_ADVERT_INTERVAL_S", "1.0"))
    )
    # graceful drain (lmstudio.admin.drain): in-flight decode gets this long
    # to finish after the queue subs are dropped; the remainder is failed
    # with the retryable draining envelope so peers absorb it
    drain_deadline_s: float = field(
        default_factory=lambda: float(_env("DRAIN_DEADLINE_S", "30"))
    )
    # router: an advert older than this marks the worker dead (dropped from
    # steering). Must comfortably exceed the advert interval.
    router_stale_after_s: float = field(
        default_factory=lambda: float(_env("ROUTER_STALE_AFTER_S", "5.0"))
    )
    # router: prompt-head chars hashed for prefix-cache locality steering
    # (0 disables locality; load-only steering remains)
    router_prefix_head_chars: int = field(
        default_factory=lambda: int(_env("ROUTER_PREFIX_HEAD_CHARS", "256"))
    )
    # phase role: "" (monolithic) is the only role the port serves; the
    # prefill and decode roles need KV export/import between workers
    worker_role: str = field(default_factory=lambda: _env("WORKER_ROLE", "").strip().lower())
    # -- OpenAI-compatible HTTP/SSE gateway (gateway/server.py) ---------------
    # bind address for ``python -m nats_llm_studio_tpu_torch gateway``;
    # loopback by default
    gateway_host: str = field(default_factory=lambda: _env("GATEWAY_HOST", "127.0.0.1"))
    gateway_port: int = field(default_factory=lambda: int(_env("GATEWAY_PORT", "8080")))
    # concurrent HTTP connections admitted before 503
    gateway_max_conn: int = field(
        default_factory=lambda: int(_env("GATEWAY_MAX_CONN", "256"))
    )
    # API-key table: comma-separated ``key:tenant:class[:weight[:rps
    # [:monthly_tokens]]]`` entries; empty disables auth (everyone is the
    # anonymous standard tenant)
    api_keys: str = field(default_factory=lambda: _env("API_KEYS", ""))
    # -- cluster observability plane (obs/aggregator.py) ---------------------
    # fleet aggregator scrape cadence over each live worker's directed
    # metrics.prom subject
    obs_scrape_interval_s: float = field(
        default_factory=lambda: float(_env("OBS_SCRAPE_INTERVAL_S", "2.0"))
    )
    # embed the fleet aggregator inside ``route``; the standalone ``obs``
    # command always runs one
    obs_aggregator: bool = field(
        default_factory=lambda: _env("OBS_AGGREGATOR", "0").strip().lower()
        in ("1", "true", "on")
    )
    # the autoscaler (serve/autoscaler.py in the JAX package) is not ported:
    # OBS_AUTOSCALE=1 makes ``route`` and ``obs`` refuse to start
    obs_autoscale: bool = field(
        default_factory=lambda: _env("OBS_AUTOSCALE", "0").strip().lower()
        in ("1", "true", "on")
    )
    # SLO objectives the aggregator evaluates over fast/slow burn windows:
    # cluster TTFT p95 (ms), the slow window (s), the least served-or-
    # retryable ratio and the largest shed ratio
    slo_ttft_p95_ms: float = field(
        default_factory=lambda: float(_env("SLO_TTFT_P95_MS", "2000"))
    )
    slo_window_s: float = field(
        default_factory=lambda: float(_env("SLO_WINDOW_S", "60"))
    )
    slo_served_ratio: float = field(
        default_factory=lambda: float(_env("SLO_SERVED_RATIO", "0.99"))
    )
    slo_shed_ratio: float = field(
        default_factory=lambda: float(_env("SLO_SHED_RATIO", "0.05"))
    )

    def __post_init__(self) -> None:
        if self.admit_queue_limit < 0:  # unset: scale with the slot count
            self.admit_queue_limit = 4 * self.max_batch_slots
        if not self.worker_id:
            from .utils import next_nuid

            self.worker_id = f"w-{next_nuid()[-8:].lower()}"
        if self.worker_role:
            raise ValueError(
                f"WORKER_ROLE={self.worker_role!r}: disaggregated prefill/decode "
                f"roles need KV export and import between workers, which this "
                f"package does not serve yet; leave WORKER_ROLE unset"
            )

    # timeout ladder — mirrors the reference's per-op deadlines
    list_timeout_s: float = 30.0
    pull_timeout_s: float = 600.0
    delete_timeout_s: float = 120.0
    chat_timeout_s: float = 120.0

    def subject(self, op: str) -> str:
        return f"{self.subject_prefix}.{op}"
