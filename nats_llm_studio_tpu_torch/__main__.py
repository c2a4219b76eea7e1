"""``python -m nats_llm_studio_tpu_torch serve|broker|route|obs|gateway|publish|chat``

Mirror of ``nats_llm_studio_tpu/main.py`` for the port:

* ``serve [--embedded-broker] [--store-dir DIR] [--device cuda|cpu]``: a
  ``Worker`` over a ``TorchRegistry`` whose ``ModelStore`` keeps
  ``LMSTUDIO_MODELS_DIR`` and reaches the ``MODEL_BUCKET`` Object Store
  bucket over NATS, optionally behind an in-process broker with the
  object-store module, with the KV cache that ``TPU_KV_QUANT`` ("none" or
  "int8") names, the pool and tier settings (``KV_BLOCK_TOKENS``,
  ``KV_POOL_BLOCKS``, ``KV_HOST_POOL_BYTES``, ``KV_SUSPEND``,
  ``QOS_PREEMPT``) and the overload, supervision and recorder knobs of
  ``config.WorkerConfig``. ``CHAOS_SPEC`` / ``CHAOS_SEED`` install a fault
  plan (``transport/faults.py``) first. The device defaults to the card;
  with no card the command fails unless ``--device cpu`` is given.
* ``broker [--port N] [--store-dir DIR]``: the embedded NATS broker with
  the object-store module alone.
* ``route [--max-attempts N]``: the cluster router (``serve/router.py
  RouterProcess``): it follows the workers' adverts and forwards
  ``lmstudio.route.chat_model`` to the best live worker; with
  ``OBS_AGGREGATOR=1`` the fleet aggregator runs in the same process.
* ``obs``: the fleet aggregator alone (``obs/aggregator.py``): the merged
  cluster exposition on ``lmstudio.cluster.metrics.prom``, assembled traces
  on ``lmstudio.debug.trace.<id>`` and ``slo_burn`` events.
* ``gateway [--host H] [--port N] [--max-attempts N]``: the OpenAI-compatible
  HTTP/SSE gateway (``gateway/server.py``) over the router.

The autoscaler is not ported: ``OBS_AUTOSCALE=1`` makes ``route`` and
``obs`` refuse to start.
* ``publish GGUF MODEL_ID``: import a GGUF into the local cache and upload
  it to the bucket, for workers to ``pull_model`` or
  ``sync_model_from_bucket``.
* ``chat MODEL_ID PROMPT [--max-tokens N] [--temperature T] [--stream]``:
  one chat over ``lmstudio.chat_model``; prints the answer (streamed as it
  arrives with ``--stream``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sys

from .config import WorkerConfig

log = logging.getLogger("nats_llm_studio_tpu_torch")


def make_store(cfg: WorkerConfig, nc):
    """The serving ``ModelStore``: the models dir, the bucket over ``nc``,
    and the configured URL schemes and pull ceiling."""
    from .store import ModelStore
    from .transport.jetstream import ObjectStore

    schemes = tuple(s for s in cfg.url_pull_schemes.split(",") if s)
    return ModelStore(cfg.models_dir, objstore=ObjectStore(nc), bucket=cfg.bucket,
                      url_schemes=schemes, max_url_pull_bytes=cfg.max_url_pull_bytes)


async def _wait_for_signal() -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()


async def _run_serve(args: argparse.Namespace) -> None:
    from .serve.registry import TorchRegistry
    from .serve.worker import Worker
    from .store import JetStreamStoreModule
    from .transport import EmbeddedBroker, connect
    from .transport import faults

    cfg = WorkerConfig()
    # the chaos harness, only when CHAOS_SPEC is set
    plan = faults.plan_from_env()
    if plan is not None:
        faults.install(plan)
    broker = None
    if args.embedded_broker:
        broker = await EmbeddedBroker(port=args.port).start()
        JetStreamStoreModule(broker, store_dir=args.store_dir).install()
        cfg.nats_url = broker.url
        log.info("embedded broker on %s (store: %s)", broker.url, args.store_dir or "memory")
    nc = await connect(cfg.nats_url, name="store-client")
    registry = TorchRegistry(
        make_store(cfg, nc), device=args.device, max_seq_len=cfg.max_seq_len,
        max_batch_slots=cfg.max_batch_slots, kv_quant=cfg.kv_quant_mode,
        admit_queue_limit=cfg.admit_queue_limit, admit_max_age_ms=cfg.admit_max_age_ms,
        restart_backoff_s=cfg.engine_restart_backoff_s,
        restart_backoff_max_s=cfg.engine_restart_backoff_max_s,
        max_restarts=cfg.engine_max_restarts, restart_window_s=cfg.engine_restart_window_s,
        brownout=cfg.brownout, obs_recorder=cfg.obs_recorder,
        obs_recorder_interval_ms=cfg.obs_recorder_interval_ms, obs_dump_dir=cfg.obs_dump_dir,
        worker_id=cfg.worker_id, qos_quantum_tokens=cfg.qos_quantum_tokens,
        kv_block_tokens=cfg.kv_block_tokens, kv_pool_blocks=cfg.kv_pool_blocks,
        kv_host_pool_bytes=cfg.kv_host_pool_bytes, kv_suspend=cfg.kv_suspend,
        qos_preempt=cfg.qos_preempt,
    )
    worker = Worker(cfg, registry)
    await worker.start()
    log.info("worker serving %s.* on %s (device %s, kv cache %s, models: %s, bucket %s)",
             cfg.subject_prefix, cfg.nats_url, registry.device, registry.kv_quant,
             cfg.models_dir, cfg.bucket)
    await _wait_for_signal()
    log.info("draining...")
    await worker.drain()
    await registry.close()
    await nc.close()
    if broker is not None:
        await broker.stop()


async def _run_broker(args: argparse.Namespace) -> None:
    from .store import JetStreamStoreModule
    from .transport import EmbeddedBroker

    broker = await EmbeddedBroker(port=args.port).start()
    JetStreamStoreModule(broker, store_dir=args.store_dir).install()
    log.info("broker on %s (store: %s)", broker.url, args.store_dir or "memory")
    await _wait_for_signal()
    await broker.stop()


def _refuse_autoscale(cfg: WorkerConfig) -> None:
    if cfg.obs_autoscale:
        raise SystemExit("OBS_AUTOSCALE=1: the autoscaler (serve/autoscaler.py of "
                         "nats_llm_studio_tpu) is not ported to this package yet")


def _aggregator(nc, cfg: WorkerConfig):
    from .obs import Aggregator

    return Aggregator(
        nc, prefix=cfg.subject_prefix, scrape_interval_s=cfg.obs_scrape_interval_s,
        stale_after_s=cfg.router_stale_after_s, slo_ttft_p95_ms=cfg.slo_ttft_p95_ms,
        slo_window_s=cfg.slo_window_s, slo_served_ratio=cfg.slo_served_ratio,
        slo_shed_ratio=cfg.slo_shed_ratio,
    )


async def _run_route(args: argparse.Namespace) -> None:
    from .serve.router import RouterProcess
    from .transport import RetryPolicy, connect

    cfg = WorkerConfig()
    _refuse_autoscale(cfg)
    nc = await connect(cfg.nats_url, name="torch-router")
    proc = RouterProcess(
        nc, prefix=cfg.subject_prefix, stale_after_s=cfg.router_stale_after_s,
        prefix_head_chars=cfg.router_prefix_head_chars, chat_timeout_s=cfg.chat_timeout_s,
        retry=RetryPolicy(max_attempts=args.max_attempts, retry_on_timeout=True),
    )
    await proc.start()
    agg = None
    if cfg.obs_aggregator:
        # OBS_AGGREGATOR=1: the fleet collector shares the router's process
        # and connection
        agg = _aggregator(nc, cfg)
        await agg.start()
    log.info("router on %s (prefix %s%s)", cfg.nats_url, cfg.subject_prefix,
             ", embedded aggregator" if agg is not None else "")
    await _wait_for_signal()
    if agg is not None:
        await agg.stop()
    await proc.stop()
    await nc.close()


async def _run_obs(args: argparse.Namespace) -> None:
    from .transport import connect

    cfg = WorkerConfig()
    _refuse_autoscale(cfg)
    nc = await connect(cfg.nats_url, name="torch-obs")
    agg = _aggregator(nc, cfg)
    await agg.start()
    log.info("aggregator on %s (prefix %s, scrape %.1fs)", cfg.nats_url,
             cfg.subject_prefix, cfg.obs_scrape_interval_s)
    await _wait_for_signal()
    await agg.stop()
    await nc.close()


async def _run_gateway(args: argparse.Namespace) -> None:
    from .gateway import Gateway
    from .transport import RetryPolicy, connect

    cfg = WorkerConfig()
    nc = await connect(cfg.nats_url, name="torch-gateway")
    gw = Gateway(
        nc, prefix=cfg.subject_prefix, host=args.host or cfg.gateway_host,
        port=cfg.gateway_port if args.port is None else args.port,
        max_conn=cfg.gateway_max_conn, chat_timeout_s=cfg.chat_timeout_s,
        retry=RetryPolicy(max_attempts=args.max_attempts, retry_on_timeout=True),
        stale_after_s=cfg.router_stale_after_s,
        prefix_head_chars=cfg.router_prefix_head_chars,
        api_keys=cfg.api_keys, tenant_topk=cfg.qos_tenant_topk,
    )
    await gw.start()
    log.info("gateway on http://%s:%d (bus %s, prefix %s)", gw.host, gw.port,
             cfg.nats_url, cfg.subject_prefix)
    await _wait_for_signal()
    await gw.stop()
    await nc.close()


async def _run_publish(args: argparse.Namespace) -> None:
    from .transport import connect

    cfg = WorkerConfig()
    nc = await connect(cfg.nats_url)
    try:
        store = make_store(cfg, nc)
        store.import_file(args.gguf, args.model_id)
        obj = await store.publish_model(args.model_id)
        print(f"published {obj} to bucket {cfg.bucket!r}")
    finally:
        await nc.close()


async def _run_chat(args: argparse.Namespace) -> int:
    from .transport import connect

    cfg = WorkerConfig()
    nc = await connect(cfg.nats_url)
    body = json.dumps({
        "model": args.model_id,
        "messages": [{"role": "user", "content": args.prompt}],
        "max_tokens": args.max_tokens,
        "temperature": args.temperature,
        "stream": args.stream,
    }).encode()
    subject = cfg.subject("chat_model")
    rc = 0
    try:
        if args.stream:
            async for msg in nc.request_stream(subject, body, timeout=cfg.chat_timeout_s):
                r = json.loads(msg.payload)
                if (msg.headers or {}).get("Nats-Stream-Done"):
                    if not r.get("ok"):
                        print(f"\nerror: {r.get('error')}", file=sys.stderr)
                        rc = 1
                    print()
                    break
                delta = r["data"]["chunk"]["choices"][0]["delta"].get("content", "")
                print(delta, end="", flush=True)
        else:
            msg = await nc.request(subject, body, timeout=cfg.chat_timeout_s)
            r = json.loads(msg.payload)
            if r.get("ok"):
                print(r["data"]["response"]["choices"][0]["message"]["content"])
            else:
                print(f"error: {r.get('error')}", file=sys.stderr)
                rc = 1
    finally:
        await nc.close()
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="nats_llm_studio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run a worker on the card")
    s.add_argument("--embedded-broker", action="store_true",
                   help="run an in-process NATS broker with the object store and serve on it")
    s.add_argument("--port", type=int, default=4222, help="embedded broker port")
    s.add_argument("--store-dir", default=None,
                   help="embedded broker's object-store directory (default: in memory)")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    b = sub.add_parser("broker", help="run the embedded NATS broker + object store")
    b.add_argument("--port", type=int, default=4222)
    b.add_argument("--store-dir", default="./nats_data")
    r = sub.add_parser("route", help="run the cluster router")
    r.add_argument("--max-attempts", type=int, default=3)
    sub.add_parser("obs", help="run the fleet metrics/trace aggregator")
    g = sub.add_parser("gateway", help="run the OpenAI-compatible HTTP gateway")
    g.add_argument("--host", default=None)
    g.add_argument("--port", type=int, default=None)
    g.add_argument("--max-attempts", type=int, default=3)
    p = sub.add_parser("publish", help="import a GGUF and upload it to the bucket")
    p.add_argument("gguf")
    p.add_argument("model_id")
    c = sub.add_parser("chat", help="send a chat request over NATS")
    c.add_argument("model_id")
    c.add_argument("prompt")
    c.add_argument("--max-tokens", type=int, default=256)
    c.add_argument("--temperature", type=float, default=0.8)
    c.add_argument("--stream", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    run = {"serve": _run_serve, "broker": _run_broker, "route": _run_route, "obs": _run_obs,
           "gateway": _run_gateway, "publish": _run_publish, "chat": _run_chat}[args.cmd]
    return asyncio.run(run(args)) or 0


if __name__ == "__main__":
    sys.exit(main())
