"""``python -m nats_llm_studio_tpu_torch serve [--embedded-broker] [--device cuda|cpu]``

Mirror of ``nats_llm_studio_tpu/main.py`` ``_run_serve`` for the port: a
``Worker`` over a ``TorchRegistry`` of ``LMSTUDIO_MODELS_DIR``, optionally
behind an in-process broker, with the KV cache that ``TPU_KV_QUANT``
("none" or "int8") names. The device defaults to the card; with no card
the command fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from .config import WorkerConfig

log = logging.getLogger("nats_llm_studio_tpu_torch")


async def _run_serve(args: argparse.Namespace) -> None:
    from .serve.registry import TorchRegistry
    from .serve.worker import Worker
    from .transport import EmbeddedBroker

    cfg = WorkerConfig()
    registry = TorchRegistry(
        cfg.models_dir, device=args.device, max_seq_len=cfg.max_seq_len,
        max_batch_slots=cfg.max_batch_slots, kv_quant=cfg.kv_quant_mode,
    )
    broker = None
    if args.embedded_broker:
        broker = await EmbeddedBroker(port=args.port).start()
        cfg.nats_url = broker.url
        log.info("embedded broker on %s", broker.url)
    worker = Worker(cfg, registry)
    await worker.start()
    log.info("worker serving %s.* on %s (device %s, kv cache %s, models: %s)",
             cfg.subject_prefix, cfg.nats_url, registry.device, registry.kv_quant,
             cfg.models_dir)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    log.info("draining...")
    await worker.drain()
    await registry.close()
    if broker is not None:
        await broker.stop()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="nats_llm_studio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run a worker on the card")
    s.add_argument("--embedded-broker", action="store_true",
                   help="run an in-process NATS broker and serve on it")
    s.add_argument("--port", type=int, default=4222, help="embedded broker port")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.cmd == "serve":
        asyncio.run(_run_serve(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
