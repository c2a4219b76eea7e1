"""Deterministic fault injection: the chaos harness behind the resilience
story (transport reconnect, engine supervision, slot suspend, KV tiers).

Copy of ``nats_llm_studio_tpu/transport/faults.py``, whole: the same sites,
rule grammar and ``CHAOS_SPEC`` / ``CHAOS_SEED`` wiring, so one spec drives
either package's worker.

A :class:`FaultPlan` is a seeded, step-indexed list of fault rules. Every
hook site (the six ``SITES`` below) calls
``plan.check(site, subject)`` once per event; each rule keeps its own count
of *matching* calls and fires exactly once, when that count passes the
rule's 0-based ``step``. Given a deterministic event sequence the firing
point is deterministic — tests assert exact recovery behavior instead of
sleeping and hoping.

Off ⇒ zero cost: with no plan installed every hook is a single module
attribute read (``faults.ACTIVE is None``) — no allocation, no lock, no
branch into this module. Production paths pay nothing.

Env wiring (parsed by :func:`plan_from_env`, installed by ``__main__ serve``):

    CHAOS_SPEC="sever@broker.publish:3:subject=lmstudio.chat_model;raise@batcher.pump:40"
    CHAOS_SEED=0

Rule grammar: ``kind@site:step[:key=value]...`` where ``kind`` is one of
``sever`` | ``drop`` | ``delay`` | ``raise``, ``site`` is a hook-site name
below, ``step`` is the 0-based matching-call index at which the rule fires,
and optional keys are ``subject=<pattern>`` (NATS wildcard filter — only
matching publishes count), ``client=<glob>`` (connection-name filter: only
events from a client whose CONNECT name matches count — the worker-scoped
kill switch, since every worker connects as ``tpu-worker-<worker_id>``),
``delay=<seconds>`` and ``msg=<text>``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from dataclasses import dataclass, field
from fnmatch import fnmatchcase

from ..utils import subject_matches

log = logging.getLogger(__name__)

# hook-site names — the stable fault-injection surface
BROKER_PUBLISH = "broker.publish"  # a client's PUB/HPUB arriving at the broker
PUMP = "batcher.pump"              # one batcher owner-loop iteration
CLIENT_CONNECT = "client.connect"  # one NatsClient dial attempt (incl. reconnects)
TIER_SPILL = "tier.spill"          # one host-tier → Object Store blob write
TIER_FETCH = "tier.fetch"          # one Object Store → host-tier blob read
SUSPEND = "batcher.suspend"        # one slot suspend attempt (swap-don't-shed)

SITES = (BROKER_PUBLISH, PUMP, CLIENT_CONNECT, TIER_SPILL, TIER_FETCH, SUSPEND)
KINDS = ("sever", "drop", "delay", "raise")


class InjectedFault(RuntimeError):
    """Raised inside a hooked loop by a ``raise`` rule."""


@dataclass
class Fault:
    site: str
    step: int  # fires on the (step+1)-th MATCHING check() call (0-based index)
    kind: str  # "sever" | "drop" | "delay" | "raise"
    subject: str | None = None  # NATS wildcard filter; None matches everything
    client: str | None = None  # connection-name glob; None matches everything
    delay_s: float = 0.0
    message: str = "injected fault (chaos)"
    fired: bool = False
    hits: int = 0  # matching check() calls observed so far

    def exception(self) -> BaseException:
        return InjectedFault(self.message)

    def describe(self) -> str:
        s = f"{self.kind}@{self.site}:{self.step}"
        if self.subject:
            s += f":subject={self.subject}"
        if self.client:
            s += f":client={self.client}"
        if self.kind == "delay":
            s += f":delay={self.delay_s}"
        return s


class FaultPlan:
    """Seeded, step-indexed fault schedule. Thread-safe: ``check`` is called
    from the asyncio loop (broker/client hooks) AND batcher owner threads."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)  # reserved for probabilistic rules
        self.faults: list[Fault] = []
        self.log: list[dict] = []  # fired rules, in firing order (test asserts)
        self._lock = threading.Lock()

    # -- rule constructors (chainable) -------------------------------------------

    def add(self, fault: Fault) -> "FaultPlan":
        if fault.site not in SITES:
            raise ValueError(f"unknown fault site {fault.site!r} (have {SITES})")
        if fault.kind not in KINDS:
            raise ValueError(f"unknown fault kind {fault.kind!r} (have {KINDS})")
        self.faults.append(fault)
        return self

    def sever(self, site: str, step: int, subject: str | None = None,
              client: str | None = None) -> "FaultPlan":
        return self.add(
            Fault(site=site, step=step, kind="sever", subject=subject, client=client)
        )

    def sever_worker(self, worker_id: str, step: int,
                     subject: str | None = None) -> "FaultPlan":
        """Worker-scoped kill switch: sever the connection of the worker
        whose id is ``worker_id`` on its (step+1)-th matching publish — the
        wire-level equivalent of kill -9 on that worker, mid-flight. Matches
        the ``tpu-worker-<worker_id>`` CONNECT name serve/worker.py uses."""
        return self.sever(BROKER_PUBLISH, step, subject=subject,
                          client=f"tpu-worker-{worker_id}")

    def drop(self, site: str, step: int, subject: str | None = None) -> "FaultPlan":
        return self.add(Fault(site=site, step=step, kind="drop", subject=subject))

    def delay(self, site: str, step: int, delay_s: float,
              subject: str | None = None) -> "FaultPlan":
        return self.add(
            Fault(site=site, step=step, kind="delay", delay_s=delay_s, subject=subject)
        )

    def raise_at(self, site: str, step: int, message: str | None = None) -> "FaultPlan":
        f = Fault(site=site, step=step, kind="raise")
        if message:
            f.message = message
        return self.add(f)

    # -- hook API ------------------------------------------------------------

    def check(
        self, site: str, subject: str | None = None, client: str | None = None
    ) -> Fault | None:
        """Count one event at ``site`` against every matching rule; return
        the first rule that fires on this event (None otherwise). A rule
        fires exactly once, when its matching-call count passes ``step``.
        ``client`` is the originating connection's CONNECT name, for
        client-scoped (worker-scoped) rules."""
        if not self.faults:
            return None
        with self._lock:
            hit: Fault | None = None
            for f in self.faults:
                if f.site != site:
                    continue
                if f.subject is not None and not (
                    subject is not None and subject_matches(f.subject, subject)
                ):
                    continue
                if f.client is not None and not fnmatchcase(client or "", f.client):
                    continue
                f.hits += 1
                if not f.fired and f.hits > f.step:
                    f.fired = True
                    entry = {"site": site, "kind": f.kind, "step": f.step,
                             "subject": subject}
                    if f.client is not None:
                        # only client-scoped rules record the connection
                        # name: the log-entry shape of existing rules is a
                        # test contract
                        entry["client"] = client
                    self.log.append(entry)
                    if hit is None:
                        hit = f
            return hit

    def fired(self, site: str | None = None) -> list[dict]:
        with self._lock:
            return [e for e in self.log if site is None or e["site"] == site]

    def done(self) -> bool:
        """True when every rule has fired (chaos tests assert this)."""
        with self._lock:
            return all(f.fired for f in self.faults)

    def describe(self) -> str:
        rules = ";".join(f.describe() for f in self.faults)
        return f"seed={self.seed} {rules or '(empty)'}"


# module-global active plan: the single attribute hooks read. None in
# production — the whole harness costs one `is None` check per hook event.
ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan | None) -> FaultPlan | None:
    """Install (or, with None, clear) the process-wide fault plan."""
    global ACTIVE
    ACTIVE = plan
    if plan is not None:
        log.warning("chaos fault plan installed: %s", plan.describe())
    return plan


def clear() -> None:
    install(None)


def plan_from_env(environ=None) -> FaultPlan | None:
    """Build a plan from ``CHAOS_SPEC`` / ``CHAOS_SEED`` (None when unset).
    See the module docstring for the rule grammar."""
    env = os.environ if environ is None else environ
    spec = (env.get("CHAOS_SPEC") or "").strip()
    if not spec:
        return None
    try:
        seed = int((env.get("CHAOS_SEED") or "0").strip() or 0)
    except ValueError:
        seed = 0
    plan = FaultPlan(seed)
    for rule in spec.split(";"):
        rule = rule.strip()
        if not rule:
            continue
        try:
            kind, rest = rule.split("@", 1)
            parts = rest.split(":")
            site = parts[0]
            step = int(parts[1])
            f = Fault(site=site, step=step, kind=kind.strip())
            for extra in parts[2:]:
                key, _, val = extra.partition("=")
                if key == "subject":
                    f.subject = val
                elif key == "client":
                    f.client = val
                elif key == "delay":
                    f.delay_s = float(val)
                elif key == "msg":
                    f.message = val
                else:
                    raise ValueError(f"unknown key {key!r}")
            plan.add(f)
        except (ValueError, IndexError) as e:
            raise ValueError(f"bad CHAOS_SPEC rule {rule!r}: {e}") from None
    return plan
