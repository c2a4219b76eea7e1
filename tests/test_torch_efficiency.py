"""The port's efficiency plane (``obs/roofline.py`` and the batcher's
device-time ledger) against the JAX package, on the CPU.

* ``resolve_chip_peaks``: the H100 parts by ``torch.cuda.get_device_name``
  (the PCIe and NVL parts before the SXM one), the ``TPU_PEAK_FLOPS`` /
  ``TPU_HBM_GBPS`` overrides and the CPU fallback, which equal the JAX
  package's.
* ``ForwardCost``: one tiny prefill and one decode burst against the closed
  form; through the batcher, each program's flops and bytes equal the
  count of the shapes it dispatched, whatever body ran the attention.
* The device-time ledger: the same traffic (a greedy request whose
  speculative drafts are partly rejected, a stream its consumer leaves, a
  stream aborted past its deadline) through the JAX ``ContinuousBatcher``
  and the port's gives the same categories and the same served tokens.
* ``HbmLedger``: fires once on a rising series, stays quiet below the
  threshold, and is inert on the CPU.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine.generator import SamplingParams as JSamplingParams
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.obs import roofline as jroofline
from nats_llm_studio_tpu.serve.batcher import ContinuousBatcher as JBatcher
from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import params_from_numpy
from nats_llm_studio_tpu_torch.obs import roofline
from nats_llm_studio_tpu_torch.serve.batcher import ContinuousBatcher

MAX_SEQ, CHUNK, K = 64, 8, 4
# a cycle: prompt lookup drafts it, and the random model rejects part of it
CYCLE = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
    ("NVIDIA H100 NVL", (835e12, 3.9e12)),
    ("cpu", (5e11, 5e10)),
    ("", (5e11, 5e10)),
])
def test_chip_peaks_of_the_h100_parts(name, want, monkeypatch):
    monkeypatch.delenv("TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TPU_HBM_GBPS", raising=False)
    assert roofline.resolve_chip_peaks(name) == want
    if want == (5e11, 5e10):  # the fallback is the reference's
        assert jroofline.resolve_chip_peaks(name) == want
    # the overrides win over the table, as in the reference
    monkeypatch.setenv("TPU_PEAK_FLOPS", "1.5e14")
    monkeypatch.setenv("TPU_HBM_GBPS", "1200")
    assert roofline.resolve_chip_peaks(name) == (1.5e14, 1.2e12)
    assert jroofline.resolve_chip_peaks("cpu") == (1.5e14, 1.2e12)
    monkeypatch.setenv("TPU_PEAK_FLOPS", "not-a-number")
    assert roofline.resolve_chip_peaks(name)[0] == want[0]
    assert roofline.chip_peaks(None) == roofline.resolve_chip_peaks("cpu")


def _closed_form(cfg, rows, tokens, ctx, logit_rows, steps, kv_quant):
    """Flops and bytes of ``steps`` forwards of ``rows`` x ``tokens`` query
    tokens, written out term by term."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    hq, hkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    mm = L * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff)
    kvtok = L * hkv * 2 * ((hd + 4) if kv_quant == "int8" else hd * 4)
    flops = by = 0.0
    for s in range(steps):
        for c in ctx:
            start = c + s * tokens
            pairs = sum(start + j + 1 for j in range(tokens))
            flops += 2 * mm * tokens + 4 * L * hq * hd * pairs
            by += kvtok * (start + tokens) + kvtok * tokens
        flops += 2 * d * V * logit_rows
        by += (mm + d * V) * 4 + 4 * V * logit_rows
    return flops, by


@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("rows,tokens,ctx,logit_rows,steps", [
    (1, 16, (0,), 1, 1),  # a fresh prefill
    (1, 8, (24,), 1, 1),  # a chunk at 24
    (4, 1, (3, 17, 0, 40), 4, 5),  # a decode burst of 5 steps
    (2, 5, (9, 30), 10, 1),  # a verify of width 5
])
def test_forward_cost_closed_form(kv, rows, tokens, ctx, logit_rows, steps):
    cfg = TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, kv_quant=kv)
    got = roofline.ForwardCost(cfg)(rows, tokens, ctx, logit_rows, steps)
    want = _closed_form(cfg, rows, tokens, ctx, logit_rows, steps, kv)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the static part is cached per shape; the ctx part is not
    fc = roofline.ForwardCost(cfg)
    assert fc(rows, tokens, ctx, logit_rows, steps) == fc(rows, tokens, ctx, logit_rows, steps)
    assert fc(rows, tokens, [c + 1 for c in ctx], logit_rows, steps)[0] > got[0]


@pytest.fixture(scope="module")
def model():
    cfg = JConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, use_flash_attention=True)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", "float32")
    return cfg, params, tparams


def _slow(b, names, gate):
    """Wrap the named decode programs of ``b`` to sleep 80 ms a dispatch
    while ``gate["on"]``: a stream then outlives a short deadline."""
    for name in names:
        fn = getattr(b, name, None)
        if fn is None:
            continue

        def slow(*a, _fn=fn, **kw):
            if gate["on"]:
                time.sleep(0.08)
            return _fn(*a, **kw)

        setattr(b, name, slow)


async def _ledger_traffic(b, sp_cls, gate):
    """A greedy request over a cycle (verifies; some drafts rejected), a
    stream whose consumer leaves after its first tokens, and a stream
    aborted when its deadline passes mid-decode."""
    served = [t async for t in b.submit(CYCLE, sp_cls(temperature=0.0, max_tokens=16))]
    agen = b.submit_batched([9, 3, 17, 2], sp_cls(temperature=0.0, max_tokens=40))
    await agen.__anext__()
    await agen.aclose()
    gate["on"] = True
    # cold rate estimates (the JAX one holds its first compile): the
    # deadline is then only checked against the clock, and passes mid-decode
    b._prefill_rate_ewma = b._decode_spt_ewma = 0.0
    with pytest.raises(Exception, match="deadline exceeded mid-decode"):
        async for _ in b.submit([4, 8, 15, 16, 23], sp_cls(temperature=0.0, max_tokens=48),
                                deadline=time.monotonic() + 0.4):
            pass
    gate["on"] = False
    t_end = time.monotonic() + 5.0
    while b.stats.cancelled < 2 and time.monotonic() < t_end:
        await asyncio.sleep(0.01)
    return served


@async_test
async def test_device_time_ledger_equals_jax(model, monkeypatch):
    cfg, params, tparams = model
    kw = dict(max_slots=4, max_seq_len=MAX_SEQ, prefill_chunk=CHUNK, spec_decode_k=K,
              decode_burst=2)
    monkeypatch.setenv("DECODE_KERNEL", "pallas")
    gate = {"on": False}
    jb = JBatcher(params, cfg, paged=True, **kw)
    _slow(jb, ("_decode_pos_pallas", "_spec_verify_pallas"), gate)
    try:
        jserved = await _ledger_traffic(jb, JSamplingParams, gate)
        jdt = jb.stats.device_time_snapshot()
        jtotal = jb.stats.dispatch_ms_total
    finally:
        jb.stop()
    tb = ContinuousBatcher(tparams, TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ), **kw)
    _slow(tb, ("_decode_pos_pallas", "_spec_verify_pallas"), gate)
    try:
        tserved = await _ledger_traffic(tb, SamplingParams, gate)
        dt = tb.stats.device_time_snapshot()
        flops, bytes_ = tb.stats.cost_counters()
        total = tb.stats.dispatch_ms_total
    finally:
        tb.stop()
    assert tserved == jserved

    def cats(d):
        return {c for c, ms in d["ms"].items() if ms > 0}

    assert cats(dt) == cats(jdt)
    assert {"served", "cancelled", "deadline_abort", "spec_rejected"} <= cats(dt)
    assert dt["tokens"] == jdt["tokens"]
    assert dt["tokens"]["served"] == len(tserved) == 16
    # every dispatch's ms lands in one category once the requests are gone
    assert sum(dt["ms"].values()) == pytest.approx(total, rel=1e-6)
    assert sum(jdt["ms"].values()) == pytest.approx(jtotal, rel=1e-6)
    # the analytic count covers exactly the forward-bearing programs
    assert set(flops) == set(bytes_) == {"prefill_full", "admit_fused_paged",
                                         "decode_pos_pallas", "spec_verify_pallas"}
    assert tb.stats.goodput_tokens_per_device_s() > 0


@async_test
async def test_program_costs_follow_the_dispatched_shapes(model):
    """Through the port's batcher: a short admit, a chunked prefill beside
    a live stream, and bursts; each program's flops are the sum of its
    dispatches' counts (the batcher's own shapes, replayed here)."""
    cfg, params, tparams = model
    tcfg = TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ)
    b = ContinuousBatcher(tparams, tcfg, max_slots=2, max_seq_len=MAX_SEQ,
                          prefill_chunk=CHUNK, decode_burst=2)
    fc = roofline.ForwardCost(tcfg)
    want: dict[str, float] = {}
    shapes = []
    for name in ("_admit_fused_paged", "_prefill1", "_decode_pos_pallas", "_finish_admit_paged"):
        inner = getattr(b, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            sh = b._shape  # the row contexts are the live list: copy them
            shapes.append((_name.lstrip("_"), sh and (*sh[:2], tuple(sh[2]), *sh[3:])))
            return _inner(*a, **kw)

        setattr(b, name, spy)
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=6)
        first = [t async for t in b.submit([1, 2, 3], sp)]
        both = await asyncio.gather(
            *[_collect(b, p, sp) for p in ([4, 5, 6], list(range(10, 30)))])
        flops, bytes_ = b.stats.cost_counters()
    finally:
        b.stop()
    assert len(first) == 6 and all(len(x) == 6 for x in both)
    for name, shape in shapes:
        if shape is not None:
            f, by = fc(*shape)
            want[name] = want.get(name, 0.0) + f
    assert "prefill1" in want and "decode_pos_pallas" in want
    assert {k: flops[k] for k in want} == pytest.approx(want, rel=1e-12)
    assert "finish_admit_paged" not in flops  # a pool write: not costed


async def _collect(b, prompt, sp):
    return [t async for t in b.submit(prompt, sp)]


def test_hbm_ledger_fires_once_on_a_leak_and_is_inert_on_the_cpu():
    events = []
    # +70, +140, +210 past the baseline fire once; the flat tail is quiet
    series = iter([1000, 1000, 1070, 1140, 1210, 1230, 1230, 1230, 1230])
    led = roofline.HbmLedger({"w": lambda: 100}, bytes_in_use_fn=lambda: next(series),
                             drift_threshold_bytes=64, sustain_ticks=3,
                             emit_fn=lambda kind, **f: events.append((kind, f)))
    jevents = []
    jseries = iter([1000, 1000, 1070, 1140, 1210, 1230, 1230, 1230, 1230])
    jled = jroofline.HbmLedger({"w": lambda: 100}, bytes_in_use_fn=lambda: next(jseries),
                               drift_threshold_bytes=64, sustain_ticks=3,
                               emit_fn=lambda kind, **f: jevents.append((kind, f)))
    drifts = [led.tick() for _ in range(9)]
    assert drifts == [jled.tick() for _ in range(9)]
    assert events == jevents and len(events) == 1 and events[0][0] == "hbm_drift"
    assert led.drift_events == 1 and led.last_sample() == jled.last_sample()
    # below the threshold: quiet
    quiet = roofline.HbmLedger({}, bytes_in_use_fn=iter(range(0, 600, 60)).__next__,
                               drift_threshold_bytes=1000, sustain_ticks=2)
    assert max(quiet.tick() for _ in range(10)) <= 1000 and quiet.drift_events == 0
    # the CPU has no allocator stats: zeros, no event
    cpu = roofline.HbmLedger({"w": lambda: 5},
                             bytes_in_use_fn=lambda: roofline._default_bytes_in_use(
                                 torch.device("cpu")))
    assert [cpu.tick() for _ in range(6)] == [0] * 6
    assert cpu.last_sample()["bytes_in_use"] == 0 and cpu.drift_events == 0
    assert roofline._default_bytes_in_use(torch.device("cpu")) is None
