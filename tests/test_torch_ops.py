"""The port's ops (nats_llm_studio_tpu_torch.ops / engine.sampling) against
the JAX package's, on the same numpy inputs, in float32.

The attention functions are the plain PyTorch versions of the CUDA kernels
K1-K3 (a wrapper given CPU tensors runs its plain version); the JAX side runs
its Pallas kernels in interpret mode (``*_auto`` off-TPU). Tolerance
rtol=atol=2e-5 is the f32 tolerance of tests/test_flash_attention.py. The
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py. TF32 is switched off so no f32 matmul is rounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nats_llm_studio_tpu.engine import sampling as jsampling
from nats_llm_studio_tpu.ops import flash_attention as jflash
from nats_llm_studio_tpu.ops import kvcache as jkv
from nats_llm_studio_tpu.ops import layers as jlayers
from nats_llm_studio_tpu.ops import paged_attention as jpaged
from nats_llm_studio_tpu_torch.engine import sampling as tsampling
from nats_llm_studio_tpu_torch.ops import flash_attention as tflash
from nats_llm_studio_tpu_torch.ops import kvcache as tkv
from nats_llm_studio_tpu_torch.ops import layers as tlayers
from nats_llm_studio_tpu_torch.ops import paged_attention as tpaged

torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 32)
    w = _rand(rng, 32)
    for plus_one in (False, True):
        want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, plus_one)
        got = tlayers.rms_norm(_t(x), _t(w), 1e-5, plus_one)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    pos = np.array([[0, 1, 2, 7, 300], [9, 10, 11, 12, 13]], np.int32)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 16, 500000.0)
    tc, ts = tlayers.rope_cos_sin(_t(pos), 16, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    q = _rand(rng, 2, 5, 3, 16)
    want = jlayers.apply_rope(jnp.asarray(q), jc, js)
    got = tlayers.apply_rope(_t(q), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    wg, wu, wd = _rand(rng, 32, 48), _rand(rng, 32, 48), _rand(rng, 48, 32)
    for act in ("silu", "gelu"):
        want = jlayers.swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                              jnp.asarray(wd), act)
        got = tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-4)


def test_kv_pool_write_row_and_rows():
    rng = np.random.default_rng(1)
    nb, L, hkv, T, d = 8, 2, 2, 8, 16
    pool = _rand(rng, nb, L, hkv, T, d)
    # a 3-block row whose last block is null-padded, and a partial block
    row = _rand(rng, 1, L, hkv, 3 * T, d)
    bids = np.array([3, 5, 0], np.int32)
    want = jkv.kv_pool_write_row(jnp.asarray(pool), jnp.asarray(row), jnp.asarray(bids))
    got = tkv.kv_pool_write_row(_t(pool.copy()), _t(row), _t(bids))
    # the port skips null-block writes (junk either way): compare blocks 1..
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    short = _rand(rng, 1, L, hkv, 5, d)
    want = jkv.kv_pool_write_row(jnp.asarray(pool), jnp.asarray(short),
                                 jnp.asarray(np.array([6], np.int32)))
    got = tkv.kv_pool_write_row(_t(pool.copy()), _t(short), _t(np.array([6], np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    tbl = np.array([[1, 2, 0], [4, 0, 0]], np.int32)
    pos = np.array([13, 6], np.int32)
    rows = _rand(rng, 2, 3, hkv, d)
    want = jkv.kv_pool_write_rows(jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(tbl),
                                  jnp.asarray(pos), 1)
    got = tkv.kv_pool_write_rows(_t(pool.copy()), _t(rows), _t(tbl), _t(pos), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [1, 3])
def test_paged_decode_plain_matches_pallas(w):
    """K1: ragged positions, a slot whose table is all null blocks, layer 1."""
    rng = np.random.default_rng(2 + w)
    b, hq, hkv, d, T, L, nbp, nbt = 3, 4, 2, 16, 8, 2, 10, 4
    q = _rand(rng, b, w, hq, d)
    kp = _rand(rng, nbp, L, hkv, T, d)
    vp = _rand(rng, nbp, L, hkv, T, d)
    tbl = np.array([[3, 7, 0, 0], [1, 2, 5, 9], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 25, 4], np.int32)
    scale = d ** -0.5
    want = jpaged.paged_decode_attention_auto(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(pos), 1, scale)
    got = tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tbl), _t(pos), 1, scale)
    assert got.shape == (b, w, hq, d)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_plain_matches_pallas_ragged_t():
    """K2 at a sequence length that is no tile multiple."""
    rng = np.random.default_rng(4)
    b, t, hq, hkv, d = 2, 37, 4, 2, 16
    q, k, v = _rand(rng, b, t, hq, d), _rand(rng, b, t, hkv, d), _rand(rng, b, t, hkv, d)
    want = jflash.flash_attention_auto(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_chunk_plain_matches_pallas():
    """K3 at start > 0, with a second row whose prompt is shorter than
    start (its cache is zero past position 10): finite junk, same junk."""
    rng = np.random.default_rng(5)
    b, c, hq, hkv, d, kw, start = 2, 16, 4, 2, 16, 64, 24
    q = _rand(rng, b, c, hq, d)
    k, v = _rand(rng, b, hkv, kw, d), _rand(rng, b, hkv, kw, d)
    k[1, :, 10:] = 0.0
    v[1, :, 10:] = 0.0
    want = jflash.flash_attention_chunk_auto(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25, jnp.int32(start))
    got = tflash.flash_attention_chunk(_t(q), _t(k), _t(v), 0.25, start)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pick_matches_with_injected_noise():
    """_pick on shared Gumbel noise: greedy, full-vocab temperature,
    top-k, top-p and both, over a vocab wider than the candidate cap."""
    rng = np.random.default_rng(6)
    b, v = 6, 100
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    gumbel = rng.gumbel(size=(b, v)).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 0.9, 1.3, 0.5], np.float32)
    topk = np.array([0, 0, 5, 0, 10, 80], np.int32)
    topp = np.array([1.0, 1.0, 1.0, 0.9, 0.8, 1.0], np.float32)
    for _ in range(4):
        want = jsampling._pick(jnp.asarray(logits), jnp.asarray(gumbel),
                               jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp))
        got = tsampling._pick(_t(logits), _t(gumbel), _t(temp), _t(topk), _t(topp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        gumbel = rng.gumbel(size=(b, v)).astype(np.float32)


def _tied_logits(rng, b: int, v: int, temp: float):
    """bf16-valued logits (a 0.25 grid, so equal values are common) with
    forced ties: rows 0..b/2 tie ranks 3..7 (a top-k of 5 cuts inside the
    tie), rows b/2.. tie ranks 1..6 and get the top_p that puts the
    crossing inside the tie. Returns (logits, top_k, top_p)."""
    logits = (np.round(rng.standard_normal((b, v)) * 8) / 4).astype(np.float32)
    top_k = np.zeros(b, np.int32)
    top_p = np.ones(b, np.float32)
    for i in range(b):
        order = np.argsort(-logits[i], kind="stable")
        if i < b // 2:
            logits[i, order[3:8]] = logits[i, order[3]]
            top_k[i] = 5
        else:
            logits[i, order[1:7]] = logits[i, order[1]]
            z = np.sort(logits[i])[::-1].astype(np.float64) / temp
            cum = np.cumsum(np.exp(z - z.max())) / np.exp(z - z.max()).sum()
            top_p[i] = (cum[2] + cum[3]) / 2
    return logits, top_k, top_p


def test_pick_orders_tied_candidates_as_jax_top_k():
    """Ties at the top-k cut and at the top-p crossing: the candidates
    come in jax.lax.top_k's order (lower index first among equals), so the
    kept set and the drawn token equal the JAX _pick's on shared noise."""
    rng = np.random.default_rng(12)
    b, v, temp = 6, 100, 0.8  # the shapes of the test above: no new JAX compiles
    logits, topk, topp = _tied_logits(rng, b, v, temp)
    temps = np.full(b, temp, np.float32)
    for _ in range(4):
        gumbel = rng.gumbel(size=(b, v)).astype(np.float32)
        want = jsampling._pick(jnp.asarray(logits), jnp.asarray(gumbel),
                               jnp.asarray(temps), jnp.asarray(topk), jnp.asarray(topp))
        got = tsampling._pick(_t(logits), _t(gumbel), _t(temps), _t(topk), _t(topp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_rows_is_per_row_deterministic():
    """A row's draw depends on its (seed, step) only, not on its batch."""
    rng = np.random.default_rng(7)
    logits = _t(rng.standard_normal((3, 50)).astype(np.float32))
    a = tsampling.sample_rows(logits, [11, 12, 13], [4, 4, 4], [1.0, 1.0, 1.0], 0, 1.0)
    b = tsampling.sample_rows(logits[1:2], [12], [4], [1.0], 0, 1.0)
    assert int(a[1]) == int(b[0])
    g = tsampling.sample_rows(logits, [1, 2, 3], [0, 0, 0], [0.0, 0.0, 0.0], 0, 1.0)
    np.testing.assert_array_equal(g.numpy(), logits.argmax(-1).numpy())


def test_kernel_wrappers_leave_counters_at_zero_on_cpu():
    rng = np.random.default_rng(8)
    counters = (tpaged.paged_decode_attention, tpaged.paged_decode_attention_kvq,
                tflash.flash_attention, tflash.flash_attention_chunk,
                tflash.flash_attention_chunk_kvq)
    before = tuple(f.launches for f in counters)
    q = _t(_rand(rng, 1, 8, 2, 16))
    tflash.flash_attention(q, q, q, 0.25)
    tflash.flash_attention_chunk(q, q.transpose(1, 2), q.transpose(1, 2), 0.25, 0)
    kq = tkv.quantize_rows(q.transpose(1, 2))
    tflash.flash_attention_chunk_kvq(q, kq.q, kq.s, kq.q, kq.s, 0.25, 0)
    pool = _t(_rand(rng, 2, 1, 2, 8, 16))
    tbl, pos = torch.ones((1, 1), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)
    tpaged.paged_decode_attention(q[:, :1], pool, pool, tbl, pos, 0, 0.25)
    qpool = tkv.quantize_rows(pool)
    tpaged.paged_decode_attention(q[:, :1], qpool, qpool, tbl, pos, 0, 0.25)
    after = tuple(f.launches for f in counters)
    assert before == after == (0,) * len(counters)
