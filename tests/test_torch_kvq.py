"""The port's int8 KV cache (TPU_KV_QUANT=int8) against the JAX package's,
on the same numpy inputs, in float32.

* ``quantize_rows``: the same codes bit for bit and the same scales;
* K1q (``paged_decode_attention`` over a KVQ pool) and K4
  (``flash_attention_chunk_kvq``): the plain PyTorch versions (a wrapper
  given CPU tensors runs its plain version) against the Pallas kernels in
  interpret mode, rtol=atol=2e-5 (the f32 tolerance of
  tests/test_flash_attention.py), and K1q once more with bf16 q, atol
  2e-2 (its bf16 tolerance); the CUDA kernels are held against these
  plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py;
* the KVQ branch of ``gqa_attention_hmajor``, 2e-5;
* the paged batcher: greedy tokens identical to the JAX ContinuousBatcher
  with its Pallas kernels, a short stream beside a prompt longer than the
  serving chunk, so both admit it in the same chunks.

TF32 is switched off so no f32 matmul is rounded.
"""

import asyncio
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine.generator import SamplingParams as JSamplingParams
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.ops import flash_attention as jflash
from nats_llm_studio_tpu.ops import kvcache as jkv
from nats_llm_studio_tpu.ops import layers as jlayers
from nats_llm_studio_tpu.ops import paged_attention as jpaged
from nats_llm_studio_tpu.serve.batcher import ContinuousBatcher as JBatcher
from nats_llm_studio_tpu_torch.engine.generator import SamplingParams as TSamplingParams
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import kvq_from_numpy, params_from_numpy
from nats_llm_studio_tpu_torch.ops import flash_attention as tflash
from nats_llm_studio_tpu_torch.ops import kvcache as tkv
from nats_llm_studio_tpu_torch.ops import layers as tlayers
from nats_llm_studio_tpu_torch.ops import paged_attention as tpaged
from nats_llm_studio_tpu_torch.serve.batcher import ContinuousBatcher as TBatcher

torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quantized(x):
    """x quantized by the JAX package, and the same codes as the port's KVQ."""
    jq = jkv.quantize_rows(jnp.asarray(x))
    return jq, kvq_from_numpy(np.asarray(jq.q), np.asarray(jq.s), "cpu")


def test_quantize_rows_matches_bit_for_bit():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 2, 40, 16) * rng.uniform(0.01, 30.0, size=(3, 2, 40, 1)).astype(np.float32)
    x[0, 1, 5] = 0.0  # an all-zero row: scale 1, codes 0
    x[2, 0, 7, :4] = [0.5, -0.5, 1.5, -2.5]  # exact halves round to even
    x[2, 0, 7, 4] = 127.0
    want = jkv.quantize_rows(jnp.asarray(x))
    got = tkv.quantize_rows(_t(x))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert got.s[0, 1, 5] == 1.0 and not got.q[0, 1, 5].any()


def test_kvq_pool_writes_match():
    """kv_pool_write_rows quantizes on write into both leaves;
    kv_pool_write_row copies an already-quantized row block by block."""
    rng = np.random.default_rng(1)
    nb, L, hkv, T, d = 8, 2, 2, 8, 16
    jpool = jkv.kv_pool_zeros((nb, L, hkv, T, d), quant=True)
    tpool = tkv.kv_pool_zeros((nb, L, hkv, T, d), torch.float32, "cpu", quant=True)
    row, trow = _quantized(_rand(rng, 1, L, hkv, 2 * T, d))
    bids = np.array([3, 5], np.int32)
    jpool = jkv.kv_pool_write_row(jpool, row, jnp.asarray(bids))
    tkv.kv_pool_write_row(tpool, trow, _t(bids))
    tbl = np.array([[1, 2, 0], [4, 0, 0]], np.int32)
    pos = np.array([13, 6], np.int32)
    rows = _rand(rng, 2, 3, hkv, d)
    jpool = jkv.kv_pool_write_rows(jpool, jnp.asarray(rows), jnp.asarray(tbl),
                                   jnp.asarray(pos), 1)
    tkv.kv_pool_write_rows(tpool, _t(rows), _t(tbl), _t(pos), 1)
    np.testing.assert_array_equal(tpool.q.numpy(), np.asarray(jpool.q))
    np.testing.assert_array_equal(tpool.s.numpy(), np.asarray(jpool.s))
    assert tkv.kv_nbytes(tpool) == jkv.kv_nbytes(jpool)


@pytest.mark.parametrize("w,dtype", [
    pytest.param(1, "float32", id="1"),
    pytest.param(3, "float32", id="3"),
    pytest.param(3, "bfloat16", id="bf16-3"),
])
def test_paged_decode_kvq_plain_matches_pallas(w, dtype):
    """K1q: GQA group 4, T 16, ragged positions, a slot whose table is all
    null blocks (codes 0, scales 1), layer 1. In bf16 (q, and the output)
    both sides round code x scale to bf16 and p to bf16 before the PV
    product, where the tensor-core body rounds: 2e-2, the bf16 tolerance
    of tests/test_flash_attention.py:184."""
    rng = np.random.default_rng(2 + w)
    b, hq, hkv, d, T, L, nbp, nbt = 3, 8, 2, 16, 16, 2, 8, 3
    q = _rand(rng, b, w, hq, d)
    shape = (nbp, L, hkv, T, d)
    jk, tk = _quantized(_rand(rng, *shape))
    jv, tv = _quantized(_rand(rng, *shape))
    for jp, tp in ((jk, tk), (jv, tv)):  # the null block as the pool keeps it
        jp.q, jp.s = jp.q.at[0].set(0), jp.s.at[0].set(1.0)
        tp.q[0], tp.s[0] = 0, 1.0
    tbl = np.array([[3, 7, 0], [1, 2, 5], [0, 0, 0]], np.int32)
    pos = np.array([17, 44 - w, 4], np.int32)
    scale = d ** -0.5
    want = jpaged.paged_decode_attention(
        jnp.asarray(q, dtype=dtype), jk, jv, jnp.asarray(tbl), jnp.asarray(pos), 1, scale,
        interpret=True)
    got = tpaged.paged_decode_attention(_t(q).to(getattr(torch, dtype)), tk, tv, _t(tbl),
                                        _t(pos), 1, scale)
    assert got.shape == (b, w, hq, d) and got.dtype == getattr(torch, dtype)
    assert torch.isfinite(got).all()
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32), **tol)


@pytest.mark.parametrize("b,c,kw,start,hq,hkv,d,bq,bk", [
    (1, 16, 64, 16, 4, 2, 16, 16, 32),   # mid chunk with history, GQA 2
    (2, 16, 64, 48, 8, 2, 16, 16, 32),   # last chunk, GQA group 4
    (1, 24, 96, 40, 4, 2, 16, 16, 32),   # unaligned start vs tiles
])
def test_flash_chunk_kvq_plain_matches_pallas(b, c, kw, start, hq, hkv, d, bq, bk):
    """K4 at the shapes of tests/test_flash_attention.py's KVQ case."""
    rng = np.random.default_rng(10 + start)
    q = _rand(rng, b, c, hq, d)
    jk, tk = _quantized(_rand(rng, b, hkv, kw, d))
    jv, tv = _quantized(_rand(rng, b, hkv, kw, d))
    scale = d ** -0.5
    want = jflash.flash_attention_chunk_kvq(
        jnp.asarray(q), jk.q, jk.s, jv.q, jv.s, scale, jnp.int32(start),
        block_q=bq, block_k=bk, interpret=True)
    got = tflash.flash_attention_chunk_kvq(_t(q), tk.q, tk.s, tv.q, tv.s, scale, start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gqa_attention_hmajor_kvq_matches():
    """The dense KVQ branch (scales folded outside the products), with a
    ragged mask, as the t == 1 and ragged-start paths use it."""
    rng = np.random.default_rng(20)
    b, t, hq, hkv, s, d = 2, 3, 8, 2, 24, 16
    q = _rand(rng, b, t, hq, d)
    jk, tk = _quantized(_rand(rng, b, hkv, s, d))
    jv, tv = _quantized(_rand(rng, b, hkv, s, d))
    qpos = np.array([[5, 6, 7], [20, 21, 22]])
    mask = np.arange(s)[None, None, :] <= qpos[:, :, None]
    want = jlayers.gqa_attention_hmajor(jnp.asarray(q), jk, jv, jnp.asarray(mask), 0.25)
    got = tlayers.gqa_attention_hmajor(_t(q), tk, tv, _t(mask), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the batcher ----------------------------------------------------------------

MAX_SEQ, CHUNK = 32, 16
SHORT = [5, 9, 2, 7, 3]
LONG = [(i * 7 + 3) % 500 for i in range(20)]  # two chunks: K2, then K4


class _TorchBatcher(TBatcher):
    PREFILL_CHUNK = CHUNK


async def _stream_then_long(submit, sp):
    """A short greedy stream; once its first token is out, a prompt longer
    than the serving chunk, which is then prefilled in chunks beside it."""
    first = asyncio.Event()

    async def short():
        out = []
        async for t in submit(SHORT, sp(24)):
            out.append(t)
            first.set()
        return out

    task = asyncio.ensure_future(short())
    await first.wait()
    long = [t async for t in submit(LONG, sp(6))]
    return await task, long


@async_test
async def test_kvq_batcher_greedy_matches_jax():
    cfg = JConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, use_flash_attention=True,
                       kv_quant="int8")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    old = os.environ.get("DECODE_KERNEL")
    os.environ["DECODE_KERNEL"] = "pallas"
    try:
        jb = JBatcher(jparams, cfg, max_slots=2, max_seq_len=MAX_SEQ, paged=True,
                      prefill_chunk=CHUNK)
    finally:
        if old is None:
            os.environ.pop("DECODE_KERNEL")
        else:
            os.environ["DECODE_KERNEL"] = old
    assert jb.decode_kernel == "pallas"
    try:
        want = await _stream_then_long(
            jb.submit, lambda n: JSamplingParams(temperature=0.0, max_tokens=n))
    finally:
        jb.stop()

    tcfg = TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, kv_quant="int8")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", "float32")
    tb = _TorchBatcher(tparams, tcfg, max_slots=2, max_seq_len=MAX_SEQ)
    try:
        got = await _stream_then_long(
            tb.submit, lambda n: TSamplingParams(temperature=0.0, max_tokens=n))
        assert tb.stats.program_calls.get("prefill1") == 2  # admitted in two chunks
        pool = tb.pool_stats()  # codes of D bytes + a 4-byte scale per row
        rows = (pool["blocks_total"] + 1) * tcfg.n_layers * tcfg.n_kv_heads * 16
        assert pool["kv_quant"] == "int8"
        assert pool["bytes"] == 2 * rows * (tcfg.head_dim + 4)
    finally:
        tb.stop()
    assert got == want
    assert len(got[0]) == 24 and len(got[1]) == 6
