"""The port's model (nats_llm_studio_tpu_torch.models) against the JAX
package's on one tiny F32 GGUF, loaded by both packages.

Logits must agree within 2e-4 (the tolerance of tests/test_hf_parity.py)
for a fresh prefill, a two-chunk continuation and three paged decode
steps, each with the KV cache in f32 ("none") and as int8 codes with f32
scales ("int8", TPU_KV_QUANT=int8). The JAX side runs with flash attention
on, so its Pallas kernels run in interpret mode; the port's kernel wrappers
run their plain versions on CPU tensors. TF32 is switched off so no f32
matmul is rounded. Under int8 the two packages quantize slightly different
f32 rows, so a code may differ by one step where a row sits on a rounding
edge: caches are compared code by code within one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nats_llm_studio_tpu.gguf.reader import open_gguf as j_open_gguf
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.models.export import export_params_to_gguf
from nats_llm_studio_tpu.ops import kvcache as jkv
from nats_llm_studio_tpu_torch.gguf.reader import open_gguf as t_open_gguf
from nats_llm_studio_tpu_torch.models import llama as tllama
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import kvq_from_numpy, params_from_numpy
from nats_llm_studio_tpu_torch.ops.kvcache import is_quantized

torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-4, atol=2e-4)
S = 64  # row-cache length


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cfg = JConfig.tiny(n_layers=2, max_seq_len=S)
    jparams0 = jllama.init_params(cfg, jax.random.PRNGKey(3))
    path = tmp_path_factory.mktemp("gguf") / "tiny.gguf"
    export_params_to_gguf(path, jparams0, cfg)
    with j_open_gguf(str(path)) as r:
        jcfg = JConfig.from_gguf_metadata(r.metadata).with_(
            dtype="float32", use_flash_attention=True)
        jparams = jllama.ensure_lm_head(jllama.load_params_from_gguf(r, jcfg))
    with t_open_gguf(str(path)) as r:
        tcfg = TConfig.from_gguf_metadata(r.metadata).with_(dtype="float32")
        tparams = tllama.ensure_lm_head(tllama.load_params_from_gguf(r, tcfg, device="cpu"))
    return jcfg, jparams, tcfg, tparams, jparams0


KV_MODES = ["none", "int8"]


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(1, 500, size=(1, n)).astype(np.int32)


def _with_kv(models, kv_quant):
    jcfg, jparams, tcfg, tparams, _ = models
    return jcfg.with_(kv_quant=kv_quant), jparams, tcfg.with_(kv_quant=kv_quant), tparams


def _to_torch(cache):
    """A JAX cache or pool (array or KVQ) as the port's, on the CPU."""
    if jkv.is_quantized(cache):
        return kvq_from_numpy(np.asarray(cache.q), np.asarray(cache.s), "cpu")
    return torch.from_numpy(np.array(cache))


def _assert_cache_close(got, want, sl=np.s_[...]):
    """Caches agree: f32 values within TOL, or int8 codes within one step
    and scales within TOL."""
    if is_quantized(got):
        dq = np.abs(got.q.numpy()[sl].astype(np.int32) - np.asarray(want.q)[sl].astype(np.int32))
        assert dq.max() <= 1
        np.testing.assert_allclose(got.s.numpy()[sl], np.asarray(want.s)[sl], **TOL)
    else:
        np.testing.assert_allclose(got.numpy()[sl], np.asarray(want)[sl], **TOL)


def test_params_from_numpy_matches_gguf_load(models):
    jcfg, jparams, tcfg, tparams, jparams0 = models
    conv = params_from_numpy(jax.tree.map(np.asarray, jparams0), "cpu", "float32")
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm"):
        np.testing.assert_array_equal(conv["blocks"][k].numpy(), tparams["blocks"][k].numpy())
    np.testing.assert_array_equal(conv["embed"].numpy(), tparams["embed"].numpy())
    np.testing.assert_array_equal(conv["lm_head"].numpy(), tparams["lm_head"].numpy())


@pytest.mark.parametrize("kv_quant", KV_MODES)
def test_fresh_prefill_logits(models, kv_quant):
    jcfg, jparams, tcfg, tparams = _with_kv(models, kv_quant)
    toks = _tokens(21, 0)
    jk, jv = jllama.make_cache(jcfg, 1, S)
    want, jk, _ = jllama.forward(jparams, jcfg, jnp.asarray(toks), jk, jv,
                                 jnp.zeros((1,), jnp.int32), fresh_prefill=True)
    tk, tv = tllama.make_cache(tcfg, 1, S, device="cpu")
    got, tk, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tk, tv,
                                torch.zeros((1,), dtype=torch.int32), fresh_prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert is_quantized(tk) == (kv_quant == "int8")
    _assert_cache_close(tk, jk)


@pytest.mark.parametrize("kv_quant", KV_MODES)
def test_two_chunk_continuation_logits(models, kv_quant):
    """First chunk at start 0 (K2 branch), second at start 16 over a
    32-token window (K3 branch, K4 under int8), each returning the
    chunk-end logits."""
    jcfg, jparams, tcfg, tparams = _with_kv(models, kv_quant)
    toks = _tokens(28, 1)
    C, n = 16, 28
    jk, jv = jllama.make_cache(jcfg, 1, S)
    tk, tv = tllama.make_cache(tcfg, 1, S, device="cpu")
    for start in (0, 16):
        chunk = np.zeros((1, C), np.int32)
        part = toks[:, start:start + C]
        chunk[:, : part.shape[1]] = part
        last = min(n - 1 - start, C - 1)
        want, jk, jv = jllama.forward(
            jparams, jcfg, jnp.asarray(chunk), jk, jv, jnp.full((1,), start, jnp.int32),
            attn_window=32, logit_positions=jnp.asarray([last], jnp.int32),
            uniform_start=True)
        got, tk, tv = tllama.forward(
            tparams, tcfg, torch.from_numpy(chunk), tk, tv,
            torch.full((1,), start, dtype=torch.int32), attn_window=32,
            logit_positions=torch.tensor([last]), uniform_start=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(tk, jk, np.s_[:, :, :, :n])


@pytest.mark.parametrize("kv_quant", KV_MODES)
def test_three_paged_decode_steps(models, kv_quant):
    """Two slots at different lengths, prefilled into pool blocks, then
    three forward_decode_paged steps through the paged-decode kernels (K1,
    or K1q over an int8 pool)."""
    jcfg, jparams, tcfg, tparams = _with_kv(models, kv_quant)
    T, nbt = 8, 4
    nb = 1 + 2 * nbt
    shape = (nb, jcfg.n_layers, jcfg.n_kv_heads, T, jcfg.head_dim)
    quant = kv_quant == "int8"
    jkp = jkv.kv_pool_zeros(shape, jnp.float32, quant=quant)
    jvp = jkv.kv_pool_zeros(shape, jnp.float32, quant=quant)
    tbl = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lens = [13, 6]
    for i, n in enumerate(lens):
        toks = _tokens(16, 10 + i)
        jk, jv = jllama.make_cache(jcfg, 1, 16)
        _, jk, jv = jllama.forward(jparams, jcfg, jnp.asarray(toks), jk, jv,
                                   jnp.zeros((1,), jnp.int32), fresh_prefill=True)
        # the row's first n tokens are the prompt; junk past n is masked
        jkp = jkv_write(jkp, jk, tbl[i, :2])
        jvp = jkv_write(jvp, jv, tbl[i, :2])
    tkp, tvp = _to_torch(jkp), _to_torch(jvp)
    pos = np.array(lens, np.int32)
    tok = np.array([[7], [9]], np.int32)
    for step in range(3):
        want, jkp, jvp = jllama.forward_decode_paged(
            jparams, jcfg, jnp.asarray(tok), jkp, jvp, jnp.asarray(tbl), jnp.asarray(pos + step))
        got, tkp, tvp = tllama.forward_decode_paged(
            tparams, tcfg, torch.from_numpy(tok), tkp, tvp, torch.from_numpy(tbl),
            torch.from_numpy(pos + step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    _assert_cache_close(tkp, jkp, np.s_[1:])


def jkv_write(pool, row, bids):
    return jkv.kv_pool_write_row(pool, row, jnp.asarray(bids))
