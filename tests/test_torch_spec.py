"""The port's speculative decoding and ext path against the JAX package, on
the CPU, in float32.

* ``_log_weights``: exactly the JAX function's, with and without a mask, at
  the settings of ``tests/test_sampling_invariance.py`` and on tied
  bf16-valued logits at the top-k and top-p edges.
* ``spec_accept_from_noise`` fed JAX's own acceptance uniforms and Gumbel
  vectors (rebuilt here with ``jax.random`` as ``spec_accept_rows`` draws
  them): exactly the JAX ``spec_accept_rows``' tokens and counts, on
  greedy, sampled, top-k, top-p, masked and short-draft rows. The port's
  own noise keeps a row's draw independent of its batch.
* ``NGramIndex`` proposals equal the JAX copy's.
* Through the paged batcher on the tiny model, in both KV modes, against the
  JAX ``ContinuousBatcher(paged=True)`` with ``DECODE_KERNEL=pallas`` (its
  Pallas kernels in interpret mode) and speculative decoding on: greedy ids
  identical with spec on and off, including a verify with a short draft
  followed by a single-token step; the spec counters equal; then a
  schema-constrained greedy request beside a logprob request and a plain
  one: identical ids, logprobs within 2e-4 and identical top ids.

TF32 is switched off so no f32 matmul is rounded.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine import sampling as jsampling
from nats_llm_studio_tpu.engine.generator import SamplingParams as JSamplingParams
from nats_llm_studio_tpu.gguf.tokenizer import GGUFTokenizer as JTokenizer
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.serve import constrain as jconstrain
from nats_llm_studio_tpu.serve import spec as jspec
from nats_llm_studio_tpu.serve.batcher import ContinuousBatcher as JBatcher
from nats_llm_studio_tpu_torch.engine import sampling as tsampling
from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
from nats_llm_studio_tpu_torch.gguf.tokenizer import GGUFTokenizer as TTokenizer
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import params_from_numpy
from nats_llm_studio_tpu_torch.serve import constrain as tconstrain
from nats_llm_studio_tpu_torch.serve import spec as tspec
from nats_llm_studio_tpu_torch.serve.batcher import ContinuousBatcher
from test_torch_ops import _tied_logits

torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
torch.backends.cudnn.allow_tf32 = False

MAX_SEQ, CHUNK, K = 64, 8, 4
KV_MODES = ["none", "int8"]
# the settings of tests/test_sampling_invariance.py: (temperature, top_k, top_p)
SETTINGS = [(0.0, 0, 1.0), (0.8, 0, 1.0), (1.3, 5, 1.0), (0.7, 0, 0.9), (1.0, 8, 0.75)]
# tests/test_spec_decode.py's prompts: a cycle (drafts accepted), none
# repeated, and two more
SPEC_PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [1, 9, 3, 17, 2, 11],
                [2, 3, 2, 3, 2, 3, 2], [8]]
# integer/enum-only (tests/test_gateway_e2e.py): a length-bounded language
SCHEMA = {"type": "object",
          "properties": {"age": {"type": "integer"}, "tag": {"enum": ["alpha", "beta"]}}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tokenizer_md(vocab: int) -> dict:
    """A byte-level gpt2 vocabulary of ``vocab`` ids: the 256 bytes, fillers
    and an end-of-turn control token last."""
    from nats_llm_studio_tpu_torch.gguf.tokenizer import _byte_to_unicode

    b2u = _byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    tokens += [f"<filler_{i}>" for i in range(256, vocab - 1)] + ["<|eot|>"]
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": [1] * (vocab - 1) + [3],
        "tokenizer.ggml.merges": [],
        "tokenizer.ggml.eos_token_id": vocab - 1,
        "tokenizer.ggml.add_bos_token": False,
    }


# -- _log_weights and the acceptance rule ---------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_log_weights_equal_jax(masked):
    """Every setting, on normal logits and on tied bf16-valued logits whose
    ties straddle the top-k cut and the top-p crossing: -inf where JAX has
    it, and every finite weight bit for bit."""
    rng = np.random.default_rng(11)
    b, v = 6, 200
    cases = [((rng.standard_normal((b, v)) * 3).astype(np.float32), t, k, p)
             for t, k, p in SETTINGS if t > 0]
    tied, tk, tp = _tied_logits(rng, b, v, 0.8)
    cases.append((tied, 0.8, tk, tp))
    mask = rng.random((b, v)) < 0.7 if masked else None
    for logits, t, k, p in cases:
        args = (np.full(b, t, np.float32), np.full(b, k, np.int32), np.full(b, p, np.float32))
        want = jax.jit(jsampling._log_weights)(jnp.asarray(logits), *map(jnp.asarray, args),
                                      mask=None if mask is None else jnp.asarray(mask))
        got = tsampling._log_weights(_t(logits), *map(_t, args),
                                     mask=None if mask is None else _t(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_noise(seeds, steps, t: int, v: int):
    """spec_accept_rows' own streams: position j of row b is fold_in(key(seed),
    step + j), split into fold_in 0 (uniform) and fold_in 1 (Gumbel)."""
    def pos_streams(seed, step):
        def one(j):
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), step + j)
            u = jax.random.uniform(jax.random.fold_in(kj, 0))
            g = jax.random.gumbel(jax.random.fold_in(kj, 1), (v,), jnp.float32)
            return u, g
        return jax.vmap(one)(jnp.arange(t, dtype=jnp.int32))

    u, g = jax.vmap(pos_streams)(jnp.asarray(seeds), jnp.asarray(steps))
    return np.asarray(u), np.asarray(g)


# (temperature, top_k, top_p) a row, and its valid drafts out of K
ACCEPT_ROWS = [((0.0, 0, 1.0), K), ((0.0, 0, 1.0), 2), ((0.9, 0, 1.0), K), ((1.2, 5, 1.0), K),
               ((0.8, 0, 0.8), 3), ((1.0, 8, 0.75), 1), ((0.7, 0, 1.0), 0), ((1.5, 0, 1.0), K)]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_spec_accept_from_noise_equals_jax(masked):
    """Greedy, sampled, top-k, top-p and short-draft rows; drafts taken
    near each position's argmax so both accepts and rejects occur, with
    tied bf16-valued logits in half the draws."""
    rng = np.random.default_rng(21)
    b, t, v = len(ACCEPT_ROWS), K + 1, 120
    temp = np.array([r[0][0] for r in ACCEPT_ROWS], np.float32)
    topk = np.array([r[0][1] for r in ACCEPT_ROWS], np.int32)
    topp = np.array([r[0][2] for r in ACCEPT_ROWS], np.float32)
    dlen = np.array([r[1] for r in ACCEPT_ROWS], np.int32)
    seeds = np.arange(100, 100 + b, dtype=np.int32)
    steps = np.arange(b, dtype=np.int32) * 7
    u, gumbel = _jax_noise(seeds, steps, t, v)
    n_emit_seen = set()
    for draw in range(6):
        logits = (rng.standard_normal((b, t, v)) * 2).astype(np.float32)
        if draw % 2:
            logits = np.round(logits * 4) / 4  # bf16-valued, ties common
        mask = rng.random((b, t, v)) < 0.6 if masked else None
        if mask is not None:
            mask[..., :3] = True
        ranked = np.argsort(-np.where(mask, logits, -np.inf) if masked else -logits,
                            axis=-1, kind="stable")
        pick = rng.integers(0, 3, size=(b, K))  # rank 0, 1 or 2 of each position
        drafts = np.take_along_axis(ranked[:, :K], pick[..., None], axis=-1)[..., 0]
        drafts = drafts.astype(np.int32)
        jm = None if mask is None else jnp.asarray(mask)
        want_tok, want_n = jax.jit(jsampling.spec_accept_rows)(
            jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(dlen), jnp.asarray(seeds),
            jnp.asarray(steps), jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp),
            mask=jm)
        got_tok, got_n = tsampling.spec_accept_from_noise(
            _t(logits), _t(drafts), _t(dlen), _t(u), _t(gumbel), _t(temp), _t(topk),
            _t(topp), mask=None if mask is None else _t(mask))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        n_emit_seen |= set(np.asarray(want_n).tolist())
    assert len(n_emit_seen) >= 3  # accepts and rejects both happened


def test_spec_accept_rows_draws_per_row():
    """The port's own noise: a row's tokens depend on its (seed, step)
    alone, not on the other rows; an all-greedy batch draws nothing and
    accepts exactly the argmax prefix."""
    rng = np.random.default_rng(5)
    logits = _t((rng.standard_normal((3, K + 1, 90)) * 2).astype(np.float32))
    drafts = logits[:, :K].argmax(-1).int()
    drafts[1, 2] = (drafts[1, 2] + 1) % 90  # row 1 rejects at its third draft
    dlen = torch.tensor([K, K, 2], dtype=torch.int32)
    tok, n = tsampling.spec_accept_rows(logits, drafts, dlen, [1, 2, 3], [4, 4, 4],
                                        [0.9, 0.9, 0.9], 0, 1.0)
    tok1, n1 = tsampling.spec_accept_rows(logits[1:2], drafts[1:2], dlen[1:2], [2], [4],
                                          [0.9], 0, 1.0)
    assert torch.equal(tok[1], tok1[0]) and int(n[1]) == int(n1[0])
    g_tok, g_n = tsampling.spec_accept_rows(logits, drafts, dlen, [1, 2, 3], [4, 4, 4],
                                            [0.0, 0.0, 0.0], 0, 1.0)
    assert g_n.tolist() == [K + 1, 3, 3]
    am = logits.argmax(-1)
    assert g_tok[1, :3].tolist() == am[1, :3].tolist()
    assert g_tok[2, :3].tolist() == am[2, :3].tolist()


def test_ngram_index_proposals_equal_jax():
    rng = np.random.default_rng(9)
    for trial in range(20):
        hist = rng.integers(0, 6 if trial % 2 else 40, size=60).tolist()
        a, b = jspec.NGramIndex(hist[:5], 3, 1), tspec.NGramIndex(hist[:5], 3, 1)
        for tok in hist[5:]:
            a.append(tok)
            b.append(tok)
            for k in (1, 4, 6):
                assert b.propose(k) == a.propose(k)
    ja = jspec.make_slot([1, 2, 3, 1, 2], 3, jspec.SpecConfig(k=4))
    ta = tspec.make_slot([1, 2, 3, 1, 2], 3, tspec.SpecConfig(k=4))
    assert ta.index.propose(4) == ja.index.propose(4) == [1, 2, 3]


# -- through the batcher ---------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """The reference tests' tiny model (tests/test_spec_decode.py) and a
    byte-level tokenizer of its vocab, in both packages. Fresh prefills go
    through the flash kernel on both sides, as the port's always do (the
    JAX default attends over the int8 cache there)."""
    cfg = JConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, use_flash_attention=True)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", "float32")
    md = tokenizer_md(cfg.vocab_size)
    return cfg, params, tparams, JTokenizer.from_metadata(md), TTokenizer.from_metadata(md)


async def _scenario(b, sp_cls, dfa, eos):
    """Four greedy prompts together (at most spec_max_active: verify
    dispatches), then a schema-constrained greedy request beside a
    top-3-logprob request and a plain one (the ext regime). Returns the
    first wave's ids, the spec counters, and the second wave's ids and
    logprob items."""
    async def one(p, n, **kw):
        return [t async for t in b.submit(p, sp_cls(temperature=0.0, max_tokens=n), **kw)]

    wave = await asyncio.gather(*[one(p, 24) for p in SPEC_PROMPTS])
    st = b.stats.snapshot()
    counters = {k: st[k] for k in ("spec_verifies", "spec_drafted", "spec_accepted")}
    ext = await asyncio.gather(
        one([10, 11, 12, 13], 30, constrain=dfa),
        one([5, 6, 7, 5, 6], 8, want_logprobs=True, top_logprobs=3),
        one([20, 21, 22], 12))
    return wave, counters, ext


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_spec_and_ext_batcher_match_jax(model, kv, monkeypatch):
    cfg, params, tparams, jtok, ttok = model
    eos = [cfg.vocab_size - 1]
    kw = dict(max_slots=4, max_seq_len=MAX_SEQ, prefill_chunk=CHUNK, spec_decode_k=K,
              decode_burst=2)
    monkeypatch.setenv("DECODE_KERNEL", "pallas")
    jb = JBatcher(params, cfg.with_(kv_quant=kv), paged=True, **kw)
    assert jb.decode_kernel == "pallas"
    try:
        jdfa = jconstrain.compile_token_dfa(SCHEMA, jtok, cfg.vocab_size, eos_ids=eos)
        want = await _scenario(jb, JSamplingParams, jdfa, eos)
    finally:
        jb.stop()

    tcfg = TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, kv_quant=kv)
    tdfa = tconstrain.compile_token_dfa(SCHEMA, ttok, cfg.vocab_size, eos_ids=eos)
    tb = ContinuousBatcher(tparams, tcfg, **kw)
    calls = []  # (program, the live rows' draft lengths)
    verify, burst = tb._spec_verify_pallas, tb._decode_pos_pallas

    def spy_verify(*a):
        calls.append(("verify", [d for d in a[6] if d]))
        return verify(*a)

    def spy_burst(*a):
        calls.append(("burst", a[-1]))
        return burst(*a)

    tb._spec_verify_pallas, tb._decode_pos_pallas = spy_verify, spy_burst
    try:
        got = await _scenario(tb, SamplingParams, tdfa, eos)
        programs = tb.stats.program_calls
    finally:
        tb.stop()
    wave, counters, ext = got
    assert wave == want[0]
    assert counters == want[1] and counters["spec_accepted"] > 0
    # a verify whose drafts fell short of k, then a burst of single-token
    # steps over the stale rows it left past the accepted ones
    assert any(c[0] == "verify" and min(c[1]) < K and nxt[0] == "burst"
               for c, nxt in zip(calls, calls[1:])), calls
    (c_ids, lp_items, plain), (j_c, j_lp, j_plain) = ext, want[2]
    assert c_ids == j_c and plain == j_plain
    assert [t[0] for t in lp_items] == [t[0] for t in j_lp]
    for g, w in zip(lp_items, j_lp):
        assert list(g[2]) == [int(x) for x in w[2]]  # top ids, in top_k order
        np.testing.assert_allclose([g[1]] + list(g[3]), [w[1]] + list(w[3]), atol=2e-4)
        assert g[2][0] == g[0]  # greedy: the chosen token is the top one
    assert programs.get("decode_pos_pallas_ext", 0) > 0

    # spec off: the same greedy ids through plain bursts alone
    tb = ContinuousBatcher(tparams, tcfg, **{**kw, "spec_decode_k": 0})
    try:
        off = await _scenario(tb, SamplingParams, tdfa, eos)
        assert "spec_verify_pallas" not in tb.stats.program_calls
    finally:
        tb.stop()
    assert off[0] == wave and off[2] == ext
    assert off[1] == {"spec_verifies": 0, "spec_drafted": 0, "spec_accepted": 0}
