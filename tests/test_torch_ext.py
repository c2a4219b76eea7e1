"""The port's ext path (schema constraints, logprobs, n choices) against the
JAX package, on the CPU.

* ``TokenDFA``: the port's copy gives the JAX copy's token strings, masks
  and transitions on the tiny model's byte-level tokenizer, state by state
  along mask-guided walks.
* ``logprob_rows``: the JAX ext program's readback (f32 ``log_softmax``,
  the chosen token's logprob, ``lax.top_k`` of ``LOGPROBS_K``) on tied
  bf16-valued logits: top ids identical, logprobs within 2e-4.
* ``_parse_ext``: the same results, and byte for byte the same error
  strings, as ``JaxChatEngine._parse_ext``.
* ``TorchChatEngine`` on the tiny model: a ``json_schema`` chat at
  temperature 0.9 returns JSON that meets the schema; a logprob chat has
  one entry a token, shaped as the JAX engine's ``_lp_entry``, its top
  entry the chosen token; ``n=2`` returns two choices whose second admits
  as a prefix-cache hit, greedy choices equal the ``n=1`` text and seeded
  choice i equals an ``n=1`` chat with seed + i.

(The batcher-level ids and logprobs against the JAX ``ContinuousBatcher``
are in ``tests/test_torch_spec.py``, which shares one JAX batcher run per
KV mode between speculative decoding and the ext regime.)
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.gguf.tokenizer import GGUFTokenizer as JTokenizer
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.serve import constrain as jconstrain
from nats_llm_studio_tpu.serve.api import EngineError as JEngineError
from nats_llm_studio_tpu.serve.registry import JaxChatEngine
from nats_llm_studio_tpu_torch.engine import sampling as tsampling
from nats_llm_studio_tpu_torch.gguf.tokenizer import GGUFTokenizer as TTokenizer
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import params_from_numpy
from nats_llm_studio_tpu_torch.serve import constrain as tconstrain
from nats_llm_studio_tpu_torch.serve.api import EngineError
from nats_llm_studio_tpu_torch.serve.batcher import LOGPROBS_K, ContinuousBatcher
from nats_llm_studio_tpu_torch.serve.registry import TorchChatEngine
from test_torch_ops import _tied_logits
from test_torch_spec import SCHEMA, tokenizer_md

V = 512  # ModelConfig.tiny's vocab


@pytest.fixture(scope="module")
def toks():
    md = tokenizer_md(V)
    return md, JTokenizer.from_metadata(md), TTokenizer.from_metadata(md)


def test_token_dfa_equal_jax(toks):
    _, jtok, ttok = toks
    assert tconstrain.token_strings(ttok, V) == jconstrain.token_strings(jtok, V)
    rng = np.random.default_rng(4)
    for schema in (SCHEMA, {}):
        jd = jconstrain.compile_token_dfa(schema, jtok, V, eos_ids=[V - 1])
        td = tconstrain.compile_token_dfa(schema, ttok, V, eos_ids=[V - 1])
        for _ in range(4):  # mask-guided walks from the start state
            js, ts = jd.start, td.start
            for _ in range(24):
                jm, tm = jd.mask(js), td.mask(ts)
                np.testing.assert_array_equal(tm, jm)
                assert td.accepting(ts) == jd.accepting(js) and td.live(ts) == jd.live(js)
                allowed = np.flatnonzero(jm)
                if not len(allowed):
                    break
                tok = int(rng.choice(allowed))
                js, ts = jd.advance(js, tok), td.advance(ts, tok)
                if js is None or ts is None:
                    assert js is None and ts is None
                    break


def test_logprob_rows_equal_jax():
    rng = np.random.default_rng(8)
    logits, _, _ = _tied_logits(rng, 6, 200, 1.0)
    chosen = logits.argmax(-1).astype(np.int32)
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    want_lp = np.take_along_axis(np.asarray(logp), chosen[:, None], axis=-1)[:, 0]
    want_top, want_ids = jax.lax.top_k(logp, LOGPROBS_K)
    lp, ids, top = tsampling.logprob_rows(torch.from_numpy(logits), torch.from_numpy(chosen),
                                          LOGPROBS_K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(lp.numpy(), want_lp, atol=2e-4)
    np.testing.assert_allclose(top.numpy(), np.asarray(want_top), atol=2e-4)


def _engines(toks, max_slots: int = 4):
    """A stand-in for each package's engine: what ``_parse_ext`` reads."""
    _, jtok, ttok = toks
    batcher = SimpleNamespace(max_slots=max_slots)
    cfg = SimpleNamespace(vocab_size=V)
    eos = frozenset({V - 1})
    return (SimpleNamespace(tokenizer=jtok, cfg=cfg, batcher=batcher, _stop_ids=eos),
            SimpleNamespace(tokenizer=ttok, cfg=cfg, batcher=batcher, _stop_ids=eos))


RF = {"type": "json_schema", "json_schema": {"name": "p", "schema": SCHEMA}}
BAD = [
    {"response_format": "json"},
    {"response_format": {"type": "xml"}},
    {"response_format": {"type": "json_schema"}},
    {"response_format": {"type": "json_schema", "json_schema": {"schema": 3}}},
    {"top_logprobs": 9},
    {"top_logprobs": -1},
    {"top_logprobs": "many"},
    {"n": -1},
    {"n": 5},
    {"n": "two"},
]


def test_parse_ext_equal_jax(toks, monkeypatch):
    je, te = _engines(toks)
    for payload in BAD:
        with pytest.raises(JEngineError) as want:
            JaxChatEngine._parse_ext(je, payload)
        with pytest.raises(EngineError) as got:
            TorchChatEngine._parse_ext(te, payload)
        assert str(got.value) == str(want.value), payload
    for payload in ({}, {"logprobs": True}, {"top_logprobs": 3, "n": 4},
                    {"response_format": RF, "n": 2}, {"response_format": {"type": "text"}}):
        w, g = JaxChatEngine._parse_ext(je, payload), TorchChatEngine._parse_ext(te, payload)
        assert g[1:] == w[1:] and (g[0] is None) == (w[0] is None)
        if g[0] is not None:
            np.testing.assert_array_equal(g[0].mask(g[0].start), w[0].mask(w[0].start))
    monkeypatch.setenv("CONSTRAIN", "0")
    with pytest.raises(JEngineError) as want:
        JaxChatEngine._parse_ext(je, {"response_format": RF})
    with pytest.raises(EngineError) as got:
        TorchChatEngine._parse_ext(te, {"response_format": RF})
    assert str(got.value) == str(want.value)


@async_test
async def test_ext_chats_and_n_choices_through_the_engine(toks):
    md, jtok, ttok = toks
    cfg = JConfig.tiny(n_layers=2, max_seq_len=64)
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(0))), "cpu",
        "float32")
    tcfg = TConfig.tiny(n_layers=2, max_seq_len=64)
    b = ContinuousBatcher(tparams, tcfg, max_slots=4, max_seq_len=64, prefill_chunk=8,
                          prefix_cache_blocks=16, spec_decode_k=4)
    eng = TorchChatEngine("test/tiny", b, ttok, tcfg, md)
    msgs = [{"role": "user", "content": "hi"}]
    try:
        r = await eng.chat({"messages": msgs, "response_format": RF, "temperature": 0.9,
                            "seed": 3, "max_tokens": 40})
        doc = json.loads(r["choices"][0]["message"]["content"])
        assert set(doc) <= {"age", "tag"}
        assert isinstance(doc.get("age", 0), int) and doc.get("tag", "alpha") in ("alpha",
                                                                                  "beta")

        r = await eng.chat({"messages": msgs, "logprobs": True, "top_logprobs": 3,
                            "temperature": 0, "max_tokens": 6})
        content = r["choices"][0]["logprobs"]["content"]
        assert len(content) == r["usage"]["completion_tokens"] == 6
        for e in content:
            assert len(e["top_logprobs"]) == 3 and e["top_logprobs"][0]["token"] == e["token"]
        item = (65, -0.25, [65, 66, 300], [-0.25, -1.5, -2.0])
        assert eng._lp_entry(item, 2) == JaxChatEngine._lp_entry(
            SimpleNamespace(tokenizer=jtok), item, 2)

        pc = b.prefix_cache
        one = await eng.chat({"messages": msgs, "temperature": 0, "max_tokens": 6})
        hits = pc.counters()["hits"]
        two = await eng.chat({"messages": msgs, "temperature": 0, "max_tokens": 6, "n": 2})
        assert [c["index"] for c in two["choices"]] == [0, 1]
        text = one["choices"][0]["message"]["content"]
        assert [c["message"]["content"] for c in two["choices"]] == [text, text]
        assert two["usage"]["completion_tokens"] == 2 * one["usage"]["completion_tokens"]
        assert pc.counters()["hits"] >= hits + 1  # choice 1 admitted over the cache

        sp = {"messages": msgs, "temperature": 0.9, "max_tokens": 6}
        two = await eng.chat({**sp, "n": 2, "seed": 40})
        alone = [(await eng.chat({**sp, "seed": 40 + i}))["choices"][0]["message"]["content"]
                 for i in range(2)]
        assert [c["message"]["content"] for c in two["choices"]] == alone
    finally:
        b.stop()
