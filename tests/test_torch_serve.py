"""The port's serving slice end to end on the CPU: embedded broker ->
Worker -> TorchRegistry(device="cpu") -> batcher -> model, driven over NATS
with ``lmstudio.chat_model``, and held against a greedy loop of the JAX
package's ``forward`` on the same tiny GGUF. Also the port's two rules:
it imports neither jax nor the JAX package, and it never falls back to the
CPU on its own.
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine.generator import GenStats
from nats_llm_studio_tpu.gguf.constants import TokenType
from nats_llm_studio_tpu.gguf.reader import open_gguf
from nats_llm_studio_tpu.gguf.tokenizer import GGUFTokenizer, _byte_to_unicode
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig
from nats_llm_studio_tpu.models.export import export_params_to_gguf
from nats_llm_studio_tpu.serve.registry import JaxChatEngine
from nats_llm_studio_tpu.serve.template import render_chat_template, stop_token_ids
from nats_llm_studio_tpu_torch.config import WorkerConfig
from nats_llm_studio_tpu_torch.gguf.reader import open_gguf as t_open_gguf
from nats_llm_studio_tpu_torch.models import llama as tllama
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
from nats_llm_studio_tpu_torch.serve.worker import Worker
from nats_llm_studio_tpu_torch.store import ModelStore
from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, connect

torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
torch.backends.cudnn.allow_tf32 = False

MID = "test/tiny"
MAX_SEQ = 512  # the 256-token serving chunk must divide it
PORT_PKG = Path(__file__).resolve().parent.parent / "nats_llm_studio_tpu_torch"


def _export(models_dir: Path) -> Path:
    cfg = ModelConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ)
    params = jllama.init_params(cfg, jax.random.PRNGKey(5))
    b2u = _byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    while len(tokens) < cfg.vocab_size - 1:
        tokens.append(f"<filler_{len(tokens)}>")
    tokens.append("<|eot|>")
    tok_md = {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": [int(TokenType.NORMAL)] * (cfg.vocab_size - 1)
        + [int(TokenType.CONTROL)],
        "tokenizer.ggml.merges": [],
        "tokenizer.ggml.eos_token_id": cfg.vocab_size - 1,
        "tokenizer.ggml.add_bos_token": False,
    }
    d = models_dir / MID
    d.mkdir(parents=True)
    return export_params_to_gguf(d / "m.gguf", params, cfg, name=MID, tokenizer_md=tok_md)


def _jax_greedy(path: Path, messages: list[dict], max_tokens: int) -> tuple[str, int, int]:
    """(text, prompt tokens, completion tokens) of a greedy loop of the JAX forward (dense, one
    compiled width: right padding never reaches the prompt-end logits)."""
    with open_gguf(str(path)) as r:
        cfg = ModelConfig.from_gguf_metadata(r.metadata).with_(dtype="float32")
        params = jllama.load_params_from_gguf(r, cfg)
        tok = GGUFTokenizer.from_metadata(r.metadata)
        meta = dict(r.metadata)
    stops = stop_token_ids(tok)
    ids = tok.encode(render_chat_template(meta, messages, add_generation_prompt=True))
    width = MAX_SEQ

    @jax.jit
    def next_logits(tokens, last):
        k, v = jllama.make_cache(cfg, 1, width)
        logits, _, _ = jllama.forward(params, cfg, tokens, k, v, jnp.zeros((1,), jnp.int32),
                                      logit_positions=last)
        return logits[0, 0]

    out: list[int] = []
    for _ in range(max_tokens):
        seq = ids + out
        padded = np.zeros((1, width), np.int32)
        padded[0, : len(seq)] = seq
        t = int(jnp.argmax(next_logits(jnp.asarray(padded), jnp.asarray([len(seq) - 1]))))
        if t in stops:
            break
        out.append(t)
    return tok.decode(out), len(ids), len(out)


@async_test
async def test_chat_model_over_nats_matches_jax_greedy(tmp_path):
    models_dir = tmp_path / "models"
    path = _export(models_dir)
    broker = await EmbeddedBroker().start()
    registry = TorchRegistry(ModelStore(models_dir), device="cpu")
    worker = Worker(WorkerConfig(nats_url=broker.url), registry)
    await worker.start()
    nc = await connect(broker.url)
    try:
        env = json.loads((await nc.request("lmstudio.list_models", b"{}", timeout=10)).payload)
        assert env["ok"] and [m["id"] for m in env["data"]["models"]["data"]] == [MID]

        short = [{"role": "user", "content": "hello there"}]
        body = {"model": MID, "messages": short, "temperature": 0, "max_tokens": 6}
        env = json.loads((await nc.request(
            "lmstudio.chat_model", json.dumps(body).encode(), timeout=30)).payload)
        assert env["ok"], env
        resp = env["data"]["response"]
        text, n_prompt, n_out = _jax_greedy(path, short, 6)
        assert resp["choices"][0]["message"]["content"] == text
        assert resp["usage"]["prompt_tokens"] == n_prompt
        assert resp["usage"]["completion_tokens"] == n_out

        # the JAX worker's documented envelope shape, key for key
        want = JaxChatEngine._completion(SimpleNamespace(model_id=MID), "x", 1, 1, "stop",
                                         stats=GenStats())
        assert set(env) >= {"ok", "data"} and set(env["data"]) == {"http_status", "response"}
        assert set(resp) == set(want)
        assert set(resp["choices"][0]) == set(want["choices"][0])
        assert set(resp["usage"]) == set(want["usage"])
        # the JAX worker's _finish_trace adds the stage waterfall to stats
        assert set(resp["stats"]) == set(want["stats"]) | {"trace"}

        # a prompt longer than one 256-token serving chunk, streamed
        long = [{"role": "user", "content": "the quick brown fox " * 16}]
        body = {"model": MID, "messages": long, "temperature": 0, "max_tokens": 8,
                "stream": True}
        chunks, final = [], None
        async for msg in nc.request_stream("lmstudio.chat_model", json.dumps(body).encode(),
                                           timeout=30):
            env = json.loads(msg.payload)
            assert env["ok"], env
            if msg.headers and "Nats-Stream-Done" in msg.headers:
                final = env["data"]["response"]
            else:
                chunks.append(env["data"]["chunk"]["choices"][0]["delta"]["content"])
        text, n_prompt, n_out = _jax_greedy(path, long, 8)
        assert n_prompt > 256
        assert final["choices"][0]["message"]["content"] == text == "".join(chunks)
        assert final["usage"]["completion_tokens"] == n_out

        # seeded sampling (temperature, top-p) through the batcher repeats
        body = {"model": MID, "messages": short, "temperature": 0.9, "top_p": 0.9,
                "seed": 77, "max_tokens": 6}
        texts = []
        for _ in range(2):
            env = json.loads((await nc.request(
                "lmstudio.chat_model", json.dumps(body).encode(), timeout=30)).payload)
            assert env["ok"], env
            texts.append(env["data"]["response"]["choices"][0]["message"]["content"])
        assert texts[0] == texts[1]

        # more choices than batch slots is refused with the reference's error
        body = {"model": MID, "messages": short, "n": 99}
        env = json.loads((await nc.request(
            "lmstudio.chat_model", json.dumps(body).encode(), timeout=10)).payload)
        assert not env["ok"] and "invalid n: must be between 1 and 8" in env["error"]
    finally:
        await nc.close()
        await worker.drain()
        await registry.close()
        await broker.stop()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(PORT_PKG.parent)!r})\n"
        "import nats_llm_studio_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nats_llm_studio_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'nats_llm_studio_tpu' or m.startswith('nats_llm_studio_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('nats_llm_studio_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_registry_without_device_raises_when_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchRegistry(ModelStore(tmp_path))


@pytest.mark.parametrize("entry", ["make_cache", "load_params_from_gguf"])
def test_model_entry_points_without_device_raise_when_no_card(tmp_path, entry):
    """The model's public functions default to the card too: without one
    they raise unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    if entry == "make_cache":
        cfg = TConfig.tiny(n_layers=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tllama.make_cache(cfg, 1, 8)
        k, _ = tllama.make_cache(cfg, 1, 8, device="cpu")
        assert k.device.type == "cpu"
        return
    with t_open_gguf(str(_export(tmp_path / "models"))) as r:
        cfg = TConfig.from_gguf_metadata(r.metadata).with_(dtype="float32")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tllama.load_params_from_gguf(r, cfg)
        assert tllama.load_params_from_gguf(r, cfg, device="cpu")["embed"].device.type == "cpu"
