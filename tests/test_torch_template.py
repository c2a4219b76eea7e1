"""The port's prompt construction against the reference's: the chat
renderer, resolved once per model, gives the reference's
``render_chat_template`` text for every family, and the gpt2 tokenizer with
its per-piece id cache gives the reference tokenizer's ids, on first use
and on repeats, with merges and without, and past the cache's bound."""

import pytest

from nats_llm_studio_tpu.gguf.constants import KEY_CHAT_TEMPLATE, TokenType
from nats_llm_studio_tpu.gguf.tokenizer import GGUFTokenizer as JTokenizer
from nats_llm_studio_tpu.serve.template import render_chat_template as j_render
from nats_llm_studio_tpu_torch.gguf import tokenizer as t_tokenizer
from nats_llm_studio_tpu_torch.gguf.tokenizer import GGUFTokenizer as TTokenizer
from nats_llm_studio_tpu_torch.gguf.tokenizer import _byte_to_unicode
from nats_llm_studio_tpu_torch.serve import template as t_template

MESSAGES = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "hi there, hi again"},
    {"role": "assistant", "content": "hello"},
    {"role": "user", "content": "once more"},
]

METADATA = {
    "llama3": {"tokenizer.ggml.tokens": ["<|start_header_id|>", "<|eot_id|>"]},
    "granite": {"tokenizer.ggml.tokens": ["<|start_of_role|>", "<|end_of_role|>"]},
    "chatml": {"tokenizer.ggml.tokens": ["<|im_start|>", "<|im_end|>"]},
    "generic": {"tokenizer.ggml.tokens": ["a", "b"]},
    "empty": {},
    "jinja": {
        KEY_CHAT_TEMPLATE: (
            "{{ bos_token }}{% for m in messages %}"
            "[{{ m.role }}]{{ m.content }}{{ eos_token }}{% endfor %}"
            "{% if add_generation_prompt %}[assistant]{% endif %}"
        ),
        "tokenizer.ggml.tokens": ["<s>", "</s>"],
        "tokenizer.ggml.bos_token_id": 0,
        "tokenizer.ggml.eos_token_id": 1,
    },
    "broken_jinja": {
        KEY_CHAT_TEMPLATE: "{% for m in messages %}{{ unclosed",
        "tokenizer.ggml.tokens": ["<|im_start|>", "<|im_end|>"],
    },
}


@pytest.mark.parametrize("add_generation_prompt", [True, False])
@pytest.mark.parametrize("family", sorted(METADATA))
def test_chat_renderer_matches_reference(family, add_generation_prompt):
    md = METADATA[family]
    render = t_template.chat_renderer(md)
    want = j_render(md, MESSAGES, add_generation_prompt=add_generation_prompt)
    # one renderer serves many chats: call it twice
    for _ in range(2):
        assert render(MESSAGES, add_generation_prompt=add_generation_prompt) == want
    assert t_template.render_chat_template(md, MESSAGES, add_generation_prompt) == want


def _gpt2_args(with_merges: bool) -> dict:
    b2u = _byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    merges = []
    if with_merges:
        for a, b in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
                     (b2u[32], "hello"), ("o", "n"), ("on", "e")]:
            merges.append(f"{a} {b}")
            tokens.append(a + b)
    tokens.append("<|eot|>")
    return dict(model="gpt2", tokens=tokens, merges=merges,
                token_types=[int(TokenType.NORMAL)] * (len(tokens) - 1)
                + [int(TokenType.CONTROL)],
                eos_id=len(tokens) - 1, add_bos=False)


TEXTS = [
    "hello hello one one, hello: one héllo ✓ hello\n\nhello  one",
    ("The harbour town kept its records in a long ledger. " * 40),
    "",
]


@pytest.mark.parametrize("with_merges", [False, True])
def test_gpt2_piece_cache_matches_reference(with_merges):
    args = _gpt2_args(with_merges)
    ref, port = JTokenizer(**args), TTokenizer(**args)
    for _ in range(2):  # the second pass reads every piece from the cache
        for text in TEXTS:
            ids = port.encode(text)
            assert ids == ref.encode(text)
            assert port.decode(ids) == text
    assert port._piece_ids  # the cache was used


def test_gpt2_piece_cache_stops_growing_at_its_bound(monkeypatch):
    monkeypatch.setattr(t_tokenizer, "_PIECE_CACHE_MAX", 3)
    args = _gpt2_args(True)
    ref, port = JTokenizer(**args), TTokenizer(**args)
    text = " ".join(f"w{i} hello" for i in range(20))
    for _ in range(2):
        assert port.encode(text) == ref.encode(text)
    assert len(port._piece_ids) == 3
