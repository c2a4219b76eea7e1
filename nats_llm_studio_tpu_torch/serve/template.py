"""Chat prompt construction from GGUF metadata.

The reference passes the OpenAI-style ``messages`` payload verbatim to LM
Studio, which applies the model's chat template internally
(nats_llm_studio.go:161). Here the template embedded in the GGUF
(``tokenizer.chat_template`` — a jinja template, the industry convention) is
rendered in-process when jinja2 is importable, with hand-rolled fallbacks for
the north-star families (llama-3 header tags, granite/chatml role tags) and a
generic role-prefix format otherwise.
"""

from __future__ import annotations

import logging
from typing import Any

from ..gguf.constants import KEY_CHAT_TEMPLATE
from ..gguf.tokenizer import GGUFTokenizer

log = logging.getLogger(__name__)

try:
    import jinja2

    _JINJA: jinja2.Environment | None = jinja2.Environment(
        loader=jinja2.BaseLoader(), keep_trailing_newline=True
    )
except ImportError:  # pragma: no cover
    _JINJA = None

# stop-string candidates looked up in the vocab (model families use different
# end-of-turn markers; anything present becomes a stop id)
STOP_TOKEN_STRINGS = (
    "</s>",
    "<|eot_id|>",
    "<|end_of_text|>",
    "<|im_end|>",
    "<|end_of_turn|>",
    "<|endoftext|>",
    "<|end_of_role|>",  # granite uses start/end role tags; end_of_text stops
)


def stop_token_ids(tok: GGUFTokenizer) -> frozenset[int]:
    ids = set()
    if tok.eos_id is not None:
        ids.add(int(tok.eos_id))
    for s in STOP_TOKEN_STRINGS:
        tid = tok.vocab.get(s)
        if tid is not None:
            ids.add(tid)
    return frozenset(ids)


def _render_jinja(template: str, messages: list[dict], add_generation_prompt: bool,
                  md: dict[str, Any]) -> str | None:
    if _JINJA is None:
        return None
    try:
        tokens = md.get("tokenizer.ggml.tokens")
        bos_id = md.get("tokenizer.ggml.bos_token_id")
        eos_id = md.get("tokenizer.ggml.eos_token_id")
        bos = tokens[bos_id] if tokens is not None and bos_id is not None else ""
        eos = tokens[eos_id] if tokens is not None and eos_id is not None else ""
        out = _JINJA.from_string(template).render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos,
            eos_token=eos,
        )
        return out
    except Exception as e:  # noqa: BLE001 — fall back to built-in formats
        log.warning("chat template render failed (%s); using fallback", e)
        return None


def _llama3_format(messages: list[dict], add_generation_prompt: bool) -> str:
    parts = ["<|begin_of_text|>"]
    for m in messages:
        parts.append(
            f"<|start_header_id|>{m.get('role', 'user')}<|end_header_id|>\n\n"
            f"{m.get('content', '')}<|eot_id|>"
        )
    if add_generation_prompt:
        parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(parts)


def _granite_format(messages: list[dict], add_generation_prompt: bool) -> str:
    parts = []
    for m in messages:
        parts.append(
            f"<|start_of_role|>{m.get('role', 'user')}<|end_of_role|>"
            f"{m.get('content', '')}<|end_of_text|>\n"
        )
    if add_generation_prompt:
        parts.append("<|start_of_role|>assistant<|end_of_role|>")
    return "".join(parts)


def _chatml_format(messages: list[dict], add_generation_prompt: bool) -> str:
    parts = []
    for m in messages:
        parts.append(f"<|im_start|>{m.get('role', 'user')}\n{m.get('content', '')}<|im_end|>\n")
    if add_generation_prompt:
        parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def _generic_format(messages: list[dict], add_generation_prompt: bool) -> str:
    parts = []
    for m in messages:
        parts.append(f"{m.get('role', 'user')}: {m.get('content', '')}\n")
    if add_generation_prompt:
        parts.append("assistant:")
    return "".join(parts)


def chat_renderer(md: dict[str, Any]):
    """The prompt builder of one model: ``render(messages,
    add_generation_prompt=True) -> str``, using (in order) the GGUF-embedded
    jinja template, a family-specific fallback keyed off vocab markers,
    generic. The fallback is chosen here, once: the marker lookup builds a
    set of the whole vocabulary (milliseconds at a 128k vocabulary), which
    per chat would sit on the worker's event loop before every arrival."""
    template = md.get(KEY_CHAT_TEMPLATE)
    tokens = md.get("tokenizer.ggml.tokens")
    vocab = set(tokens) if tokens is not None else set()
    if "<|start_header_id|>" in vocab:
        fallback = _llama3_format
    elif "<|start_of_role|>" in vocab:
        fallback = _granite_format
    elif "<|im_start|>" in vocab:
        fallback = _chatml_format
    else:
        fallback = _generic_format

    def render(messages: list[dict], add_generation_prompt: bool = True) -> str:
        if template:
            out = _render_jinja(str(template), messages, add_generation_prompt, md)
            if out is not None:
                return out
        return fallback(messages, add_generation_prompt)

    return render


def render_chat_template(
    md: dict[str, Any], messages: list[dict], add_generation_prompt: bool = True
) -> str:
    """messages -> prompt string (``chat_renderer`` for a single call)."""
    return chat_renderer(md)(messages, add_generation_prompt)
