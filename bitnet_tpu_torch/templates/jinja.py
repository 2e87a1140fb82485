"""Execute GGUF-embedded jinja chat templates (HF semantics).

Own copy of ``bitnet_tpu/templates/jinja.py``: the port imports nothing of the
JAX package.

The reference only pattern-matches an embedded ``tokenizer.chat_template``
to route to a known template type (``bitnet-prompt-templates/src/
lib.rs:362-430``); this module EXECUTES the template, so any GGUF with an
arbitrary chat template renders byte-exactly the way
``transformers.apply_chat_template`` / llama-cpp-python would render it.

Safety: GGUF metadata is untrusted input, so templates run inside
``jinja2.sandbox.ImmutableSandboxedEnvironment`` (the same guard
HuggingFace transformers uses) — no attribute traversal to dunder
internals, no state mutation.
"""

from __future__ import annotations

import datetime
import json

from ..errors import BitNetError


class ChatTemplateError(BitNetError):
    """Embedded chat template failed to parse or render."""


def _raise_exception(message: str = "chat template error"):
    raise ChatTemplateError(str(message))


def _strftime_now(fmt: str) -> str:
    return datetime.datetime.now().strftime(fmt)


def render_jinja(
    template: str,
    messages: list,
    add_generation_prompt: bool = True,
    bos_token: str = "",
    eos_token: str = "",
    **extra_context,
) -> str:
    """Render ``messages`` through an embedded jinja chat template.

    ``messages`` accepts either :class:`templates.Message` objects or
    ``{"role", "content"}`` dicts.  The render context matches HF
    ``apply_chat_template``: ``messages`` / ``add_generation_prompt`` /
    ``bos_token`` / ``eos_token`` plus a ``raise_exception`` callable,
    ``tojson`` filter, and ``strftime_now``.
    """
    try:
        import jinja2
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:                       # pragma: no cover
        raise ChatTemplateError(f"jinja2 unavailable: {e}") from e

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        keep_trailing_newline=True,
    )
    env.globals["raise_exception"] = _raise_exception
    env.globals["strftime_now"] = _strftime_now
    env.filters["tojson"] = json.dumps

    msg_dicts = []
    for m in messages:
        if isinstance(m, dict):
            msg_dicts.append(dict(m))
        else:
            msg_dicts.append({"role": m.role, "content": m.content})

    try:
        compiled = env.from_string(template)
        return compiled.render(
            messages=msg_dicts,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos_token,
            eos_token=eos_token,
            **extra_context,
        )
    except ChatTemplateError:
        raise
    except jinja2.exceptions.SecurityError as e:
        raise ChatTemplateError(f"chat template blocked by sandbox: {e}") \
            from e
    except Exception as e:
        raise ChatTemplateError(f"chat template failed: {e}") from e


def special_token_strings(metadata: dict) -> dict:
    """bos/eos token STRINGS from GGUF metadata (id → vocab lookup),
    for the jinja render context."""
    out = {"bos_token": "", "eos_token": ""}
    vocab = metadata.get("tokenizer.ggml.tokens")
    if not vocab:
        return out
    for key, mkey in (("bos_token", "tokenizer.ggml.bos_token_id"),
                      ("eos_token", "tokenizer.ggml.eos_token_id")):
        tid = metadata.get(mkey)
        if isinstance(tid, int) and 0 <= tid < len(vocab):
            out[key] = str(vocab[tid])
    return out


def render_chat_embedded(
    metadata: dict,
    messages: list,
    add_generation_prompt: bool = True,
) -> str:
    """Render through the GGUF's own ``tokenizer.chat_template``.

    Raises :class:`ChatTemplateError` when the metadata has no template
    or the template fails — callers fall back to the family catalog
    (``templates.detect`` + ``render_chat``).
    """
    tmpl = metadata.get("tokenizer.chat_template")
    if not tmpl or not isinstance(tmpl, str):
        raise ChatTemplateError("no embedded chat template in metadata")
    toks = special_token_strings(metadata)
    return render_jinja(tmpl, messages,
                        add_generation_prompt=add_generation_prompt,
                        **toks)


__all__ = ["ChatTemplateError", "render_jinja", "render_chat_embedded",
           "special_token_strings"]
