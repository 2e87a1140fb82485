"""Tokenizers: GGUF-embedded vocab, HF tokenizer.json, SentencePiece
``.model``, mock.

Own copy of ``bitnet_tpu/tokenizer/__init__.py``: the port imports nothing
of the JAX package.  ``download.py`` is not copied (it needs the network).

Discovery + fallback chain mirrors the reference
(``bitnet-tokenizers/src/{discovery,strategy,fallback}.rs``):
1. sibling ``tokenizer.json`` next to the model file (HF backend),
2. sibling ``tokenizer.model`` / ``spiece.model`` (SentencePiece backend —
   a llama-family checkpoint shipping only the SPM file loads fine),
3. GGUF-embedded vocab (``tokenizer.ggml.*`` metadata),
4. mock (only when allowed — strict mode bans it).
"""

from __future__ import annotations

import os

from ..errors import TokenizerError
from .base import Tokenizer
from .gguf_vocab import GGUFTokenizer
from .hf import HFTokenizer
from .mock import MockTokenizer
from .spm import SPMTokenizer

# (filename, backend) in priority order — strategy.rs chain
_SIBLINGS: tuple[tuple[str, str], ...] = (
    ("tokenizer.json", "hf"),
    ("tokenizer.model", "spm"),
    ("spiece.model", "spm"),
)


def discover_sibling_tokenizer(model_path: str) -> str | None:
    """Sibling tokenizer file discovery (``discovery.rs``)."""
    d = os.path.dirname(os.path.abspath(model_path))
    for cand, _kind in _SIBLINGS:
        p = os.path.join(d, cand)
        if os.path.isfile(p):
            return p
    return None


def load_tokenizer(model_path: str, allow_mock: bool = True) -> Tokenizer:
    """Fallback strategy chain (``strategy.rs`` / ``fallback.rs``)."""
    d = os.path.dirname(os.path.abspath(model_path))
    for cand, kind in _SIBLINGS:
        p = os.path.join(d, cand)
        if not os.path.isfile(p):
            continue
        try:
            if kind == "hf":
                return HFTokenizer(p)
            return SPMTokenizer(p)
        except Exception:
            continue
    try:
        from ..gguf.reader import GGUFReader

        with GGUFReader(model_path) as r:
            if "tokenizer.ggml.tokens" in r.metadata:
                return GGUFTokenizer.from_gguf_metadata(r.metadata)
    except Exception:
        pass
    if allow_mock:
        return MockTokenizer()
    raise TokenizerError(
        f"no tokenizer found for {model_path} and mock is not allowed "
        f"(strict mode)"
    )


__all__ = [
    "Tokenizer",
    "GGUFTokenizer",
    "HFTokenizer",
    "MockTokenizer",
    "SPMTokenizer",
    "load_tokenizer",
    "discover_sibling_tokenizer",
]
