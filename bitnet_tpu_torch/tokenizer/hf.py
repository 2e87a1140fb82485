"""HuggingFace tokenizer.json backend.

Own copy of ``bitnet_tpu/tokenizer/hf.py``: the port imports nothing of the
JAX package.

Equivalent of the reference's HF backend
(``bitnet-tokenizers/src/hf_tokenizer.rs``): wraps the ``tokenizers``
library when a sibling ``tokenizer.json`` exists.
"""

from __future__ import annotations

from ..errors import TokenizerError
from .base import Tokenizer


class HFTokenizer(Tokenizer):
    def __init__(self, path: str):
        try:
            from tokenizers import Tokenizer as _HFT
        except ImportError as e:  # pragma: no cover
            raise TokenizerError(f"tokenizers library unavailable: {e}")
        self._tk = _HFT.from_file(path)
        self.path = path
        # find special ids by convention
        self.bos_token_id = self._find_special(["<s>", "<|begin_of_text|>",
                                                "<bos>"])
        self.eos_token_id = self._find_special(["</s>", "<|end_of_text|>",
                                                "<eos>", "<|eot_id|>"])
        self.unk_token_id = self._find_special(["<unk>"])

    def _find_special(self, cands: list[str]) -> int | None:
        for c in cands:
            tid = self._tk.token_to_id(c)
            if tid is not None:
                return tid
        return None

    def encode(self, text: str, add_bos: bool = True,
               add_special: bool = True) -> list[int]:
        enc = self._tk.encode(text, add_special_tokens=False)
        ids = list(enc.ids)
        if add_bos and add_special and self.bos_token_id is not None:
            if not ids or ids[0] != self.bos_token_id:
                ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        return self._tk.decode(ids, skip_special_tokens=True)

    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()

    def token_to_piece(self, token_id: int) -> str:
        if token_id in (self.bos_token_id, self.eos_token_id):
            return ""
        return self._tk.decode([token_id], skip_special_tokens=True)

    def token_to_id(self, piece: str) -> int | None:
        return self._tk.token_to_id(piece)
