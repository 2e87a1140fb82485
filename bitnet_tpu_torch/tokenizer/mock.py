"""Mock tokenizer for tests (reference: ``bitnet-tokenizers/src/mock.rs``).

Own copy of ``bitnet_tpu/tokenizer/mock.py``: the port imports nothing of the
JAX package.

Byte-level: token id = byte value + 3 (ids 0..2 reserved for unk/bos/eos).
Banned in strict mode (``strict_mode.rs:87-158`` semantics) — the engine's
receipts record ``tokenizer: mock`` so honest-compute gates can reject it.
"""

from __future__ import annotations

from .base import Tokenizer


class MockTokenizer(Tokenizer):
    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 0

    def __init__(self, vocab_size: int = 259):
        self._vocab = max(vocab_size, 259)

    def encode(self, text: str, add_bos: bool = True,
               add_special: bool = True) -> list[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        if add_bos and add_special:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        bs = bytes(i - 3 for i in ids if 3 <= i < 259)
        return bs.decode("utf-8", errors="replace")

    def vocab_size(self) -> int:
        return self._vocab

    def token_to_piece(self, token_id: int) -> str:
        if 3 <= token_id < 259:
            return bytes([token_id - 3]).decode("utf-8", errors="replace")
        return ""

    @property
    def is_mock(self) -> bool:
        return True
