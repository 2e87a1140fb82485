"""Tokenizer protocol.

Own copy of ``bitnet_tpu/tokenizer/base.py``: the port imports nothing of the
JAX package.

Interface parity with the reference ``Tokenizer`` trait
(``bitnet-tokenizers/src/lib.rs:83-120``): encode with BOS/special control,
decode, vocab_size vs real_vocab_size (GGUF padding), token_to_piece,
token_to_id.
"""

from __future__ import annotations

import abc


class Tokenizer(abc.ABC):
    bos_token_id: int | None = None
    eos_token_id: int | None = None
    unk_token_id: int | None = None

    @abc.abstractmethod
    def encode(self, text: str, add_bos: bool = True,
               add_special: bool = True) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: list[int]) -> str: ...

    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    def real_vocab_size(self) -> int:
        """Unpadded vocab (lib.rs:111-120): GGUF embeddings may be padded."""
        return self.vocab_size()

    @abc.abstractmethod
    def token_to_piece(self, token_id: int) -> str: ...

    def token_to_id(self, piece: str) -> int | None:
        return None

    @property
    def is_mock(self) -> bool:
        return False
