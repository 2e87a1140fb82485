"""GGUF-embedded vocabulary tokenizer (SentencePiece-BPE semantics).

Own copy of ``bitnet_tpu/tokenizer/gguf_vocab.py``: the port imports nothing of the
JAX package.

Equivalent of the reference's GGUF tokenizer
(``bitnet-tokenizers/src/gguf_tokenizer.rs`` + ``gguf_loader.rs``): builds a
tokenizer purely from GGUF metadata (``tokenizer.ggml.tokens/scores/
token_type`` + special-token ids) with llama.cpp SPM semantics:

- text is prefixed/space-mapped with ``▁`` (U+2581),
- greedy highest-score bigram merging (priority queue), matching SPM BPE,
- byte fallback (``<0xNN>`` pieces) for unknown bytes,
- byte pieces decode to raw bytes; ``▁`` decodes to space.
"""

from __future__ import annotations

import heapq

from .base import Tokenizer

SPM_SPACE = "▁"  # ▁

# tokenizer.ggml.token_type values (ggml/llama.cpp convention)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


class GGUFTokenizer(Tokenizer):
    def __init__(
        self,
        tokens: list[str],
        scores: list[float] | None = None,
        token_types: list[int] | None = None,
        bos_token_id: int | None = None,
        eos_token_id: int | None = None,
        unk_token_id: int | None = None,
        add_space_prefix: bool = True,
        real_vocab: int | None = None,
    ):
        self.tokens = list(tokens)
        self.scores = list(scores) if scores is not None else [0.0] * len(tokens)
        self.token_types = (list(token_types) if token_types is not None
                            else [TOKEN_TYPE_NORMAL] * len(tokens))
        self.piece_to_id = {p: i for i, p in enumerate(self.tokens)}
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.unk_token_id = unk_token_id
        self.add_space_prefix = add_space_prefix
        self._real_vocab = real_vocab or len(tokens)
        # byte-piece lookup
        self.byte_to_id: dict[int, int] = {}
        for i, (p, t) in enumerate(zip(self.tokens, self.token_types)):
            if t == TOKEN_TYPE_BYTE or (
                len(p) == 6 and p.startswith("<0x") and p.endswith(">")
            ):
                try:
                    self.byte_to_id[int(p[3:5], 16)] = i
                except ValueError:
                    pass

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_gguf_metadata(cls, metadata: dict) -> "GGUFTokenizer":
        tokens = metadata.get("tokenizer.ggml.tokens")
        if tokens is None:
            raise ValueError("GGUF has no embedded tokenizer vocab")
        scores = metadata.get("tokenizer.ggml.scores")
        types = metadata.get("tokenizer.ggml.token_type")
        if types is not None:
            types = [int(t) for t in types]
        if scores is not None:
            scores = [float(s) for s in scores]
        return cls(
            tokens=list(tokens),
            scores=scores,
            token_types=types,
            bos_token_id=_opt_int(metadata.get("tokenizer.ggml.bos_token_id")),
            eos_token_id=_opt_int(metadata.get("tokenizer.ggml.eos_token_id")),
            unk_token_id=_opt_int(
                metadata.get("tokenizer.ggml.unknown_token_id")),
            add_space_prefix=bool(
                metadata.get("tokenizer.ggml.add_space_prefix", True)),
        )

    # -- encode ---------------------------------------------------------------
    def encode(self, text: str, add_bos: bool = True,
               add_special: bool = True) -> list[int]:
        ids: list[int] = []
        if add_bos and add_special and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        if not text:
            return ids
        norm = text.replace(" ", SPM_SPACE)
        if self.add_space_prefix and not norm.startswith(SPM_SPACE):
            norm = SPM_SPACE + norm
        ids.extend(self._spm_bpe(norm))
        return ids

    def _spm_bpe(self, text: str) -> list[int]:
        """SPM-BPE greedy merge: repeatedly merge the adjacent symbol pair
        whose merged piece has the highest score in the vocab."""
        # initial symbols: individual characters (byte-fallback for unknowns)
        symbols: list[str] = list(text)
        n = len(symbols)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n

        heap: list[tuple[float, int, int, str]] = []

        def try_pair(i: int) -> None:
            j = nxt[i]
            if j == -1:
                return
            merged = symbols[i] + symbols[j]
            tid = self.piece_to_id.get(merged)
            if tid is not None:
                heapq.heappush(heap, (-self.scores[tid], i, j, merged))

        for i in range(n - 1):
            try_pair(i)

        while heap:
            _, i, j, merged = heapq.heappop(heap)
            if not (alive[i] and alive[j] and nxt[i] == j
                    and symbols[i] + symbols[j] == merged):
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prev[nxt[j]] = i
            if prev[i] != -1:
                try_pair(prev[i])
            try_pair(i)

        # node 0 is always alive (merges keep the left node); walking nxt
        # from it only visits alive nodes.
        out: list[int] = []
        i = 0
        while i != -1:
            piece = symbols[i]
            tid = self.piece_to_id.get(piece)
            if tid is not None:
                out.append(tid)
            else:
                out.extend(self._byte_fallback(piece))
            i = nxt[i]
        return out

    def _byte_fallback(self, piece: str) -> list[int]:
        out = []
        for b in piece.encode("utf-8"):
            tid = self.byte_to_id.get(b)
            if tid is not None:
                out.append(tid)
            elif self.unk_token_id is not None:
                out.append(self.unk_token_id)
        return out

    # -- decode ---------------------------------------------------------------
    def token_to_piece(self, token_id: int) -> str:
        if not (0 <= token_id < len(self.tokens)):
            return ""
        t = self.token_types[token_id]
        p = self.tokens[token_id]
        if t == TOKEN_TYPE_CONTROL:
            return ""
        if token_id in (self.bos_token_id, self.eos_token_id):
            return ""
        if t == TOKEN_TYPE_BYTE or (
            len(p) == 6 and p.startswith("<0x") and p.endswith(">")
        ):
            try:
                return bytes([int(p[3:5], 16)]).decode("utf-8",
                                                        errors="replace")
            except ValueError:
                return p
        return p.replace(SPM_SPACE, " ")

    def decode(self, ids: list[int]) -> str:
        # accumulate byte pieces so multi-byte UTF-8 survives
        out: list[bytes] = []
        for tid in ids:
            if not (0 <= tid < len(self.tokens)):
                continue
            t = self.token_types[tid]
            p = self.tokens[tid]
            if t == TOKEN_TYPE_CONTROL or tid in (self.bos_token_id,
                                                  self.eos_token_id):
                continue
            if t == TOKEN_TYPE_BYTE or (
                len(p) == 6 and p.startswith("<0x") and p.endswith(">")
            ):
                try:
                    out.append(bytes([int(p[3:5], 16)]))
                    continue
                except ValueError:
                    pass
            out.append(p.replace(SPM_SPACE, " ").encode("utf-8"))
        return b"".join(out).decode("utf-8", errors="replace")

    def vocab_size(self) -> int:
        return len(self.tokens)

    def real_vocab_size(self) -> int:
        return self._real_vocab

    def token_to_id(self, piece: str) -> int | None:
        return self.piece_to_id.get(piece)


def _opt_int(v) -> int | None:
    return int(v) if v is not None else None
