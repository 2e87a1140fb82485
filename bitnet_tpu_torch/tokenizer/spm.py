"""SentencePiece ``.model`` backend (no sentencepiece dependency).

Own copy of ``bitnet_tpu/tokenizer/spm.py``: the port imports nothing of the
JAX package.

The reference ships dedicated SPM backends
(``bitnet-tokenizers/src/{sp_tokenizer,spm_tokenizer}.rs`` over the
sentencepiece crate).  This environment has no sentencepiece package, so
we parse the ``ModelProto`` protobuf wire format directly — we only need
the pieces (string / score / type) and the trainer-spec special ids — and
reuse the SPM-BPE merge machinery of :class:`GGUFTokenizer` (greedy
highest-score bigram merges + byte fallback, llama.cpp ``llm_tokenizer_spm``
semantics).  SentencePiece's piece-type enum (NORMAL=1 … BYTE=6) matches
the GGUF ``tokenizer.ggml.token_type`` convention exactly.

A matching writer (:func:`write_spm_model`) exists so tests can fabricate
valid ``.model`` files without network access.
"""

from __future__ import annotations

import struct

from ..errors import TokenizerError
from .gguf_vocab import GGUFTokenizer

# ModelProto field numbers (sentencepiece_model.proto)
_F_PIECES = 1
_F_TRAINER = 2
# SentencePiece submessage
_F_PIECE = 1
_F_SCORE = 2
_F_TYPE = 3
# TrainerSpec special ids
_F_UNK_ID = 40
_F_BOS_ID = 41
_F_EOS_ID = 42


# --------------------------------------------------------------------------
# minimal protobuf wire reader
# --------------------------------------------------------------------------
def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if i >= len(buf):
            raise TokenizerError("truncated varint in .model file")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise TokenizerError("varint overflow in .model file")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.

    Values: varint → int, length-delimited → bytes, fixed32/64 → bytes.
    """
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:          # varint
            v, i = _read_varint(buf, i)
            yield field, wt, v
        elif wt == 2:        # length-delimited
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise TokenizerError("truncated field in .model file")
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:        # fixed32
            if i + 4 > n:
                raise TokenizerError("truncated fixed32 in .model file")
            yield field, wt, buf[i:i + 4]
            i += 4
        elif wt == 1:        # fixed64
            if i + 8 > n:
                raise TokenizerError("truncated fixed64 in .model file")
            yield field, wt, buf[i:i + 8]
            i += 8
        else:
            raise TokenizerError(
                f"unsupported wire type {wt} in .model file")


def parse_spm_model(data: bytes) -> tuple[list[str], list[float], list[int],
                                          dict[str, int]]:
    """ModelProto bytes → (pieces, scores, types, special_ids)."""
    pieces: list[str] = []
    scores: list[float] = []
    types: list[int] = []
    specials = {"unk": 0, "bos": 1, "eos": 2}
    for field, wt, val in _iter_fields(data):
        if field == _F_PIECES and wt == 2:
            piece, score, ptype = "", 0.0, 1
            for f2, wt2, v2 in _iter_fields(val):
                if f2 == _F_PIECE and wt2 == 2:
                    piece = v2.decode("utf-8", errors="replace")
                elif f2 == _F_SCORE and wt2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == _F_TYPE and wt2 == 0:
                    ptype = int(v2)
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        elif field == _F_TRAINER and wt == 2:
            for f2, wt2, v2 in _iter_fields(val):
                if wt2 != 0:
                    continue
                if f2 == _F_UNK_ID:
                    specials["unk"] = int(v2)
                elif f2 == _F_BOS_ID:
                    specials["bos"] = int(v2)
                elif f2 == _F_EOS_ID:
                    specials["eos"] = int(v2)
    if not pieces:
        raise TokenizerError("no pieces in .model file (not a "
                             "SentencePiece ModelProto?)")
    return pieces, scores, types, specials


class SPMTokenizer(GGUFTokenizer):
    """Tokenizer loaded from a SentencePiece ``.model`` file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        pieces, scores, types, sp = parse_spm_model(data)
        nv = len(pieces)

        def _ok(i):
            return i if 0 <= i < nv else None

        super().__init__(
            tokens=pieces, scores=scores, token_types=types,
            bos_token_id=_ok(sp["bos"]), eos_token_id=_ok(sp["eos"]),
            unk_token_id=_ok(sp["unk"]),
        )
        self.path = path


# --------------------------------------------------------------------------
# writer (test fixtures)
# --------------------------------------------------------------------------
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wt: int) -> bytes:
    return _varint((num << 3) | wt)


def write_spm_model(path: str, pieces: list[tuple[str, float, int]],
                    unk_id: int = 0, bos_id: int = 1, eos_id: int = 2
                    ) -> None:
    """Write a minimal valid SentencePiece ModelProto."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _field(_F_PIECE, 2) + _varint(len(pb)) + pb
        body += _field(_F_SCORE, 5) + struct.pack("<f", score)
        body += _field(_F_TYPE, 0) + _varint(ptype)
        out += _field(_F_PIECES, 2) + _varint(len(body)) + bytes(body)
    trainer = bytearray()
    trainer += _field(_F_UNK_ID, 0) + _varint(unk_id)
    trainer += _field(_F_BOS_ID, 0) + _varint(bos_id)
    trainer += _field(_F_EOS_ID, 0) + _varint(eos_id)
    out += _field(_F_TRAINER, 2) + _varint(len(trainer)) + bytes(trainer)
    with open(path, "wb") as f:
        f.write(bytes(out))
