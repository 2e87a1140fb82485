"""I2_S QK256 (no-scale) codec, numpy only.

Own copy of what the port needs from ``bitnet_tpu/quant/qk256.py``: 64 B
of packed 2-bit codes per 256-element block (value = LUT[code], see
``quant/ternary.py``), each row of a [rows, cols] weight padded
independently to whole blocks; and IQ2_S (ggml type 24): 82 B a
256-element block = 2 B f16 ``d`` + 64 B ``qs`` + 8 B ``qh`` + 8 B
``scales`` (qh / scales unused by the simplified codec), value = ``d *
LUT[code]`` (``bitnet_tpu/quant/qk256.py:93-140``).
"""

from __future__ import annotations

import numpy as np

from ..errors import QuantizationError
from .ternary import (LUT_SYM, pack_codes_lsb_first, ternary_quantize_codes,
                      unpack_codes_lsb_first)

QK256_BLOCK = 256
QK256_PACKED_BYTES = 64
IQ2S_BLOCK_BYTES = 82


def row_stride_bytes(cols: int) -> int:
    return -(-cols // QK256_BLOCK) * QK256_PACKED_BYTES


def extract_codes(payload: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """QK256 payload ([rows, cols] row-major as stored) → uint8 codes
    [rows, cols]."""
    raw = np.ascontiguousarray(payload, dtype=np.uint8).reshape(-1)
    stride = row_stride_bytes(cols)
    need = rows * stride
    if raw.size < need:
        raise QuantizationError(
            f"QK256 payload too small: {raw.size} < {need} bytes for "
            f"[{rows}, {cols}]")
    codes = unpack_codes_lsb_first(raw[:need])
    return codes.reshape(rows, stride * 4)[:, :cols]


def quantize_qk256(w: np.ndarray) -> bytes:
    """[rows, cols] floats → QK256 packed bytes (row-padded); each element
    snaps to the nearest LUT level (GGML's threshold rule with d=1)."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    if w.ndim == 1:
        w = w[None, :]
    rows, cols = w.shape
    padded = np.zeros((rows, -(-cols // QK256_BLOCK) * QK256_BLOCK), np.float32)
    padded[:, :cols] = w
    codes = ternary_quantize_codes(padded, np.float32(1.0))
    return pack_codes_lsb_first(codes.reshape(-1)).tobytes()


def dequantize_qk256(payload: np.ndarray | bytes, rows: int, cols: int) -> np.ndarray:
    """QK256 payload → [rows, cols] float32."""
    raw = (np.frombuffer(payload, dtype=np.uint8) if isinstance(payload, bytes)
           else payload)
    return LUT_SYM[extract_codes(raw, rows, cols)]


def quantize_iq2s(x: np.ndarray) -> bytes:
    """Flat / 2-D floats → IQ2_S blocks (82 B each): d = absmax / 2 per
    256-block, the qh and scales fields zeroed."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % QK256_BLOCK != 0:
        raise QuantizationError(f"IQ2_S requires nelems % 256 == 0, got {x.size}")
    nblocks = x.size // QK256_BLOCK
    blocked = x.reshape(nblocks, QK256_BLOCK)
    absmax = np.abs(blocked).max(axis=1)
    absmax = np.where(absmax == 0.0, 1e-8, absmax)
    d = (absmax / 2.0).astype(np.float32)
    codes = ternary_quantize_codes(blocked, d[:, None])
    qs = pack_codes_lsb_first(codes.reshape(-1)).reshape(nblocks, QK256_PACKED_BYTES)
    out = np.zeros((nblocks, IQ2S_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nblocks, 2)
    out[:, 2:2 + QK256_PACKED_BYTES] = qs
    return out.tobytes()


def dequantize_iq2s(payload: np.ndarray | bytes, nelems: int) -> np.ndarray:
    """IQ2_S payload → flat float32 (d * LUT[code])."""
    raw = (np.frombuffer(payload, dtype=np.uint8) if isinstance(payload, bytes)
           else np.ascontiguousarray(payload, dtype=np.uint8))
    if nelems % QK256_BLOCK != 0:
        raise QuantizationError(f"IQ2_S requires nelems % 256 == 0, got {nelems}")
    nblocks = nelems // QK256_BLOCK
    need = nblocks * IQ2S_BLOCK_BYTES
    if raw.size < need:
        raise QuantizationError(f"IQ2_S: payload {raw.size} B < required {need} B")
    blocks = raw[:need].reshape(nblocks, IQ2S_BLOCK_BYTES)
    d = np.ascontiguousarray(blocks[:, 0:2]).view(np.float16).reshape(nblocks)
    qs = blocks[:, 2:2 + QK256_PACKED_BYTES]
    codes = unpack_codes_lsb_first(qs.reshape(-1))
    vals = LUT_SYM[codes].reshape(nblocks, QK256_BLOCK) * d.astype(np.float32)[:, None]
    return vals.reshape(-1).astype(np.float32)
