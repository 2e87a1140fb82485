"""I2_S QK256 (no-scale) codec, numpy only.

Own copy of what the port needs from ``bitnet_tpu/quant/qk256.py``: 64 B
of packed 2-bit codes per 256-element block (value = LUT[code], see
``quant/ternary.py``), each row of a [rows, cols] weight padded
independently to whole blocks.
"""

from __future__ import annotations

import numpy as np

from ..errors import QuantizationError
from .ternary import (LUT_SYM, pack_codes_lsb_first, ternary_quantize_codes,
                      unpack_codes_lsb_first)

QK256_BLOCK = 256
QK256_PACKED_BYTES = 64


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
