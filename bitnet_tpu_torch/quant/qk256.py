"""I2_S QK256 (no-scale) codec, numpy only.

Own copy of what the port needs from ``bitnet_tpu/quant/qk256.py``: 64 B
of packed 2-bit codes per 256-element block (value = LUT[code], see
``quant/ternary.py``), each row of a [rows, cols] weight padded
independently to whole blocks.
"""

from __future__ import annotations

import numpy as np

from ..errors import QuantizationError
from .ternary import unpack_codes_lsb_first

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
