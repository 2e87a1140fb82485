"""2-bit code primitives (own copy of the parts of bitnet_tpu/quant/ternary.py
the port needs).

Code → value is the GGML symmetric LUT used by every I2_S flavor:
code 0 → -2, 1 → -1, 2 → +1, 3 → +2.  Packing is LSB-first, 4 codes per
byte: ``byte = c0 | c1 << 2 | c2 << 4 | c3 << 6``.
"""

from __future__ import annotations

import numpy as np


def unpack_codes_lsb_first(packed: np.ndarray, n: int | None = None) -> np.ndarray:
    """Unpack bytes into uint2 codes, LSB-first; flat result (first ``n``)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(packed.size * 4, dtype=np.uint8)
    # typed shift constants: numpy 2's weak promotion makes
    # `uint8 >> python_int` far slower than `uint8 >> np.uint8(...)`
    m3 = np.uint8(0x3)
    out[0::4] = packed & m3
    out[1::4] = (packed >> np.uint8(2)) & m3
    out[2::4] = (packed >> np.uint8(4)) & m3
    out[3::4] = (packed >> np.uint8(6)) & m3
    if n is not None:
        out = out[:n]
    return out
