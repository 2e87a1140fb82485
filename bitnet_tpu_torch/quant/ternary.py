"""2-bit code primitives (own copy of the parts of bitnet_tpu/quant/ternary.py
the port needs).

Code → value is the GGML symmetric LUT used by every I2_S flavor:
code 0 → -2, 1 → -1, 2 → +1, 3 → +2.  Packing is LSB-first, 4 codes per
byte: ``byte = c0 | c1 << 2 | c2 << 4 | c3 << 6``.
"""

from __future__ import annotations

import numpy as np

# Symmetric 4-level LUT (no representable zero) — GGML IQ2_S qmap.
LUT_SYM = np.array([-2.0, -1.0, 1.0, 2.0], dtype=np.float32)


def ternary_quantize_codes(x: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Quantize floats to 2-bit codes given per-block scale ``d``.
    Thresholds match GGML: v<-1.5 → 0, v<0 → 1, v<1.5 → 2, else 3."""
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(d > 0, x / d, 0.0)
    codes = np.full(v.shape, 3, dtype=np.uint8)
    codes[v < 1.5] = 2
    codes[v < 0.0] = 1
    codes[v < -1.5] = 0
    return codes


def pack_codes_lsb_first(codes: np.ndarray) -> np.ndarray:
    """Pack uint2 codes (flat, len % 4 == 0) into bytes, LSB-first."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8).reshape(-1, 4)
    return (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
            | (codes[:, 3] << 6)).astype(np.uint8)


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


def block_absmax_scale(x: np.ndarray, block: int) -> tuple[np.ndarray, np.ndarray]:
    """Split flat ``x`` into blocks and compute GGML ``d = absmax/2`` scales.
    Returns (blocked_x [nblocks, block] zero-padded, d [nblocks])."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    nblocks = -(-x.size // block)
    padded = np.zeros(nblocks * block, dtype=np.float32)
    padded[: x.size] = x
    blocked = padded.reshape(nblocks, block)
    absmax = np.abs(blocked).max(axis=1)
    absmax = np.where(absmax == 0.0, 1e-8, absmax)
    d = absmax / 2.0
    return blocked, d.astype(np.float32)
