"""I2_S 32-element-block codecs (BitNet32F16 and Split32), numpy only.

Own copy of ``bitnet_tpu/quant/i2s.py``.  Layouts
(``crates/bitnet-quantization/src/i2s.rs:27-50`` and
``formats/gguf/types.rs:780-847``):

- **BitNet32F16**: per block of 32 elements, 10 bytes —
  8 B packed LSB-first 2-bit codes followed by 2 B little-endian f16 scale.
- **Split32**: 8 B packed codes per block; scales in a separate array
  (sibling tensor in GGUF, f16/f32).

Dequantized value = ``LUT_SYM[code] * scale``.  Blocks run over the
flattened row-major tensor (innermost dim fastest), matching GGUF's
block-along-ne[0] layout.  Inline f16 scales are read as ``|s|`` clipped
to [1e-3, 1e3] (the reference's I2S_SCALE_MIN/MAX).
"""

from __future__ import annotations

import numpy as np

from ..errors import QuantizationError
from .ternary import (
    LUT_SYM,
    block_absmax_scale,
    pack_codes_lsb_first,
    ternary_quantize_codes,
    unpack_codes_lsb_first,
)

BLOCK32 = 32
DATA_BYTES32 = 8
INLINE_BYTES32 = 10
SCALE_MIN, SCALE_MAX = 1e-3, 1e3


def _raw(payload: np.ndarray | bytes) -> np.ndarray:
    return (np.frombuffer(payload, dtype=np.uint8) if isinstance(payload, bytes)
            else np.ascontiguousarray(payload, dtype=np.uint8).reshape(-1))


# --------------------------------------------------------------------------
# BitNet32F16 (inline f16 scale)
# --------------------------------------------------------------------------
def quantize_bitnet32(x: np.ndarray) -> bytes:
    """Quantize a float tensor into BitNet32F16 payload bytes."""
    blocked, d = block_absmax_scale(x, BLOCK32)
    codes = ternary_quantize_codes(blocked, d[:, None])
    packed = pack_codes_lsb_first(codes.reshape(-1)).reshape(-1, DATA_BYTES32)
    scales = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return np.concatenate([packed, scales], axis=1).tobytes()   # [nblocks, 10]


def bitnet32_codes_and_scales(payload: np.ndarray | bytes,
                              nelems: int) -> tuple[np.ndarray, np.ndarray]:
    """BitNet32F16 payload → (flat uint8 codes [nelems], f32 block scales
    [ceil(nelems/32)], abs-clipped)."""
    raw = _raw(payload)
    nblocks = -(-nelems // BLOCK32)
    need = nblocks * INLINE_BYTES32
    if raw.size < need:
        raise QuantizationError(
            f"BitNet32F16: payload {raw.size} B < required {need} B")
    blocks = raw[:need].reshape(nblocks, INLINE_BYTES32)
    scales = np.ascontiguousarray(blocks[:, DATA_BYTES32:]).view(np.float16)
    scales = np.clip(np.abs(scales.reshape(nblocks).astype(np.float32)),
                     SCALE_MIN, SCALE_MAX)
    codes = unpack_codes_lsb_first(blocks[:, :DATA_BYTES32].reshape(-1))
    return codes[:nelems], scales


def dequantize_bitnet32(payload: np.ndarray | bytes, nelems: int) -> np.ndarray:
    """Dequantize BitNet32F16 payload to flat float32 of length ``nelems``."""
    codes, scales = bitnet32_codes_and_scales(payload, nelems)
    nblocks = scales.size
    full = np.zeros(nblocks * BLOCK32, np.uint8)
    full[:nelems] = codes
    vals = LUT_SYM[full].reshape(nblocks, BLOCK32) * scales[:, None]
    return vals.reshape(-1)[:nelems].astype(np.float32)


# --------------------------------------------------------------------------
# Split32 (sibling scales)
# --------------------------------------------------------------------------
def quantize_split32(x: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Quantize into (packed data bytes, per-block f32 scales array)."""
    blocked, d = block_absmax_scale(x, BLOCK32)
    codes = ternary_quantize_codes(blocked, d[:, None])
    return pack_codes_lsb_first(codes.reshape(-1)).tobytes(), d


def split32_codes(payload: np.ndarray | bytes, nelems: int) -> np.ndarray:
    """Split32 payload → flat uint8 codes [nelems]."""
    raw = _raw(payload)
    nblocks = -(-nelems // BLOCK32)
    need = nblocks * DATA_BYTES32
    if raw.size < need:
        raise QuantizationError(
            f"Split32: payload {raw.size} B < required {need} B")
    return unpack_codes_lsb_first(raw[:need])[:nelems]


def dequantize_split32(payload: np.ndarray | bytes, nelems: int,
                       scales: np.ndarray | None = None) -> np.ndarray:
    """Dequantize Split32 payload with sibling ``scales`` (defaults to 1.0)."""
    nblocks = -(-nelems // BLOCK32)
    full = np.zeros(nblocks * BLOCK32, np.uint8)
    full[:nelems] = split32_codes(payload, nelems)
    vals = LUT_SYM[full].reshape(nblocks, BLOCK32)
    if scales is not None:
        s = np.asarray(scales, dtype=np.float32).reshape(-1)
        if s.size == 1:
            vals = vals * s[0]
        elif s.size >= nblocks:
            vals = vals * s[:nblocks, None]
        else:
            raise QuantizationError(f"Split32: {s.size} scales for {nblocks} blocks")
    return vals.reshape(-1)[:nelems].astype(np.float32)
