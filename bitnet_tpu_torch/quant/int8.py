"""Activation int8 quantization (per-row absmax).

BitNet b1.58 computes with ternary weights × int8 activations.  This module
provides the host/numpy reference (own copy of
``bitnet_tpu/quant/int8.py``); on the card the kernels quantize their
rows themselves (``ops/ternary_matmul.quantize_rows`` is their plain
version).
"""

from __future__ import annotations

import numpy as np


def quantize_activations_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric absmax quantization.

    ``x``: [..., K] floats → (q: int8 same shape, scale: [..., 1] f32) with
    ``x ≈ q * scale``.
    """
    x = np.asarray(x, dtype=np.float32)
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    absmax = np.where(absmax == 0.0, 1.0, absmax)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_activations_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scale, dtype=np.float32)
