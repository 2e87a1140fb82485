"""TL1 / TL2 table-lookup codecs, and the runtime re-quantization of a
model's linears into the TL kernel layout.

Own copy of ``bitnet_tpu/quant/tl.py``.  In the reference these are
platform-tuned LUT formats (``crates/bitnet-quantization/src/tl1.rs``
block=64, ``src/tl2.rs`` block=128); both are symmetric 2-bit codecs whose
codes are unsigned LUT indices with reverse table ``value = (code - 2) *
scale`` and ``scale = absmax`` (``tl1.rs:49-82``).

The flat codecs are numpy.  The re-quantization (:func:`quantize_linear_tl`,
:func:`quantize_params_tl`) runs in torch on the weights' device: unpack,
block absmax, codes, repack — no host round trip (the numpy route takes
minutes on a 2B model).  Its codes and scales are bit-identical to the
JAX package's numpy: every step is exact f32 arithmetic, the division is
tensor by tensor (PyTorch's CUDA division by a Python scalar multiplies by
the reciprocal instead), and ``torch.round`` rounds half to even as
``np.round`` does — which matters, since a ternary weight re-quantized
from QK256 lands on ``w/s = ±0.5`` exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import QuantizationError
from ..ops.linear import TernaryLinear, dequantize_weight, tl_linear_from_codes
from .ternary import pack_codes_lsb_first, unpack_codes_lsb_first

TL1_BLOCK = 64
TL2_BLOCK = 128
_NUM_LEVELS = 4  # 2-bit


def _tl_quantize(x: np.ndarray, block: int) -> tuple[bytes, np.ndarray]:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    nblocks = -(-x.size // block)
    padded = np.zeros(nblocks * block, dtype=np.float32)
    padded[: x.size] = x
    blocked = padded.reshape(nblocks, block)
    absmax = np.abs(blocked).max(axis=1)
    # symmetric scale: absmax / (num_levels/2 - 1) = absmax / 1
    scale = np.where(absmax == 0.0, 1.0, absmax).astype(np.float32)
    # code = clamp(round(x/scale) + 2, 0, 3)  (levels {-2,-1,0,1})
    q = np.round(blocked / scale[:, None]).astype(np.int32) + _NUM_LEVELS // 2
    codes = np.clip(q, 0, _NUM_LEVELS - 1).astype(np.uint8)
    return pack_codes_lsb_first(codes.reshape(-1)).tobytes(), scale


def _tl_dequantize(payload: np.ndarray | bytes, nelems: int, scales: np.ndarray,
                   block: int) -> np.ndarray:
    raw = (np.frombuffer(payload, dtype=np.uint8) if isinstance(payload, bytes)
           else np.ascontiguousarray(payload, dtype=np.uint8))
    nblocks = -(-nelems // block)
    need = nblocks * block // 4
    if raw.size < need:
        raise QuantizationError(f"TL: payload {raw.size} B < required {need} B")
    s = np.asarray(scales, dtype=np.float32).reshape(-1)
    if s.size < nblocks:
        raise QuantizationError(f"TL: {s.size} scales for {nblocks} blocks")
    codes = unpack_codes_lsb_first(raw[:need]).astype(np.int32)
    vals = (codes - _NUM_LEVELS // 2).reshape(nblocks, block) * s[:nblocks, None]
    return vals.reshape(-1)[:nelems].astype(np.float32)


def quantize_tl1(x: np.ndarray) -> tuple[bytes, np.ndarray]:
    """TL1 (block=64). Returns (packed bytes, per-block f32 scales)."""
    return _tl_quantize(x, TL1_BLOCK)


def dequantize_tl1(payload, nelems: int, scales: np.ndarray) -> np.ndarray:
    return _tl_dequantize(payload, nelems, scales, TL1_BLOCK)


def quantize_tl2(x: np.ndarray) -> tuple[bytes, np.ndarray]:
    """TL2 (block=128). Returns (packed bytes, per-block f32 scales)."""
    return _tl_quantize(x, TL2_BLOCK)


def dequantize_tl2(payload, nelems: int, scales: np.ndarray) -> np.ndarray:
    return _tl_dequantize(payload, nelems, scales, TL2_BLOCK)


# --------------------------------------------------------------------------
# runtime weight quantization → TL kernel layout (tl1.rs:163: TL is a
# RUNTIME format, produced from loaded tensors, not a GGUF storage type)
# --------------------------------------------------------------------------
def tl_quantize_dense(w: torch.Tensor, block: int) -> TernaryLinear:
    """[K, N] float weights → a TL linear: per-K-block absmax scales,
    ``codes = clamp(round(w/s) + 2, 0, 3)``.  A K that the block does not
    divide shrinks the block (finer scales), as the reference does
    (``quant/tl.py:128-132``)."""
    K, N = w.shape
    while block > 32 and K % block:
        block //= 2
    if K % block:
        raise QuantizationError(f"TL block must divide K={K} (got down to {block})")
    b = w.to(torch.float32).reshape(K // block, block, N)
    absmax = b.abs().amax(dim=1)                       # [K/block, N]
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax)
    q = torch.round(b / scale[:, None, :])             # tensor / tensor: exact
    codes = torch.clamp(q + _NUM_LEVELS // 2, 0, _NUM_LEVELS - 1).to(torch.uint8)
    return tl_linear_from_codes(codes.reshape(K, N), scale, block)


def quantize_linear_tl(lin: TernaryLinear, block: int) -> TernaryLinear:
    """Re-quantize a linear (2-D or [L]-stacked, layer by layer) into the
    TL kernel layout, on its device, from its f32 dense weights (the JAX
    package's ``_dense_host_kn``, ``quant/tl.py:88-108``; a dense linear's
    weight as it is)."""
    if not lin.stacked:
        return tl_quantize_dense(dequantize_weight(lin, torch.float32), block)

    def layer(li):
        if lin.kind == "dense":
            return dataclasses.replace(lin, weight=lin.weight[li])
        return dataclasses.replace(lin, packed=lin.packed[li], scales=lin.scales[li])

    L = (lin.weight if lin.kind == "dense" else lin.packed).shape[0]
    layers = [tl_quantize_dense(dequantize_weight(layer(li), torch.float32), block)
              for li in range(L)]
    return TernaryLinear(kind="tl", k=layers[0].k, n=layers[0].n,
                         packed=torch.stack([l.packed for l in layers]),
                         scales=torch.stack([l.scales for l in layers]))


ROLES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gateup")


def quantize_params_tl(params, variant: str = "tl1"):
    """Runtime-quantize every linear of a BitNetParams (and an untied
    ``lm_head``) to TL1 / TL2 (``bitnet_tpu/quant/tl.py:162-184``).
    Embeddings and norms stay untouched, as in the reference."""
    block = {"tl1": TL1_BLOCK, "tl2": TL2_BLOCK}.get(variant)
    if block is None:
        raise QuantizationError(f"unknown TL variant {variant!r}")
    b = params.blocks
    q = {r: None if getattr(b, r) is None else quantize_linear_tl(getattr(b, r), block)
         for r in ROLES}
    lm_head = (None if params.lm_head is None
               else quantize_linear_tl(params.lm_head, block))
    return dataclasses.replace(params, blocks=dataclasses.replace(b, **q),
                               lm_head=lm_head)
