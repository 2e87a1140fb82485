"""Ternary linear layers on torch tensors, in the JAX package's word layout.

Counterpart of ``bitnet_tpu/ops/linear.py:43-121``.  Device storage is
int32 words ``[Kp/16, Np]`` (``[L, Kp/16, Np]`` when stacked): within each
KT=256 K-tile, word ``s`` (0..15), byte ``j`` and 2-bit plane ``p`` hold
the code of logical K row ``p*64 + 4s + j``.  So ``(w >> 2p) & 0x03030303``
yields 4 bytes that are 4 *consecutive* K values — one ``dp4a`` operand,
or one 4-byte slice of an int8 MMA fragment, in the CUDA kernels.

Columns are padded to a multiple of 128 (``LANE``) and K to a multiple of
256 with code 0; the kernels never read padded K rows past ``k`` for
qk256 weights of the main path (K == Kp there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import QuantizationError
from ..quant.qk256 import extract_codes

KT_PACK = 256
LANE = 128


def pad_k(k: int, kt: int = KT_PACK) -> int:
    return -(-k // kt) * kt


# --------------------------------------------------------------------------
# Host-side packing (numpy, load time)
# --------------------------------------------------------------------------
def repack_codes(codes_kn: np.ndarray, kt: int = KT_PACK) -> np.ndarray:
    """Logical codes [K, N] (uint2 in uint8) → [Kp/4, N] interleaved bytes.
    Padded K rows hold code 0."""
    K, N = codes_kn.shape
    Kp = pad_k(K, kt)
    if Kp != K:
        codes_kn = np.concatenate(
            [codes_kn, np.zeros((Kp - K, N), dtype=np.uint8)], axis=0)
    tiles = codes_kn.reshape(Kp // kt, 4, kt // 4, N).astype(np.uint8)
    packed = (tiles[:, 0] | (tiles[:, 1] << 2) | (tiles[:, 2] << 4)
              | (tiles[:, 3] << 6))
    return packed.reshape(Kp // 4, N)


def fold_packed_words(packed_bytes: np.ndarray) -> np.ndarray:
    """[Kp/4, N] uint8 → [Kp/16, N] int32 words; word ``s`` = byte rows
    ``4s..4s+3`` little-endian."""
    Kp4, N = packed_bytes.shape
    b = packed_bytes.reshape(Kp4 // 4, 4, N).astype(np.uint32)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return words.view(np.int32)


def unpack_words_host(words: np.ndarray, k: int, kt: int = KT_PACK) -> np.ndarray:
    """[Kp/16, N] int32 words → [k, N] uint8 codes (numpy; for tests)."""
    w = np.asarray(words).view(np.uint32)
    R, N = w.shape
    by = np.stack([(w >> (8 * j)) & 0xFF for j in range(4)],
                  axis=1).reshape(R * 4, N).astype(np.uint8)
    ntiles = by.shape[0] // (kt // 4)
    p = by.reshape(ntiles, kt // 4, N)
    parts = np.stack([(p >> (2 * j)) & 3 for j in range(4)], axis=1)
    return parts.reshape(ntiles * kt, N)[:k]


def _pad_cols(a: np.ndarray, mult: int = LANE) -> np.ndarray:
    n = a.shape[1]
    target = -(-n // mult) * mult
    if target == n:
        return a
    return np.concatenate(
        [a, np.zeros((a.shape[0], target - n), dtype=a.dtype)], axis=1)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TernaryLinear:
    """One qk256 linear (or an [L]-stacked set): ``packed`` int32 words
    ``[(L,) Kp/16, Np]``; ``scales`` a per-tensor scalar (``[]`` / ``[L]``)
    or, after fusion, a per-column vector ``[(L,) 1, Np]`` (f32)."""

    kind: str
    k: int
    n: int
    packed: torch.Tensor
    scales: torch.Tensor

    def to(self, device) -> "TernaryLinear":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scales=self.scales.to(device))


def qk256_linear_from_codes(codes_kn: np.ndarray,
                            scale: float = 1.0) -> TernaryLinear:
    """[K, N] uint8 codes → TernaryLinear (numpy repack, no native codec)."""
    k, n = codes_kn.shape
    words = _pad_cols(fold_packed_words(repack_codes(
        np.ascontiguousarray(codes_kn, np.uint8))))
    return TernaryLinear(
        kind="qk256", k=k, n=n,
        packed=torch.from_numpy(np.ascontiguousarray(words)),
        scales=torch.tensor(scale, dtype=torch.float32))


def qk256_linear_from_payload(payload: np.ndarray, out_dim: int, in_dim: int,
                              transposed: bool = False) -> TernaryLinear:
    """QK256 GGUF payload → TernaryLinear.  GGUF stores ``[out, in]``
    (``transposed`` = stored ``[in, out]``).  This is the numpy route —
    extract, transpose, repack, fold — which the JAX package replaced by a
    native codec because it takes minutes on a 2B checkpoint
    (bitnet_tpu/models/loader.py:229-230)."""
    if transposed:
        codes_kn = extract_codes(payload, in_dim, out_dim)
    else:
        codes_kn = extract_codes(payload, out_dim, in_dim).T
    return qk256_linear_from_codes(codes_kn)


# --------------------------------------------------------------------------
# Device-side helpers
# --------------------------------------------------------------------------
def unpack_packed(packed: torch.Tensor, kt: int = KT_PACK) -> torch.Tensor:
    """[Kp/16, N] int32 words → [Kp, N] uint8 codes (torch, any device).
    Word ``s``, byte ``j``, plane ``p`` → row ``p*64 + 4s + j`` of its
    256-row tile."""
    R, N = packed.shape
    ntiles = R // (kt // 16)
    w = packed.reshape(ntiles, kt // 16, N)
    parts = torch.stack(
        [torch.stack([(w >> (8 * j + 2 * p)) & 3 for j in range(4)], dim=2)
         for p in range(4)], dim=1)
    return parts.reshape(ntiles * kt, N).to(torch.uint8)


def codes_to_values(codes: torch.Tensor) -> torch.Tensor:
    """uint2 codes → {-2, -1, 1, 2} as float32 (no gather)."""
    c = codes.to(torch.int32)
    return (c + (c >= 2).to(torch.int32) - 2).to(torch.float32)


def dequantize_weight(lin: TernaryLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [K, N] weight of an unstacked linear."""
    if lin.kind != "qk256":
        raise QuantizationError(f"unknown TernaryLinear kind {lin.kind!r}")
    vals = codes_to_values(unpack_packed(lin.packed)[: lin.k, : lin.n])
    s = lin.scales.to(torch.float32)
    if s.ndim >= 2:                     # fused per-column vector [1, Np]
        s = s[..., :, : lin.n]
    return (vals * s).to(dtype)


def concat_linears(lins: list[TernaryLinear]) -> TernaryLinear:
    """Concatenate linears along N (q|k|v, gate|up).  Scalar per-tensor
    scales become a per-column vector ``[..., 1, Ntot]``."""
    kinds = {l.kind for l in lins}
    if kinds != {"qk256"}:
        raise QuantizationError(f"cannot fuse kinds {kinds}")
    if any(l.n % LANE != 0 for l in lins):
        raise QuantizationError(
            f"fusion needs 128-aligned widths, got {[l.n for l in lins]}")
    if len({l.k for l in lins}) != 1:
        raise QuantizationError("fusion needs equal K")
    packed = torch.cat([l.packed for l in lins], dim=-1)
    cols = []
    for l in lins:
        s = l.scales.to(torch.float32)
        cols.append(s.reshape(*s.shape, 1, 1).expand(*s.shape, 1, l.n))
    return TernaryLinear(kind="qk256", k=lins[0].k,
                         n=sum(l.n for l in lins), packed=packed,
                         scales=torch.cat(cols, dim=-1).contiguous())
