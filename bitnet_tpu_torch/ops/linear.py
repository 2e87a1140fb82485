"""Ternary linear layers on torch tensors, in the JAX package's word layout.

Counterpart of ``bitnet_tpu/ops/linear.py:43-260``: the layout, the
parameters, and ``linear_apply`` / ``linear_apply_normed``, which send the
``pallas`` and ``w2a8`` paths to the kernels' dispatcher
(``ops/ternary_matmul.ternary_matmul_pallas``) and run the ``xla`` path as
a dequantized weight and a plain matmul.  Device storage is
int32 words ``[Kp/16, Np]`` (``[L, Kp/16, Np]`` when stacked): within each
KT=256 K-tile, word ``s`` (0..15), byte ``j`` and 2-bit plane ``p`` hold
the code of logical K row ``p*64 + 4s + j``.  So ``(w >> 2p) & 0x03030303``
yields 4 bytes that are 4 *consecutive* K values — one ``dp4a`` operand,
or one 4-byte slice of an int8 MMA fragment, in the CUDA kernels.

Columns are padded to a multiple of 128 (``LANE``) and K to a multiple of
256 with code 0; the kernels never read padded K rows past ``k`` for
qk256 weights of the main path (K == Kp there).

Kinds (``bitnet_tpu/ops/linear.py:123-140``): ``dense`` (``weight`` [(L,)
K, N] floats, one plain matmul: the F32 / F16 / BF16 / GGML-classic
linears, and every linear of ``mode="dense"``), ``qk256`` (value = LUT[code]
{-2,-1,1,2} times a per-tensor or fused per-column scale), ``bitnet32``
(LUT[code] times a per-32-row block scale) and ``tl`` (TL1/TL2 levels
``code - 2`` times a per-block scale, the blocks of 64 / 128 rows arriving
expanded to 32 rows).  The block kinds keep their scales ``[(L,) Kp/32,
Np]`` f32, zero-padded along K and N.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..errors import QuantizationError
from ..quant.qk256 import extract_codes, row_stride_bytes
from .rmsnorm import rms_norm

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


def repack_codes_torch(codes_kn: torch.Tensor) -> torch.Tensor:
    """Logical codes [K, N] (uint8 in 0..3, any device) → int32 words
    [Kp/16, Np] with K padded to 256 and N to 128 by code 0: the numpy
    :func:`repack_codes` + :func:`fold_packed_words` + column padding, in
    torch on the codes' device."""
    K, N = codes_kn.shape
    Kp, Np = pad_k(K), -(-N // LANE) * LANE
    c = torch.zeros((Kp, Np), dtype=torch.uint8, device=codes_kn.device)
    c[:K, :N] = codes_kn
    t = c.view(Kp // KT_PACK, 4, KT_PACK // 4, Np)     # [tile, plane, byte row, N]
    by = t[:, 0] | (t[:, 1] << 2) | (t[:, 2] << 4) | (t[:, 3] << 6)
    # word s = byte rows 4s..4s+3, little-endian
    w = by.view(Kp // KT_PACK, KT_PACK // 16, 4, Np).permute(0, 1, 3, 2)
    return w.contiguous().view(torch.int32).reshape(Kp // 16, Np)


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
class LinearShard:
    """Where a linear's slice sits on the model axis of a mesh
    (``parallel/sharding.py``): ``kind`` ``"col"`` (this rank holds N/tp
    output columns) or ``"row"`` (K/tp input rows: each rank's output is a
    partial sum); ``group`` the model axis (a ``parallel.comm.Group``);
    ``full`` the whole linear's N (col) or K (row)."""

    kind: str
    group: object
    full: int
    # a row-parallel qk256 slice's unit column scales [L, Np] f32: its
    # kernels' partial products are taken unscaled (``_row_parallel_apply``)
    unit_scales: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TernaryLinear:
    """One linear (or an [L]-stacked set): ``packed`` int32 words
    ``[(L,) Kp/16, Np]``.  ``scales``: for qk256 a per-tensor scalar
    (``[]`` / ``[L]``) or, after fusion, a per-column vector ``[(L,) 1,
    Np]``; for bitnet32 / tl the block scales ``[(L,) Kp/32, Np]`` (f32).
    ``col_scales`` is the form the qk256 kernels read, ``[L, Np]`` f32 (L = 1
    unstacked), attached once by :func:`with_col_scales`.  A ``dense``
    linear holds ``weight`` [(L,) K, N] (the load's ``param_dtype``) and no
    words or scales.  ``shard``, on a mesh, says which slice of the whole
    linear this is (:class:`LinearShard`); ``k`` and ``n`` are the slice's."""

    kind: str
    k: int
    n: int
    packed: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    col_scales: Optional[torch.Tensor] = None
    weight: Optional[torch.Tensor] = None
    shard: Optional[LinearShard] = None

    def to(self, device) -> "TernaryLinear":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, packed=mv(self.packed), scales=mv(self.scales),
            col_scales=mv(self.col_scales), weight=mv(self.weight))

    @property
    def stacked(self) -> bool:
        """Whether the linear carries a leading [L] axis."""
        return (self.weight if self.kind == "dense" else self.packed).ndim == 3


def dense_linear(weight_kn: torch.Tensor) -> TernaryLinear:
    """A dense [K, N] (or [L, K, N]) weight → a ``dense`` linear
    (``bitnet_tpu/ops/linear.py:280-282``)."""
    return TernaryLinear(kind="dense", k=weight_kn.shape[-2], n=weight_kn.shape[-1],
                         weight=weight_kn)


def with_col_scales(lin: TernaryLinear) -> TernaryLinear:
    """Attach the kernels' ``[L, Np]`` f32 per-column scales: a scalar per
    tensor (or per layer) broadcast over the columns, a fused per-column
    vector padded to Np.  Run once at engine init, never per call.  The
    block kinds (bitnet32, tl) keep their ``[(L,) Kp/32, Np]`` scales and
    get none."""
    if lin.kind != "qk256":
        return lin
    L = lin.packed.shape[0] if lin.packed.ndim == 3 else 1
    Np = lin.packed.shape[-1]
    s = lin.scales.to(torch.float32).reshape(L, -1)
    if s.shape[1] == 1:
        s = s.expand(L, Np)
    elif s.shape[1] != Np:
        s = torch.nn.functional.pad(s, (0, Np - s.shape[1]), value=1.0)
    return dataclasses.replace(lin, col_scales=s.contiguous())


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


def _block_linear(kind: str, codes_kn: torch.Tensor,
                  s32: torch.Tensor) -> TernaryLinear:
    """codes [K, N] uint8 + scales [K/32, N] f32 (one device) → a bitnet32 /
    tl linear, scales zero-padded to [Kp/32, Np]."""
    k, n = codes_kn.shape
    packed = repack_codes_torch(codes_kn)
    Kp, Np = packed.shape[0] * 16, packed.shape[1]
    scales = torch.zeros((Kp // 32, Np), dtype=torch.float32, device=s32.device)
    scales[: k // 32, :n] = s32
    return TernaryLinear(kind=kind, k=k, n=n, packed=packed, scales=scales)


def bitnet32_linear_from_codes(codes_kn, scales_blocks_kn) -> TernaryLinear:
    """``codes_kn`` [K, N] (LUT indices); ``scales_blocks_kn`` [K/32, N] f32
    (``bitnet_tpu/ops/linear.py:371-383``).  numpy or torch inputs."""
    codes = torch.as_tensor(np.ascontiguousarray(codes_kn) if isinstance(
        codes_kn, np.ndarray) else codes_kn).to(torch.uint8)
    s = torch.as_tensor(scales_blocks_kn, dtype=torch.float32, device=codes.device)
    if codes.shape[0] % 32 != 0:
        raise QuantizationError(f"bitnet32 needs K % 32 == 0, got {codes.shape[0]}")
    return _block_linear("bitnet32", codes, s)


def tl_linear_from_codes(codes_kn, scales_blocks_kn, block: int) -> TernaryLinear:
    """TL1/TL2 linear (``bitnet_tpu/ops/linear.py:386-404``): ``codes_kn``
    [K, N] unsigned LUT indices (value = code - 2), ``scales_blocks_kn``
    [K/block, N] f32 with ``block`` a multiple of 32, expanded here to the
    kernels' 32-row granularity (exact: a TL block is whole 32-row blocks)."""
    codes = torch.as_tensor(np.ascontiguousarray(codes_kn) if isinstance(
        codes_kn, np.ndarray) else codes_kn).to(torch.uint8)
    s = torch.as_tensor(scales_blocks_kn, dtype=torch.float32, device=codes.device)
    if codes.shape[0] % block != 0:
        raise QuantizationError(f"TL needs K % {block} == 0, got {codes.shape[0]}")
    return _block_linear("tl", codes, torch.repeat_interleave(s, block // 32, dim=0))


def qk256_linear_from_payload(payload: np.ndarray, out_dim: int, in_dim: int,
                              transposed: bool = False) -> TernaryLinear:
    """QK256 GGUF payload → TernaryLinear by the numpy route on the host
    (extract, transpose, repack, fold; GGUF stores ``[out, in]``,
    ``transposed`` = stored ``[in, out]``): the plain version that
    :func:`qk256_linear_from_payload_torch` is held to bit for bit.  No
    load calls it: it took a whole 2B qk256 GGUF 12.80 and 16.25 s on the
    H100 machine's host (``chip_smoke.py``'s checkpoints phase)."""
    if transposed:
        codes_kn = extract_codes(payload, in_dim, out_dim)
    else:
        codes_kn = extract_codes(payload, out_dim, in_dim).T
    return qk256_linear_from_codes(codes_kn)


def qk256_codes_torch(payload: np.ndarray, rows: int, cols: int,
                      device) -> torch.Tensor:
    """A QK256 payload stored [rows, cols] → its uint8 codes [rows, cols]
    on ``device``: the payload's bytes copied there once, then unpacked in
    torch (4 a byte, LSB first, rows ``row_stride_bytes(cols)`` apart)."""
    stride = row_stride_bytes(cols)
    raw = np.ascontiguousarray(payload, dtype=np.uint8).reshape(-1)
    if raw.size < rows * stride:
        raise QuantizationError(f"QK256 payload too small: {raw.size} < "
                                f"{rows * stride} bytes for [{rows}, {cols}]")
    b = torch.from_numpy(raw[: rows * stride].copy()).to(device).view(rows, stride)
    codes = torch.stack([(b >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    return codes.view(rows, stride * 4)[:, :cols]


def qk256_linear_from_payload_torch(payload: np.ndarray, out_dim: int, in_dim: int,
                                    transposed: bool = False,
                                    device="cuda") -> TernaryLinear:
    """QK256 GGUF payload → TernaryLinear on ``device`` (the card unless the
    caller asks for ``"cpu"``): the function of the JAX package's native
    codec (``bitnet_tpu/native/__init__.py:231``
    ``qk256_payload_to_tpu_words``, called by its loader at
    ``bitnet_tpu/models/loader.py:222-233``) in torch on the load's
    device.  The bytes go to the device once, the codes are unpacked there
    (:func:`qk256_codes_torch`), transposed to [K, N] unless the tensor is
    stored [in, out], and packed by :func:`repack_codes_torch`.  The words
    and their padding equal :func:`qk256_linear_from_payload`'s bit for
    bit; the peak is one tensor's temporaries."""
    from ..device_probe import resolve_device

    dev = resolve_device(device)
    rows, cols = (in_dim, out_dim) if transposed else (out_dim, in_dim)
    codes = qk256_codes_torch(payload, rows, cols, dev)
    packed = repack_codes_torch(codes if transposed else codes.t())
    return TernaryLinear(kind="qk256", k=in_dim, n=out_dim, packed=packed,
                         scales=torch.tensor(1.0, dtype=torch.float32, device=dev))


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


BLOCK_KINDS = ("bitnet32", "tl")


def dequantize_weight(lin: TernaryLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [K, N] weight of an unstacked linear
    (``bitnet_tpu/ops/linear.py:173-196``), computed in f32 and cast; a
    dense linear's weight cast."""
    if lin.kind == "dense":
        return lin.weight.to(dtype)
    codes = unpack_packed(lin.packed)[: lin.k, : lin.n]
    if lin.kind in BLOCK_KINDS:
        # tl: value = code - 2 (tl1.rs:49-82); bitnet32: the LUT
        vals = ((codes.to(torch.int32) - 2).to(torch.float32) if lin.kind == "tl"
                else codes_to_values(codes))
        s = torch.repeat_interleave(lin.scales.to(torch.float32), 32, dim=0)
        return (vals * s[: lin.k, : lin.n]).to(dtype)
    if lin.kind != "qk256":
        raise QuantizationError(f"unknown TernaryLinear kind {lin.kind!r}")
    vals = codes_to_values(codes)
    s = lin.scales.to(torch.float32)
    if s.ndim >= 2:                     # fused per-column vector [1, Np]
        s = s[..., :, : lin.n]
    return (vals * s).to(dtype)


def concat_linears(lins: list[TernaryLinear]) -> TernaryLinear:
    """Concatenate linears along N (q|k|v, gate|up).  qk256 scalar
    per-tensor scales become a per-column vector ``[..., 1, Ntot]``; block
    scales concatenate along N; dense weights concatenate along N at any
    width (``bitnet_tpu/ops/linear.py:265-300``)."""
    kinds = {l.kind for l in lins}
    if len(kinds) != 1 or not kinds <= {"dense", "qk256", *BLOCK_KINDS}:
        raise QuantizationError(f"cannot fuse kinds {kinds}")
    if kinds == {"dense"}:
        return dense_linear(torch.cat([l.weight for l in lins], dim=-1))
    if any(l.n % LANE != 0 for l in lins):
        raise QuantizationError(
            f"fusion needs 128-aligned widths, got {[l.n for l in lins]}")
    if len({l.k for l in lins}) != 1:
        raise QuantizationError("fusion needs equal K")
    packed = torch.cat([l.packed for l in lins], dim=-1)
    kind = lins[0].kind
    if kind in BLOCK_KINDS:          # per-K-block scales concat along N
        return TernaryLinear(kind=kind, k=lins[0].k, n=sum(l.n for l in lins),
                             packed=packed,
                             scales=torch.cat([l.scales for l in lins], dim=-1))
    cols = []
    for l in lins:
        s = l.scales.to(torch.float32)
        cols.append(s.reshape(*s.shape, 1, 1).expand(*s.shape, 1, l.n))
    return TernaryLinear(kind="qk256", k=lins[0].k,
                         n=sum(l.n for l in lins), packed=packed,
                         scales=torch.cat(cols, dim=-1).contiguous())


def linear_apply(lin: TernaryLinear, x: torch.Tensor, path: str = "xla",
                 layer: int = 0) -> torch.Tensor:
    """``y = x @ W`` for [..., K] activations (``bitnet_tpu/ops/linear.py:199``).

    ``lin`` may be [L]-stacked, then ``layer`` picks its row.  ``path``:
    ``'xla'`` dequantizes the weight and runs one plain matmul (f32
    accumulation, result in x's dtype); ``'pallas'`` / ``'w2a8'`` go to the
    kernels (K6 / K4, or K1 at decode rows)."""
    return linear_apply_normed(lin, x, None, path=path, layer=layer)


def linear_apply_normed(lin: TernaryLinear, x: torch.Tensor,
                        gamma: torch.Tensor | None = None, eps: float = 1e-5,
                        path: str = "xla", glu: bool = False,
                        resid: torch.Tensor | None = None,
                        layer: int = 0) -> torch.Tensor:
    """``[resid +] rms_norm(glu(x), gamma) @ W`` (``bitnet_tpu/ops/linear.py:227``),
    with the branch rule of the JAX kernels' dispatcher
    (``bitnet_tpu/ops/ternary_matmul.py:1266-1326``).

    ``lin``: a dense, qk256, bitnet32 or tl linear, stacked (row
    ``layer``) or unstacked; ``x`` [..., K] (``[..., 2K]`` with ``glu``);
    ``gamma`` the RMSNorm weight (``[L, K]`` for a stack, ``[K]``
    unstacked) or None; ``resid`` [..., N].  Returns [..., N] in x's dtype.

    - dense, on every path: SwiGLU, the norm and the residual in torch and
      one plain matmul, f32 accumulation, cast back to x's dtype (JAX
      ``jnp.matmul(x, w.astype(x.dtype), preferred_element_type=f32)``,
      ``:215-218``): on the card a bf16 x meets the bf16 weight in one
      cuBLAS GEMM that writes f32 (``torch.mm(out_dtype=)``), elsewhere
      both are widened to f32 (exact products of bf16 values, f32 sums);
    - qk256 on ``w2a8`` with M ≤ 64 rows and K == Kp: K1, with the norm,
      SwiGLU and residual fused (the ``w2a8_normed`` site ``:1073``);
    - otherwise SwiGLU and the norm run in plain torch, then the path picks
      the matmul: ``xla`` a dequantized weight and a plain matmul; for
      qk256 ``w2a8`` per-row int8 quantization in torch (``:1098-1110``)
      and K4 (on x zero-padded to Kp), ``pallas`` K6 (on x as it is); for bitnet32 /
      tl K10 on ``w2a8`` and ``pallas`` alike (the block-scale bf16 body,
      ``:1098``, ``:1152-1173``); the residual is added in torch
      (``:1324-1325``)."""
    from . import ternary_matmul as tm

    if path not in ("xla", "w2a8", "pallas"):
        raise ValueError(f"bad kernel path {path!r}")
    if lin.shard is not None and lin.shard.kind == "row":
        return _row_parallel_apply(lin, x, gamma, eps, path, glu, resid, layer)
    block = lin.kind in BLOCK_KINDS
    if lin.kind == "dense":
        return _dense_apply(lin, x, gamma, eps, glu, resid, layer)
    if lin.kind != "qk256" and not block:
        raise QuantizationError(f"unknown TernaryLinear kind {lin.kind!r}")
    if path != "xla" and not block and lin.col_scales is None:
        raise ValueError("the kernels read col_scales: with_col_scales(lin) first")
    stacked = lin.packed.ndim == 3
    packed = lin.packed if stacked else lin.packed[None]
    l = layer if stacked else 0
    lead = x.shape[:-1]
    K = x.shape[-1] // 2 if glu else x.shape[-1]
    Kp = packed.shape[1] * 16
    x2 = x.reshape(-1, x.shape[-1])
    r2 = None if resid is None else resid.reshape(-1, lin.n)
    if (path == "w2a8" and not block and x2.shape[0] <= tm.STACKED_DECODE_MAX_M
            and K == Kp):
        g = gamma if gamma is None or stacked else gamma[None]
        y = tm.ternary_matmul_w2a8_normed(
            l, x2, packed, lin.col_scales, g, k_dim=lin.k, n_dim=lin.n,
            eps=eps, glu=glu, resid=r2)
        return y.reshape(*lead, lin.n)
    if glu:
        gate = x2[:, :K]
        x2 = gate * torch.sigmoid(gate) * x2[:, K:]
    if gamma is not None:
        x2 = rms_norm(x2, gamma[l] if stacked else gamma, eps)
    if path == "xla":
        w = dequantize_weight(dataclasses.replace(
            lin, packed=packed[l], scales=lin.scales[l] if stacked else lin.scales),
            x2.dtype)
        y = torch.matmul(x2.to(torch.float32), w.to(torch.float32)).to(x2.dtype)
    elif block:
        y = tm.ternary_matmul_blockscale_bf16(
            l, x2.contiguous(), packed, lin.scales if stacked else lin.scales[None],
            k_dim=lin.k, n_dim=lin.n, lut_bias=lin.kind == "bitnet32")
    elif path == "w2a8":
        if K != Kp:               # padded K rows hold code 0
            x2 = torch.nn.functional.pad(x2, (0, Kp - K))
        y = tm.ternary_matmul_w2a8(l, x2.contiguous(), packed, lin.col_scales,
                                   k_dim=Kp, n_dim=lin.n)
    else:                         # K6 pads and rounds x itself
        y = tm.ternary_matmul_bf16(l, x2.contiguous(), packed, lin.col_scales,
                                   k_dim=lin.k, n_dim=lin.n)
    if r2 is not None:
        y = y + r2
    return y.reshape(*lead, lin.n)


def dense_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] with f32 accumulation, in x's dtype: the weight
    cast to x's dtype first, as ``jnp.matmul(x, w.astype(x.dtype),
    preferred_element_type=f32)`` computes it."""
    w = w.to(x2.dtype)
    if x2.dtype == torch.float32:
        return torch.matmul(x2, w)
    if x2.is_cuda:
        return torch.mm(x2, w, out_dtype=torch.float32).to(x2.dtype)
    return torch.matmul(x2.to(torch.float32), w.to(torch.float32)).to(x2.dtype)


def _dense_apply(lin: TernaryLinear, x: torch.Tensor, gamma, eps: float,
                 glu: bool, resid, layer: int) -> torch.Tensor:
    """The dense branch of :func:`linear_apply_normed`
    (``bitnet_tpu/ops/linear.py:227-262`` on a dense linear)."""
    stacked = lin.weight.ndim == 3
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if glu:
        K = x2.shape[-1] // 2
        gate = x2[:, :K]
        x2 = gate * torch.sigmoid(gate) * x2[:, K:]
    if gamma is not None:
        x2 = rms_norm(x2, gamma[layer] if stacked else gamma, eps)
    y = dense_matmul(x2, lin.weight[layer] if stacked else lin.weight)
    if resid is not None:
        y = y + resid.reshape(-1, lin.n)
    return y.reshape(*lead, lin.n)


def _row_parallel_apply(lin: TernaryLinear, x: torch.Tensor, gamma, eps: float,
                        path: str, glu: bool, resid, layer: int) -> torch.Tensor:
    """:func:`linear_apply_normed` on a row-parallel slice (K/tp of each
    row, ``parallel/sharding.py``), computing what the whole linear
    computes.

    The norm and the int8 scale are the whole row's: each row's sum of
    squares is all-reduced over the model axis first, then the absmax of
    its normed values, and K1 / K4 (``w2a8`` qk256, the path that
    quantizes) take both in their row-statistics mode, so the slice's int8
    codes are the whole row's.  Their products are summed exactly: the
    kernels run with unit column scales, so a rank's output is ``fl(d·sx)``
    for its integer partial ``d = acc − 2·sumq`` (|d| ≤ 254·K < 2^23), from
    which ``d`` is recovered exactly; the partials are all-reduced, and the
    kernels' epilogue ``(d·sx)·s[n]`` runs on the sum, the residual added as
    the unsharded route adds it (K1: in f32 before its one rounding; K4:
    after the product's rounding to x's dtype).  With a norm the reduced sum
    of squares is summed in another order than the whole row's, so the
    codes can differ at a rounding boundary.  Other paths norm the slice in
    torch as ``rms_norm`` does and sum their f32 partial outputs."""
    from . import ternary_matmul as tm

    if glu:
        raise ValueError("a row-parallel linear takes no SwiGLU input "
                         "(a mesh needs unfused projections)")
    grp, k_full = lin.shard.group, lin.shard.full
    stacked = lin.stacked
    l = layer if stacked else 0
    gam = None if gamma is None else (gamma[layer] if stacked else gamma)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    r2 = None if resid is None else resid.reshape(-1, lin.n)
    ss = None
    if gam is not None:
        ss = (xf * xf).sum(dim=1)
        grp.all_reduce(ss, "sum")
    quant = path == "w2a8" and lin.kind == "qk256"
    k1 = quant and xf.shape[0] <= tm.STACKED_DECODE_MAX_M
    if gam is None:
        xn = xf
    elif k1:          # as K1 norms: (x · r) · γ, r = 1 / sqrt(mean + eps)
        xn = (xf * tm.norm_factor(ss, k_full, eps)[:, None]) * gam.to(torch.float32)[None]
    else:             # as rms_norm does: x · rsqrt(mean + eps) · γ
        var = ss / ss.new_full((), float(k_full))
        xn = (xf * torch.rsqrt(var + eps)[:, None]) * gam.to(torch.float32)[None]
    if not quant:
        xin = xn.to(x.dtype)
        if path != "xla" and lin.kind != "dense":
            xin = xin.to(torch.float32)       # the kernels round x as they read it
        y = linear_apply_normed(dataclasses.replace(lin, shard=None), xin, None, eps,
                                path, layer=layer).to(torch.float32)
        y = grp.all_reduce(y, "sum").to(x.dtype)
        return (y if r2 is None else y + r2).reshape(*lead, lin.n)
    packed = lin.packed if stacked else lin.packed[None]
    # K4 quantizes the normed rows as rms_norm rounds them (x's dtype)
    xq_in = xn if k1 else xn.to(x.dtype).to(torch.float32)
    amax = grp.all_reduce(xq_in.abs().amax(dim=1), "max")
    stats = torch.stack([ss if ss is not None else torch.zeros_like(amax), amax],
                        dim=1).contiguous()
    unit = lin.shard.unit_scales
    if k1:
        g = gamma if gamma is None or stacked else gamma[None]
        yr = tm.ternary_matmul_w2a8_normed(l, xf.contiguous(), packed, unit, g, k_dim=lin.k,
                                           n_dim=lin.n, eps=eps, stats=stats,
                                           k_full=k_full)
    else:
        yr = tm.ternary_matmul_w2a8(l, xq_in.contiguous(), packed, unit, k_dim=lin.k,
                                    n_dim=lin.n, stats=stats)
    sx = torch.clamp(amax, min=1e-8) / amax.new_full((), 127.0)    # the kernels' scale
    d = torch.round(yr.to(torch.float64) / sx.to(torch.float64)[:, None])
    d = grp.all_reduce(d, "sum").to(torch.float32)                   # exact integers
    y = (d * sx[:, None]) * lin.col_scales[l, :lin.n][None]
    if k1:
        y = y if r2 is None else y + r2.to(torch.float32)
        return y.to(x.dtype).reshape(*lead, lin.n)
    y = y.to(x.dtype)
    return (y if r2 is None else y + r2).reshape(*lead, lin.n)
