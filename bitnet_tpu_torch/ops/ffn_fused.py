"""The fused W2A8 FFN: the CUDA kernel K24 and its plain version.

K24 :func:`ffn_w2a8_fused` replaces ``ffn_w2a8_fused``
(``bitnet_tpu/ops/ffn_fused.py:106``, ``pallas_call`` ``:148``, body
``_ffn_kernel`` ``:34``): ``y = down(requant(silu(x @ Wg) * (x @ Wu)))`` over
the fused gate|up words and the down words, for at most 32 rows, with the
SiLU·up activation re-quantized to int8 per token and per F-tile of width
``_pick_bf(F)`` (a finer grid than the unfused path's per-row quantization,
so its results differ from K1's at the int8-noise level: another function).
No residual; the caller adds it.

The wrapper takes the whole ``[L, Kp/16, 2F]`` / ``[L, F/16, Hp]`` stacks,
their ``[L, 2F]`` / ``[L, Hp]`` column scales (``TernaryLinear.col_scales``)
and a layer index, as the other W2A8 wrappers do.  It launches the kernel
for CUDA tensors (counting it in ``ffn_w2a8_fused.launches``) and runs the
plain version for CPU tensors, never the plain version on a CUDA tensor.

On the card a call is four launches (``csrc/ffn_fused.cu``) and no other
PyTorch op than ``torch.empty``: x's row quantization (x read unpadded, in
its own dtype), the gate|up GEMM with the SiLU·up epilogue, the per-tile
requantization, the down GEMM.  Both GEMMs are K4's wgmma design with every
row in one block (M ≤ 32), so each word is read once a call; the tiles come
from :func:`ffn_plan`.  What bounds it is the 44 MB of words at the 8B
shapes (0.0131 ms at 3.35 TB/s), then the latency of four dependent
launches.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ternary_matmul import _DTYPE_CODE, _sm_count, biased_codes, int8_matmul, quantize_rows

KT = 256
# the JAX wrapper's row cap (``ffn_fused_supported``)
FFN_FUSED_MAX_M = 32


def _pick_bf(F: int) -> int:
    """Largest 256-multiple divisor of F giving ≥4 grid steps (DMA
    pipelining), else the largest divisor at all (``:87-94``).  Here it
    is no tuning: the requantization groups are this wide."""
    cands = [d for d in range(KT, F + 1, KT) if F % d == 0]
    for d in reversed(cands):
        if F // d >= 4:
            return d
    return cands[0] if cands else 0


def ffn_fused_supported(gateup, down, F: int, M: int) -> bool:
    """``ffn_fused_supported`` (``:97-101``) on the port's linears (stacked
    or not): qk256 gate|up and down, F a multiple of 256 that the down
    projection's K fills exactly, at most 32 rows."""
    return (gateup is not None and gateup.kind == "qk256"
            and down.kind == "qk256" and F % KT == 0
            and down.packed.shape[-2] * 16 == -(-F // KT) * KT
            and M <= FFN_FUSED_MAX_M and _pick_bf(F) > 0)


def gateup_act(xq, sx, sumq, gu_words, gu_scale, f_dim):
    """SiLU(gate)·up in f32 [M, F] from the int8 rows of x: the int32 dots
    over all of K, ``((acc − 2·sumq)·sx)·s``, then ``(g·sigmoid(g))·u``."""
    acc = int8_matmul(xq, biased_codes(gu_words))            # [M, 2F] exact
    y = (acc - 2 * sumq[:, None]).to(torch.float32) * sx[:, None] * gu_scale[None, :]
    g, u = y[:, :f_dim], y[:, f_dim:]
    return g * torch.sigmoid(g) * u


def requant_tiles(act, bf):
    """Each row's F-tiles of width ``bf`` to int8 with their own absmax
    scales: aq [M, F] int8, sa [M, n_f] f32, sq2 [M, n_f] int32."""
    tiles = [quantize_rows(act[:, f:f + bf]) for f in range(0, act.shape[1], bf)]
    return (torch.cat([t[0] for t in tiles], dim=1),
            torch.stack([t[1] for t in tiles], dim=1),
            torch.stack([t[2] for t in tiles], dim=1))


def down_from_tiles(aq, sa, sq2, d_words, d_scale, bf):
    """The down projection of the requantized tiles, f32 [M, Hp]: for each
    tile in order, ``acc += ((dot − 2·sq2)·sa)·sd`` from zero."""
    codes_d = biased_codes(d_words)                          # [F, Hp]
    out = torch.zeros((aq.shape[0], d_words.shape[1]), dtype=torch.float32,
                      device=aq.device)
    for i, f in enumerate(range(0, aq.shape[1], bf)):
        dot = int8_matmul(aq[:, f:f + bf].contiguous(), codes_d[f:f + bf])
        out += ((dot - 2 * sq2[:, i:i + 1]).to(torch.float32) * sa[:, i:i + 1]
                * d_scale[None, :])
    return out


def ffn_w2a8_fused_plain(x: torch.Tensor, gu_words: torch.Tensor,
                         gu_scale: torch.Tensor, d_words: torch.Tensor,
                         d_scale: torch.Tensor, f_dim: int, n_dim: int,
                         parts: bool = False):
    """K24 on one layer: x [M, K] bf16/f32; gu_words [Kp/16, 2F]; gu_scale
    [2F] f32; d_words [F/16, Hp]; d_scale [Hp] f32.  The Pallas kernel's
    arithmetic and order (:func:`gateup_act`, :func:`requant_tiles`,
    :func:`down_from_tiles`).  Returns [M, n_dim] in x's dtype; with
    ``parts`` also (xq, sx, sumq, act, aq, sa, sq2) for a check of the
    kernel's integer parts."""
    Kp = gu_words.shape[0] * 16
    bf = _pick_bf(f_dim)
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, Kp - x.shape[1]))
    xq, sx, sumq = quantize_rows(xf)
    act = gateup_act(xq, sx, sumq, gu_words, gu_scale, f_dim)
    aq, sa, sq2 = requant_tiles(act, bf)
    y = down_from_tiles(aq, sa, sq2, d_words, d_scale, bf)[:, :n_dim].to(x.dtype)
    return (y, xq, sx, sumq, act, aq, sa, sq2) if parts else y


# K24's tiles.  Both GEMMs take every row in one block: BT is the smallest of
# ``FFN_GEMM_ROWS`` that holds M.  The gate|up GEMM's blocks own 64 gate
# columns and their up columns; K is split over a cluster of 2, 4 or 8 while
# the blocks, doubled, still fit the card's SMs and each block keeps at least
# two 256-row K tiles (K4's rule).  The down GEMM's blocks own 128 output
# columns; its cluster holds the requantization tiles: n_f ranks (a tile
# each) up to 8, doubled while the blocks fit the SMs and each rank keeps two
# K tiles; past 8 tiles, 8 ranks of ceil(n_f / 8) or fewer tiles each; a
# count of tiles that is no power of two, the largest power of two below it.
FFN_GEMM_ROWS = (8, 16, 32)
FFN_MAX_SPLIT = 8


def ffn_plan(M: int, Kp: int, F: int, Hp: int, sms: int) -> tuple[int, int, int]:
    """(BT, gate|up split, down cluster) of K24 for M rows, x's Kp, F and Hp
    on ``sms`` SMs."""
    bt = next(b for b in FFN_GEMM_ROWS if b >= M)
    blocks, split = F // 64, 1
    while (split < FFN_MAX_SPLIT and 2 * split * blocks <= sms
           and 4 * split <= Kp // KT):
        split *= 2
    nf, nb = F // _pick_bf(F), _pick_bf(F) // KT
    dsplit = 1 << (min(nf, FFN_MAX_SPLIT).bit_length() - 1)
    cols = -(-Hp // 128)
    if dsplit == nf:
        while (2 * dsplit <= FFN_MAX_SPLIT and 2 * dsplit * cols <= sms
               and 4 * (dsplit // nf) <= nb):
            dsplit *= 2
    return bt, split, dsplit


def ffn_w2a8_fused(l: int, x: torch.Tensor, gu_packed: torch.Tensor,
                   gu_scales: torch.Tensor, d_packed: torch.Tensor,
                   d_scales: torch.Tensor, f_dim: int, n_dim: int) -> torch.Tensor:
    """K24: the fused FFN of layer ``l`` for x [M ≤ 32, K] (bf16/f32, the
    post-``ffn_norm`` activations); gu_packed [L, Kp/16, 2F], gu_scales
    [L, 2F] f32; d_packed [L, F/16, Hp], d_scales [L, Hp] f32 (a per-layer
    scalar broadcast over the columns, as ``with_col_scales`` makes it).
    Returns [M, n_dim] in x's dtype, without the residual."""
    if gu_packed.dtype != torch.int32 or gu_packed.ndim != 3 or d_packed.ndim != 3:
        raise ValueError("gu_packed / d_packed must be int32 [L, rows, N] stacks")
    L, R, N2 = gu_packed.shape
    Kp, F, Hp = R * 16, f_dim, d_packed.shape[2]
    M, K = x.shape if x.ndim == 2 else (0, 0)
    if x.ndim != 2 or not 0 < K <= Kp:
        raise ValueError(f"x must be [M, K <= {Kp}], got {tuple(x.shape)}")
    if not 1 <= M <= FFN_FUSED_MAX_M:
        raise ValueError(f"K24 takes 1..{FFN_FUSED_MAX_M} rows, got {M}")
    if N2 != 2 * F or F % KT or d_packed.shape[:2] != (L, F // 16):
        raise ValueError(f"gate|up must be [L, Kp/16, {2 * F}] and down "
                         f"[L, {F // 16}, Hp], got {tuple(gu_packed.shape)} and "
                         f"{tuple(d_packed.shape)}")
    if not 0 <= l < L:
        raise IndexError(f"layer {l} out of range [0, {L})")
    if (tuple(gu_scales.shape) != (L, 2 * F) or tuple(d_scales.shape) != (L, Hp)
            or gu_scales.dtype != torch.float32 or d_scales.dtype != torch.float32):
        raise ValueError(f"scales must be f32 [{L}, {2 * F}] and [{L}, {Hp}]")
    if n_dim > Hp or Hp % 64:
        raise ValueError(f"need n_dim <= Hp and Hp % 64 == 0, got {n_dim}, {Hp}")
    if x.device.type == "cpu":
        return ffn_w2a8_fused_plain(x, gu_packed[l], gu_scales[l], d_packed[l],
                                    d_scales[l], F, n_dim)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K24 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    if x.stride(1) != 1:
        raise ValueError("K24 takes rows of x that are each contiguous")
    tensors = (gu_packed, gu_scales, d_packed, d_scales)
    if any(t.get_device() != x.get_device() or not t.is_contiguous() for t in tensors):
        raise ValueError("K24 operands must be contiguous on x's device")
    out = _ffn_launch(l, x, gu_packed, gu_scales, d_packed, d_scales, F, n_dim)[0]
    ffn_w2a8_fused.launches += 1
    return out


def _scratch_layout(M, Kp, F, nf):
    """K24's scratch, one allocation: (offsets, total bytes) of xq int8
    [M, Kp] | aq int8 [M, F] | act f32 [M, F] | sx f32 [M] | sumq int32 [M]
    | sa f32 [M, nf] | sq2 int32 [M, nf], each 128-byte aligned (TMA reads
    xq and aq)."""
    offs, total = [], 0
    for n in (M * Kp, M * F, 4 * M * F, 4 * M, 4 * M, 4 * M * nf, 4 * M * nf):
        offs.append(total)
        total += -(-n // 128) * 128
    return offs, total


def _ffn_launch(l, x, gu_packed, gu_scales, d_packed, d_scales, F, n_dim):
    """Launch K24 on checked operands (x [M, K ≤ Kp] in its own dtype, rows
    each contiguous), tiled by :func:`ffn_plan`; layer ``l`` by pointer
    offset, no other PyTorch op than ``torch.empty``.  Returns (out,
    scratch)."""
    M = x.shape[0]
    Kp, Hp = gu_packed.shape[1] * 16, d_packed.shape[2]
    bf = _pick_bf(F)
    dev = x.device
    bt, split, dsplit = ffn_plan(M, Kp, F, Hp, _sm_count(dev.index))
    offs, total = _scratch_layout(M, Kp, F, F // bf)
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    scratch = torch.empty(total, dtype=torch.int8, device=dev)
    p = [scratch.data_ptr() + o for o in offs]
    lib = _cuda.library("ffn_fused")
    rc = lib.bn_ffn_w2a8(
        x.data_ptr(), x.stride(0), M, x.shape[1], Kp,
        gu_packed.data_ptr() + 4 * l * gu_packed.stride(0), F,
        gu_scales.data_ptr() + 4 * l * 2 * F,
        d_packed.data_ptr() + 4 * l * d_packed.stride(0), Hp,
        d_scales.data_ptr() + 4 * l * Hp, out.data_ptr(), n_dim, bf, bt, split, dsplit,
        p[0], p[3], p[4], p[2], p[1], p[5], p[6], _DTYPE_CODE[x.dtype],
        _cuda.stream_ptr(dev))
    _cuda.check(lib, "ffn_fused", rc, "ffn_w2a8_fused")
    return out, scratch


def _ffn_cuda(l, x, gu_packed, gu_scales, d_packed, d_scales, F, n_dim):
    """K24 with its parts: (out, (xq, sx, sumq, act, aq, sa, sq2)), the int8
    rows of x, their scales and sums, the f32 activation, and the
    requantized tiles with their scales and sums, as views of the scratch,
    so a check can hold them against the plain version's.  Counts no
    launch."""
    out, scratch = _ffn_launch(l, x, gu_packed, gu_scales, d_packed, d_scales, F,
                               n_dim)
    M, Kp, nf = x.shape[0], gu_packed.shape[1] * 16, F // _pick_bf(F)
    offs, _ = _scratch_layout(M, Kp, F, nf)

    def view(i, dtype, shape):
        n = shape[0] * (shape[1] if len(shape) > 1 else 1) * dtype.itemsize
        return scratch[offs[i]:offs[i] + n].view(dtype).view(shape)
    return out, (view(0, torch.int8, (M, Kp)), view(3, torch.float32, (M,)),
                 view(4, torch.int32, (M,)), view(2, torch.float32, (M, F)),
                 view(1, torch.int8, (M, F)), view(5, torch.float32, (M, nf)),
                 view(6, torch.int32, (M, nf)))


ffn_w2a8_fused.launches = 0
