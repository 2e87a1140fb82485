"""Ternary matmuls: the CUDA kernels K1, K4 and K6, their plain versions,
and the dispatcher of the generic path.

K1 :func:`ternary_matmul_w2a8_normed` replaces ``ternary_matmul_stacked``
(``bitnet_tpu/ops/ternary_matmul.py:316``): decode shapes, M = B ≤ 64, with
the optional SwiGLU / RMSNorm / int8-quantize preamble and residual
epilogue fused around the integer dot.  At M ≤ ``W2A8_DECODE_MAX_M`` it is
one launch, tiled by :func:`w2a8_decode_plan`; more rows take K4's row
kernel (with SwiGLU and the norm) and K4's GEMM with the residual in its
epilogue, tiled by :func:`w2a8_gemm_plan`.

K4 :func:`ternary_matmul_w2a8` replaces ``ternary_matmul_stacked_prefill``
(``:417``): the prefill GEMM on Hopper's wgmma, after a kernel that
quantizes the rows with the arithmetic the JAX package runs in XLA
(``:441-445``); its plain version quantizes in plain PyTorch.

K6 :func:`ternary_matmul_bf16` replaces the ``_qk256_kernel`` body of
``_ternary_matmul_2d`` (``:112-135``, launched at ``:1177``): bf16
activations times the biased codes with f32 accumulation, minus ``2·Σx``,
times one scale a column, the ``--kernel-path pallas`` route.  It is the
column-scale mode of K10's two forms (below): decode rows (M ≤
``BF16_DECODE_MAX_M``) take the decode form, more rows a row kernel (the
whole-row sums, and bf16 rows where the GEMM cannot read x itself), then
the wgmma GEMM.

The per-32-row block-scale kernels of the bitnet32 / TL weights
(``lut_bias`` picks the bitnet32 LUT {-2,-1,1,2} or the TL levels
{-2,-1,0,1}; both have zero point 2):

K10 :func:`ternary_matmul_blockscale_bf16` replaces the ``_bitnet32_kernel``
body of ``_ternary_matmul_2d`` (``:1152-1177``) and its stacked twin
``ternary_matmul_stacked_tl`` (``:555``): bf16 activations times the
*biased* scaled weights ``bf16(v·s)``, f32 accumulation, minus the
correction ``2·(sum32 @ s)``.  Decode rows (M ≤ ``BLOCKSCALE_DECODE_MAX_M``)
take its decode form, one launch that rounds x to bf16 and computes the
correction itself; more rows take its GEMM form, two launches: a row kernel
(x rounded to bf16 and zero-padded to Kp, and its 32-row sums: what XLA
forms at ``:533-538`` and ``:1159-1166``), then the wgmma GEMM, which
subtracts the correction itself, tiled by :func:`blockscale_gemm_plan`.

K11 :func:`ternary_matmul_tl_w2a8_normed` replaces
``ternary_matmul_stacked_tl_w2a8`` (``:960``): K1's preamble and int8 rows,
then ``y = sx·Σ_b s[b,n]·(Σ_{k∈b} q·v − 2·Σ_{k∈b} q)`` with exact int32
block partials, plus the residual; decode rows M ≤ 2.  It is K1's decode
kernel in its block-scale mode (``csrc/ternary_matmul.cu``): one launch at
every K up to ``W2A8_DECODE_MAX_K``, tiled by the same
:func:`w2a8_decode_plan`.

K12 :func:`ternary_matmul_tl_bf16_normed` replaces
``ternary_matmul_stacked_tl_fused`` (``:733``): the same preamble ending in
bf16 rows, times the *unbiased* weights ``bf16((v−2)·s)``, f32
accumulation, plus the residual; pools of M = 3…64.  Its GEMM is K10's,
unbiased, with the residual in its epilogue.

All take the whole ``[L, Kp/16, Np]`` stack and a Python layer
index, as the JAX stacked wrappers do; on a GPU ``packed[l]`` is a view,
so the layer slice costs nothing.  An unstacked ``[Kp/16, Np]`` weight is
the stack of one layer.  Each wrapper launches its CUDA kernel for CUDA
tensors (counting the launch in ``<wrapper>.launches``) and runs the plain
version for CPU tensors — never the plain version on a CUDA tensor.

:func:`ternary_matmul_pallas` is the counterpart of the JAX dispatcher
(``:1266-1326``) with its branch rule: K1 for normed decode rows, else
the SwiGLU / RMSNorm in plain torch, then K4 (W2A8) or K6 (bf16).  The
wrappers read the ``[L, Np]`` column scales that
:func:`~.linear.with_col_scales` attaches at engine init.
"""

from __future__ import annotations

import functools

import torch

from ..errors import KernelError, QuantizationError
from . import _cuda
from .linear import TernaryLinear, linear_apply_normed, unpack_packed

# The one M cap of the decode-shaped W2A8 kernel, the default of the JAX
# package's ``stacked_decode_max_m()`` (``ops/ternary_matmul.py:52``; there
# an environment override trades it against the TPU's VMEM, a limit the
# CUDA kernel does not have).  The model's stacked-decode gate and K1's
# wrapper both read it.
STACKED_DECODE_MAX_M = 64


# --------------------------------------------------------------------------
# plain PyTorch versions (the tests' reference; CPU tensors only on the path)
# --------------------------------------------------------------------------
def norm_factor(ss: torch.Tensor, k_full: int, eps: float) -> torch.Tensor:
    """Each row's RMSNorm factor ``1 / sqrt(ss / K + eps)`` from its sum of
    squares over K values, as the kernels compute it (IEEE division and
    square root; the divisors are tensors, see :func:`quantize_rows`)."""
    var = ss / ss.new_full((), float(k_full))
    return ss.new_full((), 1.0) / torch.sqrt(var + eps)


def w2a8_preamble_plain(x: torch.Tensor, gamma: torch.Tensor | None,
                        eps: float, glu: bool, stats: torch.Tensor | None = None,
                        k_full: int | None = None) -> torch.Tensor:
    """K1's preamble before quantization: optional silu(gate)·up, optional
    RMSNorm; f32 [M, K].  ``stats`` [M, 2] (the row-statistics mode): the
    norm takes each row's sum of squares over ``k_full`` values from
    ``stats[:, 0]`` (the kernels' ``(x·r)·γ``, ``r`` from :func:`norm_factor`)."""
    xf = x.to(torch.float32)
    if glu:
        K = xf.shape[1] // 2
        gate = xf[:, :K]
        xf = gate * torch.sigmoid(gate) * xf[:, K:]
    if gamma is not None and stats is not None:
        r = norm_factor(stats[:, 0], k_full, eps)
        return (xf * r[:, None]) * gamma.to(torch.float32)[None, :]
    if gamma is not None:
        var = torch.mean(xf * xf, dim=1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps)
        xf = xf * gamma.to(torch.float32)[None, :]
    return xf


def quantize_rows(xf: torch.Tensor, absmax: torch.Tensor | None = None):
    """Per-row absmax int8: ``sx = max(absmax, 1e-8)/127``,
    ``q = clip(round(x/sx), ±127)``; returns (q int8, sx f32 [M], sumq
    int32 [M]).  ``absmax`` [M], where given, is each row's (the whole
    row's, for a row-parallel slice) instead of ``xf``'s own."""
    if absmax is None:
        absmax = xf.abs().amax(dim=1)
    absmax = torch.clamp(absmax[:, None], min=1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, an f32 ulp away from the kernels' quotient
    sx = absmax / absmax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / sx), -127, 127)
    return (q.to(torch.int8), sx[:, 0],
            q.to(torch.int32).sum(dim=1, dtype=torch.int32))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] × int8 [K, N] → int32 [M, N] (``torch._int_mm``;
    on CUDA it wants more than 16 rows, so M is padded)."""
    M = a.shape[0]
    if a.is_cuda and M <= 16:
        a = torch.cat([a, a.new_zeros((32 - M, a.shape[1]))])
    if a.is_cuda:
        b = b.t().contiguous().t()          # column-major B for cuBLASLt
    return torch._int_mm(a, b)[:M]


def biased_codes(words: torch.Tensor) -> torch.Tensor:
    """[Kp/16, Np] words → [Kp, Np] int8 biased codes c + (c>>1) ∈ {0,1,3,4}."""
    c = unpack_packed(words).to(torch.int8)
    return c + (c >> 1)


def w2a8_epilogue(acc: torch.Tensor, sumq: torch.Tensor, sx: torch.Tensor,
                  scale: torch.Tensor, resid: torch.Tensor | None,
                  dtype: torch.dtype) -> torch.Tensor:
    """``((acc - 2·sumq)·sx)·scale [+ resid]`` in f32, cast to ``dtype``."""
    y = (acc - 2 * sumq[:, None]).to(torch.float32) * sx[:, None]
    y = y * scale[None, :]
    if resid is not None:
        y = y + resid.to(torch.float32)
    return y.to(dtype)


def ternary_matmul_w2a8_normed_plain(x, words, scale, gamma, eps, glu, resid,
                                     n_dim, stats=None, k_full=None):
    """K1 on one layer: words [Kp/16, Np], scale [Np], gamma [Kp] or None;
    ``stats`` [M, 2] (sum of squares, absmax of the normed row) or None."""
    xq, sx, sumq = quantize_rows(
        w2a8_preamble_plain(x, gamma, eps, glu, stats, k_full),
        None if stats is None else stats[:, 1])
    acc = int8_matmul(xq, biased_codes(words)[:, :n_dim])
    return w2a8_epilogue(acc, sumq, sx, scale[:n_dim], resid, x.dtype)


def ternary_matmul_w2a8_plain(xq, sumq, sx, words, scale, n_dim, dtype):
    """K4 on one layer: pre-quantized rows × words [Kp/16, Np]."""
    acc = int8_matmul(xq, biased_codes(words)[:, :n_dim])
    return w2a8_epilogue(acc, sumq, sx, scale[:n_dim], None, dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_stack(packed, scale_vec, l, k_dim, pad_ok=False):
    if packed.dtype != torch.int32 or packed.ndim != 3:
        raise ValueError(f"packed must be int32 [L, Kp/16, Np], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    L, R, Np = packed.shape
    if not 0 <= l < L:
        raise IndexError(f"layer {l} out of range [0, {L})")
    if pad_ok and not 0 < k_dim <= R * 16:
        raise ValueError(f"K6 needs 0 < K <= Kp, got K={k_dim} Kp={R * 16}")
    if not pad_ok and R * 16 != k_dim:
        raise ValueError(f"W2A8 kernels need K == Kp, got K={k_dim} Kp={R * 16}")
    if tuple(scale_vec.shape) != (L, Np) or scale_vec.dtype != torch.float32:
        raise ValueError(f"scale_vec must be f32 [{L}, {Np}]")
    if not (packed.is_contiguous() and scale_vec.is_contiguous()):
        raise ValueError("packed and scale_vec must be contiguous")
    if Np % 64:                 # column blocks: 32 (K1, K6 decode), halves of 128 (K4, K6)
        raise ValueError(f"W2A8 kernels need Np % 64 == 0, got Np={Np}")
    return L, Np


# K1's one-launch decode form: up to W2A8_DECODE_MAX_M rows and rows of up
# to W2A8_DECODE_MAX_K values (the 8B down projection); a block computes one
# of W2A8_DECODE_COLS output columns.  Two blocks fit an SM for rows of up
# to W2A8_DECODE_SHORT_K values, one for longer rows.  K11 is the same
# kernel in its block-scale mode, under the same limits.  The wrapper picks
# the form; the kernel's entry point refuses a call past these limits (its
# DEC_MAX_M, DEC_MAX_K and DEC_SHORT_K, which a CPU test holds equal).
W2A8_DECODE_MAX_M = 2
W2A8_DECODE_MAX_K = 14336
W2A8_DECODE_SHORT_K = 4096
W2A8_DECODE_COLS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def w2a8_decode_plan(M: int, K: int, N: int, sms: int) -> int:
    """Columns a block of K1's decode form (and of K11's, its block-scale
    mode) for M ≤ 2 rows × [K, N] words on ``sms`` SMs: the narrowest of
    ``W2A8_DECODE_COLS`` that divides N and whose blocks all fit the card at
    once (two an SM for rows of up to ``W2A8_DECODE_SHORT_K`` values, else
    one; the widest where none does).  Two blocks of either mode fit an SM
    there: the entry point cuts the ring to fit, and a ``static_assert``
    beside the kernel's sizes holds that the cut ring keeps two stages.  K
    is not split: over a cluster, every split of every main-path shape was
    slower than none, the generic path's k and v (20 column blocks)
    included (PERF.md §6, K1's plan sweep).  M does not enter.  Cached: a
    decode step asks it once a call, and the host paces the step."""
    fits = [c for c in W2A8_DECODE_COLS if N % c == 0]
    resident = (2 if K <= W2A8_DECODE_SHORT_K else 1) * sms
    return next((c for c in fits if N // c <= resident), fits[-1])


def ternary_matmul_w2a8_normed(l: int, x: torch.Tensor, packed: torch.Tensor,
                               scale_vec: torch.Tensor,
                               gamma: torch.Tensor | None, k_dim: int,
                               n_dim: int, eps: float = 1e-5,
                               glu: bool = False,
                               resid: torch.Tensor | None = None,
                               stats: torch.Tensor | None = None,
                               k_full: int | None = None) -> torch.Tensor:
    """K1: ``[resid +] quantize(norm(glu(x))) @ W[l]`` for decode rows,
    M = B ≤ ``STACKED_DECODE_MAX_M``.

    ``stats`` [M, 2] f32 (the row-statistics mode of a row-parallel slice,
    ``parallel/sharding.py``): each row's sum of squares over ``k_full``
    values and the absmax of its whole normed row, which the norm and the
    int8 scale take instead of the slice's own.

    x [M, K] (or [M, 2K] when ``glu``) bf16/f32; packed [L, Kp/16, Np];
    scale_vec [L, Np] f32; gamma [L, Kp] f32 or None; resid [M, n_dim] in
    x's dtype or None.  Returns [M, n_dim] in x's dtype.  On the card a call
    at M ≤ ``W2A8_DECODE_MAX_M`` (K ≤ ``W2A8_DECODE_MAX_K``) is one launch,
    more rows two (the row kernel, then the GEMM), and no other PyTorch op
    than ``torch.empty``."""
    L, Np = _check_stack(packed, scale_vec, l, k_dim)
    M = x.shape[0]
    if x.ndim != 2 or x.shape[1] != (2 * k_dim if glu else k_dim):
        raise ValueError(f"x must be [M, {2 * k_dim if glu else k_dim}], got "
                         f"{tuple(x.shape)}")
    if not 1 <= M <= STACKED_DECODE_MAX_M:
        raise ValueError(f"decode W2A8 takes 1..{STACKED_DECODE_MAX_M} rows, got {M}")
    if n_dim > Np:
        raise ValueError(f"n_dim {n_dim} > Np {Np}")
    if gamma is not None and tuple(gamma.shape) != (L, k_dim):
        raise ValueError(f"gamma must be [{L}, {k_dim}]")
    if resid is not None and (tuple(resid.shape) != (M, n_dim)
                              or resid.dtype != x.dtype):
        raise ValueError(f"resid must be [{M}, {n_dim}] {x.dtype}")
    _check_stats(stats, M, x, k_full, k_dim)
    if x.device.type == "cpu":
        return ternary_matmul_w2a8_normed_plain(
            x, packed[l], scale_vec[l], None if gamma is None else gamma[l],
            eps, glu, resid, n_dim, stats, k_full)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K1 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    dev_i = x.get_device()
    tensors = [x, packed, scale_vec] + [t for t in (gamma, resid) if t is not None]
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError("K1 operands must be contiguous on x's device")
    if gamma is not None and gamma.dtype != torch.float32:
        raise ValueError("gamma must be f32")
    out = _w2a8_normed_launch(l, x, packed, scale_vec, gamma, k_dim, n_dim, eps,
                              glu, resid, stats, k_full)[0]
    ternary_matmul_w2a8_normed.launches += 1
    return out


def _check_stats(stats, M, x, k_full, k_dim):
    """The row-statistics operand: f32 [M, 2], contiguous, on x's device,
    with the whole row's length ``k_full`` ≥ the slice's ``k_dim``."""
    if stats is None:
        return
    if (tuple(stats.shape) != (M, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be contiguous f32 [{M}, 2] on {x.device}")
    if k_full is None or k_full < k_dim:
        raise ValueError(f"stats need k_full >= {k_dim}, got {k_full}")


def _w2a8_normed_launch(l, x, packed, scale_vec, gamma, k_dim, n_dim, eps, glu,
                        resid, stats=None, k_full=None):
    """Launch K1 on checked operands: its decode form tiled by
    :func:`w2a8_decode_plan`, or the row kernel and the GEMM tiled by
    :func:`w2a8_gemm_plan`.  Returns (out, scratch): scratch holds the int8
    rows, their scales and their sums (``xq | sx | sumq``).  Layer ``l`` is
    addressed by pointer offset, not by a view per call."""
    M, Np = x.shape[0], packed.shape[2]
    dev = x.device
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    scratch = torch.empty(M * (k_dim + 8), dtype=torch.int8, device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul")
    args = (x.data_ptr(), x.shape[1], M, k_dim, int(glu),
            None if gamma is None else gamma.data_ptr() + 4 * l * k_dim, eps,
            packed.data_ptr() + 4 * l * packed.stride(0), Np,
            scale_vec.data_ptr() + 4 * l * Np,
            None if resid is None else resid.data_ptr(), out.data_ptr(), n_dim,
            p, p + M * k_dim, p + M * k_dim + 4 * M, _DTYPE_CODE[x.dtype])
    sms = _sm_count(dev.index)
    decode = M <= W2A8_DECODE_MAX_M and k_dim <= W2A8_DECODE_MAX_K
    # cols > 0 the decode form, cols == 0 the row kernel and the GEMM
    tiles = ((w2a8_decode_plan(M, k_dim, Np, sms), 0, 0) if decode
             else (0, *w2a8_gemm_plan(M, k_dim, Np, sms)))
    rc = lib.bn_w2a8_normed(*args, None if stats is None else stats.data_ptr(),
                            0 if k_full is None else k_full, *tiles, _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul", rc, "ternary_matmul_w2a8_normed")
    return out, scratch


def _w2a8_normed_cuda(l, x, packed, scale_vec, gamma, k_dim, n_dim, eps, glu,
                      resid, stats=None, k_full=None):
    """K1 with its integer parts: (out, xq [M, K], sx [M], sumq [M]), so a
    test can hold them against the plain version.  Counts no launch."""
    out, scratch = _w2a8_normed_launch(l, x, packed, scale_vec, gamma, k_dim,
                                       n_dim, eps, glu, resid, stats, k_full)
    M, MK = x.shape[0], x.shape[0] * k_dim
    return (out, scratch[:MK].view(M, k_dim),
            scratch[MK:MK + 4 * M].view(torch.float32),
            scratch[MK + 4 * M:].view(torch.int32))


ternary_matmul_w2a8_normed.launches = 0


# K4's tiles, chosen by shape: a block computes ``W2A8_GEMM_COLS`` output
# columns × BT rows, BT the smallest of ``W2A8_GEMM_ROWS`` that holds M (the
# largest above it).  K is split over a cluster of 2, 4 or 8 blocks while the
# blocks, doubled, still fit the card's SMs and every block keeps at least
# two 256-row K tiles: at M = 512 the generic path's k / v (N = 640) run 20
# column blocks × 4 splits, a single 8-row prompt's qkv 30 × 4.
W2A8_GEMM_ROWS = (8, 16, 32, 64, 128)
W2A8_GEMM_COLS = 128
W2A8_GEMM_MAX_SPLIT = 8


def w2a8_gemm_plan(M: int, Kp: int, Np: int, sms: int) -> tuple[int, int]:
    """(BT, split) of K4 for M rows × [Kp, Np] words on ``sms`` SMs."""
    bt = next((b for b in W2A8_GEMM_ROWS if b >= M), W2A8_GEMM_ROWS[-1])
    blocks = -(-Np // W2A8_GEMM_COLS) * -(-M // bt)
    split = 1
    while (split < W2A8_GEMM_MAX_SPLIT and 2 * split * blocks <= sms
           and 4 * split <= Kp // 256):
        split *= 2
    return bt, split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ternary_matmul_w2a8(l: int, x: torch.Tensor, packed: torch.Tensor,
                        scale_vec: torch.Tensor, k_dim: int,
                        n_dim: int, stats: torch.Tensor | None = None) -> torch.Tensor:
    """K4: ``quantize(x) @ W[l]`` for prefill rows (any M).  x [M, K]
    bf16/f32, already normed/activated; returns [M, n_dim] in x's dtype.
    On the card a call is two launches and no other PyTorch op than
    ``torch.empty``: the per-row int8 quantization (K1's row kernel, no
    norm, no SwiGLU: the arithmetic of :func:`quantize_rows`), then the
    wgmma GEMM with the epilogue, tiled by :func:`w2a8_gemm_plan`.
    ``stats`` [M, 2] f32, where given: each row's absmax is ``stats[:, 1]``
    (the whole row's, for a row-parallel slice) instead of x's own."""
    L, Np = _check_stack(packed, scale_vec, l, k_dim)
    if x.ndim != 2 or x.shape[1] != k_dim:
        raise ValueError(f"x must be [M, {k_dim}], got {tuple(x.shape)}")
    if n_dim > Np:
        raise ValueError(f"n_dim {n_dim} > Np {Np}")
    _check_stats(stats, x.shape[0], x, k_dim, k_dim)
    if x.device.type == "cpu":
        xq, sx, sumq = quantize_rows(x.to(torch.float32),
                                     None if stats is None else stats[:, 1])
        return ternary_matmul_w2a8_plain(xq, sumq, sx, packed[l], scale_vec[l],
                                         n_dim, x.dtype)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K4 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    if packed.get_device() != x.get_device() or scale_vec.get_device() != x.get_device():
        raise ValueError("K4 operands must be on x's device")
    if x.shape[0] < 1 or x.stride(1) != 1:
        raise ValueError("K4 takes at least one row, each contiguous")
    out = _w2a8_gemm_launch(l, x, packed, scale_vec, k_dim, n_dim, stats)[0]
    ternary_matmul_w2a8.launches += 1
    return out


def _w2a8_gemm_launch(l, x, packed, scale_vec, k_dim, n_dim, stats=None):
    """Launch K4 on checked operands.  Returns (out, scratch): scratch holds
    the int8 rows, their scales and their sums (``xq | sx | sumq``).  Layer
    ``l`` is addressed by pointer offset."""
    M, Np = x.shape[0], packed.shape[2]
    dev = x.device
    bt, split = w2a8_gemm_plan(M, k_dim, Np, _sm_count(dev.index))
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    scratch = torch.empty(M * (k_dim + 8), dtype=torch.int8, device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul")
    args = (x.data_ptr(), x.stride(0), M, k_dim,
            packed.data_ptr() + 4 * l * packed.stride(0), Np,
            scale_vec.data_ptr() + 4 * l * Np, out.data_ptr(), n_dim,
            p, p + M * k_dim, p + M * k_dim + 4 * M)
    rc = lib.bn_w2a8_gemm(*args, None if stats is None else stats.data_ptr(),
                          _DTYPE_CODE[x.dtype], bt, split, _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul", rc, "ternary_matmul_w2a8")
    return out, scratch


def _w2a8_gemm_cuda(l, x, packed, scale_vec, k_dim, n_dim, stats=None):
    """K4 with its integer parts: (out, xq [M, K], sx [M], sumq [M]), so a
    check can hold them against :func:`quantize_rows`.  Counts no launch."""
    out, scratch = _w2a8_gemm_launch(l, x, packed, scale_vec, k_dim, n_dim, stats)
    M, MK = x.shape[0], x.shape[0] * k_dim
    return (out, scratch[:MK].view(M, k_dim),
            scratch[MK:MK + 4 * M].view(torch.float32),
            scratch[MK + 4 * M:].view(torch.int32))


ternary_matmul_w2a8.launches = 0


# --------------------------------------------------------------------------
# K6: bf16 activations x biased codes, f32 accumulation, one scale a column
# --------------------------------------------------------------------------
def colscale_rows_plain(x: torch.Tensor, Kp: int):
    """The plain version of K6's row kernel: x [M, K] zero-padded to Kp and
    rounded to bf16 (the JAX wrapper pads in f32, then rounds: the same
    values), and the f32 sum of each row of those bf16 values (``sumx``,
    ``:1114-1121``); returns (xb bf16 [M, Kp], sumx f32 [M])."""
    xb = torch.nn.functional.pad(x.to(torch.bfloat16), (0, Kp - x.shape[1])).contiguous()
    return xb, xb.to(torch.float32).sum(dim=1)


def ternary_matmul_bf16_plain(xb, sumx, words, scale, n_dim, dtype):
    """K6 on one layer: bf16 rows [M, Kp] (their f32 row sums ``sumx``)
    × words [Kp/16, Np]: ``(Σ x·(c+(c>>1)) − 2·sumx)·scale`` in f32, cast
    to ``dtype``."""
    acc = torch.matmul(xb.to(torch.float32),
                       biased_codes(words)[:, :n_dim].to(torch.float32))
    y = (acc - 2.0 * sumx[:, None]) * scale[None, :n_dim]
    return y.to(dtype)


# The rows up to which K6 takes its decode form (one launch) rather than its
# GEMM form (the row kernel, then the wgmma GEMM): the largest M of {1, 2, 4,
# 8, 16} at which the decode form was no slower over the generic path's
# seven shapes on the H100 (PERF.md, Findings: K6's MB table).
BF16_DECODE_MAX_M = 2


def ternary_matmul_bf16(l: int, x: torch.Tensor, packed: torch.Tensor,
                        scale_vec: torch.Tensor, k_dim: int,
                        n_dim: int) -> torch.Tensor:
    """K6: ``x @ W[l]`` with x rounded to bf16 (even when x is f32, as the
    JAX ``pallas`` variant does, ``:1115-1118``) and zero-padded to Kp, the
    bias correction ``2·Σx`` summing the same bf16 values in f32; returns
    [M, n_dim] in x's dtype.  x [M, K] in its own dtype, K = ``k_dim`` ≤ Kp.
    On the card, M ≤ ``BF16_DECODE_MAX_M`` rows take the decode form (one
    launch), more rows the GEMM form (two launches: the row kernel, then the
    GEMM tiled by :func:`blockscale_gemm_plan`); neither runs another
    PyTorch op than ``torch.empty``."""
    _check_stack(packed, scale_vec, l, k_dim, pad_ok=True)
    if x.ndim != 2 or x.shape[1] != k_dim:
        raise ValueError(f"x must be [M, {k_dim}], got {tuple(x.shape)}")
    if n_dim > packed.shape[2]:
        raise ValueError(f"n_dim {n_dim} > Np {packed.shape[2]}")
    if x.device.type == "cpu":
        xb, sumx = colscale_rows_plain(x, packed.shape[1] * 16)
        return ternary_matmul_bf16_plain(xb, sumx, packed[l], scale_vec[l], n_dim,
                                         x.dtype)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K6 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    if packed.get_device() != x.get_device() or scale_vec.get_device() != x.get_device():
        raise ValueError("K6 operands must be on x's device")
    if x.shape[0] <= BF16_DECODE_MAX_M:
        out = _bf16_decode_cuda(l, x, packed, scale_vec, k_dim, n_dim)
    else:
        out = _bf16_gemm_launch(l, x, packed, scale_vec, k_dim, n_dim)[0]
    ternary_matmul_bf16.launches += 1
    return out


def _bf16_decode_cuda(l, x, packed, scale_vec, k_dim, n_dim):
    """K6's decode form on checked operands (1 ≤ M ≤ 16, x contiguous in its
    own dtype): one launch, nothing else.  Counts no launch."""
    if not x.is_contiguous():
        raise ValueError("K6's decode form takes a contiguous x")
    M, Kp, Np = x.shape[0], packed.shape[1] * 16, packed.shape[2]
    out = torch.empty((M, n_dim), dtype=x.dtype, device=x.device)
    lib = _cuda.library("ternary_matmul_tl")
    rc = lib.bn_colscale_decode(
        x.data_ptr(), M, k_dim, Kp, packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scale_vec.data_ptr() + 4 * l * Np, out.data_ptr(), n_dim, _DTYPE_CODE[x.dtype],
        _cuda.stream_ptr(x.device))
    _cuda.check(lib, "ternary_matmul_tl", rc, "ternary_matmul_bf16")
    return out


def _bf16_gemm_launch(l, x, packed, scale_vec, k_dim, n_dim):
    """Launch K6's GEMM form on checked operands, any M ≥ 1 (x's rows each
    contiguous): the row kernel, then the GEMM in column-scale mode, tiled
    by :func:`blockscale_gemm_plan`.  The GEMM reads bf16 rows that TMA can
    address (16-byte aligned, a row stride of a multiple of 8 values) from x
    itself; other rows (f32 x among them) are copied to bf16 rows
    zero-padded to Kp by the row kernel.  Returns (out, scratch, copied):
    scratch holds the copy (bf16 [M, Kp], where ``copied``), then the f32
    row sums [M]."""
    if x.stride(1) != 1:
        raise ValueError("K6's GEMM form takes rows that are each contiguous")
    M, Kp, Np = x.shape[0], packed.shape[1] * 16, packed.shape[2]
    dev = x.device
    bt, split = blockscale_gemm_plan(M, Kp, Np, _sm_count(dev.index))
    copy = not (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
                and x.stride(0) % 8 == 0)
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    a = 2 * M * Kp if copy else 0          # the copy first: TMA reads it 16-byte aligned
    scratch = torch.empty(a + 4 * M, dtype=torch.uint8, device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul_tl")
    rc = lib.bn_colscale_gemm(
        x.data_ptr(), x.stride(0), M, k_dim, Kp,
        packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scale_vec.data_ptr() + 4 * l * Np, out.data_ptr(), n_dim,
        p if copy else None, p + a, _DTYPE_CODE[x.dtype], bt, split,
        _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul_tl", rc, "ternary_matmul_bf16")
    return out, scratch, copy


def _bf16_gemm_cuda(l, x, packed, scale_vec, k_dim, n_dim):
    """K6's GEMM form with its row kernel's output: (out, xb, sumx), xb the
    bf16 rows [M, Kp] it copied or None, sumx the f32 row sums [M], so a
    check can hold them against :func:`colscale_rows_plain`.  Counts no
    launch."""
    out, scratch, copied = _bf16_gemm_launch(l, x, packed, scale_vec, k_dim, n_dim)
    M, Kp = x.shape[0], packed.shape[1] * 16
    a = 2 * M * Kp if copied else 0
    xb = scratch[:a].view(torch.bfloat16).view(M, Kp) if copied else None
    return out, xb, scratch[a:].view(torch.float32)


ternary_matmul_bf16.launches = 0


# --------------------------------------------------------------------------
# K10-K12: per-32-row block scales (bitnet32 / TL weights)
# --------------------------------------------------------------------------
def block_values(words: torch.Tensor, lut_bias: bool) -> torch.Tensor:
    """[Kp/16, Np] words → [Kp, Np] int32 biased values: c + (c>>1) ∈
    {0,1,3,4} for bitnet32 (``lut_bias``), c ∈ {0..3} for TL."""
    c = unpack_packed(words).to(torch.int32)
    return c + (c >> 1) if lut_bias else c


def block_weights(words: torch.Tensor, scales: torch.Tensor, lut_bias: bool,
                  unbiased: bool) -> torch.Tensor:
    """bf16 [Kp, Np] weights ``bf16(v·s32)`` (biased, as ``:156``) or
    ``bf16((v−2)·s32)`` (``unbiased``, as ``:633``); scales [Kp/32, Np]."""
    v = block_values(words, lut_bias) - (2 if unbiased else 0)
    s32 = torch.repeat_interleave(scales.to(torch.float32), 32, dim=0)
    return (v.to(torch.float32) * s32).to(torch.bfloat16)


def ternary_matmul_blockscale_bf16_plain(xb, corr, words, scales, n_dim,
                                         lut_bias, dtype):
    """K10 on one layer: bf16 rows [M, Kp] × the biased scaled weights,
    f32 sums, minus ``corr`` [M, Np] (``2·(sum32 @ s)``), cast to ``dtype``."""
    acc = torch.matmul(xb.to(torch.float32),
                       block_weights(words, scales, lut_bias, False).to(torch.float32))
    return (acc - corr)[:, :n_dim].to(dtype)


def _check_block_stack(packed, scales, l, k_dim):
    if packed.dtype != torch.int32 or packed.ndim != 3:
        raise ValueError(f"packed must be int32 [L, Kp/16, Np], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    L, R, Np = packed.shape
    if not 0 <= l < L:
        raise IndexError(f"layer {l} out of range [0, {L})")
    if tuple(scales.shape) != (L, R // 2, Np) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be f32 [{L}, {R // 2}, {Np}], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed and scales must be contiguous")
    if Np % 64 or not 0 < k_dim <= R * 16:
        raise ValueError(f"block-scale kernels need Np % 64 == 0 and K <= Kp, "
                         f"got Np={Np} K={k_dim} Kp={R * 16}")
    return L, R * 16, Np


# The rows up to which K10 takes its decode form: the largest M of {1, 2, 4,
# 8, 16} at which it was no slower than the GEMM form over the generic
# path's seven shapes on the H100 (PERF.md, Findings: the MB table of the
# wgmma GEMM).  The decode form itself takes up to 16 rows.
BLOCKSCALE_DECODE_MAX_M = 2


def blockscale_rows_plain(x: torch.Tensor, Kp: int):
    """The plain version of K10's row kernel: x [M, K] zero-padded to Kp and
    rounded to bf16 (the JAX wrappers pad in f32, then round: the same
    values), and the f32 sums of each 32 of those bf16 values; returns
    (xb bf16 [M, Kp], sum32 f32 [M, Kp/32])."""
    M, k_dim = x.shape
    xb = torch.nn.functional.pad(x.to(torch.bfloat16), (0, Kp - k_dim)).contiguous()
    return xb, xb.to(torch.float32).view(M, Kp // 32, 32).sum(dim=-1)


def blockscale_sums_split(sum32: torch.Tensor) -> torch.Tensor:
    """The 32-row sums as the GEMM form's correction reads them (the row
    kernel's third output): each f32 sum split into bf16 hi = bf16(v) and
    lo = bf16(v − hi), and each K tile's 8 blocks laid out as 32 values
    (hi of the 8, lo, hi, lo); [M, Kp/32] f32 → [M, Kp/8] bf16."""
    M, nb = sum32.shape
    hi = sum32.to(torch.bfloat16)
    lo = (sum32 - hi.to(torch.float32)).to(torch.bfloat16)
    hi, lo = hi.view(M, nb // 8, 1, 8), lo.view(M, nb // 8, 1, 8)
    return torch.cat([hi, lo, hi, lo], dim=2).view(M, nb * 4)


def blockscale_correction(sum32: torch.Tensor, scales_l: torch.Tensor) -> torch.Tensor:
    """K10's bias correction ``2·(sum32 @ s)`` [M, Np], an f32 matmul
    (``Precision.HIGHEST`` in XLA; the matmul is never TF32, PyTorch's
    default).  The GEMM form subtracts it inside the kernel instead."""
    return 2.0 * torch.matmul(sum32, scales_l)


# K10's GEMM form and K12 share one wgmma GEMM: a block computes
# ``BLOCKSCALE_GEMM_COLS`` output columns × BT rows, BT the smallest of
# ``BLOCKSCALE_GEMM_ROWS`` that holds M (the largest above it), so K12's
# pool of 8 fills an 8-row tile.  K is split over a cluster of 2, 4 or 8
# blocks while the blocks, doubled, still fit the card's SMs and every block
# keeps a 256-row K tile at least: at M = 8 the fused four's o and down
# (N = 2560) run 20 column blocks × 4, the generic seven's k and v (N = 640)
# 5 × 8.
BLOCKSCALE_GEMM_ROWS = (8, 16, 32, 64, 128)
BLOCKSCALE_GEMM_COLS = 128
BLOCKSCALE_GEMM_MAX_SPLIT = 8


def blockscale_gemm_plan(M: int, Kp: int, Np: int, sms: int) -> tuple[int, int]:
    """(BT, split) of the block-scale GEMM for M rows × [Kp, Np] words on
    ``sms`` SMs."""
    bt = next((b for b in BLOCKSCALE_GEMM_ROWS if b >= M), BLOCKSCALE_GEMM_ROWS[-1])
    blocks = -(-Np // BLOCKSCALE_GEMM_COLS) * -(-M // bt)
    split = 1
    while (split < BLOCKSCALE_GEMM_MAX_SPLIT and 2 * split * blocks <= sms
           and 2 * split <= Kp // 256):
        split *= 2
    return bt, split


def ternary_matmul_blockscale_bf16(l: int, x: torch.Tensor, packed: torch.Tensor,
                                   scales: torch.Tensor, k_dim: int, n_dim: int,
                                   lut_bias: bool) -> torch.Tensor:
    """K10: ``x @ W[l]`` for bitnet32 / TL weights, any M; x [M, K] (already
    normed / activated), zero-padded to Kp and rounded to bf16 (the JAX
    wrappers pad in f32, then round: the same values).  Returns [M, n_dim]
    in x's dtype.  On the card, M ≤ ``BLOCKSCALE_DECODE_MAX_M`` rows take
    the decode form (one launch, the correction inside), more rows the
    GEMM form (two launches, the correction inside); neither runs another
    PyTorch op than ``torch.empty``."""
    L, Kp, Np = _check_block_stack(packed, scales, l, k_dim)
    if x.ndim != 2 or x.shape[1] != k_dim:
        raise ValueError(f"x must be [M, {k_dim}], got {tuple(x.shape)}")
    if n_dim > Np:
        raise ValueError(f"n_dim {n_dim} > Np {Np}")
    if x.device.type == "cpu":
        xb, sum32 = blockscale_rows_plain(x, Kp)
        return ternary_matmul_blockscale_bf16_plain(
            xb, blockscale_correction(sum32, scales[l]), packed[l], scales[l], n_dim,
            lut_bias, x.dtype)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K10 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    if packed.get_device() != x.get_device() or scales.get_device() != x.get_device():
        raise ValueError("K10 operands must be on x's device")
    if x.shape[0] <= BLOCKSCALE_DECODE_MAX_M:
        out = _blockscale_decode_cuda(l, x, packed, scales, k_dim, n_dim, lut_bias)
    else:
        out = _blockscale_gemm_launch(l, x, packed, scales, k_dim, n_dim, lut_bias)[0]
    ternary_matmul_blockscale_bf16.launches += 1
    return out


def _blockscale_decode_cuda(l, x, packed, scales, k_dim, n_dim, lut_bias):
    """K10's decode form on checked operands (1 ≤ M ≤ 16, x contiguous in
    its own dtype): one launch, nothing else.  Counts no launch."""
    if not x.is_contiguous():
        raise ValueError("K10's decode form takes a contiguous x")
    M, Kp, Np = x.shape[0], packed.shape[1] * 16, packed.shape[2]
    out = torch.empty((M, n_dim), dtype=x.dtype, device=x.device)
    lib = _cuda.library("ternary_matmul_tl")
    rc = lib.bn_blockscale_decode(
        x.data_ptr(), M, k_dim, Kp, packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scales.data_ptr() + 4 * l * scales.stride(0), out.data_ptr(), n_dim,
        int(lut_bias), _DTYPE_CODE[x.dtype], _cuda.stream_ptr(x.device))
    _cuda.check(lib, "ternary_matmul_tl", rc, "ternary_matmul_blockscale_bf16")
    return out


def _blockscale_gemm_launch(l, x, packed, scales, k_dim, n_dim, lut_bias):
    """Launch K10's GEMM form on checked operands, any M ≥ 1 (x's rows each
    contiguous): the row kernel, then the GEMM, tiled by
    :func:`blockscale_gemm_plan`.  Returns (out, scratch): scratch holds the
    bf16 rows, their 32-row sums, then those sums split for the correction.
    Layer ``l`` is addressed by pointer offset."""
    if x.stride(1) != 1:
        raise ValueError("K10's GEMM form takes rows that are each contiguous")
    M, Kp, Np = x.shape[0], packed.shape[1] * 16, packed.shape[2]
    dev = x.device
    bt, split = blockscale_gemm_plan(M, Kp, Np, _sm_count(dev.index))
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    scratch = torch.empty(M * Kp * 2 + M * Kp // 8 + M * Kp // 4, dtype=torch.uint8,
                          device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul_tl")
    rc = lib.bn_blockscale_gemm(
        x.data_ptr(), x.stride(0), M, k_dim, Kp,
        packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scales.data_ptr() + 4 * l * scales.stride(0), out.data_ptr(), n_dim,
        p, p + M * Kp * 2, p + M * Kp * 2 + M * Kp // 8, int(lut_bias),
        _DTYPE_CODE[x.dtype], bt, split, _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul_tl", rc, "ternary_matmul_blockscale_bf16")
    return out, scratch


def _blockscale_gemm_cuda(l, x, packed, scales, k_dim, n_dim, lut_bias):
    """K10's GEMM form with its row kernel's output: (out, xb [M, Kp] bf16,
    sum32 [M, Kp/32] f32, split [M, Kp/8] bf16), so a check can hold them
    against :func:`blockscale_rows_plain` and :func:`blockscale_sums_split`.
    Counts no launch."""
    out, scratch = _blockscale_gemm_launch(l, x, packed, scales, k_dim, n_dim, lut_bias)
    M, Kp = x.shape[0], packed.shape[1] * 16
    a, b = M * Kp * 2, M * Kp * 2 + M * Kp // 8
    return (out, scratch[:a].view(torch.bfloat16).view(M, Kp),
            scratch[a:b].view(torch.float32).view(M, Kp // 32),
            scratch[b:].view(torch.bfloat16).view(M, Kp // 8))


ternary_matmul_blockscale_bf16.launches = 0


def tl_block_partials(xq: torch.Tensor, words: torch.Tensor,
                      lut_bias: bool) -> torch.Tensor:
    """K11's exact integer parts: int8 rows [M, Kp] × the biased values of
    words [Kp/16, Np] → int32 [Kp/32, M, Np], ``Σ_{k∈b} q·v − 2·Σ_{k∈b} q``
    per 32-row block b.  The float products are exact (|partial| ≤
    127·4·32 < 2^24), on the CPU and on the card."""
    M, Kp = xq.shape
    nb = Kp // 32
    q = xq.to(torch.float32).view(M, nb, 32).transpose(0, 1)         # [nb, M, 32]
    v = block_values(words, lut_bias).to(torch.float32).view(nb, 32, -1)
    sq = xq.to(torch.int32).view(M, nb, 32).sum(dim=-1, dtype=torch.int32).t()
    return torch.bmm(q, v).to(torch.int32) - 2 * sq[..., None]


def ternary_matmul_tl_w2a8_normed_plain(x, words, scales, gamma, eps, glu,
                                        resid, n_dim, lut_bias):
    """K11 on one layer: scales [Kp/32, Np], gamma [Kp] or None."""
    xq, sx, _ = quantize_rows(w2a8_preamble_plain(x, gamma, eps, glu))
    part = tl_block_partials(xq, words, lut_bias).to(torch.float32)
    y = (part * scales.to(torch.float32)[:, None, :]).sum(dim=0)[:, :n_dim]
    y = y * sx[:, None]
    if resid is not None:
        y = y + resid.to(torch.float32)
    return y.to(x.dtype)


def ternary_matmul_tl_bf16_normed_plain(x, words, scales, gamma, eps, glu,
                                        resid, n_dim, lut_bias):
    """K12 on one layer: the preamble rounded to bf16 × the unbiased scaled
    weights, f32 sums, plus the residual."""
    xb = w2a8_preamble_plain(x, gamma, eps, glu).to(torch.bfloat16)
    y = torch.matmul(xb.to(torch.float32),
                     block_weights(words, scales, lut_bias, True).to(torch.float32))
    y = y[:, :n_dim]
    if resid is not None:
        y = y + resid.to(torch.float32)
    return y.to(x.dtype)


def _check_normed_block(what, l, x, packed, scales, gamma, k_dim, n_dim, glu,
                        resid, max_m):
    """The shared checks of K11 and K12 (the fused TL sites need K == Kp:
    the in-kernel norm cannot see column padding, ``:690-693``)."""
    L, Kp, Np = _check_block_stack(packed, scales, l, k_dim)
    if k_dim != Kp:
        raise KernelError(f"{what} needs k_dim == Kp ({k_dim} != {Kp}); use "
                          "ternary_matmul_blockscale_bf16")
    M = x.shape[0]
    if x.ndim != 2 or x.shape[1] != (2 * k_dim if glu else k_dim):
        raise ValueError(f"x must be [M, {2 * k_dim if glu else k_dim}], got "
                         f"{tuple(x.shape)}")
    if not 1 <= M <= max_m:
        raise KernelError(f"{what} takes 1..{max_m} rows, got {M}")
    if n_dim > Np:
        raise ValueError(f"n_dim {n_dim} > Np {Np}")
    if gamma is not None and tuple(gamma.shape) != (L, k_dim):
        raise ValueError(f"gamma must be [{L}, {k_dim}]")
    if resid is not None and (tuple(resid.shape) != (M, n_dim)
                              or resid.dtype != x.dtype):
        raise ValueError(f"resid must be [{M}, {n_dim}] {x.dtype}")
    if x.device.type == "cpu":
        return False
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what} takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    dev_i = x.get_device()
    tensors = [x, packed, scales] + [t for t in (gamma, resid) if t is not None]
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous on x's device")
    if gamma is not None and gamma.dtype != torch.float32:
        raise ValueError("gamma must be f32")
    return True


# the Pallas kernel's M cap (``:916-919``): the selection rule (B <= 2 → K11,
# else K12) keeps it, because the two compute different functions
TL_W2A8_MAX_M = 2


def ternary_matmul_tl_w2a8_normed(l: int, x: torch.Tensor, packed: torch.Tensor,
                                  scales: torch.Tensor, gamma: torch.Tensor | None,
                                  k_dim: int, n_dim: int, eps: float = 1e-5,
                                  glu: bool = False,
                                  resid: torch.Tensor | None = None,
                                  lut_bias: bool = False) -> torch.Tensor:
    """K11: ``[resid +] W2A8(norm(glu(x))) @ W[l]`` with per-32-row block
    scales, M ≤ 2.  x [M, K] (or [M, 2K] when ``glu``) bf16/f32; packed
    [L, Kp/16, Np]; scales [L, Kp/32, Np]; gamma [L, Kp] f32 or None.  On
    the card a call is one launch of K1's decode kernel in its block-scale
    mode, K ≤ ``W2A8_DECODE_MAX_K`` (the 8B down projection's 14336), and
    no other PyTorch op than ``torch.empty``; a longer row is refused there
    (the stacked decode sends such a layer to K12)."""
    if not _check_normed_block("K11", l, x, packed, scales, gamma, k_dim, n_dim,
                               glu, resid, TL_W2A8_MAX_M):
        return ternary_matmul_tl_w2a8_normed_plain(
            x, packed[l], scales[l], None if gamma is None else gamma[l], eps,
            glu, resid, n_dim, lut_bias)
    if k_dim > W2A8_DECODE_MAX_K:
        raise KernelError(f"K11's kernel takes K <= {W2A8_DECODE_MAX_K}, got {k_dim}")
    out = _tl_w2a8_launch(l, x, packed, scales, gamma, k_dim, n_dim, eps, glu,
                          resid, lut_bias)[0]
    ternary_matmul_tl_w2a8_normed.launches += 1
    return out


def _tl_w2a8_launch(l, x, packed, scales, gamma, k_dim, n_dim, eps, glu, resid,
                    lut_bias):
    """Launch K11 on checked operands: K1's decode form in its block-scale
    mode, tiled by :func:`w2a8_decode_plan`.  Returns (out, scratch): the
    int8 rows, their scales and their sums (``xq | sx | sumq``), as K1's."""
    M, Np = x.shape[0], packed.shape[2]
    dev = x.device
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    scratch = torch.empty(M * (k_dim + 8), dtype=torch.int8, device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul")
    rc = lib.bn_tl_w2a8_normed(
        x.data_ptr(), x.shape[1], M, k_dim, int(glu),
        None if gamma is None else gamma.data_ptr() + 4 * l * k_dim, eps,
        packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scales.data_ptr() + 4 * l * scales.stride(0),
        None if resid is None else resid.data_ptr(), out.data_ptr(), n_dim,
        p, p + M * k_dim, p + M * k_dim + 4 * M, int(lut_bias), _DTYPE_CODE[x.dtype],
        w2a8_decode_plan(M, k_dim, Np, _sm_count(dev.index)),
        _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul", rc, "ternary_matmul_tl_w2a8_normed")
    return out, scratch


def _tl_w2a8_cuda(l, x, packed, scales, gamma, k_dim, n_dim, eps, glu, resid,
                  lut_bias):
    """K11 with its int8 rows, scales and row sums, so a check can hold them
    against K1's.  Counts no launch."""
    out, scratch = _tl_w2a8_launch(l, x, packed, scales, gamma, k_dim, n_dim, eps,
                                   glu, resid, lut_bias)
    M, MK = x.shape[0], x.shape[0] * k_dim
    return (out, scratch[:MK].view(M, k_dim),
            scratch[MK:MK + 4 * M].view(torch.float32),
            scratch[MK + 4 * M:].view(torch.int32))


ternary_matmul_tl_w2a8_normed.launches = 0


def ternary_matmul_tl_bf16_normed(l: int, x: torch.Tensor, packed: torch.Tensor,
                                  scales: torch.Tensor, gamma: torch.Tensor | None,
                                  k_dim: int, n_dim: int, eps: float = 1e-5,
                                  glu: bool = False,
                                  resid: torch.Tensor | None = None,
                                  lut_bias: bool = False) -> torch.Tensor:
    """K12: ``[resid +] bf16(norm(glu(x))) @ W[l]`` with the unbiased
    block-scaled weights, M ≤ 64.  Operands as K11's.  On the card a call
    is two launches (the preamble, then the GEMM) and no other PyTorch op
    than ``torch.empty``."""
    if not _check_normed_block("K12", l, x, packed, scales, gamma, k_dim, n_dim,
                               glu, resid, STACKED_DECODE_MAX_M):
        return ternary_matmul_tl_bf16_normed_plain(
            x, packed[l], scales[l], None if gamma is None else gamma[l], eps,
            glu, resid, n_dim, lut_bias)
    out = _tl_bf16_launch(l, x, packed, scales, gamma, k_dim, n_dim, eps, glu,
                          resid, lut_bias)
    ternary_matmul_tl_bf16_normed.launches += 1
    return out


def _tl_bf16_launch(l, x, packed, scales, gamma, k_dim, n_dim, eps, glu, resid,
                    lut_bias):
    """Launch K12 on checked operands, any M ≥ 1: the preamble, then the
    block-scale GEMM unbiased, tiled by :func:`blockscale_gemm_plan`, with
    the residual in its epilogue.  Counts no launch."""
    M, Np = x.shape[0], packed.shape[2]
    dev = x.device
    bt, split = blockscale_gemm_plan(M, k_dim, Np, _sm_count(dev.index))
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    xb = torch.empty((M, k_dim), dtype=torch.bfloat16, device=dev)
    lib = _cuda.library("ternary_matmul_tl")
    rc = lib.bn_tl_bf16_normed(
        x.data_ptr(), x.shape[1], M, k_dim, int(glu),
        None if gamma is None else gamma.data_ptr() + 4 * l * k_dim, eps,
        packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scales.data_ptr() + 4 * l * scales.stride(0),
        None if resid is None else resid.data_ptr(), out.data_ptr(), n_dim,
        xb.data_ptr(), int(lut_bias), _DTYPE_CODE[x.dtype], bt, split,
        _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul_tl", rc, "ternary_matmul_tl_bf16_normed")
    return out


ternary_matmul_tl_bf16_normed.launches = 0


# --------------------------------------------------------------------------
# the generic path's dispatcher (JAX: ternary_matmul_pallas)
# --------------------------------------------------------------------------
def ternary_matmul_pallas(lin: TernaryLinear, x: torch.Tensor,
                          variant: str = "pallas",
                          gamma: torch.Tensor | None = None,
                          eps: float = 1e-5, glu: bool = False,
                          resid: torch.Tensor | None = None,
                          layer: int = 0) -> torch.Tensor:
    """``[resid +] rms_norm(glu(x), gamma) @ W`` through the port's kernels,
    ``variant`` ``'w2a8'`` (K1, or K4) or ``'pallas'`` (K6), K10 for
    bitnet32 / TL weights on either: the JAX
    dispatcher of this name (``bitnet_tpu/ops/ternary_matmul.py:1266-1326``).
    Its branch rule lives in :func:`~.linear.linear_apply_normed`, which
    shares the SwiGLU / norm / residual steps with the ``xla`` path.  A
    dense linear has no words for a kernel to read and is refused, as the
    JAX dispatcher fails on it (``lin.packed`` is None there)."""
    if variant not in ("w2a8", "pallas"):
        raise ValueError(f"bad variant {variant!r}")
    if lin.kind == "dense":
        raise QuantizationError(
            "a dense linear has no packed words for the ternary kernels; "
            "linear_apply runs it as a plain matmul")
    return linear_apply_normed(lin, x, gamma, eps=eps, path=variant, glu=glu,
                               resid=resid, layer=layer)
