"""W2A8 ternary matmuls: the CUDA kernels K1/K4 and their plain versions.

K1 :func:`ternary_matmul_w2a8_normed` replaces ``ternary_matmul_stacked``
(``bitnet_tpu/ops/ternary_matmul.py:316``): decode shapes, M = B ≤ 64, with
the optional SwiGLU / RMSNorm / int8-quantize preamble and residual
epilogue fused around the integer dot.

K4 :func:`ternary_matmul_w2a8` replaces ``ternary_matmul_stacked_prefill``
(``:417``): the M-blocked prefill GEMM; activations are quantized outside
the kernel in plain PyTorch with the same math, as the JAX package does
in XLA (``:441-445``).

Both take the whole ``[L, Kp/16, Np]`` stack and a Python layer index, as
the JAX wrappers do; on a GPU ``packed[l]`` is a view, so the layer slice
costs nothing.  Each wrapper launches its CUDA kernel for CUDA tensors
(counting the launch in ``<wrapper>.launches``) and runs the plain version
for CPU tensors — never the plain version on a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import _cuda
from .linear import unpack_packed

# The one M cap of the decode-shaped W2A8 kernel, the default of the JAX
# package's ``stacked_decode_max_m()`` (``ops/ternary_matmul.py:52``; there
# an environment override trades it against the TPU's VMEM, a limit the
# CUDA kernel does not have).  The model's stacked-decode gate and K1's
# wrapper both read it.
STACKED_DECODE_MAX_M = 64


# --------------------------------------------------------------------------
# plain PyTorch versions (the tests' reference; CPU tensors only on the path)
# --------------------------------------------------------------------------
def w2a8_preamble_plain(x: torch.Tensor, gamma: torch.Tensor | None,
                        eps: float, glu: bool) -> torch.Tensor:
    """K1's preamble before quantization: optional silu(gate)·up, optional
    RMSNorm; f32 [M, K]."""
    xf = x.to(torch.float32)
    if glu:
        K = xf.shape[1] // 2
        gate = xf[:, :K]
        xf = gate * torch.sigmoid(gate) * xf[:, K:]
    if gamma is not None:
        var = torch.mean(xf * xf, dim=1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps)
        xf = xf * gamma.to(torch.float32)[None, :]
    return xf


def quantize_rows(xf: torch.Tensor):
    """Per-row absmax int8: ``sx = max(absmax, 1e-8)/127``,
    ``q = clip(round(x/sx), ±127)``; returns (q int8, sx f32 [M], sumq
    int32 [M])."""
    absmax = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8)
    sx = absmax / 127.0
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
                                     n_dim):
    """K1 on one layer: words [Kp/16, Np], scale [Np], gamma [Kp] or None."""
    xq, sx, sumq = quantize_rows(w2a8_preamble_plain(x, gamma, eps, glu))
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


def _check_stack(packed, scale_vec, l, k_dim):
    if packed.dtype != torch.int32 or packed.ndim != 3:
        raise ValueError(f"packed must be int32 [L, Kp/16, Np], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    L, R, Np = packed.shape
    if not 0 <= l < L:
        raise IndexError(f"layer {l} out of range [0, {L})")
    if R * 16 != k_dim:
        raise ValueError(f"W2A8 kernels need K == Kp, got K={k_dim} Kp={R * 16}")
    if tuple(scale_vec.shape) != (L, Np) or scale_vec.dtype != torch.float32:
        raise ValueError(f"scale_vec must be f32 [{L}, {Np}]")
    if not (packed.is_contiguous() and scale_vec.is_contiguous()):
        raise ValueError("packed and scale_vec must be contiguous")
    if Np % 64:                 # the kernels' column blocks are 32 (K1), 64 (K4)
        raise ValueError(f"W2A8 kernels need Np % 64 == 0, got Np={Np}")
    return L, Np


def ternary_matmul_w2a8_normed(l: int, x: torch.Tensor, packed: torch.Tensor,
                               scale_vec: torch.Tensor,
                               gamma: torch.Tensor | None, k_dim: int,
                               n_dim: int, eps: float = 1e-5,
                               glu: bool = False,
                               resid: torch.Tensor | None = None) -> torch.Tensor:
    """K1: ``[resid +] quantize(norm(glu(x))) @ W[l]`` for decode rows,
    M = B ≤ ``STACKED_DECODE_MAX_M``.

    x [M, K] (or [M, 2K] when ``glu``) bf16/f32; packed [L, Kp/16, Np];
    scale_vec [L, Np] f32; gamma [L, Kp] f32 or None; resid [M, n_dim] in
    x's dtype or None.  Returns [M, n_dim] in x's dtype."""
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
    if x.device.type == "cpu":
        return ternary_matmul_w2a8_normed_plain(
            x, packed[l], scale_vec[l], None if gamma is None else gamma[l],
            eps, glu, resid, n_dim)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K1 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    dev_i = x.get_device()
    tensors = [x, packed, scale_vec] + [t for t in (gamma, resid) if t is not None]
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError("K1 operands must be contiguous on x's device")
    if gamma is not None and gamma.dtype != torch.float32:
        raise ValueError("gamma must be f32")
    out = _w2a8_normed_launch(l, x, packed, scale_vec, gamma, k_dim, n_dim, eps,
                              glu, resid)[0]
    ternary_matmul_w2a8_normed.launches += 1
    return out


def _w2a8_normed_launch(l, x, packed, scale_vec, gamma, k_dim, n_dim, eps, glu,
                        resid):
    """Launch K1 on checked operands.  Returns (out, scratch): scratch holds
    the int8 rows, their scales and their sums (``xq | sx | sumq``).  Layer
    ``l`` is addressed by pointer offset, not by a view per call."""
    M, Np = x.shape[0], packed.shape[2]
    dev = x.device
    out = torch.empty((M, n_dim), dtype=x.dtype, device=dev)
    scratch = torch.empty(M * (k_dim + 8), dtype=torch.int8, device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul")
    rc = lib.bn_w2a8_normed(
        x.data_ptr(), x.shape[1], M, k_dim, int(glu),
        None if gamma is None else gamma.data_ptr() + 4 * l * k_dim, eps,
        packed.data_ptr() + 4 * l * packed.stride(0), Np,
        scale_vec.data_ptr() + 4 * l * Np,
        None if resid is None else resid.data_ptr(), out.data_ptr(), n_dim,
        p, p + M * k_dim, p + M * k_dim + 4 * M, _DTYPE_CODE[x.dtype],
        _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul", rc, "ternary_matmul_w2a8_normed")
    return out, scratch


def _w2a8_normed_cuda(l, x, packed, scale_vec, gamma, k_dim, n_dim, eps, glu,
                      resid):
    """K1 with its integer parts: (out, xq [M, K], sx [M], sumq [M]), so a
    test can hold them against the plain version.  Counts no launch."""
    out, scratch = _w2a8_normed_launch(l, x, packed, scale_vec, gamma, k_dim,
                                       n_dim, eps, glu, resid)
    M, MK = x.shape[0], x.shape[0] * k_dim
    return (out, scratch[:MK].view(M, k_dim),
            scratch[MK:MK + 4 * M].view(torch.float32),
            scratch[MK + 4 * M:].view(torch.int32))


ternary_matmul_w2a8_normed.launches = 0


def ternary_matmul_w2a8(l: int, x: torch.Tensor, packed: torch.Tensor,
                        scale_vec: torch.Tensor, k_dim: int,
                        n_dim: int) -> torch.Tensor:
    """K4: ``quantize(x) @ W[l]`` for prefill rows (any M).  x [M, K]
    bf16/f32, already normed/activated; returns [M, n_dim] in x's dtype.
    The per-row int8 quantization runs here in plain PyTorch (the JAX
    package runs it in XLA); the kernel does the integer GEMM and the
    epilogue."""
    L, Np = _check_stack(packed, scale_vec, l, k_dim)
    if x.ndim != 2 or x.shape[1] != k_dim:
        raise ValueError(f"x must be [M, {k_dim}], got {tuple(x.shape)}")
    if n_dim > Np:
        raise ValueError(f"n_dim {n_dim} > Np {Np}")
    xq, sx, sumq = quantize_rows(x.to(torch.float32))
    if x.device.type == "cpu":
        return ternary_matmul_w2a8_plain(xq, sumq, sx, packed[l], scale_vec[l],
                                         n_dim, x.dtype)
    if not x.is_cuda or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K4 takes CUDA bf16/f32 x, got {x.device} {x.dtype}")
    if packed.get_device() != x.get_device() or scale_vec.get_device() != x.get_device():
        raise ValueError("K4 operands must be on x's device")
    M = x.shape[0]
    out = torch.empty((M, n_dim), dtype=x.dtype, device=x.device)
    lib = _cuda.library("ternary_matmul")
    rc = lib.bn_w2a8_gemm(
        xq.data_ptr(), M, k_dim, packed.data_ptr() + 4 * l * packed.stride(0),
        Np, sumq.data_ptr(), sx.data_ptr(), scale_vec.data_ptr() + 4 * l * Np,
        out.data_ptr(), n_dim,
        _DTYPE_CODE[x.dtype], _cuda.stream_ptr(x.device))
    _cuda.check(lib, "ternary_matmul", rc, "ternary_matmul_w2a8")
    ternary_matmul_w2a8.launches += 1
    return out


ternary_matmul_w2a8.launches = 0
