"""The W2A8 probes and prototype as kernels on the card (K28–K32).

Counterparts of the six Pallas sites of ``experiments/exp_w2a8.py``; the
entry point that runs them as the script does is
:mod:`bitnet_tpu_torch.experiments.exp_w2a8`.  The probes ask whether the
facts behind K1's word layout hold (in plane p, ``(w >> 2p) & 0x03030303``
holds the K rows p·64+4s … p·64+4s+3, one dp4a operand or one 4-byte
slice of an int8 MMA fragment):

- K28 :func:`bitcast_i32_to_i8` ← ``p1_bitcast_order`` (``:55``): the byte
  order of an int32 word read as 4 int8 by dp4a, row 4s+j = byte j of word
  row s.
- K29 :func:`int8_dot` ← ``p2_int8_dot`` (``:75``, ``:84``): int8 × int8 →
  int32 through ``__dp4a`` and through the tensor cores' ``mma.sync``
  m16n8k32 s8, one launch that stages a block's rows and columns in shared
  memory (B transposed to K-major) before any step.
- K30 :func:`bytes_to_bf16` ← ``p3_i8_to_bf16`` (``:99``): the bytes as
  int8, converted to bf16.
- K31 :func:`unpack_words` ← ``p4_unpack_chain`` (``:146``): the shift /
  mask / bias chain that inverts :func:`pack_w2a8_host`.
- K32 :func:`w2a8_matmul` ← ``w2a8_matmul`` (``:181``, pallas_call
  ``:201``): the prototype GEMM with a per-tensor scale, as K4's two
  launches (``csrc/ternary_matmul.cu`` ``bn_w2a8_matmul``: K4's row kernel,
  then its wgmma GEMM in the per-tensor-scale mode, tiled by
  :func:`~.ternary_matmul.w2a8_gemm_plan`).  ``bm``, ``bn`` and ``bkt`` are
  TPU tiles that select nothing on the card; the shapes where the TPU
  kernel computes something else (``N % bn`` leaves columns uncomputed,
  ``K % (256·bkt)`` drops K rows: seen in interpret mode) raise, so it
  never returns uncomputed columns.

Each wrapper runs its plain version on CPU tensors and launches its kernel
(K28–K31 in ``csrc/exp_w2a8.cu``) on CUDA tensors, counting the launch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .ternary_matmul import (_DTYPE_CODE, _sm_count, biased_codes, int8_matmul,
                             quantize_rows, w2a8_gemm_plan)

MASK2, MASK1 = 0x03030303, 0x01010101


def _check_words(words: torch.Tensor, what: str):
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError(f"{what} takes contiguous int32 words [R, C]; got "
                         f"{words.dtype} {tuple(words.shape)}")


def _launch(what, fn, *args, device):
    lib = _cuda.library("exp_w2a8")
    rc = getattr(lib, fn)(*args, _cuda.stream_ptr(device))
    _cuda.check(lib, "exp_w2a8", rc, what)


def bitcast_i32_to_i8_plain(words: torch.Tensor) -> torch.Tensor:
    """[R, C] int32 → [4R, C] int8, row 4s+j = byte j (little-endian) of
    word row s: ``pltpu.bitcast`` as P1 found it."""
    R, C = words.shape
    return words.view(torch.int8).view(R, C, 4).permute(0, 2, 1).reshape(4 * R, C)


def bitcast_i32_to_i8(words: torch.Tensor) -> torch.Tensor:
    """K28: each word's bytes as dp4a reads them, to rows 4s+j."""
    _check_words(words, "K28")
    if words.device.type == "cpu":
        return bitcast_i32_to_i8_plain(words)
    R, C = words.shape
    out = torch.empty((4 * R, C), dtype=torch.int8, device=words.device)
    _launch("bitcast_i32_to_i8", "bn_probe_bytes", words.data_ptr(),
            out.data_ptr(), R, C, device=words.device)
    bitcast_i32_to_i8.launches += 1
    return out


bitcast_i32_to_i8.launches = 0


def int8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] × int8 [K, N] → int32 [M, N], exact (int32 sums)."""
    return int8_matmul(a, b)


def int8_dot(a: torch.Tensor, b: torch.Tensor, unit: str = "mma") -> torch.Tensor:
    """K29: int8 [M, K] × int8 [K, N] → int32 through ``__dp4a`` (``unit``
    "dp4a", K % 4 == 0) or the int8 MMA (``"mma"``: M % 16, N % 8, K %
    32 == 0)."""
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2
            or b.dim() != 2 or a.shape[1] != b.shape[0]):
        raise ValueError(f"K29 takes int8 [M, K] and [K, N]; got {a.dtype} "
                         f"{tuple(a.shape)}, {b.dtype} {tuple(b.shape)}")
    if unit not in ("dp4a", "mma"):
        raise ValueError(f"unit must be 'dp4a' or 'mma', got {unit!r}")
    if a.device.type == "cpu":
        return int8_dot_plain(a, b)
    out = _int8_dot_cuda(a, b, unit)
    int8_dot.launches += 1
    return out


def _int8_dot_cuda(a: torch.Tensor, b: torch.Tensor, unit: str) -> torch.Tensor:
    """K29's one launch on CUDA tensors (raises on any other); counts
    nothing."""
    (M, K), N = a.shape, b.shape[1]
    if (not (a.is_cuda and b.is_cuda) or a.get_device() != b.get_device()
            or not (a.is_contiguous() and b.is_contiguous())
            or (unit == "mma" and (M % 16 or N % 8 or K % 32)) or K % 4):
        raise ValueError(f"K29 ({unit}) takes contiguous int8 CUDA tensors on one "
                         f"device; shape or layout not taken: {a.device} "
                         f"{tuple(a.shape)} x {b.device} {tuple(b.shape)}")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    _launch("int8_dot", "bn_probe_dot", a.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, K, N, int(unit == "mma"), device=a.device)
    return out


int8_dot.launches = 0


def bytes_to_bf16_plain(words: torch.Tensor) -> torch.Tensor:
    """[R, C] int32 → [4R, C] bf16: the bytes as int8, converted."""
    return bitcast_i32_to_i8_plain(words).to(torch.bfloat16)


def bytes_to_bf16(words: torch.Tensor) -> torch.Tensor:
    """K30: the words' bytes as int8, converted to bf16, rows 4s+j."""
    _check_words(words, "K30")
    if words.device.type == "cpu":
        return bytes_to_bf16_plain(words)
    R, C = words.shape
    out = torch.empty((4 * R, C), dtype=torch.bfloat16, device=words.device)
    _launch("bytes_to_bf16", "bn_probe_bf16", words.data_ptr(), out.data_ptr(),
            R, C, device=words.device)
    bytes_to_bf16.launches += 1
    return out


bytes_to_bf16.launches = 0


def unpack_words_plain(words: torch.Tensor) -> torch.Tensor:
    """[R, C] int32 → [16R, C] int8 biased codes {0, 1, 3, 4}: for each
    plane p, t = (w >> 2p) & 0x03030303, t + ((t >> 1) & 0x01010101),
    bitcast to rows, planes concatenated (``_unpack_w2a8_words``)."""
    planes = []
    for p in range(4):
        t = (words >> (2 * p)) & MASK2
        planes.append(bitcast_i32_to_i8_plain(t + ((t >> 1) & MASK1)))
    return torch.cat(planes, dim=0)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """K31: the unpack chain of :func:`unpack_words_plain` on the card."""
    _check_words(words, "K31")
    if words.device.type == "cpu":
        return unpack_words_plain(words)
    R, C = words.shape
    out = torch.empty((16 * R, C), dtype=torch.int8, device=words.device)
    _launch("unpack_words", "bn_probe_unpack", words.data_ptr(), out.data_ptr(),
            R, C, device=words.device)
    unpack_words.launches += 1
    return out


unpack_words.launches = 0


def pack_w2a8_host(codes_kn: np.ndarray) -> np.ndarray:
    """Pack codes [K, N] (K % 256 == 0) → int32 words [K/16, N]: logical
    row r of each 256-row tile → (plane p, word s, byte j) = (r // 64,
    (r % 64) // 4, r % 4), bits 8j + 2p of word s (the script's packer,
    ``:120``; ``ops/linear.fold_packed_words(repack_codes(...))`` gives the
    same words)."""
    K, N = codes_kn.shape
    if K % 256:
        raise ValueError(f"K = {K} is not a multiple of 256")
    words = np.zeros((K // 16, N), np.uint32)
    for r in range(256):
        p, s, j = r // 64, (r % 64) // 4, r % 4
        c = codes_kn[r::256].astype(np.uint32)      # [K/256, N]
        words[s::16] |= c << (8 * j + 2 * p)
    return words.view(np.int32)


def w2a8_quantize_plain(x: torch.Tensor, rows: int):
    """x [M, K] → (codes [rows, K] int8, sx [rows] f32, sumq [rows] int32):
    sx = max(absmax, 1e-8) / 127 (IEEE division), q = clip(round(x / sx),
    ±127), the rows past M zero with sx 1 (the TPU prototype pads to 16
    rows; the card pads none: ``rows`` = M)."""
    M, K = x.shape
    q, sx, sumq = quantize_rows(x.to(torch.float32))
    pad = rows - M
    return (torch.cat([q, q.new_zeros((pad, K))]),
            torch.cat([sx, sx.new_ones((pad,))]),
            torch.cat([sumq, sumq.new_zeros((pad,))]))


def w2a8_matmul_plain(xq, sx, sumq, words, scale, M, out_dtype=torch.bfloat16):
    """K32's arithmetic: ((xq · c) − 2·sumq) · (sx·scale) in f32, where c
    are the words' biased codes in the layout's K order; rows past M
    dropped."""
    acc = int8_matmul(xq, biased_codes(words))
    sxs = sx * sx.new_full((), scale)          # the f32 product, as the prototype's
    y = (acc - 2 * sumq[:, None]).to(torch.float32) * sxs[:, None]
    return y[:M].to(out_dtype)


def _w2a8_matmul_launch(x: torch.Tensor, words: torch.Tensor, scale: float):
    """K32's two launches on CUDA tensors (raises on any other): K4's row
    kernel, then its GEMM in the per-tensor-scale mode, tiled by
    :func:`~.ternary_matmul.w2a8_gemm_plan`.  Returns (out [M, N] bf16,
    scratch): scratch holds the int8 rows, their scales and their sums
    (``xq | sx | sumq``)."""
    (M, K), N = x.shape, words.shape[1]
    if not x.is_cuda or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"K32 takes contiguous f32 / bf16 CUDA x, got {x.device} "
                         f"{x.dtype}")
    if (words.get_device() != x.get_device() or words.dtype != torch.int32
            or not words.is_contiguous() or K % 256 or words.shape[0] != K // 16
            or N % 8):
        raise ValueError("K32: contiguous int32 words [K/16, N] on x's device, K a "
                         "multiple of 256, N a multiple of 8")
    dev = x.device
    bt, split = w2a8_gemm_plan(M, K, N, _sm_count(dev.index))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(M * (K + 8), dtype=torch.int8, device=dev)
    p = scratch.data_ptr()
    lib = _cuda.library("ternary_matmul")
    rc = lib.bn_w2a8_matmul(x.data_ptr(), M, K, words.data_ptr(), N, float(scale),
                            out.data_ptr(), p, p + M * K, p + M * K + 4 * M,
                            _DTYPE_CODE[x.dtype], bt, split, _cuda.stream_ptr(dev))
    _cuda.check(lib, "ternary_matmul", rc, "w2a8_matmul")
    return out, scratch


def _w2a8_matmul_cuda(x: torch.Tensor, words: torch.Tensor, scale: float):
    """K32 with its integer parts: (out [M, N] bf16, codes [M, K], sx [M],
    sumq [M]), so a check can hold them against the plain versions.
    Counts no launch."""
    out, scratch = _w2a8_matmul_launch(x, words, scale)
    M, MK = x.shape[0], x.numel()
    return (out, scratch[:MK].view(x.shape),
            scratch[MK:MK + 4 * M].view(torch.float32),
            scratch[MK + 4 * M:].view(torch.int32))


def w2a8_matmul(x: torch.Tensor, words: torch.Tensor, scale: float,
                bm: int = 16, bn: int = 2560, bkt: int = 4,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K32: x [M, K] f32 / bf16 × words [K/16, N] int32 (the K1 word
    layout) with a per-tensor ``scale`` → [M, N] in ``out_dtype`` (bf16 on
    the card).  ``bm``, ``bn`` and ``bkt`` are the TPU kernel's tiles:
    they select nothing here, and the shapes where the TPU kernel leaves
    columns uncomputed (N % bn) or drops K rows (K % (256·bkt)) raise."""
    if x.dim() != 2 or words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("K32 takes x [M, K] and int32 words [K/16, N]")
    (M, K), N = x.shape, words.shape[1]
    if K % 256 or words.shape[0] != K // 16 or not words.is_contiguous():
        raise ValueError(f"K32: K = {K} must be a multiple of 256 and words "
                         f"[K/16, N] contiguous; got {tuple(words.shape)}")
    if N % bn or K % (256 * bkt):
        raise ValueError(
            f"N = {N} % bn = {bn} or K = {K} % (256 * bkt = {256 * bkt}) is not "
            "0: the TPU kernel leaves those columns uncomputed or drops those "
            "K rows, so the port refuses the shape")
    if x.device.type == "cpu":
        xq, sx, sumq = w2a8_quantize_plain(x, M)
        return w2a8_matmul_plain(xq, sx, sumq, words, scale, M, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"K32 writes bf16, got out_dtype {out_dtype}")
    out = _w2a8_matmul_launch(x, words, scale)[0]
    w2a8_matmul.launches += 1
    return out


w2a8_matmul.launches = 0
