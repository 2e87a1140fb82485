"""The stacked decode-attention kernels of the fused path and the KV row
scatter: the CUDA kernels and their plain versions.

- K2 :func:`decode_attention_qkv` replaces ``decode_attention_qkv_v2_stacked``
  (``bitnet_tpu/ops/decode_attention_v2.py:859``, body ``_v2_qkv_kernel``
  ``:318`` with ``quant=False``): B ≤ 2, bf16 cache.
- K7 :func:`decode_attention_qkv_quant` replaces
  ``decode_attention_qkv_quant_v2_stacked`` (``:949``, pallas_call
  ``:1021``): K2 over an int8 / fp8-e4m3 cache, quantizing the new rows.
- K8 :func:`decode_attention_batched` replaces
  ``decode_attention_batched_v2_stacked`` (``:675``, pallas_call ``:735``):
  pools B = 3…64, RoPE outside, bf16 cache.  Its function is K5's, so it
  launches K5's CUDA kernel under its own wrapper and counter.
- K9 :func:`decode_attention_quant_batched` replaces
  ``decode_attention_quant_batched_v2_stacked`` (``:754``, pallas_call
  ``:820``): K8 over an int8 / fp8-e4m3 cache.
- K3 :func:`scatter_kv_rows` replaces ``scatter_kv_rows`` (``:1068``,
  pallas_call ``:1113``), for bf16 and 1-byte caches.

All take the full flat cache stack ``[L, B, S, KV*D]`` and a layer index,
as the JAX wrappers do.  A quantized cache keeps its f32 scales in the
canonical ``[L, B, S, KV]`` layout of ``bitnet_tpu/engine/cache.py``; the
kernels read them with strides, so nothing transposes them per step (the
JAX decode loop swaps their axes every step, ``models/bitnet.py:853-854``,
to feed the TPU kernels' lane layout).
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_attention import (QUANT_CODE, SPLIT, _DTYPE_CODE, NEG_INF,
                               check_layer_args, launch_split_attention,
                               new_token_init, online_softmax_plain)

DEFAULT_CHUNK = 1024


def quantize_kv(x: torch.Tensor, dtype: torch.dtype):
    """Per-vector absmax quantization of KV rows (``_quantize_kv``,
    ``bitnet_tpu/models/bitnet.py:1171-1182``): x [..., D] → (codes in
    ``dtype``, scale [...] f32) with scale = max(absmax, 1e-8) / qmax
    (127 for int8, 448 for fp8-e4m3) and codes x / scale, rounded half to
    even and clipped to ±127 for int8."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, an f32 ulp away from the quotient the kernels and
    # the reference compute
    qmax = absmax.new_full((), 127.0 if dtype == torch.int8 else 448.0)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    q = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(dtype), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes [..., D] × scale [...] → f32 rows (the round trip)."""
    return codes.to(torch.float32) * scale[..., None]


def pick_group(B: int) -> tuple[int, int]:
    """The JAX wrappers' batch groups (``_pick_group``, ``:1130``): the
    TPU's VMEM scope holds at most 16 slots' scratch.  The CUDA kernels
    need no groups; the plain versions use the group size only to choose
    the TPU kernels' chunk."""
    if B <= 16:
        return B, 1
    for bg in (8, 4, 2, 1):
        if B % bg == 0:
            return bg, B // bg
    return 1, B


def pick_chunk(S: int, B: int, itemsize: int) -> int:
    """The cache rows a TPU grid step reads (``_pick_chunk``, ``:1145``):
    the chunk the JAX kernels round their softmax weights against."""
    rows = 2048 if itemsize >= 2 else 4096
    chunk = min(max(128, 1 << ((rows // B).bit_length() - 1)), S, DEFAULT_CHUNK)
    while S % chunk:
        chunk //= 2
    return chunk


def _rope_rows(rows: torch.Tensor, sin_row: torch.Tensor,
               cos_row: torch.Tensor) -> torch.Tensor:
    """Split-layout RoPE of [B, n, D] f32 rows by [B, D/2] tables, written
    as the JAX kernel does: x·[cos,cos] + [-x_hi, x_lo]·[sin,sin]."""
    half = rows.shape[-1] // 2
    cs = torch.cat([cos_row, cos_row], dim=-1)[:, None, :]
    sn = torch.cat([sin_row, sin_row], dim=-1)[:, None, :]
    rot = torch.cat([-rows[..., half:], rows[..., :half]], dim=-1)
    return rows * cs + rot * sn


def decode_attention_qkv_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv):
    """K2 on one layer: qkv [B, H+2KV, D]; caches [B, S, KV*D] (PRE-write);
    pos [B] valid rows.  Returns (attn [B, H, D] in qkv's dtype, k_row,
    v_row [B, KV, D] in the cache dtype)."""
    B, _, D = qkv.shape
    H, KV = n_heads, n_kv
    G = H // KV
    S = k_cache_l.shape[1]
    cdt = k_cache_l.dtype
    scale = float(D) ** -0.5
    rows = qkv.to(torch.float32)
    qk = _rope_rows(rows[:, : H + KV], sin_row, cos_row)
    q = qk[:, :H].reshape(B, KV, G, D)                      # f32 roped
    k_new = qk[:, H:]                                       # [B, KV, D] f32
    v_new = rows[:, H + KV:]
    # the new token initializes the online softmax (f32 rows)
    m0 = (q * k_new[:, :, None, :]).sum(-1) * scale          # [B, KV, G]
    kc = k_cache_l.reshape(B, S, KV, D)
    vc = v_cache_l.reshape(B, S, KV, D)
    s = torch.einsum("bkgd,bskd->bkgs", q.to(cdt).float(), kc.float()) * scale
    valid = torch.arange(S, device=qkv.device)[None, :] < pos[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.maximum(m0, s.amax(-1))
    alpha = torch.exp(m0 - m)
    e = torch.exp(s - m[..., None])
    d = alpha + e.sum(-1)
    ctx = (v_new[:, :, None, :] * alpha[..., None]
           + torch.einsum("bkgs,bskd->bkgd", e.to(cdt).float(), vc.float()))
    attn = (ctx / d[..., None]).reshape(B, H, D).to(qkv.dtype)
    return attn, k_new.to(cdt), v_new.to(cdt)


def _check_qkv_args(l, qkv, sin_row, cos_row, k_cache, v_cache, n_heads, n_kv):
    B, R, D = qkv.shape
    L, Bc, S, KVD = k_cache.shape
    if R != n_heads + 2 * n_kv or KVD != n_kv * D or Bc != B:
        raise ValueError(f"shape mismatch: qkv {tuple(qkv.shape)}, cache "
                         f"{tuple(k_cache.shape)}, H={n_heads} KV={n_kv}")
    if tuple(v_cache.shape) != tuple(k_cache.shape) or not 0 <= l < L:
        raise ValueError("v_cache must match k_cache; l in range")
    if tuple(sin_row.shape) != (B, D // 2) or tuple(cos_row.shape) != (B, D // 2):
        raise ValueError(f"sin/cos rows must be [{B}, {D // 2}]")


def _launch_qkv(what, l, qkv, sin_row, cos_row, k_cache, v_cache, pos,
                n_heads, n_kv, k_scale=None, v_scale=None):
    """K2 (bf16 cache) or K7 (int8/fp8 cache with its scale stacks)."""
    B, _, D = qkv.shape
    L, _, S, _ = k_cache.shape
    quant = k_scale is not None
    G = n_heads // n_kv
    cache_ok = (k_cache.dtype in QUANT_CODE if quant
                else k_cache.dtype == torch.bfloat16)
    if (not qkv.is_cuda or qkv.dtype not in _DTYPE_CODE or not cache_ok
            or v_cache.dtype != k_cache.dtype or D not in (64, 128)
            or n_heads % n_kv or G > 8):
        raise ValueError(
            f"{what} takes CUDA bf16/f32 qkv, a "
            f"{'int8/fp8' if quant else 'bf16'} cache, D in (64, 128) and "
            f"H/KV <= 8; got {qkv.device} {qkv.dtype}, {k_cache.dtype}, "
            f"D={D}, H={n_heads}, KV={n_kv}")
    dev_i = qkv.get_device()
    tensors = (qkv, sin_row, cos_row, k_cache, v_cache, pos) + (
        (k_scale, v_scale) if quant else ())
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous on qkv's device")
    if sin_row.dtype != torch.float32 or pos.dtype != torch.int32:
        raise ValueError("sin/cos rows must be f32 and pos int32")
    if quant and (k_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (L, B, S, n_kv)
                  or tuple(v_scale.shape) != (L, B, S, n_kv)):
        raise ValueError(f"{what}: scales must be f32 [{L}, {B}, {S}, {n_kv}]")
    dev = qkv.device
    NS = -(-S // SPLIT)
    out = torch.empty((B, n_heads, D), dtype=qkv.dtype, device=dev)
    rows = torch.empty((2, B, n_kv, D), dtype=k_cache.dtype, device=dev)
    # per-split partials: m/d [B, KV, NS, G, 2] then ctx [B, KV, NS, G, D]
    n_md = B * n_kv * NS * G * 2
    part = torch.empty(n_md + B * n_kv * NS * G * D, dtype=torch.float32,
                       device=dev)
    layer = l * k_cache.stride(0) * k_cache.element_size()   # bytes to layer l
    head = (qkv.data_ptr(), sin_row.data_ptr(), cos_row.data_ptr(),
            k_cache.data_ptr() + layer, v_cache.data_ptr() + layer)
    dims = (pos.data_ptr(), B, n_heads, n_kv, D, S, float(D) ** -0.5,
            out.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr())
    parts = (part.data_ptr(), part.data_ptr() + 4 * n_md, _DTYPE_CODE[qkv.dtype])
    lib = _cuda.library("decode_attention")
    if quant:
        sl = 4 * l * k_scale.stride(0)
        scales = torch.empty((2, B, n_kv), dtype=torch.float32, device=dev)
        rc = lib.bn_decode_attention_qkv_quant(
            *head, k_scale.data_ptr() + sl, v_scale.data_ptr() + sl, *dims,
            scales[0].data_ptr(), scales[1].data_ptr(), *parts,
            QUANT_CODE[k_cache.dtype], _cuda.stream_ptr(dev))
    else:
        rc = lib.bn_decode_attention_qkv(*head, *dims, *parts,
                                         _cuda.stream_ptr(dev))
    _cuda.check(lib, "decode_attention", rc, what)
    if quant:
        return out, rows[0], rows[1], scales[0], scales[1]
    return out, rows[0], rows[1]


def decode_attention_qkv(l: int, qkv: torch.Tensor, sin_row: torch.Tensor,
                         cos_row: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor,
                         n_heads: int, n_kv: int):
    """K2 over layer ``l`` of the flat stacks [L, B, S, KV*D].

    qkv [B, H+2KV, D] (raw projection, bf16/f32); sin/cos rows [B, D/2]
    f32; pos [B] int32 = rows already in the cache (read before this
    step's write).  Returns (attn [B, H, D], k_row, v_row [B, KV, D])."""
    _check_qkv_args(l, qkv, sin_row, cos_row, k_cache, v_cache, n_heads, n_kv)
    if qkv.device.type == "cpu":
        return decode_attention_qkv_plain(qkv, sin_row, cos_row, k_cache[l],
                                          v_cache[l], pos, n_heads, n_kv)
    out = _launch_qkv("K2", l, qkv, sin_row, cos_row, k_cache, v_cache, pos,
                      n_heads, n_kv)
    decode_attention_qkv.launches += 1
    return out


decode_attention_qkv.launches = 0


def decode_attention_qkv_quant_plain(qkv, sin_row, cos_row, k_cache_l,
                                     v_cache_l, k_scale_l, v_scale_l, pos,
                                     n_heads, n_kv):
    """K7 on one layer, as ``_v2_qkv_kernel`` with ``quant=True``
    computes it: RoPE of q and k in f32; the roped k row and the v row
    quantized per kv head (:func:`quantize_kv`); the softmax starts from
    the round-tripped f32 rows (m = q_f32·k_rt/√D, ctx = v_rt) and walks
    the cache in the TPU kernel's chunks.  caches [B, S, KV*D] int8/fp8,
    scales [B, S, KV] f32.  Returns (attn [B, H, D] in qkv's dtype, k_q,
    v_q [B, KV, D] in the cache dtype, k_s, v_s [B, KV] f32)."""
    B, _, D = qkv.shape
    H, KV = n_heads, n_kv
    cdt = k_cache_l.dtype
    rows = qkv.to(torch.float32)
    qk = _rope_rows(rows[:, : H + KV], sin_row, cos_row)
    q = qk[:, :H].reshape(B, KV, H // KV, D)
    kq, ks = quantize_kv(qk[:, H:], cdt)
    vq, vs = quantize_kv(rows[:, H + KV:], cdt)
    k_rt, v_rt = dequantize_kv(kq, ks), dequantize_kv(vq, vs)
    m = (q * k_rt[:, :, None, :]).sum(-1) * float(D) ** -0.5
    ctx = v_rt[:, :, None, :].expand(q.shape).clone()
    chunk = pick_chunk(k_cache_l.shape[1], B, 1)
    out = online_softmax_plain(q.to(torch.bfloat16).to(torch.float32), m, ctx,
                               k_cache_l, v_cache_l, pos, chunk, k_scale_l,
                               v_scale_l)
    return out.reshape(B, H, D).to(qkv.dtype), kq, vq, ks, vs


def decode_attention_qkv_quant(l: int, qkv: torch.Tensor, sin_row: torch.Tensor,
                               cos_row: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, pos: torch.Tensor,
                               n_heads: int, n_kv: int):
    """K7 over layer ``l`` of the flat int8/fp8 stacks [L, B, S, KV*D] and
    their f32 scale stacks [L, B, S, KV]; the rest as K2.  Returns (attn
    [B, H, D], k_q, v_q [B, KV, D] codes, k_s, v_s [B, KV] f32)."""
    _check_qkv_args(l, qkv, sin_row, cos_row, k_cache, v_cache, n_heads, n_kv)
    if qkv.device.type == "cpu":
        return decode_attention_qkv_quant_plain(
            qkv, sin_row, cos_row, k_cache[l], v_cache[l], k_scale[l],
            v_scale[l], pos, n_heads, n_kv)
    out = _launch_qkv("K7", l, qkv, sin_row, cos_row, k_cache, v_cache, pos,
                      n_heads, n_kv, k_scale, v_scale)
    decode_attention_qkv_quant.launches += 1
    return out


decode_attention_qkv_quant.launches = 0


def decode_attention_batched_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos):
    """K8 on one layer, as ``_v2_kernel`` computes it: K5's function (q,
    k_new, v_new cast to the cache dtype, the new token folded in first,
    bf16 softmax weights) with the v2 chunking of ``_pick_chunk`` for the
    wrapper's batch group.  Returns [B, H, D] in q's dtype."""
    B, S = q.shape[0], k_cache_l.shape[1]
    qf, m, ctx = new_token_init(q, k_new, v_new, k_cache_l.dtype)
    chunk = pick_chunk(S, pick_group(B)[0], k_cache_l.element_size())
    out = online_softmax_plain(qf, m, ctx, k_cache_l, v_cache_l, pos, chunk)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_batched(l: int, q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K8 over layer ``l`` of the flat bf16 stacks [L, B, S, KV*D] for a
    pool of B slots: q [B, H, D] roped, k_new / v_new [B, KV, D] (k
    roped), one dtype (bf16/f32); pos [B] int32 rows already cached.
    Returns attn [B, H, D] in q's dtype."""
    check_layer_args(l, q, k_new, v_new, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_batched_plain(q, k_new, v_new, k_cache[l],
                                              v_cache[l], pos)
    out = launch_split_attention("K8", l, q, k_new, v_new, k_cache, v_cache,
                                 pos)
    decode_attention_batched.launches += 1
    return out


decode_attention_batched.launches = 0


def decode_attention_quant_batched_plain(q, k_new, v_new, k_cache_l, v_cache_l,
                                         k_scale_l, v_scale_l, pos):
    """K9 on one layer, as ``_v2_kernel`` with ``quant=True``: q, k_new and
    v_new (the round-tripped rows) cast to bf16 (``:781-784``); the cache's
    codes read as bf16, scores scaled by the k scales after the dot, the
    weights by the v scales before their bf16 rounding; the TPU kernel's
    chunks.  Returns [B, H, D] in q's dtype."""
    B, S = q.shape[0], k_cache_l.shape[1]
    qf, m, ctx = new_token_init(q, k_new, v_new, torch.bfloat16)
    chunk = pick_chunk(S, pick_group(B)[0], 1)
    out = online_softmax_plain(qf, m, ctx, k_cache_l, v_cache_l, pos, chunk,
                               k_scale_l, v_scale_l)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_quant_batched(l: int, q: torch.Tensor, k_new: torch.Tensor,
                                   v_new: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, k_scale: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """K9 over layer ``l`` of the flat int8/fp8 stacks [L, B, S, KV*D] and
    their f32 scale stacks [L, B, S, KV]; the rest as K8."""
    check_layer_args(l, q, k_new, v_new, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_quant_batched_plain(
            q, k_new, v_new, k_cache[l], v_cache[l], k_scale[l], v_scale[l], pos)
    out = launch_split_attention("K9", l, q, k_new, v_new, k_cache, v_cache,
                                 pos, k_scale, v_scale)
    decode_attention_quant_batched.launches += 1
    return out


decode_attention_quant_batched.launches = 0


def scatter_kv_rows_plain(k_cache, v_cache, k_rows, v_rows, pos,
                          k_scale=None, v_scale=None, ks_rows=None,
                          vs_rows=None):
    """K3: write rows [L, B, 1, KVD] (and a quantized cache's scale rows
    [L, B, 1, KV]) at min(pos[b], S-1), in place."""
    S = k_cache.shape[2]
    p = torch.clamp(pos.to(torch.int64), max=S - 1)
    b = torch.arange(k_cache.shape[1], device=k_cache.device)
    k_cache[:, b, p] = k_rows[:, :, 0].to(k_cache.dtype)
    v_cache[:, b, p] = v_rows[:, :, 0].to(v_cache.dtype)
    if k_scale is not None:
        k_scale[:, b, p] = ks_rows[:, :, 0]
        v_scale[:, b, p] = vs_rows[:, :, 0]
    return k_cache, v_cache


def scatter_kv_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_rows: torch.Tensor, v_rows: torch.Tensor,
                    pos: torch.Tensor, k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    ks_rows: torch.Tensor | None = None,
                    vs_rows: torch.Tensor | None = None):
    """K3: one new row per (layer, batch slot) into the flat caches
    [L, B, S, KVD], in place, at ``min(pos[b], S-1)`` — a pos ≥ S
    overwrites row S-1 of that slot (``models/bitnet.py:978-991`` of the
    JAX package).  k_rows/v_rows [L, B, 1, KVD] in the cache dtype (bf16,
    int8 or fp8); for a quantized cache the scale rows ks_rows/vs_rows
    [L, B, 1, KV] go into the scale stacks [L, B, S, KV] beside them, with
    the same clamp (``:954-963``)."""
    L, B, S, KVD = k_cache.shape
    quant = k_scale is not None
    if (tuple(k_rows.shape) != (L, B, 1, KVD)
            or tuple(v_rows.shape) != (L, B, 1, KVD)
            or tuple(v_cache.shape) != (L, B, S, KVD) or pos.shape != (B,)):
        raise ValueError("scatter_kv_rows shape mismatch")
    KV = k_scale.shape[3] if quant else 0
    if quant and (tuple(k_scale.shape) != (L, B, S, KV)
                  or tuple(v_scale.shape) != (L, B, S, KV)
                  or tuple(ks_rows.shape) != (L, B, 1, KV)
                  or tuple(vs_rows.shape) != (L, B, 1, KV)):
        raise ValueError("scatter_kv_rows scale shape mismatch")
    if k_cache.device.type == "cpu":
        return scatter_kv_rows_plain(k_cache, v_cache, k_rows, v_rows, pos,
                                     k_scale, v_scale, ks_rows, vs_rows)
    tensors = (k_cache, v_cache, k_rows, v_rows, pos) + (
        (k_scale, v_scale, ks_rows, vs_rows) if quant else ())
    dt = k_cache.dtype
    row_bytes = KVD * k_cache.element_size()
    if (not k_cache.is_cuda or dt not in (torch.bfloat16, *QUANT_CODE)
            or quant != (dt in QUANT_CODE) or v_cache.dtype != dt
            or k_rows.dtype != dt or v_rows.dtype != dt
            or pos.dtype != torch.int32 or row_bytes % 16
            or (quant and any(t.dtype != torch.float32
                              for t in (k_scale, v_scale, ks_rows, vs_rows)))
            or any(t.get_device() != k_cache.get_device()
                   or not t.is_contiguous() for t in tensors)):
        raise ValueError("K3 takes contiguous CUDA bf16 (or int8/fp8 with f32 "
                         "scales) caches and rows of one dtype, int32 pos and "
                         "rows of a multiple of 16 bytes")
    ptr = (lambda t: t.data_ptr()) if quant else (lambda t: None)
    lib = _cuda.library("decode_attention")
    rc = lib.bn_scatter_kv_rows(
        k_cache.data_ptr(), v_cache.data_ptr(), k_rows.data_ptr(),
        v_rows.data_ptr(), ptr(k_scale), ptr(v_scale), ptr(ks_rows),
        ptr(vs_rows), pos.data_ptr(), L, B, S, row_bytes, KV,
        _cuda.stream_ptr(k_cache.device))
    _cuda.check(lib, "decode_attention", rc, "scatter_kv_rows")
    scatter_kv_rows.launches += 1
    return k_cache, v_cache


scatter_kv_rows.launches = 0
