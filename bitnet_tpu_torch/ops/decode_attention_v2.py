"""The stacked decode-attention kernels of the fused path and the KV row
scatter: the CUDA kernels and their plain versions.

- K2 :func:`decode_attention_qkv` replaces ``decode_attention_qkv_v2_stacked``
  (``bitnet_tpu/ops/decode_attention_v2.py:859``, body ``_v2_qkv_kernel``
  ``:318`` with ``quant=False``): B ≤ 2, bf16 or f32 cache.
- K7 :func:`decode_attention_qkv_quant` replaces
  ``decode_attention_qkv_quant_v2_stacked`` (``:949``, pallas_call
  ``:1021``): K2 over an int8 / fp8-e4m3 cache, quantizing the new rows.
- K8 :func:`decode_attention_batched` replaces
  ``decode_attention_batched_v2_stacked`` (``:675``, pallas_call ``:735``):
  pools B = 3…64, RoPE outside, bf16 or f32 cache.  Its function is K5's, so it
  launches K5's CUDA kernel under its own wrapper and counter.
- K9 :func:`decode_attention_quant_batched` replaces
  ``decode_attention_quant_batched_v2_stacked`` (``:754``, pallas_call
  ``:820``): K8 over an int8 / fp8-e4m3 cache.
- K3 :func:`scatter_kv_rows` replaces ``scatter_kv_rows`` (``:1068``,
  pallas_call ``:1113``), for bf16, f32 and 1-byte caches.
- K20 / K21 :func:`decode_attention_qkv_batched_v2` /
  :func:`decode_attention_qkv_quant_batched_v2` replace the unstacked
  rope-fused v2 wrappers (``:453`` / ``:542``, pallas_call ``:487`` /
  ``:582``; plans ``qkv_batched_v2`` / ``qkv_quant_batched_v2``): K2's and
  K7's functions for pools.
- K22 / K23 :func:`decode_attention_batched_v2` /
  :func:`decode_attention_quant_batched_v2` replace the unstacked v2
  wrappers (``:1159`` / ``:1239``, pallas_call ``:1193`` / ``:1291``; plans
  ``batched_v2`` / ``quant_batched_v2`` under ``BITNET_ATTN_STACKED=0``):
  K8's and K9's functions.
- K27 :func:`decode_attention_perb_v2` replaces ``decode_attention_perb_v2``
  (``:249``, pallas_call ``:278``; ``experiments/exp_r4_attn.py`` variant
  ``v2p``): K8's function on a per-b grid over a 4-D cache with no layer
  axis.

Every one launches the split-S kernel of ``csrc/decode_attention.cu``
(``ops/decode_attention.py`` says why one kernel computes them all) under
its own counter.  All take the full flat cache stack ``[L, B, S, KV*D]`` and a layer index,
as the JAX wrappers do.  A quantized cache keeps its f32 scales in the
canonical ``[L, B, S, KV]`` layout of ``bitnet_tpu/engine/cache.py``; the
kernels read them with strides, so nothing transposes them per step (the
JAX decode loop swaps their axes every step, ``models/bitnet.py:853-854``,
to feed the TPU kernels' lane layout).
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_attention import (FLOAT_CODE, QUANT_CODE, pick_chunk,
                               pick_group, qkv_attention_plain, qkv_call,
                               split_attention_plain, split_call, v1_chunk)
# the KV quantization round trip, where slice 3's callers import it from
from .decode_attention import dequantize_kv, quantize_kv  # noqa: F401


def decode_attention_qkv_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv):
    """K2 on one layer: qkv [B, H+2KV, D]; caches [B, S, KV*D] (PRE-write);
    pos [B] valid rows; the TPU kernel's chunks (``_pick_chunk``).  Returns
    (attn [B, H, D] in qkv's dtype, k_row, v_row [B, KV, D] in the cache
    dtype)."""
    B, S = qkv.shape[0], k_cache_l.shape[1]
    return qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv,
                               pick_chunk(S, B, k_cache_l.element_size()))


def decode_attention_qkv(l: int, qkv: torch.Tensor, sin_row: torch.Tensor,
                         cos_row: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor,
                         n_heads: int, n_kv: int):
    """K2 over layer ``l`` of the flat stacks [L, B, S, KV*D].

    qkv [B, H+2KV, D] (raw projection, bf16/f32); sin/cos rows [B, D/2]
    f32; pos [B] int32 = rows already in the cache (read before this
    step's write).  Returns (attn [B, H, D], k_row, v_row [B, KV, D])."""
    return qkv_call(decode_attention_qkv, "K2", decode_attention_qkv_plain, l,
                    qkv, sin_row, cos_row, k_cache, v_cache, pos, n_heads, n_kv)


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
    B, S = qkv.shape[0], k_cache_l.shape[1]
    return qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv, pick_chunk(S, B, 1),
                               k_scale_l, v_scale_l)


def decode_attention_qkv_quant(l: int, qkv: torch.Tensor, sin_row: torch.Tensor,
                               cos_row: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, pos: torch.Tensor,
                               n_heads: int, n_kv: int):
    """K7 over layer ``l`` of the flat int8/fp8 stacks [L, B, S, KV*D] and
    their f32 scale stacks [L, B, S, KV]; the rest as K2.  Returns (attn
    [B, H, D], k_q, v_q [B, KV, D] codes, k_s, v_s [B, KV] f32)."""
    return qkv_call(decode_attention_qkv_quant, "K7",
                    decode_attention_qkv_quant_plain, l, qkv, sin_row, cos_row,
                    k_cache, v_cache, pos, n_heads, n_kv, k_scale, v_scale)


decode_attention_qkv_quant.launches = 0


def decode_attention_batched_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos):
    """K8 on one layer, as ``_v2_kernel`` computes it: K5's function (q,
    k_new, v_new cast to the cache dtype, the new token folded in first,
    bf16 softmax weights) with the v2 chunking of ``_pick_chunk`` for the
    wrapper's batch group.  Returns [B, H, D] in q's dtype."""
    B, S = q.shape[0], k_cache_l.shape[1]
    return split_attention_plain(
        q, k_new, v_new, k_cache_l, v_cache_l, pos,
        pick_chunk(S, pick_group(B)[0], k_cache_l.element_size()))


def decode_attention_batched(l: int, q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K8 over layer ``l`` of the flat bf16 / f32 stacks [L, B, S, KV*D] for a
    pool of B slots: q [B, H, D] roped, k_new / v_new [B, KV, D] (k
    roped), one dtype (bf16/f32); pos [B] int32 rows already cached.
    Returns attn [B, H, D] in q's dtype."""
    return split_call(decode_attention_batched, "K8",
                      decode_attention_batched_plain, l, q, k_new, v_new,
                      k_cache, v_cache, pos)


decode_attention_batched.launches = 0


def decode_attention_quant_batched_plain(q, k_new, v_new, k_cache_l, v_cache_l,
                                         k_scale_l, v_scale_l, pos):
    """K9 on one layer, as ``_v2_kernel`` with ``quant=True``: q, k_new and
    v_new (the round-tripped rows) cast to bf16 (``:781-784``); the cache's
    codes read as bf16, scores scaled by the k scales after the dot, the
    weights by the v scales before their bf16 rounding; the TPU kernel's
    chunks.  Returns [B, H, D] in q's dtype."""
    B, S = q.shape[0], k_cache_l.shape[1]
    return split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos,
                                 pick_chunk(S, pick_group(B)[0], 1), k_scale_l,
                                 v_scale_l)


def decode_attention_quant_batched(l: int, q: torch.Tensor, k_new: torch.Tensor,
                                   v_new: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, k_scale: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """K9 over layer ``l`` of the flat int8/fp8 stacks [L, B, S, KV*D] and
    their f32 scale stacks [L, B, S, KV]; the rest as K8."""
    return split_call(decode_attention_quant_batched, "K9",
                      decode_attention_quant_batched_plain, l, q, k_new, v_new,
                      k_cache, v_cache, pos, k_scale, v_scale)


decode_attention_quant_batched.launches = 0


# --------------------------------------------------------------------------
# the per-layer-slice v2 kernels: K20, K21 (BITNET_BATCHED_ATTN=v2qkv),
# K22, K23 (BITNET_ATTN_STACKED=0)
# --------------------------------------------------------------------------
# K20–K23's plain versions are K2's, K7's, K8's and K9's: the unstacked v2
# wrappers pick their chunks (and K22 / K23 their batch groups) by the same
# rules as the stacked ones
decode_attention_qkv_batched_v2_plain = decode_attention_qkv_plain
decode_attention_qkv_quant_batched_v2_plain = decode_attention_qkv_quant_plain
decode_attention_batched_v2_plain = decode_attention_batched_plain
decode_attention_quant_batched_v2_plain = decode_attention_quant_batched_plain


def decode_attention_qkv_batched_v2(l: int, qkv: torch.Tensor,
                                    sin_row: torch.Tensor, cos_row: torch.Tensor,
                                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                                    pos: torch.Tensor, n_heads: int, n_kv: int):
    """K20 ← ``decode_attention_qkv_batched_v2``
    (``bitnet_tpu/ops/decode_attention_v2.py:453``, pallas_call ``:487``):
    the arguments and results of K2, for pools (2 < B ≤ 16 by the plan)."""
    return qkv_call(decode_attention_qkv_batched_v2, "K20",
                    decode_attention_qkv_batched_v2_plain, l, qkv, sin_row,
                    cos_row, k_cache, v_cache, pos, n_heads, n_kv)


decode_attention_qkv_batched_v2.launches = 0


def decode_attention_qkv_quant_batched_v2(l: int, qkv: torch.Tensor,
                                          sin_row: torch.Tensor,
                                          cos_row: torch.Tensor,
                                          k_cache: torch.Tensor,
                                          v_cache: torch.Tensor,
                                          k_scale: torch.Tensor,
                                          v_scale: torch.Tensor,
                                          pos: torch.Tensor, n_heads: int,
                                          n_kv: int):
    """K21 ← ``decode_attention_qkv_quant_batched_v2`` (``:542``,
    pallas_call ``:582``): the arguments and results of K7, for pools."""
    return qkv_call(decode_attention_qkv_quant_batched_v2, "K21",
                    decode_attention_qkv_quant_batched_v2_plain, l, qkv,
                    sin_row, cos_row, k_cache, v_cache, pos, n_heads, n_kv,
                    k_scale, v_scale)


decode_attention_qkv_quant_batched_v2.launches = 0


def decode_attention_batched_v2(l: int, q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor,
                                pos: torch.Tensor) -> torch.Tensor:
    """K22 ← ``decode_attention_batched_v2`` (``:1159``, pallas_call
    ``:1193``): K8 on one layer slice (the JAX loop under
    ``BITNET_ATTN_STACKED=0``); the arguments of K8."""
    return split_call(decode_attention_batched_v2, "K22",
                      decode_attention_batched_v2_plain, l, q, k_new, v_new,
                      k_cache, v_cache, pos)


decode_attention_batched_v2.launches = 0


def decode_attention_quant_batched_v2(l: int, q: torch.Tensor,
                                      k_new: torch.Tensor, v_new: torch.Tensor,
                                      k_cache: torch.Tensor,
                                      v_cache: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      pos: torch.Tensor) -> torch.Tensor:
    """K23 ← ``decode_attention_quant_batched_v2`` (``:1239``, pallas_call
    ``:1291``): K9 on one layer slice; the arguments of K9."""
    return split_call(decode_attention_quant_batched_v2, "K23",
                      decode_attention_quant_batched_v2_plain, l, q, k_new,
                      v_new, k_cache, v_cache, pos, k_scale, v_scale)


decode_attention_quant_batched_v2.launches = 0


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
    f32, int8 or fp8); for a quantized cache the scale rows ks_rows/vs_rows
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
    if (not k_cache.is_cuda or dt not in (*FLOAT_CODE, *QUANT_CODE)
            or quant != (dt in QUANT_CODE) or v_cache.dtype != dt
            or k_rows.dtype != dt or v_rows.dtype != dt
            or pos.dtype != torch.int32 or row_bytes % 16
            or (quant and any(t.dtype != torch.float32
                              for t in (k_scale, v_scale, ks_rows, vs_rows)))
            or any(t.get_device() != k_cache.get_device()
                   or not t.is_contiguous() for t in tensors)):
        raise ValueError("K3 takes contiguous CUDA bf16 / f32 (or int8/fp8 "
                         "with f32 scales) caches and rows of one dtype, int32 "
                         "pos and rows of a multiple of 16 bytes")
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


# --------------------------------------------------------------------------
# K27: the per-b v2 kernel (experiments/exp_r4_attn.py variant v2p)
# --------------------------------------------------------------------------
PERB_V2_CHUNK = 512   # the per-b v2 kernel's largest chunk (``:270``)


def decode_attention_perb_v2_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos):
    """K27 on one layer [B, S, KV*D]: K5's function (``_v2p_kernel``: q and
    the new rows cast to the cache dtype, the new token folded in first)
    over chunks of min(512, S) rows; the chunks at or past pos that the TPU
    kernel skips add exactly nothing here."""
    return split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos,
                                 v1_chunk(k_cache_l.shape[1], PERB_V2_CHUNK))


def decode_attention_perb_v2(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K27 ← ``decode_attention_perb_v2``
    (``bitnet_tpu/ops/decode_attention_v2.py:249``, pallas_call ``:278``):
    the v2 body on a per-b grid over one layer's cache [B, S, KV, D] (bf16
    or f32, PRE-write, no layer axis); q [B, H, D] roped, k_new / v_new
    [B, KV, D]; pos [B] int32.  Returns [B, H, D] in q's dtype."""
    if k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"caches must be one [B, S, KV, D] shape; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, KV, D = k_cache.shape
    return split_call(decode_attention_perb_v2, "K27",
                      decode_attention_perb_v2_plain, 0, q, k_new, v_new,
                      k_cache.view(1, B, S, KV * D),
                      v_cache.view(1, B, S, KV * D), pos)


decode_attention_perb_v2.launches = 0
