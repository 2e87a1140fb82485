"""Rope-fused decode attention (K2) and the KV row scatter (K3): the CUDA
kernels and their plain versions.

K2 :func:`decode_attention_qkv` replaces ``decode_attention_qkv_v2_stacked``
(``bitnet_tpu/ops/decode_attention_v2.py:859``, body ``_v2_qkv_kernel``
``:318`` with ``quant=False``).  K3 :func:`scatter_kv_rows` replaces
``scatter_kv_rows`` (``:1068``).  Both take the full flat cache stack
``[L, B, S, KV*D]`` (bf16) as the JAX wrappers do.
"""

from __future__ import annotations

import torch

from . import _cuda

NEG_INF = -1e30
SPLIT = 64           # cache rows per block of the CUDA kernel (csrc)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def decode_attention_qkv(l: int, qkv: torch.Tensor, sin_row: torch.Tensor,
                         cos_row: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor,
                         n_heads: int, n_kv: int):
    """K2 over layer ``l`` of the flat stacks [L, B, S, KV*D].

    qkv [B, H+2KV, D] (raw projection, bf16/f32); sin/cos rows [B, D/2]
    f32; pos [B] int32 = rows already in the cache (read before this
    step's write).  Returns (attn [B, H, D], k_row, v_row [B, KV, D])."""
    B, R, D = qkv.shape
    L, Bc, S, KVD = k_cache.shape
    if R != n_heads + 2 * n_kv or KVD != n_kv * D or Bc != B:
        raise ValueError(f"shape mismatch: qkv {tuple(qkv.shape)}, cache "
                         f"{tuple(k_cache.shape)}, H={n_heads} KV={n_kv}")
    if tuple(v_cache.shape) != tuple(k_cache.shape) or not 0 <= l < L:
        raise ValueError("v_cache must match k_cache; l in range")
    if tuple(sin_row.shape) != (B, D // 2) or tuple(cos_row.shape) != (B, D // 2):
        raise ValueError(f"sin/cos rows must be [{B}, {D // 2}]")
    if qkv.device.type == "cpu":
        return decode_attention_qkv_plain(qkv, sin_row, cos_row, k_cache[l],
                                          v_cache[l], pos, n_heads, n_kv)
    G = n_heads // n_kv
    if (not qkv.is_cuda or qkv.dtype not in _DTYPE_CODE
            or k_cache.dtype != torch.bfloat16 or D not in (64, 128)
            or n_heads % n_kv or G > 8):
        raise ValueError(
            f"K2 takes CUDA bf16/f32 qkv, a bf16 cache, D in (64, 128) and "
            f"H/KV <= 8; got {qkv.device} {qkv.dtype}, {k_cache.dtype}, "
            f"D={D}, H={n_heads}, KV={n_kv}")
    dev_i = qkv.get_device()
    tensors = (qkv, sin_row, cos_row, k_cache, v_cache, pos)
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError("K2 operands must be contiguous on qkv's device")
    if sin_row.dtype != torch.float32 or pos.dtype != torch.int32:
        raise ValueError("sin/cos rows must be f32 and pos int32")
    dev = qkv.device
    NS = -(-S // SPLIT)
    out = torch.empty((B, n_heads, D), dtype=qkv.dtype, device=dev)
    rows = torch.empty((2, B, n_kv, D), dtype=k_cache.dtype, device=dev)
    # per-split partials: m/d [B, KV, NS, G, 2] then ctx [B, KV, NS, G, D]
    n_md = B * n_kv * NS * G * 2
    part = torch.empty(n_md + B * n_kv * NS * G * D, dtype=torch.float32,
                       device=dev)
    layer = 2 * l * k_cache.stride(0)                  # bytes to layer l
    lib = _cuda.library("decode_attention")
    rc = lib.bn_decode_attention_qkv(
        qkv.data_ptr(), sin_row.data_ptr(), cos_row.data_ptr(),
        k_cache.data_ptr() + layer, v_cache.data_ptr() + layer, pos.data_ptr(),
        B, n_heads, n_kv, D, S, float(D) ** -0.5, out.data_ptr(),
        rows[0].data_ptr(), rows[1].data_ptr(), part.data_ptr(),
        part.data_ptr() + 4 * n_md, _DTYPE_CODE[qkv.dtype], _cuda.stream_ptr(dev))
    _cuda.check(lib, "decode_attention", rc, "decode_attention_qkv")
    decode_attention_qkv.launches += 1
    return out, rows[0], rows[1]


decode_attention_qkv.launches = 0


def scatter_kv_rows_plain(k_cache, v_cache, k_rows, v_rows, pos):
    """K3: write rows [L, B, 1, KVD] at min(pos[b], S-1), in place."""
    S = k_cache.shape[2]
    p = torch.clamp(pos.to(torch.int64), max=S - 1)
    b = torch.arange(k_cache.shape[1], device=k_cache.device)
    k_cache[:, b, p] = k_rows[:, :, 0].to(k_cache.dtype)
    v_cache[:, b, p] = v_rows[:, :, 0].to(v_cache.dtype)
    return k_cache, v_cache


def scatter_kv_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_rows: torch.Tensor, v_rows: torch.Tensor,
                    pos: torch.Tensor):
    """K3: one new row per (layer, batch slot) into the flat caches
    [L, B, S, KVD], in place, at ``min(pos[b], S-1)`` — a pos ≥ S
    overwrites row S-1 of that slot (``models/bitnet.py:978-991`` of the
    JAX package).  k_rows/v_rows [L, B, 1, KVD] in the cache dtype."""
    L, B, S, KVD = k_cache.shape
    if (tuple(k_rows.shape) != (L, B, 1, KVD)
            or tuple(v_rows.shape) != (L, B, 1, KVD)
            or tuple(v_cache.shape) != (L, B, S, KVD) or pos.shape != (B,)):
        raise ValueError("scatter_kv_rows shape mismatch")
    if k_cache.device.type == "cpu":
        return scatter_kv_rows_plain(k_cache, v_cache, k_rows, v_rows, pos)
    tensors = (k_cache, v_cache, k_rows, v_rows, pos)
    if (not k_cache.is_cuda or k_cache.dtype != torch.bfloat16
            or v_cache.dtype != torch.bfloat16
            or k_rows.dtype != torch.bfloat16 or v_rows.dtype != torch.bfloat16
            or pos.dtype != torch.int32 or KVD % 8
            or any(t.get_device() != k_cache.get_device()
                   or not t.is_contiguous() for t in tensors)):
        raise ValueError("K3 takes contiguous CUDA bf16 caches/rows, int32 "
                         "pos and KVD % 8 == 0")
    lib = _cuda.library("decode_attention")
    rc = lib.bn_scatter_kv_rows(
        k_cache.data_ptr(), v_cache.data_ptr(), k_rows.data_ptr(),
        v_rows.data_ptr(), pos.data_ptr(), L, B, S, KVD,
        _cuda.stream_ptr(k_cache.device))
    _cuda.check(lib, "decode_attention", rc, "scatter_kv_rows")
    scatter_kv_rows.launches += 1
    return k_cache, v_cache


scatter_kv_rows.launches = 0
