"""v1 flash decode attention (K5): the CUDA kernel and its plain version.

K5 :func:`decode_attention` replaces ``decode_attention``
(``bitnet_tpu/ops/decode_attention.py:922-996``, body
``_decode_attn_kernel`` ``:75-145``): one decode step of causal GQA
attention for the generic ``block_forward`` (T=1, B≤2, dense bf16 cache),
with the new token folded into the online softmax and the cache read
before this step's row is written.  It takes layer ``l`` of the flat cache
stack ``[L, B, S, KV*D]``, as K2 does.
"""

from __future__ import annotations

import torch

from . import _cuda

NEG_INF = -1e30
DEFAULT_CHUNK = 1024  # the JAX kernel's sequence chunk (one grid step ≤ 1024)
SPLIT = 64            # cache rows per block of the CUDA kernel (csrc)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos):
    """K5 on one layer, as the JAX kernel computes it: q [B, H, D] (roped),
    k_new / v_new [B, KV, D], caches [B, S, KV*D] (PRE-write), pos [B]
    valid rows.  q, k_new and v_new are cast to the cache dtype; the online
    softmax starts from the new token (m = q·k_new/√D, d = 1, ctx = v_new)
    and walks the cache in chunks of min(1024, S) rows, rounding its
    weights to the cache dtype before the PV product.  Returns [B, H, D]
    in q's dtype."""
    B, H, D = q.shape
    S = k_cache_l.shape[1]
    KV = k_new.shape[1]
    G = H // KV
    cdt = k_cache_l.dtype
    scale = float(D) ** -0.5
    qf = q.to(cdt).to(torch.float32).reshape(B, KV, G, D)
    kn = k_new.to(cdt).to(torch.float32)
    vn = v_new.to(cdt).to(torch.float32)
    m = (qf * kn[:, :, None, :]).sum(-1) * scale             # [B, KV, G]
    d = torch.ones_like(m)
    ctx = vn[:, :, None, :].expand(B, KV, G, D).clone()
    kc = k_cache_l.reshape(B, S, KV, D)
    vc = v_cache_l.reshape(B, S, KV, D)
    chunk = min(DEFAULT_CHUNK, S)
    while S % chunk:
        chunk //= 2
    for c0 in range(0, S, chunk):
        kcc = kc[:, c0:c0 + chunk].to(torch.float32)
        vcc = vc[:, c0:c0 + chunk]
        s = torch.einsum("bkgd,bskd->bkgs", qf, kcc) * scale
        idx = torch.arange(c0, c0 + chunk, device=q.device)
        s = torch.where((idx[None, :] < pos[:, None])[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        d = d * alpha + e.sum(-1)
        r = torch.einsum("bkgs,bskd->bkgd", e.to(cdt).to(torch.float32),
                         vcc.to(torch.float32))
        ctx = ctx * alpha[..., None] + r
        m = m_new
    return (ctx / d[..., None]).reshape(B, H, D).to(q.dtype)


def decode_attention(l: int, q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K5 over layer ``l`` of the flat stacks [L, B, S, KV*D].

    q [B, H, D] roped, k_new / v_new [B, KV, D] (k roped), all in one
    dtype (bf16/f32); pos [B] int32 = rows already in the cache.  Returns
    attn [B, H, D] in q's dtype.  Writes nothing."""
    B, H, D = q.shape
    L, Bc, S, KVD = k_cache.shape
    KV = k_new.shape[1]
    if (tuple(k_new.shape) != (B, KV, D) or tuple(v_new.shape) != (B, KV, D)
            or KVD != KV * D or Bc != B or H % KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, cache {tuple(k_cache.shape)}")
    if tuple(v_cache.shape) != tuple(k_cache.shape) or not 0 <= l < L:
        raise ValueError("v_cache must match k_cache; l in range")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache[l], v_cache[l],
                                      pos)
    G = H // KV
    if (not q.is_cuda or q.dtype not in _DTYPE_CODE or k_new.dtype != q.dtype
            or v_new.dtype != q.dtype or k_cache.dtype != torch.bfloat16
            or v_cache.dtype != torch.bfloat16 or D not in (64, 128) or G > 8):
        raise ValueError(
            f"K5 takes CUDA bf16/f32 q, k_new, v_new of one dtype, a bf16 "
            f"cache, D in (64, 128) and H/KV <= 8; got {q.device} {q.dtype}, "
            f"{k_new.dtype}, {k_cache.dtype}, D={D}, H={H}, KV={KV}")
    dev_i = q.get_device()
    tensors = (q, k_new, v_new, k_cache, v_cache, pos)
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError("K5 operands must be contiguous on q's device")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError("pos must be int32 [B]")
    dev = q.device
    NS = -(-S // SPLIT)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    # per-split partials: m/d [B, KV, NS, G, 2] then ctx [B, KV, NS, G, D]
    n_md = B * KV * NS * G * 2
    part = torch.empty(n_md + B * KV * NS * G * D, dtype=torch.float32,
                       device=dev)
    layer = 2 * l * k_cache.stride(0)                  # bytes to layer l
    lib = _cuda.library("decode_attention")
    rc = lib.bn_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr() + layer, v_cache.data_ptr() + layer, pos.data_ptr(),
        B, H, KV, D, S, float(D) ** -0.5, out.data_ptr(), part.data_ptr(),
        part.data_ptr() + 4 * n_md, _DTYPE_CODE[q.dtype], _cuda.stream_ptr(dev))
    _cuda.check(lib, "decode_attention", rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
