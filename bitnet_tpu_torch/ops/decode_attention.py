"""v1 flash decode attention (K5): the CUDA kernel and its plain version,
and the split-S launcher it shares with K8 and K9.

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
# the quantized caches the kernels stream (csrc `cache` argument)
QUANT_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}


def online_softmax_plain(qf, m, ctx, k_cache_l, v_cache_l, pos, chunk,
                         k_scale_l=None, v_scale_l=None):
    """The JAX kernels' online softmax over one layer's cache, chunk by
    chunk: qf [B, KV, G, D] f32 (the cache-dot operand), m [B, KV, G] and
    ctx [B, KV, G, D] the new token's init (d = 1); caches [B, S, KV*D]
    read as f32; pos [B] valid rows.  The weights e round to bf16 before
    the PV product; a quantized cache's scales [B, S, KV] multiply the
    scores after the dot and e before that rounding, while d sums the
    unscaled e.  Returns ctx / d [B, KV, G, D] f32."""
    B, KV, G, D = qf.shape
    S = k_cache_l.shape[1]
    scale = float(D) ** -0.5
    ew = torch.bfloat16 if k_scale_l is not None else k_cache_l.dtype
    d = torch.ones_like(m)
    kc = k_cache_l.reshape(B, S, KV, D)
    vc = v_cache_l.reshape(B, S, KV, D)
    for c0 in range(0, S, chunk):
        s = torch.einsum("bkgd,bskd->bkgs", qf,
                         kc[:, c0:c0 + chunk].to(torch.float32)) * scale
        if k_scale_l is not None:
            s = s * k_scale_l[:, c0:c0 + chunk].permute(0, 2, 1)[:, :, None, :]
        idx = torch.arange(c0, c0 + chunk, device=qf.device)
        s = torch.where((idx[None, :] < pos[:, None])[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        d = d * alpha + e.sum(-1)
        if v_scale_l is not None:
            e = e * v_scale_l[:, c0:c0 + chunk].permute(0, 2, 1)[:, :, None, :]
        r = torch.einsum("bkgs,bskd->bkgd", e.to(ew).to(torch.float32),
                         vc[:, c0:c0 + chunk].to(torch.float32))
        ctx = ctx * alpha[..., None] + r
        m = m_new
    return ctx / d[..., None]


def new_token_init(q, k_new, v_new, dtype):
    """The softmax init of the kernels that take q and the new rows apart
    (K5, K8, K9): all three rounded to ``dtype``; m = q·k_new/√D and ctx =
    v_new.  Returns (qf [B, KV, G, D], m, ctx) in f32."""
    B, H, D = q.shape
    KV = k_new.shape[1]
    qf = q.to(dtype).to(torch.float32).reshape(B, KV, H // KV, D)
    kn = k_new.to(dtype).to(torch.float32)
    vn = v_new.to(dtype).to(torch.float32)
    m = (qf * kn[:, :, None, :]).sum(-1) * float(D) ** -0.5
    return qf, m, vn[:, :, None, :].expand(qf.shape).clone()


def v1_chunk(S: int) -> int:
    chunk = min(DEFAULT_CHUNK, S)
    while S % chunk:
        chunk //= 2
    return chunk


def decode_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos):
    """K5 on one layer, as the JAX kernel computes it: q [B, H, D] (roped),
    k_new / v_new [B, KV, D], caches [B, S, KV*D] (PRE-write), pos [B]
    valid rows.  q, k_new and v_new are cast to the cache dtype; the online
    softmax starts from the new token (m = q·k_new/√D, d = 1, ctx = v_new)
    and walks the cache in chunks of min(1024, S) rows, rounding its
    weights to the cache dtype before the PV product.  Returns [B, H, D]
    in q's dtype."""
    qf, m, ctx = new_token_init(q, k_new, v_new, k_cache_l.dtype)
    out = online_softmax_plain(qf, m, ctx, k_cache_l, v_cache_l, pos,
                               v1_chunk(k_cache_l.shape[1]))
    return out.reshape(q.shape).to(q.dtype)


def launch_split_attention(what: str, l: int, q, k_new, v_new, k_cache,
                           v_cache, pos, k_scale=None, v_scale=None):
    """The split-S decode kernels without RoPE over layer ``l`` of the
    flat stacks [L, B, S, KV*D]: K5 and K8 on a bf16 cache, K9 on an int8
    or fp8 cache with its f32 scale stacks [L, B, S, KV].  Checks what the
    CUDA kernel takes and launches it; counts nothing (each wrapper counts
    its own launches)."""
    B, H, D = q.shape
    L, _, S, _ = k_cache.shape
    KV = k_new.shape[1]
    quant = k_scale is not None
    cache_ok = (k_cache.dtype in QUANT_CODE if quant
                else k_cache.dtype == torch.bfloat16)
    if (not q.is_cuda or q.dtype not in _DTYPE_CODE or k_new.dtype != q.dtype
            or v_new.dtype != q.dtype or not cache_ok
            or v_cache.dtype != k_cache.dtype or D not in (64, 128)
            or H // KV > 8):
        raise ValueError(
            f"{what} takes CUDA bf16/f32 q, k_new, v_new of one dtype, a "
            f"{'int8/fp8' if quant else 'bf16'} cache, D in (64, 128) and "
            f"H/KV <= 8; got {q.device} {q.dtype}, {k_new.dtype}, "
            f"{k_cache.dtype}, D={D}, H={H}, KV={KV}")
    tensors = (q, k_new, v_new, k_cache, v_cache, pos) + (
        (k_scale, v_scale) if quant else ())
    dev_i = q.get_device()
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous on q's device")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError("pos must be int32 [B]")
    if quant and (k_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (L, B, S, KV)
                  or tuple(v_scale.shape) != (L, B, S, KV)):
        raise ValueError(f"{what}: scales must be f32 [{L}, {B}, {S}, {KV}]")
    dev = q.device
    NS = -(-S // SPLIT)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    # per-split partials: m/d [B, KV, NS, G, 2] then ctx [B, KV, NS, G, D]
    G = H // KV
    n_md = B * KV * NS * G * 2
    part = torch.empty(n_md + B * KV * NS * G * D, dtype=torch.float32,
                       device=dev)
    layer = l * k_cache.stride(0) * k_cache.element_size()   # bytes to layer l
    args = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr() + layer, v_cache.data_ptr() + layer)
    tail = (pos.data_ptr(), B, H, KV, D, S, float(D) ** -0.5, out.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * n_md, _DTYPE_CODE[q.dtype])
    lib = _cuda.library("decode_attention")
    if quant:
        sl = 4 * l * k_scale.stride(0)
        rc = lib.bn_decode_attention_quant(
            *args, k_scale.data_ptr() + sl, v_scale.data_ptr() + sl, *tail,
            QUANT_CODE[k_cache.dtype], _cuda.stream_ptr(dev))
    else:
        rc = lib.bn_decode_attention(*args, *tail, _cuda.stream_ptr(dev))
    _cuda.check(lib, "decode_attention", rc, what)
    return out


def check_layer_args(l, q, k_new, v_new, k_cache, v_cache):
    B, H, D = q.shape
    L, Bc, S, KVD = k_cache.shape
    KV = k_new.shape[1]
    if (tuple(k_new.shape) != (B, KV, D) or tuple(v_new.shape) != (B, KV, D)
            or KVD != KV * D or Bc != B or H % KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, cache {tuple(k_cache.shape)}")
    if tuple(v_cache.shape) != tuple(k_cache.shape) or not 0 <= l < L:
        raise ValueError("v_cache must match k_cache; l in range")


def decode_attention(l: int, q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K5 over layer ``l`` of the flat stacks [L, B, S, KV*D].

    q [B, H, D] roped, k_new / v_new [B, KV, D] (k roped), all in one
    dtype (bf16/f32); pos [B] int32 = rows already in the cache.  Returns
    attn [B, H, D] in q's dtype.  Writes nothing."""
    check_layer_args(l, q, k_new, v_new, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache[l], v_cache[l],
                                      pos)
    out = launch_split_attention("K5", l, q, k_new, v_new, k_cache, v_cache,
                                 pos)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
