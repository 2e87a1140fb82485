"""BitNet forward pass in PyTorch: the fused stacked prefill and decode,
and the generic per-layer path.

Counterpart of ``bitnet_tpu/models/bitnet.py``:
- slice 1: ``forward`` → ``_prefill_stacked`` (``:1440`` → ``:1059``) and
  ``forward`` → ``_decode_stacked`` with plan ``qkv_v2s`` (``:1414`` →
  ``:401``, the stacked-attention branch ``:839-966``);
- slice 2: the generic layer loop ``forward`` → ``block_forward``
  (``:1449-1461`` → ``:1241-1367``), which the CLI runs (unfused
  projections; ``kernel_path`` ``w2a8``, ``pallas`` or ``xla``), with its
  ``fast_decode`` branch on the v1 decode attention (K5).

The JAX package walks the layers with ``lax.scan`` and reaches the stacked
weights through scalar-prefetch kernels so XLA does not copy per-layer
slices; here a Python loop over the layers does the same work, the
kernels take the stack and a layer index, and ``packed[l]`` is a view.

Semantics kept exactly:
- ``_pre_len = kv_valid_len + num_real_tokens - T`` (``:1402``);
- the rope rows are gathered once per call at positions clamped to the
  table (``:1408``);
- prefill cache writes, and every write of the generic path, DROP
  positions >= S (``.at[].set(mode="drop")``, ``:1331-1334``,
  ``:1347-1350``);
- the stacked decode row write CLAMPS to S-1 (``:978-991``, kernel K3).

Batched pools and quantized caches are not ported yet and raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch

from ..config import ModelConfig
from ..errors import QuantizationError
from ..ops.attention import attention
from ..ops.decode_attention import decode_attention
from ..ops.decode_attention_v2 import decode_attention_qkv, scatter_kv_rows
from ..ops.flash import flash_attention
from ..ops.linear import (TernaryLinear, concat_linears, linear_apply,
                          linear_apply_normed, with_col_scales)
from ..ops.rmsnorm import rms_norm
from ..ops.rope import apply_rope
from ..ops.ternary_matmul import (
    STACKED_DECODE_MAX_M,
    int8_matmul,
    quantize_rows,
    ternary_matmul_w2a8,
    ternary_matmul_w2a8_normed,
)

# decode-attention plans the port has kernels for (see decode_attn_plan)
PORTED_PLANS = frozenset({"qkv_v2s"})


def _to(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass
class BlockParams:
    """Per-layer parameters stacked on a leading [L] axis."""

    attn_norm: torch.Tensor                    # [L, H] f32
    wq: Optional[TernaryLinear]
    wk: Optional[TernaryLinear]
    wv: Optional[TernaryLinear]
    wo: TernaryLinear
    ffn_norm: torch.Tensor                     # [L, H] f32
    w_gate: Optional[TernaryLinear]
    w_up: Optional[TernaryLinear]
    w_down: TernaryLinear
    wqkv: Optional[TernaryLinear] = None       # [L, H, (nh+2nkv)*D]
    w_gateup: Optional[TernaryLinear] = None   # [L, H, 2F]
    attn_sub_norm: Optional[torch.Tensor] = None   # [L, nh*D]
    ffn_sub_norm: Optional[torch.Tensor] = None    # [L, F]

    def to(self, device) -> "BlockParams":
        return BlockParams(**{f.name: _to(getattr(self, f.name), device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass
class BitNetParams:
    embed: torch.Tensor                        # [V, H] (compute dtype)
    blocks: BlockParams
    final_norm: torch.Tensor                   # [H] f32
    rope_sin: torch.Tensor                     # [S_rope, D/2] f32
    rope_cos: torch.Tensor
    embed_q: Optional[torch.Tensor] = None         # [V, H] int8 head
    embed_q_scale: Optional[torch.Tensor] = None   # [V] f32
    lm_head: Optional[TernaryLinear] = None        # untied output [H, V]

    def to(self, device) -> "BitNetParams":
        return BitNetParams(**{f.name: _to(getattr(self, f.name), device)
                               for f in dataclasses.fields(self)})


def quantize_head(params: BitNetParams) -> BitNetParams:
    """Attach an int8 per-row copy of the tied embedding for the logits
    (``logits_dtype='int8'``); the float table stays for lookups.  An
    untied head is a ternary linear already and stays as it is."""
    if params.lm_head is not None:
        return params
    emb = params.embed.to(torch.float32)
    scale = torch.clamp(emb.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(emb / scale[:, None]), -127, 127).to(torch.int8)
    return dataclasses.replace(params, embed_q=q, embed_q_scale=scale)


def fuse_block_params(blocks: BlockParams) -> BlockParams:
    """Fuse q|k|v and gate|up (4 matmuls a layer instead of 7).  Widths
    that cannot fuse leave the blocks unfused, as the JAX package does
    (the engine records ``fuse_projections_fallback``)."""
    try:
        wqkv = concat_linears([blocks.wq, blocks.wk, blocks.wv])
        w_gateup = concat_linears([blocks.w_gate, blocks.w_up])
    except QuantizationError:
        return blocks
    return dataclasses.replace(blocks, wqkv=wqkv, w_gateup=w_gateup,
                               wq=None, wk=None, wv=None, w_gate=None,
                               w_up=None)


def with_col_scales_params(params: BitNetParams) -> BitNetParams:
    """Every linear's ``[L, Np]`` kernel scales (:func:`with_col_scales`),
    once at engine init rather than once per kernel call."""
    b = params.blocks
    blocks = dataclasses.replace(b, **{
        n: with_col_scales(getattr(b, n))
        for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "wqkv", "w_gateup") if getattr(b, n) is not None})
    return dataclasses.replace(
        params, blocks=blocks,
        lm_head=None if params.lm_head is None else with_col_scales(params.lm_head))


# --------------------------------------------------------------------------
# the shared eligibility predicate
# --------------------------------------------------------------------------
def decode_attn_plan(B: int, kv_dtype: str = "bf16") -> str:
    """The decode-attention plan the JAX package's default selection picks
    (``bitnet_tpu/models/bitnet.py:305-398``, flat cache, no env
    overrides).  The port has kernels for the plans in PORTED_PLANS."""
    quantized = kv_dtype in ("int8", "fp8")
    if B <= 2:
        return "qkv_quant_v2s" if quantized else "qkv_v2s"
    v2_ok_b = B <= 16 or (B % 2 == 0 and B <= STACKED_DECODE_MAX_M)
    if v2_ok_b:
        return "quant_batched_v2" if quantized else "batched_v2"
    return "einsum"


def stacked_weights_ok(cfg: ModelConfig, b: BlockParams) -> bool:
    """Weight-side eligibility of the stacked prefill and decode: fused
    qk256 stacks with K == Kp, silu, and norm widths that match."""
    if b.wqkv is None or b.w_gateup is None or cfg.hidden_act != "silu":
        return False
    for lin in (b.wqkv, b.wo, b.w_gateup, b.w_down):
        if (lin.kind != "qk256" or lin.packed.ndim != 3
                or lin.packed.shape[1] * 16 != lin.k):
            return False
    if b.attn_sub_norm is not None and b.attn_sub_norm.shape[-1] != b.wo.k:
        return False
    if b.ffn_sub_norm is not None and b.ffn_sub_norm.shape[-1] != b.w_down.k:
        return False
    return (b.attn_norm.shape[-1] == b.wqkv.k
            and b.ffn_norm.shape[-1] == b.w_gateup.k)


def stacked_decode_ok(cfg: ModelConfig, params: BitNetParams, T: int, B: int,
                      cache_dtype: torch.dtype, kernel_path: str) -> bool:
    kv = "bf16" if cache_dtype == torch.bfloat16 else str(cache_dtype)
    return (T == 1 and B <= STACKED_DECODE_MAX_M and kernel_path == "w2a8"
            and decode_attn_plan(B, kv) in PORTED_PLANS
            and cache_dtype == torch.bfloat16
            and stacked_weights_ok(cfg, params.blocks))


def stacked_prefill_ok(cfg: ModelConfig, params: BitNetParams, T: int,
                       kernel_path: str) -> bool:
    return (T > 1 and kernel_path == "w2a8"
            and stacked_weights_ok(cfg, params.blocks))


# --------------------------------------------------------------------------
# cache writes that drop positions >= S
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CacheWrites:
    """Where this call's new rows go, found once per forward call: batch
    ``b`` and token ``t`` of every position < S, at row ``pos`` (positions
    >= S are dropped, never clamped).  The prefill of the stacked path and
    every write of the generic path go through it."""

    b: torch.Tensor
    t: torch.Tensor
    pos: torch.Tensor

    @classmethod
    def of(cls, q_positions: torch.Tensor, S: int) -> "CacheWrites":
        b, t = torch.nonzero(q_positions < S, as_tuple=True)
        return cls(b, t, q_positions[b, t])

    def put(self, cache: torch.Tensor, l: int, rows: torch.Tensor) -> None:
        """rows [B, T, KV, D] → cache[l] [B, S, KV*D], in place."""
        cache[l, self.b, self.pos] = rows[self.b, self.t].reshape(
            self.b.shape[0], cache.shape[-1]).to(cache.dtype)


# --------------------------------------------------------------------------
# decode (T == 1): K1 x4, K2 x1 per layer, K3 once per step
# --------------------------------------------------------------------------
def _decode_stacked(cfg: ModelConfig, params: BitNetParams,
                    x: torch.Tensor,             # [B, 1, H]
                    q_positions: torch.Tensor,   # [B, 1]
                    k_cache: torch.Tensor,       # [L, B, S, KV*D] flat
                    v_cache: torch.Tensor,
                    pre_len: torch.Tensor,       # [B] valid cache rows
                    sin_rows: torch.Tensor,      # [B, 1, D/2]
                    cos_rows: torch.Tensor) -> torch.Tensor:
    b = params.blocks
    B = x.shape[0]
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = k_cache.shape[0]
    eps = cfg.rms_norm_eps

    def mm(l, h, name, gamma, **kw):
        lin = getattr(b, name)
        return ternary_matmul_w2a8_normed(l, h, lin.packed, lin.col_scales, gamma,
                                          k_dim=lin.k, n_dim=lin.n, eps=eps, **kw)

    sin_r = sin_rows[:, 0].contiguous()
    cos_r = cos_rows[:, 0].contiguous()
    pos = pre_len.to(torch.int32).contiguous()
    h = x[:, 0, :]
    k_rows, v_rows = [], []
    for l in range(L):
        qkv = mm(l, h, "wqkv", b.attn_norm)
        attn, kr, vr = decode_attention_qkv(
            l, qkv.view(B, nh + 2 * nkv, D), sin_r, cos_r, k_cache, v_cache,
            pos, n_heads=nh, n_kv=nkv)
        h = mm(l, attn.view(B, nh * D), "wo", b.attn_sub_norm, resid=h)
        gu = mm(l, h, "w_gateup", b.ffn_norm)
        h = mm(l, gu, "w_down", b.ffn_sub_norm, glu=True, resid=h)
        k_rows.append(kr.view(B, 1, nkv * D))
        v_rows.append(vr.view(B, 1, nkv * D))
    # ONE write of all L new rows, after every layer read its PRE-write cache
    scatter_kv_rows(k_cache, v_cache, torch.stack(k_rows), torch.stack(v_rows),
                    q_positions[:, 0].to(torch.int32).contiguous())
    return h[:, None, :]


# --------------------------------------------------------------------------
# prefill (T > 1): K4 x4 per layer; norms, RoPE, attention in plain torch
# --------------------------------------------------------------------------
def _prefill_stacked(cfg: ModelConfig, params: BitNetParams,
                     x: torch.Tensor,             # [B, T, H]
                     q_positions: torch.Tensor,   # [B, T]
                     k_cache: torch.Tensor,       # [L, B, S, KV*D] flat
                     v_cache: torch.Tensor,
                     pre_len: torch.Tensor,       # [B]
                     sin_rows: torch.Tensor,      # [B, T, D/2]
                     cos_rows: torch.Tensor) -> torch.Tensor:
    b = params.blocks
    B, T, H = x.shape
    M = B * T
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, S = k_cache.shape[0], k_cache.shape[2]
    eps = cfg.rms_norm_eps
    use_flash = T * S >= (1 << 19)
    new_len = pre_len + T
    writes = CacheWrites.of(q_positions, S)   # padding carries position S

    def mm(l, h2, name):
        lin = getattr(b, name)
        return ternary_matmul_w2a8(l, h2, lin.packed, lin.col_scales, k_dim=lin.k,
                                   n_dim=lin.n)

    h2 = x.reshape(M, H)
    for l in range(L):
        qkv = mm(l, rms_norm(h2, b.attn_norm[l], eps), "wqkv").reshape(B, T, -1)
        q = qkv[..., : nh * D].reshape(B, T, nh, D)
        kn = qkv[..., nh * D: (nh + nkv) * D].reshape(B, T, nkv, D)
        vn = qkv[..., (nh + nkv) * D:].reshape(B, T, nkv, D)
        q = apply_rope(q, sin_rows, cos_rows)
        kn = apply_rope(kn, sin_rows, cos_rows)
        writes.put(k_cache, l, kn)
        writes.put(v_cache, l, vn)
        k_read = k_cache[l].view(B, S, nkv, D)
        v_read = v_cache[l].view(B, S, nkv, D)
        attend = flash_attention if use_flash else attention
        attn = attend(q, k_read, v_read, q_positions, new_len)
        a2 = attn.reshape(M, nh * D)
        if b.attn_sub_norm is not None:
            a2 = rms_norm(a2, b.attn_sub_norm[l], eps)
        h2 = mm(l, a2, "wo") + h2
        gu = mm(l, rms_norm(h2, b.ffn_norm[l], eps), "w_gateup")
        F = gu.shape[1] // 2
        gate = gu[:, :F]
        act = gate * torch.sigmoid(gate) * gu[:, F:]
        if b.ffn_sub_norm is not None:
            act = rms_norm(act, b.ffn_sub_norm[l], eps)
        h2 = mm(l, act, "w_down") + h2
    return h2.reshape(B, T, H)


# --------------------------------------------------------------------------
# the generic per-layer path (JAX: block_forward under lax.scan)
# --------------------------------------------------------------------------
def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "relu2":
        r = torch.relu(x)
        return r * r
    if name == "gelu":                      # jax.nn.gelu: tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {name!r}")


def _ffn(cfg: ModelConfig, bp: BlockParams, x: torch.Tensor, kernel_path: str,
         l: int) -> torch.Tensor:
    """SwiGLU FFN of layer ``l`` (``:162-215``): ``x`` is the PRE-norm
    residual and the result includes it.  ffn_norm, the 2B-4T
    ffn_sub_norm, the SwiGLU and the residual ride the projections
    (fused into K1 at decode rows).  The opt-in ``BITNET_FUSED_FFN`` kernel
    is not ported (ROADMAP.md queue 2 #14)."""
    lapn = partial(linear_apply_normed, eps=cfg.rms_norm_eps, path=kernel_path,
                   layer=l)
    if bp.w_gateup is not None:
        gu = lapn(bp.w_gateup, x, bp.ffn_norm)
        if cfg.hidden_act == "silu":
            return lapn(bp.w_down, gu, bp.ffn_sub_norm, glu=True, resid=x)
        F = bp.w_gateup.n // 2
        gate = _act(cfg.hidden_act, gu[..., :F])
        up = gu[..., F:]
    else:
        h = rms_norm(x, bp.ffn_norm[l], cfg.rms_norm_eps)
        gate = _act(cfg.hidden_act, lapn(bp.w_gate, h, None))
        up = lapn(bp.w_up, h, None)
    return lapn(bp.w_down, gate * up, bp.ffn_sub_norm, resid=x)


def block_qkv(cfg: ModelConfig, bp: BlockParams, x: torch.Tensor,
              sin_rows: torch.Tensor, cos_rows: torch.Tensor,
              kernel_path: str, l: int):
    """Projections + RoPE of layer ``l`` (``:1185-1222``): fused wqkv with
    attn_norm in the kernel preamble, or q, k, v from an ``rms_norm`` that
    rounds to the activation dtype (``:1212``) and then ``gamma=None``.
    Returns q [B,T,nh,D], k, v [B,T,nkv,D], q and k roped."""
    B, T, _ = x.shape
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lapn = partial(linear_apply_normed, eps=cfg.rms_norm_eps, path=kernel_path,
                   layer=l)
    if bp.wqkv is not None:
        qkv = lapn(bp.wqkv, x, bp.attn_norm)
        q = qkv[..., : nh * D].reshape(B, T, nh, D)
        k = qkv[..., nh * D: (nh + nkv) * D].reshape(B, T, nkv, D)
        v = qkv[..., (nh + nkv) * D:].reshape(B, T, nkv, D)
    else:
        h = rms_norm(x, bp.attn_norm[l], cfg.rms_norm_eps)
        q = lapn(bp.wq, h, None).reshape(B, T, nh, D)
        k = lapn(bp.wk, h, None).reshape(B, T, nkv, D)
        v = lapn(bp.wv, h, None).reshape(B, T, nkv, D)
    return (apply_rope(q, sin_rows, cos_rows), apply_rope(k, sin_rows, cos_rows),
            v)


def block_finish(cfg: ModelConfig, bp: BlockParams, x: torch.Tensor,
                 attn: torch.Tensor, kernel_path: str, l: int) -> torch.Tensor:
    """o-projection (+ attn_sub_norm, kept inside K1) + residual + FFN
    (``:1225-1238``)."""
    B, T, _ = x.shape
    x = linear_apply_normed(bp.wo, attn.reshape(B, T, -1), bp.attn_sub_norm,
                            eps=cfg.rms_norm_eps, path=kernel_path,
                            resid=x, layer=l)
    return _ffn(cfg, bp, x, kernel_path, l)


def block_forward(cfg: ModelConfig, x: torch.Tensor, bp: BlockParams, l: int,
                  sin_rows: torch.Tensor, cos_rows: torch.Tensor,
                  q_positions: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pre_len: torch.Tensor,
                  kernel_path: str, writes: CacheWrites) -> torch.Tensor:
    """Layer ``l`` of the generic path (``:1241-1367``) over the flat bf16
    cache stack [L, B, S, KV*D], written in place.

    ``fast_decode`` (T=1, B≤2, path ``pallas``/``w2a8``): K5 attends over
    the PRE-write cache with the new token folded in, then the rows are
    written.  Otherwise the rows are written first and plain ``attention``
    (or ``flash_attention`` once T·S ≥ 2^19) reads the cache.  The
    ``BITNET_ROPE_FUSED`` branch (ROADMAP.md queue 2 #6) and the quantized
    cache (queue 1 #8) are not ported."""
    B, T, _ = x.shape
    nkv, D = cfg.num_kv_heads, cfg.head_dim
    S = k_cache.shape[2]
    q, k, v = block_qkv(cfg, bp, x, sin_rows, cos_rows, kernel_path, l)
    if T == 1 and B <= 2 and kernel_path in ("pallas", "w2a8"):
        attn1 = decode_attention(l, q[:, 0].contiguous(), k[:, 0].contiguous(),
                                 v[:, 0].contiguous(), k_cache, v_cache, pre_len)
        writes.put(k_cache, l, k)
        writes.put(v_cache, l, v)
        return block_finish(cfg, bp, x, attn1[:, None], kernel_path, l)
    writes.put(k_cache, l, k)
    writes.put(v_cache, l, v)
    k_read = k_cache[l].view(B, S, nkv, D)
    v_read = v_cache[l].view(B, S, nkv, D)
    attend = flash_attention if T > 1 and T * S >= (1 << 19) else attention
    attn = attend(q, k_read, v_read, q_positions, pre_len + T)
    return block_finish(cfg, bp, x, attn, kernel_path, l)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def embed_tokens(params: BitNetParams, tokens: torch.Tensor) -> torch.Tensor:
    """[B, T] int → [B, T, H] in the embedding's dtype."""
    return params.embed[tokens.to(torch.int64)]


def forward(cfg: ModelConfig, params: BitNetParams,
            tokens: torch.Tensor,          # [B, T]
            q_positions: torch.Tensor,     # [B, T]; padding holds S
            k_cache: torch.Tensor,         # [L, B, S, KV*D], updated in place
            v_cache: torch.Tensor,
            kv_valid_len: torch.Tensor,    # [B] valid length BEFORE this call
            num_real_tokens: torch.Tensor | int | None = None,  # [B] int32
            kernel_path: str = "xla"):
    """Returns (final-normed hidden [B, T, H], k_cache, v_cache)."""
    x = embed_tokens(params, tokens)
    B, T, _ = x.shape
    if num_real_tokens is None:
        num_real_tokens = T
    # attention masks with pre_len + T == kv_valid_len + num_real_tokens
    pre_len = kv_valid_len + (num_real_tokens - T)
    # rope rows gathered once for all layers, positions clamped to the table
    rp = torch.clamp(q_positions.to(torch.int64), max=params.rope_sin.shape[0] - 1)
    sin_rows, cos_rows = params.rope_sin[rp], params.rope_cos[rp]
    if stacked_decode_ok(cfg, params, T, B, k_cache.dtype, kernel_path):
        h = _decode_stacked(cfg, params, x, q_positions, k_cache, v_cache,
                            pre_len, sin_rows, cos_rows)
    elif stacked_prefill_ok(cfg, params, T, kernel_path):
        h = _prefill_stacked(cfg, params, x, q_positions, k_cache, v_cache,
                             pre_len, sin_rows, cos_rows)
    elif k_cache.dtype == torch.bfloat16:
        writes = CacheWrites.of(q_positions, k_cache.shape[2])
        pos = pre_len.to(torch.int32).contiguous()
        h = x
        for l in range(k_cache.shape[0]):
            h = block_forward(cfg, h, params.blocks, l, sin_rows, cos_rows,
                              q_positions, k_cache, v_cache, pos, kernel_path,
                              writes)
    else:
        raise NotImplementedError(
            f"no ported path for a {k_cache.dtype} cache (ROADMAP.md queue 1 #8)")
    return rms_norm(h, params.final_norm, cfg.rms_norm_eps), k_cache, v_cache


def forward_cache(cfg: ModelConfig, params: BitNetParams,
                  tokens: torch.Tensor, q_positions: torch.Tensor, cache,
                  num_real_tokens: torch.Tensor | int | None = None,
                  kernel_path: str = "xla"):
    """:func:`forward` on an ``engine.cache.KVCache``; advances its lengths
    in place and returns (hidden, cache)."""
    if num_real_tokens is None:
        num_real_tokens = tokens.shape[1]
    h, _, _ = forward(cfg, params, tokens, q_positions, cache.k, cache.v,
                      cache.lengths, num_real_tokens, kernel_path)
    cache.lengths += num_real_tokens
    return h, cache


# the tied bf16 head's CPU route: f32 copies of this many table rows at a
# time, never of the whole [V, H] table
HEAD_CHUNK_ROWS = 1024


def tied_head(hidden: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[M, H] × [V, H]ᵀ in the table's dtype with f32 accumulation and f32
    logits (JAX: ``dot_general(..., preferred_element_type=f32)``,
    ``:1519-1526``).  A bf16 table is never copied to f32 whole: on the
    card one cuBLAS bf16 GEMM writes f32 (``torch.mm(out_dtype=)``); on the
    CPU, which has no such call, row chunks of the table are widened to
    f32 one at a time (exact bf16 products, f32 sums)."""
    h = hidden.to(table.dtype)
    if table.dtype == torch.float32:
        return torch.matmul(h, table.t())
    if h.is_cuda:
        return torch.mm(h, table.t(), out_dtype=torch.float32)
    hf = h.to(torch.float32)
    out = torch.empty((h.shape[0], table.shape[0]), dtype=torch.float32)
    for v0 in range(0, table.shape[0], HEAD_CHUNK_ROWS):
        rows = table[v0:v0 + HEAD_CHUNK_ROWS].to(torch.float32)
        out[:, v0:v0 + rows.shape[0]] = hf @ rows.t()
    return out


def logits(cfg: ModelConfig, params: BitNetParams, hidden: torch.Tensor,
           kernel_path: str = "xla") -> torch.Tensor:
    """Final-normed hidden [B, T, H] → logits [B, T, V] (``:1495-1526``):
    the untied ``lm_head`` through ``linear_apply`` (hidden's dtype), else
    the int8 tied head on path ``w2a8`` (f32), else the tied head in the
    table's dtype with f32 accumulation (f32)."""
    B, T, H = hidden.shape
    if params.lm_head is not None:
        return linear_apply(params.lm_head, hidden, path=kernel_path)
    if params.embed_q is not None and kernel_path == "w2a8":
        # int8 head: per-token activation scale x per-row table scale
        xq, sx, _ = quantize_rows(hidden.reshape(B * T, H).to(torch.float32))
        acc = int8_matmul(xq, params.embed_q.t())
        out = acc.to(torch.float32) * sx[:, None] * params.embed_q_scale[None, :]
        return out.reshape(B, T, -1)
    return tied_head(hidden.reshape(B * T, H), params.embed).reshape(B, T, -1)
