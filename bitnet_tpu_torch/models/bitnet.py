"""BitNet forward pass in PyTorch: the fused stacked prefill and decode.

Counterpart of ``bitnet_tpu/models/bitnet.py``, slice 1: the paths
``forward`` → ``_prefill_stacked`` (``:1440`` → ``:1059``) and ``forward``
→ ``_decode_stacked`` with plan ``qkv_v2s`` (``:1414`` → ``:401``, the
stacked-attention branch ``:839-966``).  The JAX package walks the layers
with ``lax.scan`` and reaches the stacked weights through scalar-prefetch
kernels so XLA does not copy per-layer slices; here a Python loop over the
layers does the same work and ``packed[l]`` is a view.

Semantics kept exactly:
- ``_pre_len = kv_valid_len + num_real_tokens - T`` (``:1402``);
- the rope rows are gathered once per call at positions clamped to the
  table (``:1408``);
- prefill cache writes DROP positions >= S (``.at[].set(mode="drop")``);
- the decode row write CLAMPS to S-1 (``:978-991``, kernel K3).

Other paths (unfused projections, batched pools, quantized caches, the
generic per-layer loop) are not ported yet and raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ModelConfig
from ..errors import QuantizationError
from ..ops.attention import attention
from ..ops.decode_attention_v2 import decode_attention_qkv, scatter_kv_rows
from ..ops.flash import flash_attention
from ..ops.linear import TernaryLinear, concat_linears
from ..ops.rmsnorm import rms_norm
from ..ops.rope import apply_rope
from ..ops.ternary_matmul import (
    int8_matmul,
    STACKED_DECODE_MAX_M,
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

    def to(self, device) -> "BitNetParams":
        return BitNetParams(**{f.name: _to(getattr(self, f.name), device)
                               for f in dataclasses.fields(self)})


def quantize_head(params: BitNetParams) -> BitNetParams:
    """Attach an int8 per-row copy of the tied embedding for the logits
    (``logits_dtype='int8'``); the float table stays for lookups."""
    emb = params.embed.to(torch.float32)
    scale = torch.clamp(emb.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(emb / scale[:, None]), -127, 127).to(torch.int8)
    return dataclasses.replace(params, embed_q=q, embed_q_scale=scale)


def _colvec_scales(lin: TernaryLinear) -> TernaryLinear:
    """Stacked per-layer scalar scales [L] → per-column vectors [L, 1, Np]."""
    s = lin.scales
    if lin.kind != "qk256" or lin.packed.ndim != 3 or s.ndim != 1:
        return lin
    L, Np = lin.packed.shape[0], lin.packed.shape[2]
    vec = s.to(torch.float32).reshape(L, 1, 1).expand(L, 1, Np).contiguous()
    return dataclasses.replace(lin, scales=vec)


def fuse_block_params(blocks: BlockParams) -> BlockParams:
    """Fuse q|k|v and gate|up (4 matmuls a layer instead of 7).  Widths
    that cannot fuse raise: the unfused path is not ported (#7)."""
    try:
        wqkv = concat_linears([blocks.wq, blocks.wk, blocks.wv])
        w_gateup = concat_linears([blocks.w_gate, blocks.w_up])
    except QuantizationError as e:
        raise NotImplementedError(
            f"projection fusion impossible ({e}); the unfused path is not "
            "ported yet (ROADMAP.md queue 1 #7)") from e
    return dataclasses.replace(blocks, wqkv=wqkv, w_gateup=w_gateup,
                               wq=None, wk=None, wv=None, w_gate=None,
                               w_up=None, wo=_colvec_scales(blocks.wo),
                               w_down=_colvec_scales(blocks.w_down))


def _scale_vec(lin: TernaryLinear) -> torch.Tensor:
    """[L, Np] f32 per-column scales (a view for fused params)."""
    L, Np = lin.packed.shape[0], lin.packed.shape[2]
    s = lin.scales.to(torch.float32).reshape(L, -1)
    if s.shape[1] == 1:
        return s.expand(L, Np).contiguous()
    if s.shape[1] != Np:
        s = torch.nn.functional.pad(s, (0, Np - s.shape[1]), value=1.0)
    return s.contiguous()


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
                      cache_dtype: torch.dtype) -> bool:
    kv = "bf16" if cache_dtype == torch.bfloat16 else str(cache_dtype)
    return (T == 1 and B <= STACKED_DECODE_MAX_M
            and decode_attn_plan(B, kv) in PORTED_PLANS
            and cache_dtype == torch.bfloat16
            and stacked_weights_ok(cfg, params.blocks))


def stacked_prefill_ok(cfg: ModelConfig, params: BitNetParams, T: int) -> bool:
    return T > 1 and stacked_weights_ok(cfg, params.blocks)


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
    sv = {n: _scale_vec(getattr(b, n)) for n in ("wqkv", "wo", "w_gateup", "w_down")}

    def mm(l, h, name, gamma, **kw):
        lin = getattr(b, name)
        return ternary_matmul_w2a8_normed(l, h, lin.packed, sv[name], gamma,
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
    sv = {n: _scale_vec(getattr(b, n)) for n in ("wqkv", "wo", "w_gateup", "w_down")}
    use_flash = T * S >= (1 << 19)
    new_len = pre_len + T
    # cache writes drop positions >= S (padding carries position S)
    wb, wt = torch.nonzero(q_positions < S, as_tuple=True)
    wp = q_positions[wb, wt]

    def mm(l, h2, name):
        lin = getattr(b, name)
        return ternary_matmul_w2a8(l, h2, lin.packed, sv[name], k_dim=lin.k,
                                   n_dim=lin.n)

    h2 = x.reshape(M, H)
    for l in range(L):
        qkv = mm(l, rms_norm(h2, b.attn_norm[l], eps), "wqkv").reshape(B, T, -1)
        q = qkv[..., : nh * D].reshape(B, T, nh, D)
        kn = qkv[..., nh * D: (nh + nkv) * D].reshape(B, T, nkv, D)
        vn = qkv[..., (nh + nkv) * D:].reshape(B, T, nkv, D)
        q = apply_rope(q, sin_rows, cos_rows)
        kn = apply_rope(kn, sin_rows, cos_rows)
        k_cache[l, wb, wp] = kn[wb, wt].reshape(-1, nkv * D).to(k_cache.dtype)
        v_cache[l, wb, wp] = vn[wb, wt].reshape(-1, nkv * D).to(v_cache.dtype)
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
            num_real_tokens: torch.Tensor | int | None = None):  # [B] int32
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
    if stacked_decode_ok(cfg, params, T, B, k_cache.dtype):
        h = _decode_stacked(cfg, params, x, q_positions, k_cache, v_cache,
                            pre_len, sin_rows, cos_rows)
    elif stacked_prefill_ok(cfg, params, T):
        h = _prefill_stacked(cfg, params, x, q_positions, k_cache, v_cache,
                             pre_len, sin_rows, cos_rows)
    else:
        raise NotImplementedError(
            f"no ported path for T={T}, B={B}, cache {k_cache.dtype}: the "
            "generic per-layer path is ROADMAP.md queue 1 #7 (pools with "
            "B > 2: #9, quantized caches: #8)")
    return rms_norm(h, params.final_norm, cfg.rms_norm_eps), k_cache, v_cache


def forward_cache(cfg: ModelConfig, params: BitNetParams,
                  tokens: torch.Tensor, q_positions: torch.Tensor, cache,
                  num_real_tokens: torch.Tensor | int | None = None):
    """:func:`forward` on an ``engine.cache.KVCache``; advances its lengths
    in place and returns (hidden, cache)."""
    if num_real_tokens is None:
        num_real_tokens = tokens.shape[1]
    h, _, _ = forward(cfg, params, tokens, q_positions, cache.k, cache.v,
                      cache.lengths, num_real_tokens)
    cache.lengths += num_real_tokens
    return h, cache


def logits(cfg: ModelConfig, params: BitNetParams,
           hidden: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden [B, T, H] → f32 logits [B, T, V] (tied head)."""
    B, T, H = hidden.shape
    if params.embed_q is not None:
        # int8 head: per-token activation scale x per-row table scale
        xq, sx, _ = quantize_rows(hidden.reshape(B * T, H).to(torch.float32))
        acc = int8_matmul(xq, params.embed_q.t())
        out = acc.to(torch.float32) * sx[:, None] * params.embed_q_scale[None, :]
        return out.reshape(B, T, -1)
    h = hidden.to(params.embed.dtype).to(torch.float32)
    return torch.matmul(h, params.embed.to(torch.float32).t())
