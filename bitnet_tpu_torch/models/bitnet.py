"""BitNet forward pass in PyTorch: the fused stacked prefill and decode,
and the generic per-layer path.

Counterpart of ``bitnet_tpu/models/bitnet.py``:
- slice 1: ``forward`` → ``_prefill_stacked`` (``:1440`` → ``:1059``) and
  ``forward`` → ``_decode_stacked`` with plan ``qkv_v2s`` (``:1414`` →
  ``:401``, the stacked-attention branch ``:839-966``);
- slice 2: the generic layer loop ``forward`` → ``block_forward``
  (``:1449-1461`` → ``:1241-1367``), which the CLI runs (unfused
  projections; ``kernel_path`` ``w2a8``, ``pallas`` or ``xla``), with its
  ``fast_decode`` branch on the v1 decode attention (K5);
- slice 3: pools of B = 1…64 and int8 / fp8-e4m3 caches: every plan of
  ``decode_attn_plan`` in the stacked decode loop (``qkv_quant_v2s`` on K7,
  ``batched_v2`` on K8, ``quant_batched_v2`` on K9, ``einsum`` in plain
  torch), and the quantized branches of the stacked prefill and of
  ``block_forward`` (``:1118-1130``, ``:1337-1345``);
- slice 4: bitnet32 and TL weights (per-32-row block scales): the stacked
  decode loop's three-way matmul choice (``:457-499``, K11 / K12 / K10),
  and the layer loop (K10 on ``w2a8`` and ``pallas``) for their prefill
  and for the generic path;
- slice 5: every decode-attention plan of ``decode_attn_plan`` under the
  JAX package's kernel-selection knobs (``BITNET_B1_ATTN``,
  ``BITNET_BATCHED_ATTN``, ``BITNET_ROPE_FUSED``,
  ``BITNET_DECODE_ATTN_MAX_B``, ``BITNET_V2_WHOLEBATCH_MAX_B``,
  ``BITNET_FP8_KERNEL``, ``BITNET_ATTN_STACKED``; K13–K23), the generic
  path's ``BITNET_ROPE_FUSED=1`` branch, and ``BITNET_TL_W2A8``,
  ``BITNET_TL_FUSED``, ``BITNET_STACKED_PREFILL``;
- slice 6: the fused W2A8 FFN (``BITNET_FUSED_FFN=1``, ``:184-200``, K24)
  in the generic layer loop of a model without ``ffn_sub_norm`` (the
  Llama-3-8B-1.58 shapes);
- slice 21: the stacked decode over a page pool, plan ``paged``
  (:func:`forward_paged_decode`, K33), the function of the JAX
  ``paged_forward``'s decode step without its dense view.
- slice 25: dense linears (the JAX ``dense`` kind: every stacked gate
  refuses them, so they take the layer loop, K5 at B ≤ 2 decode), and the
  windowed ring cache's ``write_slots`` / ``kv_positions`` / ``window``
  (``:1255-1364``): the layer loop writes each row at its ring slot and
  attends by stored position within the window.

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
- the stacked decode row write CLAMPS to S-1 (``:978-991``, kernel K3);
- a quantized cache holds codes and f32 scales ``[L, B, S, KV]``; the
  stacked prefill and the generic path attend over the f32 dequantized
  cache, the stacked decode over the codes (K7, K9) or, on the ``einsum``
  plan, over the cache dequantized to the activation dtype.

An f32 cache takes the unquantized plans and kernels (the JAX
``decode_attn_plan`` counts only int8 and fp8 as quantized); over it the
kernels round nothing to bf16.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Callable, Optional

import torch

from ..config import ModelConfig, not_ported
from ..errors import QuantizationError
from ..ops.attention import attention
from ..ops.decode_attention import (
    decode_attention,
    decode_attention_batched_v1,
    decode_attention_qkv_batched,
    decode_attention_qkv_quant_batched,
    decode_attention_qkv_quant_v1,
    decode_attention_qkv_v1,
    decode_attention_quant,
    decode_attention_quant_batched_v1,
    dequantize_kv,
    quantize_kv,
)
from ..ops.decode_attention_v2 import (
    decode_attention_batched,
    decode_attention_batched_v2,
    decode_attention_qkv,
    decode_attention_qkv_batched_v2,
    decode_attention_qkv_quant,
    decode_attention_qkv_quant_batched_v2,
    decode_attention_quant_batched,
    decode_attention_quant_batched_v2,
    scatter_kv_rows,
)
from ..ops.ffn_fused import ffn_fused_supported, ffn_w2a8_fused
from ..ops.paged_attention import paged_attention
from ..ops.flash import flash_attention
from ..ops.linear import (TernaryLinear, concat_linears, linear_apply,
                          linear_apply_normed, with_col_scales)
from ..ops.rmsnorm import rms_norm
from ..ops.rope import apply_rope
from ..ops.ternary_matmul import (
    STACKED_DECODE_MAX_M,
    TL_W2A8_MAX_M,
    W2A8_DECODE_MAX_K,
    int8_matmul,
    quantize_rows,
    ternary_matmul_blockscale_bf16,
    ternary_matmul_tl_bf16_normed,
    ternary_matmul_tl_w2a8_normed,
    ternary_matmul_w2a8,
    ternary_matmul_w2a8_normed,
)

# the kinds the stacked decode loop takes (``:279-280``)
STACKED_DECODE_KINDS = ("qk256", "tl", "bitnet32")

# the cache dtypes the port runs, by the names decode_attn_plan reads
KV_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
                  torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


def kv_dtype_name(dtype: torch.dtype) -> str:
    """'bf16', 'f32', 'int8' or 'fp8' for a cache of ``dtype``."""
    if dtype not in KV_DTYPE_NAMES:
        raise ValueError(f"no KV cache of dtype {dtype}")
    return KV_DTYPE_NAMES[dtype]


def _to(x, device):
    return x if x is None or not hasattr(x, "to") else x.to(device)


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
    # the (data, model) mesh these are one rank's shard of
    # (``parallel/sharding.shard_params``), or None
    mesh: Optional[object] = None

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
def refuse_layout_knobs() -> None:
    """The JAX package's cache-layout knobs whose settings change what the
    stacked decode computes raise here (ROADMAP.md queue 1 #21): the port
    keeps one flat ``[L, B, S, KV*D]`` cache and writes every step's rows
    with K3.  ``BITNET_CACHE_YS=1`` runs the ys-threaded loop, whose
    quantized B ≤ 2 step attends over a dequantized cache
    (``bitnet_tpu/models/bitnet.py:729-790``); ``BITNET_CACHE_LAYOUT=5d``
    takes pools off ``batched_v2`` to ``einsum`` (``engine/cache.py:75-89``).
    ``BITNET_CACHE_FLAT`` and ``BITNET_ROWS_WRITE`` only move the cache
    between layouts or write its rows another way (the same rows at every
    valid position), and are ignored."""
    if os.environ.get("BITNET_CACHE_YS", "0") == "1":
        raise not_ported("BITNET_CACHE_YS=1 (the ys-threaded decode loop)", "#21")
    if os.environ.get("BITNET_CACHE_LAYOUT", "auto") == "5d":
        raise not_ported("BITNET_CACHE_LAYOUT=5d (a 5-D cache)", "#21")


def decode_attn_plan(B: int, kv_dtype: str = "bf16") -> str:
    """The decode-attention plan of the stacked loop, the JAX package's
    rule (``bitnet_tpu/models/bitnet.py:305-398``) for a cache named by
    :func:`kv_dtype_name`, with the environment knobs it reads and their
    defaults, evaluated with ``flat=True``: the port keeps the flat cache
    that the JAX engine allocates for every plan in ``_FLAT_PLANS``
    (``engine/cache.py:67-89``), and a plan outside that set reads the
    same from either layout.  Plans and their kernels (``_decode_stacked``):

    - ``qkv_v2s`` / ``qkv_quant_v2s`` (B ≤ 2, default): K2 / K7;
    - ``qkv`` / ``qkv_quant`` (``BITNET_B1_ATTN=v1``): K13 / K14;
    - ``qkv_batched_v2`` / ``qkv_quant_batched_v2``
      (``BITNET_BATCHED_ATTN=v2qkv``, 2 < B ≤ ``BITNET_V2_WHOLEBATCH_MAX_B``):
      K20 / K21;
    - ``qkv_batched`` / ``qkv_quant_batched`` (``BITNET_BATCHED_ATTN=1``,
      B > 2): K18 / K19;
    - ``flash`` / ``flash_quant`` (``BITNET_ROPE_FUSED=0``, B ≤
      ``BITNET_DECODE_ATTN_MAX_B``): K5 / K15;
    - ``batched_v2`` / ``quant_batched_v2`` (pools, default): K8 / K9, or
      K22 / K23 under ``BITNET_ATTN_STACKED=0``;
    - ``batched`` / ``quant_batched`` (``BITNET_BATCHED_ATTN`` set to
      anything else but 0 when no plan above applies): K16 / K17;
    - ``einsum``: plain torch (odd B > 16, or an fp8 cache under
      ``BITNET_FP8_KERNEL=0``).

    ``BITNET_CACHE_YS=1`` and ``BITNET_CACHE_LAYOUT=5d`` raise
    (:func:`refuse_layout_knobs`)."""
    refuse_layout_knobs()
    quantized = kv_dtype in ("int8", "fp8")
    rope_fused = os.environ.get("BITNET_ROPE_FUSED", "1") == "1"
    batched_env = os.environ.get("BITNET_BATCHED_ATTN", "v2")
    attn_max_b = int(os.environ.get("BITNET_DECODE_ATTN_MAX_B", "2"))
    v2_max_b = int(os.environ.get("BITNET_V2_WHOLEBATCH_MAX_B", "16"))
    v2_ok_b = B <= v2_max_b or (B % 2 == 0 and B <= STACKED_DECODE_MAX_M)
    dt_ok = kv_dtype != "fp8" or os.environ.get("BITNET_FP8_KERNEL", "1") == "1"
    q = "quant_" if quantized else ""
    if rope_fused and batched_env == "v2qkv" and 2 < B <= v2_max_b and dt_ok:
        return f"qkv_{q}batched_v2"
    if rope_fused and batched_env == "1" and B > 2 and dt_ok:
        return f"qkv_{q}batched"
    if rope_fused and B <= 2 and dt_ok:
        if os.environ.get("BITNET_B1_ATTN", "v2s") == "v2s":
            return f"qkv_{q}v2s"
        return "qkv_quant" if quantized else "qkv"
    if B <= attn_max_b and dt_ok:
        return "flash_quant" if quantized else "flash"
    if batched_env == "v2" and dt_ok and v2_ok_b:
        return f"{q}batched_v2"
    if batched_env not in ("0", "", "v2") and dt_ok:
        return f"{q}batched"
    return "einsum"


def stacked_weights_ok(cfg: ModelConfig, b: BlockParams,
                       kinds: tuple[str, ...] = ("qk256",)) -> bool:
    """Weight-side eligibility of the stacked prefill and decode
    (``_stacked_weights_ok``, ``:230-257``): fused stacks of one kind in
    ``kinds``, K == Kp for qk256 (the TL kinds take a padded K), silu, and
    norm widths that match."""
    if b.wqkv is None or b.w_gateup is None or cfg.hidden_act != "silu":
        return False
    lins = (b.wqkv, b.wo, b.w_gateup, b.w_down)
    if len({lin.kind for lin in lins}) != 1:
        return False
    for lin in lins:
        if lin.kind not in kinds or lin.packed.ndim != 3:
            return False
        if lin.kind == "qk256" and lin.packed.shape[1] * 16 != lin.k:
            return False
    if b.attn_sub_norm is not None and b.attn_sub_norm.shape[-1] != b.wo.k:
        return False
    if b.ffn_sub_norm is not None and b.ffn_sub_norm.shape[-1] != b.w_down.k:
        return False
    return (b.attn_norm.shape[-1] == b.wqkv.k
            and b.ffn_norm.shape[-1] == b.w_gateup.k)


def stacked_decode_ok(cfg: ModelConfig, params: BitNetParams, T: int, B: int,
                      kernel_path: str) -> bool:
    """The reference's gate (``_stacked_decode_ok``, ``:260-280``): one
    token a slot, B within K1's rows, path ``w2a8``, stacked weights of
    kind qk256, tl or bitnet32.  Every plan runs inside the loop, which
    reads it from the cache's dtype."""
    return (T == 1 and B <= STACKED_DECODE_MAX_M and kernel_path == "w2a8"
            and stacked_weights_ok(cfg, params.blocks, STACKED_DECODE_KINDS))


def stacked_prefill_ok(cfg: ModelConfig, params: BitNetParams, T: int,
                       kernel_path: str) -> bool:
    """``_stacked_prefill_ok`` (``:283-302``): qk256 only, so a TL prefill
    runs the layer loop; ``BITNET_STACKED_PREFILL`` other than 1 sends
    every prefill there too."""
    return (os.environ.get("BITNET_STACKED_PREFILL", "1") == "1" and T > 1
            and kernel_path == "w2a8" and stacked_weights_ok(cfg, params.blocks))


# --------------------------------------------------------------------------
# cache writes that drop positions >= S
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CacheWrites:
    """Where this call's new rows go, found once per forward call with
    fixed shapes (no host sync, no shape that depends on the data).  Every
    token (b, t) writes row min(pos, S-1) of slot b; a position >= S is
    DROPPED, not clamped (``mode="drop"``): it writes the row that this
    call leaves at S-1 anyway (the row of the slot's token at S-1 if it
    has one, else the row already there), so the write changes nothing.
    The prefill of the stacked path, every write of the generic path and
    the ``einsum`` plan's post-write view go through it."""

    b: torch.Tensor          # [B, T] slot of each token
    row: torch.Tensor        # [B, T] min(pos, S-1)
    valid: torch.Tensor      # [B, T] pos < S
    last: torch.Tensor       # [B] the token at S-1, if any (else 0)
    has_last: torch.Tensor   # [B]

    @classmethod
    def of(cls, q_positions: torch.Tensor, S: int) -> "CacheWrites":
        B, T = q_positions.shape
        at_last = q_positions == S - 1
        return cls(
            b=torch.arange(B, device=q_positions.device)[:, None].expand(B, T),
            row=torch.clamp(q_positions, max=S - 1).to(torch.int64),
            valid=q_positions < S, last=at_last.to(torch.int32).argmax(1),
            has_last=at_last.any(1))

    def put(self, layer: torch.Tensor, rows: torch.Tensor) -> None:
        """rows [B, T, ...] → one layer [B, S, W] of a cache (or scale)
        stack, in place."""
        B, T = self.row.shape
        new = rows.reshape(B, T, layer.shape[-1]).to(layer.dtype)
        keep = torch.where(self.has_last[:, None], new[self.b[:, 0], self.last],
                           layer[:, -1])
        layer.index_put_((self.b, self.row),
                         torch.where(self.valid[..., None], new, keep[:, None]))


# --------------------------------------------------------------------------
# decode (T == 1): K1 x4 and one attention kernel per layer, K3 once a step
# --------------------------------------------------------------------------
def _split_qkv(qkv: torch.Tensor, nh: int, nkv: int, D: int):
    """[B, T, (nh+2nkv)*D] → q [B, T, nh, D], k, v [B, T, nkv, D] (views)."""
    B, T = qkv.shape[:2]
    return (qkv[..., : nh * D].reshape(B, T, nh, D),
            qkv[..., nh * D: (nh + nkv) * D].reshape(B, T, nkv, D),
            qkv[..., (nh + nkv) * D:].reshape(B, T, nkv, D))


def _einsum_decode_attention(q, k_rows, v_rows, ks_rows, vs_rows, k_cache_l,
                             v_cache_l, k_scale_l, v_scale_l, writes,
                             q_positions, pre_len, act_dtype):
    """The ``einsum`` plan (odd B > 16, ``:698-717``): plain attention over
    a copy of the layer with this step's rows written (drop at S); a
    quantized copy is dequantized to the activation dtype."""
    B, S = k_cache_l.shape[:2]
    nkv, D = k_rows.shape[-2:]
    kc, vc = k_cache_l.clone(), v_cache_l.clone()
    writes.put(kc, k_rows)
    writes.put(vc, v_rows)
    k_read, v_read = kc.view(B, S, nkv, D), vc.view(B, S, nkv, D)
    if k_scale_l is not None:
        ks, vs = k_scale_l.clone(), v_scale_l.clone()
        writes.put(ks, ks_rows)
        writes.put(vs, vs_rows)
        k_read = dequantize_kv(k_read, ks).to(act_dtype)
        v_read = dequantize_kv(v_read, vs).to(act_dtype)
    return attention(q, k_read, v_read, q_positions, pre_len + 1)[:, 0]


def _stacked_mm(b: BlockParams, B: int, eps: float):
    """The four matmuls of a stacked decode layer, ``mm(l, h, name, gamma,
    glu=, resid=)``, by the weights' kind (``:439-499``): qk256 on K1; the
    TL kinds on K11 when B <= 2 and every K is a multiple of 256 and at most
    ``W2A8_DECODE_MAX_K``, else K12 when aligned, else K10 on the stacked
    weights with SwiGLU, the norm and the residual in torch
    (``BITNET_TL_W2A8`` / ``BITNET_TL_FUSED`` set to anything but 1 skip
    K11 / K12, as in the JAX package)."""
    kind = b.wqkv.kind
    if kind == "qk256":
        def mm(l, h, name, gamma, **kw):
            lin = getattr(b, name)
            return ternary_matmul_w2a8_normed(l, h, lin.packed, lin.col_scales,
                                              gamma, k_dim=lin.k, n_dim=lin.n,
                                              eps=eps, **kw)
        return mm
    lut_bias = kind == "bitnet32"
    ks = [getattr(b, n).k for n in ("wqkv", "wo", "w_gateup", "w_down")]
    aligned = all(k % 256 == 0 for k in ks)
    # ``:473-476``: BITNET_TL_W2A8=0 keeps B <= 2 off K11, BITNET_TL_FUSED=0
    # keeps every B off K12 (K10 then, with the norm etc. in torch).  The
    # JAX kernel takes any aligned K; K11's kernel holds the rows in shared
    # memory, so a layer with a longer row (Falcon3-7B's F = 23040) decodes
    # on K12
    if (os.environ.get("BITNET_TL_W2A8", "1") == "1" and aligned
            and B <= TL_W2A8_MAX_M and max(ks) <= W2A8_DECODE_MAX_K):
        fused = ternary_matmul_tl_w2a8_normed
    elif os.environ.get("BITNET_TL_FUSED", "1") == "1" and aligned:
        fused = ternary_matmul_tl_bf16_normed
    else:
        fused = None

    def mm_tl(l, h, name, gamma, glu=False, resid=None):
        lin = getattr(b, name)
        if fused is not None:
            return fused(l, h, lin.packed, lin.scales, gamma, k_dim=lin.k,
                         n_dim=lin.n, eps=eps, glu=glu, resid=resid,
                         lut_bias=lut_bias)
        x2 = h
        if glu:
            K2 = x2.shape[1] // 2
            gate = x2[:, :K2]
            x2 = gate * torch.sigmoid(gate) * x2[:, K2:]
        if gamma is not None:
            x2 = rms_norm(x2, gamma[l], eps)
        y = ternary_matmul_blockscale_bf16(l, x2.contiguous(), lin.packed,
                                           lin.scales, k_dim=lin.k, n_dim=lin.n,
                                           lut_bias=lut_bias)
        return y if resid is None else y + resid
    return mm_tl


# each plan's attention wrapper: the rope-fused ones take the raw q|k|v
# row (``:528-624``, ``:856-876``), the others q and the new rows apart with
# RoPE in torch (``:625-697``, ``:878-901``)
ROPE_FUSED_ATTN = {
    "qkv_v2s": decode_attention_qkv, "qkv_quant_v2s": decode_attention_qkv_quant,
    "qkv": decode_attention_qkv_v1, "qkv_quant": decode_attention_qkv_quant_v1,
    "qkv_batched": decode_attention_qkv_batched,
    "qkv_quant_batched": decode_attention_qkv_quant_batched,
    "qkv_batched_v2": decode_attention_qkv_batched_v2,
    "qkv_quant_batched_v2": decode_attention_qkv_quant_batched_v2}
SPLIT_ATTN = {
    "flash": decode_attention, "flash_quant": decode_attention_quant,
    "batched": decode_attention_batched_v1,
    "quant_batched": decode_attention_quant_batched_v1,
    "batched_v2": decode_attention_batched,
    "quant_batched_v2": decode_attention_quant_batched}
# the per-layer-slice v2 kernels that BITNET_ATTN_STACKED=0 selects
UNSTACKED_V2_ATTN = {"batched_v2": decode_attention_batched_v2,
                     "quant_batched_v2": decode_attention_quant_batched_v2}


def plan_attention(plan: str):
    """(rope-fused wrapper, split wrapper) of a plan, one of them None, or
    both None for the ``einsum`` tail.  The v2 plans read the whole cache
    stack (``:839-842``) unless ``BITNET_ATTN_STACKED=0``, which sends
    ``batched_v2`` / ``quant_batched_v2`` to the per-layer-slice kernels
    K22 / K23 and ``qkv_v2s`` / ``qkv_quant_v2s`` to the ``einsum`` tail
    (``:698-717``; the JAX package's flat-cache loop fails there on its 5-D
    rows, and runs that tail under ``BITNET_CACHE_FLAT=0``).  The
    ``paged`` plan (K33 over a page pool) is :func:`forward_paged_decode`'s,
    never a dense cache's."""
    stacked = os.environ.get("BITNET_ATTN_STACKED", "1") == "1"
    if plan.endswith("v2s") and not stacked:
        return None, None
    if plan in UNSTACKED_V2_ATTN and not stacked:
        return None, UNSTACKED_V2_ATTN[plan]
    return ROPE_FUSED_ATTN.get(plan), SPLIT_ATTN.get(plan)


def _decode_stacked(cfg: ModelConfig, params: BitNetParams,
                    x: torch.Tensor,             # [B, 1, H]
                    q_positions: torch.Tensor,   # [B, 1]
                    k_cache: torch.Tensor,       # [L, B, S, KV*D] flat
                    v_cache: torch.Tensor,
                    pre_len: torch.Tensor,       # [B] valid cache rows
                    sin_rows: torch.Tensor,      # [B, 1, D/2]
                    cos_rows: torch.Tensor,
                    k_scale: torch.Tensor | None = None,   # [L, B, S, KV]
                    v_scale: torch.Tensor | None = None,
                    paged: tuple | None = None) -> torch.Tensor:
    """The stacked decode loop (``:401``, rows mode): per layer four
    matmuls (:func:`_stacked_mm`) and the plan's attention over the
    PRE-write cache (:func:`plan_attention`), then ONE K3 write of all L
    new rows (and scales) at min(pos, S-1) — the clamped write of every
    rows-mode plan (``:932-1038``).

    ``paged`` = (k_pool, v_pool, tables, page, offset, lengths) selects the
    ``paged`` plan (:func:`forward_paged_decode`): no dense cache; each
    layer's new rows (RoPE in torch) are written into their pages first,
    then K33 attends over ``lengths`` positions through the block table,
    q cast to the pool's dtype and scaled by 1/sqrt(D) in f32 (K33 takes
    no scale)."""
    b = params.blocks
    B = x.shape[0]
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = b.attn_norm.shape[0]
    eps = cfg.rms_norm_eps
    quantized = k_scale is not None
    if paged is not None:
        plan, rope_attn, split_attn = "paged", None, None
        k_pool, v_pool, tables, gpage, goff, attn_len = paged
    else:
        S = k_cache.shape[2]
        plan = decode_attn_plan(B, kv_dtype_name(k_cache.dtype))
        rope_attn, split_attn = plan_attention(plan)

    mm = _stacked_mm(b, B, eps)

    sin_r = sin_rows[:, 0].contiguous()
    cos_r = cos_rows[:, 0].contiguous()
    pos = pre_len.to(torch.int32).contiguous()
    scales = (k_scale, v_scale) if quantized else ()
    einsum = rope_attn is None and split_attn is None and paged is None
    writes = CacheWrites.of(q_positions, S) if einsum else None
    h = x[:, 0, :]
    rows = []                                    # per layer (k, v, k_s, v_s)
    for l in range(L):
        qkv = mm(l, h, "wqkv", b.attn_norm)
        ksr = vsr = None
        if rope_attn is not None:
            attn, kr, vr, *rs = rope_attn(
                l, qkv.view(B, nh + 2 * nkv, D), sin_r, cos_r, k_cache, v_cache,
                *scales, pos, n_heads=nh, n_kv=nkv)
            if quantized:
                ksr, vsr = rs
        else:                    # RoPE in torch, one call for the q|k heads
            qk = apply_rope(qkv[:, None, : (nh + nkv) * D].view(B, 1, nh + nkv, D),
                            sin_rows, cos_rows)
            q, kn = qk[:, :, :nh], qk[:, :, nh:]
            vn = qkv[:, None, (nh + nkv) * D:].view(B, 1, nkv, D)
            if quantized:
                kr, ksr = quantize_kv(kn[:, 0], k_cache.dtype)
                vr, vsr = quantize_kv(vn[:, 0], v_cache.dtype)
                # the ROUND-TRIPPED rows feed attention (``:632-639``)
                kn = dequantize_kv(kr, ksr).to(x.dtype)[:, None]
                vn = dequantize_kv(vr, vsr).to(x.dtype)[:, None]
            elif paged is not None:
                kr, vr = kn[:, 0].to(k_pool.dtype), vn[:, 0].to(v_pool.dtype)
            else:
                kr, vr = kn[:, 0].to(k_cache.dtype), vn[:, 0].to(v_cache.dtype)
            if paged is not None:
                k_pool[l][:, gpage, goff] = kr.transpose(0, 1)
                v_pool[l][:, gpage, goff] = vr.transpose(0, 1)
                qs = q[:, 0].to(k_pool.dtype).to(torch.float32) * (1.0 / D ** 0.5)
                attn = paged_attention(qs, k_pool[l], v_pool[l], attn_len,
                                       tables).to(x.dtype)
            elif split_attn is not None:
                attn = split_attn(l, q[:, 0].contiguous(), kn[:, 0].contiguous(),
                                  vn[:, 0].contiguous(), k_cache, v_cache, *scales,
                                  pos)
            else:
                attn = _einsum_decode_attention(
                    q, kr, vr, ksr, vsr, k_cache[l], v_cache[l],
                    None if k_scale is None else k_scale[l],
                    None if v_scale is None else v_scale[l], writes,
                    q_positions, pre_len, x.dtype)
        h = mm(l, attn.reshape(B, nh * D), "wo", b.attn_sub_norm, resid=h)
        gu = mm(l, h, "w_gateup", b.ffn_norm)
        h = mm(l, gu, "w_down", b.ffn_sub_norm, glu=True, resid=h)
        rows.append((kr, vr, ksr, vsr))
    if paged is not None:
        return h[:, None, :]

    def stack(i, width):
        return torch.stack([r[i] for r in rows]).view(L, B, 1, width)

    # ONE write of all L new rows, after every layer read its PRE-write cache
    row_scales = ((k_scale, v_scale, stack(2, nkv), stack(3, nkv)) if quantized
                  else ())
    scatter_kv_rows(k_cache, v_cache, stack(0, nkv * D), stack(1, nkv * D),
                    q_positions[:, 0].to(torch.int32).contiguous(), *row_scales)
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
                     cos_rows: torch.Tensor,
                     k_scale: torch.Tensor | None = None,   # [L, B, S, KV]
                     v_scale: torch.Tensor | None = None,
                     trace: Callable[[str, torch.Tensor], None] | None = None
                     ) -> torch.Tensor:
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
        q, kn, vn = _split_qkv(qkv, nh, nkv, D)
        q = apply_rope(q, sin_rows, cos_rows)
        kn = apply_rope(kn, sin_rows, cos_rows)
        k_read, v_read = _write_and_read(l, kn, vn, k_cache, v_cache, k_scale,
                                         v_scale, writes)
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
        if trace is not None:
            trace(f"blk.{l}.out", h2.reshape(B, T, H))
    return h2.reshape(B, T, H)


def _write_and_read(l: int, k: torch.Tensor, v: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
                    writes: CacheWrites):
    """Write layer ``l``'s new rows k, v [B, T, KV, D] (drop at S) and
    return the cache to attend over, [B, S, KV, D]: the cache itself, or
    for a quantized cache the rows' codes and scales written and the whole
    layer dequantized to f32 (``:1118-1130``, ``:1337-1345``)."""
    B, S = k_cache.shape[1], k_cache.shape[2]
    nkv, D = k.shape[-2:]
    if k_scale is not None:
        kq, ks = quantize_kv(k, k_cache.dtype)
        vq, vs = quantize_kv(v, v_cache.dtype)
        for layer, rows in ((k_cache[l], kq), (v_cache[l], vq),
                            (k_scale[l], ks), (v_scale[l], vs)):
            writes.put(layer, rows)
        return (dequantize_kv(k_cache[l].view(B, S, nkv, D), k_scale[l]),
                dequantize_kv(v_cache[l].view(B, S, nkv, D), v_scale[l]))
    writes.put(k_cache[l], k)
    writes.put(v_cache[l], v)
    return k_cache[l].view(B, S, nkv, D), v_cache[l].view(B, S, nkv, D)


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
    (fused into K1 at decode rows).  Under ``BITNET_FUSED_FFN=1``, on path
    ``w2a8`` with fused gate|up, SiLU and no ffn_sub_norm, where
    :func:`fused_ffn_supported` holds (at most 32 rows), the whole FFN is
    one K24 call on ``rms_norm(x)`` (rounded to x's dtype, as the JAX
    package rounds it) plus the residual (``:184-200``): per-F-tile int8
    requantization, another function than the two projections'."""
    B, T, H = x.shape
    if (os.environ.get("BITNET_FUSED_FFN", "0") == "1" and kernel_path == "w2a8"
            and cfg.hidden_act == "silu" and bp.ffn_sub_norm is None
            and bp.w_gateup is not None and fused_ffn_supported(bp, B * T)):
        gu, down = bp.w_gateup, bp.w_down
        h = rms_norm(x, bp.ffn_norm[l], cfg.rms_norm_eps)
        y = ffn_w2a8_fused(l, h.reshape(B * T, H), gu.packed, gu.col_scales,
                           down.packed, down.col_scales, f_dim=gu.n // 2,
                           n_dim=down.n)
        return x + y.reshape(B, T, down.n)
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


def fused_ffn_supported(bp: BlockParams, M: int) -> bool:
    """Where the JAX ``_ffn`` takes ``ffn_w2a8_fused`` (``:190-192``):
    ``ffn_fused_supported`` (qk256 gate|up and down, F a multiple of 256
    that the down projection's K fills, at most 32 rows) and the fused
    gate|up exactly 2F wide."""
    gu = bp.w_gateup
    F = gu.n // 2
    return (ffn_fused_supported(gu, bp.w_down, F, M)
            and gu.packed.shape[-1] == 2 * F)


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
        q, k, v = _split_qkv(lapn(bp.wqkv, x, bp.attn_norm), nh, nkv, D)
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
                  kernel_path: str, writes: CacheWrites,
                  k_scale: torch.Tensor | None = None,
                  v_scale: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None,
                  window: int | None = None,
                  ring: bool = False) -> torch.Tensor:
    """Layer ``l`` of the generic path (``:1241-1367``) over the flat cache
    stack [L, B, S, KV*D] (bf16, or int8 / fp8 with its scale stacks),
    written in place.

    ``fast_decode`` (T=1, B≤2, a bf16 cache, path ``pallas``/``w2a8``): K5
    attends over the PRE-write cache with the new token folded in, then the
    rows are written; with fused projections and ``BITNET_ROPE_FUSED=1``
    (``:1286-1307``) K13 takes the raw q|k|v row instead, applies RoPE and
    hands back the rows to write.  Otherwise the rows are written first
    (quantized for an int8 / fp8 cache) and plain ``attention`` (or
    ``flash_attention`` once T·S ≥ 2^19, without ``kv_positions``) reads
    the cache, dequantized to f32 if it is quantized.

    ``ring`` (``write_slots`` given to :func:`forward`; ``writes`` then
    holds the slots), ``kv_positions`` [B, S] and ``window`` are the
    windowed ring cache's (``:1255-1364``): the rows go to their ring
    slots and attention masks by each slot's true position and the
    window; they take the write-then-attend branch, never ``fast_decode``."""
    B, T, _ = x.shape
    S = k_cache.shape[2]
    fast_decode = (T == 1 and B <= 2 and k_scale is None and not ring
                   and kv_positions is None and window is None
                   and kernel_path in ("pallas", "w2a8"))
    if (fast_decode and bp.wqkv is not None
            and os.environ.get("BITNET_ROPE_FUSED", "0") == "1"):
        qkv = linear_apply_normed(bp.wqkv, x, bp.attn_norm, eps=cfg.rms_norm_eps,
                                  path=kernel_path, layer=l)
        nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn1, k_row, v_row = decode_attention_qkv_v1(
            l, qkv[:, 0].reshape(B, nh + 2 * nkv, D).contiguous(),
            sin_rows[:, 0].contiguous(), cos_rows[:, 0].contiguous(), k_cache,
            v_cache, pre_len, n_heads=nh, n_kv=nkv)
        writes.put(k_cache[l], k_row[:, None])
        writes.put(v_cache[l], v_row[:, None])
        return block_finish(cfg, bp, x, attn1[:, None], kernel_path, l)
    q, k, v = block_qkv(cfg, bp, x, sin_rows, cos_rows, kernel_path, l)
    if fast_decode:
        attn1 = decode_attention(l, q[:, 0].contiguous(), k[:, 0].contiguous(),
                                 v[:, 0].contiguous(), k_cache, v_cache, pre_len)
        writes.put(k_cache[l], k)
        writes.put(v_cache[l], v)
        return block_finish(cfg, bp, x, attn1[:, None], kernel_path, l)
    k_read, v_read = _write_and_read(l, k, v, k_cache, v_cache, k_scale, v_scale,
                                     writes)
    if kv_positions is None and T > 1 and T * S >= (1 << 19):
        attn = flash_attention(q, k_read, v_read, q_positions, pre_len + T,
                               window=window)
    else:
        attn = attention(q, k_read, v_read, q_positions, pre_len + T,
                         kv_positions=kv_positions, window=window)
    return block_finish(cfg, bp, x, attn, kernel_path, l)


def run_layers(cfg: ModelConfig, params: BitNetParams, x: torch.Tensor,
               q_positions: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pre_len: torch.Tensor, sin_rows: torch.Tensor, cos_rows: torch.Tensor,
               kernel_path: str = "xla", k_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None,
               trace: Callable[[str, torch.Tensor], None] | None = None,
               write_slots: torch.Tensor | None = None,
               kv_positions: torch.Tensor | None = None,
               window: int | None = None) -> torch.Tensor:
    """The generic layer loop of :func:`forward` (``block_forward`` over
    every layer of ``params.blocks`` and of the cache stack, written in
    place) from the residual stream ``x`` [B, T, H]; returns the last
    layer's output, before the final norm.  The pipeline stages run their
    own layers through it (``parallel/pipeline.py``)."""
    ring = write_slots is not None or kv_positions is not None or window is not None
    writes = CacheWrites.of(q_positions if write_slots is None else write_slots,
                            k_cache.shape[2])
    pos = pre_len.to(torch.int32).contiguous()
    h = x
    for l in range(k_cache.shape[0]):
        h = block_forward(cfg, h, params.blocks, l, sin_rows, cos_rows, q_positions,
                          k_cache, v_cache, pos, kernel_path, writes, k_scale, v_scale,
                          kv_positions=kv_positions, window=window, ring=ring)
        if trace is not None:
            trace(f"blk.{l}.out", h)
    return h


def rope_rows(params: BitNetParams, q_positions: torch.Tensor):
    """The RoPE rows of ``q_positions`` [B, T], gathered once for all layers
    at positions clamped to the table."""
    rp = torch.clamp(q_positions.to(torch.int64), max=params.rope_sin.shape[0] - 1)
    return params.rope_sin[rp], params.rope_cos[rp]


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
            kernel_path: str = "xla",
            k_scale: torch.Tensor | None = None,   # [L, B, S, KV] (int8/fp8)
            v_scale: torch.Tensor | None = None,
            trace: Callable[[str, torch.Tensor], None] | None = None,
            write_slots: torch.Tensor | None = None,   # [B, T] ring slots
            kv_positions: torch.Tensor | None = None,  # [B, S] abs pos a slot
            window: int | None = None):
    """Returns (final-normed hidden [B, T, H], k_cache, v_cache); the
    caches (and a quantized cache's scale stacks) are written in place.
    ``write_slots`` decouples where a row is stored from its position (a
    slot of S drops the write), ``kv_positions`` gives each slot's true
    position (-1 = empty) and ``window`` the sliding window, as the
    windowed ring cache passes them (``bitnet_tpu/models/bitnet.py:1370``):
    any of them takes the generic layer loop (the JAX stacked gates refuse
    them, ``:273-274``, ``:298-299``).
    ``trace(name, tensor)``, when given, sees the embedding rows
    (``token_embd``), each layer's output (``blk.<l>.out``) of the prefill
    loops, and the final-normed hidden state (``output_norm``), all
    [B, T, H]; the stacked decode loop records only the ends."""
    if (kv_dtype_name(k_cache.dtype) in ("int8", "fp8")) != (k_scale is not None):
        raise ValueError("an int8 / fp8 cache needs its scale stacks, a bf16 / "
                         "f32 cache none")
    mesh, gather = params.mesh, False
    if mesh is not None:
        # one rank's shard: its heads and FFN columns, and on the data axis
        # its rows of the batch (the rows of its cache), the hidden states
        # gathered back after the final norm
        cfg = mesh.local_cfg(cfg)
        Bl = k_cache.shape[1]
        gather = tokens.shape[0] != Bl
        tokens, q_positions, kv_valid_len, num_real_tokens = (
            mesh.data_rows(t, Bl) for t in (tokens, q_positions, kv_valid_len,
                                              num_real_tokens))
        if tokens.shape[0] != Bl:
            raise ValueError(f"{tokens.shape[0]} rows for a cache of {Bl} on a "
                             f"mesh of {mesh.shape}")
    x = embed_tokens(params, tokens)
    if trace is not None:
        trace("token_embd", x)
    B, T, _ = x.shape
    if num_real_tokens is None:
        num_real_tokens = T
    # attention masks with pre_len + T == kv_valid_len + num_real_tokens
    pre_len = kv_valid_len + (num_real_tokens - T)
    sin_rows, cos_rows = rope_rows(params, q_positions)
    scales = (k_scale, v_scale)
    ring = write_slots is not None or kv_positions is not None or window is not None
    if not ring and stacked_decode_ok(cfg, params, T, B, kernel_path):
        h = _decode_stacked(cfg, params, x, q_positions, k_cache, v_cache,
                            pre_len, sin_rows, cos_rows, *scales)
    elif not ring and stacked_prefill_ok(cfg, params, T, kernel_path):
        h = _prefill_stacked(cfg, params, x, q_positions, k_cache, v_cache,
                             pre_len, sin_rows, cos_rows, *scales, trace=trace)
    else:
        h = run_layers(cfg, params, x, q_positions, k_cache, v_cache, pre_len, sin_rows,
                       cos_rows, kernel_path, *scales, trace=trace,
                       write_slots=write_slots, kv_positions=kv_positions, window=window)
    h = rms_norm(h, params.final_norm, cfg.rms_norm_eps)
    if gather:
        h = mesh.gather_rows(h)
    if trace is not None:
        trace("output_norm", h)
    return h, k_cache, v_cache


def forward_paged_decode(cfg: ModelConfig, params: BitNetParams,
                         tokens: torch.Tensor,        # [B, 1]
                         q_positions: torch.Tensor,   # [B, 1]; idle slots: the view length
                         cache,                       # engine.paged_cache.PagedKVCache
                         num_real_tokens: torch.Tensor | int = 1) -> torch.Tensor:
    """One decode step of the stacked loop over the page pool, plan
    ``paged`` (:func:`_decode_stacked`): no dense view is built; the new
    rows go to ``tables[b, pos // page]`` at ``pos % page`` (idle slots and
    unassigned blocks to the scratch page) and K33 attends over
    ``lengths + num_real_tokens`` positions.  Returns the final-normed
    hidden [B, 1, H]; the caller advances ``cache.lengths``."""
    from ..engine.paged_cache import row_slots

    x = embed_tokens(params, tokens)
    pre_len = cache.lengths + (num_real_tokens - 1)
    sin_rows, cos_rows = rope_rows(params, q_positions)
    gpage, goff = row_slots(cache, q_positions)
    attn_len = (pre_len + 1).to(torch.int32).contiguous()
    h = _decode_stacked(cfg, params, x, q_positions, None, None, pre_len, sin_rows,
                        cos_rows, paged=(cache.k, cache.v, cache.tables, gpage[:, 0],
                                         goff[:, 0], attn_len))
    return rms_norm(h, params.final_norm, cfg.rms_norm_eps)


def forward_cache(cfg: ModelConfig, params: BitNetParams,
                  tokens: torch.Tensor, q_positions: torch.Tensor, cache,
                  num_real_tokens: torch.Tensor | int | None = None,
                  kernel_path: str = "xla",
                  trace: Callable[[str, torch.Tensor], None] | None = None):
    """:func:`forward` on an ``engine.cache.KVCache``; advances its lengths
    in place and returns (hidden, cache)."""
    if num_real_tokens is None:
        num_real_tokens = tokens.shape[1]
    h, _, _ = forward(cfg, params, tokens, q_positions, cache.k, cache.v,
                      cache.lengths, num_real_tokens, kernel_path,
                      cache.k_scale, cache.v_scale, trace)
    if params.mesh is not None:
        num_real_tokens = params.mesh.data_rows(num_real_tokens, cache.lengths.shape[0])
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
        out = linear_apply(params.lm_head, hidden, path=kernel_path)
        sh = params.lm_head.shard
        # column-parallel on the vocab: every rank's slice, gathered
        return out if sh is None else sh.group.all_gather(out, dim=-1)
    if params.embed_q is not None and kernel_path == "w2a8":
        # int8 head: per-token activation scale x per-row table scale
        xq, sx, _ = quantize_rows(hidden.reshape(B * T, H).to(torch.float32))
        acc = int8_matmul(xq, params.embed_q.t())
        out = acc.to(torch.float32) * sx[:, None] * params.embed_q_scale[None, :]
        return out.reshape(B, T, -1)
    return tied_head(hidden.reshape(B * T, H), params.embed).reshape(B, T, -1)
