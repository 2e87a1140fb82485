"""Carry weights and KV caches across from the JAX package.

``params_from_arrays`` takes ``bitnet_tpu``'s ``BitNetParams`` as a
nested dict of numpy arrays (dataclass fields → dict keys; a
``TernaryLinear`` → ``{"kind", "k", "n", "weight", "packed", "scales"}``;
absent fields → None) and returns the port's params, so both packages
compute the same function from the same numbers; ``cache_from_arrays``
does the same for a ``KVCache``.  It reads only numpy:
the caller turns the JAX arrays into numpy (``np.asarray``), so this
module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device_probe import resolve_device
from ..engine.cache import KVCache
from ..ops.linear import BLOCK_KINDS, TernaryLinear, dense_linear
from .bitnet import BitNetParams, BlockParams


def _tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":     # ml_dtypes float8_e4m3fn
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _linear(d, device) -> TernaryLinear | None:
    """A dense, qk256, bitnet32 or tl linear.  The JAX package keeps block
    scales ``[(L,) K/32, Np]``; the port's are zero-padded to ``Kp/32``
    rows.  A dense linear carries its weight in its own dtype."""
    if d is None:
        return None
    if d["kind"] == "dense":
        return dense_linear(_tensor(d["weight"], device))
    if d["kind"] not in ("qk256", *BLOCK_KINDS):
        raise ValueError(f"unknown linear kind {d['kind']!r}")
    packed = _tensor(d["packed"], device)
    scales = _tensor(d["scales"], device).to(torch.float32)
    if d["kind"] in BLOCK_KINDS:
        pad = packed.shape[-2] // 2 - scales.shape[-2]
        scales = torch.nn.functional.pad(scales, (0, 0, 0, pad))
    return TernaryLinear(kind=d["kind"], k=int(d["k"]), n=int(d["n"]),
                         packed=packed, scales=scales)


def params_from_arrays(tree: dict, device="cuda") -> BitNetParams:
    """A JAX ``BitNetParams`` tree (as numpy) → the port's params, on the
    card unless the caller passes ``device="cpu"`` (without CUDA it
    raises)."""
    device = resolve_device(device)
    b = tree["blocks"]
    lin_names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "wqkv", "w_gateup")
    vec_names = ("attn_norm", "ffn_norm", "attn_sub_norm", "ffn_sub_norm")
    blocks = BlockParams(
        **{n: _linear(b.get(n), device) for n in lin_names},
        **{n: _tensor(b.get(n), device) for n in vec_names})
    return BitNetParams(
        embed=_tensor(tree["embed"], device), blocks=blocks,
        final_norm=_tensor(tree["final_norm"], device),
        rope_sin=_tensor(tree["rope_sin"], device),
        rope_cos=_tensor(tree["rope_cos"], device),
        embed_q=_tensor(tree.get("embed_q"), device),
        embed_q_scale=_tensor(tree.get("embed_q_scale"), device),
        lm_head=_linear(tree.get("lm_head"), device))


def cache_from_arrays(k, v, lengths, k_scale=None, v_scale=None,
                      device="cuda") -> KVCache:
    """A JAX ``KVCache``'s arrays (as numpy) → the port's flat cache: k / v
    [L, B, S, KV, D] or flat [L, B, S, KV*D] (bf16, int8 or fp8), lengths
    [B], and for a quantized cache the f32 scales [L, B, S, KV], which the
    port keeps in the same layout.  On the card unless the caller passes
    ``device="cpu"``, as ``allocate_cache``."""
    device = resolve_device(device)
    def flat(a):
        a = np.asarray(a)
        return a.reshape(*a.shape[:3], -1)

    return KVCache(k=_tensor(flat(k), device), v=_tensor(flat(v), device),
                   lengths=_tensor(lengths, device).to(torch.int32),
                   k_scale=_tensor(k_scale, device),
                   v_scale=_tensor(v_scale, device))
