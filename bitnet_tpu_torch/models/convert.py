"""Carry weights across from the JAX package's parameters.

``params_from_arrays`` takes ``bitnet_tpu``'s ``BitNetParams`` as a
nested dict of numpy arrays (dataclass fields → dict keys; a
``TernaryLinear`` → ``{"kind", "k", "n", "weight", "packed", "scales"}``;
absent fields → None) and returns the port's params, so both packages
compute the same function from the same numbers.  It reads only numpy:
the caller turns the JAX arrays into numpy (``np.asarray``), so this
module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linear import TernaryLinear
from .bitnet import BitNetParams, BlockParams


def _tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _linear(d, device) -> TernaryLinear | None:
    if d is None:
        return None
    if d["kind"] != "qk256":
        raise NotImplementedError(
            f"{d['kind']} linears are not ported yet (ROADMAP.md queue 1 "
            f"{'#10' if d['kind'] in ('tl', 'bitnet32') else '#7'})")
    return TernaryLinear(kind="qk256", k=int(d["k"]), n=int(d["n"]),
                         packed=_tensor(d["packed"], device),
                         scales=_tensor(d["scales"], device).to(torch.float32))


def params_from_arrays(tree: dict, device="cpu") -> BitNetParams:
    if tree.get("lm_head") is not None:
        raise NotImplementedError("an untied output head is not ported yet "
                                  "(ROADMAP.md queue 1 #7)")
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
        embed_q_scale=_tensor(tree.get("embed_q_scale"), device))
