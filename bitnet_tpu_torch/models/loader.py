"""GGUF → BitNetParams loader (numpy route, tensors on the CPU).

Counterpart of ``bitnet_tpu/models/loader.py`` (``load_model`` ``:334``)
for the flavors slice 1 runs: ternary linears in I2_S QK256 (either
orientation), everything else (embedding, norms) in F32 or F16.  Other
I2_S flavors and other tensor types raise a ModelError naming the ROADMAP
item that ports them.  The QK256 repack is the numpy route; the JAX
package's native codec (``loader.py:228-234``) is not ported, and on a
real 2B checkpoint this route takes minutes (``loader.py:229-230``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..errors import ModelError
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader, TensorInfo
from ..ops.linear import TernaryLinear, qk256_linear_from_payload
from ..ops.rope import build_rope_tables
from ..quant.flavor import I2SFlavor, detect_i2s_flavor
from .bitnet import BitNetParams, BlockParams
from .config import config_from_gguf
from .weight_map import find_global, find_layer, require_layer


def _to_float(reader: GGUFReader, info: TensorInfo) -> np.ndarray:
    if info.ggml_type in (GGMLType.F32, GGMLType.F16):
        return np.asarray(reader.tensor_data(info.name), dtype=np.float32)
    raise ModelError(
        f"{info.name}: tensor type {info.ggml_type.name} is not ported yet "
        "(the port loads F32/F16 and I2_S QK256; ROADMAP.md queue 1 #7)")


def _load_linear(reader: GGUFReader, name: str, out_dim: int,
                 in_dim: int) -> TernaryLinear:
    """One [out, in] QK256 weight → TernaryLinear ([K=in, N=out])."""
    info = reader.tensors[name]
    if info.ggml_type != GGMLType.I2_S:
        raise ModelError(
            f"{name}: {info.ggml_type.name} linears run the generic path, "
            "not ported yet (ROADMAP.md queue 1 #7)")
    flavor = detect_i2s_flavor(info.nelems, info.nbytes, name=name,
                               cols=int(info.shape[0]) if info.shape else None)
    if flavor != I2SFlavor.GGML_QK256_NO_SCALE:
        raise ModelError(
            f"{name}: I2_S flavor {flavor.value} is not ported yet "
            "(ROADMAP.md queue 1 #10)")
    shape = info.logical_shape
    if shape == (out_dim, in_dim):
        transposed = False
    elif shape == (in_dim, out_dim):
        transposed = True
    else:
        raise ModelError(f"{name}: shape {shape} incompatible with expected "
                         f"({out_dim}, {in_dim})")
    return qk256_linear_from_payload(reader.tensor_bytes(name), out_dim,
                                     in_dim, transposed=transposed)


def _stack_linears(lins: list[TernaryLinear]) -> TernaryLinear:
    return TernaryLinear(kind="qk256", k=lins[0].k, n=lins[0].n,
                         packed=torch.stack([l.packed for l in lins]),
                         scales=torch.stack([l.scales for l in lins]))


def _vec(reader: GGUFReader, name: str, n: int) -> torch.Tensor:
    return torch.from_numpy(_to_float(reader, reader.tensors[name]).reshape(n).copy())


def load_model(path: str, max_seq_len: int | None = None,
               param_dtype: torch.dtype = torch.bfloat16
               ) -> tuple[ModelConfig, BitNetParams, dict]:
    """Load a BitNet GGUF.  Returns (cfg, params on the CPU, metadata with
    ``eos_token_id``)."""
    with GGUFReader(path) as r:
        cfg = config_from_gguf(r)
        if not cfg.tie_word_embeddings:
            raise ModelError("an untied output head is not ported yet "
                             "(ROADMAP.md queue 1 #7)")
        names = set(r.tensors)
        emb_name = find_global(names, "token_embd")
        if emb_name is None:
            raise ModelError("no token embedding tensor found")
        embed = _to_float(r, r.tensors[emb_name]).reshape(-1, cfg.hidden_size)
        if embed.shape[0] < cfg.vocab_size:
            raise ModelError(
                f"embedding rows {embed.shape[0]} < vocab {cfg.vocab_size}")
        embed = embed[: cfg.vocab_size]

        H, F = cfg.hidden_size, cfg.intermediate_size
        nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        shapes = {"attn_q": (nh * D, H), "attn_k": (nkv * D, H),
                  "attn_v": (nkv * D, H), "attn_output": (H, nh * D),
                  "ffn_gate": (F, H), "ffn_up": (F, H), "ffn_down": (H, F)}
        lin: dict[str, list] = {k: [] for k in shapes}
        norms: dict[str, list] = {"attn_norm": [], "ffn_norm": [],
                                  "attn_sub_norm": [], "ffn_sub_norm": []}
        widths = {"attn_norm": H, "ffn_norm": H, "attn_sub_norm": nh * D,
                  "ffn_sub_norm": F}
        for i in range(cfg.num_layers):
            for role, (o, k) in shapes.items():
                lin[role].append(_load_linear(r, require_layer(names, role, i), o, k))
            for role in norms:
                nm = find_layer(names, role, i)
                if nm is None and role in ("attn_norm", "ffn_norm"):
                    nm = require_layer(names, role, i)
                if nm is not None:
                    norms[role].append(_vec(r, nm, widths[role]))
        for role in ("attn_sub_norm", "ffn_sub_norm"):
            if norms[role] and len(norms[role]) != cfg.num_layers:
                raise ModelError(f"{role} present for only {len(norms[role])} "
                                 f"of {cfg.num_layers} layers")
        if norms["attn_sub_norm"]:
            cfg = cfg.replace(use_sub_norm=True)

        def stack(role):
            return torch.stack(norms[role]) if norms[role] else None

        blocks = BlockParams(
            attn_norm=stack("attn_norm"),
            wq=_stack_linears(lin["attn_q"]), wk=_stack_linears(lin["attn_k"]),
            wv=_stack_linears(lin["attn_v"]),
            wo=_stack_linears(lin["attn_output"]),
            ffn_norm=stack("ffn_norm"),
            w_gate=_stack_linears(lin["ffn_gate"]),
            w_up=_stack_linears(lin["ffn_up"]),
            w_down=_stack_linears(lin["ffn_down"]),
            attn_sub_norm=stack("attn_sub_norm"),
            ffn_sub_norm=stack("ffn_sub_norm"))
        fn_name = find_global(names, "output_norm")
        if fn_name is None:
            raise ModelError("no output_norm tensor found")
        sin, cos = build_rope_tables(D, max_seq_len or cfg.max_seq_len,
                                     cfg.rope_base)
        params = BitNetParams(
            embed=torch.from_numpy(np.array(embed)).to(param_dtype),
            blocks=blocks, final_norm=_vec(r, fn_name, H),
            rope_sin=sin, rope_cos=cos)
        eos = r.metadata.get("tokenizer.ggml.eos_token_id")
        meta = {"eos_token_id": None if eos is None else int(eos)}
    return cfg, params, meta
