"""GGUF → BitNetParams loader (numpy route, tensors on the CPU).

Counterpart of ``bitnet_tpu/models/loader.py`` (``load_model`` ``:334``)
for the flavors the port runs: ternary linears in I2_S QK256 (either
orientation) and in the per-32-element-block flavors BitNet32-F16 (inline
f16 scales) and Split32 (sibling scales), everything else (embedding,
norms) in F32 or F16.  Other tensor types raise a ModelError naming the
ROADMAP item that ports them.  The QK256 repack is the numpy route; the
JAX package's native codec (``loader.py:228-234``) is not ported, and on a
real 2B checkpoint this route takes minutes (``loader.py:229-230``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..device_probe import resolve_device
from ..errors import ModelError
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader, TensorInfo
from ..ops.linear import (TernaryLinear, bitnet32_linear_from_codes,
                          qk256_linear_from_payload)
from ..ops.rope import build_rope_tables
from ..quant import i2s, qk256
from ..quant.flavor import I2SFlavor, detect_i2s_flavor
from .arch_registry import resolve_arch, validate_config_for_arch
from .bitnet import BitNetParams, BlockParams
from .config import config_from_gguf
from .memory import validate_memory
from .weight_map import find_global, find_layer, require_layer, scale_sibling_name


def _to_float(reader: GGUFReader, info: TensorInfo) -> np.ndarray:
    """An F32 / F16 tensor, or an I2_S one dequantized, as float32
    [logical_shape] (``bitnet_tpu/models/loader.py:87-138``; the numpy
    golden model of ``verify/crossval.py`` reads every tensor through it)."""
    if info.ggml_type in (GGMLType.F32, GGMLType.F16):
        return np.asarray(reader.tensor_data(info.name), dtype=np.float32)
    if info.ggml_type == GGMLType.I2_S:
        flavor = detect_i2s_flavor(info.nelems, info.nbytes, name=info.name,
                                   cols=int(info.shape[0]) if info.shape else None)
        raw = reader.tensor_bytes(info.name)
        shape = info.logical_shape
        if flavor == I2SFlavor.GGML_QK256_NO_SCALE:
            rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            return qk256.dequantize_qk256(raw, rows, shape[-1]).reshape(shape)
        if flavor == I2SFlavor.BITNET32_F16:
            return i2s.dequantize_bitnet32(raw, info.nelems).reshape(shape)
        scales = None
        for cand in scale_sibling_name(info.name):
            if cand in reader.tensors:
                scales = _to_float(reader, reader.tensors[cand]).reshape(-1)
                break
        return i2s.dequantize_split32(raw, info.nelems, scales).reshape(shape)
    raise ModelError(
        f"{info.name}: tensor type {info.ggml_type.name} is not ported yet "
        "(the port loads F32/F16 and I2_S; ROADMAP.md queue 1 #7)")


def _i2s_codes_and_scales(reader: GGUFReader, info: TensorInfo,
                          flavor: I2SFlavor) -> tuple[np.ndarray, np.ndarray | None]:
    """A BitNet32-F16 or Split32 tensor → codes [rows, cols] and per-block
    scales [rows, cols/32] along the stored rows, or None when the blocks
    straddle rows (``bitnet_tpu/models/loader.py:143-192``).  Split32
    scales come from a sibling tensor (``scale_sibling_name``), one value
    broadcast, or 1.0 without one."""
    shape = info.logical_shape
    rows, cols = (1, shape[0]) if len(shape) == 1 else (
        int(np.prod(shape[:-1])), shape[-1])
    raw = reader.tensor_bytes(info.name)
    nblocks = -(-info.nelems // 32)
    if flavor == I2SFlavor.BITNET32_F16:
        codes, scales = i2s.bitnet32_codes_and_scales(raw, info.nelems)
    else:
        codes = i2s.split32_codes(raw, info.nelems)
        scales = np.ones(nblocks, np.float32)
        for cand in scale_sibling_name(info.name):
            if cand in reader.tensors:
                sib = _to_float(reader, reader.tensors[cand]).reshape(-1)
                scales = (np.full(nblocks, sib[0], np.float32) if sib.size == 1
                          else sib)
                break
    codes = codes.reshape(rows, cols)
    if cols % 32:
        return codes, None
    return codes, scales[: rows * (cols // 32)].reshape(rows, cols // 32)


def _load_linear(reader: GGUFReader, name: str, out_dim: int,
                 in_dim: int) -> TernaryLinear:
    """One [out, in] I2_S weight → TernaryLinear ([K=in, N=out]): QK256 →
    ``qk256``; BitNet32-F16 / Split32 → ``bitnet32`` (``:195-261``).  A
    per-block tensor whose blocks do not run along K (stored transposed
    with scales that differ, or blocks that straddle rows) is densified by
    the JAX package; the port has no dense linear and raises."""
    info = reader.tensors[name]
    if info.ggml_type != GGMLType.I2_S:
        raise ModelError(
            f"{name}: {info.ggml_type.name} linears run the generic path, "
            "not ported yet (ROADMAP.md queue 1 #7)")
    flavor = detect_i2s_flavor(info.nelems, info.nbytes, name=name,
                               cols=int(info.shape[0]) if info.shape else None)
    shape = info.logical_shape
    if shape == (out_dim, in_dim):
        transposed = False
    elif shape == (in_dim, out_dim):
        transposed = True
    else:
        raise ModelError(f"{name}: shape {shape} incompatible with expected "
                         f"({out_dim}, {in_dim})")
    if flavor == I2SFlavor.GGML_QK256_NO_SCALE:
        return qk256_linear_from_payload(reader.tensor_bytes(name), out_dim,
                                         in_dim, transposed=transposed)
    codes, scales = _i2s_codes_and_scales(reader, info, flavor)
    if scales is not None and not transposed:
        return bitnet32_linear_from_codes(codes.T, scales.T.copy())
    if scales is not None:
        # the blocks run along the stored rows, i.e. along N: only a
        # uniform scale carries over to the K-block layout
        uniq = np.unique(scales)
        if uniq.size == 1 and in_dim % 32 == 0:
            return bitnet32_linear_from_codes(
                np.ascontiguousarray(codes),
                np.full((in_dim // 32, out_dim), uniq[0], np.float32))
    raise ModelError(
        f"{name}: {flavor.value} tensor whose scale blocks do not run along K "
        "needs a dense linear, not ported yet (ROADMAP.md queue 1 #7)")


def _stack_linears(lins: list[TernaryLinear]) -> TernaryLinear:
    kinds = {l.kind for l in lins}
    if len(kinds) != 1:
        raise ModelError(f"cannot stack heterogeneous linear kinds {kinds}")
    return TernaryLinear(kind=kinds.pop(), k=lins[0].k, n=lins[0].n,
                         packed=torch.stack([l.packed for l in lins]),
                         scales=torch.stack([l.scales for l in lins]))


def _vec(reader: GGUFReader, name: str, n: int) -> torch.Tensor:
    return torch.from_numpy(_to_float(reader, reader.tensors[name]).reshape(n).copy())


def load_model(path: str, max_seq_len: int | None = None,
               param_dtype: torch.dtype = torch.bfloat16, device="cuda"
               ) -> tuple[ModelConfig, BitNetParams, dict]:
    """Load a BitNet GGUF onto ``device`` (the card unless the caller asks
    for ``"cpu"``; without CUDA the default raises, as every entry point
    does).  Returns (cfg, params on that device, metadata with
    ``eos_token_id``).  Before any tensor is read, the architecture's
    envelope is checked (a ModelError outside it) and the memory estimate
    against the device's memory (a warning past it; none on the CPU), as
    the JAX ``load_model`` checks against the accelerator (``:352-359``)."""
    dev = resolve_device(device)
    with GGUFReader(path) as r:
        cfg = config_from_gguf(r)
        validate_config_for_arch(cfg, resolve_arch(cfg.architecture))
        validate_memory(cfg, strict=False, device=dev)
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
                                     cfg.rope_base, device="cpu")   # moved below
        lm_head = None
        if not cfg.tie_word_embeddings:       # untied output.weight [V, H]
            lm_head = _load_linear(r, find_global(names, "output"),
                                   cfg.vocab_size, H)
        params = BitNetParams(
            embed=torch.from_numpy(np.array(embed)).to(param_dtype),
            blocks=blocks, final_norm=_vec(r, fn_name, H),
            rope_sin=sin, rope_cos=cos, lm_head=lm_head)
        eos = r.metadata.get("tokenizer.ggml.eos_token_id")
        meta = {"eos_token_id": None if eos is None else int(eos)}
    return cfg, params.to(dev), meta
