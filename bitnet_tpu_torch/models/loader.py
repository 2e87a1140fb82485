"""Checkpoint → BitNetParams loader: GGUF, and SafeTensors files or HF
checkpoint directories through a cached conversion.

Counterpart of ``bitnet_tpu/models/loader.py`` (``load_model`` ``:334``):
- ``_resolve_checkpoint`` (``:301-331``): a ``.safetensors`` file or a
  directory of them converts once to a sibling ``<path>.converted.gguf``
  (``tools/st2gguf.py``), reused while it is newer than every shard;
- every tensor type the JAX ``_to_float`` reads (``:87-140``): F32, F16,
  F64, BF16, IQ2_S, the GGML-classic Q8_0 / Q4_0 / Q4_1 / Q5_0 / Q5_1 /
  Q4_K / Q6_K (``quant/ggml_classic.py``, numpy on the host) and I2_S in
  its three flavors;
- ``mode="auto"`` keeps I2_S linears packed: QK256 (either orientation) as
  ``qk256``, BitNet32-F16 / Split32 as ``bitnet32`` where their scale
  blocks run along K; every other linear, and a per-block tensor whose
  blocks do not run along K, is densified (``:262-282``) to a ``dense``
  linear in ``param_dtype``.  ``mode="dense"`` densifies every linear;
- a ``LoadReport`` of what happened (the flavors, each role's kind, the
  tensors dequantized), with the GGUF's ``eos_token_id``.

A QK256 linear is packed on the load's device
(``ops/linear.qk256_linear_from_payload_torch``, the function of the JAX
package's native codec, ``:222-233``): the payload's bytes go there once
and are unpacked, transposed and packed in torch, the words equal to the
numpy route's (``qk256_linear_from_payload``, which no load calls) bit
for bit.  Densified under ``mode="dense"`` it is unpacked the same way:
the values are the LUT's small integers, exact in bf16, so the result
equals the numpy route's (``_to_float`` → ``.T`` → the param dtype) bit
for bit, without an f32 copy of the weights on the host.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import ModelConfig
from ..device_probe import resolve_device
from ..errors import ModelError
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader, TensorInfo
from ..ops.linear import (TernaryLinear, bitnet32_linear_from_codes, dense_linear,
                          qk256_codes_torch, qk256_linear_from_payload_torch)
from ..ops.rope import build_rope_tables
from ..quant import ggml_classic, i2s, qk256
from ..quant.flavor import I2SFlavor, detect_i2s_flavor
from .arch_registry import resolve_arch, validate_config_for_arch
from .bitnet import BitNetParams, BlockParams
from .config import config_from_gguf
from .memory import validate_memory
from .weight_map import find_global, find_layer, require_layer, scale_sibling_name


@dataclasses.dataclass
class LoadReport:
    """What happened at load (``bitnet_tpu/models/loader.py:47-55``): each
    I2_S tensor's flavor, each role's kind (``dense`` / ``qk256`` /
    ``bitnet32``), the tensors dequantized, the config, and the GGUF's
    ``tokenizer.ggml.eos_token_id``."""

    path: str
    flavors: dict[str, str]
    kinds: dict[str, str]
    dequantized: list[str]
    config: ModelConfig | None = None
    eos_token_id: int | None = None


_CLASSIC = {GGMLType.Q8_0: ggml_classic.dequantize_q8_0,
            GGMLType.Q4_0: ggml_classic.dequantize_q4_0,
            GGMLType.Q4_1: ggml_classic.dequantize_q4_1,
            GGMLType.Q5_0: ggml_classic.dequantize_q5_0,
            GGMLType.Q5_1: ggml_classic.dequantize_q5_1,
            GGMLType.Q4_K: ggml_classic.dequantize_q4_k,
            GGMLType.Q6_K: ggml_classic.dequantize_q6_k}


# float GGUF types: (the numpy view of the payload, the torch dtype of its bits)
_FLOAT_VIEWS = {GGMLType.F32: (np.float32, torch.float32),
                GGMLType.F16: (np.float16, torch.float16),
                GGMLType.BF16: (np.int16, torch.bfloat16)}


def _to_float(reader: GGUFReader, info: TensorInfo) -> np.ndarray:
    """Any supported tensor as float32 [logical_shape]
    (``bitnet_tpu/models/loader.py:87-140``; the numpy golden model of
    ``verify/crossval.py`` reads every tensor through it)."""
    t = info.ggml_type
    if t in (GGMLType.F32, GGMLType.F16, GGMLType.F64):
        return np.asarray(reader.tensor_data(info.name), dtype=np.float32)
    if t == GGMLType.BF16:
        raw = reader.tensor_data(info.name)          # uint16 words
        return (raw.astype(np.uint32) << 16).view(np.float32).astype(np.float32)
    if t == GGMLType.IQ2_S:
        return qk256.dequantize_iq2s(reader.tensor_bytes(info.name),
                                     info.nelems).reshape(info.logical_shape)
    if t in _CLASSIC:
        return _CLASSIC[t](reader.tensor_bytes(info.name),
                           info.nelems).reshape(info.logical_shape)
    if t == GGMLType.I2_S:
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
    raise ModelError(f"{info.name}: unsupported tensor type {t.name} for dequant")


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


def qk256_dense_kn(payload: np.ndarray, rows: int, cols: int, transposed: bool,
                   dtype: torch.dtype, device) -> torch.Tensor:
    """A QK256 payload stored [rows, cols] → its dense [K, N] weight in
    ``dtype`` on ``device``: the codes unpacked in torch from the bytes
    (``ops/linear.qk256_codes_torch``), LUT values {-2, -1, 1, 2},
    transposed unless the tensor is stored [in, out] already.  Equal bit for
    bit to ``dequantize_qk256`` → ``.T`` → ``dtype`` (the values are exact)."""
    codes = qk256_codes_torch(payload, rows, cols, device).to(torch.int8)
    vals = (codes + (codes >= 2).to(torch.int8) - 2).to(dtype)     # [rows, cols]
    return vals.contiguous() if transposed else vals.t().contiguous()


def _load_linear(reader: GGUFReader, name: str, out_dim: int, in_dim: int,
                 mode: str = "auto", report: LoadReport | None = None,
                 role: str = "", param_dtype: torch.dtype = torch.bfloat16,
                 device="cpu") -> TernaryLinear:
    """One [out, in] weight → a linear in the [K=in, N=out] layout
    (``bitnet_tpu/models/loader.py:195-282``).  ``mode="auto"``: QK256 →
    ``qk256``; BitNet32-F16 / Split32 → ``bitnet32`` where the scale blocks
    run along K (a transposed tensor with one uniform scale carries over);
    anything else → ``dense`` in ``param_dtype`` (a warning names a
    per-block tensor that cannot keep its layout).  ``mode="dense"``
    densifies every linear.  ``report`` records the flavor and kind."""
    report = report if report is not None else LoadReport("", {}, {}, [])
    info = reader.tensors[name]
    shape = info.logical_shape
    transposed = False
    if shape == (in_dim, out_dim) and shape != (out_dim, in_dim):
        transposed = True
    elif shape != (out_dim, in_dim) and int(np.prod(shape)) != out_dim * in_dim:
        raise ModelError(f"{name}: shape {shape} incompatible with expected "
                         f"({out_dim}, {in_dim})")
    flavor = None
    if info.ggml_type == GGMLType.I2_S:
        flavor = detect_i2s_flavor(info.nelems, info.nbytes, name=name,
                                   cols=int(info.shape[0]) if info.shape else None)
    if mode != "dense" and flavor is not None:
        report.flavors[name] = flavor.value
        if flavor == I2SFlavor.GGML_QK256_NO_SCALE:
            report.kinds[role] = "qk256"
            return qk256_linear_from_payload_torch(
                reader.tensor_bytes(name), out_dim, in_dim, transposed=transposed,
                device=device)
        codes, scales = _i2s_codes_and_scales(reader, info, flavor)
        if scales is not None and not transposed:
            report.kinds[role] = "bitnet32"
            return bitnet32_linear_from_codes(codes.T, scales.T.copy())
        from ..obs.warn_once import warn_once

        if scales is not None:
            # the blocks run along the stored rows, i.e. along N: only a
            # uniform scale carries over to the K-block layout
            uniq = np.unique(scales)
            if uniq.size == 1 and in_dim % 32 == 0:
                report.kinds[role] = "bitnet32"
                return bitnet32_linear_from_codes(
                    np.ascontiguousarray(codes),
                    np.full((in_dim // 32, out_dim), uniq[0], np.float32))
            warn_once(f"{name}: transposed {flavor.value} tensor with per-block "
                      "scales cannot keep the packed kernel layout — "
                      "dequantizing to dense")
        else:
            warn_once(f"{name}: {flavor.value} block structure did not align "
                      "(cols % 32 != 0) — dequantizing to dense")
    report.kinds[role] = "dense"
    report.dequantized.append(name)
    if flavor == I2SFlavor.GGML_QK256_NO_SCALE and len(shape) == 2:
        return dense_linear(qk256_dense_kn(reader.tensor_bytes(name), shape[0],
                                           shape[1], transposed, param_dtype, device))
    if info.ggml_type in _FLOAT_VIEWS and len(shape) == 2:
        # float storage: widened to f32 and cast on the load's device (the
        # numpy route's values without its f32 host copy and transpose: a 2B
        # HF directory's load 2.26 s against 23.6 s, PERF.md §6 PR 25)
        np_dt, t_dt = _FLOAT_VIEWS[info.ggml_type]
        raw = np.ascontiguousarray(reader.tensor_data(name)).view(np_dt)
        w = torch.from_numpy(raw.copy()).to(device).view(t_dt).to(torch.float32)
        return dense_linear((w if transposed else w.t()).to(param_dtype).contiguous())
    w = _to_float(reader, info)
    w = w.reshape(shape if len(shape) == 2 else (out_dim, in_dim))
    w_kn = w if transposed else w.T                 # [K=in, N=out]
    return dense_linear(torch.from_numpy(np.ascontiguousarray(w_kn)).to(
        device=device, dtype=param_dtype))


def _stack_linears(lins: list[TernaryLinear]) -> TernaryLinear:
    kinds = {l.kind for l in lins}
    if len(kinds) != 1:
        raise ModelError(f"cannot stack heterogeneous linear kinds {kinds}")
    kind = kinds.pop()
    if kind == "dense":
        return dense_linear(torch.stack([l.weight for l in lins]))
    return TernaryLinear(kind=kind, k=lins[0].k, n=lins[0].n,
                         packed=torch.stack([l.packed for l in lins]),
                         scales=torch.stack([l.scales for l in lins]))


def _vec(reader: GGUFReader, name: str, n: int) -> torch.Tensor:
    return torch.from_numpy(_to_float(reader, reader.tensors[name]).reshape(n).copy())


def _resolve_checkpoint(path: str) -> str:
    """Format dispatch (``bitnet_tpu/models/loader.py:301-331``): a GGUF
    passes through; a SafeTensors file or a checkpoint directory of them is
    converted once to a sibling GGUF (``<file stem>.converted.gguf``, or
    ``<dir>.converted.gguf``) through ``tools/st2gguf.py`` (f16 linears,
    f32 norms, ``config.json`` honored; BF16 tensors widened to f32 first,
    as the JAX route reads them through ``ml_dtypes``), and reconverted
    only when a shard is newer than the cache."""
    is_dir = os.path.isdir(path)
    if is_dir:
        shards = [f for f in sorted(os.listdir(path)) if f.endswith(".safetensors")]
        if not shards:
            raise ModelError(f"{path}: directory has no .safetensors")
    elif not path.endswith(".safetensors"):
        return path
    from ..tools.st2gguf import convert_safetensors_to_gguf

    if is_dir:
        src_mtime = max(os.path.getmtime(os.path.join(path, f)) for f in shards)
        cache = path.rstrip("/") + ".converted.gguf"
    else:
        src_mtime = os.path.getmtime(path)
        cache = path[: -len(".safetensors")] + ".converted.gguf"
    if not os.path.exists(cache) or os.path.getmtime(cache) < src_mtime:
        convert_safetensors_to_gguf(path, cache)
    return cache


def load_model(path: str, mode: str = "auto", max_seq_len: int | None = None,
               param_dtype: torch.dtype = torch.bfloat16, device="cuda"
               ) -> tuple[ModelConfig, BitNetParams, LoadReport]:
    """Load a BitNet checkpoint onto ``device`` (the card unless the caller
    asks for ``"cpu"``; without CUDA the default raises, as every entry
    point does): a GGUF natively, a SafeTensors file or an HF checkpoint
    directory through :func:`_resolve_checkpoint`.  ``mode``: ``"auto"``
    keeps I2_S linears packed, ``"dense"`` densifies every linear to
    ``param_dtype`` (the embedding's dtype too).  Returns (cfg, params on
    that device, LoadReport).  Before any tensor is read, the
    architecture's envelope is checked (a ModelError outside it) and the
    memory estimate against the device's memory (a warning past it; none
    on the CPU), as the JAX ``load_model`` checks against the accelerator
    (``:352-359``)."""
    if mode not in ("auto", "dense"):
        raise ModelError(f"bad load mode {mode!r} (auto | dense)")
    dev = resolve_device(device)
    path = _resolve_checkpoint(path)
    report = LoadReport(path=path, flavors={}, kinds={}, dequantized=[])
    with GGUFReader(path) as r:
        cfg = config_from_gguf(r)
        report.config = cfg
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
        shapes = {"attn_q": ("wq", nh * D, H), "attn_k": ("wk", nkv * D, H),
                  "attn_v": ("wv", nkv * D, H), "attn_output": ("wo", H, nh * D),
                  "ffn_gate": ("w_gate", F, H), "ffn_up": ("w_up", F, H),
                  "ffn_down": ("w_down", H, F)}
        lin: dict[str, list] = {k: [] for k in shapes}
        norms: dict[str, list] = {"attn_norm": [], "ffn_norm": [],
                                  "attn_sub_norm": [], "ffn_sub_norm": []}
        widths = {"attn_norm": H, "ffn_norm": H, "attn_sub_norm": nh * D,
                  "ffn_sub_norm": F}
        for i in range(cfg.num_layers):
            for name, (role, o, k) in shapes.items():
                lin[name].append(_load_linear(
                    r, require_layer(names, name, i), o, k, mode, report, role,
                    param_dtype, dev))
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
            report.config = cfg

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
        out_name = find_global(names, "output")
        if out_name is not None:             # untied output.weight [V, H]
            lm_head = _load_linear(r, out_name, cfg.vocab_size, H, mode, report,
                                   "lm_head", param_dtype, dev)
        params = BitNetParams(
            embed=torch.from_numpy(np.array(embed)).to(param_dtype),
            blocks=blocks, final_norm=_vec(r, fn_name, H),
            rope_sin=sin, rope_cos=cos, lm_head=lm_head)
        eos = r.metadata.get("tokenizer.ggml.eos_token_id")
        report.eos_token_id = None if eos is None else int(eos)
    return cfg, params.to(dev), report
