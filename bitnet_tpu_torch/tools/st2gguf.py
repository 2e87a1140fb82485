"""SafeTensors → GGUF converter.

Counterpart of ``bitnet_tpu/tools/st2gguf.py`` on the port's own
SafeTensors reader (``tools/safetensors_io.py``): reads an HF
``.safetensors`` file or a directory of shards (with or without
``model.safetensors.index.json``), maps HF names to GGUF names, keeps the
norms in f32 (never quantized), honors ``config.json`` (head counts, FFN
width, context, RoPE base, RMS epsilon) and writes GGUF v3 with the linear
weights in f16 (default), f32, bitnet32 or qk256.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from ..errors import ModelError
from ..gguf.constants import GGMLType
from ..gguf.writer import GGUFWriter

# HF name → GGUF name (inverse of models/weight_map.py)
_HF_TO_GGUF = [
    (re.compile(r"^model\.embed_tokens\.weight$"), "token_embd.weight"),
    (re.compile(r"^model\.norm\.weight$"), "output_norm.weight"),
    (re.compile(r"^lm_head\.weight$"), "output.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.input_layernorm\.weight$"),
     r"blk.\1.attn_norm.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.post_attention_layernorm\.weight$"),
     r"blk.\1.ffn_norm.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.q_proj\.weight$"),
     r"blk.\1.attn_q.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.k_proj\.weight$"),
     r"blk.\1.attn_k.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.v_proj\.weight$"),
     r"blk.\1.attn_v.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.o_proj\.weight$"),
     r"blk.\1.attn_output.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.gate_proj\.weight$"),
     r"blk.\1.ffn_gate.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.up_proj\.weight$"),
     r"blk.\1.ffn_up.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.down_proj\.weight$"),
     r"blk.\1.ffn_down.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.self_attn\.inner_attn_ln\.weight$"),
     r"blk.\1.attn_sub_norm.weight"),
    (re.compile(r"^model\.layers\.(\d+)\.mlp\.ffn_layernorm\.weight$"),
     r"blk.\1.ffn_sub_norm.weight"),
]


def map_hf_name(name: str) -> str | None:
    for pat, repl in _HF_TO_GGUF:
        if pat.match(name):
            return pat.sub(repl, name)
    return None


def is_norm_tensor(gguf_name: str) -> bool:
    """LayerNorm detection (st2gguf layernorm.rs:37): never quantize norms."""
    return "norm" in gguf_name


def _load_safetensors(path: str) -> dict[str, np.ndarray]:
    from .safetensors_io import load_file

    if os.path.isdir(path):
        # sharded HF layout
        idx = os.path.join(path, "model.safetensors.index.json")
        tensors: dict[str, np.ndarray] = {}
        if os.path.isfile(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            for shard in sorted(set(weight_map.values())):
                tensors.update(load_file(os.path.join(path, shard)))
        else:
            for fn in sorted(os.listdir(path)):
                if fn.endswith(".safetensors"):
                    tensors.update(load_file(os.path.join(path, fn)))
        if not tensors:
            raise ModelError(f"no .safetensors files under {path}")
        return tensors
    return load_file(path)


def convert_safetensors_to_gguf(
    input_path: str,
    output_path: str,
    quant: str = "f16",
    metadata: dict | None = None,
    arch: str = "bitnet-25",
) -> dict:
    """Convert; returns a summary dict. ``quant``: f16|f32|bitnet32|qk256.
    BF16 tensors are read widened to f32, as the JAX loader's route reads
    them (``tools/safetensors_io.py``)."""
    tensors = _load_safetensors(input_path)
    w = GGUFWriter()

    # infer config from shapes
    cfg_meta = dict(metadata or {})
    emb = None
    for hf_name in ("model.embed_tokens.weight",):
        if hf_name in tensors:
            emb = tensors[hf_name]
    n_layers = 0
    for name in tensors:
        m = re.match(r"^model\.layers\.(\d+)\.", name)
        if m:
            n_layers = max(n_layers, int(m.group(1)) + 1)

    # HF checkpoints ship config.json — the authoritative head/ffn config
    # (a sibling of the .safetensors file or inside the directory)
    hf_cfg = {}
    cfg_dir = input_path if os.path.isdir(input_path) \
        else os.path.dirname(os.path.abspath(input_path))
    cfg_json = os.path.join(cfg_dir, "config.json")
    if os.path.isfile(cfg_json):
        try:
            with open(cfg_json) as f:
                hf_cfg = json.load(f)
        except json.JSONDecodeError:
            hf_cfg = {}

    w.add_metadata("general.architecture", arch)
    w.add_metadata("general.name", os.path.basename(input_path))
    hidden = int(hf_cfg.get("hidden_size", emb.shape[1] if emb is not None
                            else 0))
    if hidden:
        w.add_metadata(f"{arch}.embedding_length", hidden)
    if emb is not None:
        w.add_metadata(f"{arch}.vocab_size",
                       int(hf_cfg.get("vocab_size", emb.shape[0])))
    w.add_metadata(f"{arch}.block_count",
                   int(hf_cfg.get("num_hidden_layers", n_layers)))

    # head counts: config.json first; else infer from q/k projection shapes
    # assuming head_dim = hidden / num_heads unless config says otherwise
    q0 = tensors.get("model.layers.0.self_attn.q_proj.weight")
    k0 = tensors.get("model.layers.0.self_attn.k_proj.weight")
    n_heads = hf_cfg.get("num_attention_heads")
    head_dim = hf_cfg.get("head_dim")
    if n_heads is None and q0 is not None:
        # no config.json: assume the standard 128-dim heads when q rows
        # divide cleanly, else 64 (small/test models)
        head_dim = 128 if q0.shape[0] % 128 == 0 and q0.shape[0] >= 128 \
            else 64
        n_heads = max(1, q0.shape[0] // head_dim)
    if n_heads:
        n_heads = int(n_heads)
        w.add_metadata(f"{arch}.attention.head_count", n_heads)
        hd = int(head_dim or (q0.shape[0] // n_heads if q0 is not None
                              else hidden // n_heads))
        w.add_metadata(f"{arch}.attention.key_length", hd)
        n_kv = hf_cfg.get("num_key_value_heads")
        if n_kv is None and k0 is not None and hd:
            n_kv = k0.shape[0] // hd
        if n_kv:
            w.add_metadata(f"{arch}.attention.head_count_kv", int(n_kv))
    g0 = tensors.get("model.layers.0.mlp.gate_proj.weight")
    ffn = hf_cfg.get("intermediate_size",
                     g0.shape[0] if g0 is not None else None)
    if ffn:
        w.add_metadata(f"{arch}.feed_forward_length", int(ffn))
    if hf_cfg.get("max_position_embeddings"):
        w.add_metadata(f"{arch}.context_length",
                       int(hf_cfg["max_position_embeddings"]))
    if hf_cfg.get("rope_theta"):
        w.add_metadata(f"{arch}.rope.freq_base",
                       float(hf_cfg["rope_theta"]))
    if hf_cfg.get("rms_norm_eps"):
        w.add_metadata(f"{arch}.attention.layer_norm_rms_epsilon",
                       float(hf_cfg["rms_norm_eps"]))
    for k, v in cfg_meta.items():
        w.add_metadata(k, v)

    converted, skipped = [], []
    for hf_name, arr in sorted(tensors.items()):
        gguf_name = map_hf_name(hf_name)
        if gguf_name is None:
            skipped.append(hf_name)
            continue
        arr = np.asarray(arr)
        if (arr.dtype == np.float16 and quant not in ("f32", "qk256", "bitnet32")
                and not is_norm_tensor(gguf_name)):
            # f16 → f32 → f16 is the identity: the bytes go across as they are
            w.add_tensor(gguf_name, arr, GGMLType.F16)
            converted.append(gguf_name)
            continue
        arr32 = arr if arr.dtype == np.float32 else arr.astype(np.float32)

        if is_norm_tensor(gguf_name):
            # norms stay f32 — never quantized (layernorm.rs:37)
            w.add_tensor(gguf_name, arr32.astype(np.float32), GGMLType.F32)
        elif quant == "qk256" and arr32.ndim == 2:
            from ..quant.qk256 import quantize_qk256

            w.add_quantized_tensor(gguf_name, tuple(arr32.shape),
                                   GGMLType.I2_S, quantize_qk256(arr32))
        elif quant == "bitnet32" and arr32.ndim == 2:
            from ..quant.i2s import quantize_bitnet32

            w.add_quantized_tensor(gguf_name, tuple(arr32.shape),
                                   GGMLType.I2_S, quantize_bitnet32(arr32))
        elif quant == "f32":
            w.add_tensor(gguf_name, arr32.astype(np.float32), GGMLType.F32)
        else:  # f16 default
            w.add_tensor(gguf_name, arr32.astype(np.float16), GGMLType.F16)
        converted.append(gguf_name)

    w.write(output_path)
    return {"converted": len(converted), "skipped": skipped,
            "layers": n_layers, "output": output_path}
