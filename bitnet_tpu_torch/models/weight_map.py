"""Weight-name mapping: checkpoint tensor names → canonical roles (own copy
of bitnet_tpu/models/weight_map.py).

Equivalent of the reference's GGUF→internal mapper
(``crates/bitnet-models/src/weight_mapper.rs``).  Supports ggml/llama.cpp
names (``blk.N.attn_q.weight``) and HF-transformers names
(``model.layers.N.self_attn.q_proj.weight``).
"""

from __future__ import annotations

from ..errors import ModelError

# canonical role → list of name templates ({i} = layer index)
GLOBAL_ROLES: dict[str, list[str]] = {
    "token_embd": ["token_embd.weight", "model.embed_tokens.weight",
                   "tok_embeddings.weight"],
    "output_norm": ["output_norm.weight", "model.norm.weight", "norm.weight"],
    "output": ["output.weight", "lm_head.weight"],
}

LAYER_ROLES: dict[str, list[str]] = {
    "attn_norm": ["blk.{i}.attn_norm.weight",
                  "model.layers.{i}.input_layernorm.weight"],
    "attn_q": ["blk.{i}.attn_q.weight",
               "model.layers.{i}.self_attn.q_proj.weight"],
    "attn_k": ["blk.{i}.attn_k.weight",
               "model.layers.{i}.self_attn.k_proj.weight"],
    "attn_v": ["blk.{i}.attn_v.weight",
               "model.layers.{i}.self_attn.v_proj.weight"],
    "attn_output": ["blk.{i}.attn_output.weight",
                    "model.layers.{i}.self_attn.o_proj.weight"],
    "attn_sub_norm": ["blk.{i}.attn_sub_norm.weight",
                      "model.layers.{i}.self_attn.inner_attn_ln.weight"],
    "ffn_norm": ["blk.{i}.ffn_norm.weight",
                 "model.layers.{i}.post_attention_layernorm.weight"],
    "ffn_gate": ["blk.{i}.ffn_gate.weight",
                 "model.layers.{i}.mlp.gate_proj.weight"],
    "ffn_up": ["blk.{i}.ffn_up.weight",
               "model.layers.{i}.mlp.up_proj.weight"],
    "ffn_down": ["blk.{i}.ffn_down.weight",
                 "model.layers.{i}.mlp.down_proj.weight"],
    "ffn_sub_norm": ["blk.{i}.ffn_sub_norm.weight",
                     "model.layers.{i}.mlp.ffn_layernorm.weight"],
}


def find_global(names: set[str], role: str) -> str | None:
    for cand in GLOBAL_ROLES[role]:
        if cand in names:
            return cand
    return None


def find_layer(names: set[str], role: str, i: int) -> str | None:
    for tmpl in LAYER_ROLES[role]:
        cand = tmpl.format(i=i)
        if cand in names:
            return cand
    return None


def require_layer(names: set[str], role: str, i: int) -> str:
    got = find_layer(names, role, i)
    if got is None:
        raise ModelError(
            f"missing tensor for role {role!r} layer {i} "
            f"(tried {[t.format(i=i) for t in LAYER_ROLES[role]]})"
        )
    return got

