"""The port's model and engine against the JAX package on the mini QK256
fixture: the GGUF loaders agree bit for bit, greedy decoding at f32 picks
the same tokens, and with the JAX parameters carried across
(models/convert.py) the bf16 int8-head logits agree to cosine >= 0.99 at
every position (bf16 rounding, moved across int8 requantization
boundaries, is what separates them).  The plain tensor ops are held to
f32 rounding (1e-5) against their XLA counterparts."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.models.loader import load_model as jload_model
from bitnet_tpu.ops.attention import attention as jattention
from bitnet_tpu.ops.flash import flash_attention as jflash
from bitnet_tpu.ops.rmsnorm import rms_norm as jrms_norm
from bitnet_tpu.ops.rope import apply_rope as japply_rope
from bitnet_tpu.ops.rope import build_rope_tables as jbuild_rope
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models.convert import params_from_arrays
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.ops.attention import attention
from bitnet_tpu_torch.ops.flash import flash_attention
from bitnet_tpu_torch.ops.rmsnorm import rms_norm
from bitnet_tpu_torch.ops.rope import apply_rope, build_rope_tables


def _np_tree(obj):
    """A JAX params pytree as the nested dict of numpy arrays convert.py reads."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: _np_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def test_loader_matches_jax_loader(mini_gguf_qk256):
    jcfg, jp, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    cfg, p, meta = load_model(mini_gguf_qk256.path, param_dtype=torch.float32)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
              "rope_base", "rms_norm_eps", "hidden_act"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert meta["eos_token_id"] == 2
    np.testing.assert_array_equal(p.embed.numpy(), np.asarray(jp.embed))
    np.testing.assert_array_equal(p.final_norm.numpy(), np.asarray(jp.final_norm))
    np.testing.assert_array_equal(p.rope_sin.numpy(), np.asarray(jp.rope_sin))
    for n in ("attn_norm", "ffn_norm"):
        np.testing.assert_array_equal(getattr(p.blocks, n).numpy(),
                                      np.asarray(getattr(jp.blocks, n)))
    for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        t, j = getattr(p.blocks, n), getattr(jp.blocks, n)
        assert (t.kind, t.k, t.n) == (j.kind, j.k, j.n)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))


@pytest.mark.parametrize("prompt", [[1, 5, 9, 14], list(range(3, 23))])
def test_greedy_tokens_match_jax_f32(mini_gguf_qk256, prompt):
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(
        kernel_path="w2a8", max_seq_len=64, compute_dtype="f32",
        fuse_projections=True))
    want = je.generate(prompt, JGenerationConfig(max_new_tokens=8, greedy=True))
    pe = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(max_seq_len=64, compute_dtype="f32"),
        device="cpu")
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=8))
    assert got.token_ids == want.token_ids
    assert got.stop_reason.value == want.stop_reason.value
    assert any(k.startswith("decode_w2a8_attn_qkv_v2s") for k in pe.kernel_recorder)


def test_converted_params_bf16_logits_cosine(mini_gguf_qk256):
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(
        kernel_path="w2a8", max_seq_len=64, compute_dtype="bf16",
        fuse_projections=True, logits_dtype="int8"))
    params = params_from_arrays(_np_tree(je.params))
    assert params.blocks.wqkv is not None and params.embed_q is not None
    pe = InferenceEngine(_port_cfg(je.cfg), params,
                         EngineConfig(max_seq_len=64, logits_dtype="int8"),
                         device="cpu")
    prompt = [1, 7, 3, 250, 9, 44, 12]
    jl, tl = je.prefill(prompt), pe.prefill(prompt)
    decode = je._get_decode()
    pos, cos = len(prompt), []
    for _ in range(6):
        a = np.asarray(jl[0], np.float32)
        b = tl[0].numpy()
        cos.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
        tok = int(np.argmax(a))
        tk = np.zeros((1, 1), np.int32)
        tk[0, 0] = tok
        jl, je.cache = decode(je.params, jnp.asarray(tk), je.cache,
                              jnp.asarray([[pos]], jnp.int32))
        tl = pe.decode_step(tok, pos)
        pos += 1
    assert min(cos) >= 0.99, cos


def _port_cfg(jcfg):
    from bitnet_tpu_torch.config import ModelConfig

    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def test_plain_ops_match_xla():
    rng = np.random.default_rng(5)
    B, T, H, KV, D, S = 2, 6, 4, 2, 32, 40
    x = rng.standard_normal((B, T, 48)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    np.testing.assert_allclose(rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jrms_norm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-6)
    sin, cos = build_rope_tables(D, 64, 500000.0)
    jsin, jcos = jbuild_rope(D, 64, 500000.0)
    np.testing.assert_array_equal(sin.numpy(), jsin)
    pos = np.stack([np.arange(T) + 3, np.arange(T) + 30]).astype(np.int32)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    got = apply_rope(torch.from_numpy(q), sin[torch.from_numpy(pos).long()],
                     cos[torch.from_numpy(pos).long()])
    want = japply_rope(jnp.asarray(q), jnp.asarray(jsin), jnp.asarray(jcos),
                       jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    valid = np.array([T + 3, T + 30], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, k, v, pos, valid)]
    args_j = [jnp.asarray(a) for a in (q, k, v, pos, valid)]
    want = np.asarray(jattention(*args_j))
    np.testing.assert_allclose(attention(*args_t).numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flash_attention(*args_t, chunk=16).numpy(),
                               np.asarray(jflash(*args_j, chunk=16)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(flash_attention(*args_t, chunk=16).numpy(), want,
                               rtol=1e-4, atol=1e-5)
