"""An f32 KV cache (ROADMAP.md queue 1 #18) in the port against the JAX
package, which takes ``kv_cache_dtype="f32"`` on every path and treats only
int8 and fp8 as quantized when it picks a plan.

- Every unquantized plan's kernel on an f32 cache: the plain versions of
  K2, K13, K18, K20 (the raw q|k|v row) and K5, K8, K16, K22 (q and the new
  rows apart) against their Pallas kernels in interpret mode, and K3's f32
  row write against ``scatter_kv_rows``.  Over an f32 cache nothing rounds
  to bf16 (q, the rows and the softmax weights stay f32 in both), so the
  attention output is held to 1e-5 (the same f32 products summed in
  another order); the v row is equal and the roped k row within 1e-6 (XLA
  fuses RoPE's multiply-add on the CPU).
- The engines with ``kv_cache_dtype="f32"`` on the mini GGUF at
  ``compute_dtype="f32"``: the fused stacked path at B=1 (plan
  ``qkv_v2s``, K2), a pool of 3 (``batched_v2``, K8) and the generic path
  (K5): greedy tokens equal to the JAX engine's.
- The memory estimate prices an f32 cache as the JAX package does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.config import ModelConfig as JModelConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.models import memory as jmemory
from bitnet_tpu.ops import decode_attention as jv1
from bitnet_tpu.ops import decode_attention_v2 as jv2
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models import memory
from bitnet_tpu_torch.models.bitnet import decode_attn_plan, kv_dtype_name
from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, LLAMA3_8B_158
from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da

torch.set_num_threads(1)

L, H, KV, D = 2, 4, 2, 64


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    vc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    pos = rng.integers(1, S, B).astype(np.int32)
    pos[0] = S - 1
    if B > 2:
        pos[1] = 0
    return rng, kc, vc, pos


# (port wrapper, JAX wrapper, JAX cache: stacked "stack", one "flat" layer
# with n_kv, or one "5d" layer)
ROPE = {"K2": (da.decode_attention_qkv, jv2.decode_attention_qkv_v2_stacked, "stack"),
        "K13": (dk.decode_attention_qkv_v1, jv1.decode_attention_qkv, "flat"),
        "K18": (dk.decode_attention_qkv_batched, jv1.decode_attention_qkv_batched,
                "5d"),
        "K20": (da.decode_attention_qkv_batched_v2,
                jv2.decode_attention_qkv_batched_v2, "flat")}
SPLIT = {"K5": (dk.decode_attention, jv1.decode_attention, "5d"),
         "K8": (da.decode_attention_batched, jv2.decode_attention_batched_v2_stacked,
                "stack"),
         "K16": (dk.decode_attention_batched_v1, jv1.decode_attention_batched, "5d"),
         "K22": (da.decode_attention_batched_v2, jv2.decode_attention_batched_v2,
                 "flat")}


def _jax_cache(kc, l, B, S, layout):
    if layout == "stack":
        return jnp.asarray(kc), {"n_kv": KV}
    if layout == "flat":
        return jnp.asarray(kc[l]), {"n_kv": KV}
    return jnp.asarray(kc[l].reshape(B, S, KV, D)), {}


@pytest.mark.parametrize("name,S,B", [("K2", 1280, 2), ("K13", 64, 1),
                                      ("K18", 64, 3), ("K20", 1280, 3)])
def test_rope_fused_plans_on_an_f32_cache(name, S, B):
    wrapper, jfn, layout = ROPE[name]
    rng, kc, vc, pos = _inputs(S + B, B, S)
    qkv = rng.standard_normal((B, H + 2 * KV, D)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (B, D // 2)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    l = 1
    (jk, kw), (jv, _) = _jax_cache(kc, l, B, S, layout), _jax_cache(vc, l, B, S, layout)
    lead = (jnp.int32(l),) if layout == "stack" else ()
    want = jfn(*lead, jnp.asarray(qkv), jnp.asarray(sin), jnp.asarray(cos), jk, jv,
               jnp.asarray(pos), n_heads=H, interpret=True, **kw)
    got = wrapper(l, _t(qkv), _t(sin), _t(cos), _t(kc), _t(vc), _t(pos),
                  n_heads=H, n_kv=KV)
    assert got[1].dtype == torch.float32
    # the v row is copied; the k row is RoPE's x·cos + rot·sin, which XLA's
    # CPU build contracts into a fused multiply-add where torch (and the
    # CUDA kernel) rounds each product: an f32 ulp apart
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]).reshape(got[2].shape))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]).reshape(got[1].shape),
                               rtol=0, atol=1e-6)
    _close(got[0], want[0])


@pytest.mark.parametrize("name,S,B,qdtype", [("K5", 1280, 2, "f32"),
                                             ("K8", 64, 3, "bf16"),
                                             ("K16", 1280, 3, "f32"),
                                             ("K22", 64, 3, "f32")])
def test_split_plans_on_an_f32_cache(name, S, B, qdtype):
    wrapper, jfn, layout = SPLIT[name]
    rng, kc, vc, pos = _inputs(2 * S + B, B, S)
    jd = jnp.float32 if qdtype == "f32" else jnp.bfloat16
    q, kn, vn = (jnp.asarray(rng.standard_normal(s), jd)
                 for s in ((B, H, D), (B, KV, D), (B, KV, D)))
    l = 1
    (jk, kw), (jv, _) = _jax_cache(kc, l, B, S, layout), _jax_cache(vc, l, B, S, layout)
    lead = (jnp.int32(l),) if layout == "stack" else ()
    want = jfn(*lead, q, kn, vn, jk, jv, jnp.asarray(pos), interpret=True, **kw)
    tq, tk, tv = (_t(a.astype(jnp.float32)).to(
        torch.float32 if qdtype == "f32" else torch.bfloat16) for a in (q, kn, vn))
    got = wrapper(l, tq, tk, tv, _t(kc), _t(vc), _t(pos))
    assert got.dtype == tq.dtype
    want = np.asarray(want.astype(jnp.float32))
    if qdtype == "f32":
        _close(got, want)
    else:               # the output rounds once to bf16: one bf16 ulp of its max
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 ** -8 * np.abs(want).max())


def test_k3_writes_f32_rows_like_the_reference():
    B, S = 3, 64
    rng, kc, vc, _ = _inputs(5, B, S)
    rows = rng.standard_normal((2, L, B, 1, KV * D)).astype(np.float32)
    pos = np.array([5, S - 1, S + 3], np.int32)          # the last one clamps
    jk, jv = jv2.scatter_kv_rows(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(rows[0]),
                                 jnp.asarray(rows[1]), jnp.asarray(pos),
                                 interpret=True)
    tk, tv = _t(kc), _t(vc)
    da.scatter_kv_rows(tk, tv, _t(rows[0]), _t(rows[1]), _t(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _engines(mini, B, fuse):
    kw = dict(kernel_path="w2a8", max_seq_len=64, compute_dtype="f32",
              fuse_projections=fuse, max_batch_size=B, kv_cache_dtype="f32")
    je = JEngine.from_gguf(mini.path, JEngineConfig(**kw))
    pe = InferenceEngine.from_gguf(mini.path, EngineConfig(**kw), device="cpu")
    return je, pe


PROMPTS = [[1, 5, 9, 14, 200, 77, 3], [1, 33], [1, 9, 250, 7, 80, 12, 5, 61]]


@pytest.mark.parametrize("B,fuse", [(1, True), (3, True), (1, False)],
                         ids=["fused_B1", "pool_B3", "generic"])
def test_greedy_tokens_match_jax_with_an_f32_cache(mini_gguf_qk256, B, fuse):
    je, pe = _engines(mini_gguf_qk256, B, fuse)
    assert pe.cache.k.dtype == torch.float32 and pe.cache.k_scale is None
    assert pe.stacked_decode() == fuse
    gc = dict(max_new_tokens=8, greedy=True)
    if B == 1:
        want = je.generate(PROMPTS[0], JGenerationConfig(**gc)).token_ids
        got = pe.generate(PROMPTS[0], GenerationConfig(**gc)).token_ids
    else:
        want = [r.token_ids for r in je.generate_batch(PROMPTS, JGenerationConfig(**gc))]
        got = [r.token_ids for r in pe.generate_batch(PROMPTS, GenerationConfig(**gc))]
    assert got == want
    if fuse:            # f32 takes the unquantized plans, as in the JAX package
        assert kv_dtype_name(torch.float32) == "f32"
        assert pe.decode_plan() == decode_attn_plan(B, "bf16")
        if B == 1:
            assert any(k.startswith(f"decode_w2a8_attn_{pe.decode_plan()}_x")
                       for k in pe.kernel_recorder)


@pytest.mark.parametrize("ek", [dict(kv_cache_dtype="f32"),
                                dict(kv_cache_dtype="f32", max_batch_size=8),
                                dict(kv_cache_dtype="f32", max_seq_len=4096)],
                         ids=["B1", "B8", "S4096"])
@pytest.mark.parametrize("cfg", [BITNET_2B4T, LLAMA3_8B_158], ids=["2b4t", "8b"])
def test_memory_estimate_prices_f32_as_the_reference(cfg, ek):
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    got = memory.estimate_memory(cfg, EngineConfig(**ek))
    want = jmemory.estimate_memory(jcfg, JEngineConfig(**ek))
    assert got.as_dict() == want.as_dict()
    assert got.kv_cache_bytes == 2 * memory.estimate_memory(
        cfg, EngineConfig(**dict(ek, kv_cache_dtype="bf16"))).kv_cache_bytes
