"""The JAX package's kernel-selection knobs in the port.

- ``decode_attn_plan`` names the plan the JAX engine picks
  (``decode_cache_layout`` then ``decode_attn_plan``) for every setting of
  its environment knobs, B ∈ {1, 2, 3, 8, 16, 17, 18, 64} and every cache
  dtype; the two layout knobs that change the plan or the numerics raise.
- Each plan's wrapper: K13–K23 where the JAX decode loop calls the Pallas
  kernel each replaces.
- The mini QK256 model (2 layers, f32 activations) under each knob: from
  the same prefilled cache (the port's, carried into the JAX engine), two
  greedy decode steps give the JAX package's tokens and logits within 1e-4
  of their max magnitude (the attention sums run in another order; an f32
  ulp that moves an int8 activation across a rounding boundary moves a
  logit by far less), and the engine names the plan the JAX engine
  records.  The JAX engine reads the knobs when it traces its decode
  step, and each case builds a new one.
- ``BITNET_FUSED_FFN=1`` runs K24 exactly where the JAX package takes its
  fused FFN kernel (the generic path of a model without ffn_sub_norm,
  reached here through ``BITNET_STACKED_PREFILL=0``), with the JAX
  engine's prefill logits and greedy tokens.
- ``BITNET_TL_W2A8`` / ``BITNET_TL_FUSED`` pick the JAX package's TL
  kernel, shown by its tokens and its receipt.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bitnet_tpu.ops.ffn_fused as jffn
from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.cache import decode_cache_layout, is_flat
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.models.bitnet import _stacked_prefill_ok as j_stacked_prefill_ok
from bitnet_tpu.models.bitnet import decode_attn_plan as jdecode_attn_plan
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models import bitnet as bm
from bitnet_tpu_torch.models.convert import cache_from_arrays

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KNOBS = ("BITNET_CACHE_YS", "BITNET_ROPE_FUSED", "BITNET_FP8_KERNEL",
         "BITNET_BATCHED_ATTN", "BITNET_DECODE_ATTN_MAX_B",
         "BITNET_V2_WHOLEBATCH_MAX_B", "BITNET_B1_ATTN", "BITNET_ATTN_STACKED",
         "BITNET_STACKED_DECODE_MAX_M", "BITNET_CACHE_LAYOUT", "BITNET_CACHE_FLAT",
         "BITNET_ROWS_WRITE", "BITNET_FUSED_FFN", "BITNET_STACKED_PREFILL",
         "BITNET_TL_W2A8", "BITNET_TL_FUSED")
JDT = {"bf16": None, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}

SETTINGS = [
    {}, {"BITNET_B1_ATTN": "v1"}, {"BITNET_ROPE_FUSED": "0"},
    {"BITNET_BATCHED_ATTN": "1"}, {"BITNET_BATCHED_ATTN": "v2qkv"},
    {"BITNET_BATCHED_ATTN": "0"}, {"BITNET_BATCHED_ATTN": ""},
    {"BITNET_ROPE_FUSED": "0", "BITNET_BATCHED_ATTN": "1"},
    {"BITNET_ROPE_FUSED": "0", "BITNET_DECODE_ATTN_MAX_B": "8"},
    {"BITNET_ROPE_FUSED": "0", "BITNET_BATCHED_ATTN": "v2qkv"},
    {"BITNET_BATCHED_ATTN": "v2qkv", "BITNET_V2_WHOLEBATCH_MAX_B": "32"},
    {"BITNET_V2_WHOLEBATCH_MAX_B": "4"}, {"BITNET_FP8_KERNEL": "0"},
    {"BITNET_FP8_KERNEL": "0", "BITNET_B1_ATTN": "v1"},
    {"BITNET_ATTN_STACKED": "0"}, {"BITNET_CACHE_LAYOUT": "flat"},
    {"BITNET_CACHE_FLAT": "0"}, {"BITNET_ROWS_WRITE": "scatter"},
]


@pytest.fixture
def clean_env(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_decode_attn_plan_matches_the_jax_engine(clean_env):
    for env in SETTINGS:
        for var in KNOBS:
            clean_env.delenv(var, raising=False)
        for k, v in env.items():
            clean_env.setenv(k, v)
        for B, kv in itertools.product((1, 2, 3, 8, 16, 17, 18, 64), JDT):
            flat = decode_cache_layout(B, kv) == "flat"
            want = jdecode_attn_plan(B, JDT[kv], flat=flat)
            assert bm.decode_attn_plan(B, kv) == want, (env, B, kv)


@pytest.mark.parametrize("env", [{"BITNET_CACHE_YS": "1"},
                                 {"BITNET_CACHE_LAYOUT": "5d"}])
def test_layout_knobs_that_change_the_plan_raise(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 #21"):
        bm.decode_attn_plan(8, "int8")


def test_each_plan_runs_the_wrapper_of_its_pallas_kernel(clean_env):
    from bitnet_tpu_torch.ops import decode_attention as dk
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    want = {"qkv_v2s": da.decode_attention_qkv,
            "qkv_quant_v2s": da.decode_attention_qkv_quant,
            "qkv": dk.decode_attention_qkv_v1,
            "qkv_quant": dk.decode_attention_qkv_quant_v1,
            "qkv_batched": dk.decode_attention_qkv_batched,
            "qkv_quant_batched": dk.decode_attention_qkv_quant_batched,
            "qkv_batched_v2": da.decode_attention_qkv_batched_v2,
            "qkv_quant_batched_v2": da.decode_attention_qkv_quant_batched_v2,
            "flash": dk.decode_attention, "flash_quant": dk.decode_attention_quant,
            "batched": dk.decode_attention_batched_v1,
            "quant_batched": dk.decode_attention_quant_batched_v1,
            "batched_v2": da.decode_attention_batched,
            "quant_batched_v2": da.decode_attention_quant_batched}
    for plan, wrapper in want.items():
        assert wrapper in bm.plan_attention(plan)
    assert bm.plan_attention("einsum") == (None, None)
    clean_env.setenv("BITNET_ATTN_STACKED", "0")
    assert bm.plan_attention("batched_v2") == (None, da.decode_attention_batched_v2)
    assert bm.plan_attention("quant_batched_v2") == (
        None, da.decode_attention_quant_batched_v2)
    assert bm.plan_attention("qkv_v2s") == bm.plan_attention("qkv_quant_v2s") == (
        None, None)                                  # the einsum tail
    assert bm.plan_attention("qkv") == (dk.decode_attention_qkv_v1, None)


PROMPTS = [[1, 5, 9, 14, 200, 77, 3], [1, 33, 250], [1, 9, 250, 7, 80, 12, 5, 61],
           [1, 120, 17, 4]]


def _engines(mini, B, kv, fuse=True, kp="w2a8", weight_quant="none"):
    kw = dict(kernel_path=kp, max_seq_len=32, compute_dtype="f32",
              fuse_projections=fuse, max_batch_size=B, kv_cache_dtype=kv,
              weight_quant=weight_quant)
    return (JEngine.from_gguf(mini.path, JEngineConfig(**kw)),
            InferenceEngine.from_gguf(mini.path, EngineConfig(**kw), device="cpu"))


def _to_jax(t: torch.Tensor, shape):
    """A port cache tensor as a JAX array of the JAX cache's shape."""
    view = {torch.bfloat16: (torch.int16, jnp.bfloat16),
            torch.float8_e4m3fn: (torch.uint8, jnp.float8_e4m3fn)}
    if t.dtype in view:
        raw, jdt = view[t.dtype]
        return jnp.asarray(t.view(raw).numpy().view(jdt).reshape(shape))
    return jnp.asarray(t.numpy().reshape(shape))


def _greedy_steps(je, pe, B, tol=1e-4, steps=2):
    """Prefill the pool in the port, carry its cache into the JAX engine,
    then take ``steps`` greedy decode steps in both, from token 42: each
    step's logits within ``tol`` of their max magnitude and the same
    greedy tokens."""
    if B == 1:
        pe.prefill(PROMPTS[0])
    else:
        pe.prefill_batch(PROMPTS[:B])
    c, jc = pe.cache, je.cache
    scales = {} if c.k_scale is None else {
        "k_scale": _to_jax(c.k_scale, jc.k_scale.shape),
        "v_scale": _to_jax(c.v_scale, jc.v_scale.shape)}
    je.cache = dataclasses.replace(jc, k=_to_jax(c.k, jc.k.shape),
                                   v=_to_jax(c.v, jc.v.shape),
                                   lengths=jnp.asarray(c.lengths.numpy()), **scales)
    pos = c.lengths.numpy().astype(np.int32).copy()
    tok = np.full((B,), 42, np.int32)
    for _ in range(steps):
        jl, je.cache = je._get_decode()(je.params, jnp.asarray(tok[:, None]),
                                        je.cache, jnp.asarray(pos[:, None]))
        jl = np.asarray(jl, np.float32)
        tl = pe.decode_batch_step(torch.from_numpy(tok), pos).numpy()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=tol * np.abs(jl).max())
        tok = jl.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1), tok)
        pos = pos + 1


@pytest.mark.parametrize("env,B,kv,plan", [
    ({"BITNET_B1_ATTN": "v1"}, 1, "int8", "qkv_quant"),
    ({"BITNET_ROPE_FUSED": "0"}, 1, "int8", "flash_quant"),
    ({"BITNET_BATCHED_ATTN": "1"}, 3, "bf16", "qkv_batched"),
    ({"BITNET_BATCHED_ATTN": "v2qkv"}, 3, "int8", "qkv_quant_batched_v2"),
    ({"BITNET_ROPE_FUSED": "0", "BITNET_BATCHED_ATTN": "1"}, 3, "fp8",
     "quant_batched"),
    ({"BITNET_ATTN_STACKED": "0"}, 3, "int8", "quant_batched_v2"),
    # the JAX package's flat-cache loop fails on the einsum tail's 5-D rows
    # (``:712-715``); it runs that tail on a 5-D cache, which
    # BITNET_CACHE_FLAT=0 gives it and the port ignores
    ({"BITNET_ATTN_STACKED": "0", "BITNET_CACHE_FLAT": "0"}, 1, "bf16", "qkv_v2s")])
def test_stacked_decode_under_each_knob_matches_jax(mini_gguf_qk256, clean_env,
                                                    env, B, kv, plan):
    for k, v in env.items():
        clean_env.setenv(k, v)
    je, pe = _engines(mini_gguf_qk256, B, kv)
    assert pe.stacked_decode() and pe.decode_plan() == plan
    # the name the JAX engine records (``engine.py:764-769``)
    assert jdecode_attn_plan(B, JDT[kv], flat=is_flat(je.cache)) == plan
    _greedy_steps(je, pe, B)


def test_generic_rope_fused_branch_matches_jax(mini_gguf_qk256, clean_env):
    """``BITNET_ROPE_FUSED=1`` on the generic path (fused projections on
    ``pallas``, B = 1, bf16 cache): K13 with the rows written after it
    (``:1286-1307``)."""
    clean_env.setenv("BITNET_ROPE_FUSED", "1")
    je, pe = _engines(mini_gguf_qk256, 1, "bf16", kp="pallas")
    assert not pe.stacked_decode() and pe.params.blocks.wqkv is not None
    calls = []
    real = bm.decode_attention_qkv_v1
    clean_env.setattr(bm, "decode_attention_qkv_v1",
                      lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    _greedy_steps(je, pe, 1)
    assert calls == [0, 1, 0, 1]


@pytest.mark.parametrize("env", [{}, {"BITNET_STACKED_PREFILL": "0"}])
def test_fused_ffn_raises_where_jax_takes_it(mini_gguf_qk256, clean_env, env):
    """The mini model has no ffn_sub_norm: with BITNET_FUSED_FFN=1 the JAX
    generic path runs ``ffn_w2a8_fused`` (here the prefill, sent there by
    BITNET_STACKED_PREFILL=0, with M = 8 rows); the stacked prefill never
    calls ``_ffn``.  The port runs K24 exactly when the JAX kernel runs
    (no longer raising there), once a layer: the prefill logits agree
    within 1e-4 of their largest magnitude (f32; the sigmoid's last ulp
    may move an activation across a requantization boundary, see
    tests/test_torch_ffn_fused.py) and the greedy tokens are the JAX
    engine's."""
    clean_env.setenv("BITNET_FUSED_FFN", "1")
    for k, v in env.items():
        clean_env.setenv(k, v)
    je, pe = _engines(mini_gguf_qk256, 1, "bf16")
    assert (bm.stacked_prefill_ok(pe.cfg, pe.params, 8, "w2a8")
            == j_stacked_prefill_ok(je.cfg, je.params, 8, None, None, None, "w2a8")
            == (not env))
    calls, port_calls = [], []
    real = jffn.ffn_w2a8_fused
    clean_env.setattr(jffn, "ffn_w2a8_fused",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
    preal = bm.ffn_w2a8_fused
    clean_env.setattr(bm, "ffn_w2a8_fused",
                      lambda *a, **k: port_calls.append(a[0]) or preal(*a, **k))
    jl = np.asarray(je.prefill(PROMPTS[0]), np.float32)
    tl = pe.prefill(PROMPTS[0]).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4 * np.abs(jl).max())
    assert bool(calls) == bool(env)
    assert port_calls == ([0, 1] if env else [])
    gc = dict(max_new_tokens=6, greedy=True)
    assert (pe.generate(PROMPTS[0], GenerationConfig(**gc)).token_ids
            == je.generate(PROMPTS[0], JGenerationConfig(**gc)).token_ids)


@pytest.mark.parametrize("env,B", [({"BITNET_TL_W2A8": "0"}, 1),
                                   ({"BITNET_TL_FUSED": "0"}, 3)])
def test_tl_knobs_pick_the_jax_kernel(mini_gguf_qk256, clean_env, env, B):
    """TL2 weights, fused: BITNET_TL_W2A8=0 takes B = 1 off the W2A8 kernel
    (K11) onto the bf16 one (K12), BITNET_TL_FUSED=0 takes a pool off K12
    onto K10 with the norm, SwiGLU and residual in torch; the logits and
    greedy tokens are the JAX package's, and so is the receipt of the W2A8
    kernel.  K10's sums of biased weights cancel against its f32
    correction, so its results keep f32 rounding at 2e-3 of their size."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    je, pe = _engines(mini_gguf_qk256, B, "bf16", weight_quant="tl2")
    calls = []
    want_fn = "ternary_matmul_tl_bf16_normed" if B == 1 else "ternary_matmul_blockscale_bf16"
    real = getattr(bm, want_fn)
    clean_env.setattr(bm, want_fn, lambda *a, **k: calls.append(1) or real(*a, **k))
    _greedy_steps(je, pe, B, tol=1e-4 if B == 1 else 2e-3)
    assert calls
    # the JAX receipt names the W2A8 kernel from the knob and K alone, so a
    # pool records it without running it (ROADMAP.md §3)
    tag = "ternary_matmul_tl_w2a8_stacked"
    assert (tag in pe.kernel_recorder) == (tag in je.kernel_recorder) == (B > 1)
