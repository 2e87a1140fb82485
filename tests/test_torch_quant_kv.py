"""int8 and fp8-e4m3 KV caches in the port against the JAX package.

- ``quantize_kv`` against ``_quantize_kv``: the same int8 codes and fp8
  bits, and the same f32 scales (both one IEEE division of the same f32
  absmax, so they are held equal).
- K7's plain version against ``decode_attention_qkv_quant_v2_stacked`` in
  interpret mode, B ∈ {1, 2}, partly filled caches and a slot at pos = 0:
  the new rows' codes equal and their scales to an f32 ulp, the output held
  to 2e-3 of its max
  magnitude (sums of the same products in another order; a softmax weight
  an f32 ulp away can round to the neighbouring bf16).
- K3 on 1-byte rows with their scales against ``scatter_kv_rows`` and the
  reference's clamped scale write (``models/bitnet.py:954-963``): equal.
- The engines: fused int8 (B=1, plan ``qkv_quant_v2s``) and fp8 (B=2), the
  unfused generic path with an int8 cache: greedy tokens equal to the JAX
  package at f32; one decode step from the same (carried-across) cache.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.models.bitnet import _quantize_kv as jquantize_kv
from bitnet_tpu.ops.decode_attention_v2 import (
    decode_attention_qkv_quant_v2_stacked,
    scatter_kv_rows as jax_scatter_kv_rows,
)
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.cache import allocate_cache
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models import bitnet as bm
from bitnet_tpu_torch.models.convert import cache_from_arrays
from bitnet_tpu_torch.ops import decode_attention_v2 as da

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

L, H, KV, D, S = 2, 4, 2, 64, 256
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def to_torch(a) -> torch.Tensor:
    """A JAX / numpy array as a torch tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantize_kv_matches_jax(kv):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, KV, D)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0                                 # absmax 0: the 1e-8 floor
    x[1, 1, 1, :4] = [127.0, -63.5, 0.5, 1.5]        # halves at the code grid
    x[1, 1, 1, 4:] = 0.0
    for arr in (x, x.astype(jnp.bfloat16)):
        jq, js = jquantize_kv(jnp.asarray(arr), JDT[kv])
        tq, ts = da.quantize_kv(to_torch(jnp.asarray(arr)), TDT[kv])
        assert tq.dtype == TDT[kv] and ts.dtype == torch.float32
        np.testing.assert_array_equal(bits(tq), bits(to_torch(jq)))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _quant_cache(rng, B, kv):
    kf = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    vf = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    kq, ks = jquantize_kv(jnp.asarray(kf), JDT[kv])
    vq, vs = jquantize_kv(jnp.asarray(vf), JDT[kv])
    return (kq.reshape(L, B, S, KV * D), vq.reshape(L, B, S, KV * D), ks, vs)


@pytest.mark.parametrize("pos", [[0], [37], [S], [0, 200], [S - 1, 5]])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_k7_plain_matches_pallas(pos, kv):
    B = len(pos)
    rng = np.random.default_rng(sum(pos) + B)
    qkv = rng.standard_normal((B, H + 2 * KV, D)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (B, D // 2)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    kc, vc, ks, vs = _quant_cache(rng, B, kv)
    l = 1
    ja, jkq, jvq, jks, jvs = decode_attention_qkv_quant_v2_stacked(
        jnp.int32(l), jnp.asarray(qkv), jnp.asarray(sin), jnp.asarray(cos), kc,
        vc, jnp.swapaxes(ks, 2, 3), jnp.swapaxes(vs, 2, 3),
        jnp.asarray(pos, jnp.int32), n_heads=H, interpret=True, n_kv=KV)
    ta, tkq, tvq, tks, tvs = da.decode_attention_qkv_quant(
        l, torch.from_numpy(qkv), torch.from_numpy(sin), torch.from_numpy(cos),
        to_torch(kc), to_torch(vc), to_torch(ks), to_torch(vs),
        torch.tensor(pos, dtype=torch.int32), n_heads=H, n_kv=KV)
    np.testing.assert_array_equal(bits(tkq), bits(to_torch(jkq)))
    np.testing.assert_array_equal(bits(tvq), bits(to_torch(jvq)))
    # the Pallas kernel's scale division, traced by XLA, may land one f32
    # ulp from the IEEE quotient (``quantize_kv`` outside a kernel does not)
    for t, j in ((tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.4e-7, atol=0)
    want = np.asarray(ja)
    np.testing.assert_allclose(ta.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_k3_writes_quantized_rows_and_scales(kv):
    B = 3
    rng = np.random.default_rng(9)
    kc, vc, ks, vs = _quant_cache(rng, B, kv)
    kr, vr, ksr, vsr = (a[:, :, :1] for a in _quant_cache(rng, B, kv))
    pos = np.array([4, S - 1, S + 3], np.int32)
    tk, tv, tks, tvs = (to_torch(a) for a in (kc, vc, ks, vs))
    jk, jv = jax_scatter_kv_rows(kc, vc, kr, vr, jnp.asarray(pos),   # donates
                                 interpret=True)
    want_ks, want_vs = np.array(ks), np.array(vs)
    for b, p in enumerate(np.minimum(pos, S - 1)):      # the clamped XLA write
        want_ks[:, b, p] = np.asarray(ksr)[:, b, 0]
        want_vs[:, b, p] = np.asarray(vsr)[:, b, 0]
    da.scatter_kv_rows(tk, tv, to_torch(kr), to_torch(vr), torch.from_numpy(pos),
                       tks, tvs, to_torch(ksr), to_torch(vsr))
    np.testing.assert_array_equal(bits(tk), bits(to_torch(jk)))
    np.testing.assert_array_equal(bits(tv), bits(to_torch(jv)))
    np.testing.assert_array_equal(tks.numpy(), want_ks)
    np.testing.assert_array_equal(tvs.numpy(), want_vs)


def test_cache_allocates_codes_and_unit_scales():
    from bitnet_tpu_torch.config import ModelConfig

    cfg = ModelConfig(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      hidden_size=256)
    for kv, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        c = allocate_cache(cfg, 3, 16, kv, device="cpu")
        assert c.k.dtype == dt and tuple(c.k.shape) == (2, 3, 16, 128)
        assert tuple(c.k_scale.shape) == (2, 3, 16, 2)
        assert bool((c.v_scale == 1).all()) and c.v_scale.dtype == torch.float32
    assert allocate_cache(cfg, 1, 16, "bf16", device="cpu").k_scale is None
    # an f32 cache (it raised naming #18 until slice 7): f32 rows, no scales
    c = allocate_cache(cfg, 2, 16, "f32", device="cpu")
    assert c.k.dtype == torch.float32 and c.k_scale is None
    assert tuple(c.v.shape) == (2, 2, 16, 128)
    with pytest.raises(ValueError, match="bad KV cache dtype"):
        allocate_cache(cfg, 1, 16, "f16", device="cpu")


def _engines(mini, B, kv, fuse, kp="w2a8"):
    je = JEngine.from_gguf(mini.path, JEngineConfig(
        kernel_path=kp, max_seq_len=64, compute_dtype="f32",
        fuse_projections=fuse, max_batch_size=B, kv_cache_dtype=kv))
    pe = InferenceEngine.from_gguf(mini.path, EngineConfig(
        kernel_path=kp, max_seq_len=64, compute_dtype="f32",
        fuse_projections=fuse, max_batch_size=B, kv_cache_dtype=kv),
        device="cpu")
    return je, pe


@pytest.mark.parametrize("B,kv,fuse,kp", [
    (1, "int8", True, "w2a8"), (2, "fp8", True, "w2a8"),
    (1, "int8", False, "w2a8"), (1, "int8", False, "xla"),
    (2, "fp8", False, "pallas")])
def test_greedy_tokens_match_jax_f32(mini_gguf_qk256, B, kv, fuse, kp):
    prompt = [1, 5, 9, 14, 200, 77, 3]
    je, pe = _engines(mini_gguf_qk256, B, kv, fuse, kp)
    assert pe.cache.k_scale is not None and pe.stacked_decode() == fuse
    want = je.generate(prompt, JGenerationConfig(max_new_tokens=8, greedy=True))
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=8, greedy=True))
    assert got.token_ids == want.token_ids
    if fuse:
        assert any(k.startswith("decode_w2a8_attn_qkv_quant_v2s")
                   for k in pe.kernel_recorder)


def test_decode_step_from_a_carried_cache(mini_gguf_qk256):
    """One fused int8 decode step of both packages from the same cache
    (the JAX cache carried across with ``cache_from_arrays``): the new
    rows' codes and scales equal, the logits to 1e-4 of their max."""
    je, pe = _engines(mini_gguf_qk256, 1, "int8", True)
    prompt = [1, 7, 3, 250, 9, 44, 12]
    je.prefill(prompt)
    pe.prefill(prompt)
    c = je.cache
    pe.cache = cache_from_arrays(c.k, c.v, c.lengths, c.k_scale, c.v_scale,
                                 device="cpu")
    pos = len(prompt)
    jl, je.cache = je._get_decode()(je.params, jnp.asarray([[42]], jnp.int32),
                                    je.cache, jnp.asarray([[pos]], jnp.int32))
    tl = pe.decode_step(42, pos)
    c = je.cache
    for t, j in ((pe.cache.k, c.k), (pe.cache.v, c.v)):
        np.testing.assert_array_equal(bits(t[:, 0, pos]),
                                      np.asarray(j).reshape(t.shape)[:, 0, pos])
    np.testing.assert_array_equal(pe.cache.k_scale[:, 0, pos].numpy(),
                                  np.asarray(c.k_scale)[:, 0, pos])
    want = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_fault1_plan_is_read_from_the_cache_dtype(mini_gguf_qk256):
    """``str(torch.int8)`` is "torch.int8", which the plan rule never read
    as quantized: an int8 cache got the bf16 plan."""
    assert bm.kv_dtype_name(torch.int8) == "int8"
    assert bm.kv_dtype_name(torch.float8_e4m3fn) == "fp8"
    _je, pe = _engines(mini_gguf_qk256, 1, "int8", True)
    assert pe.decode_plan() == "qkv_quant_v2s"
    pe.generate([1, 2, 3], GenerationConfig(max_new_tokens=3, greedy=True))
    assert "decode_w2a8_attn_qkv_quant_v2s_x3" in pe.kernel_recorder


def test_fault3_fast_decode_skips_quantized_caches(mini_gguf_qk256, monkeypatch):
    """The generic ``fast_decode`` branch (K5, bf16 caches only) must not
    take an int8 cache (``bitnet_tpu/models/bitnet.py:1276-1279``)."""
    def refuse(*a, **k):
        raise AssertionError("K5 got a quantized cache")

    monkeypatch.setattr(bm, "decode_attention", refuse)
    _je, pe = _engines(mini_gguf_qk256, 1, "int8", False)
    r = pe.generate([1, 2, 3], GenerationConfig(max_new_tokens=3, greedy=True))
    assert len(r.token_ids) == 3
