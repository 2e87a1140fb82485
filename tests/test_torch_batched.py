"""Pools of B = 3…64 on the port's fused stacked path against the JAX package.

- ``decode_attn_plan`` picks the reference's plan for every B in 1…64 and
  every cache dtype (flat cache, no environment overrides).
- K8 and K9's plain versions against the Pallas kernels they replace
  (``decode_attention_batched_v2_stacked`` / ``…_quant_…``), in interpret
  mode, at B ∈ {3, 8, 18} (18 rides the TPU wrapper's batch groups) with
  partly filled caches and one idle slot at pos = 0.  The outputs are held
  to 2e-3 of their max magnitude: the scores are sums of the same exact
  products in another order, and a softmax weight whose f32 value moves by
  an ulp can round to the neighbouring bf16 before the PV product.
- ``InferenceEngine.generate_batch`` against the JAX engine's: the same
  greedy tokens and stop reasons at f32, B = 4 with mixed prompt lengths
  and one slot that stops early, bf16 and int8 (``kv_cache_dtype="auto"``);
  an odd pool of B = 17 on the ``einsum`` plan.
- ``CacheWrites``: the fixed-shape drop write against ``mode="drop"``,
  with no ``nonzero`` (no host sync).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.models.bitnet import _quantize_kv as jquantize_kv
from bitnet_tpu.models.bitnet import decode_attn_plan as jdecode_attn_plan
from bitnet_tpu.ops.decode_attention_v2 import (
    decode_attention_batched_v2_stacked,
    decode_attention_quant_batched_v2_stacked,
)
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import InferenceError
from bitnet_tpu_torch.models.bitnet import CacheWrites, decode_attn_plan
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


def _pool(seed, B, qdtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KV, D)).astype(np.float32)
    vn = rng.standard_normal((B, KV, D)).astype(np.float32)
    kf = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    vf = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    # partly filled: one idle slot at 0, the others anywhere up to S
    pos = rng.integers(1, S + 1, B).astype(np.int32)
    pos[B // 2] = 0
    jd = jnp.float32 if qdtype == "f32" else jnp.bfloat16
    return q, kn, vn, kf, vf, pos, jd


@pytest.mark.parametrize("B", [3, 8, 18])
@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
def test_k8_plain_matches_pallas(B, qdtype):
    q, kn, vn, kf, vf, pos, jd = _pool(B, B, qdtype)
    kc = jnp.asarray(kf.reshape(L, B, S, KV * D), jnp.bfloat16)
    vc = jnp.asarray(vf.reshape(L, B, S, KV * D), jnp.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, kn, vn))
    tk, tv = to_torch(kc), to_torch(vc)
    for l in (0, 1):
        want = np.asarray(decode_attention_batched_v2_stacked(
            jnp.int32(l), jq, jk, jv, kc, vc, jnp.asarray(pos), interpret=True,
            n_kv=KV).astype(jnp.float32))
        got = da.decode_attention_batched(
            l, to_torch(jq), to_torch(jk), to_torch(jv), tk, tv,
            torch.from_numpy(pos))
        assert got.dtype == to_torch(jq).dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("B", [3, 8, 18])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_k9_plain_matches_pallas(B, kv):
    q, kn, vn, kf, vf, pos, jd = _pool(100 + B, B, "bf16")
    kq, ks = jquantize_kv(jnp.asarray(kf), JDT[kv])
    vq, vs = jquantize_kv(jnp.asarray(vf), JDT[kv])
    kc, vc = kq.reshape(L, B, S, KV * D), vq.reshape(L, B, S, KV * D)
    # the new rows arrive round-tripped through the cache dtype
    knq, kns = jquantize_kv(jnp.asarray(kn), JDT[kv])
    vnq, vns = jquantize_kv(jnp.asarray(vn), JDT[kv])
    k_rt = knq.astype(jnp.float32) * kns[..., None]
    v_rt = vnq.astype(jnp.float32) * vns[..., None]
    jq = jnp.asarray(q, jd)
    want = np.asarray(decode_attention_quant_batched_v2_stacked(
        jnp.int32(1), jq, k_rt, v_rt, kc, vc, jnp.swapaxes(ks, 2, 3),
        jnp.swapaxes(vs, 2, 3), jnp.asarray(pos), interpret=True,
        n_kv=KV).astype(jnp.float32))
    got = da.decode_attention_quant_batched(
        1, to_torch(jq), to_torch(k_rt), to_torch(v_rt), to_torch(kc),
        to_torch(vc), to_torch(ks), to_torch(vs), torch.from_numpy(pos))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_decode_attn_plan_matches_reference(monkeypatch):
    for var in ("BITNET_CACHE_YS", "BITNET_ROPE_FUSED", "BITNET_FP8_KERNEL",
                "BITNET_BATCHED_ATTN", "BITNET_DECODE_ATTN_MAX_B",
                "BITNET_V2_WHOLEBATCH_MAX_B", "BITNET_B1_ATTN",
                "BITNET_STACKED_DECODE_MAX_M"):
        monkeypatch.delenv(var, raising=False)
    for B in range(1, 65):
        for kv, jkv in (("bf16", None), ("int8", jnp.int8),
                        ("fp8", jnp.float8_e4m3fn)):
            assert decode_attn_plan(B, kv) == jdecode_attn_plan(B, jkv, flat=True), (B, kv)


def _engines(mini, B, kv, max_seq_len=64):
    je = JEngine.from_gguf(mini.path, JEngineConfig(
        kernel_path="w2a8", max_seq_len=max_seq_len, compute_dtype="f32",
        fuse_projections=True, max_batch_size=B, kv_cache_dtype=kv))
    pe = InferenceEngine.from_gguf(mini.path, EngineConfig(
        kernel_path="w2a8", max_seq_len=max_seq_len, compute_dtype="f32",
        fuse_projections=True, max_batch_size=B, kv_cache_dtype=kv),
        device="cpu")
    return je, pe


PROMPTS = [[1, 5, 9, 14, 200, 77, 3], [1, 33], [1, 9, 250, 7, 80, 12, 5, 61, 2, 44, 6],
           [1, 120, 17, 4]]


@pytest.mark.parametrize("kv,plan", [("bf16", "batched_v2"),
                                     ("auto", "quant_batched_v2")])
def test_generate_batch_matches_jax_f32(mini_gguf_qk256, kv, plan):
    je, pe = _engines(mini_gguf_qk256, 4, kv)
    assert pe.stacked_decode() and pe.decode_plan() == plan
    gc = dict(max_new_tokens=8, greedy=True)
    free = je.generate_batch(PROMPTS, JGenerationConfig(**gc))
    # slot 1 stops early on its third token (a stop id; not emitted)
    stop = (free[1].token_ids[2],)
    want = je.generate_batch(PROMPTS, JGenerationConfig(**gc, stop_token_ids=stop))
    got = pe.generate_batch(PROMPTS, GenerationConfig(**gc, stop_token_ids=stop))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.stop_reason.value for r in got] == [r.stop_reason.value for r in want]
    assert len(got[1].token_ids) <= 2 and got[1].stop_reason.value == "stop_token"
    assert "prefill_batch4_T16" in pe.kernel_recorder
    assert "decode_batch4" in pe.kernel_recorder


def test_odd_pool_of_17_rides_the_einsum_plan(mini_gguf_qk256):
    """Odd B > 16 runs attention in plain torch inside the stacked loop
    (``:698-717``); three of its slots are busy, the rest idle at S."""
    je, pe = _engines(mini_gguf_qk256, 17, "int8")
    assert pe.stacked_decode() and pe.decode_plan() == "einsum"
    prompts = PROMPTS[:3]
    want = je.generate_batch(prompts, JGenerationConfig(max_new_tokens=6, greedy=True))
    got = pe.generate_batch(prompts, GenerationConfig(max_new_tokens=6, greedy=True))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]


def test_fault2_every_pool_up_to_64_takes_the_stacked_loop(mini_gguf_qk256,
                                                           monkeypatch):
    """The port left the stacked loop for every plan outside its ported
    set; the reference takes every B <= 64 into it, whatever the plan."""
    import bitnet_tpu_torch.models.bitnet as bm

    calls = []
    real = bm._decode_stacked
    monkeypatch.setattr(bm, "_decode_stacked",
                        lambda *a, **k: calls.append(a[2].shape[0]) or real(*a, **k))
    for B in (3, 17):
        _je, pe = _engines(mini_gguf_qk256, B, "bf16", max_seq_len=32)
        pe.generate_batch([[1, 5, 9]], GenerationConfig(max_new_tokens=2, greedy=True))
    assert calls == [3, 17]


def test_generate_batch_refusals(mini_gguf_qk256):
    _je, pe = _engines(mini_gguf_qk256, 2, "bf16", max_seq_len=32)
    gc = GenerationConfig(max_new_tokens=2, greedy=True)
    assert pe.generate_batch([], gc) == []
    for prompts, cfg in (([[1, 2]], GenerationConfig(logprobs=2)),
                         ([[1, 2], []], gc), ([[1]] * 3, gc),
                         ([list(range(1, 33))], gc)):
        with pytest.raises(InferenceError):
            pe.generate_batch(prompts, cfg)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_cache_writes_drop_like_the_reference(dtype):
    """Positions >= S change nothing, also beside a valid write at S-1 of
    the same slot; the write has fixed shapes and never calls nonzero."""
    rng = np.random.default_rng(5)
    B, T, Sc, W = 3, 5, 8, 6
    pos = np.array([[0, 1, 2, 8, 9], [3, 7, 8, 8, 8], [8, 8, 8, 8, 8]], np.int32)
    cache = rng.integers(-100, 100, (B, Sc, W)).astype(np.float32)
    rows = rng.integers(-100, 100, (B, T, W)).astype(np.float32)
    b_idx = np.arange(B)[:, None]
    want = np.asarray(jnp.asarray(cache).at[b_idx, pos].set(jnp.asarray(rows),
                                                           mode="drop"))
    layer = torch.from_numpy(cache).to(dtype)
    with _Ops() as ops:
        CacheWrites.of(torch.from_numpy(pos), Sc).put(layer, torch.from_numpy(rows))
    np.testing.assert_array_equal(layer.float().numpy(), want)
    assert not any("nonzero" in n for n in ops.names), ops.names
