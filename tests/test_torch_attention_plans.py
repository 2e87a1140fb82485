"""The plain versions of K13–K23, the decode-attention wrappers of every
other plan, against the Pallas kernels they replace, run in interpret mode
on the CPU (seeded numpy inputs; H=4, KV=2, D=64, S ∈ {64, 1280}).

Each plain version computes K2's function (the raw q|k|v row, RoPE and
for a quantized cache the new rows' quantization inside) or K5's (q and
the new rows apart), in its Pallas kernel's chunks of cache rows: the
per-b v1 kernels min(1024, S), the whole-batch v1 kernels a 2048-row
budget over the pool for every cache dtype, the v2 kernels ``_pick_chunk``
(4096 rows for a 1-byte cache, over the batch group).  The chunk rules are
held equal to the JAX wrappers' for every (S, B).

Tolerances: the roped k row and the v row, and a quantized cache's new
codes, are exact (one f32 RoPE or one IEEE division, rounded once); the
new rows' scales are held to an f32 ulp (the Pallas kernel's division,
traced by XLA, may land one ulp from the IEEE quotient).  The attention
output is held to 2e-3 of its max magnitude: the scores are sums of the
same exact products taken in another order, and a softmax weight whose
f32 value moves by an ulp can round to the neighbouring bf16 before the PV
product (2^-8 relative on that one weight).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.models.bitnet import _quantize_kv as jquantize_kv
from bitnet_tpu.ops import decode_attention as jv1
from bitnet_tpu.ops import decode_attention_v2 as jv2
from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da
from bitnet_tpu_torch.ops import registry

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

L, H, KV, D = 2, 4, 2, 64
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def to_torch(a) -> torch.Tensor:
    """A JAX / numpy array as a torch tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a tensor (bf16 and fp8 have no numpy dtype)."""
    view = {torch.float8_e4m3fn: torch.uint8, torch.bfloat16: torch.int16}
    return (t.view(view[t.dtype]) if t.dtype in view else t).numpy()


def _positions(rng, B, S):
    """Valid rows per slot: a full cache, an empty one (pos 0) and any."""
    pos = rng.integers(1, S, B).astype(np.int32)
    pos[0] = S - 1
    if B > 1:
        pos[1] = 0 if B > 2 else S // 3
    return pos


def _cache(rng, B, S, kv):
    """Flat cache stacks [L, B, S, KV*D] (bf16, or codes with their f32
    scales [L, B, S, KV] from the JAX quantizer)."""
    kf = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    vf = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    if kv == "bf16":
        return (jnp.asarray(kf.reshape(L, B, S, KV * D), jnp.bfloat16),
                jnp.asarray(vf.reshape(L, B, S, KV * D), jnp.bfloat16), None, None)
    kq, ks = jquantize_kv(jnp.asarray(kf), JDT[kv])
    vq, vs = jquantize_kv(jnp.asarray(vf), JDT[kv])
    return kq.reshape(L, B, S, KV * D), vq.reshape(L, B, S, KV * D), ks, vs


def _close(got, want):
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


# (port wrapper, JAX wrapper, layout of the JAX cache: flat with n_kv, or 5-D)
ROPE_FUSED = {
    "qkv_v1": (dk.decode_attention_qkv_v1, jv1.decode_attention_qkv, "flat"),
    "qkv_quant_v1": (dk.decode_attention_qkv_quant_v1,
                     jv1.decode_attention_qkv_quant, "flat"),
    "qkv_batched": (dk.decode_attention_qkv_batched,
                    jv1.decode_attention_qkv_batched, "5d"),
    "qkv_quant_batched": (dk.decode_attention_qkv_quant_batched,
                          jv1.decode_attention_qkv_quant_batched, "5d"),
    "qkv_batched_v2": (da.decode_attention_qkv_batched_v2,
                       jv2.decode_attention_qkv_batched_v2, "flat"),
    "qkv_quant_batched_v2": (da.decode_attention_qkv_quant_batched_v2,
                             jv2.decode_attention_qkv_quant_batched_v2, "flat"),
}


# one case a kernel (the interpret-mode kernels cost ~2 s a call), over
# both cache lengths, every cache dtype, B = 1…3 and both activation dtypes
@pytest.mark.parametrize("name,kv,S,B,qdtype", [
    ("qkv_v1", "bf16", 1280, 2, "bf16"), ("qkv_quant_v1", "fp8", 64, 1, "f32"),
    ("qkv_batched", "bf16", 64, 3, "f32"),
    ("qkv_quant_batched", "int8", 1280, 3, "bf16"),
    ("qkv_batched_v2", "bf16", 1280, 3, "f32"),
    ("qkv_quant_batched_v2", "fp8", 64, 3, "bf16")])
def test_rope_fused_plain_matches_pallas(name, kv, S, B, qdtype):
    """K13, K14, K18, K19, K20, K21."""
    wrapper, jfn, layout = ROPE_FUSED[name]
    rng = np.random.default_rng(S + 7 * B + len(name))
    qkv = rng.standard_normal((B, H + 2 * KV, D)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (B, D // 2)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    kc, vc, ks, vs = _cache(rng, B, S, kv)
    pos = _positions(rng, B, S)
    jd = jnp.float32 if qdtype == "f32" else jnp.bfloat16
    jqkv = jnp.asarray(qkv, jd)
    l = 1
    jk, jv = kc[l], vc[l]
    kw = {"n_kv": KV} if layout == "flat" else {}
    if layout == "5d":
        jk, jv = jk.reshape(B, S, KV, D), jv.reshape(B, S, KV, D)
    jscales = () if ks is None else (ks[l], vs[l])
    want = jfn(jqkv, jnp.asarray(sin), jnp.asarray(cos), jk, jv, *jscales,
               jnp.asarray(pos), n_heads=H, interpret=True, **kw)
    tscales = () if ks is None else (to_torch(ks), to_torch(vs))
    got = wrapper(l, to_torch(jqkv), torch.from_numpy(sin), torch.from_numpy(cos),
                  to_torch(kc), to_torch(vc), *tscales, torch.from_numpy(pos),
                  n_heads=H, n_kv=KV)
    assert got[0].dtype == to_torch(jqkv).dtype and got[0].shape == (B, H, D)
    for t, j in zip(got[1:3], want[1:3]):           # the new rows (or codes)
        np.testing.assert_array_equal(bits(t), bits(to_torch(j)))
    for t, j in zip(got[3:], want[3:]):             # their scales
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.4e-7, atol=0)
    _close(got[0], want[0])


# (port wrapper, JAX wrapper, layout of the JAX cache)
SPLIT = {
    "quant": (dk.decode_attention_quant, jv1.decode_attention_quant, "5d"),
    "batched_v1": (dk.decode_attention_batched_v1, jv1.decode_attention_batched,
                   "5d"),
    "quant_batched_v1": (dk.decode_attention_quant_batched_v1,
                         jv1.decode_attention_quant_batched, "5d"),
    "batched_v2": (da.decode_attention_batched_v2, jv2.decode_attention_batched_v2,
                   "flat"),
    "quant_batched_v2": (da.decode_attention_quant_batched_v2,
                         jv2.decode_attention_quant_batched_v2, "flat"),
}


@pytest.mark.parametrize("name,kv,S,B,qdtype", [
    ("quant", "int8", 1280, 1, "f32"), ("batched_v1", "bf16", 64, 3, "bf16"),
    ("quant_batched_v1", "fp8", 1280, 3, "f32"),
    ("batched_v2", "bf16", 1280, 3, "bf16"),
    ("quant_batched_v2", "int8", 64, 2, "f32")])
def test_split_plain_matches_pallas(name, kv, S, B, qdtype):
    """K15, K16, K17, K22, K23: q and the new rows apart (a quantized
    cache's rows round-tripped through it, as the model feeds them)."""
    wrapper, jfn, layout = SPLIT[name]
    rng = np.random.default_rng(S + 5 * B + len(name))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KV, D)).astype(np.float32)
    vn = rng.standard_normal((B, KV, D)).astype(np.float32)
    kc, vc, ks, vs = _cache(rng, B, S, kv)
    if ks is not None:
        rt = [jquantize_kv(jnp.asarray(x), JDT[kv]) for x in (kn, vn)]
        kn, vn = (np.asarray(c.astype(jnp.float32) * s[..., None]) for c, s in rt)
    pos = _positions(rng, B, S)
    jd = jnp.float32 if qdtype == "f32" else jnp.bfloat16
    jq, jkn, jvn = (jnp.asarray(a, jd) for a in (q, kn, vn))
    l = 1
    jk, jv = kc[l], vc[l]
    kw = {"n_kv": KV} if layout == "flat" else {}
    if layout == "5d":
        jk, jv = jk.reshape(B, S, KV, D), jv.reshape(B, S, KV, D)
    jscales = () if ks is None else (ks[l], vs[l])
    want = jfn(jq, jkn, jvn, jk, jv, *jscales, jnp.asarray(pos), interpret=True,
               **kw)
    tscales = () if ks is None else (to_torch(ks), to_torch(vs))
    got = wrapper(l, to_torch(jq), to_torch(jkn), to_torch(jvn), to_torch(kc),
                  to_torch(vc), *tscales, torch.from_numpy(pos))
    assert got.dtype == to_torch(jq).dtype and got.shape == (B, H, D)
    _close(got, want)


def test_chunk_rules_match_the_jax_wrappers():
    """The rows a TPU grid step reads, against the JAX wrappers' own rule
    (``_pick_chunk``; the v1 wrappers' inline min(1024, S) and 2048-row
    budget)."""
    for S in (8, 64, 96, 256, 1280, 1536, 2048, 4096, 6144):
        # the per-b v1 wrappers: a 1024-row chunk halved until it divides S
        assert dk.v1_chunk(S) == jv2._pick_chunk(1024, S, 1, 2)
        for B in (1, 2, 3, 5, 8, 16, 17, 18, 48, 64):
            for isz in (1, 2):
                assert dk.pick_chunk(S, B, isz) == jv2._pick_chunk(None, S, B, isz)
            assert dk.pick_group(B) == jv2._pick_group(B)


def test_wrappers_count_nothing_on_cpu_and_check_their_arguments():
    """Every wrapper's plain version runs for CPU tensors and counts no
    launch; a tensor on neither the CPU nor a card raises (no fallback)."""
    rng = np.random.default_rng(0)
    B, S = 2, 64
    kc, vc, _, _ = _cache(rng, B, S, "bf16")
    kc, vc = to_torch(kc), to_torch(vc)
    qkv = torch.randn((B, H + 2 * KV, D))
    sc = torch.rand((B, D // 2))
    q, kn, vn = torch.randn((B, H, D)), torch.randn((B, KV, D)), torch.randn((B, KV, D))
    pos = torch.tensor([5, 9], dtype=torch.int32)
    ks = torch.ones((L, B, S, KV))
    kc8, vc8 = kc.to(torch.int8), vc.to(torch.int8)
    registry.reset_launch_counts()
    for wrapper, _j, _layout in ROPE_FUSED.values():
        quant = "quant" in wrapper.__name__
        caches = (kc8, vc8, ks, ks) if quant else (kc, vc)
        wrapper(0, qkv, sc, sc, *caches, pos, n_heads=H, n_kv=KV)
        with pytest.raises(ValueError):
            wrapper(0, qkv.to("meta"), sc, sc, *caches, pos, n_heads=H, n_kv=KV)
    for wrapper, _j, _layout in SPLIT.values():
        quant = "quant" in wrapper.__name__
        caches = (kc8, vc8, ks, ks) if quant else (kc, vc)
        wrapper(1, q, kn, vn, *caches, pos)
        with pytest.raises(ValueError):                # layer out of range
            wrapper(L, q, kn, vn, *caches, pos)
    assert all(n == 0 for n in registry.launch_counts().values())
