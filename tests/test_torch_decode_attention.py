"""Plain versions of kernels K2 / K3 (bitnet_tpu_torch.ops.decode_attention_v2)
against the Pallas kernels they replace, run in interpret mode on the CPU.

K2: the roped k row and the v row are exact (the same f32 RoPE, rounded
once to the cache dtype).  The attention output is held to 2e-3 of its
max magnitude: the scores are sums of the same exact products taken in
another order, and a softmax weight whose f32 value moves by an ulp can
round to the neighbouring bf16 before the PV product (2^-8 relative on
that one weight).  K3 is a copy and must match exactly, pos >= S included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops.decode_attention_v2 import (
    decode_attention_qkv_v2_stacked,
    scatter_kv_rows as jax_scatter_kv_rows,
)
from bitnet_tpu_torch.ops import decode_attention_v2 as da

L, H, KV, D, S = 2, 4, 2, 64, 64


def _inputs(seed, B, qdtype):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, H + 2 * KV, D)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (B, D // 2)).astype(np.float32)
    kc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    vc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    jq = jnp.asarray(qkv, jnp.float32 if qdtype == "f32" else jnp.bfloat16)
    tq = torch.from_numpy(qkv).to(torch.float32 if qdtype == "f32" else torch.bfloat16)
    return (jq, tq, np.sin(ang), np.cos(ang), jnp.asarray(kc, jnp.bfloat16),
            jnp.asarray(vc, jnp.bfloat16), torch.from_numpy(kc).to(torch.bfloat16),
            torch.from_numpy(vc).to(torch.bfloat16))


@pytest.mark.parametrize("pos,qdtype", [
    ([0], "f32"), ([1], "f32"), ([37], "f32"), ([S - 1], "f32"),
    ([S - 1], "bf16"), ([5, S - 1], "f32"), ([0, 40], "bf16")])
def test_k2_plain_matches_pallas(pos, qdtype):
    B = len(pos)
    jq, tq, sin, cos, jk, jv, tk, tv = _inputs(sum(pos) + B, B, qdtype)
    l = 1
    ja, jkr, jvr = decode_attention_qkv_v2_stacked(
        jnp.int32(l), jq, jnp.asarray(sin), jnp.asarray(cos), jk, jv,
        jnp.asarray(pos, jnp.int32), n_heads=H, interpret=True, n_kv=KV)
    ta, tkr, tvr = da.decode_attention_qkv(
        l, tq, torch.from_numpy(sin), torch.from_numpy(cos), tk, tv,
        torch.tensor(pos, dtype=torch.int32), n_heads=H, n_kv=KV)
    assert ta.dtype == tq.dtype and tkr.dtype == torch.bfloat16
    np.testing.assert_array_equal(tkr.float().numpy(),
                                  np.asarray(jkr.astype(jnp.float32)))
    np.testing.assert_array_equal(tvr.float().numpy(),
                                  np.asarray(jvr.astype(jnp.float32)))
    want = np.asarray(ja.astype(jnp.float32))
    np.testing.assert_allclose(ta.float().numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("pos", [[0, 7], [S - 1, 3], [S, S + 5], [12, S]])
def test_k3_plain_matches_pallas(pos):
    B = len(pos)
    rng = np.random.default_rng(sum(pos))
    kc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    vc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    kr = rng.standard_normal((L, B, 1, KV * D)).astype(np.float32)
    vr = rng.standard_normal((L, B, 1, KV * D)).astype(np.float32)
    jk, jv = jax_scatter_kv_rows(
        jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
        jnp.asarray(kr, jnp.bfloat16), jnp.asarray(vr, jnp.bfloat16),
        jnp.asarray(pos, jnp.int32), interpret=True)
    tk = torch.from_numpy(kc).to(torch.bfloat16)
    tv = torch.from_numpy(vc).to(torch.bfloat16)
    out_k, out_v = da.scatter_kv_rows(
        tk, tv, torch.from_numpy(kr).to(torch.bfloat16),
        torch.from_numpy(vr).to(torch.bfloat16), torch.tensor(pos, dtype=torch.int32))
    assert out_k is tk                       # in place
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))


def test_k2_wrapper_checks_shapes():
    _jq, tq, sin, cos, _jk, _jv, tk, tv = _inputs(0, 1, "f32")
    with pytest.raises(ValueError):
        da.decode_attention_qkv(0, tq, torch.from_numpy(sin), torch.from_numpy(cos),
                                tk, tv, torch.tensor([3], dtype=torch.int32),
                                n_heads=H + 1, n_kv=KV)
    with pytest.raises(ValueError):          # a device that is neither CPU nor CUDA
        da.decode_attention_qkv(0, tq.to("meta"), torch.from_numpy(sin),
                                torch.from_numpy(cos), tk, tv,
                                torch.tensor([3], dtype=torch.int32), n_heads=H, n_kv=KV)
