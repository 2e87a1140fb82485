"""The plain version of kernel K5 (bitnet_tpu_torch.ops.decode_attention)
against the Pallas kernel it replaces, ``decode_attention`` of
bitnet_tpu/ops/decode_attention.py, run in interpret mode on the CPU.

The plain version walks the cache in the same chunks of min(1024, S)
rows as the TPU kernel and rounds its softmax weights to the cache dtype
against the same running maxima, so the two differ only in the order of
their f32 sums: a weight whose f32 value moves by an ulp can round to the
neighbouring bf16 before the PV product (2^-8 relative on that weight),
and the output is held to 2e-3 of its max magnitude (one bf16 ulp of the
output is 2^-8 of it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from bitnet_tpu_torch.ops import decode_attention as dk

L, H, KV, D = 2, 4, 2, 64


def _inputs(seed, B, S, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, KV, D)).astype(np.float32)
    vn = rng.standard_normal((B, KV, D)).astype(np.float32)
    kc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    vc = rng.standard_normal((L, B, S, KV * D)).astype(np.float32)
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("S,pos,dtype", [
    (64, [0], "f32"), (64, [1], "f32"), (64, [37], "f32"), (64, [63], "f32"),
    (64, [0, 63], "f32"), (64, [1, 37], "bf16"), (64, [37, 5], "f32"),
    (64, [63, 1], "bf16"),
    # S > 1024: the TPU kernel and the plain version walk 1024-row chunks
    (2048, [1500], "f32"), (2048, [2047, 700], "bf16")])
def test_k5_plain_matches_pallas(S, pos, dtype):
    B = len(pos)
    q, kn, vn, kc, vc = _inputs(S + sum(pos), B, S, dtype)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    l = 1
    want = jax_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
        jnp.asarray(kc[l], jnp.bfloat16).reshape(B, S, KV, D),
        jnp.asarray(vc[l], jnp.bfloat16).reshape(B, S, KV, D),
        jnp.asarray(pos, jnp.int32), interpret=True)
    got = dk.decode_attention(
        l, torch.from_numpy(q).to(tdt), torch.from_numpy(kn).to(tdt),
        torch.from_numpy(vn).to(tdt), torch.from_numpy(kc).to(torch.bfloat16),
        torch.from_numpy(vc).to(torch.bfloat16),
        torch.tensor(pos, dtype=torch.int32))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_k5_wrapper_checks_and_counts_nothing_on_cpu():
    q, kn, vn, kc, vc = _inputs(0, 1, 64, "f32")
    t = [torch.from_numpy(a) for a in (q, kn, vn)]
    kc_t = torch.from_numpy(kc).to(torch.bfloat16)
    vc_t = torch.from_numpy(vc).to(torch.bfloat16)
    pos = torch.tensor([3], dtype=torch.int32)
    before = dk.decode_attention.launches
    dk.decode_attention(0, *t, kc_t, vc_t, pos)
    assert dk.decode_attention.launches == before      # plain versions count nothing
    with pytest.raises(ValueError):                    # layer out of range
        dk.decode_attention(L, *t, kc_t, vc_t, pos)
    with pytest.raises(ValueError):                    # KV*D does not match the cache
        dk.decode_attention(0, t[0], t[1][:, :1], t[2][:, :1], kc_t, vc_t, pos)
    with pytest.raises(ValueError):                    # neither a CPU nor a CUDA tensor
        dk.decode_attention(0, t[0].to("meta"), *t[1:], kc_t, vc_t, pos)
