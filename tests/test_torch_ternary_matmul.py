"""Plain versions of kernels K1 / K4 (bitnet_tpu_torch.ops.ternary_matmul)
against the Pallas kernels they replace, run in interpret mode on the CPU.

Integer parts are exact: the int8 rows and row sums from the same f32
input, and the int32 dot against the biased codes.  Float outputs: K4's
quantization sees the same f32 input in both packages, so its f32 outputs
agree to f32 rounding (rtol 1e-6).  For bf16 inputs XLA's CPU build of
the same expressions gives a per-row scale one f32 ulp off the plain
division (the f32 variant is bit-identical), which can move an int8
activation across a rounding boundary, as below.  K1 normalizes inside (rsqrt and the
f32 row reductions run in another order in each framework), which can
move an int8 activation across a rounding boundary; one such flip moves
an output by at most sx·scale·4, so K1 is held to 1e-2 of the output's
max magnitude (bf16 K4 too).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops.linear import unpack_words_host
from bitnet_tpu.ops.ternary_matmul import (
    ternary_matmul_stacked,
    ternary_matmul_stacked_prefill,
)
from bitnet_tpu_torch.ops import ternary_matmul as tm

L, K, N = 2, 256, 256


def _stack(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31 - 1, (L, K // 16, N), dtype=np.int32)
    sv = rng.uniform(0.5, 1.5, (L, N)).astype(np.float32) * 0.02
    gamma = rng.uniform(0.5, 1.5, (L, K)).astype(np.float32)
    return rng, words, sv, gamma


@pytest.mark.parametrize("glu,norm,resid,M,dtype", [
    (glu, norm, resid, 3, "f32")
    for glu in (False, True) for norm in (False, True) for resid in (False, True)
] + [(True, True, True, 1, "f32"), (True, True, True, 64, "f32"),
     (False, True, True, 3, "bf16")])
def test_k1_plain_matches_pallas(glu, norm, resid, M, dtype):
    rng, words, sv, gamma = _stack(M * 8 + glu * 4 + norm * 2 + resid)
    x = rng.standard_normal((M, 2 * K if glu else K)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    l = 1
    want = ternary_matmul_stacked(
        jnp.int32(l), jnp.asarray(x, jdt), jnp.asarray(words), jnp.asarray(sv),
        jnp.asarray(gamma) if norm else None, k_dim=K, n_dim=N, eps=1e-5,
        glu=glu, resid=jnp.asarray(r, jdt) if resid else None, interpret=True)
    got = tm.ternary_matmul_w2a8_normed(
        l, torch.from_numpy(x).to(tdt), torch.from_numpy(words),
        torch.from_numpy(sv), torch.from_numpy(gamma) if norm else None,
        k_dim=K, n_dim=N, eps=1e-5, glu=glu,
        resid=torch.from_numpy(r).to(tdt) if resid else None)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("M", [1, 3, 64])
def test_quantize_and_int_dot_exact(M):
    """Same f32 rows → identical int8 rows, row sums and int32 dot."""
    rng, words, _sv, _g = _stack(100 + M)
    xf = rng.standard_normal((M, K)).astype(np.float32) * 3.0
    xq, sx, sumq = tm.quantize_rows(torch.from_numpy(xf))
    # the JAX package's quantization (ternary_matmul.py:441-445)
    jx = jnp.asarray(xf)
    jsx = jnp.maximum(jnp.max(jnp.abs(jx), axis=1, keepdims=True), 1e-8) / 127.0
    jq = jnp.clip(jnp.round(jx / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx)[:, 0])
    np.testing.assert_array_equal(
        sumq.numpy(), np.asarray(jnp.sum(jq.astype(jnp.int32), axis=1)))
    codes = unpack_words_host(words[0], K).astype(np.int64)
    want = np.asarray(jq).astype(np.int64) @ (codes + (codes >> 1))
    got = tm.int8_matmul(xq, tm.biased_codes(torch.from_numpy(words[0])))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,dtype", [(5, "f32"), (130, "f32"), (64, "bf16")])
def test_k4_plain_matches_pallas(M, dtype):
    rng, words, sv, _g = _stack(200 + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = ternary_matmul_stacked_prefill(
        jnp.int32(1), jnp.asarray(x, jdt), jnp.asarray(words), jnp.asarray(sv),
        k_dim=K, n_dim=N, interpret=True)
    got = tm.ternary_matmul_w2a8(1, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(words), torch.from_numpy(sv),
                                 k_dim=K, n_dim=N)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _rng, words, sv, _g = _stack(0)
    w, s = torch.from_numpy(words), torch.from_numpy(sv)
    with pytest.raises(ValueError):       # no rows
        tm.ternary_matmul_w2a8_normed(0, torch.zeros(0, K), w, s, None, K, N)
    with pytest.raises(ValueError):       # more rows than the decode cap
        tm.ternary_matmul_w2a8_normed(0, torch.zeros(tm.STACKED_DECODE_MAX_M + 1, K),
                                      w, s, None, K, N)
    with pytest.raises(ValueError):       # Np not a whole number of column blocks
        tm.ternary_matmul_w2a8(0, torch.zeros(4, K), w[..., :N - 32].contiguous(),
                               s[:, :N - 32].contiguous(), K, N - 32)
    with pytest.raises(ValueError):       # K != Kp
        tm.ternary_matmul_w2a8(0, torch.zeros(4, K - 16), w, s, K - 16, N)
    with pytest.raises(ValueError):       # neither a CPU nor a CUDA tensor
        tm.ternary_matmul_w2a8_normed(0, torch.zeros(1, K, device="meta"),
                                      w, s, None, K, N)
    assert tm.STACKED_DECODE_MAX_M == 64
