"""bitnet_tpu_torch.ops.linear against bitnet_tpu.ops.linear: the int32 word
layout, the dequantized weights and the fused scale vectors must be
bit-identical (same numpy inputs, made from a seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops import linear as jl
from bitnet_tpu.quant.qk256 import quantize_qk256
from bitnet_tpu_torch.ops import linear as tl


@pytest.mark.parametrize("K,N", [(256, 128), (512, 384), (300, 200), (1024, 64)])
def test_repack_and_fold_bit_identical(K, N):
    codes = np.random.default_rng(K + N).integers(0, 4, (K, N), dtype=np.uint8)
    want = jl.fold_packed_words(jl.repack_codes_for_tpu(codes))
    got = tl.fold_packed_words(tl.repack_codes(codes))
    np.testing.assert_array_equal(got, want)
    # and back: the host unpack recovers the logical codes
    np.testing.assert_array_equal(tl.unpack_words_host(got, K), codes)


@pytest.mark.parametrize("K,N", [(256, 128), (512, 256), (300, 200)])
def test_linear_from_codes_and_dequantize(K, N):
    codes = np.random.default_rng(7 * K + N).integers(0, 4, (K, N), dtype=np.uint8)
    jlin = jl.qk256_linear_from_codes(codes, 0.5)
    tlin = tl.qk256_linear_from_codes(codes, 0.5)
    np.testing.assert_array_equal(tlin.packed.numpy(), np.asarray(jlin.packed))
    np.testing.assert_array_equal(
        tl.unpack_packed(tlin.packed).numpy(),
        np.asarray(jl._unpack_packed(jlin.packed)))
    np.testing.assert_array_equal(
        tl.dequantize_weight(tlin, torch.float32).numpy(),
        np.asarray(jl.dequantize_weight(jlin, jnp.float32)))


@pytest.mark.parametrize("transposed", [False, True])
def test_linear_from_payload_matches(transposed):
    out_dim, in_dim = 384, 512
    w = np.random.default_rng(3).standard_normal((out_dim, in_dim)).astype(np.float32)
    if transposed:
        stored = w.T.copy()
        payload = np.frombuffer(quantize_qk256(stored), np.uint8)
        codes_kn = tl.extract_codes(payload, in_dim, out_dim)
        jlin = jl.qk256_linear_from_codes(np.ascontiguousarray(codes_kn))
    else:
        payload = np.frombuffer(quantize_qk256(w), np.uint8)
        jlin = jl.qk256_linear_from_payload(payload, out_dim, in_dim)
    tlin = tl.qk256_linear_from_payload(payload, out_dim, in_dim,
                                        transposed=transposed)
    np.testing.assert_array_equal(tlin.packed.numpy(), np.asarray(jlin.packed))
    assert (tlin.k, tlin.n) == (jlin.k, jlin.n)


def test_concat_linears_scale_vectors():
    rng = np.random.default_rng(11)
    L, K = 2, 256
    jlins, tlins = [], []
    for n, s in ((256, 0.5), (128, 2.0), (128, 1.5)):
        words = rng.integers(-2**31, 2**31 - 1, (L, K // 16, n), dtype=np.int32)
        scales = np.full((L,), s, np.float32)
        jlins.append(jl.TernaryLinear(kind="qk256", k=K, n=n,
                                      packed=jnp.asarray(words),
                                      scales=jnp.asarray(scales)))
        tlins.append(tl.TernaryLinear(kind="qk256", k=K, n=n,
                                      packed=torch.from_numpy(words),
                                      scales=torch.from_numpy(scales)))
    jf, tf = jl.concat_linears(jlins), tl.concat_linears(tlins)
    assert (tf.k, tf.n) == (jf.k, jf.n)
    np.testing.assert_array_equal(tf.packed.numpy(), np.asarray(jf.packed))
    np.testing.assert_array_equal(tf.scales.numpy(), np.asarray(jf.scales))
    assert tf.scales.shape == (L, 1, 512)


def test_concat_rejects_unaligned_widths():
    from bitnet_tpu_torch.errors import QuantizationError

    lin = tl.qk256_linear_from_codes(np.zeros((256, 100), np.uint8))
    lin.n = 100
    with pytest.raises(QuantizationError):
        tl.concat_linears([lin, lin])
