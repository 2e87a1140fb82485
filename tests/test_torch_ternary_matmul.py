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

import dataclasses

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


@pytest.mark.parametrize("M,dtype,k,n", [
    (5, "f32", K, N), (130, "f32", K, N), (64, "bf16", K, N),
    # ragged and tiny M (the wgmma kernel's 8-row tile and a row past it)
    (1, "f32", K, N), (8, "f32", K, N), (33, "f32", K, N), (257, "f32", K, N),
    (33, "bf16", K, N),
    # two K tiles, and a narrow N like the generic path's k / v (640)
    (8, "f32", 512, N), (77, "bf16", 512, N), (8, "f32", K, 640),
    (33, "bf16", 512, 640)])
def test_k4_plain_matches_pallas(M, dtype, k, n):
    if (k, n) == (K, N):
        rng, words, sv, _g = _stack(200 + M)
    else:
        rng = np.random.default_rng(200 + M + k + n)
        words = rng.integers(-2**31, 2**31 - 1, (L, k // 16, n), dtype=np.int32)
        sv = rng.uniform(0.5, 1.5, (L, n)).astype(np.float32) * 0.02
    x = rng.standard_normal((M, k)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = ternary_matmul_stacked_prefill(
        jnp.int32(1), jnp.asarray(x, jdt), jnp.asarray(words), jnp.asarray(sv),
        k_dim=k, n_dim=n, interpret=True)
    got = tm.ternary_matmul_w2a8(1, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(words), torch.from_numpy(sv),
                                 k_dim=k, n_dim=n)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == (M, n) and got.dtype == tdt
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


# --------------------------------------------------------------------------
# K6 (bf16 activations) and the generic path's dispatcher
# --------------------------------------------------------------------------
def _jax_lin(words, scale, k, n):
    from bitnet_tpu.ops.linear import TernaryLinear as JLin

    return JLin(kind="qk256", k=k, n=n, packed=jnp.asarray(words),
                scales=jnp.float32(scale))


def _port_lin(words, scale, k, n):
    from bitnet_tpu_torch.ops.linear import TernaryLinear, with_col_scales

    return with_col_scales(TernaryLinear(
        kind="qk256", k=k, n=n, packed=torch.from_numpy(words),
        scales=torch.tensor(scale, dtype=torch.float32)))


@pytest.mark.parametrize("M,dtype", [(1, "f32"), (2, "bf16"), (40, "f32"),
                                     (130, "bf16")])
def test_k6_plain_matches_pallas(M, dtype):
    """K6's plain version against the ``_qk256_kernel`` body of
    ``_ternary_matmul_2d(variant='pallas')``: both round x to bf16 and sum
    the exact products in f32 (in another order), so f32 outputs agree to
    2e-6 of their max magnitude; a bf16 output can round to the
    neighbouring bf16 (2^-8 relative)."""
    from bitnet_tpu.ops.ternary_matmul import _pick_blocks, _ternary_matmul_2d

    rng, words, _sv, _g = _stack(300 + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    scale = 0.03
    bm, bn, bkt = _pick_blocks(M, K, N, "pallas")
    want = _ternary_matmul_2d(
        jnp.asarray(x, jdt), jnp.asarray(words[1]), jnp.float32(scale),
        kind="qk256", variant="pallas", k_dim=K, n_dim=N, bm=bm, bn=bn,
        bkt=bkt, interpret=True, out_dtype=jdt)
    sv = torch.full((L, N), scale, dtype=torch.float32)
    got = tm.ternary_matmul_bf16(1, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(words), sv, K, N)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (M, N)
    tol = 2e-6 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_k6_integer_parts_exact():
    """The bf16 rows K6 multiplies and the biased codes {0,1,3,4} it
    expands are the JAX kernel's exactly."""
    rng, words, _sv, _g = _stack(400)
    x = rng.standard_normal((5, K)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        xb.float().numpy(), np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                       .astype(jnp.float32)))
    codes = unpack_words_host(words[0], K).astype(np.int8)
    np.testing.assert_array_equal(tm.biased_codes(torch.from_numpy(words[0])).numpy(),
                                  codes + (codes >> 1))


@pytest.mark.parametrize("M,k,vecscale,dtype", [
    (3, 200, False, "f32"), (3, 200, True, "bf16"), (2, K, True, "f32"),
    (1, 200, True, "bf16"), (40, 200, True, "f32"), (130, 136, False, "bf16")])
def test_k6_unpadded_x_matches_pallas(M, k, vecscale, dtype):
    """K6 takes x [M, K] unpadded, K ≤ Kp, in its own dtype, and a per-column
    scale vector: against ``_ternary_matmul_2d(variant='pallas')``, which
    pads x to Kp itself (and, with a [1, N] scale, takes its ``vecscale``
    epilogue); the tolerances of ``test_k6_plain_matches_pallas``."""
    from bitnet_tpu.ops.ternary_matmul import _pick_blocks, _ternary_matmul_2d

    rng, words, sv, _g = _stack(700 + M + k)
    x = rng.standard_normal((M, k)).astype(np.float32)
    if not vecscale:
        sv = np.full_like(sv, 0.03)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    bm, bn, bkt = _pick_blocks(M, K, N, "pallas")
    want = _ternary_matmul_2d(
        jnp.asarray(x, jdt), jnp.asarray(words[1]),
        jnp.asarray(sv[1][None, :]) if vecscale else jnp.float32(0.03),
        kind="qk256", variant="pallas", k_dim=k, n_dim=N, bm=bm, bn=bn,
        bkt=bkt, interpret=True, out_dtype=jdt)
    got = tm.ternary_matmul_bf16(1, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(words), torch.from_numpy(sv), k, N)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (M, N)
    tol = 2e-6 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("M,k,dtype", [(1, K, "f32"), (3, 200, "f32"),
                                       (5, 200, "bf16"), (64, 136, "f32")])
def test_k6_row_kernel_plain_matches_jax(M, k, dtype):
    """The plain version of K6's row kernel: its bf16 rows are JAX's
    ``x.astype(bf16)`` of x zero-padded to Kp bit for bit, and its row sums
    JAX's ``sumx`` (``:1114-1121``) within the f32 bound of two summation
    orders, 2·Kp·2^-24·Σ|x| a row."""
    rng = np.random.default_rng(800 + M + k)
    x = (rng.standard_normal((M, k)) * 3.0).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.pad(jnp.asarray(x, jdt).astype(jnp.float32), ((0, 0), (0, K - k)))
    jxb = jx.astype(jnp.bfloat16)
    jsum = np.asarray(jnp.sum(jxb.astype(jnp.float32), axis=1))
    xb, sumx = tm.colscale_rows_plain(torch.from_numpy(x).to(tdt), K)
    assert xb.dtype == torch.bfloat16 and xb.shape == (M, K) and sumx.shape == (M,)
    np.testing.assert_array_equal(xb.float().numpy(),
                                  np.asarray(jxb.astype(jnp.float32)))
    bound = 2 * K * 2.0**-24 * np.abs(np.asarray(jxb.astype(jnp.float32))).sum(1)
    assert (np.abs(sumx.numpy() - jsum) <= bound).all()


@pytest.mark.parametrize("M,k", [(1, 200), (3, 200), (80, 136), (2, K)])
def test_pallas_dispatcher_passes_x_to_k6_unpadded(M, k, monkeypatch):
    """``linear_apply_normed(path='pallas')`` hands K6 x as it is, [M, K]
    with K < Kp, and K6 pads it itself: the dispatcher pads nothing."""
    from bitnet_tpu_torch.ops.linear import linear_apply_normed

    rng, words, _sv, gamma = _stack(900 + M + k)
    seen, k6 = [], tm.ternary_matmul_bf16

    def spy(l, x, packed, scale_vec, k_dim, n_dim):
        seen.append((tuple(x.shape), k_dim))
        return k6(l, x, packed, scale_vec, k_dim, n_dim)

    monkeypatch.setattr(tm, "ternary_matmul_bf16", spy)
    x = torch.from_numpy(rng.standard_normal((M, k)).astype(np.float32))
    y = linear_apply_normed(_port_lin(words[0], 0.02, k, N), x,
                            torch.from_numpy(gamma[0, :k]), path="pallas")
    assert seen == [((M, k), k)] and y.shape == (M, N)


def test_k6_refuses_what_its_forms_do_not_take():
    """K6 takes K ≤ Kp (not more), x of K values, bf16 / f32 on the CPU or a
    CUDA device; its decode-form rule is a row count the decode form takes."""
    _rng, words, sv, _g = _stack(0)
    w, s = torch.from_numpy(words), torch.from_numpy(sv)
    with pytest.raises(ValueError):       # K > Kp
        tm.ternary_matmul_bf16(0, torch.zeros(2, K + 16), w, s, K + 16, N)
    with pytest.raises(ValueError):       # x narrower than k_dim
        tm.ternary_matmul_bf16(0, torch.zeros(2, 200), w, s, 208, N)
    with pytest.raises(ValueError):       # neither a CPU nor a CUDA tensor
        tm.ternary_matmul_bf16(0, torch.zeros(1, K, device="meta"), w, s, K, N)
    assert 1 <= tm.BF16_DECODE_MAX_M <= 16


@pytest.mark.parametrize("variant,M,k,glu,norm,resid,dtype", [
    ("w2a8", 2, K, True, True, True, "f32"),       # normed: K1
    ("w2a8", 3, K, False, False, False, "bf16"),   # normed, no norm: K1
    ("w2a8", 80, K, False, True, True, "f32"),     # quantize in torch, then K4
    ("w2a8", 2, 200, False, True, False, "f32"),   # K != Kp: pad, then K4
    ("pallas", 1, K, True, True, True, "f32"),     # bf16 body: K6
    ("pallas", 80, K, False, False, True, "bf16"),
    ("pallas", 2, 200, False, False, False, "f32"),
])
def test_dispatcher_matches_ternary_matmul_pallas(variant, M, k, glu, norm,
                                                  resid, dtype):
    """``ternary_matmul_pallas`` of the port against the JAX dispatcher of
    the same name, branch by branch.  The K1 and K4 branches requantize to
    int8 (an f32 ulp in the norm can flip one int8 activation), the K6
    branch rounds to bf16 after the norm: held to 1e-2 of the output's max
    magnitude, as K1 is above."""
    from bitnet_tpu.ops.ternary_matmul import ternary_matmul_pallas as jtmp

    rng, words, _sv, gamma = _stack(500 + M + k + glu + 2 * norm)
    x = rng.standard_normal((M, 2 * k if glu else k)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    g = gamma[0, :k]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    scale = 0.02
    want = jtmp(_jax_lin(words[0], scale, k, N), jnp.asarray(x, jdt),
                interpret=True, variant=variant,
                gamma=jnp.asarray(g) if norm else None, eps=1e-5, glu=glu,
                resid=jnp.asarray(r, jdt) if resid else None)
    got = tm.ternary_matmul_pallas(
        _port_lin(words[0], scale, k, N), torch.from_numpy(x).to(tdt),
        variant=variant, gamma=torch.from_numpy(g) if norm else None, eps=1e-5,
        glu=glu, resid=torch.from_numpy(r).to(tdt) if resid else None)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_dispatcher_refuses_unported_kinds():
    """bitnet32 and tl run (K10, ``tests/test_torch_tl.py``); a dense
    linear (the kind of the JAX package's F32 / densified weights, ported:
    it used to raise naming #7) has no words for a kernel, and the
    dispatcher refuses it as the JAX ``ternary_matmul_pallas`` fails on it;
    ``linear_apply`` runs it on every path as the JAX one does."""
    from bitnet_tpu.ops.linear import dense_linear as jdense
    from bitnet_tpu.ops.linear import linear_apply as japply
    from bitnet_tpu.ops.ternary_matmul import ternary_matmul_pallas as jpallas
    from bitnet_tpu_torch.errors import QuantizationError
    from bitnet_tpu_torch.ops.linear import dense_linear, linear_apply

    w = np.random.default_rng(3).standard_normal((K, N)).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((2, K)).astype(np.float32)
    with pytest.raises(AttributeError):
        jpallas(jdense(jnp.asarray(w)), jnp.asarray(x), variant="w2a8")
    lin = dense_linear(torch.from_numpy(w))
    with pytest.raises(QuantizationError, match="dense"):
        tm.ternary_matmul_pallas(lin, torch.from_numpy(x), variant="w2a8")
    want = np.asarray(japply(jdense(jnp.asarray(w)), jnp.asarray(x), path="w2a8"))
    for path in ("w2a8", "pallas", "xla"):
        got = linear_apply(lin, torch.from_numpy(x), path=path).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("form", ["scalar", "per_layer", "fused"])
def test_col_scales_once_at_init(form):
    """``with_col_scales`` gives every qk256 linear the ``[L, Np]`` f32 rows
    the kernels read: a scalar (or per-layer scalar) broadcast over the
    columns, a fused per-column vector as it is, padded to Np with 1.0.
    The kernel paths refuse a linear that has none."""
    from bitnet_tpu_torch.ops.linear import (TernaryLinear, concat_linears,
                                             with_col_scales)

    rng, words, _sv, _g = _stack(600)
    if form == "scalar":
        lin = _port_lin(words[0], 0.25, K, N)
        want = np.full((1, N), 0.25, np.float32)
    elif form == "per_layer":
        s = rng.uniform(0.5, 1.5, L).astype(np.float32)
        lin = with_col_scales(TernaryLinear(kind="qk256", k=K, n=N,
                                            packed=torch.from_numpy(words),
                                            scales=torch.from_numpy(s)))
        want = np.repeat(s[:, None], N, axis=1)
    else:
        parts = [TernaryLinear(kind="qk256", k=K, n=N // 2,
                               packed=torch.from_numpy(words[:, :, :N // 2]),
                               scales=torch.full((L,), v)) for v in (0.5, 2.0)]
        lin = with_col_scales(concat_linears(parts))
        want = np.repeat(np.array([[0.5] * (N // 2) + [2.0] * (N // 2)],
                                  np.float32), L, axis=0)
    assert lin.col_scales.dtype == torch.float32 and lin.col_scales.is_contiguous()
    np.testing.assert_array_equal(lin.col_scales.numpy(), want)
    bare = dataclasses.replace(lin, col_scales=None)
    with pytest.raises(ValueError, match="col_scales"):
        tm.ternary_matmul_pallas(bare, torch.zeros(1, K), variant="pallas")
