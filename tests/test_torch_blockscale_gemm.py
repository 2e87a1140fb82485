"""K10's GEMM form and K12 on the CPU: the tiling plan of their shared wgmma
GEMM, and the plain version of K10's row kernel against the JAX package.

- ``blockscale_gemm_plan`` over the main path's shapes (the 2B fused four and
  generic seven, the 8B four, the unaligned K = 6784 < Kp = 6912): BT holds
  M or is 128; the K split is a power of two of at most 8 that leaves every
  block a 256-row K tile; the blocks of a split fit the SMs; and the shapes
  whose column blocks leave SMs idle at decode rows are split.
- ``blockscale_rows_plain`` (the bf16 rows and 32-row sums the card's row
  kernel writes) and the correction formed from them against the values the
  JAX wrappers form in XLA (``bitnet_tpu/ops/ternary_matmul.py:533-538`` and
  ``:1159-1166``: pad in f32, round to bf16, sum each 32 in f32, then
  ``2·(sum32 @ s)`` at ``Precision.HIGHEST``), on numpy inputs from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitnet_tpu_torch.ops import ternary_matmul as tm

torch.set_num_threads(1)

H100_SMS = 132
# (K, N) of every block-scale GEMM on the main path
SHAPES_2B = [(2560, 3840), (2560, 2560), (2560, 13824), (6912, 2560),
             (2560, 640), (2560, 6912)]
SHAPES_8B = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]
SHAPE_UNALIGNED = [(6784, 2560)]


@pytest.mark.parametrize("M", [1, 2, 3, 8, 16, 17, 33, 64, 77, 128, 512, 2048])
@pytest.mark.parametrize("K,N", SHAPES_2B + SHAPES_8B + SHAPE_UNALIGNED)
def test_blockscale_gemm_plan_fits_the_card(M, K, N):
    Kp = -(-K // 256) * 256
    bt, split = tm.blockscale_gemm_plan(M, Kp, N, H100_SMS)
    assert bt in tm.BLOCKSCALE_GEMM_ROWS
    assert bt >= M or bt == tm.BLOCKSCALE_GEMM_ROWS[-1]
    # the smallest tile that holds M: no tile of half the rows would
    assert bt == tm.BLOCKSCALE_GEMM_ROWS[0] or bt // 2 < M
    assert split & (split - 1) == 0 and 1 <= split <= tm.BLOCKSCALE_GEMM_MAX_SPLIT
    assert split <= Kp // 256
    blocks = -(-N // tm.BLOCKSCALE_GEMM_COLS) * -(-M // bt)
    assert blocks * split <= H100_SMS or split == 1


@pytest.mark.parametrize("K,N,want", [(2560, 2560, 4), (6912, 2560, 4), (2560, 640, 8),
                                      (2560, 13824, 1)])
def test_blockscale_gemm_plan_splits_where_sms_idle(K, N, want):
    """K12's pool of 8: o and down (20 column blocks) split K four ways, k and
    v (5 column blocks) eight, gate|up (108) not at all."""
    assert tm.blockscale_gemm_plan(8, K, N, H100_SMS) == (8, want)


def _jax_rows_and_corr(x, s, kp, dtype):
    """The JAX wrappers' operands of the block-scale body: x padded in f32,
    rounded to bf16, its 32-row sums in f32 and the HIGHEST-precision
    correction (``:533-538``, ``:1159-1166``)."""
    xj = jnp.asarray(x, dtype)
    k = xj.shape[1]
    if k != kp:
        xj = jnp.pad(xj.astype(jnp.float32), ((0, 0), (0, kp - k)))
    xb = xj.astype(jnp.bfloat16)
    sum32 = jnp.sum(xb.astype(jnp.float32).reshape(xb.shape[0], kp // 32, 32), axis=-1)
    corr = 2.0 * jnp.matmul(sum32, jnp.asarray(s), precision=jax.lax.Precision.HIGHEST)
    return (np.asarray(xb.astype(jnp.float32)), np.asarray(sum32), np.asarray(corr))


@pytest.mark.parametrize("M", [1, 3, 40])
@pytest.mark.parametrize("k", [512, 224])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockscale_rows_plain_matches_jax(M, k, dtype):
    """The bf16 rows equal JAX's bit for bit (one rounding of the same f32
    value, zeros past K).  The sums and the correction agree within the f32
    rounding bound of either summation order: an f32 sum of n terms in any
    order is within (n − 1)·2^-24·Σ|term| of the exact sum, so two orders
    are within twice that; the correction adds its own matmul's bound over
    Kp/32 terms, each |sum32|·|s| bounded by the block's Σ|x|·|s|."""
    rng = np.random.default_rng(100 + M + k)
    kp = -(-k // 256) * 256
    x = rng.standard_normal((M, k)).astype(np.float32)
    s = rng.uniform(0.01, 0.03, (kp // 32, 256)).astype(np.float16).astype(np.float32)
    s[k // 32:] = 0                                   # as the loader pads them
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    want_xb, want_sum32, want_corr = _jax_rows_and_corr(x, s, kp, jdt)
    xb, sum32 = tm.blockscale_rows_plain(torch.from_numpy(x).to(tdt), kp)
    assert xb.dtype == torch.bfloat16 and xb.shape == (M, kp)
    assert sum32.dtype == torch.float32 and sum32.shape == (M, kp // 32)
    np.testing.assert_array_equal(xb.float().numpy(), want_xb)
    abs32 = np.abs(want_xb).reshape(M, kp // 32, 32).sum(-1)
    np.testing.assert_array_less(np.abs(sum32.numpy() - want_sum32),
                                 2 * 31 * 2.0**-24 * abs32 + 1e-30)
    corr = tm.blockscale_correction(sum32, torch.from_numpy(s))
    bound = 2 * 2 * (kp // 32 + 31) * 2.0**-24 * (abs32 @ s)
    np.testing.assert_array_less(np.abs(corr.numpy() - want_corr), bound + 1e-30)
    # the correction the plain K10 subtracts is this one
    words = rng.integers(-2**31, 2**31 - 1, (kp // 16, 256), dtype=np.int32)
    got = tm.ternary_matmul_blockscale_bf16_plain(
        xb, corr, torch.from_numpy(words), torch.from_numpy(s), 256, True, torch.float32)
    again = tm.ternary_matmul_blockscale_bf16(
        0, torch.from_numpy(x).to(tdt), torch.from_numpy(words)[None],
        torch.from_numpy(s)[None], k, 256, True)
    assert torch.equal(got.to(tdt), again)


@pytest.mark.parametrize("M,kp", [(1, 256), (5, 2560), (3, 6912)])
def test_blockscale_sums_split_layout_and_precision(M, kp):
    """The row kernel's third output: each K tile's 8 sums as 32 bf16
    values (hi, lo, hi, lo), hi = bf16(v), lo = bf16(v − hi), so hi + lo is
    v within 2^-16·|v| (two roundings, each within bf16's 2^-8).  The GEMM
    multiplies them by the same split of −2·s on the tensor cores: the four
    products sum to −2·s·v within 2^-15 of |s·v| a term, far inside K10's
    f32 tolerance (1e-4 of the largest output)."""
    rng = np.random.default_rng(M + kp)
    nb = kp // 32
    sum32 = torch.from_numpy((rng.standard_normal((M, nb)) * 6).astype(np.float32))
    got = tm.blockscale_sums_split(sum32)
    assert got.dtype == torch.bfloat16 and got.shape == (M, kp // 8)
    t = got.float().view(M, nb // 8, 4, 8)
    assert torch.equal(t[:, :, 0], t[:, :, 2]) and torch.equal(t[:, :, 1], t[:, :, 3])
    hi, lo = t[:, :, 0].reshape(M, nb).double(), t[:, :, 1].reshape(M, nb).double()
    v = sum32.double()
    assert torch.equal(t[:, :, 0].reshape(M, nb), sum32.to(torch.bfloat16).float())
    assert ((hi + lo - v).abs() <= 2.0**-16 * v.abs()).all()
    s = torch.from_numpy(rng.uniform(0.01, 0.03, (nb, 16)).astype(np.float16)
                         .astype(np.float32))
    S = -2.0 * s
    S_hi = S.to(torch.bfloat16).float()
    S_lo = (S - S_hi).to(torch.bfloat16).float()
    split = (hi @ (S_hi.double() + S_lo.double()) + lo @ (S_hi.double() + S_lo.double()))
    exact = v @ S.double()
    assert ((split - exact).abs() <= 2.0**-15 * (v.abs() @ S.double().abs())).all()
