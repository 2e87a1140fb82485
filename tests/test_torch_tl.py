"""BitNet32-F16 and TL1 / TL2 weights in the port against the JAX package.

- **Codecs and re-quantization.**  The I2_S 32-element-block codecs and the
  TL codecs give the JAX package's bytes, codes and scales; the runtime TL
  re-quantization (torch, on the weights' device) gives the JAX package's
  numpy codes and scales bit for bit, on the mini QK256 model (whose
  weights land on exact ±0.5 ties of ``w/s``: round half to even) and on
  the float weights of the mini F32 model.
- **Plain kernel versions against the Pallas sites**, in interpret mode:
  - K10 against ``_ternary_matmul_2d``'s bitnet32/TL body (``:1177``) and
    ``ternary_matmul_stacked_tl`` (``:555``).  Both round x and the
    *biased* scaled weights to bf16, sum the exact products in f32 (in
    another order) and subtract the same f32 correction: f32 outputs
    agree to 1e-5 of their max magnitude (the correction cancels the
    larger biased sum), bf16 outputs to two bf16 ulps (8e-3).
  - K11 against ``ternary_matmul_stacked_tl_w2a8`` (``:960``), at M = 1, 2
    and at the 8B down projection's K = 14336 too: the int8
    rows from the same f32 rows and the per-block int32 partials are
    exact; outputs within 1e-4 of max|ref| (the reference's own gate,
    ``tests/test_tl_inference.py:244-303``: the norm's f32 sums run in
    another order, and the f32 block sums too).
  - K12 against ``ternary_matmul_stacked_tl_fused`` (``:733``): the
    *unbiased* scaled weights rounded to bf16; 1e-4 of max|ref| at f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops.linear import unpack_words_host
from bitnet_tpu.ops.ternary_matmul import (
    _pick_blocks,
    _ternary_matmul_2d,
    ternary_matmul_stacked_tl,
    ternary_matmul_stacked_tl_fused,
    ternary_matmul_stacked_tl_w2a8,
)
from bitnet_tpu_torch.ops import ternary_matmul as tm

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

L, K, N = 2, 512, 256


def _stack(seed, k=K, n=N):
    """Random words [L, Kp/16, n], f16-valued block scales [L, k/32, n] in
    the loader's range, RMSNorm gains [L, k]."""
    rng = np.random.default_rng(seed)
    kp = -(-k // 256) * 256
    words = rng.integers(-2**31, 2**31 - 1, (L, kp // 16, n), dtype=np.int32)
    s = rng.uniform(0.01, 0.03, (L, k // 32, n)).astype(np.float16).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, (L, k)).astype(np.float32)
    return rng, words, s, gamma


def _pad_scales(s, kp):
    """JAX block scales [L, k/32, n] → the port's [L, Kp/32, n]."""
    return np.pad(s, ((0, 0), (0, kp // 32 - s.shape[1]), (0, 0)))


def _dt(dtype):
    return ((jnp.float32, torch.float32) if dtype == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _close(got, want, rel):
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flavor", ["bitnet32", "split32"])
def test_i2s_codecs_match_jax(flavor):
    from bitnet_tpu.quant import i2s as ji2s
    from bitnet_tpu_torch.quant import i2s

    rng = np.random.default_rng(1)
    x = rng.standard_normal(32 * 37 + 5).astype(np.float32)
    x[:32] = 0.0                                       # an all-zero block
    if flavor == "bitnet32":
        pay = i2s.quantize_bitnet32(x)
        assert pay == ji2s.quantize_bitnet32(x)
        np.testing.assert_array_equal(i2s.dequantize_bitnet32(pay, x.size),
                                      ji2s.dequantize_bitnet32(pay, x.size))
        # |s| clipped to [1e-3, 1e3]: a negative and a tiny f16 scale
        raw = np.frombuffer(pay, np.uint8).copy().reshape(-1, 10)
        raw[1, 8:] = np.array([-0.5], np.float16).view(np.uint8)
        raw[2, 8:] = np.array([1e-5], np.float16).view(np.uint8)
        codes, s = i2s.bitnet32_codes_and_scales(raw, x.size)
        assert s[1] == np.float32(np.float16(0.5)) and s[2] == np.float32(1e-3)
        np.testing.assert_array_equal(i2s.dequantize_bitnet32(raw, x.size),
                                      ji2s.dequantize_bitnet32(raw, x.size))
    else:
        pay, s = i2s.quantize_split32(x)
        jpay, js = ji2s.quantize_split32(x)
        assert pay == jpay
        np.testing.assert_array_equal(s, js)
        for sc in (None, s, np.float32([0.25])):
            np.testing.assert_array_equal(i2s.dequantize_split32(pay, x.size, sc),
                                          ji2s.dequantize_split32(pay, x.size, sc))


@pytest.mark.parametrize("variant", ["tl1", "tl2"])
def test_tl_codecs_match_jax(variant):
    from bitnet_tpu.quant import tl as jtl
    from bitnet_tpu_torch.quant import tl

    rng = np.random.default_rng(2)
    x = rng.standard_normal(128 * 9 + 17).astype(np.float32)
    q, dq = getattr(tl, f"quantize_{variant}"), getattr(tl, f"dequantize_{variant}")
    pay, s = q(x)
    jpay, js = getattr(jtl, f"quantize_{variant}")(x)
    assert pay == jpay
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(
        dq(pay, x.size, s), getattr(jtl, f"dequantize_{variant}")(pay, x.size, s))


def _same_linear(t, j):
    """A port linear equals a JAX one: kind, dims, words; the port's block
    scales are the JAX scales zero-padded from K/32 to Kp/32 rows."""
    assert (t.kind, t.k, t.n) == (j.kind, j.k, j.n)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    js = np.asarray(j.scales)
    ts = t.scales.numpy()
    np.testing.assert_array_equal(ts[..., : js.shape[-2], :], js)
    assert not ts[..., js.shape[-2]:, :].any()


@pytest.mark.parametrize("variant,tied", [("tl1", True), ("tl2", True),
                                          ("tl2", False)])
def test_requant_of_qk256_model_is_bit_identical(tmp_path, variant, tied):
    """``quantize_params_tl`` on a loaded QK256 model: every linear (and an
    untied ``lm_head``) gets the JAX package's codes and scales."""
    from bitnet_tpu.gguf.fixtures import MiniModelSpec, generate_mini_gguf
    from bitnet_tpu.models.loader import load_model as jload
    from bitnet_tpu.quant.tl import quantize_params_tl as jq
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.quant.tl import quantize_params_tl

    path = str(tmp_path / "m.gguf")
    generate_mini_gguf(path, MiniModelSpec(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
        quant="qk256", tie_embeddings=tied))
    _c, jp, _m = jload(path, param_dtype=jnp.float32)
    _c, p, _m = load_model(path, param_dtype=torch.float32, device="cpu")
    jp, p = jq(jp, variant), quantize_params_tl(p, variant)
    for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        _same_linear(getattr(p.blocks, n), getattr(jp.blocks, n))
    assert (p.lm_head is None) == tied
    if not tied:
        _same_linear(p.lm_head, jp.lm_head)


@pytest.mark.parametrize("variant", ["tl1", "tl2"])
def test_requant_rounds_ties_to_even(variant):
    """The synthetic QK256 stacks (LUT values {-2,-1,1,2} times 0.02, block
    absmax 0.04) put ``w/s`` on exact ±0.5 ties: torch must round them
    half to even as numpy does, or codes differ from the JAX package's."""
    from bitnet_tpu.ops.linear import TernaryLinear as JLin
    from bitnet_tpu.quant.tl import quantize_linear_tl as jq
    from bitnet_tpu_torch.config import ModelConfig
    from bitnet_tpu_torch.models.synthetic import build_synthetic
    from bitnet_tpu_torch.ops.linear import dequantize_weight
    from bitnet_tpu_torch.quant.tl import TL1_BLOCK, TL2_BLOCK, quantize_linear_tl

    block = TL1_BLOCK if variant == "tl1" else TL2_BLOCK
    cfg = ModelConfig(vocab_size=64, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=32)
    lin = build_synthetic(cfg, seed=3, device="cpu").blocks.w_down
    w = dequantize_weight(dataclasses.replace(lin, packed=lin.packed[0],
                                              scales=lin.scales[0]), torch.float32)
    bmax = w.abs().reshape(-1, block, w.shape[1]).amax(1)
    assert (w.abs() == 0.5 * bmax.repeat_interleave(block, 0)).any()
    jlin = JLin(kind="qk256", k=lin.k, n=lin.n, packed=jnp.asarray(lin.packed.numpy()),
                scales=jnp.asarray(lin.scales.numpy()))
    _same_linear(quantize_linear_tl(lin, block), jq(jlin, block))


@pytest.mark.parametrize("variant", ["tl1", "tl2"])
def test_requant_of_float_weights_is_bit_identical(mini_gguf_f32, variant):
    """The F32 mini model's dense linears (K = 64 / 128: TL2 shrinks its
    block to 64 where 128 does not divide K, as the reference does)."""
    from bitnet_tpu.models.loader import load_model as jload
    from bitnet_tpu.quant.tl import quantize_linear_tl as jq
    from bitnet_tpu_torch.quant.tl import TL1_BLOCK, TL2_BLOCK, tl_quantize_dense

    block = TL1_BLOCK if variant == "tl1" else TL2_BLOCK
    _c, jp, _m = jload(mini_gguf_f32.path, param_dtype=jnp.float32)
    for n in ("wq", "wk", "wo", "w_gate", "w_down"):
        jl = getattr(jp.blocks, n)
        w = np.asarray(jl.weight, np.float32)[0]       # layer 0, [K, N]
        got = tl_quantize_dense(torch.from_numpy(w.copy()), block)
        from bitnet_tpu.ops.linear import dense_linear

        _same_linear(got, jq(dense_linear(jnp.asarray(w)), block))


def test_repack_codes_torch_matches_numpy():
    from bitnet_tpu_torch.ops.linear import (fold_packed_words, repack_codes,
                                             repack_codes_torch)

    rng = np.random.default_rng(3)
    for k, n in ((256, 128), (320, 200)):
        codes = rng.integers(0, 4, (k, n), dtype=np.uint8)
        got = repack_codes_torch(torch.from_numpy(codes)).numpy()
        want = fold_packed_words(repack_codes(codes))
        np.testing.assert_array_equal(got[:, :n], want)
        assert got.shape[1] % 128 == 0 and not got[:, n:].any()


# --------------------------------------------------------------------------
# K10: the block-scale bf16 body (:1177) and its stacked twin (:555)
# --------------------------------------------------------------------------
# the card's decode form takes M <= MB rows, its GEMM more: on the CPU both
# are the plain version, held to the Pallas sites on each side of MB and of
# 16 (the most rows the decode form takes), for bitnet32 and TL, f32 and
# bf16 x, K == Kp and K < Kp
MB = tm.BLOCKSCALE_DECODE_MAX_M
K10_DECODE_ROWS = [(lut_bias, M, k, dtype) for M in sorted({1, 2, MB, MB + 1, 16, 17})
                   for lut_bias in (True, False) for k in (K, 224)
                   for dtype in ("f32", "bf16")]
K10_2D = [(True, 1, K, "f32"), (False, 1, K, "f32"), (True, 40, K, "bf16"),
          (False, 130, K, "f32"), (True, 3, 224, "f32"), (False, 2, K, "bf16")]


@pytest.mark.parametrize("lut_bias,M,k,dtype", K10_2D + [
    c for c in K10_DECODE_ROWS if c not in K10_2D])
def test_k10_plain_matches_pallas_2d(lut_bias, M, k, dtype):
    rng, words, s, _g = _stack(10 + M + k + lut_bias, k=k)
    kp = words.shape[1] * 16
    x = rng.standard_normal((M, k)).astype(np.float32)
    jdt, tdt = _dt(dtype)
    bm, bn, bkt = _pick_blocks(M, kp, N, "pallas")
    want = _ternary_matmul_2d(
        jnp.asarray(x, jdt), jnp.asarray(words[1]), jnp.asarray(s[1]),
        kind="bitnet32" if lut_bias else "tl", variant="pallas", k_dim=k,
        n_dim=N, bm=bm, bn=bn, bkt=bkt, interpret=True, out_dtype=jdt)
    got = tm.ternary_matmul_blockscale_bf16(
        1, torch.from_numpy(x).to(tdt), torch.from_numpy(words),
        torch.from_numpy(_pad_scales(s, kp)), k_dim=k, n_dim=N, lut_bias=lut_bias)
    assert got.dtype == tdt and got.shape == (M, N)
    _close(got, want, 1e-5 if dtype == "f32" else 8e-3)


K10_STACKED = [(True, 1, 384, "f32"), (False, 2, 384, "f32"), (True, 5, 384, "bf16")]


@pytest.mark.parametrize("lut_bias,M,k,dtype", [
    pytest.param(*c, id=f"{c[0]}-{c[1]}-{c[3]}") for c in K10_STACKED] + [
    pytest.param(*c, id=f"{c[0]}-{c[1]}-{c[2]}-{c[3]}") for c in K10_DECODE_ROWS])
def test_k10_plain_matches_pallas_stacked(lut_bias, M, k, dtype):
    rng, words, s, _g = _stack(20 + M + lut_bias + k, k=k)
    kp = words.shape[1] * 16
    x = rng.standard_normal((M, k)).astype(np.float32)
    jdt, tdt = _dt(dtype)
    want = ternary_matmul_stacked_tl(
        jnp.int32(1), jnp.asarray(x, jdt), jnp.asarray(words), jnp.asarray(s),
        k_dim=k, n_dim=N, lut_bias=lut_bias, interpret=True)
    got = tm.ternary_matmul_blockscale_bf16(
        1, torch.from_numpy(x).to(tdt), torch.from_numpy(words),
        torch.from_numpy(_pad_scales(s, kp)), k_dim=k, n_dim=N, lut_bias=lut_bias)
    assert got.dtype == tdt and got.shape == (M, N)
    _close(got, want, 1e-5 if dtype == "f32" else 8e-3)


def test_k10_padded_scale_never_meets_a_padded_row():
    """K ≠ Kp: the padded K rows hold code 0 (biased value 0), so even a
    nonzero scale in the padded rows leaves the output unchanged."""
    rng, words, s, _g = _stack(30, k=224)
    kp = words.shape[1] * 16
    w = words.copy()
    # rows 224..255 are plane 3 (bits 6-7 of each byte) of words 8..15
    w[:, 8:16, :] &= 0x3F3F3F3F
    sp = _pad_scales(s, kp)
    x = torch.from_numpy(rng.standard_normal((3, 224)).astype(np.float32))
    a = tm.ternary_matmul_blockscale_bf16(1, x, torch.from_numpy(w),
                                          torch.from_numpy(sp), 224, N, True)
    sp[:, -1, :] = 7.0
    b = tm.ternary_matmul_blockscale_bf16(1, x, torch.from_numpy(w),
                                          torch.from_numpy(sp), 224, N, True)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# K11 (W2A8, :960) and K12 (bf16 fused, :733)
# --------------------------------------------------------------------------
CASES = [("none", False, False, False), ("norm", True, False, False),
         ("glu_resid", True, True, True)]


def _fused_case(fn, jfn, seed, M, lut_bias, norm, glu, resid, dtype):
    rng, words, s, gamma = _stack(seed)
    x = rng.standard_normal((M, 2 * K if glu else K)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)
    jdt, tdt = _dt(dtype)
    want = jfn(jnp.int32(1), jnp.asarray(x, jdt), jnp.asarray(words), jnp.asarray(s),
               jnp.asarray(gamma) if norm else None, k_dim=K, n_dim=N, eps=1e-5,
               glu=glu, resid=jnp.asarray(r, jdt) if resid else None,
               lut_bias=lut_bias, interpret=True)
    got = fn(1, torch.from_numpy(x).to(tdt), torch.from_numpy(words),
             torch.from_numpy(s), torch.from_numpy(gamma) if norm else None,
             k_dim=K, n_dim=N, eps=1e-5, glu=glu,
             resid=torch.from_numpy(r).to(tdt) if resid else None, lut_bias=lut_bias)
    assert got.dtype == tdt and got.shape == (M, N)
    return got, want


@pytest.mark.parametrize("lut_bias", [False, True])
@pytest.mark.parametrize("case,norm,glu,resid", CASES)
@pytest.mark.parametrize("M", [1, 2])
def test_k11_plain_matches_pallas(M, case, norm, glu, resid, lut_bias):
    got, want = _fused_case(tm.ternary_matmul_tl_w2a8_normed,
                            ternary_matmul_stacked_tl_w2a8,
                            40 + M + 2 * norm + 4 * glu + 8 * lut_bias, M,
                            lut_bias, norm, glu, resid, "f32")
    _close(got, want, 1e-4)


@pytest.mark.parametrize("lut_bias", [False, True])
@pytest.mark.parametrize("M", [1, 2])
def test_k11_plain_matches_pallas_at_k14336(M, lut_bias):
    """The 8B down projection's K = 14336 (SwiGLU, the residual, no
    sub-norm), which K11's kernel takes in one launch: the plain version
    against the Pallas kernel within the same 1e-4 of max|ref|."""
    k, n = 14336, 128
    rng, words, s, _gamma = _stack(90 + M + 2 * lut_bias, k=k, n=n)
    x = rng.standard_normal((M, 2 * k)).astype(np.float32)
    r = rng.standard_normal((M, n)).astype(np.float32)
    want = ternary_matmul_stacked_tl_w2a8(
        jnp.int32(1), jnp.asarray(x), jnp.asarray(words), jnp.asarray(s), None,
        k_dim=k, n_dim=n, eps=1e-5, glu=True, resid=jnp.asarray(r),
        lut_bias=lut_bias, interpret=True)
    got = tm.ternary_matmul_tl_w2a8_normed(
        1, torch.from_numpy(x), torch.from_numpy(words), torch.from_numpy(s), None,
        k_dim=k, n_dim=n, eps=1e-5, glu=True, resid=torch.from_numpy(r),
        lut_bias=lut_bias)
    assert got.dtype == torch.float32 and got.shape == (M, n)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("lut_bias", [False, True])
def test_k11_int8_rows_and_block_partials_exact(lut_bias):
    """From the same f32 rows: the JAX kernel's int8 rows (``:819-822``),
    and per 32-row block ``Σ q·v − 2·Σ q`` against int64 numpy."""
    rng, words, _s, _g = _stack(50 + lut_bias)
    xf = rng.standard_normal((2, K)).astype(np.float32) * 3.0
    xq, sx, _sq = tm.quantize_rows(torch.from_numpy(xf))
    jx = jnp.asarray(xf)
    jsx = jnp.maximum(jnp.max(jnp.abs(jx), axis=1, keepdims=True), 1e-8) / 127.0
    jq = np.asarray(jnp.clip(jnp.round(jx / jsx), -127.0, 127.0)).astype(np.int64)
    np.testing.assert_array_equal(xq.numpy(), jq)
    codes = unpack_words_host(words[0], K).astype(np.int64)
    v = codes + (codes >> 1) if lut_bias else codes
    qb = jq.reshape(2, K // 32, 32)
    want = (np.einsum("mbk,bkn->bmn", qb, v.reshape(K // 32, 32, N))
            - 2 * qb.sum(-1).T[..., None])
    got = tm.tl_block_partials(xq, torch.from_numpy(words[0]), lut_bias)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lut_bias", [False, True])
@pytest.mark.parametrize("case,norm,glu,resid", CASES)
@pytest.mark.parametrize("M", [3, 8])
def test_k12_plain_matches_pallas(M, case, norm, glu, resid, lut_bias):
    got, want = _fused_case(tm.ternary_matmul_tl_bf16_normed,
                            ternary_matmul_stacked_tl_fused,
                            60 + M + 2 * norm + 4 * glu + 8 * lut_bias, M,
                            lut_bias, norm, glu, resid, "f32")
    _close(got, want, 1e-4)


def test_k12_bf16_activations():
    """bf16 x and residual: the output rounds to bf16 (two ulps)."""
    got, want = _fused_case(tm.ternary_matmul_tl_bf16_normed,
                            ternary_matmul_stacked_tl_fused, 70, 5, True, True,
                            True, True, "bf16")
    _close(got, want, 8e-3)


def test_k10_and_k12_round_differently():
    """Trap: ``:1177`` rounds the *biased* scaled weight, ``:733`` the
    unbiased one.  At bf16 these are different functions, and each plain
    version follows its own site."""
    _rng, words, s, _g = _stack(80)
    w = torch.from_numpy(words[0])
    sc = torch.from_numpy(s[0])
    biased = tm.block_weights(w, sc, True, False).float()
    unbiased = tm.block_weights(w, sc, True, True).float()
    s32 = torch.repeat_interleave(sc, 32, dim=0)
    assert not torch.equal(biased - 2 * s32, unbiased)


@pytest.mark.parametrize("which", ["k11", "k12"])
def test_fused_tl_wrappers_refuse_what_the_kernels_do_not_take(which):
    from bitnet_tpu_torch.errors import KernelError

    fn = (tm.ternary_matmul_tl_w2a8_normed if which == "k11"
          else tm.ternary_matmul_tl_bf16_normed)
    _rng, words, s, _g = _stack(0)
    w, sc = torch.from_numpy(words), torch.from_numpy(s)
    too_many = tm.TL_W2A8_MAX_M + 1 if which == "k11" else tm.STACKED_DECODE_MAX_M + 1
    with pytest.raises(KernelError):                  # past the row cap
        fn(0, torch.zeros(too_many, K), w, sc, None, K, N)
    with pytest.raises(KernelError):                  # K != Kp
        fn(0, torch.zeros(1, K - 32), w, sc, None, K - 32, N)
    with pytest.raises(ValueError):                   # scales of the wrong shape
        fn(0, torch.zeros(1, K), w, sc[:, :-1].contiguous(), None, K, N)
    with pytest.raises(ValueError):                   # neither a CPU nor a CUDA tensor
        fn(0, torch.zeros(1, K, device="meta"), w, sc, None, K, N)


# --------------------------------------------------------------------------
# the stacked decode's choice of K11 or K12 (``models/bitnet._stacked_mm``)
# --------------------------------------------------------------------------
def _tl_layer(kind, rng, k_down, n=64):
    """A stacked TL / bitnet32 layer whose four projections read rows of 256
    values but the down projection's, of ``k_down``."""
    from bitnet_tpu_torch.models.bitnet import BlockParams
    from bitnet_tpu_torch.ops.linear import TernaryLinear

    def lin(k):
        w = rng.integers(-2**31, 2**31 - 1, (L, k // 16, n), dtype=np.int32)
        s = rng.uniform(0.01, 0.03, (L, k // 32, n)).astype(np.float32)
        return TernaryLinear(kind, k, n, torch.from_numpy(w), torch.from_numpy(s))
    short = lin(256)
    return BlockParams(attn_norm=None, wq=None, wk=None, wv=None, wo=short,
                       ffn_norm=None, w_gate=None, w_up=None, w_down=lin(k_down),
                       wqkv=short, w_gateup=short)


@pytest.mark.parametrize("kind", ["tl", "bitnet32"])
@pytest.mark.parametrize("B,k_down,want", [
    (1, 14336, "w2a8"), (2, 14336, "w2a8"), (1, 14592, "bf16"), (2, 23040, "bf16"),
    (3, 14336, "bf16")])
def test_stacked_decode_takes_k11_only_where_its_kernel_reaches(monkeypatch, kind, B,
                                                               k_down, want):
    """B <= 2 decodes a layer on K11 while every row is at most
    W2A8_DECODE_MAX_K values (the longest K11's kernel takes); a layer with
    a longer row (the down projection here), like a pool, decodes on K12,
    all four projections alike.  Each call is that wrapper's, with its
    result."""
    from bitnet_tpu_torch.models import bitnet as bm

    for knob in ("BITNET_TL_W2A8", "BITNET_TL_FUSED"):
        monkeypatch.delenv(knob, raising=False)
    rng = np.random.default_rng(B + k_down)
    blk = _tl_layer(kind, rng, k_down)
    calls = []
    for name in ("w2a8", "bf16"):
        real = getattr(bm, f"ternary_matmul_tl_{name}_normed")
        monkeypatch.setattr(bm, f"ternary_matmul_tl_{name}_normed",
                            lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    mm = bm._stacked_mm(blk, B, 1e-5)
    lut_bias = kind == "bitnet32"
    plain = (tm.ternary_matmul_tl_w2a8_normed_plain if want == "w2a8"
             else tm.ternary_matmul_tl_bf16_normed_plain)
    x = torch.from_numpy(rng.standard_normal((B, 2 * k_down)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((B, 64)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, (L, k_down)).astype(np.float32))
    got = mm(1, x, "w_down", gamma, glu=True, resid=r)
    d = blk.w_down
    assert torch.equal(got, plain(x, d.packed[1], d.scales[1], gamma[1], 1e-5, True, r,
                                  64, lut_bias))
    mm(0, x[:, :256].contiguous(), "wo", None)
    assert calls == [want, want]


@pytest.mark.parametrize("lut_bias", [False, True])
def test_stacked_decode_past_k11s_rows_matches_pallas(monkeypatch, lut_bias):
    """A B = 1 layer whose down projection reads 14592 values (past
    W2A8_DECODE_MAX_K) decodes on K12: against the JAX package's K12 site
    (``ternary_matmul_stacked_tl_fused``, interpret mode), SwiGLU, the
    sub-norm and the residual, within the module's 1e-4 of max|ref|."""
    from bitnet_tpu_torch.models import bitnet as bm

    monkeypatch.delenv("BITNET_TL_W2A8", raising=False)
    monkeypatch.delenv("BITNET_TL_FUSED", raising=False)
    k, n = 14592, 64
    rng = np.random.default_rng(95 + lut_bias)
    blk = _tl_layer("bitnet32" if lut_bias else "tl", rng, k, n)
    x = rng.standard_normal((1, 2 * k)).astype(np.float32)
    r = rng.standard_normal((1, n)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, (L, k)).astype(np.float32)
    d = blk.w_down
    want = ternary_matmul_stacked_tl_fused(
        jnp.int32(1), jnp.asarray(x), jnp.asarray(d.packed.numpy()),
        jnp.asarray(d.scales.numpy()), jnp.asarray(gamma), k_dim=k, n_dim=n, eps=1e-5,
        glu=True, resid=jnp.asarray(r), lut_bias=lut_bias, interpret=True)
    got = bm._stacked_mm(blk, 1, 1e-5)(1, torch.from_numpy(x), "w_down",
                                       torch.from_numpy(gamma), glu=True,
                                       resid=torch.from_numpy(r))
    assert got.dtype == torch.float32 and got.shape == (1, n)
    _close(got, want, 1e-4)
