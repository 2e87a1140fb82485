"""Slice 6: the fused W2A8 FFN (K24) and the sub-norm-free model.

- ``_pick_bf`` and ``ffn_fused_supported`` are the JAX package's.
- K24's plain version against ``ffn_w2a8_fused(..., interpret=True)`` on
  seeded numpy inputs, at n_f = 2 and n_f = 4, M ∈ {1, 4, 32}, x in f32
  and bf16, scalar and per-column down scales: the int8 codes of x equal
  the JAX wrapper's, the outputs agree within 1e-2 of their largest
  magnitude.  Why not exactly: torch's CPU sigmoid differs from XLA's
  logistic by one f32 ulp on ~0.4 % of inputs, and an activation that sits
  at a rounding boundary of its tile's int8 requantization then takes the
  neighbouring code, which moves that row's outputs by 2·sa·sd at most (a
  few bf16 ulps); elsewhere they agree to f32 rounding.
- A narrow sub-norm-free model with the 8B's 4:1 grouped-query heads,
  fused, at B = 1 and 3 (and B = 1 with K24 in its prefill): greedy tokens
  equal to the JAX engine's at f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bitnet_tpu.ops.ffn_fused as jffn
from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.gguf.fixtures import MiniModelSpec, generate_mini_gguf
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models import bitnet as bm
from bitnet_tpu_torch.ops import ffn_fused as pf

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


class _Lin:
    """The two attributes ``ffn_fused_supported`` reads."""

    def __init__(self, rows, kind="qk256"):
        self.kind = kind
        self.packed = np.zeros((rows, 128), np.int32)


@pytest.mark.parametrize("M", [1, 32, 33])
def test_pick_bf_and_supported_match_jax(M):
    for F in range(256, 14336 + 1, 128):
        assert pf._pick_bf(F) == jffn._pick_bf(F), F
        for rows in (F // 16, F // 16 + 16):
            gu, down = _Lin(16), _Lin(rows)
            assert (pf.ffn_fused_supported(gu, down, F, M)
                    == jffn.ffn_fused_supported(gu, down, F, M)), (F, rows, M)
    assert pf._pick_bf(14336) == 3584 and pf._pick_bf(512) == 256
    assert not pf.ffn_fused_supported(_Lin(16, "tl"), _Lin(32), 512, 1)


def _inputs(seed, M, K, F, H, col):
    rng = np.random.default_rng(seed)
    gu = rng.integers(-2**31, 2**31, (K // 16, 2 * F), dtype=np.int64).astype(np.int32)
    dw = rng.integers(-2**31, 2**31, (F // 16, H), dtype=np.int64).astype(np.int32)
    sg = (rng.random(2 * F) * 0.02 + 0.01).astype(np.float32)
    sd = (rng.random(H) * 0.02 + 0.01).astype(np.float32) if col else np.float32(0.02)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, gu, dw, sg, sd


@pytest.mark.parametrize("dtype,col", [("f32", False), ("bf16", True)])
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,F,H", [(256, 512, 256), (256, 1024, 256)])
def test_plain_matches_pallas_interpret(K, F, H, M, dtype, col):
    x, gu, dw, sg, sd = _inputs(M * 7 + F, M, K, F, H, col)
    assert F // pf._pick_bf(F) == {512: 2, 1024: 4}[F]
    xj = jnp.asarray(x) if dtype == "f32" else jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jffn.ffn_w2a8_fused(
        xj, jnp.asarray(gu), jnp.asarray(sg)[None], jnp.asarray(dw),
        jnp.asarray(sd) if col else jnp.float32(sd), k_dim=K, f_dim=F, n_dim=H,
        interpret=True).astype(jnp.float32))
    # the JAX wrapper's int8 codes of x (``ffn_fused.py:126-131``)
    xf = xj.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-8) / 127.0
    xq_want = np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8))

    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    sdt = torch.from_numpy(sd) if col else torch.full((H,), float(sd))
    gut, dwt, sgt = torch.from_numpy(gu), torch.from_numpy(dw), torch.from_numpy(sg)
    got = pf.ffn_w2a8_fused(0, xt, gut[None], sgt[None], dwt[None], sdt[None], F, H)
    y, xq, *_ = pf.ffn_w2a8_fused_plain(xt, gut, sgt, dwt, sdt, F, H, parts=True)
    assert got.dtype == xt.dtype and tuple(got.shape) == (M, H)
    assert torch.equal(got, y)
    np.testing.assert_array_equal(xq.numpy(), xq_want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("M", [1, 9])
def test_plain_matches_pallas_interpret_unpadded_x(M):
    """x of K = 200 columns against Kp = 256 rows of words: both sides
    quantize the row zero-padded to Kp (the kernel writes those zeros
    itself, reading x unpadded)."""
    K, Kp, F, H = 200, 256, 512, 256
    x, gu, dw, sg, sd = _inputs(M + 500, M, Kp, F, H, True)
    x = x[:, :K].copy()
    want = np.asarray(jffn.ffn_w2a8_fused(
        jnp.asarray(x), jnp.asarray(gu), jnp.asarray(sg)[None], jnp.asarray(dw),
        jnp.asarray(sd), k_dim=K, f_dim=F, n_dim=H, interpret=True))
    got = pf.ffn_w2a8_fused(0, torch.from_numpy(x), torch.from_numpy(gu)[None],
                            torch.from_numpy(sg)[None], torch.from_numpy(dw)[None],
                            torch.from_numpy(sd)[None], F, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("M,Kp,F,Hp,sms,want", [
    (32, 4096, 14336, 4096, 132, (32, 1, 4)),    # the 8B FFN: 224 and 32x4 blocks
    (1, 4096, 14336, 4096, 132, (8, 1, 4)),
    (9, 4096, 14336, 4096, 132, (16, 1, 4)),
    (17, 2560, 6912, 2560, 132, (32, 1, 8)),     # bf = 768: n_f = 9 on 8 ranks
    (17, 512, 2304, 512, 132, (32, 1, 8)),       # bf = 256: n_f = 9
    (3, 512, 512, 320, 132, (8, 1, 2)),          # n_f = 2, one K tile a tile
    (5, 2048, 2048, 640, 132, (8, 4, 4)),        # 32 gate|up blocks split 4
    (2, 8192, 512, 512, 132, (8, 8, 2)),
    (1, 512, 768, 256, 132, (8, 1, 2)),          # n_f = 3: two ranks, 1 + 2 tiles
    (1, 4096, 4096, 1024, 132, (8, 2, 8))])      # n_f = 4 of 4 K tiles: two ranks a tile
def test_ffn_plan_table(M, Kp, F, Hp, sms, want):
    assert pf.ffn_plan(M, Kp, F, Hp, sms) == want


@pytest.mark.parametrize("M", [1, 8, 9, 32])
def test_ffn_plan_forms_are_ones_the_kernel_takes(M):
    """Over every F the fused path takes, the plan's BT holds M, the gate|up
    split leaves each rank two K tiles, and the down cluster is a power of
    two of at most 8 ranks that either hold whole tiles or split each tile
    over the same number of ranks, at least one K tile each."""
    for F in range(256, 16384 + 1, 256):
        bf = pf._pick_bf(F)
        nf, nb = F // bf, bf // 256
        for Kp, Hp in ((512, 320), (4096, 4096)):
            bt, split, dsplit = pf.ffn_plan(M, Kp, F, Hp, 132)
            assert bt in pf.FFN_GEMM_ROWS and bt >= M and (bt == 8 or bt // 2 < M)
            assert split in (1, 2, 4, 8) and (split == 1 or 2 * split <= Kp // 256)
            assert dsplit in (1, 2, 4, 8)
            assert dsplit <= nf or (dsplit % nf == 0 and dsplit // nf <= nb), (F, dsplit)
            assert dsplit == min(8, 1 << (nf.bit_length() - 1)) or dsplit > nf
            offs, total = pf._scratch_layout(M, Kp, F, nf)
            assert all(o % 128 == 0 for o in offs) and total >= offs[-1] + 4 * M * nf


@pytest.fixture(scope="module")
def gqa_gguf(tmp_path_factory):
    """A narrow sub-norm-free QK256 model with the 8B's 4:1 grouped-query
    heads (8 of 64 over 2 KV heads) and F = 1024 (n_f = 4)."""
    path = tmp_path_factory.mktemp("models") / "mini_gqa4.gguf"
    return generate_mini_gguf(str(path), MiniModelSpec(
        hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=2,
        quant="qk256", seed=3))


GQA_PROMPTS = [[1, 5, 9, 14, 200, 77, 3], [1, 33, 250, 7], [1, 9, 250, 7, 80, 12]]


@pytest.mark.parametrize("B,env", [(1, {}), (3, {}),
                                   (1, {"BITNET_FUSED_FFN": "1",
                                        "BITNET_STACKED_PREFILL": "0"})])
def test_gqa4_model_matches_jax(gqa_gguf, monkeypatch, B, env):
    for k in ("BITNET_FUSED_FFN", "BITNET_STACKED_PREFILL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(kernel_path="w2a8", max_seq_len=32, compute_dtype="f32",
              fuse_projections=True, max_batch_size=B)
    je = JEngine.from_gguf(gqa_gguf.path, JEngineConfig(**kw))
    pe = InferenceEngine.from_gguf(gqa_gguf.path, EngineConfig(**kw), device="cpu")
    assert pe.stacked_decode() and pe.cfg.num_heads == 4 * pe.cfg.num_kv_heads
    calls = []
    real = bm.ffn_w2a8_fused
    monkeypatch.setattr(bm, "ffn_w2a8_fused",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    gc = dict(max_new_tokens=6, greedy=True)
    if B == 1:
        want = [je.generate(GQA_PROMPTS[0], JGenerationConfig(**gc)).token_ids]
        got = [pe.generate(GQA_PROMPTS[0], GenerationConfig(**gc)).token_ids]
    else:
        want = [r.token_ids for r in je.generate_batch(GQA_PROMPTS,
                                                       JGenerationConfig(**gc))]
        got = [r.token_ids for r in pe.generate_batch(GQA_PROMPTS, GenerationConfig(**gc))]
    assert got == want
    # K24 once a layer in the prefill (8 rows), never in a decode step
    assert calls == ([0, 1] if env else [])
