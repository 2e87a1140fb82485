"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA sm_90 card and nvcc (the kernels have no CPU mode);
elsewhere they skip.  On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (the suite's conftest imports JAX, which the
card's machine need not have; this file imports none).  chip_smoke.py runs the same checks at the
main path's full shapes.
"""

import pytest
import torch

from bitnet_tpu_torch.ops import decode_attention_v2 as da
from bitnet_tpu_torch.ops import ternary_matmul as tm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA sm_90 card: the CUDA kernels have no CPU mode")
    from bitnet_tpu_torch.device_probe import require_sm90

    require_sm90(0)
    return torch.device("cuda", 0)


def _words(g, L, K, N, dev):
    return (torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev),
            (torch.rand((L, N), generator=g, device=dev) + 0.5) * 0.02)


@pytest.mark.parametrize("M,glu,resid", [(1, False, False), (2, True, False),
                                         (3, True, True), (4, False, True),
                                         (5, True, True), (64, False, True)])
def test_k1_matches_plain(dev, M, glu, resid):
    g = torch.Generator(device=dev).manual_seed(M)
    K, N = 512, 384
    w, sv = _words(g, 2, K, N, dev)
    gamma = torch.rand((2, K), generator=g, device=dev) + 0.5
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
    r = torch.randn((M, N), generator=g, device=dev).bfloat16() if resid else None
    out = tm.ternary_matmul_w2a8_normed(1, x, w, sv, gamma, K, N, 1e-5, glu, r)
    out2, xq, sx, sumq = tm._w2a8_normed_cuda(1, x, w, sv, gamma, K, N, 1e-5, glu, r)
    assert torch.equal(out, out2)
    # rows are independent: row 0 of the batch equals the batch of row 0
    one = tm.ternary_matmul_w2a8_normed(1, x[:1], w, sv, gamma, K, N, 1e-5, glu,
                                        None if r is None else r[:1])
    assert torch.equal(one[0], out[0])
    acc = tm.int8_matmul(xq, tm.biased_codes(w[1]))
    assert torch.equal(tm.w2a8_epilogue(acc, sumq, sx, sv[1], r, x.dtype), out)
    plain = tm.ternary_matmul_w2a8_normed_plain(x, w[1], sv[1], gamma[1], 1e-5,
                                                glu, r, N)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * ref + 1e-3


@pytest.mark.parametrize("M", [7, 100, 300])
def test_k4_matches_plain_exactly(dev, M):
    g = torch.Generator(device=dev).manual_seed(M)
    K, N = 768, 640
    w, sv = _words(g, 2, K, N, dev)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    out = tm.ternary_matmul_w2a8(1, x, w, sv, K, N)
    xq, sx, sumq = tm.quantize_rows(x.float())
    assert torch.equal(out, tm.ternary_matmul_w2a8_plain(xq, sumq, sx, w[1], sv[1],
                                                         N, x.dtype))


@pytest.mark.parametrize("pos", [[0], [1], [200], [255, 17]])
def test_k2_matches_plain(dev, pos):
    g = torch.Generator(device=dev).manual_seed(sum(pos))
    B, H, KV, D, S = len(pos), 20, 5, 128, 256
    qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev).bfloat16()
    ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
    kc = torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16()
    vc = torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    a, kr, vr = da.decode_attention_qkv(1, qkv, ang.sin(), ang.cos(), kc, vc, p, H, KV)
    pa, pk, pv = da.decode_attention_qkv_plain(qkv, ang.sin(), ang.cos(), kc[1],
                                               vc[1], p, H, KV)
    assert torch.equal(kr, pk) and torch.equal(vr, pv)
    ref = pa.float().abs().max()
    assert (a.float() - pa.float()).abs().max() <= 1e-2 * ref + 2e-3


def test_k3_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    L, B, S, KVD = 3, 2, 64, 640
    kc = torch.randn((L, B, S, KVD), generator=g, device=dev).bfloat16()
    vc = torch.randn((L, B, S, KVD), generator=g, device=dev).bfloat16()
    kr = torch.randn((L, B, 1, KVD), generator=g, device=dev).bfloat16()
    vr = torch.randn((L, B, 1, KVD), generator=g, device=dev).bfloat16()
    pos = torch.tensor([5, S + 3], dtype=torch.int32, device=dev)
    k2, v2 = kc.clone(), vc.clone()
    da.scatter_kv_rows(kc, vc, kr, vr, pos)
    da.scatter_kv_rows_plain(k2, v2, kr, vr, pos)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


def test_engine_two_slots_cuda_matches_cpu(dev):
    """The whole decode path on the card with B=2 (slot 1 idles at position
    S, writing row S-1) against the plain versions on the CPU, teacher-forced
    with the card's tokens: every step's logits keep cosine >= 0.99, and
    the greedy tokens agree wherever the CPU's top-2 margin exceeds the
    largest logit difference.  K2 rounds its softmax weights to bf16
    against other maxima than the plain version, and W2A8 requantization
    amplifies that, so a near-tie may go either way (at step 3 of this
    seed the CPU's margin is 0.005 against a difference of 0.038:
    ``python -m bitnet_tpu_torch.tools.parity_probe``)."""
    from bitnet_tpu_torch.config import EngineConfig, ModelConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import build_synthetic

    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=768,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                      max_seq_len=256)
    params = build_synthetic(cfg, seed=3, device="cpu")
    ec = EngineConfig(max_seq_len=256, max_batch_size=2, compute_dtype="f32",
                      logits_dtype="int8")
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    prompt = list(range(7, 47))
    lg, lc = eg.prefill(prompt), ecpu.prefill(prompt)
    for pos in range(len(prompt), len(prompt) + 6):
        a, b = lg[0].float().cpu(), lc[0].float()
        assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.99
        tok = int(lg[0].argmax())
        top2 = torch.topk(b, 2).values
        assert tok == int(b.argmax()) or top2[0] - top2[1] <= (a - b).abs().max()
        lg, lc = eg.decode_step(tok, pos), ecpu.decode_step(tok, pos)
