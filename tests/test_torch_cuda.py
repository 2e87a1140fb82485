"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA sm_90 card and nvcc (the kernels have no CPU mode);
elsewhere they skip.  On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (the suite's conftest imports JAX, which the
card's machine need not have; this file imports none).  chip_smoke.py runs the same checks at the
main path's full shapes.
"""

import pytest
import torch

from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da
from bitnet_tpu_torch.ops import ffn_fused as ff
from bitnet_tpu_torch.ops import ternary_matmul as tm
from bitnet_tpu_torch.ops import w2a8_probes as wp

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


def _k1_case(g, M, K, N, gamma, resid, glu, dtype, dev, L=2):
    w, sv = _words(g, L, K, N, dev)
    gm = (torch.rand((L, K), generator=g, device=dev) + 0.5) if gamma else None
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).to(dtype)
    r = torch.randn((M, N), generator=g, device=dev).to(dtype) if resid else None
    return w, sv, gm, x, r


def _k1_gates(out, xq, sx, sumq, x, w, sv, gm, r, K, N, glu, l=1):
    """K1's gates (chip_smoke.py check_k1): the dot and epilogue of the
    kernel's own int8 rows give its output bit for bit, the row sums are
    the rows', the rows at most one step off the plain version's in at most
    max(2, 0.1 %) entries, the output within 2e-2 of the max plus 1e-3."""
    g_l = None if gm is None else gm[l]
    assert torch.equal(sumq, xq.int().sum(1, dtype=torch.int32))
    acc = tm.int8_matmul(xq, tm.biased_codes(w[l]))
    assert torch.equal(tm.w2a8_epilogue(acc, sumq, sx, sv[l], r, x.dtype), out)
    xq_p = tm.quantize_rows(tm.w2a8_preamble_plain(x, g_l, 1e-5, glu))[0]
    qd = (xq.int() - xq_p.int()).abs()
    assert int(qd.max()) <= 1 and int((qd > 0).sum()) <= max(2, xq.numel() // 1000)
    plain = tm.ternary_matmul_w2a8_normed_plain(x, w[l], sv[l], g_l, 1e-5, glu, r, N)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * ref + 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,glu", [(2560, False), (6912, True), (14336, True)])
@pytest.mark.parametrize("M", [1, 2, 3, 8, 16, 33, 64])
def test_k1_both_forms_match_plain(dev, M, K, glu, dtype):
    """K1 at every row count of both forms (one launch at M <= 2; the row
    kernel and the GEMM with the residual above), at the main path's K
    (14336: the 8B down projection, one launch at M <= 2), with and
    without gamma and the residual, bf16 and f32: its gates, and the
    wrapper's output equal to the launch's."""
    for gamma, resid in ((True, True), (False, False)):
        g = torch.Generator(device=dev).manual_seed(M * 7 + K + gamma)
        N = 640
        w, sv, gm, x, r = _k1_case(g, M, K, N, gamma, resid, glu, dtype, dev)
        out = tm.ternary_matmul_w2a8_normed(1, x, w, sv, gm, K, N, 1e-5, glu, r)
        out2, xq, sx, sumq = tm._w2a8_normed_cuda(1, x, w, sv, gm, K, N, 1e-5, glu, r)
        assert torch.equal(out, out2)
        _k1_gates(out, xq, sx, sumq, x, w, sv, gm, r, K, N, glu)


@pytest.mark.parametrize("cols", [32, 64, 128])
@pytest.mark.parametrize("M", [1, 2])
def test_k1_every_decode_plan_matches(dev, monkeypatch, M, cols):
    """Every column block w2a8_decode_plan can return, forced past the plan,
    gives the planned call's bits (the partials are exact int32), within
    K1's gates; K = 2560 (ten K tiles: the last stage of 32 columns holds
    two of its four), N = 640 (20, 10 or 5 column blocks), bf16 with gamma
    and the residual."""
    g = torch.Generator(device=dev).manual_seed(cols + M)
    K, N = 2560, 640
    w, sv, gm, x, r = _k1_case(g, M, K, N, True, True, False, torch.bfloat16, dev)
    want = tm.ternary_matmul_w2a8_normed(1, x, w, sv, gm, K, N, 1e-5, False, r)
    monkeypatch.setattr(tm, "w2a8_decode_plan", lambda *a: cols)
    out, xq, sx, sumq = tm._w2a8_normed_cuda(1, x, w, sv, gm, K, N, 1e-5, False, r)
    assert torch.equal(out, want)
    _k1_gates(out, xq, sx, sumq, x, w, sv, gm, r, K, N, False)


@pytest.mark.parametrize("M", [1, 2, 8])
def test_k1_repeats_and_graph_replays_bit_for_bit(dev, M):
    """Three calls, and ten calls replayed in one CUDA graph, give the same
    bits (the 8B down projection's K at M <= 2, a pool of 8 on the GEMM)."""
    g = torch.Generator(device=dev).manual_seed(40 + M)
    K, N = (14336, 512) if M <= 2 else (2560, 640)
    w, sv, gm, x, r = _k1_case(g, M, K, N, M == 8, True, True, torch.bfloat16, dev)
    call = lambda: tm.ternary_matmul_w2a8_normed(1, x, w, sv, gm, K, N, 1e-5, True, r)
    first = call()
    assert all(torch.equal(first, call()) for _ in range(2))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.parametrize("M", [1, 2, 8])
def test_k1_dependent_chain_matches_synced_chain(dev, M):
    """Sixteen calls, each taking the last one's output as x and as the
    residual, nothing kept of the earlier ones (so the allocator hands a
    call the buffers its predecessors read), launched back to back without a
    sync, give the bits of the same chain synced after every call: no launch
    reads x or resid, or writes anything, before the launch before it has
    ended."""
    g = torch.Generator(device=dev).manual_seed(50 + M)
    K = N = 2560
    L = 4
    w, sv = _words(g, L, K, N, dev)
    sv.mul_(0.05)                                     # keep the chain's scale
    gm = torch.rand((L, K), generator=g, device=dev) + 0.5
    x0 = torch.randn((M, K), generator=g, device=dev).bfloat16()

    def chain(sync):
        x = x0.clone()
        torch.cuda.synchronize()
        for i in range(16):
            x = tm.ternary_matmul_w2a8_normed(i % L, x, w, sv, gm, K, N, 1e-5, False, x)
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return x
    want = chain(True)
    assert torch.isfinite(want.float()).all()
    for _ in range(3):
        assert torch.equal(chain(False), want)


@pytest.mark.parametrize("M", [1, 2, 8, 64])
def test_k1_runs_one_kernel_at_decode_rows_two_above(dev, M):
    """A K1 call at M <= 2 is one launch of the decode kernel; above, the row
    kernel and the GEMM; no ATen op but the allocations."""
    K, N = 2560, 640
    setup = (f"w, _s = words({K}, {N})\n"
             f"sv = torch.rand((2, {N}), generator=g, device=dev) * 0.02 + 0.01\n"
             f"gamma = torch.rand((2, {K}), generator=g, device=dev) + 0.5\n"
             f"x = torch.randn(({M}, {K}), generator=g, device=dev).bfloat16()\n"
             f"r = torch.randn(({M}, {N}), generator=g, device=dev).bfloat16()")
    call = f"tm.ternary_matmul_w2a8_normed(1, x, w, sv, gamma, {K}, {N}, 1e-5, False, r)"
    # a trace with no kernel at all is the card's tracer losing the trace
    # (seen before on this card; the call still counted its launch): profile
    # again, up to twice more
    for _ in range(3):
        kernels, ops = _profiled_call(setup, call, "ternary_matmul_w2a8_normed")
        if kernels:
            break
    if M <= 2:
        assert len(kernels) == 1 and "w2a8_decode" in kernels[0], kernels
    else:
        assert len(kernels) == 2, kernels
        assert sorted("quantize_rows" in k for k in kernels) == [False, True], kernels
        assert all("quantize_rows" in k or "w2a8_gemm" in k for k in kernels), kernels
    assert ops <= {"aten::empty"}, ops


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


@pytest.mark.parametrize("N", [640, 2560, 13824])
@pytest.mark.parametrize("K", [2560, 6912])
@pytest.mark.parametrize("M", [8, 32, 77, 128, 500, 2048])
def test_k4_main_path_shapes_match_plain(dev, M, K, N):
    """K4 at the tile and split the wrapper's plan picks for the main path's
    shapes: the int8 rows, scales and sums equal ``quantize_rows``', and the
    output is bit for bit the plain version's."""
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    w, sv = _words(g, 2, K, N, dev)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    out, xq, sx, sumq = tm._w2a8_gemm_cuda(1, x, w, sv, K, N)
    xq_p, sx_p, sumq_p = tm.quantize_rows(x.float())
    assert torch.equal(xq, xq_p) and torch.equal(sx, sx_p) and torch.equal(sumq, sumq_p)
    assert torch.equal(out, tm.ternary_matmul_w2a8_plain(xq_p, sumq_p, sx_p, w[1],
                                                         sv[1], N, x.dtype))
    assert torch.equal(out, tm.ternary_matmul_w2a8(1, x, w, sv, K, N))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("bt", [8, 16, 32, 64, 128])
def test_k4_every_tile_and_split_matches_plain(dev, monkeypatch, bt, split):
    """Every form of K4 (rows a block x K split), forced past the plan:
    ragged M (a row past one tile), N = 192 (a block whose second column
    half lies past Np), f32 x, and a strided x."""
    monkeypatch.setattr(tm, "w2a8_gemm_plan", lambda *a: (bt, split))
    g = torch.Generator(device=dev).manual_seed(bt * 10 + split)
    K, N, M = 2048, 192, bt + 1
    w, sv = _words(g, 2, K, N, dev)
    x = torch.randn((M, K + 64), generator=g, device=dev)[:, :K]
    out, xq, sx, sumq = tm._w2a8_gemm_cuda(1, x, w, sv, K, N)
    xq_p, sx_p, sumq_p = tm.quantize_rows(x.float())
    assert torch.equal(xq, xq_p) and torch.equal(sx, sx_p) and torch.equal(sumq, sumq_p)
    assert torch.equal(out, tm.ternary_matmul_w2a8_plain(xq_p, sumq_p, sx_p, w[1],
                                                         sv[1], N, x.dtype))


def test_k4_runs_two_kernels_and_no_pytorch_op(dev):
    """A K4 call is the row quantization and the GEMM: the profiler sees two
    kernels, and no ATen op but the allocations; two calls give the same
    bits (K split over a cluster at N = 640)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    g = torch.Generator(device=dev).manual_seed(4)
    K, N = 2560, 640
    w, sv = _words(g, 2, K, N, dev)
    x = torch.randn((512, K), generator=g, device=dev).bfloat16()
    first = tm.ternary_matmul_w2a8(1, x, w, sv, K, N)          # build, warm up
    torch.cuda.synchronize()
    # one call in the profiler's warm-up step: the tracer now and then lost
    # the first kernel of a session
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            before = tm.ternary_matmul_w2a8.launches
            again = tm.ternary_matmul_w2a8(1, x, w, sv, K, N)
            torch.cuda.synchronize()
            prof.step()
    assert tm.ternary_matmul_w2a8.launches == before + 1
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]          # the step's span
    ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
    assert len(kernels) == 2, kernels
    assert sorted("quantize_rows" in k for k in kernels) == [False, True], kernels
    assert all("quantize_rows" in k or "w2a8_gemm" in k for k in kernels), kernels
    assert ops <= {"aten::empty"}, ops
    assert torch.equal(first, again)


# One profiled call in a fresh process: a process that had run the other
# card tests of this file caught no kernel in the profiler (alone, and in
# chip_smoke.py, the same calls show theirs).  The child builds its
# operands from a seed, makes one call to build and warm up, then profiles
# one call after one in the profiler's warm-up step (the tracer now and then
# lost the first kernel of a session), and prints the kernels, the ATen ops
# and the launch count of the profiled call.
_PROFILE_CHILD = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da
from bitnet_tpu_torch.ops import ffn_fused as ff
from bitnet_tpu_torch.ops import ternary_matmul as tm
from bitnet_tpu_torch.ops import w2a8_probes as wp
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
def words(K, N):
    return (torch.randint(-2**31, 2**31, (2, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev),
            (torch.rand((2, K // 32, N), generator=g, device=dev) * 0.02 + 0.01))
{setup}
call = lambda: {call}
call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
    for step in range(2):
        before = {module}.{counter}.launches
        call()
        torch.cuda.synchronize()
        prof.step()
print(json.dumps({{
    "kernels": [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("ProfilerStep")],
    "ops": sorted({{e.name for e in prof.events() if e.name.startswith("aten::")}}),
    "launches": {module}.{counter}.launches - before}}))
"""


def _profiled_call(setup, call, counter, module="tm"):
    import json
    import subprocess
    import sys
    from pathlib import Path

    code = _PROFILE_CHILD.format(setup=setup, call=call, counter=counter, module=module)
    # a counted launch with no kernel in the trace: the tracer lost the
    # device's events (it does now and then); profile again, at most twice
    for _ in range(3):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=600, cwd=Path(__file__).resolve().parent.parent)
        assert r.returncode == 0, r.stderr[-3000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["launches"] == 1, out
        if out["kernels"]:
            break
    return out["kernels"], set(out["ops"])


def test_k10_decode_form_runs_no_pytorch_op(dev):
    """At M=1 the wrapper launches K10's decode form and nothing else: the
    profiler sees one kernel, and no ATen op but the output's allocation."""
    kernels, ops = _profiled_call(
        "w, s = words(2560, 640)\nx = torch.randn((1, 2560), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_blockscale_bf16(1, x, w, s, 2560, 640, True)",
        "ternary_matmul_blockscale_bf16")
    assert len(kernels) == 1 and "blockscale_decode" in kernels[0], kernels
    assert ops <= {"aten::empty"}, ops


def test_k10_gemm_form_runs_two_kernels_and_no_pytorch_op(dev):
    """Past MB rows a K10 call is the row kernel and the GEMM: the profiler
    sees two kernels, and no ATen op but the allocations."""
    kernels, ops = _profiled_call(
        "w, s = words(2560, 640)\nx = torch.randn((512, 2560), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_blockscale_bf16(1, x, w, s, 2560, 640, False)",
        "ternary_matmul_blockscale_bf16")
    assert len(kernels) == 2, kernels
    assert sorted("blockscale_rows" in k for k in kernels) == [False, True], kernels
    assert all("blockscale_rows" in k or "blockscale_gemm" in k for k in kernels), kernels
    assert ops <= {"aten::empty"}, ops


def test_k12_runs_two_kernels_and_no_pytorch_op(dev):
    """A K12 call is the preamble and the GEMM: two kernels, no ATen op but
    the allocations."""
    kernels, ops = _profiled_call(
        "w, s = words(2560, 640)\n"
        "gamma = torch.rand((2, 2560), generator=g, device=dev) + 0.5\n"
        "x = torch.randn((8, 2560), generator=g, device=dev).bfloat16()\n"
        "r = torch.randn((8, 640), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_tl_bf16_normed(1, x, w, s, gamma, 2560, 640, 1e-5, False, r)",
        "ternary_matmul_tl_bf16_normed")
    assert len(kernels) == 2, kernels
    assert sorted("bf16_rows" in k for k in kernels) == [False, True], kernels
    assert all("bf16_rows" in k or "blockscale_gemm" in k for k in kernels), kernels
    assert ops <= {"aten::empty"}, ops


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
                      logits_dtype="int8", kernel_path="w2a8",
                      fuse_projections=True)
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


@pytest.mark.parametrize("pos", [[0], [1], [200], [255, 17]])
def test_k5_matches_plain(dev, pos):
    """K5 rounds its bf16 softmax weights against the running max of its
    split's 64-row stages, the plain version (as the TPU kernel) against
    chunk maxima."""
    g = torch.Generator(device=dev).manual_seed(7 + sum(pos))
    B, H, KV, D, S = len(pos), 20, 5, 128, 256
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    kn = torch.randn((B, KV, D), generator=g, device=dev).bfloat16()
    vn = torch.randn((B, KV, D), generator=g, device=dev).bfloat16()
    kc = torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16()
    vc = torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = dk.decode_attention.launches
    a = dk.decode_attention(1, q, kn, vn, kc, vc, p)
    assert dk.decode_attention.launches == before + 1
    pa = dk.decode_attention_plain(q, kn, vn, kc[1], vc[1], p)
    ref = pa.float().abs().max()
    assert (a.float() - pa.float()).abs().max() <= 1e-2 * ref + 2e-3


@pytest.mark.parametrize("M,dtype", [(1, torch.bfloat16), (2, torch.float32),
                                     (100, torch.bfloat16)])
def test_k6_matches_plain(dev, M, dtype):
    """K6's f32 sums run in another order than the plain matmul's: one
    bf16 ulp (2^-8 relative) of the largest output, twice."""
    g = torch.Generator(device=dev).manual_seed(M)
    K, N = 768, 640
    w, sv = _words(g, 2, K, N, dev)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    out = tm.ternary_matmul_bf16(1, x, w, sv, K, N)
    xb = x.bfloat16()
    plain = tm.ternary_matmul_bf16_plain(xb, xb.float().sum(1), w[1], sv[1], N, dtype)
    assert out.dtype == dtype
    assert (out.float() - plain.float()).abs().max() <= 8e-3 * plain.float().abs().max()


MB6 = tm.BF16_DECODE_MAX_M


def _k6_check(out, x, w, sv, k, N, rows=None):
    """K6's output against its plain version: 1e-4 of the largest output
    with f32 x (the correction cancels: acc reaches ~4·K·|x|, and the f32
    sums run in another order), 8e-3 (two bf16 ulps) with bf16 x.  With the
    GEMM form's row-kernel outputs ``rows`` = (xb or None, sumx): its bf16
    rows are the plain row kernel's bit for bit, its row sums within the f32
    bound of two summation orders (2·Kp·2^-24·Σ|x| a row)."""
    Kp = w.shape[1] * 16
    xb, sumx = tm.colscale_rows_plain(x, Kp)
    plain = tm.ternary_matmul_bf16_plain(xb, sumx, w[1], sv[1], N, x.dtype)
    assert out.dtype == x.dtype and out.shape == plain.shape
    rel = 8e-3 if x.dtype == torch.bfloat16 else 1e-4
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= rel * ref
    if rows is not None:
        xb_k, sum_k = rows
        assert xb_k is None or torch.equal(xb_k, xb)
        bound = 2 * Kp * 2.0**-24 * xb.float().abs().sum(1)
        assert ((sum_k - sumx).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 2, MB6, MB6 + 1, 17, 64, 65, 130])
@pytest.mark.parametrize("k,N", [(1952, 192), (2560, 640), (200, 640)])
def test_k6_forms_match_plain(dev, k, N, M, dtype):
    """Both of K6's forms past the MB rule: the decode form at every M it
    takes (≤ 16), the GEMM form at every M (bf16 rows TMA can read taken as
    they are, other rows copied), K < Kp, a ragged column block (N = 192),
    layer 1; the wrapper's output is the form it takes, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(M + k + N)
    Kp = -(-k // 256) * 256
    w, sv = _words(g, 2, Kp, N, dev)
    x = torch.randn((M, k), generator=g, device=dev).to(dtype)
    out = tm.ternary_matmul_bf16(1, x, w, sv, k, N)
    gem, xb_k, sum_k = tm._bf16_gemm_cuda(1, x, w, sv, k, N)
    _k6_check(gem, x, w, sv, k, N, (xb_k, sum_k))
    assert (xb_k is None) == (dtype == torch.bfloat16 and k % 8 == 0)
    if M <= 16:
        dec = tm._bf16_decode_cuda(1, x, w, sv, k, N)
        _k6_check(dec, x, w, sv, k, N)
    assert torch.equal(out, dec if M <= MB6 else gem)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("bt", [8, 16, 32, 64, 128])
def test_k6_gemm_every_tile_and_split_matches_plain(dev, monkeypatch, bt, split):
    """Every tile and K split of K6's GEMM form, forced past the plan: ragged
    M (a row past one tile), K < Kp, N = 192 (a block whose second column
    half lies past Np) with f32 x in strided rows (copied), N = 640 with
    bf16 x (read by TMA as it is)."""
    monkeypatch.setattr(tm, "blockscale_gemm_plan", lambda *a: (bt, split))
    g = torch.Generator(device=dev).manual_seed(bt * 10 + split)
    Kp, k, M = 2048, 1952, bt + 1
    for N, dtype in ((192, torch.float32), (640, torch.bfloat16)):
        w, sv = _words(g, 2, Kp, N, dev)
        x = torch.randn((M, k + 64), generator=g, device=dev).to(dtype)
        x = x[:, :k] if dtype == torch.float32 else x[:, :k].contiguous()
        out, xb_k, sum_k = tm._bf16_gemm_cuda(1, x, w, sv, k, N)
        assert (xb_k is None) == (dtype == torch.bfloat16)
        _k6_check(out, x, w, sv, k, N, (xb_k, sum_k))


def test_k6_repeats_bit_for_bit(dev):
    """Two identical calls give the same bits: the split-K partials and the
    row sums are added in a fixed order (N = 640 splits K over a cluster of
    8 in the decode form, and over 8 blocks at M = 77 in the GEMM form)."""
    g = torch.Generator(device=dev).manual_seed(6)
    w, sv = _words(g, 2, 2560, 640, dev)
    assert tm.blockscale_gemm_plan(77, 2560, 640, 132)[1] == 8
    for M in (1, MB6, 77):
        x = torch.randn((M, 2560), generator=g, device=dev)
        a = tm.ternary_matmul_bf16(1, x, w, sv, 2560, 640)
        assert torch.equal(a, tm.ternary_matmul_bf16(1, x, w, sv, 2560, 640))


def test_k6_never_falls_back(dev, monkeypatch):
    """On a CUDA tensor K6 launches a form (counted) at decode and prefill
    rows, and never calls its plain versions."""
    for name in ("ternary_matmul_bf16_plain", "colscale_rows_plain"):
        monkeypatch.setattr(tm, name, None)
    g = torch.Generator(device=dev).manual_seed(0)
    w, sv = _words(g, 1, 512, 128, dev)
    before = tm.ternary_matmul_bf16.launches
    for M in (1, 77):
        tm.ternary_matmul_bf16(0, torch.randn((M, 500), generator=g, device=dev), w, sv,
                               500, 128)
    assert tm.ternary_matmul_bf16.launches == before + 2


def test_k6_decode_form_runs_one_kernel_and_no_pytorch_op(dev):
    """At M=1 a K6 call is its decode form alone: one kernel, no ATen op but
    the output's allocation."""
    kernels, ops = _profiled_call(
        "w, _s = words(2560, 640)\ns = torch.rand((2, 640), generator=g, device=dev)\n"
        "x = torch.randn((1, 2560), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_bf16(1, x, w, s, 2560, 640)", "ternary_matmul_bf16")
    assert len(kernels) == 1 and "blockscale_decode" in kernels[0], kernels
    assert ops <= {"aten::empty"}, ops


def test_k6_gemm_form_runs_two_kernels_and_no_pytorch_op(dev):
    """Past MB rows a K6 call is the row kernel and the GEMM: two kernels, no
    ATen op but the allocations."""
    kernels, ops = _profiled_call(
        "w, _s = words(2560, 640)\ns = torch.rand((2, 640), generator=g, device=dev)\n"
        "x = torch.randn((512, 2560), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_bf16(1, x, w, s, 2560, 640)", "ternary_matmul_bf16")
    assert len(kernels) == 2, kernels
    assert sorted("colscale_rows" in k for k in kernels) == [False, True], kernels
    assert all("colscale_rows" in k or "blockscale_gemm" in k for k in kernels), kernels
    assert ops <= {"aten::empty"}, ops


@pytest.mark.parametrize("kp", ["w2a8", "pallas"])
def test_generic_engine_cuda_matches_cpu(dev, kp):
    """The unfused generic path (K1/K4 or K6, K5) on the card against the
    plain versions on the CPU, teacher-forced with the card's tokens; the
    bf16 tied head on the card is one bf16 GEMM with f32 output."""
    from bitnet_tpu_torch.config import EngineConfig, ModelConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import build_synthetic

    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=768,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                      max_seq_len=256)
    params = build_synthetic(cfg, seed=3, device="cpu")
    ec = EngineConfig(max_seq_len=256, kernel_path=kp)
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    assert eg.params.blocks.wqkv is None
    prompt = list(range(7, 90))
    lg, lc = eg.prefill(prompt), ecpu.prefill(prompt)
    assert lg.dtype == torch.float32
    for pos in range(len(prompt), len(prompt) + 6):
        a, b = lg[0].float().cpu(), lc[0].float()
        assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.99
        tok = int(lg[0].argmax())
        top2 = torch.topk(b, 2).values
        assert tok == int(b.argmax()) or top2[0] - top2[1] <= (a - b).abs().max()
        lg, lc = eg.decode_step(tok, pos), ecpu.decode_step(tok, pos)


def _codes(g, shape, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    return (torch.randn(shape, generator=g, device=dev) * 64).to(dtype)


def _same(a, b):
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


QDT = [torch.int8, torch.float8_e4m3fn]


@pytest.mark.parametrize("dtype", QDT)
@pytest.mark.parametrize("pos", [[0], [200], [255, 17]])
def test_k7_matches_plain(dev, dtype, pos):
    """K7's new rows (codes and scales) are bit-exact; its output is held
    as K2's."""
    g = torch.Generator(device=dev).manual_seed(11 + sum(pos))
    B, H, KV, D, S = len(pos), 20, 5, 128, 256
    qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev).bfloat16()
    ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
    kc, vc = (_codes(g, (2, B, S, KV * D), dtype, dev) for _ in range(2))
    ks, vs = (torch.rand((2, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
              for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = da.decode_attention_qkv_quant(1, qkv, ang.sin(), ang.cos(), kc, vc, ks, vs,
                                        p, H, KV)
    pl = da.decode_attention_qkv_quant_plain(qkv, ang.sin(), ang.cos(), kc[1], vc[1],
                                             ks[1], vs[1], p, H, KV)
    assert all(_same(a, b) for a, b in zip(out[1:], pl[1:]))
    ref = pl[0].float().abs().max()
    assert (out[0].float() - pl[0].float()).abs().max() <= 1e-2 * ref + 2e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16] + QDT)
@pytest.mark.parametrize("B", [3, 18])
def test_k8_k9_match_plain(dev, dtype, B):
    """K8 (bf16) / K9 (int8, fp8) over a pool with mixed lengths and an
    idle slot, held as K5; the idle slot's output is the new token's v."""
    g = torch.Generator(device=dev).manual_seed(B)
    H, KV, D, S = 20, 5, 128, 256
    quant = dtype != torch.bfloat16
    kc, vc = ((_codes(g, (2, B, S, KV * D), dtype, dev) if quant else
               torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16())
              for _ in range(2))
    ks, vs = (torch.rand((2, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
              for _ in range(2))
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    kn, vn = (torch.randn((B, KV, D), generator=g, device=dev).bfloat16()
              for _ in range(2))
    p = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    p[1] = 0
    if quant:
        before = da.decode_attention_quant_batched.launches
        a = da.decode_attention_quant_batched(1, q, kn, vn, kc, vc, ks, vs, p)
        pa = da.decode_attention_quant_batched_plain(q, kn, vn, kc[1], vc[1], ks[1],
                                                     vs[1], p)
        assert da.decode_attention_quant_batched.launches == before + 1
    else:
        a = da.decode_attention_batched(1, q, kn, vn, kc, vc, p)
        pa = da.decode_attention_batched_plain(q, kn, vn, kc[1], vc[1], p)
    ref = pa.float().abs().max()
    assert (a.float() - pa.float()).abs().max() <= 1e-2 * ref + 2e-3
    assert torch.equal(a[1].view(KV, H // KV, D), vn[1][:, None].expand(KV, H // KV, D))


@pytest.mark.parametrize("dtype", QDT)
def test_k3_quantized_rows_match_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    L, B, S, KV, D = 3, 4, 64, 5, 128
    kc, vc, kr, vr = (_codes(g, (L, B, n, KV * D), dtype, dev)
                      for n in (S, S, 1, 1))
    ks, vs, ksr, vsr = (torch.rand((L, B, n, KV), generator=g, device=dev)
                        for n in (S, S, 1, 1))
    pos = torch.tensor([5, S - 1, S + 3, 0], dtype=torch.int32, device=dev)
    ref = [t.clone() for t in (kc, vc, ks, vs)]
    da.scatter_kv_rows(kc, vc, kr, vr, pos, ks, vs, ksr, vsr)
    da.scatter_kv_rows_plain(*ref[:2], kr, vr, pos, *ref[2:], ksr, vsr)
    assert all(_same(a, b) for a, b in zip((kc, vc, ks, vs), ref))


@pytest.mark.parametrize("B,kv", [(1, "int8"), (2, "fp8"), (8, "bf16"), (8, "auto"),
                                  (17, "int8")])
def test_pool_engine_cuda_matches_cpu(dev, B, kv):
    """The fused path over pools and quantized caches on the card against
    the plain versions on the CPU, teacher-forced with the card's tokens;
    gates as in test_engine_two_slots_cuda_matches_cpu."""
    import numpy as np

    from bitnet_tpu_torch.config import EngineConfig, ModelConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import build_synthetic

    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=768,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                      max_seq_len=256)
    params = build_synthetic(cfg, seed=3, device="cpu")
    ec = EngineConfig(max_seq_len=256, max_batch_size=B, kv_cache_dtype=kv,
                      compute_dtype="f32", logits_dtype="int8", kernel_path="w2a8",
                      fuse_projections=True)
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    prompts = [list(range(7 + i, 30 + 3 * i)) for i in range(B)]
    lg, lc = eg.prefill_batch(prompts), ecpu.prefill_batch(prompts)
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(5):
        a, b = lg.float().cpu(), lc.float()
        assert (torch.nn.functional.cosine_similarity(a, b, dim=1) >= 0.99).all()
        tok = a.argmax(1)
        top2 = torch.topk(b, 2, dim=1).values
        assert ((tok == b.argmax(1))
                | (top2[:, 0] - top2[:, 1] <= (a - b).abs().amax(1))).all()
        lg, lc = eg.decode_batch_step(tok.to(dev), pos), ecpu.decode_batch_step(tok, pos)
        pos = pos + 1


# --------------------------------------------------------------------------
# K10-K12: per-32-row block scales (bitnet32 / TL weights)
# --------------------------------------------------------------------------
def _block_words(g, L, K, N, dev, k_live=None):
    """Words [L, K/16, N] and f32 block scales [L, K/32, N] (rows past
    ``k_live`` zero, as the loader pads them)."""
    w = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                      generator=g, device=dev)
    s = ((torch.rand((L, K // 32, N), generator=g, device=dev) * 0.02 + 0.01)
         .half().float())
    if k_live is not None:
        s[:, k_live // 32:] = 0
    return w, s


MB = tm.BLOCKSCALE_DECODE_MAX_M


@pytest.mark.parametrize("M,k,lut_bias,dtype", [
    (1, 512, True, torch.bfloat16), (2, 512, False, torch.float32),
    (37, 512, True, torch.float32), (200, 768, False, torch.bfloat16),
    (3, 224, True, torch.bfloat16), (MB, 512, False, torch.bfloat16),
    (MB + 1, 224, True, torch.float32), (MB, 224, False, torch.float32),
    (2, 224, True, torch.bfloat16), (1, 14336, True, torch.float32),
    (2, 14336, False, torch.bfloat16), (MB, 14336, True, torch.bfloat16),
    (MB + 1, 14336, False, torch.float32)])
def test_k10_matches_plain(dev, M, k, lut_bias, dtype):
    """bf16 rows × biased scaled weights, f32 sums (another order), minus
    the same correction: two bf16 ulps of the largest output.  M ≤ MB
    takes the decode form (the correction inside), more rows the GEMM."""
    g = torch.Generator(device=dev).manual_seed(M + k)
    Kp, N = -(-k // 256) * 256, 384
    w, s = _block_words(g, 2, Kp, N, dev, k_live=k)
    x = torch.randn((M, k), generator=g, device=dev).to(dtype)
    out = tm.ternary_matmul_blockscale_bf16(1, x, w, s, k, N, lut_bias)
    xb = torch.nn.functional.pad(x.bfloat16(), (0, Kp - k))
    corr = 2.0 * torch.matmul(xb.float().view(M, Kp // 32, 32).sum(-1), s[1])
    plain = tm.ternary_matmul_blockscale_bf16_plain(xb, corr, w[1], s[1], N,
                                                    lut_bias, dtype)
    assert out.dtype == dtype and out.shape == (M, N)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 8e-3 * ref + 1e-6


# K10's GEMM form at the main path's shapes: the 2B fused four, the generic
# seven's other two, the 8B four, and K = 6784 < Kp (the tl (d) down)
K10_GEMM_SHAPES = [(2560, 3840), (2560, 2560), (2560, 13824), (6912, 2560),
                   (2560, 640), (2560, 6912), (4096, 6144), (4096, 4096),
                   (4096, 28672), (14336, 4096), (6784, 2560)]


def _k10_gemm_check(out, xb_k, sum_k, split_k, x, w, s, k, N, lut_bias):
    """The GEMM form's bf16 rows equal the plain row kernel's bit for bit,
    its 32-row sums agree within the f32 bound of two summation orders
    (2·31·2^-24·Σ|x| a block) and their bf16 split is theirs bit for bit,
    and its output the plain K10's: two bf16
    ulps of the largest output with bf16 x; with f32 x 1e-4 of it (wgmma
    accumulates without IEEE rounding: its addends are aligned and
    truncated, as mma.sync's were)."""
    Kp = w.shape[1] * 16
    xb, sum32 = tm.blockscale_rows_plain(x, Kp)
    assert torch.equal(xb_k, xb)
    abs32 = xb.float().abs().view(x.shape[0], -1, 32).sum(-1)
    assert ((sum_k - sum32).abs() <= 2 * 31 * 2.0**-24 * abs32).all()
    assert torch.equal(split_k, tm.blockscale_sums_split(sum_k))
    plain = tm.ternary_matmul_blockscale_bf16_plain(
        xb, tm.blockscale_correction(sum32, s[1]), w[1], s[1], N, lut_bias, x.dtype)
    assert out.dtype == x.dtype and out.shape == plain.shape
    ref = plain.float().abs().max()
    rel = 8e-3 if x.dtype == torch.bfloat16 else 1e-4
    assert (out.float() - plain.float()).abs().max() <= rel * ref


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [17, 64, 77, 512, 2048])
@pytest.mark.parametrize("k,N", K10_GEMM_SHAPES)
def test_k10_gemm_main_path_shapes_match_plain(dev, k, N, M, dtype):
    """K10's GEMM form at the tile and split the wrapper's plan picks; lut_bias
    alternates with M; the wrapper's output is the form's bit for bit."""
    lut_bias = M in (17, 77, 2048)
    g = torch.Generator(device=dev).manual_seed(M + k + N)
    Kp = -(-k // 256) * 256
    w, s = _block_words(g, 2, Kp, N, dev, k_live=k)
    x = torch.randn((M, k), generator=g, device=dev).to(dtype)
    out, xb_k, sum_k, split_k = tm._blockscale_gemm_cuda(1, x, w, s, k, N, lut_bias)
    _k10_gemm_check(out, xb_k, sum_k, split_k, x, w, s, k, N, lut_bias)
    assert torch.equal(out, tm.ternary_matmul_blockscale_bf16(1, x, w, s, k, N, lut_bias))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("bt", [8, 16, 32, 64, 128])
def test_k10_gemm_every_tile_and_split_matches_plain(dev, monkeypatch, bt, split):
    """Every form of the block-scale GEMM, forced past the plan, for K10:
    ragged M (a row past one tile), N = 192 (a block whose second column
    half lies past Np), K < Kp, f32 x with strided rows; and for K12 at the
    same tile and split, with SwiGLU, norm and the residual."""
    monkeypatch.setattr(tm, "blockscale_gemm_plan", lambda *a: (bt, split))
    g = torch.Generator(device=dev).manual_seed(bt * 10 + split)
    Kp, k, N, M = 2048, 1952, 192, bt + 1
    w, s = _block_words(g, 2, Kp, N, dev, k_live=k)
    x = torch.randn((M, k + 64), generator=g, device=dev)[:, :k]
    out, xb_k, sum_k, split_k = tm._blockscale_gemm_cuda(1, x, w, s, k, N,
                                                         bool(split & 1))
    _k10_gemm_check(out, xb_k, sum_k, split_k, x, w, s, k, N, bool(split & 1))
    w, s = _block_words(g, 2, Kp, N, dev)
    gamma = torch.rand((2, Kp), generator=g, device=dev) + 0.5
    x = torch.randn((M, 2 * Kp), generator=g, device=dev).bfloat16()
    r = torch.randn((M, N), generator=g, device=dev).bfloat16()
    out = tm._tl_bf16_launch(1, x, w, s, gamma, Kp, N, 1e-5, True, r, False)
    plain = tm.ternary_matmul_tl_bf16_normed_plain(x, w[1], s[1], gamma[1], 1e-5, True,
                                                   r, N, False)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 1e-2 * ref + 1e-3


@pytest.mark.parametrize("glu,gamma,resid", [(False, False, False), (True, True, True),
                                             (False, True, False), (True, False, True)])
@pytest.mark.parametrize("M", [1, 2, 3, 8, 16, 33, 64])
def test_k12_pool_rows_match_plain(dev, M, glu, gamma, resid):
    """K12 at every pool size the stacked loop gives it, with and without
    SwiGLU, the norm and the residual (a bf16 row value one ulp off plus two
    ulps of output rounding: 1e-2 of the largest output plus 1e-3)."""
    g = torch.Generator(device=dev).manual_seed(30 + M)
    K, N = 2560, 640
    w, s = _block_words(g, 2, K, N, dev)
    gm = torch.rand((2, K), generator=g, device=dev) + 0.5 if gamma else None
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
    r = torch.randn((M, N), generator=g, device=dev).bfloat16() if resid else None
    lut_bias = M % 2 == 1
    out = tm.ternary_matmul_tl_bf16_normed(1, x, w, s, gm, K, N, 1e-5, glu, r, lut_bias)
    plain = tm.ternary_matmul_tl_bf16_normed_plain(x, w[1], s[1], None if gm is None
                                                   else gm[1], 1e-5, glu, r, N, lut_bias)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 1e-2 * ref + 1e-3


def test_k10_gemm_and_k12_repeat_bit_for_bit(dev):
    """Two identical calls give the same bits: the split-K partials are added
    in rank order (K10 at M = 77 on N = 640 splits K over 8 blocks, K12 at
    M = 8 on N = 2560 over 4)."""
    g = torch.Generator(device=dev).manual_seed(7)
    w, s = _block_words(g, 2, 2560, 640, dev)
    x = torch.randn((77, 2560), generator=g, device=dev)
    assert tm.blockscale_gemm_plan(77, 2560, 640, 132)[1] == 8
    a = tm.ternary_matmul_blockscale_bf16(1, x, w, s, 2560, 640, True)
    assert torch.equal(a, tm.ternary_matmul_blockscale_bf16(1, x, w, s, 2560, 640, True))
    w, s = _block_words(g, 2, 2560, 2560, dev)
    x = torch.randn((8, 2560), generator=g, device=dev).bfloat16()
    a = tm.ternary_matmul_tl_bf16_normed(1, x, w, s, None, 2560, 2560)
    assert torch.equal(a, tm.ternary_matmul_tl_bf16_normed(1, x, w, s, None, 2560, 2560))


@pytest.mark.parametrize("M,glu,resid,lut_bias", [(1, False, False, False),
                                                  (2, True, True, True),
                                                  (1, True, False, True)])
def test_k11_matches_plain(dev, M, glu, resid, lut_bias):
    """K11's int8 rows are K1's bit for bit on the same input; its output
    equals the exact block partials of its own rows to f32 rounding, and
    the plain version as K1's gate does."""
    g = torch.Generator(device=dev).manual_seed(10 + M)
    K, N = 512, 384
    w, s = _block_words(g, 2, K, N, dev)
    gamma = torch.rand((2, K), generator=g, device=dev) + 0.5
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
    r = torch.randn((M, N), generator=g, device=dev).bfloat16() if resid else None
    out = tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gamma, K, N, 1e-5, glu, r,
                                           lut_bias)
    out2, xq, sx, sumq = tm._tl_w2a8_cuda(1, x, w, s, gamma, K, N, 1e-5, glu, r,
                                          lut_bias)
    assert torch.equal(out, out2)
    sv = torch.ones((2, N), device=dev)
    _o, xq1, sx1, sumq1 = tm._w2a8_normed_cuda(1, x, w, sv, gamma, K, N, 1e-5, glu,
                                               None)
    assert torch.equal(xq, xq1) and torch.equal(sx, sx1) and torch.equal(sumq, sumq1)
    part = tm.tl_block_partials(xq, w[1], lut_bias).float()
    y = (part * s[1][:, None, :]).sum(0) * sx[:, None]
    if r is not None:
        y = y + r.float()
    # the bf16 output is y rounded once: within half an ulp, plus f32 order
    assert ((out.float() - y).abs() <= 2**-8 * y.abs() + 1e-6).all()
    plain = tm.ternary_matmul_tl_w2a8_normed_plain(x, w[1], s[1], gamma[1], 1e-5,
                                                   glu, r, N, lut_bias)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * ref + 1e-3


def _k11_gates(out, x, w, s, gm, r, K, N, glu, lut_bias, l=1, atol=1e-5):
    """K11's gates (chip_smoke.py check_k11_k12 / check_k11_wide): the
    wrapper's output is the launch's bit for bit; its int8 rows, scales and
    sums are K1's on the same input bit for bit; its output is the exact
    block partials of its own rows to f32 rounding (``atol``: the f32 sums'
    order where outputs cancel to near zero, as at K = 14336); and it is
    within K1's gate of the plain version."""
    out2, xq, sx, sumq = tm._tl_w2a8_cuda(l, x, w, s, gm, K, N, 1e-5, glu, r, lut_bias)
    assert torch.equal(out, out2)
    sv = torch.ones((w.shape[0], N), device=x.device)
    _o, xq1, sx1, sumq1 = tm._w2a8_normed_cuda(l, x, w, sv, gm, K, N, 1e-5, glu, None)
    assert torch.equal(xq, xq1) and torch.equal(sx, sx1) and torch.equal(sumq, sumq1)
    part = tm.tl_block_partials(xq, w[l], lut_bias).float()
    y = (part * s[l][:, None, :]).sum(0) * sx[:, None]
    if r is not None:
        y = y + r.float()
    assert ((out.float() - y).abs() <= 2**-8 * y.abs() + atol).all()
    g_l = None if gm is None else gm[l]
    plain = tm.ternary_matmul_tl_w2a8_normed_plain(x, w[l], s[l], g_l, 1e-5, glu, r, N,
                                                   lut_bias)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * ref + 1e-3


def _k11_case(g, M, K, N, gamma, resid, glu, dtype, dev, L=2):
    w, s = _block_words(g, L, K, N, dev)
    gm = (torch.rand((L, K), generator=g, device=dev) + 0.5) if gamma else None
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).to(dtype)
    r = torch.randn((M, N), generator=g, device=dev).to(dtype) if resid else None
    return w, s, gm, x, r


@pytest.mark.parametrize("lut_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,glu", [(2560, False), (6912, True), (14336, True)])
@pytest.mark.parametrize("M", [1, 2])
def test_k11_matches_plain_at_every_k(dev, M, K, glu, dtype, lut_bias):
    """K11, one launch at M <= 2 and the main path's K (2560; 6912 with
    SwiGLU; 14336, the 8B down projection), with and without gamma and the
    residual, bf16 and f32, TL and bitnet32 codes: its gates."""
    for gamma, resid in ((True, True), (False, False)):
        g = torch.Generator(device=dev).manual_seed(M * 7 + K + gamma + 2 * lut_bias)
        N = 640
        w, s, gm, x, r = _k11_case(g, M, K, N, gamma, resid, glu, dtype, dev)
        out = tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gm, K, N, 1e-5, glu, r,
                                               lut_bias)
        assert out.dtype == dtype and out.shape == (M, N)
        _k11_gates(out, x, w, s, gm, r, K, N, glu, lut_bias)


@pytest.mark.parametrize("cols", [32, 64, 128])
@pytest.mark.parametrize("M", [1, 2])
def test_k11_every_decode_plan_matches(dev, monkeypatch, M, cols):
    """Every column block w2a8_decode_plan can return for K11, forced past
    the plan, within K11's gates: K = 2560 (ten K tiles: at 32 columns three
    stages, the last holding two tiles, so warps 0-7 take two and warps 8-15
    one), N = 640 (20, 10 or 5 column blocks), bf16 with gamma and the
    residual, TL codes at 64 columns and bitnet32's elsewhere."""
    g = torch.Generator(device=dev).manual_seed(cols + M)
    K, N = 2560, 640
    w, s, gm, x, r = _k11_case(g, M, K, N, True, True, False, torch.bfloat16, dev)
    monkeypatch.setattr(tm, "w2a8_decode_plan", lambda *a: cols)
    out = tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gm, K, N, 1e-5, False, r,
                                           cols != 64)
    _k11_gates(out, x, w, s, gm, r, K, N, False, cols != 64)


@pytest.mark.parametrize("K", [2560, 14336])
@pytest.mark.parametrize("M", [1, 2])
def test_k11_repeats_and_graph_replays_bit_for_bit(dev, M, K):
    """Three calls, and ten calls replayed in one CUDA graph, give the same
    bits: the warps' f32 partials meet in a fixed order."""
    g = torch.Generator(device=dev).manual_seed(60 + M + K)
    N = 512
    glu = K == 14336
    w, s, gm, x, r = _k11_case(g, M, K, N, not glu, True, glu, torch.bfloat16, dev)
    call = lambda: tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gm, K, N, 1e-5, glu, r,
                                                    True)
    first = call()
    assert all(torch.equal(first, call()) for _ in range(2))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(10)]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs)


@pytest.mark.parametrize("M", [1, 2])
def test_k11_dependent_chain_matches_synced_chain(dev, M):
    """Sixteen K11 calls, each taking the last one's output as x and as the
    residual, nothing kept of the earlier ones, launched back to back
    without a sync, give the bits of the same chain synced after every call:
    no launch reads x or resid, or writes anything, before the launch
    before it has ended."""
    g = torch.Generator(device=dev).manual_seed(70 + M)
    K = N = 2560
    L = 4
    w, s = _block_words(g, L, K, N, dev)
    s.mul_(0.05)                                      # keep the chain's scale
    gm = torch.rand((L, K), generator=g, device=dev) + 0.5
    x0 = torch.randn((M, K), generator=g, device=dev).bfloat16()

    def chain(sync):
        x = x0.clone()
        torch.cuda.synchronize()
        for i in range(16):
            x = tm.ternary_matmul_tl_w2a8_normed(i % L, x, w, s, gm, K, N, 1e-5, False, x,
                                                 i % 2 == 0)
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return x
    want = chain(True)
    assert torch.isfinite(want.float()).all()
    for _ in range(3):
        assert torch.equal(chain(False), want)


@pytest.mark.parametrize("K,glu", [(2560, False), (6912, True), (14336, True)])
@pytest.mark.parametrize("M", [1, 2])
def test_k11_runs_one_kernel_at_every_k(dev, M, K, glu):
    """A K11 call at M <= 2 is one launch of K1's decode kernel (its
    block-scale mode) at every K up to 14336, and no ATen op but the
    allocations."""
    N = 640
    setup = (f"w, s = words({K}, {N})\n"
             f"gamma = torch.rand((2, {K}), generator=g, device=dev) + 0.5\n"
             f"x = torch.randn(({M}, {2 * K if glu else K}), generator=g, device=dev)"
             f".bfloat16()\n"
             f"r = torch.randn(({M}, {N}), generator=g, device=dev).bfloat16()")
    call = (f"tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gamma, {K}, {N}, 1e-5, "
            f"{glu}, r)")
    kernels, ops = _profiled_call(setup, call, "ternary_matmul_tl_w2a8_normed")
    assert len(kernels) == 1 and "w2a8_decode" in kernels[0], kernels
    assert ops <= {"aten::empty"}, ops


def test_k11_refuses_k_past_the_kernels(dev):
    """Past W2A8_DECODE_MAX_K the wrapper refuses the call on the card (the
    entry point would refuse it too) rather than reading out of bounds."""
    from bitnet_tpu_torch.errors import KernelError

    g = torch.Generator(device=dev).manual_seed(3)
    K, N = tm.W2A8_DECODE_MAX_K + 256, 128
    w, s = _block_words(g, 1, K, N, dev)
    x = torch.randn((1, K), generator=g, device=dev).bfloat16()
    with pytest.raises(KernelError):
        tm.ternary_matmul_tl_w2a8_normed(0, x, w, s, None, K, N)


@pytest.mark.parametrize("K", [14592, 23040])
def test_stacked_decode_past_k11s_rows_matches_plain(dev, monkeypatch, K):
    """A B = 1 TL layer whose down projection reads more than
    W2A8_DECODE_MAX_K values (23040: Falcon3-7B's F) decodes on K12, not
    K11: SwiGLU, the sub-norm and the residual, against K12's plain version
    within K12's gate, one K12 call and no K11 call."""
    from bitnet_tpu_torch.models import bitnet as bm
    from bitnet_tpu_torch.models.bitnet import BlockParams
    from bitnet_tpu_torch.ops.linear import TernaryLinear

    monkeypatch.delenv("BITNET_TL_W2A8", raising=False)
    monkeypatch.delenv("BITNET_TL_FUSED", raising=False)
    g = torch.Generator(device=dev).manual_seed(K)
    H = 3072
    short = TernaryLinear("tl", H, H, *_block_words(g, 2, H, H, dev))
    down = TernaryLinear("tl", K, H, *_block_words(g, 2, K, H, dev))
    blk = BlockParams(attn_norm=None, wq=None, wk=None, wv=None, wo=short, ffn_norm=None,
                      w_gate=None, w_up=None, w_down=down, wqkv=short, w_gateup=short)
    x = torch.randn((1, 2 * K), generator=g, device=dev).bfloat16()
    r = torch.randn((1, H), generator=g, device=dev).bfloat16()
    gm = torch.rand((2, K), generator=g, device=dev) + 0.5
    k11, k12 = (tm.ternary_matmul_tl_w2a8_normed.launches,
                tm.ternary_matmul_tl_bf16_normed.launches)
    out = bm._stacked_mm(blk, 1, 1e-5)(1, x, "w_down", gm, glu=True, resid=r)
    assert tm.ternary_matmul_tl_w2a8_normed.launches == k11
    assert tm.ternary_matmul_tl_bf16_normed.launches == k12 + 1
    plain = tm.ternary_matmul_tl_bf16_normed_plain(x, down.packed[1], down.scales[1],
                                                   gm[1], 1e-5, True, r, H, False)
    ref = plain.float().abs().max()
    assert out.shape == (1, H) and torch.isfinite(out.float()).all()
    assert (out.float() - plain.float()).abs().max() <= 1e-2 * ref + 1e-3


@pytest.mark.parametrize("lut_bias", [False, True])
def test_k11_reads_weights_built_on_the_card_just_before(dev, lut_bias):
    """TL weights re-quantized on the card (``quant/tl.tl_quantize_dense``,
    as the engine does at init), then K11 at once, with no sync between: the
    programmatic launch reads its words and block scales before its
    dependency wait, and the kernels that built them ran before it on the
    stream (the stack's copy last).  Against the plain version of the same
    weights, within K11's gates."""
    from bitnet_tpu_torch.quant.tl import tl_quantize_dense

    g = torch.Generator(device=dev).manual_seed(80 + lut_bias)
    K, N, L = 2560, 640, 2
    x = torch.randn((2, K), generator=g, device=dev).bfloat16()
    r = torch.randn((2, N), generator=g, device=dev).bfloat16()
    gm = torch.rand((L, K), generator=g, device=dev) + 0.5
    dense = torch.randn((L, K, N), generator=g, device=dev)
    torch.cuda.synchronize()
    lins = [tl_quantize_dense(dense[l], 128) for l in range(L)]
    w = torch.stack([lin.packed for lin in lins])
    s = torch.stack([lin.scales for lin in lins])
    out = tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gm, K, N, 1e-5, False, r, lut_bias)
    torch.cuda.synchronize()
    _k11_gates(out, x, w, s, gm, r, K, N, False, lut_bias)


@pytest.mark.parametrize("M,glu,resid,lut_bias", [(3, False, False, False),
                                                  (8, True, True, True),
                                                  (64, False, True, False)])
def test_k12_matches_plain(dev, M, glu, resid, lut_bias):
    g = torch.Generator(device=dev).manual_seed(20 + M)
    K, N = 512, 384
    w, s = _block_words(g, 2, K, N, dev)
    gamma = torch.rand((2, K), generator=g, device=dev) + 0.5
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
    r = torch.randn((M, N), generator=g, device=dev).bfloat16() if resid else None
    out = tm.ternary_matmul_tl_bf16_normed(1, x, w, s, gamma, K, N, 1e-5, glu, r,
                                           lut_bias)
    plain = tm.ternary_matmul_tl_bf16_normed_plain(x, w[1], s[1], gamma[1], 1e-5,
                                                   glu, r, N, lut_bias)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 1e-2 * ref + 1e-3


@pytest.mark.parametrize("M,k,dtype", [(1, 2560, torch.bfloat16),
                                       (MB, 6784, torch.float32)])
def test_k10_decode_form_repeats_bit_for_bit(dev, M, k, dtype):
    """Two identical calls give the same bits: the split-K partials are
    added in a fixed order (N = 640 splits K over a cluster of 8)."""
    g = torch.Generator(device=dev).manual_seed(M + k)
    Kp, N = -(-k // 256) * 256, 640
    w, s = _block_words(g, 2, Kp, N, dev, k_live=k)
    x = torch.randn((M, k), generator=g, device=dev).to(dtype)
    a = tm.ternary_matmul_blockscale_bf16(1, x, w, s, k, N, False)
    b = tm.ternary_matmul_blockscale_bf16(1, x, w, s, k, N, False)
    assert torch.equal(a, b)
    assert torch.equal(a, tm._blockscale_decode_cuda(1, x, w, s, k, N, False))


def test_block_wrappers_never_fall_back(dev, monkeypatch):
    """On a CUDA tensor the K10-K12 wrappers launch their kernels (counted)
    and never call their plain versions."""
    g = torch.Generator(device=dev).manual_seed(0)
    K, N = 256, 128
    w, s = _block_words(g, 1, K, N, dev)
    for name in ("ternary_matmul_blockscale_bf16_plain",
                 "ternary_matmul_tl_w2a8_normed_plain",
                 "ternary_matmul_tl_bf16_normed_plain"):
        monkeypatch.setattr(tm, name, None)
    before = [tm.ternary_matmul_blockscale_bf16.launches,
              tm.ternary_matmul_tl_w2a8_normed.launches,
              tm.ternary_matmul_tl_bf16_normed.launches]
    x = torch.randn((2, K), generator=g, device=dev).bfloat16()
    tm.ternary_matmul_blockscale_bf16(0, x, w, s, K, N, False)
    tm.ternary_matmul_tl_w2a8_normed(0, x, w, s, None, K, N)
    tm.ternary_matmul_tl_bf16_normed(0, x, w, s, None, K, N)
    after = [tm.ternary_matmul_blockscale_bf16.launches,
             tm.ternary_matmul_tl_w2a8_normed.launches,
             tm.ternary_matmul_tl_bf16_normed.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.parametrize("wq,B", [("tl2", 1), ("tl1", 3), ("bitnet32", 1)])
def test_tl_engine_cuda_matches_cpu(dev, wq, B):
    """A TL re-quantized (or bitnet32) model, fused, on the card against the
    plain versions on the CPU: the re-quantized codes and scales are equal
    bit for bit, and the teacher-forced logits keep cosine >= 0.99."""
    import numpy as np

    from bitnet_tpu_torch.config import EngineConfig, ModelConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import build_synthetic

    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=768,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                      max_seq_len=256)
    kind = "bitnet32" if wq == "bitnet32" else "qk256"
    params = build_synthetic(cfg, seed=5, device="cpu", kind=kind)
    ec = EngineConfig(max_seq_len=256, max_batch_size=B, kernel_path="w2a8",
                      fuse_projections=True,
                      weight_quant="none" if wq == "bitnet32" else wq)
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    for n in ("wqkv", "wo", "w_gateup", "w_down"):
        a, b = getattr(eg.params.blocks, n), getattr(ecpu.params.blocks, n)
        assert torch.equal(a.packed.cpu(), b.packed) and torch.equal(a.scales.cpu(),
                                                                      b.scales)
    prompts = [list(range(7 + i, 30 + 3 * i)) for i in range(B)]
    lg, lc = eg.prefill_batch(prompts), ecpu.prefill_batch(prompts)
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(5):
        a, b = lg.float().cpu(), lc.float()
        assert (torch.nn.functional.cosine_similarity(a, b, dim=1) >= 0.99).all()
        tok = a.argmax(1)
        lg, lc = eg.decode_batch_step(tok.to(dev), pos), ecpu.decode_batch_step(tok, pos)
        pos = pos + 1


# slice 5: the wrappers of every other plan (name, rope-fused?, quantized?)
PLAN_WRAPPERS = [
    (dk.decode_attention_qkv_v1, True, False),
    (dk.decode_attention_qkv_quant_v1, True, True),
    (dk.decode_attention_quant, False, True),
    (dk.decode_attention_batched_v1, False, False),
    (dk.decode_attention_quant_batched_v1, False, True),
    (dk.decode_attention_qkv_batched, True, False),
    (dk.decode_attention_qkv_quant_batched, True, True),
    (da.decode_attention_qkv_batched_v2, True, False),
    (da.decode_attention_qkv_quant_batched_v2, True, True),
    (da.decode_attention_batched_v2, False, False),
    (da.decode_attention_quant_batched_v2, False, True)]


@pytest.mark.parametrize("fn,rope,quant", PLAN_WRAPPERS,
                         ids=[w[0].__name__ for w in PLAN_WRAPPERS])
@pytest.mark.parametrize("B", [2, 3])
def test_k13_to_k23_match_plain(dev, fn, rope, quant, B):
    """Each wrapper counts one launch and matches its plain version as K2
    / K5 do (the rope-fused ones' new rows bit for bit)."""
    import importlib

    g = torch.Generator(device=dev).manual_seed(B + len(fn.__name__))
    H, KV, D, S = 20, 5, 128, 256
    dtype = torch.int8 if quant else torch.bfloat16
    kc, vc = ((_codes(g, (2, B, S, KV * D), dtype, dev) if quant else
               torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16())
              for _ in range(2))
    scales = tuple(torch.rand((2, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
                   for _ in range(2)) if quant else ()
    p = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    if rope:
        ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
        args = (torch.randn((B, H + 2 * KV, D), generator=g, device=dev).bfloat16(),
                ang.sin(), ang.cos())
        kw = (H, KV)
    else:
        args = (torch.randn((B, H, D), generator=g, device=dev).bfloat16(),
                *(torch.randn((B, KV, D), generator=g, device=dev).bfloat16()
                  for _ in range(2)))
        kw = ()
    plain = getattr(importlib.import_module(fn.__module__), fn.__name__ + "_plain")
    before = fn.launches
    out = fn(1, *args, kc, vc, *scales, p, *kw)
    assert fn.launches == before + 1
    pl = plain(*args, kc[1], vc[1], *(s[1] for s in scales), p, *kw)
    a, pa = (out[0], pl[0]) if rope else (out, pl)
    assert (a.float() - pa.float()).abs().max() <= 1e-2 * pa.float().abs().max() + 2e-3
    if rope:
        assert all(_same(x, y) for x, y in zip(out[1:], pl[1:]))


@pytest.mark.parametrize("env,B,kv", [
    ({"BITNET_B1_ATTN": "v1"}, 1, "int8"), ({"BITNET_ROPE_FUSED": "0"}, 2, "bf16"),
    ({"BITNET_BATCHED_ATTN": "1"}, 3, "fp8"), ({"BITNET_BATCHED_ATTN": "v2qkv"}, 3, "bf16"),
    ({"BITNET_ROPE_FUSED": "0", "BITNET_BATCHED_ATTN": "1"}, 3, "int8"),
    ({"BITNET_ATTN_STACKED": "0"}, 3, "bf16")])
def test_plan_engine_cuda_matches_cpu(dev, monkeypatch, env, B, kv):
    """A 2-layer full-width pool under each knob on the card against the
    same engine's plain versions on the CPU, teacher-forced; the gates of
    test_engine_two_slots_cuda_matches_cpu, per slot."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = BITNET_2B4T.replace(num_layers=2)
    params = build_synthetic(cfg, seed=3, device="cpu")
    ec = EngineConfig(max_seq_len=128, max_batch_size=B, kv_cache_dtype=kv,
                      logits_dtype="int8", kernel_path="w2a8", fuse_projections=True)
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    prompts = [[int(t) for t in torch.randint(0, cfg.vocab_size, (9 + 5 * i,),
                                              generator=torch.Generator().manual_seed(i))]
               for i in range(B)]
    lg, lc = eg.prefill_batch(prompts), ecpu.prefill_batch(prompts)
    pos = torch.tensor([len(x) for x in prompts], dtype=torch.int32).numpy()
    for _ in range(4):
        a, b = lg.float().cpu(), lc.float()
        assert (torch.nn.functional.cosine_similarity(a, b, dim=1) >= 0.99).all()
        tok = a.argmax(1)
        top2 = torch.topk(b, 2, dim=1).values
        assert ((tok == b.argmax(1)) | (top2[:, 0] - top2[:, 1] <= (a - b).abs().amax(1))).all()
        lg, lc = eg.decode_batch_step(tok.to(dev), pos), ecpu.decode_batch_step(tok, pos)
        pos = pos + 1


def test_chain_timer_on_the_card(dev):
    """CUDA-graph replays of two chain lengths: a positive device time a
    step, well under a millisecond for one small kernel."""
    from bitnet_tpu_torch.obs.timing import chain_timer

    def step(x, i):
        return x * 1.0001

    t = chain_timer(step, lambda salt: torch.ones(1 << 20, device=dev), 64, 16)
    assert 0 < t < 1e-3


# --------------------------------------------------------------------------
# slice 6: K11 at the 8B down projection's K and the fused W2A8 FFN (K24)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("M,glu,has_gamma", [(1, True, False), (2, True, False),
                                             (2, False, True)])
def test_k11_one_launch_at_k14336_matches_plain(dev, M, glu, has_gamma):
    """K = 14336 (the 8B down projection): one launch, as at every other K.
    Its rows are K1's (also one launch at this K) bit for bit, its output
    the exact block partials of those rows to f32 rounding, and within K1's
    gate of the plain version."""
    g = torch.Generator(device=dev).manual_seed(30 + M)
    K, N = 14336, 256
    w, s = _block_words(g, 2, K, N, dev)
    gamma = (torch.rand((2, K), generator=g, device=dev) + 0.5) if has_gamma else None
    x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
    r = torch.randn((M, N), generator=g, device=dev).bfloat16()
    before = tm.ternary_matmul_tl_w2a8_normed.launches
    out = tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gamma, K, N, 1e-5, glu, r)
    assert tm.ternary_matmul_tl_w2a8_normed.launches == before + 1
    out2, xq, sx, sumq = tm._tl_w2a8_cuda(1, x, w, s, gamma, K, N, 1e-5, glu, r, False)
    assert torch.equal(out, out2)
    sv = torch.ones((2, N), device=dev)
    _o, xq1, sx1, sumq1 = tm._w2a8_normed_cuda(1, x, w, sv, gamma, K, N, 1e-5, glu,
                                               None)
    assert torch.equal(xq, xq1) and torch.equal(sx, sx1) and torch.equal(sumq, sumq1)
    part = tm.tl_block_partials(xq, w[1], False).float()
    y = (part * s[1][:, None, :]).sum(0) * sx[:, None] + r.float()
    assert ((out.float() - y).abs() <= 2**-8 * y.abs() + 1e-5).all()
    plain = tm.ternary_matmul_tl_w2a8_normed_plain(
        x, w[1], s[1], None if gamma is None else gamma[1], 1e-5, glu, r, N, False)
    ref = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2e-2 * ref + 1e-3


@pytest.mark.parametrize("M,dtype,col,F,K,H", [
    (1, torch.bfloat16, False, 1024, 512, 384), (3, torch.float32, True, 1024, 512, 384),
    (8, torch.bfloat16, True, 512, 512, 384), (32, torch.float32, False, 1024, 512, 384),
    # every BT boundary
    (9, torch.bfloat16, True, 1024, 512, 384), (16, torch.bfloat16, False, 1024, 512, 384),
    (17, torch.float32, True, 1024, 512, 384),
    # n_f = 9 tiles of 256 on a cluster of 8: a rank holds two
    (1, torch.bfloat16, True, 2304, 512, 384), (17, torch.bfloat16, False, 2304, 512, 384),
    # Hp = 320: the last down block has one column half
    (3, torch.bfloat16, True, 512, 512, 320), (32, torch.float32, True, 512, 512, 320),
    # x unpadded, K < Kp = 512
    (1, torch.bfloat16, True, 1024, 416, 384), (9, torch.float32, False, 1024, 416, 384)])
def test_k24_matches_plain(dev, M, dtype, col, F, K, H):
    """K24's int8 rows of x are the plain version's bit for bit; its f32
    activation is the plain SiLU·up of its own rows to f32 rounding; its
    requantized tiles are the plain requantization of its own activation
    bit for bit, and its output the plain down projection of its own tiles
    bit for bit; the whole within 1e-2 of the plain version (an activation
    on a requantization boundary may take the neighbouring code); a second
    call equals the first bit for bit."""
    g = torch.Generator(device=dev).manual_seed(40 + M)
    Kp, L = 512, 2
    gu, _ = _words(g, L, Kp, 2 * F, dev)
    sg = (torch.rand((L, 2 * F), generator=g, device=dev) + 0.5) * 0.02
    dw, sd = _words(g, L, F, H, dev)
    if not col:
        sd = torch.full((L, H), 0.02, device=dev)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    before = ff.ffn_w2a8_fused.launches
    out = ff.ffn_w2a8_fused(1, x, gu, sg, dw, sd, F, H)
    assert ff.ffn_w2a8_fused.launches == before + 1
    out2, (xq, sx, sumq, act, aq, sa, sq2) = ff._ffn_cuda(1, x, gu, sg, dw, sd, F, H)
    assert torch.equal(out, out2) and out.dtype == dtype
    assert torch.equal(ff.ffn_w2a8_fused(1, x, gu, sg, dw, sd, F, H), out)
    y, xq_p, sx_p, sumq_p, *_ = ff.ffn_w2a8_fused_plain(x, gu[1], sg[1], dw[1], sd[1],
                                                        F, H, parts=True)
    assert torch.equal(xq, xq_p) and torch.equal(sx, sx_p) and torch.equal(sumq, sumq_p)
    act_p = ff.gateup_act(xq, sx, sumq, gu[1], sg[1], F)
    assert ((act - act_p).abs() <= 1e-5 * act_p.abs() + 1e-30).all()
    bf = ff._pick_bf(F)
    aq_p, sa_p, sq2_p = ff.requant_tiles(act, bf)
    assert torch.equal(aq, aq_p) and torch.equal(sa, sa_p) and torch.equal(sq2, sq2_p)
    down = ff.down_from_tiles(aq, sa, sq2, dw[1], sd[1], bf)[:, :H].to(dtype)
    assert torch.equal(down, out)
    ref = y.float().abs().max()
    assert (out.float() - y.float()).abs().max() <= 1e-2 * ref


@pytest.mark.parametrize("plan", [(8, 1, 1), (16, 2, 2), (32, 4, 4), (32, 8, 8),
                                  (16, 1, 8), (8, 8, 2)])
def test_k24_every_plan_matches(dev, plan):
    """K24 in forced tiles (BT rows, the gate|up GEMM's K split, the down
    GEMM's cluster: one rank holding all four tiles, two each, one each, a
    tile split over two ranks) at K = 2048, F = 2048 (bf = 512, n_f = 4):
    its output, activation and tiles equal the planned call's bit for bit
    (integer dots are exact in any split, and the tiles' f32 terms are
    added in one order)."""
    from unittest import mock

    g = torch.Generator(device=dev).manual_seed(77)
    K, F, H, M = 2048, 2048, 640, 5
    gu, sg = _words(g, 2, K, 2 * F, dev)
    dw, sd = _words(g, 2, F, H, dev)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    want, parts = ff._ffn_cuda(1, x, gu, sg, dw, sd, F, H)
    with mock.patch.object(ff, "ffn_plan", lambda *a: plan):
        out, forced = ff._ffn_cuda(1, x, gu, sg, dw, sd, F, H)
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(forced, parts))


def test_k24_runs_four_kernels_and_no_pytorch_op(dev):
    """A K24 call is its four launches (x's row quantization, the gate|up
    GEMM, the requantization, the down GEMM) and no ATen op but the
    allocations."""
    kernels, ops = _profiled_call(
        "gu = torch.randint(-2**31, 2**31, (2, 32, 2048), dtype=torch.int32, generator=g, "
        "device=dev)\nsg = torch.rand((2, 2048), generator=g, device=dev)\n"
        "dw = torch.randint(-2**31, 2**31, (2, 64, 384), dtype=torch.int32, generator=g, "
        "device=dev)\nsd = torch.rand((2, 384), generator=g, device=dev)\n"
        "x = torch.randn((9, 500), generator=g, device=dev).bfloat16()",
        "ff.ffn_w2a8_fused(1, x, gu, sg, dw, sd, 1024, 384)", "ffn_w2a8_fused", "ff")
    assert len(kernels) == 4, kernels
    assert sum("quantize_groups" in k for k in kernels) == 2, kernels
    assert sum("ffn_gemm" in k for k in kernels) == 2, kernels
    assert ops <= {"aten::empty"}, ops


# (relative, absolute) tolerance of the decode-attention checks: over a
# bf16 cache the kernel rounds its bf16 softmax weights against other maxima
# than the chunked plain version; over an f32 cache with f32 activations
# nothing rounds to bf16, so only the order of f32 sums differs
ATTN_TOL = {torch.bfloat16: (1e-2, 2e-3), torch.float32: (1e-5, 0.0)}


# --------------------------------------------------------------------------
# slice 7: K25-K27, the f32 instance of the split-S pair and K3, K28-K32
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where", ["pos", "before", "past"])
def test_k25_k26_match_plain(dev, dtype, where):
    """K25 and K26 on a 5-D stack; K26's rows written bit for bit at
    write_pos (= pos, < pos, = S dropped), every other byte unchanged."""
    g = torch.Generator(device=dev).manual_seed(25)
    L, B, S, H, KV, D = 3, 2, 256, 20, 5, 128
    kc, vc = (torch.randn((L, B, S, KV, D), generator=g, device=dev).to(dtype)
              for _ in range(2))
    q, kn, vn = (torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, H, D), (B, KV, D), (B, KV, D)))
    pos = torch.tensor([S - 1, 100], dtype=torch.int32, device=dev)
    wpos = {"pos": pos, "before": pos - 9, "past": torch.full_like(pos, S)}[where]
    rel, eps = ATTN_TOL[dtype]
    for l in (0, L - 1):
        a = dk.decode_attention_stacked(l, q, kn, vn, kc, vc, pos)
        pa = dk.decode_attention_stacked_plain(q, kn, vn, kc.view(L, B, S, -1)[l],
                                               vc.view(L, B, S, -1)[l], pos)
        ref = pa.float().abs().max()
        assert (a.float() - pa.float()).abs().max() <= rel * ref + eps
        k2, v2, k3, v3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        b, kr, vr = dk.decode_attention_stacked_inplace(l, q, kn, vn, k2, v2, pos, wpos)
        pb = dk.decode_attention_stacked_inplace_plain(
            q, kn, vn, k3.view(L, B, S, -1)[l], v3.view(L, B, S, -1)[l], pos, wpos)
        assert kr is k2 and vr is v2
        assert torch.equal(k2, k3) and torch.equal(v2, v3)
        assert (b.float() - pb.float()).abs().max() <= rel * ref + eps


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k27_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(27)
    B, S, H, KV, D = 8, 1024, 20, 5, 128
    kc, vc = (torch.randn((B, S, KV, D), generator=g, device=dev).to(dtype)
              for _ in range(2))
    q, kn, vn = (torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, H, D), (B, KV, D), (B, KV, D)))
    pos = torch.randint(0, S, (B,), generator=g, device=dev, dtype=torch.int32)
    before = da.decode_attention_perb_v2.launches
    a = da.decode_attention_perb_v2(q, kn, vn, kc, vc, pos)
    assert da.decode_attention_perb_v2.launches == before + 1
    pa = da.decode_attention_perb_v2_plain(q, kn, vn, kc.view(B, S, -1),
                                           vc.view(B, S, -1), pos)
    rel, eps = ATTN_TOL[dtype]
    ref = pa.float().abs().max()
    assert (a.float() - pa.float()).abs().max() <= rel * ref + eps


def test_f32_cache_instances_match_plain(dev):
    """Over an f32 cache with f32 activations nothing rounds to bf16: K2,
    K5 and K8 within 1e-5 of the plain versions' max, the rows exact; K3
    copies 4-byte rows bit for bit."""
    g = torch.Generator(device=dev).manual_seed(32)
    L, B, S, H, KV, D = 2, 2, 1024, 20, 5, 128
    kc, vc = (torch.randn((L, B, S, KV * D), generator=g, device=dev) for _ in range(2))
    pos = torch.tensor([S - 1, 300], dtype=torch.int32, device=dev)
    qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev)
    ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
    a, kr, vr = da.decode_attention_qkv(1, qkv, ang.sin(), ang.cos(), kc, vc, pos, H, KV)
    pa, pk, pv = da.decode_attention_qkv_plain(qkv, ang.sin(), ang.cos(), kc[1], vc[1],
                                               pos, H, KV)
    assert torch.equal(kr, pk) and torch.equal(vr, pv)
    assert (a - pa).abs().max() <= 1e-5 * pa.abs().max()
    q, kn, vn = (torch.randn(s, generator=g, device=dev)
                 for s in ((B, H, D), (B, KV, D), (B, KV, D)))
    for fn, plain in ((dk.decode_attention, dk.decode_attention_plain),
                      (da.decode_attention_batched, da.decode_attention_batched_plain)):
        a = fn(1, q, kn, vn, kc, vc, pos)
        pa = plain(q, kn, vn, kc[1], vc[1], pos)
        assert (a - pa).abs().max() <= 1e-5 * pa.abs().max()
    rows = torch.randn((2, L, B, 1, KV * D), generator=g, device=dev)
    k2, v2 = kc.clone(), vc.clone()
    da.scatter_kv_rows(kc, vc, rows[0], rows[1], pos)
    da.scatter_kv_rows_plain(k2, v2, rows[0], rows[1], pos)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


# K29's shapes: None = the probe's inputs; (M, K, N); "unaligned" = operands
# whose pointers are 1 (dp4a) or 4 (mma) bytes past an aligned one.  Each
# unit meets its 16-byte, 4-byte and single-byte staging, one slab and
# several (K = 1024, 260), one block and several (M = 48, N = 72 / 136).
K29_CASES = [(unit, shape) for unit in ("dp4a", "mma")
             for shape in (None, (48, 1024, 72), (16, 32, 8), (32, 512, 136),
                           "unaligned")] + [
    ("dp4a", (33, 260, 20)), ("dp4a", (5, 12, 7)), ("dp4a", (3, 0, 5))]


@pytest.mark.parametrize("unit,shape", K29_CASES)
def test_w2a8_probes_match_plain(dev, unit, shape):
    """K28-K31 bit for bit on the probes' inputs; K29 exact on both units,
    on the probe's inputs and past one slab, one block and the aligned
    loads."""
    from bitnet_tpu_torch.experiments import exp_w2a8 as ew

    if shape is None:
        for fn, plain, words in ((wp.bitcast_i32_to_i8, wp.bitcast_i32_to_i8_plain,
                                  ew.p1_inputs()),
                                 (wp.bytes_to_bf16, wp.bytes_to_bf16_plain,
                                  ew.p3_inputs()),
                                 (wp.unpack_words, wp.unpack_words_plain,
                                  ew.p4_inputs()[1])):
            w = torch.from_numpy(words)
            assert torch.equal(fn(w.to(dev)).cpu(), plain(w))
        a, b, a2 = (torch.from_numpy(t) for t in ew.p2_inputs())
        pairs = [(a, b), (a2, b)]
    else:
        g = torch.Generator().manual_seed(7)
        M, K, N = (16, 64, 16) if shape == "unaligned" else shape
        a, b = (torch.randint(-128, 128, s, generator=g).to(torch.int8)
                for s in ((M, K), (K, N)))
        pairs = [(a, b)]
    for lhs, rhs in pairs:
        la, lb = lhs.to(dev), rhs.to(dev)
        if shape == "unaligned":
            off = 1 if unit == "dp4a" else 4
            la = torch.empty(la.numel() + off, dtype=torch.int8, device=dev)[off:].view(
                la.shape).copy_(la)
            lb = torch.empty(lb.numel() + off, dtype=torch.int8, device=dev)[off:].view(
                lb.shape).copy_(lb)
            assert la.data_ptr() % 16 and lb.data_ptr() % 16
        assert torch.equal(wp.int8_dot(la, lb, unit).cpu(), wp.int8_dot_plain(lhs, rhs))


@pytest.mark.parametrize("M,dtype,N", [(M, dt, 384) for M in (1, 16, 17, 33)
                                       for dt in (torch.bfloat16, torch.float32)]
                         + [(1, torch.bfloat16, 8), (33, torch.float32, 200)])
def test_k32_matches_plain(dev, M, dtype, N):
    """K32's int8 codes, row scales and sums of its M rows bit for bit; its
    output the plain arithmetic on them bit for bit (exact int32 sums, the
    same two f32 products, one bf16 rounding), bf16 for f32 x too; N not a
    multiple of 128 (and below one 64-column half)."""
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(M)
    K = 512
    codes = np.random.default_rng(M).integers(0, 4, (K, N)).astype(np.uint8)
    words = torch.from_numpy(wp.pack_w2a8_host(codes)).to(dev)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    out, xq, sx, sumq = wp._w2a8_matmul_cuda(x, words, 0.02)
    pq, psx, psum = wp.w2a8_quantize_plain(x, M)
    assert xq.shape == (M, K) and out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.equal(xq, pq) and torch.equal(sx, psx) and torch.equal(sumq, psum)
    assert torch.equal(out, wp.w2a8_matmul_plain(pq, psx, psum, words, 0.02, M))
    assert torch.equal(out, wp.w2a8_matmul(x, words, 0.02, bn=8, bkt=2))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("bt", [8, 16, 32, 64, 128])
def test_k32_every_tile_and_split_matches_plain(dev, monkeypatch, bt, split):
    """Every form of K32's GEMM (rows a block x K split), forced past the
    plan, at a row past one tile and N = 200, bit for bit."""
    monkeypatch.setattr(wp, "w2a8_gemm_plan", lambda *a: (bt, split))
    g = torch.Generator(device=dev).manual_seed(bt * 10 + split)
    K, N, M = 2048, 200, bt + 1
    words = torch.randint(-2**31, 2**31, (K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    out, xq, sx, sumq = wp._w2a8_matmul_cuda(x, words, 0.03)
    pq, psx, psum = wp.w2a8_quantize_plain(x, M)
    assert torch.equal(xq, pq) and torch.equal(sx, psx) and torch.equal(sumq, psum)
    assert torch.equal(out, wp.w2a8_matmul_plain(pq, psx, psum, words, 0.03, M))


def test_k4_keeps_its_epilogue_beside_k32s(dev):
    """K4 and K32 launch the same two kernels on the same words and rows:
    their int8 rows, scales and sums agree, and each output rounds in its
    own order (K4 ((acc - 2 sumq) sx) s[n] in x's dtype, K32 (acc - 2 sumq)
    (sx s) in bf16), so K4's default mode is untouched by K32's."""
    g = torch.Generator(device=dev).manual_seed(32)
    K, N, M = 768, 640, 40
    w, _ = _words(g, 1, K, N, dev)
    sv = torch.full((1, N), 0.02, device=dev)
    x = torch.randn((M, K), generator=g, device=dev)
    out4, xq4, sx4, sumq4 = tm._w2a8_gemm_cuda(0, x, w, sv, K, N)
    out32, xq32, sx32, sumq32 = wp._w2a8_matmul_cuda(x, w[0], 0.02)
    assert torch.equal(xq4, xq32) and torch.equal(sx4, sx32) and torch.equal(sumq4, sumq32)
    assert out4.dtype == torch.float32 and out32.dtype == torch.bfloat16
    acc = tm.int8_matmul(xq4, tm.biased_codes(w[0]))
    assert torch.equal(out4, tm.w2a8_epilogue(acc, sumq4, sx4, sv[0], None, x.dtype))
    assert torch.equal(out32, wp.w2a8_matmul_plain(xq32, sx32, sumq32, w[0], 0.02, M))


def test_k32_runs_two_kernels_and_no_pytorch_op(dev):
    """A K32 call is K4's row kernel and GEMM: the profiler sees those two
    kernels, and no ATen op but the allocations."""
    kernels, ops = _profiled_call(
        "w = words(2560, 13824)[0][0]\nx = torch.randn((1, 2560), generator=g, "
        "device=dev).bfloat16()",
        "wp.w2a8_matmul(x, w, 0.02, bn=2304, bkt=2)", "w2a8_matmul", module="wp")
    assert len(kernels) == 2, kernels
    assert sorted("quantize_rows" in k for k in kernels) == [False, True], kernels
    assert all("quantize_rows" in k or "w2a8_gemm" in k for k in kernels), kernels
    assert ops <= {"aten::empty"}, ops


# --------------------------------------------------------------------------
# the one-launch split-S decode attention: split edges, head groups, pools,
# repeats and graph replays
# --------------------------------------------------------------------------
ATTN_CACHES = [torch.bfloat16, torch.float32] + QDT


def _attn_call(dev, g, rope, cache, B, S, KV, G, D, pos, L=2, l=1):
    """One call of K2 / K7 (rope) or K5 / K15 (no rope) at these shapes and
    its plain version: (output, plain output, new rows, plain new rows)."""
    H = KV * G
    act = torch.float32 if cache == torch.float32 else torch.bfloat16
    quant = cache in QDT
    kc, vc = ((_codes(g, (L, B, S, KV * D), cache, dev) if quant else
               torch.randn((L, B, S, KV * D), generator=g, device=dev).to(cache))
              for _ in range(2))
    sc = tuple(torch.rand((L, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
               for _ in range(2)) if quant else ()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    if rope:
        qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev).to(act)
        ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
        fn, plain = ((da.decode_attention_qkv_quant, da.decode_attention_qkv_quant_plain)
                     if quant else (da.decode_attention_qkv, da.decode_attention_qkv_plain))
        out = fn(l, qkv, ang.sin(), ang.cos(), kc, vc, *sc, p, H, KV)
        pl = plain(qkv, ang.sin(), ang.cos(), kc[l], vc[l], *(t[l] for t in sc), p, H, KV)
        return out[0], pl[0], out[1:], pl[1:]
    q, kn, vn = (torch.randn(s_, generator=g, device=dev)
                 for s_ in ((B, H, D), (B, KV, D), (B, KV, D)))
    if quant:
        kn, vn = (dk.dequantize_kv(*dk.quantize_kv(x, cache)) for x in (kn, vn))
    q, kn, vn = q.to(act), kn.to(act), vn.to(act)
    fn, plain = ((dk.decode_attention_quant, dk.decode_attention_quant_plain) if quant
                 else (dk.decode_attention, dk.decode_attention_plain))
    out = fn(l, q, kn, vn, kc, vc, *sc, p)
    pl = plain(q, kn, vn, kc[l], vc[l], *(t[l] for t in sc), p)
    return out, pl, (), ()


def _attn_close(out, pl, cache):
    rel, eps = ATTN_TOL[torch.float32 if cache == torch.float32 else torch.bfloat16]
    ref = pl.float().abs().max()
    assert (out.float() - pl.float()).abs().max() <= rel * ref + eps


@pytest.mark.parametrize("cache", ATTN_CACHES, ids=str)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rope", [False, True])
def test_attn_split_edges_match_plain(dev, rope, D, G, cache):
    """Every instance (D, head group G, cache dtype, RoPE or not) against
    its plain version with one slot at each edge of the plan's splits
    (R = 128 on 132 SMs, 64 over a 1-byte cache), S = 1000 not a multiple
    of R: pos 0, 1, R-1, R,
    R+1, S-1, S.  The rope-fused kernels' new rows (codes and scales) bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(D + G + len(str(cache)) + rope)
    B, S, KV = 7, 1000, 2
    R = dk.attn_plan(B, KV, S, torch.cuda.get_device_properties(dev).multi_processor_count,
                     cache.itemsize)
    assert S % R and S // R >= 2
    out, pl, rows, prow = _attn_call(dev, g, rope, cache, B, S, KV, G, D,
                                     [0, 1, R - 1, R, R + 1, S - 1, S])
    _attn_close(out, pl, cache)
    assert all(_same(a, b) for a, b in zip(rows, prow))


@pytest.mark.parametrize("cache", ATTN_CACHES, ids=str)
@pytest.mark.parametrize("R", [64, 128, 512, 1024])
def test_attn_every_split_size_matches_plain(dev, monkeypatch, cache, R):
    """The kernel at split sizes forced past attn_plan, with slots at the
    forced split's edges (one split a slot at R = 1024)."""
    monkeypatch.setattr(dk, "attn_plan", lambda *a: R)
    g = torch.Generator(device=dev).manual_seed(R)
    S = 1024
    pos = [0, 1, R - 1, R, min(R + 1, S), S - 1, S]
    for rope in (False, True):
        out, pl, rows, prow = _attn_call(dev, g, rope, cache, 7, S, 5, 4, 128, pos)
        _attn_close(out, pl, cache)
        assert all(_same(a, b) for a, b in zip(rows, prow))


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_attn_pool_of_64_with_idle_slots(dev, cache):
    """K8 / K9 over a pool of 64 with idle slots (pos 0): the idle slots'
    output is exactly the new token's v."""
    g = torch.Generator(device=dev).manual_seed(64)
    B, S, H, KV, D = 64, 512, 20, 5, 128
    quant = cache in QDT
    kc, vc = ((_codes(g, (2, B, S, KV * D), cache, dev) if quant else
               torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16())
              for _ in range(2))
    sc = tuple(torch.rand((2, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
               for _ in range(2)) if quant else ()
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    kn, vn = (torch.randn((B, KV, D), generator=g, device=dev).bfloat16() for _ in range(2))
    p = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    idle = [0, 5, 31, 63]
    p[idle] = 0
    fn, plain = ((da.decode_attention_quant_batched, da.decode_attention_quant_batched_plain)
                 if quant else (da.decode_attention_batched, da.decode_attention_batched_plain))
    a = fn(1, q, kn, vn, kc, vc, *sc, p)
    pa = plain(q, kn, vn, kc[1], vc[1], *(t[1] for t in sc), p)
    _attn_close(a, pa, cache)
    for b in idle:
        assert torch.equal(a[b].view(KV, H // KV, D), vn[b][:, None].expand(KV, H // KV, D))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k26_rows_at_split_edges(dev, dtype):
    """K26 with pos at the splits' edges (R = 64) and write_pos = pos: the
    new rows land at pos (dropped at S), every other byte unchanged, and
    attention read the pre-write cache."""
    g = torch.Generator(device=dev).manual_seed(26)
    L, B, S, H, KV, D = 2, 7, 1000, 8, 2, 128
    kc, vc = (torch.randn((L, B, S, KV, D), generator=g, device=dev).to(dtype)
              for _ in range(2))
    q, kn, vn = (torch.randn(s_, generator=g, device=dev).to(dtype)
                 for s_ in ((B, H, D), (B, KV, D), (B, KV, D)))
    pos = torch.tensor([0, 1, 63, 64, 65, S - 1, S], dtype=torch.int32, device=dev)
    k2, v2, k3, v3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    a, kr, vr = dk.decode_attention_stacked_inplace(1, q, kn, vn, k2, v2, pos)
    pa = dk.decode_attention_stacked_inplace_plain(
        q, kn, vn, k3.view(L, B, S, -1)[1], v3.view(L, B, S, -1)[1], pos, pos)
    assert kr is k2 and vr is v2
    assert torch.equal(k2, k3) and torch.equal(v2, v3)
    _attn_close(a, pa, dtype)


def test_attn_repeats_and_graph_replays_bit_for_bit(dev):
    """Three calls in a row, and ten calls replayed in one CUDA graph, give
    the same bits (K2, K5 at B=1, S=4096: 32 splits a kv head; K8 at B=8,
    S=1024): the arrival counters are zero again after every call."""
    g = torch.Generator(device=dev).manual_seed(10)
    H, KV, D = 20, 5, 128
    calls = []
    for B, S in ((1, 4096), (8, 1024)):
        kc, vc = (torch.randn((2, B, S, KV * D), generator=g, device=dev).bfloat16()
                  for _ in range(2))
        q, kn, vn = (torch.randn(s_, generator=g, device=dev).bfloat16()
                     for s_ in ((B, H, D), (B, KV, D), (B, KV, D)))
        qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev).bfloat16()
        ang = torch.rand((B, D // 2), generator=g, device=dev)
        sin, cos = ang.sin(), ang.cos()
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        if B == 1:
            calls.append(lambda kc=kc, vc=vc, q=q, kn=kn, vn=vn, pos=pos:
                         dk.decode_attention(1, q, kn, vn, kc, vc, pos))
            calls.append(lambda kc=kc, vc=vc, qkv=qkv, sin=sin, cos=cos, pos=pos:
                         da.decode_attention_qkv(1, qkv, sin, cos, kc, vc, pos, H, KV)[0])
        else:
            calls.append(lambda kc=kc, vc=vc, q=q, kn=kn, vn=vn, pos=pos:
                         da.decode_attention_batched(1, q, kn, vn, kc, vc, pos))
    for call in calls:
        first = call()
        assert all(torch.equal(first, call()) for _ in range(2))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [call() for _ in range(10)]
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(first, o) for o in outs)
    assert int(dk.attn_counters(dev).abs().sum()) == 0


@pytest.mark.parametrize("kernel", ["K5", "K2"])
def test_attn_runs_one_kernel_and_no_pytorch_op(dev, kernel):
    """A K5 and a K2 call at B=1, S=4096 are one launch of the split-S
    kernel and no ATen op but the allocations."""
    setup = ("kc = torch.randn((2, 1, 4096, 640), generator=g, device=dev).bfloat16()\n"
             "vc = torch.randn_like(kc)\n"
             "pos = torch.tensor([4095], dtype=torch.int32, device=dev)\n"
             "q = torch.randn((1, 20, 128), generator=g, device=dev).bfloat16()\n"
             "kn = torch.randn((1, 5, 128), generator=g, device=dev).bfloat16()\n"
             "qkv = torch.randn((1, 30, 128), generator=g, device=dev).bfloat16()\n"
             "a = torch.rand((1, 64), generator=g, device=dev)\n"
             "sin, cos = a.sin(), a.cos()")
    call, counter, module = {
        "K5": ("dk.decode_attention(1, q, kn, kn, kc, vc, pos)", "decode_attention", "dk"),
        "K2": ("da.decode_attention_qkv(1, qkv, sin, cos, kc, vc, pos, 20, 5)",
               "decode_attention_qkv", "da")}[kernel]
    kernels, ops = _profiled_call(setup, call, counter, module)
    assert len(kernels) == 1 and "attn_decode" in kernels[0], kernels
    assert ops <= {"aten::empty"}, ops


def _two_layer_2b():
    """A 2-layer model at the 2B-4T widths (H=2560, F=6912, 20/5 heads,
    sub-norms), random weights from a seed, on the CPU."""
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T.replace(num_layers=2)
    return cfg, build_synthetic(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("kp", ["w2a8", "pallas"])
def test_eval_ids_on_the_card_matches_the_plain_versions(dev, kp):
    """The crossval entry point on the card (one bucketed prefill of 8
    rows: K1's row kernel and GEMM on w2a8, K6 on pallas) against the plain
    versions on the CPU, per-position cosine >= 0.99 (ROADMAP §3's gate)."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.ops import registry
    from bitnet_tpu_torch.verify.reference import cosine_similarity

    cfg, params = _two_layer_2b()
    ec = EngineConfig(max_seq_len=256, kernel_path=kp)
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    ids = [2, 7, 11, 5]
    registry.reset_launch_counts()
    a = eg.eval_ids(ids)
    n = registry.launch_counts()
    b = ecpu.eval_ids(ids)
    assert a.shape == b.shape == (4, cfg.vocab_size) and a.dtype == b.dtype
    cos = [cosine_similarity(a[t], b[t]) for t in range(4)]
    assert min(cos) >= 0.99, cos
    mm = "ternary_matmul_w2a8_normed" if kp == "w2a8" else "ternary_matmul_bf16"
    assert n[mm] == 7 * cfg.num_layers
    assert f"kernel_{mm}_x{7 * cfg.num_layers}" in eg.kernel_recorder
    assert not any(k.startswith("kernel_") for k in ecpu.kernel_recorder)


def test_receipt_names_k1_and_k5_and_replays(dev):
    """A greedy request on the card (the CLI's engine: unfused, w2a8):
    the receipt is strict-valid with backend cuda, names K1
    (``ternary_matmul_w2a8_normed``) and K5 (``decode_attention``) with
    their launch counts and the card with its power limit, and replays
    token for token."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.verify.receipts import generate_receipt, validate_receipt
    from bitnet_tpu_torch.verify.replay import replay_receipt

    cfg, params = _two_layer_2b()
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=256), device=dev)
    eng.generate([1, 5, 9], GenerationConfig(max_new_tokens=4, greedy=True))
    rec = generate_receipt(eng)
    assert rec.backend == "cuda" and validate_receipt(rec) == []
    L = cfg.num_layers
    # prefill 7L K1 launches, 3 decode steps of 7L K1 and L K5 each
    assert f"kernel_ternary_matmul_w2a8_normed_x{7 * L}" in rec.kernels
    assert f"kernel_ternary_matmul_w2a8_normed_x{3 * 7 * L}" in rec.kernels
    assert f"kernel_decode_attention_x{3 * L}" in rec.kernels
    assert rec.environment["device_name"] == torch.cuda.get_device_name(dev)
    assert "W" in rec.environment["nvidia_smi"]
    assert replay_receipt(eng, rec).matched


def _requests_engines(dev):
    """The 2B fused engine of chip_smoke's requests phase at 2 layers (int8
    head, bf16 cache, S=1024, the mock tokenizer) with a prefix cache, and
    its twin without one."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.tokenizer import MockTokenizer

    cfg, params = _two_layer_2b()
    tok = MockTokenizer(vocab_size=cfg.vocab_size)
    ec = EngineConfig(max_seq_len=1024, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True,
                      prefix_cache_tokens=4096)
    return (InferenceEngine(cfg, params, ec, tokenizer=tok, device=dev),
            InferenceEngine(cfg, params, ec.replace(prefix_cache_tokens=0),
                            tokenizer=tok, device=dev))


def test_prefix_cache_hits_match_a_cold_prefill(dev):
    """A 480-token prefix stored, then the prefix plus 20 tokens (a hit
    restoring 480 rows) and the same 500 again (499 rows): each hit's
    last-token logits keep cosine >= 0.99 against a cold prefill, and the
    suffix prefill runs K4."""
    from bitnet_tpu_torch.ops import registry

    eng, cold = _requests_engines(dev)
    g = torch.Generator().manual_seed(19)
    full = [int(t) for t in torch.randint(3, eng.cfg.vocab_size, (500,), generator=g)]
    want = cold.prefill(full)[0].float()
    eng.prefill(full[:480])
    for m in (480, 499):
        registry.reset_launch_counts()
        got = eng.prefill(full)[0].float()
        assert eng.kernel_recorder[-2] == f"prefix_restore_m{m}"
        assert registry.launch_counts()["ternary_matmul_w2a8"] == 4 * eng.cfg.num_layers
        assert torch.nn.functional.cosine_similarity(got, want, dim=0) >= 0.99


def test_checkpoint_resume_repeats_the_unbroken_run(dev, tmp_path):
    """32 greedy tokens unbroken; the same run broken after 16, captured,
    saved, loaded and resumed on the reset engine: the same tokens (the
    resume decodes the 16th token again over bit-exact restored rows)."""
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.engine import checkpoint as ck

    _eng, cold = _requests_engines(dev)
    g = torch.Generator().manual_seed(20)
    prompt = [int(t) for t in torch.randint(3, cold.cfg.vocab_size, (64,), generator=g)]
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    golden = cold.generate(prompt, gc).token_ids
    first = []
    for ev in cold.generate_stream(prompt, gc):
        first.append(ev.token_id)
        if len(first) == 16:
            break
    path = str(tmp_path / "state")
    man = ck.save(ck.capture(cold, prompt, first), path)
    # one step a round trip: the 16th token was yielded, not decoded; in
    # K-step segments (auto: 8 on the card) every segment decoded all K
    K = cold._segment_steps()
    assert man["kv_len"] == len(prompt) + (-(-16 // K) * K if K > 1 else 15)
    assert man["packed_dtypes"]["k"] == "bfloat16"
    cold.prefill([5, 6, 7])
    res = ck.resume_generation(cold, ck.load(path), gc)
    assert first == golden[:16] and res.token_ids == golden[16:]


# --------------------------------------------------------------------------
# K-step decode segments: one CUDA graph of K steps (engine/loop.py)
# --------------------------------------------------------------------------
def _segment_engine(dev, **kw):
    """The 2-layer 2B-width fused engine (int8 head, bf16 cache, S=1024)."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine

    cfg, params = _two_layer_2b()
    ec = EngineConfig(max_seq_len=1024, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True, **kw)
    return InferenceEngine(cfg, params, ec, device=dev)


def _at_k(eng, K, prompt, gc):
    from bitnet_tpu_torch.ops import registry

    eng.engine_cfg = eng.engine_cfg.replace(decode_steps_per_dispatch=K)
    registry.reset_launch_counts()
    r = eng.generate(prompt, gc)
    return r, registry.launch_counts(), eng.last_metrics.decode_steps


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "topk_seeded"])
def test_segment_graph_gives_the_eager_tokens_and_counts(dev, sampled):
    """32 tokens at K=1 (eager steps) and K=8 (four replays of one graph):
    the same tokens; each kernel's launches a decode step the same (K1 4L,
    K2 L, K3 1; K4 4L a prefill), the replays' counts added on the host."""
    from bitnet_tpu_torch.config import GenerationConfig

    eng = _segment_engine(dev)
    L = eng.cfg.num_layers
    gc = (GenerationConfig(max_new_tokens=32, temperature=0.8, top_k=40, seed=7)
          if sampled else GenerationConfig(max_new_tokens=32, greedy=True))
    prompt = list(range(3, 103))
    r1, n1, s1 = _at_k(eng, 1, prompt, gc)
    r8, n8, s8 = _at_k(eng, 8, prompt, gc)
    assert r8.token_ids == r1.token_ids and len(r8.token_ids) == 32
    assert (s1, s8) == (31, 32)
    seg = next(iter(eng._segments.values()))
    assert seg.graph is not None and seg.calls == 4
    for n, s in ((n1, s1), (n8, s8)):
        assert n["ternary_matmul_w2a8_normed"] == 4 * L * s
        assert n["decode_attention_qkv"] == L * s and n["scatter_kv_rows"] == s
        assert n["ternary_matmul_w2a8"] == 4 * L
    # a second request replays the captured graph (no new capture)
    r8b, n8b, _ = _at_k(eng, 8, prompt, gc)
    assert r8b.token_ids == r1.token_ids and n8b == n8
    assert list(eng._segments.values()) == [seg] and seg.calls == 8


def test_segment_is_captured_anew_after_the_cache_is_replaced(dev, tmp_path):
    """A checkpoint restored into a replaced cache: the engine drops the
    segment that holds the old buffers, captures a new one, and the resumed
    tokens equal the unbroken run's."""
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.engine import checkpoint as ck
    from bitnet_tpu_torch.engine.cache import allocate_cache

    eng = _segment_engine(dev, decode_steps_per_dispatch=8)
    prompt = list(range(5, 69))
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    golden = eng.generate(prompt, gc).token_ids
    first = []
    for ev in eng.generate_stream(prompt, gc):
        first.append(ev.token_id)
        if len(first) == 16:
            break
    path = str(tmp_path / "state")
    ck.save(ck.capture(eng, prompt, first), path)
    old = next(iter(eng._segments.values()))
    eng.cache = allocate_cache(eng.cfg, 1, 1024, "bf16", device=dev)
    res = ck.resume_generation(eng, ck.load(path), gc)
    assert first == golden[:16] and res.token_ids == golden[16:]
    new = list(eng._segments.values())
    assert len(new) == 1 and new[0] is not old and new[0].cache is eng.cache
    assert new[0].graph is not None and new[0].calls == 2


def test_segment_warms_the_attention_counters_itself(dev):
    """The fused prefill runs no attention kernel, so a request whose first
    decode is a segment makes its capture the device's first attention
    call: the segment zeroes the arrival counters before it captures, also
    for an engine built on ``"cuda"`` without an index (the CLI's)."""
    from bitnet_tpu_torch.config import GenerationConfig

    assert dev.index == torch.cuda.current_device()
    eng = _segment_engine("cuda", decode_steps_per_dispatch=8)
    dk._COUNTERS.pop(dev.index, None)
    r = eng.generate(list(range(7, 40)), GenerationConfig(max_new_tokens=8, greedy=True))
    assert len(r.token_ids) == 8 and dev.index in dk._COUNTERS
    assert next(iter(eng._segments.values())).calls == 1
    assert int(dk._COUNTERS[dev.index].abs().sum()) == 0


# --------------------------------------------------------------------------
# K33 (paged decode attention) and the scheduler's pool graphs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("qdt,kdt,D,G,page,B,S", [
    ("bf16", "bf16", 128, 4, 16, 8, 1024), ("bf16", "bf16", 128, 4, 128, 8, 1024),
    ("f32", "bf16", 128, 4, 16, 3, 200), ("f32", "f32", 64, 1, 8, 2, 64),
    ("bf16", "f32", 128, 8, 32, 64, 512), ("bf16", "bf16", 64, 2, 16, 1, 4096),
    # every page size the pool and the experiment use and those between
    # (24: stage and split boundaries inside a page), both q and page dtypes
    ("f32", "bf16", 128, 4, 8, 11, 600), ("f32", "bf16", 128, 4, 24, 11, 600),
    ("f32", "bf16", 128, 4, 128, 11, 600), ("f32", "bf16", 128, 4, 256, 11, 600),
    ("bf16", "bf16", 128, 4, 24, 11, 600), ("f32", "f32", 128, 4, 24, 11, 600),
    ("f32", "f32", 128, 4, 256, 11, 600), ("bf16", "f32", 64, 4, 256, 11, 600),
    # pages of 12 and 5 rows: TMA boxes of 4 and 1 rows, off the swizzle's
    # 8-row period
    ("f32", "bf16", 128, 4, 12, 11, 600), ("bf16", "bf16", 64, 2, 5, 8, 700),
    # G = 1, 2, 5, 8 at D = 64 and 128
    ("f32", "bf16", 64, 1, 16, 8, 700), ("f32", "bf16", 128, 2, 24, 8, 700),
    ("bf16", "bf16", 128, 5, 16, 8, 700), ("f32", "bf16", 64, 5, 128, 8, 700),
    ("f32", "bf16", 128, 8, 8, 8, 700), ("f32", "f32", 128, 5, 16, 8, 700),
    ("bf16", "f32", 64, 8, 24, 8, 700), ("f32", "f32", 64, 2, 128, 8, 700),
    # the scheduler's largest pool and its longest slot
    ("f32", "bf16", 128, 4, 16, 64, 1024), ("f32", "bf16", 128, 4, 16, 1, 4096)])
def test_k33_matches_plain(dev, qdt, kdt, D, G, page, B, S):
    """K33 against its plain version: slot 0 full; then lengths 0, 1,
    page - 1, page, page + 1 and one past the table's reach in the next
    slots, random lengths in the rest (splits of 64..512 positions, so a
    split boundary falls inside a page of 24, 128 or 256 rows); one launch,
    a second call bit for bit; then -1 entries and a length past the
    reach."""
    from bitnet_tpu_torch.ops import paged_attention as pa

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device=dev).manual_seed(D + G + page + B)
    KV, npg = 2, -(-S // page)
    P = B * npg + 3
    q = (torch.randn((B, KV * G, D), generator=g, device=dev) * 0.1).to(dt[qdt])
    kp = torch.randn((KV, P, page, D), generator=g, device=dev).to(dt[kdt])
    vp = torch.randn((KV, P, page, D), generator=g, device=dev).to(dt[kdt])
    table = torch.randperm(P, generator=torch.Generator().manual_seed(1))[:B * npg]
    table = table.view(B, npg).to(torch.int32).to(dev)
    lens = torch.randint(1, S + 1, (B,), generator=g, device=dev).to(torch.int32)
    lens[0] = S
    for i, n in enumerate([0, 1, page - 1, page, page + 1, npg * page + 1][:B - 1]):
        lens[1 + i] = n
    pa.paged_attention.launches = 0
    out = pa.paged_attention(q, kp, vp, lens, table)
    assert pa.paged_attention.launches == 1
    plain = pa.paged_attention_plain(q, kp, vp, lens, table)
    ref = plain.float().abs().max()
    tol = 1e-5 * ref + 1e-6 if qdt == "f32" else 1e-2 * ref + 2e-3
    assert (out.float() - plain.float()).abs().max() <= tol
    if B > 1:
        assert bool((out[1] == 0).all())
    assert torch.equal(out, pa.paged_attention(q, kp, vp, lens, table))
    # a scheduler window past a slot's pages: -1 entries read page 0, and a
    # length past the table's reach attends what it reaches
    table[-1, npg // 2:] = -1
    lens[-1] = S + 40
    out = pa.paged_attention(q, kp, vp, lens, table)
    plain = pa.paged_attention_plain(q, kp, vp, lens, table)
    assert (out.float() - plain.float()).abs().max() <= tol


def test_k33_two_layers_back_to_back_leave_the_counters_zero(dev):
    """Two layers of a pool called back to back on one stream, as the
    paged plan calls them (splits combined through the arrival counters):
    each meets its plain version, and the counters are zero after."""
    from bitnet_tpu_torch.ops import decode_attention as dk
    from bitnet_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(7)
    B, KV, H, D, page, npg = 8, 5, 20, 128, 16, 64
    pool = torch.randn((2, 2, KV, B * npg + 1, page, D), generator=g, device=dev).bfloat16()
    q = (torch.randn((B, H, D), generator=g, device=dev) * 0.1).float()
    table = torch.randperm(B * npg, generator=torch.Generator().manual_seed(2))
    table = table.view(B, npg).to(torch.int32).to(dev)
    lens = torch.randint(1, npg * page + 1, (B,), generator=g, device=dev).to(torch.int32)
    lens[0] = npg * page
    assert pa.paged_plan(B, KV, npg * page, dk._sm_count(dev.index))[0] > 1
    outs = [pa.paged_attention(q, pool[0, l], pool[1, l], lens, table) for l in (0, 1)]
    torch.cuda.synchronize()
    assert int(dk.attn_counters(dev).abs().sum()) == 0
    for l, out in enumerate(outs):
        plain = pa.paged_attention_plain(q, pool[0, l], pool[1, l], lens, table)
        assert (out - plain).abs().max() <= 1e-5 * plain.abs().max() + 1e-6


def test_k33_replays_in_a_graph_bit_for_bit(dev):
    from bitnet_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((8, 20, 128), generator=g, device=dev).bfloat16()
    kp = torch.randn((30, 5, 70, 16, 128), generator=g, device=dev).bfloat16()
    table = torch.arange(64, device=dev, dtype=torch.int32).view(8, 8)
    lens = torch.full((8,), 100, dtype=torch.int32, device=dev)
    want = pa.paged_attention(q, kp[3], kp[4], lens, table)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, kp[3], kp[4], lens, table)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def _pool_scheduler(dev, paged=False, **kw):
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg, params = _two_layer_2b()
    ec = EngineConfig(max_seq_len=512, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True)
    return ContinuousBatchingScheduler(cfg, params, None, ec, num_slots=8,
                                       start_loop=False, max_admissions_per_step=8,
                                       paged=paged, page_size=16, device=dev, **kw)


def _pool_run(s):
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.ops import registry

    gens = [GenerationConfig(max_new_tokens=20, greedy=True),
            GenerationConfig(max_new_tokens=20, temperature=0.8, top_k=40, seed=3),
            GenerationConfig(max_new_tokens=17, temperature=0.9, top_p=0.8, seed=5,
                             repetition_penalty=1.2, logit_bias=((7, 3.0),))]
    reqs = [s.submit(list(range(3 + i, 40 + 9 * i)), gens[i % 3]) for i in range(10)]
    registry.reset_launch_counts()
    for _ in range(200):
        s._step()
        if not any(sl.occupied for sl in s.slots) and s.pending.empty():
            break
    out = []
    for r in reqs:
        toks = []
        while not r.out.empty():
            t, _, done, reason = r.out.get()
            if t is not None:
                toks.append(t)
        out.append(toks)
    return out, registry.launch_counts()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pool_graphs_give_the_eager_body_tokens_and_counts(dev, paged, monkeypatch):
    """A 2-layer 2B-width pool of 8 at K=4 (ten staggered requests, greedy
    and seeded): the captured graphs' tokens and launch counts equal the
    same pool body run eagerly on the card."""
    from bitnet_tpu_torch.engine import loop

    got, n_graph = _pool_run(_pool_scheduler(dev, paged, decode_steps_per_dispatch=4))

    def eager(self, ints, floats, generators):
        self.calls += 1
        with torch.inference_mode():
            toks, raw, u = self._body(torch.from_numpy(ints).to(self.device),
                                      torch.from_numpy(floats).to(self.device),
                                      generators)
        return toks.cpu().numpy().astype("int64"), raw, u
    monkeypatch.setattr(loop.PoolSegment, "__call__", eager)
    want, n_eager = _pool_run(_pool_scheduler(dev, paged, decode_steps_per_dispatch=4))
    assert got == want and all(len(t) >= 17 for t in got)
    assert n_graph == n_eager
    assert n_graph["paged_attention" if paged else "decode_attention_batched"] > 0


def test_pool_k8_gives_the_k1_tokens(dev):
    a, _ = _pool_run(_pool_scheduler(dev, decode_steps_per_dispatch=1))
    b, _ = _pool_run(_pool_scheduler(dev, decode_steps_per_dispatch=8))
    assert a == b


def test_a_decode_from_another_thread_raises_while_a_scheduler_runs(dev):
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine

    s = _pool_scheduler(dev)
    s._step()                       # the calling thread now drives the device
    cfg, params = _two_layer_2b()
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=256, kernel_path="w2a8",
                                                    fuse_projections=True), device=dev)
    err = {}

    def other():
        try:
            eng.generate([1, 2, 3], GenerationConfig(max_new_tokens=2, greedy=True))
        except RuntimeError as e:
            err["e"] = e
    import threading

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert "another thread" in str(err["e"])
    s.shutdown()


# --------------------------------------------------------------------------
# speculative decoding and pipelined serving (engine/speculative.py, the
# scheduler's speculative_k and pipeline_depth)
# --------------------------------------------------------------------------
def _verify_inp(B, T, S, slot, toks, base):
    import numpy as np

    from bitnet_tpu_torch.engine.speculative import verify_input

    inp = verify_input(B, T, S)
    inp[slot, :T] = toks
    inp[slot, T:2 * T] = np.arange(base, base + T)
    inp[slot, 2 * T], inp[slot, 2 * T + 1] = base, T
    return inp


@pytest.mark.parametrize("T", [2, 3, 5])
def test_verify_graph_argmax_is_the_eager_verifys(dev, T):
    """The fused 2-layer engine's verify of T tokens: the graph's argmaxes
    and draft probabilities equal the same body run eagerly on the card,
    bit for bit; a replay launches K4 four times a layer and no decode
    attention."""
    import numpy as np

    from bitnet_tpu_torch.engine.speculative import VerifyStep
    from bitnet_tpu_torch.ops import registry

    eng = _segment_engine(dev)
    prompt = list(range(3, 60))
    n = len(prompt)
    eng.prefill(prompt)
    inp = _verify_inp(1, T, 1024, 0, [prompt[-1]] + [7 + i for i in range(T - 1)], n - 1)
    step = VerifyStep(eng.cfg, eng.params, eng.cache, "w2a8", T, 1, True, dev)
    eng.cache.lengths[0] = n - 1
    with torch.inference_mode():
        eager = step._body(torch.from_numpy(inp).to(dev)).cpu().numpy()
    eng.cache.lengths[0] = n - 1
    registry.reset_launch_counts()
    best, probs = step(inp)
    n_graph = registry.launch_counts()
    assert step.graph is not None and int(eng.cache.lengths[0]) == n - 1 + T
    np.testing.assert_array_equal(best, eager[:, :T])
    np.testing.assert_array_equal(probs, np.ascontiguousarray(eager[:, T:]).view(np.float32))
    L = eng.cfg.num_layers
    assert n_graph["ternary_matmul_w2a8"] == 4 * L
    assert n_graph["decode_attention_qkv"] == 0 and n_graph["scatter_kv_rows"] == 0
    eng.cache.lengths[0] = n - 1
    again, _ = step(inp)
    np.testing.assert_array_equal(again, best)


def test_rejected_rows_stay_out_of_attention(dev):
    """Two verifies with different rejected drafts at the same positions:
    once the length is rolled back, the next decode step's logits are bit
    for bit the same."""
    from bitnet_tpu_torch.engine.speculative import VerifyStep

    eng = _segment_engine(dev)
    prompt = list(range(11, 70))
    n = len(prompt)
    outs = []
    for junk in ([5, 6, 7, 8], [900, 31, 4444, 12]):
        eng.prefill(prompt)
        eng.cache.lengths[0] = n - 1
        step = VerifyStep(eng.cfg, eng.params, eng.cache, "w2a8", 5, 1, False, dev)
        best, _ = step(_verify_inp(1, 5, 1024, 0, [prompt[-1]] + junk, n - 1))
        eng.cache.lengths[0] = n
        outs.append(eng.decode_step(int(best[0, 0]), n).float().cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_verify_leaves_masked_slots_rows_untouched(dev, kv):
    from bitnet_tpu_torch.engine.speculative import VerifyStep

    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine

    cfg, params = _two_layer_2b()
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_seq_len=1024, max_batch_size=3, kv_cache_dtype=kv, logits_dtype="int8",
        kernel_path="w2a8", fuse_projections=True), device=dev)
    eng.prefill_batch([list(range(3, 40)), list(range(5, 30)), list(range(9, 60))])
    c = eng.cache
    before = {n: getattr(c, n).clone() for n in ("k", "v", "k_scale", "v_scale")
              if getattr(c, n) is not None}
    step = VerifyStep(eng.cfg, eng.params, c, "w2a8", 5, 3, False, dev)
    step(_verify_inp(3, 5, 1024, 1, [4, 40, 41, 42, 43], 25))
    torch.cuda.synchronize()
    for n, t in before.items():
        now = getattr(c, n)
        assert torch.equal(now[:, 0], t[:, 0]) and torch.equal(now[:, 2], t[:, 2]), n
        assert not torch.equal(now[:, 1], t[:, 1])
    assert c.lengths.tolist() == [37, 30, 51]


def test_engine_draft_segment_gives_k_single_steps(dev):
    """EngineDraft drafts k tokens in one replay of a K = k greedy segment:
    the tokens of k eager greedy decode steps on a second engine."""
    from bitnet_tpu_torch.engine.speculative import EngineDraft

    eng, ref = _segment_engine(dev), _segment_engine(dev)
    prompt = list(range(21, 90))
    d = EngineDraft(eng)
    d.begin(prompt)
    got = d.propose(prompt, 6)
    lg = ref.prefill(prompt)
    want = []
    for i in range(6):
        t = int(torch.argmax(lg[0].float()))
        want.append(t)
        lg = ref.decode_step(t, len(prompt) + i)
    assert got == want
    seg = next(iter(eng._segments.values()))
    assert seg.graph is not None and seg.n_steps == 6 and seg.calls == 1
    # the next round goes on from the draft's own context (no re-prefill)
    assert len(d.propose(prompt + got, 2)) == 2
    assert sum(r.startswith("prefill") for r in eng.kernel_recorder) == 1


def _pl_run(s):
    """``_pool_run`` stepping the pipelined loop; also the most windows in
    flight when one was read."""
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.ops import registry

    gens = [GenerationConfig(max_new_tokens=20, greedy=True),
            GenerationConfig(max_new_tokens=20, temperature=0.8, top_k=40, seed=3),
            GenerationConfig(max_new_tokens=17, temperature=0.9, top_p=0.8, seed=5,
                             repetition_penalty=1.2, logit_bias=((7, 3.0),))]
    reqs = [s.submit(list(range(3 + i, 40 + 9 * i)), gens[i % 3]) for i in range(10)]
    registry.reset_launch_counts()
    deepest, read = 0, s._pl_read_one

    def spy():                      # the pipe's depth when a window is read
        nonlocal deepest
        deepest = max(deepest, len(s._pl_inflight))
        read()
    s._pl_read_one = spy
    try:
        for _ in range(400):
            s._step_pipelined()
            if not any(sl.occupied for sl in s.slots) and s.pending.empty() \
                    and not s._pl_inflight:
                break
    finally:
        del s._pl_read_one          # no cycle keeps the scheduler alive
    out = []
    for r in reqs:
        toks = []
        while not r.out.empty():
            t, _, done, reason = r.out.get()
            if t is not None:
                toks.append(t)
        out.append(toks)
    return out, registry.launch_counts(), deepest


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_tokens_are_the_sync_tokens(dev, depth):
    """A 2-layer 2B-width pool of 8 at K=8, ten staggered requests (greedy,
    seeded, penalties with a logit bias): the pipelined windows give the
    synchronous scheduler's tokens; windows were in flight together; each
    window's kernels are a sync step's (K1 4L, K8 L and K3 once a step)."""
    want, _ = _pool_run(_pool_scheduler(dev, decode_steps_per_dispatch=8))
    s = _pool_scheduler(dev, decode_steps_per_dispatch=8, pipeline_depth=depth)
    got, n, deepest = _pl_run(s)
    assert got == want and all(len(t) >= 17 for t in got)
    assert deepest == depth
    L = 2
    steps = s.stats["decode_steps"]
    assert n["ternary_matmul_w2a8_normed"] == 4 * L * steps
    assert n["decode_attention_batched"] == L * steps and n["scatter_kv_rows"] == steps


def test_pipelined_windows_keep_one_stream_and_the_counters(dev, monkeypatch):
    """Every window, admission and finish is issued on the caller's stream
    (the decode attention's arrival counters are one buffer a device), and
    the counters are back at zero once the windows are read."""
    from bitnet_tpu_torch.engine import loop

    streams = set()
    issue = loop.PoolPipeline.issue

    def spy(self, *a, **k):
        streams.add(torch.cuda.current_stream(dev).cuda_stream)
        return issue(self, *a, **k)
    monkeypatch.setattr(loop.PoolPipeline, "issue", spy)
    s = _pool_scheduler(dev, decode_steps_per_dispatch=4, pipeline_depth=3)
    _, _, deepest = _pl_run(s)
    torch.cuda.synchronize()
    assert deepest >= 2 and streams == {torch.cuda.current_stream(dev).cuda_stream}
    assert int(dk.attn_counters(dev).abs().sum()) == 0


def test_spec_pool_keeps_the_sampled_tokens_and_runs_k4(dev):
    """The same staggered pool with speculative_k=4: its sampled and
    penalised slots (not eligible) emit the tokens of the pool without
    speculation; the verifies launch K4 (4L a verify) and no decode
    attention of their own."""
    from bitnet_tpu_torch.ops import registry

    want, _ = _pool_run(_pool_scheduler(dev, decode_steps_per_dispatch=8))
    s = _pool_scheduler(dev, decode_steps_per_dispatch=8, speculative_k=4)
    got, n = _pool_run(s)
    for i in range(10):
        if i % 3:
            assert got[i] == want[i], i
    verifies = sum(v.calls for v in s._verifies.values())
    assert verifies > 0 and s.stats["spec_drafted"] > 0
    assert all(len(got[i]) == 20 for i in range(0, 10, 3))
    assert n["ternary_matmul_w2a8"] == 4 * 2 * (verifies + s.stats["prefills"])
    assert registry.launch_counts()["paged_attention"] == 0
