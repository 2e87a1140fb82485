"""K1's tiles, its choice of form, and its plain version at the rows and
widths its two forms take; K11's launch, the block-scale mode of K1's
decode form under the same plan and limits.

``w2a8_decode_plan`` picks the column block of K1's one-launch decode form
(M <= 2, K <= 14336): whole column blocks, and every block resident at once
on the main path's shapes.  The wrapper alone picks the form (the decode
kernel, or the row kernel and the GEMM tiled by ``w2a8_gemm_plan``), through
limits that equal the kernel's own.  The plain version is held to the
Pallas kernel it replaces (``ternary_matmul_stacked``, interpret mode) at
the rows of both forms and at the 8B down projection's K = 14336, with the
tolerance of ``test_torch_ternary_matmul.py`` (an int8 activation one step
off at a rounding boundary moves an output by at most sx * scale * 4).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops.ternary_matmul import ternary_matmul_stacked
from bitnet_tpu_torch.ops import ternary_matmul as tm

# (K, N) of the 2B fused four and the 8B fused four
MAIN_SHAPES = ((2560, 3840), (2560, 2560), (2560, 13824), (6912, 2560),
               (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))


SRC = (Path(tm.__file__).resolve().parent.parent / "csrc" / "ternary_matmul.cu").read_text()


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("M", [1, 2])
def test_decode_plan_tiles_n_whole(M, sms):
    for K in (256, 512, 2560, 6912, 14336):
        for N in range(64, 30000, 448):
            cols = tm.w2a8_decode_plan(M, K, N, sms)
            assert cols in tm.W2A8_DECODE_COLS and N % cols == 0, (K, N, cols)


@pytest.mark.parametrize("py,c", [("W2A8_DECODE_MAX_M", "DEC_MAX_M"),
                                  ("W2A8_DECODE_MAX_K", "DEC_MAX_K"),
                                  ("W2A8_DECODE_SHORT_K", "DEC_SHORT_K")])
def test_decode_limits_are_the_kernels(py, c):
    """The wrapper's limits of the decode form (K1's and K11's) are the
    kernel's, which its entry point checks (a call past them is refused,
    never misread)."""
    m = re.search(rf"constexpr int {c} = (\d+);", SRC)
    assert m and int(m.group(1)) == getattr(tm, py), (py, c)


@pytest.mark.parametrize("K,N", MAIN_SHAPES)
def test_decode_plan_fits_the_modes_shared_memory(K, N):
    """On the 2B and 8B shapes at 132 SMs the plan's column block, the one
    K1 and K11 both take, tiles N whole, for M = 1 and 2 alike.  Where it
    counts two blocks an SM (rows of up to W2A8_DECODE_SHORT_K values), two
    blocks of either mode fit: a ``static_assert`` beside the kernel's
    sizes holds it, so a build that broke it would fail."""
    cols = tm.w2a8_decode_plan(1, K, N, 132)
    assert cols in tm.W2A8_DECODE_COLS and N % cols == 0
    assert tm.w2a8_decode_plan(2, K, N, 132) == cols


def test_decode_cols_are_the_kernels():
    """Every column block the plan can return is one the entry point takes
    and one the kernel is instantiated for, and no other."""
    taken = re.search(r"\(cols != (\d+) && cols != (\d+) && cols != (\d+)\)", SRC)
    assert taken and tuple(int(v) for v in taken.groups()) == tm.W2A8_DECODE_COLS
    cases = re.findall(r"case (\d+): return BN_DEC\(\1\);", SRC)
    default = re.search(r"default: return BN_DEC\((\d+)\);", SRC)
    assert tuple(sorted(int(v) for v in cases + [default.group(1)])) == tm.W2A8_DECODE_COLS


class _Lib:
    """The ternary_matmul library's K1 and K11 entry points, recording calls."""
    def __init__(self):
        self.calls = []

    def bn_tl_w2a8_normed(self, *args):
        self.calls.append(("k11", args[16:-1]))
        return 0

    def bn_w2a8_normed(self, *args):
        cols, bt, split = args[19:22]
        self.calls.append(("decode", (cols,)) if cols else ("gemm", (bt, split)))
        return 0


@pytest.mark.parametrize("M,K,N,form", [
    (1, 2560, 2560, "decode"), (2, 14336, 4096, "decode"), (1, 14592, 4096, "gemm"),
    (3, 2560, 3840, "gemm"), (8, 6912, 2560, "gemm"), (64, 2560, 13824, "gemm")])
def test_k1_launch_takes_one_form(monkeypatch, M, K, N, form):
    """The wrapper's launch takes the decode form at M <= 2 and K <= 14336,
    with the plan's column block as its one tile argument; else the GEMM
    form, with the GEMM plan's rows a block and K split."""
    lib = _Lib()
    monkeypatch.setattr(tm._cuda, "library", lambda name: lib)
    monkeypatch.setattr(tm._cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tm, "_sm_count", lambda index: 132)
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    w = torch.zeros((2, K // 16, N), dtype=torch.int32)
    sv = torch.ones((2, N), dtype=torch.float32)
    tm._w2a8_normed_launch(1, x, w, sv, None, K, N, 1e-5, False, None)
    want = ((tm.w2a8_decode_plan(M, K, N, 132),) if form == "decode"
            else tm.w2a8_gemm_plan(M, K, N, 132))
    assert lib.calls == [(form, want)]


@pytest.mark.parametrize("lut_bias", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, 2560, 2560), (2, 2560, 13824), (1, 6912, 2560),
                                   (2, 14336, 4096), (1, 4096, 28672)])
def test_k11_launch_is_the_block_scale_decode_form(monkeypatch, M, K, N, lut_bias):
    """K11's wrapper makes one call of K1's library, ``bn_tl_w2a8_normed``
    (the decode kernel's block-scale mode), at every K up to 14336, with
    the codes' bias, x's dtype and the plan's column block (K1's); no
    scratch beyond K1's rows, scales and sums."""
    lib = _Lib()
    monkeypatch.setattr(tm._cuda, "library", lambda name: lib if name == "ternary_matmul"
                        else None)
    monkeypatch.setattr(tm._cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tm, "_sm_count", lambda index: 132)
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    w = torch.zeros((2, K // 16, N), dtype=torch.int32)
    s = torch.ones((2, K // 32, N), dtype=torch.float32)
    out, scratch = tm._tl_w2a8_launch(1, x, w, s, None, K, N, 1e-5, False, None, lut_bias)
    want = (int(lut_bias), 1, tm.w2a8_decode_plan(M, K, N, 132))
    assert lib.calls == [("k11", want)]
    assert out.shape == (M, N) and scratch.numel() == M * (K + 8)


def test_old_k11_kernels_are_gone():
    """K11's own one-launch and two-kernel paths, and the preamble they
    shared, are gone; its entry point sits beside K1's."""
    csrc = Path(tm.__file__).resolve().parent.parent / "csrc"
    srcs = "".join(p.read_text() for p in sorted(csrc.glob("*.cu*")))
    for gone in ("tl_w2a8_fused", "tl_quantize_rows", "tl_w2a8_gemv", "tl_dot_epilogue",
                 "launch_tl_w2a8", "fused_quantize_rows", "FUSED_MAX_K"):
        assert not re.search(rf"\b{gone}\b", srcs), gone
    assert "int bn_tl_w2a8_normed(" in (csrc / "ternary_matmul.cu").read_text()
    assert "bn_tl_w2a8_normed" in tm._cuda.SIGNATURES["ternary_matmul"]
    assert "bn_tl_w2a8_normed" not in tm._cuda.SIGNATURES["ternary_matmul_tl"]


@pytest.mark.parametrize("K,N", MAIN_SHAPES)
def test_decode_plan_keeps_every_block_resident(K, N):
    """Every block of the call is resident at once (two an SM for rows of up
    to W2A8_DECODE_SHORT_K values, else one), with at least 80 of them on
    the main path's shapes (the 2560-column projections: 80 blocks of 32)."""
    cols = tm.w2a8_decode_plan(1, K, N, 132)
    blocks = N // cols
    cap = (2 if K <= tm.W2A8_DECODE_SHORT_K else 1) * 132
    assert 80 <= blocks <= cap, (cols, blocks)
    assert tm.w2a8_decode_plan(2, K, N, 132) == cols


def test_decode_plan_is_the_main_paths():
    """The plans the kernel was timed in (PERF.md §6, K1's plan sweep)."""
    want = {(2560, 3840): 32, (2560, 2560): 32, (2560, 13824): 64, (6912, 2560): 32,
            (4096, 6144): 32, (4096, 4096): 32, (4096, 28672): 128, (14336, 4096): 32}
    assert {kn: tm.w2a8_decode_plan(1, *kn, 132) for kn in MAIN_SHAPES} == want


@pytest.mark.parametrize("M,K,glu,norm,resid,dtype", [
    (1, 256, False, True, True, "f32"), (2, 256, True, True, False, "f32"),
    (3, 256, True, False, True, "f32"), (8, 512, False, True, True, "bf16"),
    (64, 256, True, True, True, "f32"),
    (1, 14336, True, False, True, "f32"), (2, 14336, True, True, True, "bf16")])
def test_k1_plain_matches_pallas_at_both_forms(M, K, glu, norm, resid, dtype):
    N, L = 128, 2
    rng = np.random.default_rng(M * 100 + K)
    words = rng.integers(-2**31, 2**31 - 1, (L, K // 16, N), dtype=np.int32)
    sv = rng.uniform(0.5, 1.5, (L, N)).astype(np.float32) * 0.02
    gamma = rng.uniform(0.5, 1.5, (L, K)).astype(np.float32)
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


def test_k1_timeline_stamps_find_their_lines():
    """``tools/k1_timeline`` stamps an instrumented copy of K1's kernels
    beside fixed source lines: every one is in the source once."""
    from bitnet_tpu_torch.tools import k1_timeline

    src = SRC
    out = k1_timeline.instrumented_source(src)
    assert "w2a8_gemv_fused" not in src
    stamps = [a[1] for a in k1_timeline.ANCHORS]
    assert all(out.count(st) >= 1 for st in stamps)
    assert out.count("BN_T(") - src.count("BN_T(") >= len(k1_timeline.ANCHORS) - 2
    assert "bn_k1_stamps" in out
