"""The W2A8 probe and prototype wrappers (K29, K32) on the CPU: what runs
before their kernels (K32's tile plan, the refusals of the kernel paths),
that the card's unpadded K32 rows give the padded prototype's output, and
that the C entry points match the ctypes signatures they are called with.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marker ``cuda``); ``tests/test_torch_exp_w2a8.py`` holds the CPU results to
``experiments/exp_w2a8.py``'s own Pallas calls.
"""

import re

import numpy as np
import pytest
import torch

from bitnet_tpu_torch.ops import _cuda
from bitnet_tpu_torch.ops import registry
from bitnet_tpu_torch.ops import ternary_matmul as tm
from bitnet_tpu_torch.ops import w2a8_probes as wp

torch.set_num_threads(1)


# (M, K, N, SMs) -> (BT, split): the script's shape (K = 2560, N = 13824: 108
# column blocks, no split on 132 SMs), a narrow N that leaves SMs idle, and
# a card with fewer SMs
@pytest.mark.parametrize("M,K,N,sms,want", [
    (1, 2560, 13824, 132, (8, 1)), (16, 2560, 13824, 132, (16, 1)),
    (17, 2560, 13824, 132, (32, 1)), (33, 2560, 13824, 132, (64, 1)),
    (200, 2560, 13824, 132, (128, 1)), (1, 2560, 384, 132, (8, 4)),
    (1, 512, 384, 132, (8, 1)), (16, 2560, 2560, 132, (16, 4)),
    (1, 2560, 13824, 66, (8, 1)), (1, 2560, 2560, 16, (8, 1))])
def test_k32_tile_plan_is_a_function_of_the_shape(M, K, N, sms, want):
    assert tm.w2a8_gemm_plan(M, K, N, sms) == want


@pytest.mark.parametrize("M", [1, 3, 16, 17, 33])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_k32_unpadded_rows_give_the_padded_prototypes_output(M, xdt):
    """The TPU prototype pads M to a multiple of 16 rows with zero codes and
    sx = 1; the card and the CPU path take the M rows alone: the codes, the
    scales, the sums and the bf16 output of those rows are the same bits."""
    K, N = 512, 128
    rng = np.random.default_rng(M)
    words = torch.from_numpy(wp.pack_w2a8_host(
        rng.integers(0, 4, (K, N)).astype(np.uint8)))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(xdt)
    Mp = 16 * -(-M // 16)
    pq, psx, psum = wp.w2a8_quantize_plain(x, Mp)
    q, sx, sumq = wp.w2a8_quantize_plain(x, M)
    assert torch.equal(q, pq[:M]) and torch.equal(sx, psx[:M])
    assert torch.equal(sumq, psum[:M])
    padded = wp.w2a8_matmul_plain(pq, psx, psum, words, 0.02, M)
    got = wp.w2a8_matmul(x, words, 0.02, bn=N, bkt=2)
    assert got.shape == (M, N) and torch.equal(got, padded)


def test_kernel_paths_raise_on_cpu_tensors():
    """K29's and K32's kernel paths take CUDA tensors only: on CPU tensors
    they raise before building anything, rather than computing there."""
    a = torch.zeros((16, 64), dtype=torch.int8)
    b = torch.zeros((64, 16), dtype=torch.int8)
    for unit in ("dp4a", "mma"):
        with pytest.raises(ValueError, match="CUDA"):
            wp._int8_dot_cuda(a, b, unit)
    x = torch.zeros((1, 512))
    words = torch.zeros((32, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        wp._w2a8_matmul_cuda(x, words, 0.02)
    with pytest.raises(ValueError, match="CUDA"):
        wp._w2a8_matmul_launch(x.bfloat16(), words, 0.02)
    assert torch.equal(wp.int8_dot(a, b), wp.int8_dot_plain(a, b))


def test_k32_is_k4s_kernel_in_the_registry():
    spec, = [s for s in registry.REGISTRY if s.kernel_id == "w2a8_matmul"]
    assert spec.source == "bitnet_tpu_torch/csrc/ternary_matmul.cu"
    assert spec.replaces == "experiments/exp_w2a8.py:201"
    spec, = [s for s in registry.REGISTRY if s.kernel_id == "int8_dot"]
    assert spec.source == "bitnet_tpu_torch/csrc/exp_w2a8.cu"


@pytest.mark.parametrize("name", _cuda.SOURCES)
def test_c_entry_points_match_their_ctypes_signatures(name):
    """Each ``extern "C"`` entry point of a source has a ctypes signature
    with as many arguments, and each signature an entry point: a drift
    between the two would pass pointers into the wrong parameters on the
    card, where nothing here can compile the source."""
    src = (_cuda.CSRC / f"{name}.cu").read_text()
    src = src[src.index('extern "C" {'):]
    found = {}
    for fn, params in re.findall(r"^int (bn_\w+)\(([^)]*)\)\s*\{", src, re.M | re.S):
        found[fn] = len([p for p in params.split(",") if p.strip()])
    want = {fn: len(args) for fn, args in _cuda.SIGNATURES[name].items()}
    assert found == want
    assert re.search(rf"^const char\* bn_{name}_error\(int code\)", src, re.M)
