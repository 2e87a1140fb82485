"""The W2A8 probes and prototype (K28–K32, ``bitnet_tpu_torch.experiments
.exp_w2a8``) against ``experiments/exp_w2a8.py``'s own Pallas calls, run
under ``pltpu.force_tpu_interpret_mode()`` on the CPU.

The script is loaded from its file (the port never imports it).  A spy on
its ``pl`` records the inputs and the output of each ``pl.pallas_call``;
the port's plain versions take the same inputs and must give the same
arrays bit for bit (P1–P4), and the port's input builders must give the
script's inputs.  K32's plain version is held to ``w2a8_matmul``: its int8
codes and row sums equal the operands the Pallas kernel received, its
per-row scale times the per-tensor one equals the kernel's ``sx``
operand, and the output is bit for bit the kernel's (both take one exact
int32 sum and the same two f32 products, rounded once to bf16).
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from bitnet_tpu_torch.experiments import exp_w2a8 as ew
from bitnet_tpu_torch.ops import w2a8_probes as wp
from bitnet_tpu_torch.ops import registry
from bitnet_tpu_torch.ops.linear import fold_packed_words, repack_codes

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "experiments" / "exp_w2a8.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("exp_w2a8_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def spy(script, monkeypatch):
    """Replace the script's ``pl`` by one whose ``pallas_call`` records
    (inputs, output) of every call."""
    real = script.pl
    calls = []

    def pallas_call(*a, **kw):
        fn = real.pallas_call(*a, **kw)

        def run(*args):
            out = fn(*args)
            calls.append(([np.array(x) for x in args], out))
            return out
        return run

    proxy = SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                               if not k.startswith("__")})
    proxy.pallas_call = pallas_call
    monkeypatch.setattr(script, "pl", proxy)
    return calls


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_p1_p3_bitcasts_match_the_script(script, spy, capsys):
    with pltpu.force_tpu_interpret_mode():
        script.p1_bitcast_order()
        script.p3_i8_to_bf16()
    assert "P1 ordering ROW-MAJOR-LE" in capsys.readouterr().out
    (p1_in, p1_out), (p3_in, p3_out) = spy
    np.testing.assert_array_equal(p1_in[0], ew.p1_inputs())
    np.testing.assert_array_equal(p3_in[0], ew.p3_inputs())
    got1 = wp.bitcast_i32_to_i8(torch.from_numpy(p1_in[0]))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(p1_out))
    got3 = wp.bytes_to_bf16(torch.from_numpy(p3_in[0]))
    np.testing.assert_array_equal(got3.view(torch.int16).numpy(), _bits(p3_out))


def test_p2_int8_dots_match_the_script(script, spy, capsys):
    with pltpu.force_tpu_interpret_mode():
        script.p2_int8_dot()
    assert capsys.readouterr().out.count("EXACT") == 2
    want_in = ew.p2_inputs()
    for (args, out), lhs in zip(spy, (want_in[0], want_in[2])):
        np.testing.assert_array_equal(args[0], lhs)
        np.testing.assert_array_equal(args[1], want_in[1])
        a, b = torch.from_numpy(args[0]), torch.from_numpy(args[1])
        for unit in ("dp4a", "mma"):
            np.testing.assert_array_equal(wp.int8_dot(a, b, unit).numpy(),
                                          np.asarray(out))


def test_p4_unpack_chain_matches_the_script(script, spy, capsys):
    with pltpu.force_tpu_interpret_mode():
        script.p4_unpack_chain()
    assert "P4 full unpack chain vs host: EXACT" in capsys.readouterr().out
    (args, out), = spy
    codes, words = ew.p4_inputs()
    np.testing.assert_array_equal(args[0], words)
    got = wp.unpack_words(torch.from_numpy(args[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    np.testing.assert_array_equal(got.numpy(), codes + (codes >> 1))


@pytest.mark.parametrize("K,N", [(256, 128), (512, 384)])
def test_pack_w2a8_host_is_the_scripts_and_k1s_layout(script, K, N):
    codes = np.random.default_rng(K + N).integers(0, 4, (K, N)).astype(np.uint8)
    port = wp.pack_w2a8_host(codes)
    np.testing.assert_array_equal(port, script.pack_w2a8_host(codes))
    np.testing.assert_array_equal(port, fold_packed_words(repack_codes(codes)))


# six interpreted calls (~2 s each): M in {1, 3, 17} (one and two 16-row
# tiles), K in {256, 512}, N = 256, f32 and bf16 x
@pytest.mark.parametrize("M,K,xdt", [(1, 256, "f32"), (3, 512, "bf16"),
                                     (17, 256, "bf16"), (1, 512, "bf16"),
                                     (3, 256, "f32"), (17, 512, "f32")])
def test_k32_plain_matches_w2a8_matmul(script, spy, M, K, xdt):
    N, scale = 256, 0.02
    rng = np.random.default_rng(M * K)
    codes = rng.integers(0, 4, (K, N)).astype(np.uint8)
    x = (rng.standard_normal((M, K)) * rng.uniform(0.1, 3.0, (M, 1))).astype(np.float32)
    jdt = jnp.float32 if xdt == "f32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    words = script.pack_w2a8_host(codes)
    bkt = K // 256
    with pltpu.force_tpu_interpret_mode():
        want = script.w2a8_matmul(jx, jnp.asarray(words), scale, bn=N, bkt=bkt)
    (kq, kw, ksumq, ksxs), _ = spy[0]
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.float32 if xdt == "f32" else torch.bfloat16)
    xq, sx, sumq = wp.w2a8_quantize_plain(tx, 16 * -(-M // 16))
    np.testing.assert_array_equal(xq.numpy(), kq)             # the codes
    np.testing.assert_array_equal(sumq.numpy(), ksumq[:, 0])  # their sums
    np.testing.assert_array_equal(
        (sx * torch.tensor(scale, dtype=torch.float32)).numpy(), ksxs[:, 0])
    got = wp.w2a8_matmul(tx, torch.from_numpy(words), scale, bn=N, bkt=bkt)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), _bits(want))


def test_w2a8_matmul_refuses_what_the_tpu_kernel_leaves_uncomputed():
    """``N % bn`` leaves columns uncomputed (NaN in interpret mode) and
    ``K % (256·bkt)`` drops K rows: the port refuses both."""
    words = torch.zeros((512 // 16, 384), dtype=torch.int32)
    x = torch.randn((1, 512))
    with pytest.raises(ValueError, match="uncomputed"):
        wp.w2a8_matmul(x, words, 0.02, bn=256, bkt=1)
    with pytest.raises(ValueError, match="uncomputed"):
        wp.w2a8_matmul(x, words, 0.02, bn=128, bkt=4)
    assert wp.w2a8_matmul(x, words, 0.02, bn=128, bkt=2).shape == (1, 384)


def test_main_runs_every_probe_on_the_cpu(capsys):
    registry.reset_launch_counts()
    assert ew.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "P1 ordering ROW-MAJOR-LE" in out
    assert out.count("EXACT") == 5 and "FAIL" not in out and "DONE" in out
    cos = float(out.split("cosine = ")[1].split()[0])
    assert cos >= 0.99
    assert all(n == 0 for n in registry.launch_counts().values())


def test_the_entry_point_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from bitnet_tpu_torch.errors import ConfigError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        ew.main([])
