"""The W2A8 probes and prototype on the card (K28–K32), as the script runs them.

Counterpart of ``experiments/exp_w2a8.py``, whose four Mosaic probes asked
whether a TPU could run the W2A8 building blocks and whose prototype
``w2a8_matmul`` became the JAX package's W2A8 kernels.  On the card the
probes ask whether the facts behind K1's word layout hold; the kernels and
their plain versions are in :mod:`bitnet_tpu_torch.ops.w2a8_probes`:

- P1 on K28 (``bitcast_i32_to_i8``): the byte order of an int32 word read
  as 4 int8 by dp4a; row 4s+j must hold byte j of word row s
  (``ROW-MAJOR-LE``).
- P2 on K29 (``int8_dot``): exact int8 × int8 → int32 products through
  ``__dp4a`` and through the tensor cores' ``mma.sync`` m16n8k32 s8, at
  (128×256)·(256×256) and M = 16.
- P3 on K30 (``bytes_to_bf16``): the bytes as int8, converted to bf16.
- P4 on K31 (``unpack_words``): the shift / mask / bias chain against
  ``pack_w2a8_host``.
- P5 on K32 (``w2a8_matmul``): the prototype GEMM with a per-tensor scale
  on the int8 tensor cores, its cosine against K6 (``ternary_matmul_bf16``,
  the bf16-exact path the script compares with) at the script's shape (K =
  2560, N = 13824, M = 1), and its time beside K6's and K1's through
  :func:`~bitnet_tpu_torch.obs.timing.chain_timer`, with the card's name
  and power limit.

The script's sweep of TPU tile shapes (``bn``, ``bkt``) has no counterpart:
those tiles select nothing on the card.

Run: ``python -m bitnet_tpu_torch.experiments.exp_w2a8 [--device cpu]``.
Each probe prints its lines as the script does; a failed probe prints
``FAIL`` and the run exits 1.  On the CPU every wrapper runs its plain
version and P5 times nothing.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import traceback

import numpy as np
import torch

from ..device_probe import resolve_device
from ..obs.timing import chain_timer
from ..ops.w2a8_probes import (bitcast_i32_to_i8, bytes_to_bf16,
                               bytes_to_bf16_plain, int8_dot, int8_dot_plain,
                               pack_w2a8_host, unpack_words, w2a8_matmul)

L2_CYCLE_BYTES = 120 << 20       # what a timed chain cycles through (> 50 MB L2)
P5_K, P5_N = 2560, 13824         # the script's P5 shape: the 2B fused gate|up


def say(*a):
    print(*a, flush=True)


def run(name, fn, *args):
    """Run one probe; print ``FAIL`` and the traceback's tail if it raises."""
    try:
        fn(*args)
    except Exception as e:  # a probe's failure is its result: report, go on
        say(f"{name}: FAIL {type(e).__name__}: {str(e)[:500]}")
        tb = traceback.format_exc().splitlines()
        say("  " + "\n  ".join(tb[-4:]))
        return False
    return True


# --------------------------------------------------------------------------
# the probes (the script's inputs, from the same numpy seeds)
# --------------------------------------------------------------------------
def p1_inputs() -> np.ndarray:
    words = np.zeros((16, 128), np.uint32)
    for s in range(16):
        v = 0
        for j in range(4):
            v |= (4 * s + j) << (8 * j)
        words[s, 0] = v
        words[s, 1] = v  # second lane identical
    return words.view(np.int32)


def p2_inputs():
    """(a [128, 256], b [256, 256], a2 [16, 256]) int8."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, size=(128, 256)).astype(np.int8)
    b = rng.integers(-4, 5, size=(256, 256)).astype(np.int8)
    a2 = rng.integers(-127, 128, size=(16, 256)).astype(np.int8)
    return a, b, a2


def p3_inputs() -> np.ndarray:
    words = np.arange(16 * 128, dtype=np.uint32).reshape(16, 128) & 0x7F7F7F7F
    return words.view(np.int32)


def p4_inputs():
    """(codes [256, 128] uint8, their words [16, 128] int32)."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=(256, 128)).astype(np.uint8)
    return codes, pack_w2a8_host(codes)


def p1_bitcast_order(dev):
    out = bitcast_i32_to_i8(torch.from_numpy(p1_inputs()).to(dev))
    col = out[:, 0].cpu().numpy()
    say(f"P1 bitcast i32->i8 OK; order col0={col.tolist()}")
    ok = bool((col == np.arange(64)).all())
    say(f"P1 ordering {'ROW-MAJOR-LE' if ok else 'OTHER'}")
    if not ok:
        raise AssertionError("the bytes of a word are not in little-endian row order")


def p2_int8_dot(dev):
    a, b, a2 = (torch.from_numpy(t).to(dev) for t in p2_inputs())
    wrong = []
    for label, lhs in (("(128x256x256)", a), ("M=16", a2)):
        ref = int8_dot_plain(lhs.cpu(), b.cpu())
        for unit in ("dp4a", "mma"):
            ok = torch.equal(int8_dot(lhs, b, unit).cpu(), ref)
            say(f"P2 int8 dot {label} {unit}: {'EXACT' if ok else 'WRONG'}")
            if not ok:
                wrong.append(f"{label} {unit}")
    if wrong:
        raise AssertionError(f"inexact int8 products: {wrong}")


def p3_i8_to_bf16(dev):
    words = torch.from_numpy(p3_inputs())
    out = bytes_to_bf16(words.to(dev)).cpu()
    say(f"P3 i8->bf16 convert OK; sample={out[:3, :2].float().tolist()}")
    if not torch.equal(out, bytes_to_bf16_plain(words)):
        raise AssertionError("the i8 -> bf16 conversion differs from the bitcast")


def p4_unpack_chain(dev):
    codes, words = p4_inputs()
    out = unpack_words(torch.from_numpy(words).to(dev)).cpu().numpy()
    biased = codes + (codes >> 1)   # {0,1,3,4}
    ok = bool((out == biased).all())
    say(f"P4 full unpack chain vs host: {'EXACT' if ok else 'WRONG'}")
    if not ok:
        say(f"   got[:16]={out[:16, 0].tolist()} want={biased[:16, 0].tolist()}")
        raise AssertionError("the unpack chain does not invert pack_w2a8_host")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def p5_correctness_and_timing(dev) -> dict:
    """K32 against K6 at [1, K] × [K, N] (the script's fused gate|up), then
    on the card K32's, K6's and K1's device µs a call."""
    from ..ops.linear import (TernaryLinear, qk256_linear_from_codes,
                              with_col_scales)
    from ..ops.ternary_matmul import ternary_matmul_pallas

    K, N = P5_K, P5_N
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(K, N)).astype(np.uint8)
    scale = 0.02
    x = rng.standard_normal((1, K)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).to(dev)
    lin = with_col_scales(qk256_linear_from_codes(codes, scale)).to(dev)
    y_ref = ternary_matmul_pallas(lin, xb).double().cpu()[0]   # K6, bf16-exact
    words = torch.from_numpy(pack_w2a8_host(codes)).to(dev)
    bn = 2304 if N % 2304 == 0 else N
    bkt = 2 if K % 512 == 0 else 1
    y = w2a8_matmul(xb, words, scale, bm=16, bn=bn, bkt=bkt).double().cpu()[0]
    cos = float(torch.dot(y_ref, y) / (y_ref.norm() * y.norm() + 1e-30))
    rel = float((y - y_ref).abs().max() / (y_ref.abs().max() + 1e-30))
    say(f"P5 w2a8 vs bf16-exact cosine = {cos:.6f} (max rel err {rel:.4f})")
    res = {"K": K, "N": N, "cosine": cos, "max_rel_err": rel}
    if dev.type != "cuda":
        say("P5 timing: not measured (device times come from the card)")
        return res

    n = max(2, math.ceil(L2_CYCLE_BYTES / (K * N // 4)))   # cycle past the L2
    wstack = torch.stack([words] * n)
    lstack = with_col_scales(TernaryLinear(
        kind="qk256", k=K, n=N, packed=torch.stack([lin.packed] * n),
        scales=torch.full((n,), scale, dtype=torch.float32, device=dev)))

    def timed(fn):
        def step(c, i):
            return (fn(c, i)[:, :K] * 1e-3).to(torch.bfloat16)

        def mk(salt):
            g = torch.Generator(device=dev).manual_seed(salt)
            return torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
        return chain_timer(step, mk, 512, 128, pairs=3)

    t6 = timed(lambda c, i: ternary_matmul_pallas(lstack, c, "pallas", layer=i % n))
    say(f"P5 timing K6 bf16 kernel     ({K}x{N}): {t6 * 1e6:.1f} us")
    t1 = timed(lambda c, i: ternary_matmul_pallas(lstack, c, "w2a8", layer=i % n))
    say(f"P5 timing K1 w2a8 kernel     ({K}x{N}): {t1 * 1e6:.1f} us")
    t32 = timed(lambda c, i: w2a8_matmul(c, wstack[i % n], scale, bn=bn, bkt=bkt))
    say(f"P5 timing K32 w2a8 wgmma kernel ({K}x{N}): {t32 * 1e6:.1f} us "
        f"({t6 / t32:.2f}x K6, {t1 / t32:.2f}x K1)")
    card = card_line()
    say(f"P5 card: {card}")
    res.update(us_k6=t6 * 1e6, us_k1=t1 * 1e6, us_k32=t32 * 1e6, card=card)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say(f"device={dev} torch={torch.__version__}")
    ok = [run("P1", p1_bitcast_order, dev)]
    ok.append(run("P2", p2_int8_dot, dev))
    ok.append(run("P3", p3_i8_to_bf16, dev))
    if ok[0]:
        ok.append(run("P4", p4_unpack_chain, dev))
        if ok[-1]:
            ok.append(run("P5", p5_correctness_and_timing, dev))
    say("DONE")
    return 0 if all(ok) and len(ok) == 5 else 1


if __name__ == "__main__":
    sys.exit(main())
