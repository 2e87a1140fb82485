"""Where the µs of one K1 or K11 call go on the card, from ``%globaltimer``
stamps in an instrumented copy of the kernel, and the gap between launches
in a CUDA-graph chain, from ``torch.profiler``.

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.k1_timeline [--force COLS] [--kernel K1|K11]

It copies ``csrc/`` into ``csrc/build/k1_timeline/`` (git-ignored, through
``_timeline``), inserts a stamp at each phase boundary of K1's decode
kernel, builds that copy, and prints, for K1 (qk256 words, a scale a
column) and for K11 (the same kernel in its block-scale mode: TL words and
a scale a 32-row block) at M=1 on the 2B o (2560 x 2560, norm, residual)
and gate|up (2560 x 13824, norm) projections and on the 8B down projection
(14336 x 4096, SwiGLU, residual), three calls' stamps in µs from the first
block's start, for the first block and for the block that finished last,
with the card's name and power limit.  Stamps, per block:

  start        the block's first instruction
  wait         griddepcontrol.wait returned (the launch before has ended)
  preamble     the int8 rows, their scales and sums are in shared memory
  first words  the dot's first wait on the words returned
  last words   the dot's last wait on the words returned
  end          the block's outputs are written

(the row kernel of a two-kernel call stamps its own start and end; the
stamps are thread 0's, so K11's are those of warps 0-7, the even stages).
``--force`` sets the decode form's column block past ``w2a8_decode_plan``;
``--kernel`` keeps one of the two.  Then the same calls, eight layers
captured in one CUDA graph and replayed under the profiler, give each
launch's device µs and the gap from one kernel's end to the next one's
start (negative where the next starts early, as a programmatic dependent).

The committed kernel carries no stamp; ``ANCHORS`` are the source lines the
stamps go beside (a CPU test holds them to the source).
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics

import torch

from ..device_probe import require_sm90
from ..ops import ternary_matmul as tm
from . import _timeline

START, WAIT, PRE, FIRST, LAST, END = range(6)
NAMES = ("start", "wait", "preamble", "first_words", "last_words", "end")
SLOTS = 16                     # stamps a block
MAX_BLOCKS = 8192

# (anchor, stamp, before the anchor?) in csrc/ternary_matmul.cu: slots 0-5
# as NAMES, 6-13 the preamble's and the epilogue's steps (FINE)
ANCHORS = (
    ("  __shared__ int part[MB][COLS];\n", "  BN_T(0);\n", True),
    ("    grid_dependency_wait();               // x, resid and out: after the launch before\n",
     "    BN_T(1);\n", False),
    ("    // the dot: each word once, from the ring.", "    BN_T(2);\n", True),
    ("      mbar_wait(&full[slot], (s / nst) & 1);\n",
     "      if (s == 0) BN_T(3);\n      BN_T(4);\n", False),
    ("    store_f32(a.out, (size_t)emm * a.N + en, y);\n  }\n",
     "  __syncthreads();\n  BN_T(5);\n", False),
    ("    if (norm) {                           // RMSNorm: (x * rsqrt(mean + eps)) * g\n",
     "    BN_F(6, v[0][0]);\n", True),
    ("      mbar_wait(gbar, 0);\n", "      BN_T(7);\n", False),
    ("      dec_reduce<MB>(ss, redf, false);\n", "      BN_T(8);\n", True),
    ("      dec_reduce<MB>(ss, redf, false);\n", "      BN_T(9);\n", False),
    ("    dec_reduce<MB>(am, redf, true);\n", "    BN_T(10);\n", False),
    ("    consumers_sync();                     // the int8 rows are in place\n",
     "    BN_T(11);\n", True),
    ("      else atomicAdd(&part[mm][col], acc[mm]);\n    }\n  }\n",
     "  BN_T(12);\n", False),
    ("  if (eout) {\n    float y;\n", "  BN_T(13);\n", True),
    ("  extern __shared__ float row[];         // K floats\n", "  BN_Q(0);\n", True),
    ("    sx_out[m] = sx;\n    sumq_out[m] = sq;\n  }\n", "  BN_Q(1);\n", False),
)
FINE = ("x_loaded", "gamma_in_hand", "squares_summed", "norm_scale", "row_max",
        "rows_quantized", "dot_done", "partials_met")
STAMPS = """
__device__ unsigned long long bn_stamps[%(blocks)d * %(slots)d];
__device__ unsigned long long bn_qstamps[128];
#define BN_BLOCK (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define BN_T(k) do { if (threadIdx.x == 0) bn_stamps[BN_BLOCK * %(slots)d + (k)] = bn_now(); } \\
  while (0)
#define BN_Q(k) do { if (threadIdx.x == 0) bn_qstamps[blockIdx.x * 2 + (k)] = bn_now(); } \\
  while (0)
#define BN_F(k, v) do { if (threadIdx.x == 0) { asm volatile("" :: "f"(v)); BN_T(k); } } \\
  while (0)
""" % {"blocks": MAX_BLOCKS, "slots": SLOTS}
READ = "bn_k1_stamps"
# (name, K, N, gamma, glu, resid) at M=1
CASES = (("2B o", 2560, 2560, True, False, True),
         ("2B gate_up", 2560, 13824, True, False, False),
         ("8B down", 14336, 4096, False, True, True))


def instrumented_source(src: str) -> str:
    """``src`` with the stamps in place; raises if an anchor is missing."""
    return _timeline.instrument(src, ANCHORS, STAMPS,
                                _timeline.reader(READ, ("bn_stamps", "bn_qstamps")),
                                "k1_timeline")


def _operands(dev, g, kernel, K, N, has_g, glu, has_r):
    """A stack of enough layers that each call finds its words (and K11's
    block scales) cold (past the 50 MB L2), one row of x (and of resid), and
    the call of layer l."""
    per_layer = K * N // 4 + (K * N // 8 if kernel == "K11" else 0)
    L = max(2, math.ceil((120 << 20) / per_layer))
    w = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32, generator=g,
                      device=dev)
    if kernel == "K11":
        s = (torch.rand((L, K // 32, N), generator=g, device=dev) * 0.02 + 0.01
             ).half().float()
    else:
        s = (torch.rand((L, N), generator=g, device=dev) + 0.5) * 0.02
    gam = (torch.rand((L, K), generator=g, device=dev) + 0.5) if has_g else None
    x = torch.randn((1, 2 * K if glu else K), generator=g, device=dev).bfloat16()
    r = torch.randn((1, N), generator=g, device=dev).bfloat16() if has_r else None
    fn = (tm.ternary_matmul_tl_w2a8_normed if kernel == "K11"
          else tm.ternary_matmul_w2a8_normed)

    def call(l):
        return fn(l, x, w, s, gam, K, N, 1e-5, glu, r)
    return L, call


def summarize(stamps, qstamps) -> dict:
    """µs from the first block's (or row kernel's) start: the first block's
    stamps and those of the block that ended last."""
    blocks = [b for b in range(MAX_BLOCKS) if stamps[b * SLOTS + START]]
    rows = [q for q in range(64) if qstamps[2 * q]]
    t0 = min([stamps[b * SLOTS + START] for b in blocks]
             + [qstamps[2 * q] for q in rows])

    def us(t):
        return round((t - t0) / 1e3, 3) if t else None
    last = max(blocks, key=lambda b: stamps[b * SLOTS + END])
    out = {"blocks": len(blocks),
           "block_0": {name: us(stamps[k]) for k, name in enumerate(NAMES + FINE)
                       if stamps[k]},
           "last_block": {"id": last, **{name: us(stamps[last * SLOTS + k])
                                          for k, name in enumerate(NAMES + FINE)
                                          if stamps[last * SLOTS + k]}},
           "starts_us": [us(min(stamps[b * SLOTS] for b in blocks)),
                         us(max(stamps[b * SLOTS] for b in blocks))]}
    if rows:
        out["row_kernel"] = {"start": us(min(qstamps[2 * q] for q in rows)),
                             "end": us(max(qstamps[2 * q + 1] for q in rows))}
    return out


def chain_gaps(call, L: int, n: int = 8) -> dict:
    """``n`` calls (layers cycled) captured in one CUDA graph, replayed three
    times under the profiler: each K1 kernel's device µs and the gap from
    one kernel's end to the next one's start, in µs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            call(i % L)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "w2a8" in e.name), key=lambda e: e.time_range.start)
    if not ev:
        return {"events": 0}
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(ev, ev[1:])]
    durs = [e.time_range.end - e.time_range.start for e in ev]
    names = {e.name.replace("(anonymous namespace)::", "").replace("void ", "")
             .split("(")[0][-40:] for e in ev}
    return {"events": len(ev), "kernels": sorted(names),
            "device_us_median": round(statistics.median(durs), 3),
            "gap_us_median": round(statistics.median(gaps), 3),
            "gap_us_min": round(min(gaps), 3), "gap_us_max": round(max(gaps), 3)}


def main(argv=None) -> None:
    import argparse
    from unittest import mock

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--force", type=int, default=0,
                    help="COLS: the decode form's column block, forced")
    ap.add_argument("--kernel", choices=("K1", "K11"), default=None,
                    help="time one of K1 and K11 (default: both)")
    args = ap.parse_args(argv)
    if args.force:
        mock.patch.object(tm, "w2a8_decode_plan", lambda *a: args.force).start()
    require_sm90(0)
    dev = torch.device("cuda", 0)
    smi = _timeline.card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [(f"{kernel} {name}", *_operands(dev, g, kernel, K, N, hg, glu, hr),
              tm.w2a8_decode_plan(1, K, N, sms))
             for kernel in ("K1", "K11") if args.kernel in (None, kernel)
             for name, K, N, hg, glu, hr in CASES]
    # the uninstrumented kernel first: the chain's gaps
    for name, L, call, pl in cases:
        for i in range(2):
            call(i % L)
        torch.cuda.synchronize()
        print(json.dumps({"case": f"{name} M=1 chain", "card": smi, "plan": pl,
                          **chain_gaps(call, L)}), flush=True)
    # the wrappers launch the instrumented copy
    lib = _timeline.build("ternary_matmul", "k1_timeline", instrumented_source, READ)
    stamps = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
    qstamps = (ctypes.c_ulonglong * 128)()

    def read(clear):
        _timeline.read(lib, "ternary_matmul", READ, (stamps, qstamps), clear)
    for name, L, call, pl in cases:
        for i in range(2):                            # build, warm up
            call(i % L)
        torch.cuda.synchronize()
        for i in range(3):
            read(True)
            call(i % L)
            torch.cuda.synchronize()
            read(False)
            print(json.dumps({"case": f"{name} M=1", "card": smi, "plan": pl, "call": i,
                              **summarize(stamps, qstamps)}), flush=True)


if __name__ == "__main__":
    main()
