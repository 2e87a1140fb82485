"""The phases of one split-S decode-attention call on the card, from
``%globaltimer`` stamps in an instrumented copy of the kernel.

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.attn_timeline

It copies ``csrc/`` into ``csrc/build/timeline/`` (git-ignored, through
``_timeline``), inserts a stamp at each phase boundary of ``attn_decode`` (block (0, 0, 0): the pos
read, each stage's TMA issue and each stage's k / v arrival as its first
consumer warp sees them, the split's merge and publish; the block that
combines (b, kv head) = (0, 0): its count, weights and output), builds that
copy, and prints, for K5 at B=1, S=4096 and S=1024 and K9 (int8) at B=8,
S=1024 (20 / 5 heads of 128, S - 1 rows cached), three calls' stamps in µs
from block (0, 0, 0)'s start, with the card's name and power limit.  The
committed kernel carries no stamp; ``ANCHORS`` are the source lines the
stamps go beside (a CPU test holds them to the source).
"""

from __future__ import annotations

import ctypes
import json

import torch

from ..device_probe import require_sm90
from ..ops import decode_attention as dk
from ..ops import decode_attention_v2 as da
from . import _timeline

# (anchor, stamp, before the anchor?): stamps 0..39 are block (0, 0, 0)'s,
# 64.. those of the block that combines (b, kv head) = (0, 0)
ANCHORS = (
    ("  const int p = min(a.pos[b], S);\n", "  if (threadIdx.x == 0) BN_T(0);\n", True),
    ("  const int live = max(1, (p + a.R - 1) / a.R);          // split 0 always runs\n",
     "  if (threadIdx.x == 0) BN_T(1);\n", False),
    ("    for (int i = 0; i < nst; ++i) {\n      const int s = i % NST;\n",
     "      if (lane == 0) BN_T(2 + i);\n", False),
    ("    if constexpr (MMA) {\n      // the tensor cores", "    if (tid == 0) BN_T(20);\n",
     True),
    ("          mbar_wait(&full_k[s], par);\n          // every fragment",
     "          if (tid == 0) BN_T(21 + 2 * i);\n", True),
    ("          mbar_wait(&full_v[s], par);\n          // the warp's v rows",
     "          if (tid == 0) BN_T(22 + 2 * i);\n", True),
    ("  __syncthreads();                                       // the ring is free\n",
     "  if (tid == 0) BN_T(40);\n", False),
    ("  // more than one split: the last to arrive combines\n", "  if (tid == 0) BN_T(41);\n",
     False),
    ("    if (!last_s) return;\n", "    if (tid == 0) BN_C(0);\n", False),
    ("  // each head: the common max, the partials' weights", "  if (tid == 0) BN_C(1);\n", True),
    ("  // out: a thread for each 4 elements of a head", "  if (tid == 0) BN_C(2);\n", True),
    ("      store_f32(out, ((size_t)b * a.H + h * G + g) * D + d0 + e, c[e] / den);\n  }\n",
     "  __syncthreads();\n  if (tid == 0) BN_C(3);\n", False),
)
STAMPS = """
__device__ unsigned long long bn_stamps[128];
#define BN_T(k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) \\
  bn_stamps[k] = bn_now(); } while (0)
#define BN_C(k) do { if (blockIdx.y == 0 && blockIdx.z == 0) bn_stamps[64 + (k)] = bn_now(); } \\
  while (0)
"""
READ = "bn_attn_stamps"


def instrumented_source(src: str) -> str:
    """``src`` with the stamps in place; raises if an anchor is missing."""
    return _timeline.instrument(src, ANCHORS, STAMPS, _timeline.reader(READ, ("bn_stamps",)),
                                "attn_timeline")


def main() -> None:
    require_sm90(0)
    dev = torch.device("cuda", 0)
    smi = _timeline.card()
    # the wrappers launch the instrumented copy
    lib = _timeline.build("decode_attention", "timeline", instrumented_source, READ)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, D, L = 20, 5, 128, 4
    for name, B, S in (("K5", 1, 4096), ("K5", 1, 1024), ("K9 int8", 8, 1024)):
        quant = name.startswith("K9")
        if quant:
            kc, vc = (torch.randint(-127, 128, (L, B, S, KV * D), generator=g, device=dev
                                    ).to(torch.int8) for _ in range(2))
            ks, vs = (torch.rand((L, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
                      for _ in range(2))
        else:
            kc, vc = (torch.randn((L, B, S, KV * D), generator=g, device=dev).bfloat16()
                      for _ in range(2))
        q, kn, vn = (torch.randn(s, generator=g, device=dev).bfloat16()
                     for s in ((B, H, D), (B, KV, D), (B, KV, D)))
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)

        def call(l):
            if quant:
                return da.decode_attention_quant_batched(l, q, kn, vn, kc, vc, ks, vs, pos)
            return dk.decode_attention(l, q, kn, vn, kc, vc, pos)
        for i in range(2 * L):                       # build, warm up
            call(i % L)
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 128)()
        for i in range(3):
            call(i % L)
            torch.cuda.synchronize()
            _timeline.read(lib, "decode_attention", READ, (stamps,), False)
            t0 = stamps[0]
            # a stamp this call did not write is older than its start
            us = {k: round((stamps[k] - t0) / 1e3, 3) for k in range(128)
                  if stamps[k] >= t0}
            print(json.dumps({"case": f"{name} B={B} S={S}", "card": smi,
                              "R": dk.attn_plan(B, KV, S, sms, kc.element_size()),
                              "us": us}))


if __name__ == "__main__":
    main()
