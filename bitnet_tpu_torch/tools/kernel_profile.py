"""Device time of each CUDA kernel behind the four wrappers, at the main
path's bitnet-b1.58-2B-4T shapes, from ``torch.profiler`` (CUPTI).

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.kernel_profile [--only K6,K10]
    python -m bitnet_tpu_torch.tools.kernel_profile --only K11

It splits what ``chip_smoke.py`` times per wrapper into the kernels that
ran (K1 at the 2B fused four, M = 1, 2, 8 and 64: its one-launch decode
form at M <= 2, the row kernel and the GEMM above; at the generic seven and
the 8B fused four, M = 1 and 2; the ``K1 tiles`` cases force every column
block of its decode form past ``w2a8_decode_plan`` at M=1 on the 2B and 8B
fused four and the generic k, the plan's marked; K1's stacks hold enough layers
to stream past the 50 MB L2 (``fn.layers``); K11, K1's decode kernel in its
block-scale mode, at the 2B and 8B fused four, M = 1 and 2, and in every
column block at M=1 (the ``K11 tiles`` cases, the plan's marked); K4's row
quantization and
wgmma GEMM at M = 8, 512
and 2048; K10's GEMM form, its row kernel and block-scale GEMM, and K12,
its preamble and the same GEMM unbiased, at M = 8, 512 and 2048, beside
the f32 correction matmul K10's GEMM form no longer runs; K6 at the generic
path's seven shapes, its decode form at M = 1 and its row kernel and GEMM
at M = 512; K24's four launches at the 8B FFN, H = 4096,
F = 14336, at M = 1 and 32; K29 through both units at the P2 probe's
(128×256)·(256×256); K32's row kernel and GEMM at K = 2560, N = 13824, M = 1
and 16) and prints one JSON line per case with the card's name and power
limit.  The split-S decode attention at the 2B heads (K2, K5, K7 int8 at
B = 1, S = 1024 and 4096; K8, K9 int8 at B = 8, S = 1024) is one kernel a
call; the ``attn tiles`` cases time K5 (bf16) and K15 (int8) in every split
size R = 64 .. 1024, forced past ``attn_plan``, at (B, S) = (1, 4096), (2, 4096), (8, 1024) and
(64, 1024), the plan's R marked.  The ``K6 tiles`` cases time K6's GEMM form at
M = 128, 512 and 2048 in BT = 32, 64 and 128 rows a block and K splits of 1,
2 and 4, forced past ``blockscale_gemm_plan`` (the table its choice rests
on).  ``--only`` keeps the cases whose names start with one of the given
prefixes.  Weights and caches cycle over 8 layers.  ``call_us`` is a
call's device time (CUDA-graph replays between CUDA events); a kernel's
device µs can overlap the next one's where the next is a programmatic
dependent (K4's and K32's GEMM, K24's launches), so they need not sum to
it.  The ``K24 plans`` cases force K24's gate|up split and down cluster
past ``ffn_plan``; the ``K32 tiles`` cases force K32's BT (8, 16, 32, at
least M) and K split (1, 2, 4, 8) past ``w2a8_gemm_plan`` at M = 1 and 16.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

from ..device_probe import require_sm90
from ..ops import _cuda
from ..ops import decode_attention as dk
from ..ops import decode_attention_v2 as da
from ..ops import ffn_fused as ff
from ..ops import ternary_matmul as tm
from ..ops import w2a8_probes as wp

SHAPES = (("qkv", 2560, 3840, False, False), ("o", 2560, 2560, False, True),
          ("gate_up", 2560, 13824, False, False), ("down", 6912, 2560, True, True))
# the generic path's seven unfused projections (K6 under --kernel-path pallas)
SEVEN = (("q", 2560, 2560), ("k", 2560, 640), ("v", 2560, 640), ("o", 2560, 2560),
         ("gate", 2560, 6912), ("up", 2560, 6912), ("down", 6912, 2560))
REPS, LAYERS = 40, 8


def _cases(dev, g):
    a = torch.randint(-127, 128, (128, 256), generator=g, device=dev).to(torch.int8)
    b = torch.randint(-4, 5, (256, 256), generator=g, device=dev).to(torch.int8)
    for unit in ("mma", "dp4a"):
        yield f"K29 {unit} (128x256)x(256x256)", lambda i, unit=unit: wp.int8_dot(a, b, unit)
    K, N = 2560, 13824                              # the script's P5 shape
    w32 = torch.randint(-2**31, 2**31, (LAYERS, K // 16, N), dtype=torch.int32,
                        generator=g, device=dev)
    for M in (1, 16):
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        yield f"K32 M={M}", lambda i, x=x: wp.w2a8_matmul(x, w32[i % LAYERS], 0.02,
                                                          bn=2304, bkt=2)
        for bt in (b_ for b_ in (8, 16, 32) if b_ >= M):
            for split in (1, 2, 4, 8):
                def call(i, x=x, plan=(bt, split)):
                    with mock.patch.object(wp, "w2a8_gemm_plan", lambda *a: plan):
                        return wp._w2a8_matmul_launch(x, w32[i % LAYERS], 0.02)
                yield f"K32 tiles M={M} BT={bt} split={split}", call
    for name, K, N, glu, res in SHAPES:
        w = torch.randint(-2**31, 2**31, (LAYERS, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
        sv = (torch.rand((LAYERS, N), generator=g, device=dev) + 0.5) * 0.02
        gam = torch.rand((LAYERS, K), generator=g, device=dev) + 0.5
        x = torch.randn((1, 2 * K if glu else K), generator=g, device=dev).bfloat16()
        r = torch.randn((1, N), generator=g, device=dev).bfloat16() if res else None
        for M in (8, 512, 2048):
            x4 = torch.randn((M, K), generator=g, device=dev).bfloat16()
            yield f"K4 {name} M={M}", lambda i, w=w, sv=sv, x4=x4, K=K, N=N: (
                tm.ternary_matmul_w2a8(i % LAYERS, x4, w, sv, K, N))
    yield from _k1_cases(dev, g)
    yield from _k11_cases(dev, g)
    for name, K, N, glu, res in SHAPES:            # bitnet32 / TL weights
        w = torch.randint(-2**31, 2**31, (LAYERS, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
        s = (torch.rand((LAYERS, K // 32, N), generator=g, device=dev) * 0.02 + 0.01)
        gam = torch.rand((LAYERS, K), generator=g, device=dev) + 0.5
        for M in (8, 512, 2048):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            # K10's GEMM form at any M (the wrapper takes its decode form at 8)
            yield f"K10 gemm {name} M={M}", lambda i, w=w, s=s, x=x, K=K, N=N: (
                tm._blockscale_gemm_cuda(i % LAYERS, x, w, s, K, N, False))
            x12 = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
            r = torch.randn((M, N), generator=g, device=dev).bfloat16() if res else None
            # K12 past its pools' 64 rows: the same launches, uncounted
            yield f"K12 {name} M={M}", lambda i, w=w, s=s, x=x12, K=K, N=N, glu=glu, r=r, gam=gam: (
                tm._tl_bf16_launch(i % LAYERS, x, w, s, gam, K, N, 1e-5, glu, r, False))
            if M > 8:
                sum32 = torch.randn((M, K // 32), generator=g, device=dev)
                yield f"K10 correction matmul {name} M={M}", lambda i, s=s, sum32=sum32: (
                    tm.blockscale_correction(sum32, s[i % LAYERS]))
    for name, K, N in SEVEN:
        w = torch.randint(-2**31, 2**31, (LAYERS, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
        sv = (torch.rand((LAYERS, N), generator=g, device=dev) + 0.5) * 0.02
        for M in (1, 512):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            yield f"K6 {name} M={M}", lambda i, w=w, sv=sv, x=x, K=K, N=N: (
                tm.ternary_matmul_bf16(i % LAYERS, x, w, sv, K, N))
        for M in (128, 512, 2048):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            for bt in (32, 64, 128):
                for split in (1, 2, 4):
                    def call(i, w=w, sv=sv, x=x, K=K, N=N, plan=(bt, split)):
                        with mock.patch.object(tm, "blockscale_gemm_plan", lambda *a: plan):
                            return tm._bf16_gemm_launch(i % LAYERS, x, w, sv, K, N)
                    yield f"K6 tiles {name} M={M} BT={bt} split={split}", call
    H, F = 4096, 14336                             # the 8B FFN (K24)
    gu = torch.randint(-2**31, 2**31, (LAYERS, H // 16, 2 * F), dtype=torch.int32,
                       generator=g, device=dev)
    sg = (torch.rand((LAYERS, 2 * F), generator=g, device=dev) + 0.5) * 0.02
    dw = torch.randint(-2**31, 2**31, (LAYERS, F // 16, H), dtype=torch.int32,
                       generator=g, device=dev)
    sd = torch.full((LAYERS, H), 0.02, device=dev)
    for M in (1, 32):
        x = torch.randn((M, H), generator=g, device=dev).bfloat16()
        yield f"K24 M={M}", lambda i, x=x: ff.ffn_w2a8_fused(i % LAYERS, x, gu, sg, dw, sd,
                                                             F, H)
        bt = ff.ffn_plan(M, H, F, H, 132)[0]
        for split, dsplit in ((1, 2), (1, 4), (1, 8), (2, 4)):
            def call(i, x=x, plan=(bt, split, dsplit)):
                with mock.patch.object(ff, "ffn_plan", lambda *a: plan):
                    return ff._ffn_launch(i % LAYERS, x, gu, sg, dw, sd, F, H)
            yield f"K24 plans M={M} BT={bt} split={split} dsplit={dsplit}", call
    yield from _attention_cases(dev, g)


# K1's shapes: (name, K, N, gamma, glu, resid, row counts); the 2B fused
# four, the generic seven, the 8B fused four (no sub-norms)
K1_CASES = (("qkv", 2560, 3840, True, False, False, (1, 2, 8, 64)),
            ("o", 2560, 2560, True, False, True, (1, 2, 8, 64)),
            ("gate_up", 2560, 13824, True, False, False, (1, 2, 8, 64)),
            ("down", 6912, 2560, True, True, True, (1, 2, 8, 64)),
            *((f"seven {n}", K, N, n in ("o", "down"), False, n in ("o", "down"), (1,))
              for n, K, N in SEVEN),
            ("8b qkv", 4096, 6144, True, False, False, (1, 2)),
            ("8b o", 4096, 4096, False, False, True, (1, 2)),
            ("8b gate_up", 4096, 28672, True, False, False, (1, 2)),
            ("8b down", 14336, 4096, False, True, True, (1, 2)))


def _k1_cases(dev, g):
    """K1 through its wrapper at ``K1_CASES``, over stacks of at least 120 MB
    of words, and its decode form in every column block at M=1 on the 2B
    and 8B fused four and the generic k."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, K, N, has_g, glu, res, Ms in K1_CASES:
        L = max(LAYERS, -(-(120 << 20) // (K * N // 4)))
        w = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
        sv = (torch.rand((L, N), generator=g, device=dev) + 0.5) * 0.02
        gam = torch.rand((L, K), generator=g, device=dev) + 0.5 if has_g else None
        for M in Ms:
            x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
            r = torch.randn((M, N), generator=g, device=dev).bfloat16() if res else None

            def call(i, w=w, sv=sv, gam=gam, x=x, r=r, K=K, N=N, glu=glu, L=L):
                return tm.ternary_matmul_w2a8_normed(i % L, x, w, sv, gam, K, N, 1e-5,
                                                     glu, r)
            call.layers = L
            yield f"K1 {name} M={M}", call
            if M != 1 or (name.startswith("seven") and name != "seven k"):
                continue
            planned = tm.w2a8_decode_plan(1, K, N, sms)
            for cols in (c for c in tm.W2A8_DECODE_COLS if N % c == 0):
                def forced(i, call=call, p=cols):
                    with mock.patch.object(tm, "w2a8_decode_plan", lambda *a: p):
                        return call(i)
                forced.layers = L
                mark = " (plan)" if cols == planned else ""
                yield f"K1 tiles {name} cols={cols}{mark}", forced


def _k11_cases(dev, g):
    """K11 (TL codes, block scales) through its wrapper at the 2B and 8B
    fused four of ``K1_CASES``, M = 1 and 2, over stacks of at least 120 MB
    of words and scales, and K1's decode kernel in its block-scale mode in
    every column block at M=1, forced past ``w2a8_decode_plan``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, K, N, has_g, glu, res, _Ms in K1_CASES:
        if name.startswith("seven"):
            continue
        L = max(LAYERS, -(-(120 << 20) // (K * N // 4 + K * N // 8)))
        w = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
        s = (torch.rand((L, K // 32, N), generator=g, device=dev) * 0.02 + 0.01)
        gam = torch.rand((L, K), generator=g, device=dev) + 0.5 if has_g else None
        for M in (1, 2):
            x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev).bfloat16()
            r = torch.randn((M, N), generator=g, device=dev).bfloat16() if res else None

            def call(i, w=w, s=s, gam=gam, x=x, r=r, K=K, N=N, glu=glu, L=L):
                return tm.ternary_matmul_tl_w2a8_normed(i % L, x, w, s, gam, K, N, 1e-5,
                                                        glu, r)
            call.layers = L
            yield f"K11 {name} M={M}", call
            if M != 1:
                continue
            planned = tm.w2a8_decode_plan(1, K, N, sms)
            for cols in (c for c in tm.W2A8_DECODE_COLS if N % c == 0):
                def forced(i, call=call, p=cols):
                    with mock.patch.object(tm, "w2a8_decode_plan", lambda *a: p):
                        return call(i)
                forced.layers = L
                mark = " (plan)" if cols == planned else ""
                yield f"K11 tiles {name} cols={cols}{mark}", forced


def _attention_cases(dev, g):
    """The split-S decode attention of the 2B shapes (20 / 5 heads of 128)
    with S - 1 rows cached in every slot: K2 and K5 over bf16, K7 over int8
    at B=1; K8 over bf16 and K9 over int8 at B=8."""
    H, KV, D = 20, 5, 128
    for B, S in ((1, 1024), (1, 4096), (8, 1024)):
        kc = torch.randn((LAYERS, B, S, KV * D), generator=g, device=dev).bfloat16()
        vc = torch.randn_like(kc)
        kq, vq = (torch.randint(-127, 128, kc.shape, generator=g, device=dev
                                ).to(torch.int8) for _ in range(2))
        ks, vs = (torch.rand((LAYERS, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
                  for _ in range(2))
        qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev).bfloat16()
        a = torch.rand((B, D // 2), generator=g, device=dev)
        sin, cos = a.sin(), a.cos()
        q, kn, vn = (torch.randn(s, generator=g, device=dev).bfloat16()
                     for s in ((B, H, D), (B, KV, D), (B, KV, D)))
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        tag = f"B={B} S={S}"
        if B == 1:
            yield f"K2 {tag}", lambda i, kc=kc, vc=vc, qkv=qkv, sin=sin, cos=cos, pos=pos: (
                da.decode_attention_qkv(i % LAYERS, qkv, sin, cos, kc, vc, pos, H, KV))
            yield f"K5 {tag}", lambda i, kc=kc, vc=vc, q=q, kn=kn, vn=vn, pos=pos: (
                dk.decode_attention(i % LAYERS, q, kn, vn, kc, vc, pos))
            yield f"K7 int8 {tag}", lambda i, a=(qkv, sin, cos, kq, vq, ks, vs, pos): (
                da.decode_attention_qkv_quant(i % LAYERS, *a, H, KV))
        else:
            yield f"K8 {tag}", lambda i, kc=kc, vc=vc, q=q, kn=kn, vn=vn, pos=pos: (
                da.decode_attention_batched(i % LAYERS, q, kn, vn, kc, vc, pos))
            yield f"K9 int8 {tag}", lambda i, a=(q, kn, vn, kq, vq, ks, vs, pos): (
                da.decode_attention_quant_batched(i % LAYERS, *a))
    # K5 (bf16) and K15 (int8) in every split size R, forced past attn_plan
    # (the table it rests on)
    for B, S in ((1, 4096), (2, 4096), (8, 1024), (64, 1024)):
        kc = torch.randn((LAYERS, B, S, KV * D), generator=g, device=dev).bfloat16()
        vc = torch.randn_like(kc)
        kq, vq = (torch.randint(-127, 128, kc.shape, generator=g, device=dev
                                ).to(torch.int8) for _ in range(2))
        ks, vs = (torch.rand((LAYERS, B, S, KV), generator=g, device=dev) * 0.01 + 0.005
                  for _ in range(2))
        q, kn, vn = (torch.randn(s, generator=g, device=dev).bfloat16()
                     for s in ((B, H, D), (B, KV, D), (B, KV, D)))
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plans = (dk.attn_plan(B, KV, S, sms, 2), dk.attn_plan(B, KV, S, sms, 1))
        for R in (64, 128, 256, 512, 1024):
            mark, mark_q = (" (plan)" if R == plan else "" for plan in plans)

            def call(i, kc=kc, vc=vc, q=q, kn=kn, vn=vn, pos=pos, R=R):
                with mock.patch.object(dk, "attn_plan", lambda *a: R):
                    return dk.decode_attention(i % LAYERS, q, kn, vn, kc, vc, pos)

            def call_q(i, a=(q, kn, vn, kq, vq, ks, vs, pos), R=R):
                with mock.patch.object(dk, "attn_plan", lambda *a: R):
                    return dk.decode_attention_quant(i % LAYERS, *a)
            yield f"attn tiles K5 B={B} S={S} R={R}{mark}", call
            yield f"attn tiles K15 int8 B={B} S={S} R={R}{mark_q}", call_q


def _graph_us(fn) -> float:
    """Device µs a call: LAYERS calls (``fn.layers``, where the case sets
    it) captured in one CUDA graph, replayed five times between CUDA
    events, the median."""
    n = getattr(fn, "layers", LAYERS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / n)
    return sorted(times)[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated case-name prefixes")
    only = tuple(p for p in ap.parse_args().only.split(",") if p)
    require_sm90(0)
    dev = torch.device("cuda", 0)
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    for name, fn in _cases(dev, g):
        if only and not name.startswith(only):
            continue
        for i in range(LAYERS):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for i in range(REPS):
                fn(i)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():               # device kernels, not aten ops
            if (e.device_time_total > 0 and e.count >= REPS
                    and not e.key.startswith("aten::")):
                key = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                kernels[key[-60:]] = kernels.get(key[-60:], 0.0) + (
                    e.device_time_total / REPS)
        print(json.dumps({"case": name, "card": smi,
                          "call_us": round(_graph_us(fn), 2),
                          "device_us_per_call": {k: round(v, 2) for k, v in
                                                 sorted(kernels.items(),
                                                        key=lambda kv: -kv[1])}}))


if __name__ == "__main__":
    main()
