#!/usr/bin/env python3
"""On-card check of the PyTorch/H100 port (``bitnet_tpu_torch``).

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases probe,build,kernels

Phases (each prints one JSON line; any failure exits non-zero and prints
no result line):
  probe    nvidia-smi name / power limit and the sm version
  build    nvcc of every csrc/*.cu for sm_90a (one process per source)
  kernels  each kernel against its plain PyTorch version at main-path
           shapes: error, median ms (CUDA events), bound, plain and library ms
  parity   a full-width 2-layer model on cuda (kernels) vs cpu (plain
           versions): identical greedy tokens, per-step logits cosine
  serving  the full bitnet-b1.58-2B-4T shapes (random weights from a seed)
           serve 3 requests; launch counts per step, determinism, timings

Before the last line it prints the card's name and power limit, then the
``{"kernels": [...]}`` summary; the last line is the result object.
Details go to ``chiprun_out/chip_smoke.json``.  It imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"
HBM_BPS = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
PHASES = ("probe", "build", "kernels", "parity", "serving")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, n_inner: int = 10, n_outer: int = 7) -> float:
    """Median device ms per call of ``fn(i)``: ``n_inner`` calls captured in
    one CUDA graph (so host launch overhead stays out of the number),
    replayed ``n_outer`` times between CUDA events."""
    for i in range(n_inner):                      # warm-up: lazy init, pools
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inner):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_outer):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n_inner)
    del graph
    times.sort()
    return times[len(times) // 2]


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------
# (name, K, N, gamma, glu, resid) at 2B-4T: H=2560, F=6912, 20/5 heads of 128
K1_SHAPES = (("qkv", 2560, 3840, True, False, False),
             ("o", 2560, 2560, True, False, True),
             ("gate_up", 2560, 13824, True, False, False),
             ("down", 6912, 2560, True, True, True))


def _stack(torch, g, K, N, dev, min_bytes=120 << 20):
    """A weight stack with enough layers that cycling through them keeps
    the working set above the 50 MB L2 (the real decode streams 30 layers)."""
    L = max(2, math.ceil(min_bytes / (K * N // 4)))
    words = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
    sv = (torch.rand((L, N), generator=g, device=dev) + 0.5) * 0.02
    return words, sv


def _dense_stack(torch, words, sv, min_bytes=120 << 20):
    """bf16 dense copies of the first layers of a stack, enough of them to
    exceed the L2 (the library yardstick streams cold weights too)."""
    from bitnet_tpu_torch.ops.linear import codes_to_values, unpack_packed

    K, N = words.shape[1] * 16, words.shape[2]
    n = min(words.shape[0], max(2, math.ceil(min_bytes / (K * N * 2))))
    return [(codes_to_values(unpack_packed(words[l])) * sv[l][None, :]
             ).to(torch.bfloat16) for l in range(n)]


def phase_kernels(torch, dev):
    from bitnet_tpu_torch.ops import decode_attention_v2 as da
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    g = torch.Generator(device=dev).manual_seed(1234)
    res = {"k1": [], "k4": [], "k2": [], "k3": []}
    eps = 1e-5

    # K1: decode W2A8 at the four shapes, M in {1, 8, 64}
    for name, K, N, has_g, glu, has_r in K1_SHAPES:
        words, sv = _stack(torch, g, K, N, dev)
        L = words.shape[0]
        gamma = (torch.rand((L, K), generator=g, device=dev) + 0.5) if has_g else None
        for M in (1, 8, 64):
            x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev
                            ).to(torch.bfloat16)
            resid = (torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
                     if has_r else None)
            l = 1
            out = tm.ternary_matmul_w2a8_normed(l, x, words, sv, gamma, K, N,
                                                eps, glu, resid)
            # the same launch with its int8 rows, scales and row sums kept
            out2, xq, sx, sumq = tm._w2a8_normed_cuda(l, x, words, sv, gamma, K,
                                                     N, eps, glu, resid)
            g_l = None if gamma is None else gamma[l]
            pre = tm.w2a8_preamble_plain(x, g_l, eps, glu)
            xq_p, sx_p, sumq_p = tm.quantize_rows(pre)
            plain = tm.ternary_matmul_w2a8_normed_plain(
                x, words[l], sv[l], g_l, eps, glu, resid, N)
            # the integer dot + epilogue from the kernel's own int8 rows
            # must reproduce its output bit for bit
            acc = tm.int8_matmul(xq, tm.biased_codes(words[l]))
            exact = tm.w2a8_epilogue(acc, sumq, sx, sv[l], resid, x.dtype)
            qdiff = (xq.int() - xq_p.int()).abs()
            err = (out.float() - plain.float()).abs().max().item()
            ref = plain.float().abs().max().item()
            # float tolerance: an int8 activation one step off at a rounding
            # boundary (the norm's f32 sums run in another order) moves an
            # output by sx*scale*4 at most
            tol = 2e-2 * ref + 1e-3
            row = {"shape": name, "M": M, "K": K, "N": N,
                   "max_abs_err": err, "ref_max": ref, "tol": tol,
                   "xq_mismatch": int((qdiff > 0).sum().item()),
                   "xq_max_diff": int(qdiff.max().item()),
                   "sumq_exact": bool(torch.equal(sumq, xq.int().sum(1, dtype=torch.int32))),
                   "dot_epilogue_exact": bool(torch.equal(exact, out)),
                   "wrapper_equals_launch": bool(torch.equal(out, out2))}
            ok = (row["sumq_exact"] and row["dot_epilogue_exact"]
                  and row["wrapper_equals_launch"]
                  and row["xq_max_diff"] <= 1
                  and row["xq_mismatch"] <= max(2, xq.numel() // 1000)
                  and err <= tol)
            if M == 1:
                row["ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8_normed(
                    i % L, x, words, sv, gamma, K, N, eps, glu, resid), L)
                row["plain_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8_normed_plain(
                    x, words[i % L], sv[i % L], g_l, eps, glu, resid, N), 4)
                dense = _dense_stack(torch, words, sv)
                xin = pre.to(torch.bfloat16)
                row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
                    xin, dense[i % len(dense)]), 2 * len(dense))
                del dense
                nbytes = (K * N // 4 + x.numel() * 2 + M * N * 2 * (2 if has_r else 1)
                          + (K * 4 if has_g else 0) + N * 4)
                row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * K * N, "int8")
            row["ok"] = ok
            res["k1"].append(row)
            if not ok:
                raise AssertionError(f"K1 mismatch: {row}")
        del words, sv

    # K4: prefill GEMM at M in {512, 2048}, same four shapes
    for name, K, N, _g, _glu, _r in K1_SHAPES:
        words, sv = _stack(torch, g, K, N, dev)
        L = words.shape[0]
        for M in (512, 2048):
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            l = 1
            out = tm.ternary_matmul_w2a8(l, x, words, sv, K, N)
            xq, sx, sumq = tm.quantize_rows(x.float())
            plain = tm.ternary_matmul_w2a8_plain(xq, sumq, sx, words[l], sv[l], N,
                                                 x.dtype)
            err = (out.float() - plain.float()).abs().max().item()
            row = {"shape": name, "M": M, "K": K, "N": N, "max_abs_err": err,
                   "tol": 0.0, "exact": bool(torch.equal(out, plain))}
            if M == 512:
                row["ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8(
                    i % L, x, words, sv, K, N), L)
                row["plain_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8_plain(
                    xq, sumq, sx, words[i % L], sv[i % L], N, x.dtype), 4)
                dense = _dense_stack(torch, words, sv)
                row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
                    x, dense[i % len(dense)]), 2 * len(dense))
                del dense
                nbytes = M * K * 2 + K * N // 4 + M * N * 2 + N * 4
                row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * K * N, "int8")
            row["ok"] = row["exact"]
            res["k4"].append(row)
            if not row["ok"]:
                raise AssertionError(f"K4 mismatch: {row}")
        del words, sv

    # K2: rope-fused decode attention, B=1, 20/5 heads of 128
    H, KV, D = 20, 5, 128
    for S in (1024, 4096):
        L = max(2, math.ceil((120 << 20) / (2 * S * KV * D * 2)))
        kc = torch.randn((L, 1, S, KV * D), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((L, 1, S, KV * D), generator=g, device=dev).to(torch.bfloat16)
        qkv = torch.randn((1, H + 2 * KV, D), generator=g, device=dev).to(torch.bfloat16)
        ang = torch.rand((1, D // 2), generator=g, device=dev) * 6.283
        sin, cos = torch.sin(ang), torch.cos(ang)
        for p in (0, 1, 777, S - 1):
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            l = 1
            attn, kr, vr = da.decode_attention_qkv(l, qkv, sin, cos, kc, vc, pos, H, KV)
            pa, pk, pv = da.decode_attention_qkv_plain(qkv, sin, cos, kc[l], vc[l],
                                                       pos, H, KV)
            err = (attn.float() - pa.float()).abs().max().item()
            ref = pa.float().abs().max().item()
            # float tolerance: the split softmax rounds its bf16 weights
            # against other running maxima than the one-pass plain version
            tol = 1e-2 * ref + 2e-3
            row = {"S": S, "pos": p, "max_abs_err": err, "ref_max": ref,
                   "tol": tol,
                   "rows_exact": bool(torch.equal(kr, pk) and torch.equal(vr, pv))}
            row["ok"] = row["rows_exact"] and err <= tol
            if p == S - 1:
                row["ms"] = time_ms(torch, lambda i: da.decode_attention_qkv(
                    i % L, qkv, sin, cos, kc, vc, pos, H, KV), L)
                row["plain_ms"] = time_ms(torch, lambda i: da.decode_attention_qkv_plain(
                    qkv, sin, cos, kc[i % L], vc[i % L], pos, H, KV), 4)
                q4 = pa.view(1, H, 1, D)       # any q of the right shape
                mask = (torch.arange(S, device=dev) < p).view(1, 1, 1, S)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                row["library_ms"] = time_ms(torch, lambda i: sdpa(
                    q4, kc[i % L].view(1, S, KV, D).transpose(1, 2),
                    vc[i % L].view(1, S, KV, D).transpose(1, 2),
                    attn_mask=mask, enable_gqa=True), L)
                nbytes = 2 * p * KV * D * 2 + qkv.numel() * 2 + H * D * 2 + 2 * KV * D * 2
                row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * H * p * D, "bf16")
            res["k2"].append(row)
            if not row["ok"]:
                raise AssertionError(f"K2 mismatch: {row}")
        del kc, vc

    # K3: the decode row scatter at 2B-4T (L=30, B=1), incl. pos >= S
    L, B, S, KVD = 30, 1, 4096, 640
    kc = torch.randn((L, B, S, KVD), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((L, B, S, KVD), generator=g, device=dev).to(torch.bfloat16)
    for p in (5, S - 1, S, S + 7):
        kr = torch.randn((L, B, 1, KVD), generator=g, device=dev).to(torch.bfloat16)
        vr = torch.randn((L, B, 1, KVD), generator=g, device=dev).to(torch.bfloat16)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        k2, v2 = kc.clone(), vc.clone()
        da.scatter_kv_rows(kc, vc, kr, vr, pos)
        da.scatter_kv_rows_plain(k2, v2, kr, vr, pos)
        row = {"pos": p, "tol": 0.0,
               "exact": bool(torch.equal(kc, k2) and torch.equal(vc, v2)),
               "max_abs_err": max((kc.float() - k2.float()).abs().max().item(),
                                  (vc.float() - v2.float()).abs().max().item())}
        if p == 5:
            row["ms"] = time_ms(torch, lambda i: da.scatter_kv_rows(kc, vc, kr, vr, pos))
            row["plain_ms"] = time_ms(torch, lambda i: da.scatter_kv_rows_plain(
                kc, vc, kr, vr, pos))
            pl = pos.long()
            row["library_ms"] = time_ms(torch, lambda i: (
                kc[:, 0].index_copy_(1, pl, kr[:, 0]),
                vc[:, 0].index_copy_(1, pl, vr[:, 0])))
            row["bound_ms"], row["bound_by"] = bound(4 * L * B * KVD * 2, 0, "bf16")
        row["ok"] = row["exact"]
        res["k3"].append(row)
        if not row["ok"]:
            raise AssertionError(f"K3 mismatch: {row}")
    return res


def summarize(res, launches):
    """One entry per kernel at its main-path shapes: K1 = one layer's four
    calls at M=1, K4 = one layer's four calls at M=512 (T=512 prefill),
    K2 = S=4096 with a full cache, K3 = all 30 rows of a B=1 step."""
    from bitnet_tpu_torch.ops.registry import REGISTRY

    def total(rows, key):
        return sum(r[key] for r in rows)

    k1 = [r for r in res["k1"] if r["M"] == 1]
    k4 = [r for r in res["k4"] if r["M"] == 512]
    k2 = [r for r in res["k2"] if "ms" in r and r["S"] == 4096]
    k3 = [r for r in res["k3"] if "ms" in r]
    picks = {"ternary_matmul_w2a8_normed": (k1, res["k1"]),
             "ternary_matmul_w2a8": (k4, res["k4"]),
             "decode_attention_qkv": (k2, res["k2"]),
             "scatter_kv_rows": (k3, res["k3"])}
    out = []
    for spec in REGISTRY:
        timed, every = picks[spec.kernel_id]
        bby = max(timed, key=lambda r: r["bound_ms"])["bound_by"]
        out.append({
            "name": spec.kernel_id, "route": spec.route, "source": spec.source,
            "replaces": spec.replaces, "launches": launches.get(spec.kernel_id, 0),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": total(timed, "ms"), "plain_ms": total(timed, "plain_ms"),
            "bound_ms": total(timed, "bound_ms"), "bound_by": bby,
            "library_ms": total(timed, "library_ms")})
    return out


# ---------------------------------------------------------------------------
# phase: parity (cuda kernels vs cpu plain versions, full width, 2 layers)
# ---------------------------------------------------------------------------
def phase_parity(torch, dev):
    """The same 2-layer full-width model through the CUDA kernels and
    through the plain versions on the CPU, teacher-forced with the CUDA
    run's greedy tokens.  Every step's logits keep cosine >= 0.99.  At f32
    activations the two must pick the same tokens.  At bf16 they must pick
    the same token wherever the CPU's top-2 logit margin exceeds the
    largest logit difference: K2 rounds its softmax weights to bf16
    against other maxima than the plain version, and int8 requantization
    amplifies that (``python -m bitnet_tpu_torch.tools.parity_probe``), so
    a near-tie may go either way."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.engine.sampling import argmax
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T.replace(num_layers=2)
    prompt = [int(t) for t in torch.randint(
        0, cfg.vocab_size, (24,), generator=torch.Generator().manual_seed(3))]
    out = {}
    for dtype in ("f32", "bf16"):
        params = build_synthetic(cfg, seed=7, device="cpu")
        ec = EngineConfig(max_seq_len=256, logits_dtype="int8",
                          kv_cache_dtype="bf16", compute_dtype=dtype)
        eg = InferenceEngine(cfg, params, ec, device=dev)
        ecpu = InferenceEngine(cfg, params, ec, device="cpu")
        lg_g, lg_c = eg.prefill(prompt), ecpu.prefill(prompt)
        toks_g, toks_c, cos, tie_ok = [], [], [], []
        pos = len(prompt)
        for _ in range(8):
            a, b = lg_g[0].float().cpu(), lg_c[0].float()
            cos.append(float(torch.nn.functional.cosine_similarity(a, b, dim=0)))
            tg, tc = int(argmax(lg_g)[0]), int(argmax(lg_c)[0])
            top2 = torch.topk(b, 2).values
            tie_ok.append(tg == tc or float(top2[0] - top2[1])
                          <= float((a - b).abs().max()))
            toks_g.append(tg)
            toks_c.append(tc)
            lg_g, lg_c = eg.decode_step(tg, pos), ecpu.decode_step(tg, pos)
            pos += 1
        r = {"tokens_cuda": toks_g, "tokens_cpu": toks_c, "min_cosine": min(cos),
             "cosines": cos, "tokens_agree": sum(a == b for a, b in zip(toks_g, toks_c))}
        r["ok"] = (min(cos) >= 0.99 and all(tie_ok)
                   and (dtype == "bf16" or toks_g == toks_c))
        out[dtype] = r
        del eg, ecpu, params
        if not r["ok"]:
            raise AssertionError(f"parity failed at {dtype}: {r}")
    out["ok"] = True
    return out


# ---------------------------------------------------------------------------
# phase: serving at the full 2B-4T shapes
# ---------------------------------------------------------------------------
def phase_serving(torch, dev):
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic
    from bitnet_tpu_torch.ops import registry

    cfg = BITNET_2B4T
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=dev)
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_seq_len=4096, kv_cache_dtype="bf16", logits_dtype="int8"), device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(11)
    prompts = [[int(t) for t in torch.randint(0, cfg.vocab_size, (n,), generator=gen)]
               for n in (32, 128, 500)]
    gc = GenerationConfig(max_new_tokens=32)
    for p in prompts[:1]:                                 # warm-up (allocator)
        eng.generate(p, gc)
    runs, totals = [], {k.kernel_id: 0 for k in registry.REGISTRY}
    for rep in range(2):
        toks = []
        for p in prompts:
            registry.reset_launch_counts()
            r = eng.generate(p, gc)
            n = registry.launch_counts()
            steps = r.metrics["decode_steps"]
            want = {"ternary_matmul_w2a8_normed": 4 * L * steps,
                    "decode_attention_qkv": L * steps,
                    "scatter_kv_rows": steps, "ternary_matmul_w2a8": 4 * L}
            if n != want:
                raise AssertionError(f"launch counts {n} != {want}")
            for k, v in n.items():
                totals[k] += v
            m = r.metrics
            toks.append(r.token_ids)
            runs.append({"rep": rep, "prompt": len(p), "generated": len(r.token_ids),
                         "decode_steps": steps, "prefill_ms": m["prefill_s"] * 1e3,
                         "decode_ms_per_token": m["decode_s"] * 1e3 / max(steps, 1),
                         "decode_tok_s": steps / m["decode_s"] if m["decode_s"] else 0.0,
                         "launches": n})
        if rep == 0:
            first = toks
        elif toks != first:
            raise AssertionError("two runs gave different tokens")
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    weights = L * (H * (H + 2 * KVD) + H * H + H * 2 * F + F * H) / 4
    head = V * H

    def step_bytes(S):
        return weights + head + 2 * L * S * KVD * 2

    return {"build_s": build_s, "runs": runs, "launch_totals": totals,
            "tokens": first, "decode_bytes_S1024": step_bytes(1024),
            "decode_bound_ms_S1024": step_bytes(1024) / HBM_BPS * 1e3,
            "bandwidth": "data sheet 3.35 TB/s (H100 SXM)", "ok": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: no torch ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from bitnet_tpu_torch.device_probe import require_sm90
        from bitnet_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: bitnet_tpu_torch is not importable ({e})",
              file=sys.stderr)
        return 2
    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda", 0)
    report, smi = {}, None
    try:
        smi = nvidia_smi_line()
        probe = require_sm90(0)
        report["probe"] = {"phase": "probe", "nvidia_smi": smi, "sm": probe.sm,
                           "device": probe.device_kind, "torch": torch.__version__,
                           "cuda": torch.version.cuda}
        emit(report["probe"])
        if "build" in phases or "kernels" in phases:
            secs = _cuda.build()
            report["build"] = {"phase": "build", "seconds": secs}
            (OUT_DIR / "ptxas.txt").write_text(
                "\n".join(f"== {k}\n{v}" for k, v in _cuda.BUILD_LOG.items()))
            emit(report["build"])
        if "kernels" in phases:
            res = phase_kernels(torch, dev)
            report["kernels"] = res
            for k, rows in res.items():
                emit({"phase": f"kernels.{k}", "rows": rows})
        if "parity" in phases:
            report["parity"] = phase_parity(torch, dev)
            emit({"phase": "parity", **report["parity"]})
        launches = {}
        if "serving" in phases:
            report["serving"] = phase_serving(torch, dev)
            s = report["serving"]
            launches = s["launch_totals"]
            emit({"phase": "serving", "nvidia_smi": smi,
                  **{k: v for k, v in s.items() if k != "tokens"}})
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        report["error"] = repr(e)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                            default=str))
        print(f"chip_smoke: FAILED: {e!r}", file=sys.stderr)
        return 1
    summary = summarize(report["kernels"], launches) if "kernels" in report else []
    report["summary"] = summary
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
