#!/usr/bin/env python3
"""On-card check of the PyTorch/H100 port (``bitnet_tpu_torch``).

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases probe,build,kernels
    python3 chip_smoke.py --phases probe,build,kernels,batched
    python3 chip_smoke.py --phases probe,build,kernels,tl
    python3 chip_smoke.py --phases probe,build,kernels,llama8b
    python3 chip_smoke.py --phases probe,build,kernels,experiments,parity
    python3 chip_smoke.py --phases probe,build,k24,llama8b
    python3 chip_smoke.py --phases probe,build,w2a8,experiments
    python3 chip_smoke.py --phases probe,build,k1
    python3 chip_smoke.py --phases probe,build,k11
    python3 chip_smoke.py --phases probe,build,gate
    python3 chip_smoke.py --phases probe,build,requests
    python3 chip_smoke.py --phases probe,build,segments
    python3 chip_smoke.py --phases probe,build,scheduler
    python3 chip_smoke.py --phases probe,build,k33
    python3 chip_smoke.py --phases probe,build,speculative
    python3 chip_smoke.py --phases probe,build,server
    python3 chip_smoke.py --phases probe,build,checkpoints

Phases (each prints one JSON line; any failure exits non-zero and prints
no result line):
  probe    nvidia-smi name / power limit and the sm version
  build    nvcc of every csrc/*.cu for sm_90a (one process per source)
  kernels  each kernel against its plain PyTorch version at the shapes of
           the fused and the generic path, of pools and int8 / fp8 caches
           (K1 at M = 1..64 on both its forms, the 8B four at M <= 2, its M
           table (kernels.k1_m) and a chain of the fused four, each call's x
           the last one's output, timed against the four calls apart
           (kernels.k1_chain)),
           of bitnet32 / TL weights, of every other decode-attention plan
           (K13-K23), and of the 8B-class model (K24, the fused FFN; K1 and
           K11 at the 8B four, K = 14336 included; K11's M table
           (kernels.k11_m) and one call at K = 2560 and 14336 under the
           profiler (kernels.k11_profile)), the stacked-cache and per-b
           kernels (K25-K27), K33 (the stock paged attention) at the paged
           variant's and the paged scheduler's shapes,
           the f32-cache instances (K2, K3, K5, K8) and the W2A8 probes and
           prototype (K28-K32): error, median ms (CUDA events), bound, plain
           and library ms; K10's decode form and GEMM side by side at
           M <= 16 (kernels.k10_mb: the rows where the wrapper switches);
           K10's GEMM form at M = 17..2048 with its bf16 rows and 32-row
           sums, its M table over the fused four beside the library and the
           correction matmul it replaced (kernels.k10_m), K10's GEMM and K12
           in every forced tile / K split and their two launches under the
           profiler (kernels.k10_profile, kernels.k12_profile);
           K6's two forms (its decode form at M <= 16, its row kernel and
           GEMM at every M) at M = 1..512 on the generic seven, bf16 and
           f32 x, side by side at M <= 16 (kernels.k6_mb: the rows where the
           wrapper switches), its M table (kernels.k6_m), every forced tile
           and K split, and each form under the profiler
           (kernels.k6_decode_profile, kernels.k6_gemm_profile);
           K4 bit for bit with its int8 rows at M = 8..2048 on the 2B and
           8B shapes and in every forced tile / K split, its M table over
           the fused four beside torch._int_mm (kernels.k4_m), and its two
           launches under the profiler (kernels.k4_profile);
           K24 at the 8B FFN and at its edges (every BT boundary, nine
           requantization tiles, Hp = 320, K < Kp), twice a shape, and its
           MB table: ms at M = 1..32 (kernels.k24_mb); the one-launch
           split-S decode attention at its splits' edges over every cache
           dtype with and without RoPE (kernels.attn_edges), three calls and
           ten graph replays bit for bit with the arrival counters back at
           zero (kernels.attn_repeats), and a K5 and a K2 call under the
           profiler (kernels.k5_profile, kernels.k2_profile)
  k1       (not in the default run, which holds it in kernels) K1's checks
           and times alone (kernels.k1, k1_m, k1_chain), and K1's and K4's
           row-statistics mode (kernels.rowstats): a short call that
           compares two trees
  k11      (not in the default run, which holds it in kernels) K11's and
           K12's checks and times alone (kernels.k11, k11_8b, k11_m, k12): a
           short call that compares two trees
  k24      (not in the default run, which holds it in kernels) K24's checks
           and times alone: a short call that compares two trees
  k33      (not in the default run, which holds it in kernels) K33's checks
           and times alone (kernels.k33): a short call that compares two
           trees
  w2a8     (not in the default run, which holds it in kernels) the W2A8
           probes' and prototype's checks and times (K28-K32) alone
  parity   a full-width 2-layer model on cuda (kernels) vs cpu (plain
           versions), fused (slice 1; int8 B=1, fp8 B=2, bf16 and auto
           pools of 8) and unfused on paths w2a8 and pallas, and with an
           int8 cache; re-quantized to TL2 and as bitnet32, fused (B=1, 3)
           and unfused; a 2-layer model at the 8B widths fused, with K24 in
           its prefill, and re-quantized to TL1; an f32 cache fused (B=1, a
           pool of 8) and unfused: greedy tokens and per-step logits cosine
  serving  the full bitnet-b1.58-2B-4T shapes (random weights from a seed)
           serve 3 requests on the fused stacked path, twice, and one over
           an f32 cache; launch counts per step, determinism, timings
  batched  the same shapes, fused: generate_batch pools of 8 (bf16, auto →
           int8, fp8) and 64 (int8) with prompts of 32-500 tokens, and
           generate at B=1 with a 4096-token auto (int8) cache; launch
           counts per step, determinism, prefill / decode timings
  tl       the same shapes with TL1-re-quantized weights (fused B=1, a
           pool of 8) and a bitnet32 model (the CLI's unfused engine), and
           a 2-layer bitnet32 model whose FFN width is not a multiple of
           256; launch counts per request
  llama8b  the 8B-class model (Llama-3-8B-1.58 shapes, no sub-norms,
           random weights from a seed): fused B=1, a pool of 8, prefills
           through K24 (BITNET_FUSED_FFN=1, BITNET_STACKED_PREFILL=0), TL1,
           and the CLI's unfused engine; launch counts per request
  plans    the 2B shapes under each knob setting of the JAX package's
           decode-attention selection (B=1 and a pool of 8, bf16 and int8
           caches, and the generic path's BITNET_ROPE_FUSED=1): plan names,
           launch counts, step times beside the default plan's, logits
           against it; then each knob plan on a 2-layer model, card vs CPU
  kernel_bench  `python -m bitnet_tpu_torch.cli benchmark-kernels` three
           times (the 2B shapes; --attention all at B=1 and at B=8, S=4096)
  experiments  the port's two experiment entry points: `exp_w2a8` (P1-P4 on
           K28-K31, P5 on K32 timed beside K6 and K1) and `exp_r4_attn`
           (every variant, paged on K33, at L=30, B=8, S=1024: µs a layer
           beside the stream floor; one untimed loop of each kernel variant
           counted)
  generic  the same shapes unfused, as the CLI builds the engine (auto →
           w2a8, bf16 KV, bf16 tied head): 3 requests greedy, then seeded
           sampling twice, one greedy request over an f32 cache, then one
           greedy request on kernel_path="pallas"
  cli      `python -m bitnet_tpu_torch.cli run` on mini QK256 (also with
           --weight-quant tl2) and BitNet32 GGUFs written by the port's own
           fixtures, on the card; then, in process on the QK256 mini, `chat`
           with redirected stdin (K1 and K5), `config` on a file of its own
           (the default of --model), `list-templates`, `list-architectures`,
           `info` and `preflight` (the H100, `native_codec`, nvcc),
           `bench-compare` (a regression, exit 1), `download-model`'s
           refusal and `gate --require-native`
  segments K-step decode segments (one CUDA graph of 8 steps a round trip)
           against one step a round trip on the same engine, 32 tokens a
           request: the 2B fused B=1 engine (bf16 cache greedy and seeded
           top-k, int8 cache), TL1 fused B=1, the CLI's generic engine
           (greedy and seeded) and the 8B fused B=1 engine: tokens and stop
           reasons equal, launch counts by kernel per step equal (the
           replays' counts), a replay for every 8 steps; host ms a step at
           K = 1 and 8, the graph's device ms a step and capture ms.  Every
           earlier phase that calls ``generate`` decodes in segments too
           (auto: 8 steps a round trip on the card)
  requests the per-request state on the full-width 2B fused engine (seed 0,
           int8 head, bf16 cache, S=1024, the mock tokenizer over 128256
           ids, a 4096-token prefix cache): (a) a JSON-schema grammar
           greedy and sampled, 32 tokens each, every token admissible under
           a fresh matcher, and a yes/no grammar; (b) Mirostat v1 and v2,
           32 tokens each, mu's update checked a step against the host's
           surprise; (c) a 480-token prefix stored, then hits restoring 480
           and 499 rows, logits against a cold prefill (cosine >= 0.99 and
           the parity rule's argmax); (d) a 32-token greedy run broken
           after 16, checkpointed to disk, resumed on the reset engine:
           the same tokens; (e) a two-turn chatml session; K1-K4 launched,
           no other kernel; TTFTs, copy ms, mask and decode ms a step
  scheduler  the continuous-batching scheduler (serve/scheduler.py) on the
           full-width 2B fused engine (condition_norms gains, mock tokenizer,
           S=1024): (a) a pool of 8 bf16 slots, (b) kv auto -> int8, (c) paged
           (half of B*S/16 pages, a shared-prefix fork; K33 L times a step),
           (d) chunked prefill of 64 while a 900-token prompt joins in-flight
           streams, (e) a pool of 64 on int8; 24 staggered requests each
           (greedy, seeded top-k / top-p / typical, penalties with a logit
           bias, Mirostat, a JSON-schema grammar, logprobs, a min_new_tokens
           phase, a cancel, a deadline, a preemption), each pool at K=1 and
           K=8 (pool steps replayed as CUDA graphs): K=8's tokens K=1's,
           greedy requests against B=1 under the near-tie rule (logits cosine
           >= 0.99), launches a step against the want table; ms a step, tok/s,
           TTFT p50 / p90, capture ms, the gap between tokens around the
           900-token admission with and without chunking
  gate     `python -m bitnet_tpu_torch.tools.gate_2b` on the full-width 2B
           qk256 GGUF of tools/gen_2b_gguf.py (generate, build the C++
           golden, `cli run --greedy --receipt`, `cli gate --receipt
           --require-cuda`, `cli crossval --backend cppref` at tokens
           2,7,11,5 on the default path w2a8): fails under cosine 0.99 at
           any position or without a strict-valid cuda receipt naming K1 and
           K5; then `cli crossval` on --kernel-path pallas and on the
           bitnet32 2B GGUF, for information (cosines, ppl delta, launches)
  speculative  speculative decoding and pipelined serving on the
           scheduler phase's 2B fused engine: (a) n-gram drafts, k=4,
           greedy, three prompts (one repetitive) against plain greedy
           under the near-tie rule, K4 4L a verify and nothing else;
           (b) EngineDraft over a second engine with the same weights (at
           least one draft accepted); (c) `cli run --speculative 4` on the
           full-width 2B GGUF (the gate's; the generic engine); (d) the
           scheduler with speculative_k=4, pools of 8 bf16 and auto ->
           int8: sampled tokens those without speculation, greedy ones the
           near-tie rule; (e) pipeline_depth 2 and 3 at K=8: the
           synchronous scheduler's tokens.  The verify graph's ms a round
           and capture ms, the draft's ms a round, the acceptance rate, ms
           per emitted token beside plain greedy's ms a step, the pool's
           ms a step at depth 1, 2, 3
  server   the HTTP server (serve/server.py on the standard-library
           serve/http.py): in process, BitNetServer over a scheduler of the
           gate's 2B qk256 GGUF (4 slots, bf16, S=1024, K=8 graphs, fused
           w2a8): /v1/inference greedy against generate (near-tie rule), the
           stream, chat streamed and not, 8 concurrent requests each its solo
           answer, /v1/embeddings while the pool decodes, /v1/models/load of
           the gate's bitnet32 GGUF and a request to each model (each
           against its own generate), checkpoint and resume, /v1/ws,
           /metrics, /v1/devices; a load window of 128 streamed requests at
           Poisson arrivals of 6 a second from a client process: TTFT p50 /
           p90 / p99, latency, tok/s and ms a step over HTTP; K1, K3, K4, K8
           launched; then `python -m bitnet_tpu_torch.cli serve` as a
           process: /health, one request (near-tie rule against the generic
           engine), SIGTERM, exit 0
  checkpoints  every checkpoint the JAX package loads, on the gate's 2B
           qk256 GGUF: (a) loaded with mode="dense" (bf16 dense linears,
           the CLI's engine: K5 L times a step and no other kernel), B=1
           greedy requests of 32 and 128 tokens (prefill ms, decode ms a
           step beside its byte bound, load s) held to the packed GGUF on
           --kernel-path pallas (K6) under the near-tie rule, and its first
           two layers card vs CPU (cosine >= 0.99); (b) the same weights
           written as an HF directory (two f16 SafeTensors shards, the
           index, config.json), converted once (timed) to a cached GGUF,
           loaded by InferenceEngine.from_gguf(dir) and by `cli run -m
           <dir>` in a process of its own, the cache reused (mtime
           unchanged), tokens against (a)'s (near-tie rule), the files
           deleted; (c) the packed GGUF on the windowed ring (W=256, bf16
           KV, K1 at the generic site): a 64-token prompt and 320 greedy
           eager tokens, those inside the window against the plain engine's
           (near-tie rule), allocated memory flat after the first window,
           decode ms and launches a step, then the ring's logits at every
           position of that run, teacher-forced, against forward(window=W)
           over a dense cache (cosine >= 0.99 on both sides of W); (d)
           the QK256 tensors of the 2B's first two layers packed on the
           card against the
           numpy route on the host, bit for bit (seconds, the largest
           memory rise of one pack); (e) the CLI in process at the 2B:
           `benchmark -n 64` (tok/s, TTFT), `score` over ~300 ids
           (perplexity, seconds), `tokenize`, `inspect`, `fingerprint`,
           `ln-check`, `compat-check` (rc, keys), K1 and K5 launched by
           the engine commands; (f) `compat.llama.Llama(n_ctx=512)`: a
           greedy 32-token completion equal to `InferenceEngine.generate`,
           a streamed chat joined to the unstreamed one, an embedding,
           `eval` + `sample`, `save_state` / `load_state`; K1 and K5

Before the last line it prints the card's name and power limit, then the
``{"kernels": [...]}`` summary; the last line is the result object.
Details go to ``chiprun_out/chip_smoke.json``.  It imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"
HBM_BPS = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
PHASES = ("probe", "build", "kernels", "parity", "serving", "batched", "tl",
          "llama8b", "generic", "plans", "kernel_bench", "experiments", "cli",
          "segments", "requests", "scheduler", "gate", "speculative", "server",
          "checkpoints", "parallel")


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
# the generic path's seven unfused projections: q, k, v and gate, up take
# already-normed rows (gamma None); o and down keep their sub-norm and the
# residual inside K1; SwiGLU runs in torch before down
UNFUSED_SHAPES = (("q", 2560, 2560, False, False, False),
                  ("k", 2560, 640, False, False, False),
                  ("v", 2560, 640, False, False, False),
                  ("o", 2560, 2560, True, False, True),
                  ("gate", 2560, 6912, False, False, False),
                  ("up", 2560, 6912, False, False, False),
                  ("down", 6912, 2560, True, False, True))


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
    res = {"k1": [], "k4": [], "k2": [], "k3": [], "k5": [], "k6": [], "k7": [],
           "k8": [], "k9": [], "k3q": [], "k10": [], "k11": [], "k12": [],
           **{key: [] for key, *_ in PLAN_KERNELS}, "k24": [], "k11_8b": [],
           **{f"k{n}": [] for n in range(25, 34)}, "f32": [], "attn_edges": [],
           "attn_repeats": [], "rowstats": []}
    res.update(_profile_calls())
    check_k1_all(torch, dev, g, res)
    check_rowstats(torch, dev, g, res)
    check_k4(torch, dev, g, K1_SHAPES, K4_MS, "fused", res, K4_TIMED)
    check_k4(torch, dev, g, UNFUSED_SHAPES, K4_MS, "unfused", res)
    check_k4(torch, dev, g, K4_8B_SHAPES, K4_MS, "8b", res)
    check_k4_forms(torch, dev, g, res)
    # the M table: K4 over the fused four, per M
    res["k4_m"] = [
        {"M": M, **{f: sum(r[f] for r in res["k4"] if r["path"] == "fused"
                           and r["M"] == M) for f in ("ms", "library_ms", "int_mm_ms",
                                                      "bound_ms", "plain_ms")}}
        for M in K4_TIMED]
    check_k6(torch, dev, g, res)
    # the MB table: K6's two forms summed over the generic seven, per M; the
    # M table: the wrapper over the seven at M=1 and 512
    res["k6_mb"] = [
        {"M": M, **{f: sum(r[f] for r in res["k6"] if r["M"] == M and f in r)
                    for f in ("decode_ms", "gemm_ms")}} for M in (1, 2, 4, 8, 16)]
    res["k6_m"] = [
        {"M": M, **{f: sum(r[f] for r in res["k6"] if r["M"] == M and "ms" in r)
                    for f in ("ms", "library_ms", "bound_ms", "plain_ms")}}
        for M in (1, 512)]
    check_k6_forms(torch, dev, g, res)
    check_k5(torch, dev, g, res)
    check_k7(torch, dev, g, res)
    check_k8_k9(torch, dev, g, res)
    check_k3_quant(torch, dev, g, res)
    check_k10(torch, dev, g, res)
    # the MB table: K10's two forms summed over the generic seven, per M
    res["k10_mb"] = [
        {"M": M, **{f: sum(r[f] for r in res["k10"] if r["path"] == "unfused"
                           and r["M"] == M and f in r) for f in ("decode_ms", "gemm_ms")}}
        for M in (1, 2, 4, 8, 16)]
    # the M table: K10's GEMM form over the fused four, per M
    res["k10_m"] = [
        {"M": M, **{f: sum(r[f] for r in res["k10"] if r["path"] == "fused"
                           and r["M"] == M and "ms" in r)
                    for f in ("ms", "library_ms", "corr_ms", "bound_ms", "plain_ms")}}
        for M in K10_TIMED]
    check_k10_forms(torch, dev, g, res)
    check_k11_k12(torch, dev, g, res)
    check_plan_kernels(torch, dev, g, res)
    # slice 6: K11 at the 8B four, the down projection's K = 14336 included
    # (K1's 8B four are in check_k1_all), one launch a call under the
    # profiler, and K24 at the 8B FFN shapes
    check_k11_wide(torch, dev, g, res)
    check_k11_profile(res)
    check_k24(torch, dev, g, res)
    # slice 7: the stacked-cache and per-b kernels, the f32 cache instances,
    # the W2A8 probes and prototype
    check_k25_k27(torch, dev, g, res)
    # slice 21: K33, the stock paged attention
    check_k33(torch, dev, g, res)
    check_f32_instances(torch, dev, g, res)
    # the one-launch split-S kernel at its splits' edges, repeated
    # and replayed, and under the profiler
    check_attn_edges(torch, dev, g, res)
    check_attn_repeats(torch, dev, g, res)
    check_attn_profiles(res)
    check_exp_w2a8(torch, dev, g, res)

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


# K1's rows: one launch at M <= 2, the row kernel and the GEMM above (every
# BT of the GEMM's plan); the fused four timed at K1_TIMED (the M table)
K1_MS = (1, 2, 3, 8, 16, 33, 64)
K1_TIMED = (1, 8, 64)


def check_k1_all(torch, dev, g, res):
    """K1 at the fused four (M in ``K1_MS``, timed at ``K1_TIMED``), the
    generic seven (M = 1, 2, 32, 64, timed at 1) and the 8B four (M = 1, 2,
    timed at 1), the M table (``k1_m``: each path's shapes summed per timed
    M) and the chain of the fused four (``k1_chain``)."""
    check_k1(torch, dev, g, K1_SHAPES, K1_MS, "fused", res, timed=K1_TIMED)
    check_k1(torch, dev, g, UNFUSED_SHAPES, (1, 2, 32, 64), "unfused", res)
    check_k1(torch, dev, g, K1_8B_SHAPES, (1, 2), "8b", res)
    res["k1_m"] = [
        {"path": path, "M": M, **{f: sum(r[f] for r in res["k1"] if r["path"] == path
                                         and r["M"] == M) for f in
                                  ("ms", "library_ms", "bound_ms", "plain_ms")}}
        for path, Ms in (("fused", K1_TIMED), ("unfused", (1,)), ("8b", (1,)))
        for M in Ms]
    res["k1_chain"] = [check_k1_chain(torch, dev, g, res)]


def check_k1_chain(torch, dev, g, res, L=8, eps=1e-5):
    """The fused four of one 2B layer at M=1 as the step chains them, over
    ``L`` layers (139 MB of words): qkv of the residual stream h, o of
    qkv's first 2560 values (in place of the attention) plus h, gate|up of
    that, down of its SwiGLU plus the o output; each call's x is the last
    one's output, so each launch, a programmatic dependent, waits on the one
    before it.  The chain launched without a sync gives the bits of the same
    chain synced after every call; timed as one layer of four calls against
    the sum of the four calls timed apart (``k1`` rows, M=1)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    w = {}
    for name, K, N, has_g, glu, has_r in K1_SHAPES:
        words = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                              generator=g, device=dev)
        sv = (torch.rand((L, N), generator=g, device=dev) + 0.5) * 0.02
        gamma = torch.rand((L, K), generator=g, device=dev) + 0.5
        w[name] = (words, sv, gamma, K, N)
    h0 = torch.randn((1, 2560), generator=g, device=dev).to(torch.bfloat16)

    def mm(name, l, x, glu=False, resid=None):
        words, sv, gamma, K, N = w[name]
        return tm.ternary_matmul_w2a8_normed(l, x, words, sv, gamma, K, N, eps, glu, resid)

    def layer(l, h):
        q = mm("qkv", l, h)
        h = mm("o", l, q[:, :2560], resid=h)
        return mm("down", l, mm("gate_up", l, h), glu=True, resid=h)

    def chain(sync):
        h = h0
        for i in range(2 * L):
            h = layer(i % L, h)
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return h
    want = chain(True)
    got = [chain(False) for _ in range(3)]
    row = {"path": "chain", "M": 1, "layers": 2 * L, "max_abs_err": 0.0,
           "finite": bool(torch.isfinite(want.float()).all()),
           "equal_to_synced": all(torch.equal(h, want) for h in got)}
    state = {"h": h0}

    def step(i):
        state["h"] = layer(i % L, state["h"])
    row["ms"] = time_ms(torch, step, L)
    four = [r for r in res["k1"] if r["path"] == "fused" and r["M"] == 1 and "ms" in r]
    row["four_apart_ms"] = sum(r["ms"] for r in four)
    row["bound_ms"] = sum(r["bound_ms"] for r in four)
    row["ok"] = row["finite"] and row["equal_to_synced"]
    if not row["ok"]:
        raise AssertionError(f"K1 chain mismatch: {row}")
    return row


def check_k1(torch, dev, g, shapes, Ms, path, res, eps=1e-5, timed=(1,)):
    """K1 against its plain version at ``shapes`` and row counts ``Ms``;
    timed at the ``timed`` row counts."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    for name, K, N, has_g, glu, has_r in shapes:
        words, sv = _stack(torch, g, K, N, dev)
        L = words.shape[0]
        gamma = (torch.rand((L, K), generator=g, device=dev) + 0.5) if has_g else None
        for M in Ms:
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
            row = {"path": path, "shape": name, "M": M, "K": K, "N": N,
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
            if M in timed:
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


# the row-statistics mode of K1 and K4 (a row-parallel slice: the 8B's o
# and down at tp = 2, K = 2048 and 7168 of a row of 4096 and 14336)
ROWPAR_SHAPES = (("o", 2048, 4096, 4096), ("down", 7168, 4096, 14336))


def check_rowstats(torch, dev, g, res, eps=1e-5):
    """K1 (M = 1, 2: its decode form; M = 8: its row kernel and GEMM) and
    K4 (M = 128) in their row-statistics mode at the 8B's tp = 2 slices,
    with and without a norm gain, against their plain versions on the same
    statistics (the whole row's sum of squares and normed absmax, here
    made larger than the slice's own): the int8 rows bit for bit, the
    output within K1's tolerance (K4's: exact)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    for name, K, N, K_full in ROWPAR_SHAPES:
        words, sv = _stack(torch, g, K, N, dev, min_bytes=0)
        l = 1
        for has_g in (False, True):
            gamma = (torch.rand((words.shape[0], K), generator=g, device=dev) + 0.5
                     if has_g else None)
            for M in (1, 2, 8, 128):
                x = torch.randn((M, K), generator=g, device=dev)
                ss = (x * x).sum(1) * (K_full / K)          # the whole row's
                xn = x if gamma is None else (
                    x * tm.norm_factor(ss, K_full, eps)[:, None]) * gamma[l]
                stats = torch.stack([ss, xn.abs().amax(1) * 1.25], 1).contiguous()
                if M <= tm.STACKED_DECODE_MAX_M:
                    out, xq, sx, sumq = tm._w2a8_normed_cuda(
                        l, x, words, sv, gamma, K, N, eps, False, None, stats, K_full)
                    pre = tm.w2a8_preamble_plain(x, None if gamma is None else gamma[l],
                                                 eps, False, stats, K_full)
                    plain = tm.ternary_matmul_w2a8_normed_plain(
                        x, words[l], sv[l], None if gamma is None else gamma[l], eps,
                        False, None, N, stats, K_full)
                else:
                    if gamma is not None:
                        continue                      # K4 takes normed rows
                    out, xq, sx, sumq = tm._w2a8_gemm_cuda(l, x, words, sv, K, N, stats)
                    pre = x
                    xq_p, sx_p, sumq_p = tm.quantize_rows(x, stats[:, 1])
                    plain = tm.ternary_matmul_w2a8_plain(xq_p, sumq_p, sx_p, words[l],
                                                         sv[l], N, x.dtype)
                xq_p, sx_p, _ = tm.quantize_rows(pre, stats[:, 1])
                err = (out.float() - plain.float()).abs().max().item()
                ref = plain.float().abs().max().item()
                tol = 0.0 if M > tm.STACKED_DECODE_MAX_M else 2e-2 * ref + 1e-3
                row = {"shape": name, "K": K, "K_full": K_full, "N": N, "M": M,
                       "gamma": has_g, "max_abs_err": err, "ref_max": ref, "tol": tol,
                       "rows_exact": bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p))}
                row["ok"] = row["rows_exact"] and err <= tol
                res["rowstats"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K1 / K4 row-statistics mismatch: {row}")
        del words, sv


# K4's rows: every tile of the wrapper's plan (BT = 8, 32, 128; ragged M)
# and the prefill buckets; the fused four are timed at K4_TIMED (the M
# table), the other paths at M=512
K4_MS = (8, 32, 77, 128, 500, 512, 2048)
K4_TIMED = (8, 32, 128, 512, 2048)


def _codes_stack(torch, words, min_bytes=120 << 20):
    """int8 biased codes [K, N] of the first layers of a stack, column-major
    as cuBLASLt wants them, enough of them to exceed the L2 (the
    ``torch._int_mm`` yardstick)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    K, N = words.shape[1] * 16, words.shape[2]
    n = min(words.shape[0], max(2, math.ceil(min_bytes / (K * N))))
    return [tm.biased_codes(words[l]).t().contiguous().t() for l in range(n)]


def check_k4(torch, dev, g, shapes, Ms, path, res, timed=(512,)):
    """K4 against its plain version, bit for bit, with its int8 rows, scales
    and row sums against ``quantize_rows``; timed at ``timed`` rows beside
    the plain version, the bf16 matmul and ``torch._int_mm`` on the int8
    rows and biased codes (M <= 16 padded to 32 rows, as ``_int_mm`` wants
    more than 16)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, K, N, *_ in shapes:
        words, sv = _stack(torch, g, K, N, dev)
        L = words.shape[0]
        dense = codes = None
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            l = 1
            out = tm.ternary_matmul_w2a8(l, x, words, sv, K, N)
            out2, xq, sx, sumq = tm._w2a8_gemm_cuda(l, x, words, sv, K, N)
            xq_p, sx_p, sumq_p = tm.quantize_rows(x.float())
            plain = tm.ternary_matmul_w2a8_plain(xq_p, sumq_p, sx_p, words[l], sv[l],
                                                 N, x.dtype)
            err = (out.float() - plain.float()).abs().max().item()
            bt, split = tm.w2a8_gemm_plan(M, K, N, sms)
            row = {"path": path, "shape": name, "M": M, "K": K, "N": N, "bt": bt,
                   "split": split, "max_abs_err": err, "tol": 0.0,
                   "exact": bool(torch.equal(out, plain)),
                   "rows_exact": bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)
                                      and torch.equal(sumq, sumq_p)),
                   "wrapper_equals_launch": bool(torch.equal(out, out2))}
            if M in timed:
                if dense is None:
                    dense, codes = _dense_stack(torch, words, sv), _codes_stack(torch, words)
                row["ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8(
                    i % L, x, words, sv, K, N), L)
                row["plain_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8_plain(
                    xq_p, sumq_p, sx_p, words[i % L], sv[i % L], N, x.dtype), 4)
                row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
                    x, dense[i % len(dense)]), 2 * len(dense))
                xq32 = xq_p if M > 16 else torch.cat([xq_p, xq_p.new_zeros((32 - M, K))])
                row["int_mm_ms"] = time_ms(torch, lambda i: torch._int_mm(
                    xq32, codes[i % len(codes)]), 2 * len(codes))
                nbytes = M * K * 2 + K * N // 4 + M * N * 2 + N * 4
                row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * K * N, "int8")
            row["ok"] = row["exact"] and row["rows_exact"] and row["wrapper_equals_launch"]
            res["k4"].append(row)
            if not row["ok"]:
                raise AssertionError(f"K4 mismatch: {row}")
        del words, sv, dense, codes


def check_k4_forms(torch, dev, g, res):
    """Every form of K4 (BT rows a block x a K split of 1-8), forced past the
    wrapper's plan, bit for bit: ragged M, N = 192 (a block whose second
    column half lies past Np) and 640, f32 and bf16 x; then one call under
    the profiler: two kernels and no ATen op but ``aten::empty``."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    K = 2048
    for N, dtype in ((192, torch.float32), (640, torch.bfloat16)):
        words, sv = _stack(torch, g, K, N, dev, min_bytes=0)
        for bt in tm.W2A8_GEMM_ROWS:
            for split in (1, 2, 4, 8):
                M = bt + 1
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                with mock.patch.object(tm, "w2a8_gemm_plan", lambda *a: (bt, split)):
                    out, xq, sx, sumq = tm._w2a8_gemm_cuda(1, x, words, sv, K, N)
                xq_p, sx_p, sumq_p = tm.quantize_rows(x.float())
                plain = tm.ternary_matmul_w2a8_plain(xq_p, sumq_p, sx_p, words[1],
                                                     sv[1], N, x.dtype)
                row = {"path": "forms", "M": M, "K": K, "N": N, "bt": bt,
                       "split": split, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": (out.float() - plain.float()).abs().max().item(),
                       "tol": 0.0,
                       "ok": bool(torch.equal(out, plain) and torch.equal(xq, xq_p)
                                  and torch.equal(sx, sx_p)
                                  and torch.equal(sumq, sumq_p))}
                res["k4"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K4 form mismatch: {row}")
    if not res["k4_profile"]["ok"]:
        raise AssertionError(f"K4 launched more than its two kernels: {res['k4_profile']}")


# K6's rows at the generic seven: both forms at M <= 16 (the MB table), the
# GEMM form past them; timed at M=1 and a 512-row prefill bucket
K6_MS = (1, 2, 4, 8, 16, 17, 64, 512)


def _k6_rows_ok(torch, xb_k, sum_k, xb, sumx):
    """The GEMM form's row-kernel outputs: its bf16 rows (where it copied
    them) the plain row kernel's bit for bit, its row sums within the f32
    bound of two summation orders, 2·Kp·2^-24·Σ|x| a row."""
    bound = 2 * xb.shape[1] * 2.0**-24 * xb.float().abs().sum(1)
    return bool((xb_k is None or torch.equal(xb_k, xb))
                and ((sum_k - sumx).abs() <= bound).all())


def check_k6(torch, dev, g, res):
    """K6 (bf16 x biased codes, f32 accumulation, one scale a column)
    against its plain version at the seven unfused shapes, M in ``K6_MS``,
    bf16 and f32 x: the wrapper, and each form it can take (the decode form
    at M <= 16, twice, bit for bit; the GEMM form with its row kernel's bf16
    rows and row sums); the wrapper's output is the form it takes, bit for
    bit, and past MB two calls give the same bits.  Tolerance: the
    correction cancels (acc reaches ~4·K·|x|) and the f32 sums run in
    another order, so f32 outputs within 1e-4 of the largest output, bf16
    8e-3 (two ulps).  With bf16 x: both forms timed at M <= 16 (the MB
    table, ``kernels.k6_mb``), the wrapper at M=1 and 512 beside the plain
    version, ``torch.matmul`` on the dequantized bf16 weights and the bound
    (``kernels.k6_m``)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    MB = tm.BF16_DECODE_MAX_M
    for name, K, N, _g, _glu, _r in UNFUSED_SHAPES:
        words, sv = _stack(torch, g, K, N, dev)
        L = words.shape[0]
        dense = None
        for M in K6_MS:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                l = 1
                out = tm.ternary_matmul_bf16(l, x, words, sv, K, N)
                xb, sumx = tm.colscale_rows_plain(x, K)
                plain = tm.ternary_matmul_bf16_plain(xb, sumx, words[l], sv[l], N, dtype)
                ref = plain.float().abs().max().item()
                tol = (8e-3 if dtype == torch.bfloat16 else 1e-4) * ref
                form = "decode" if M <= MB else "gemm"
                row = {"shape": name, "M": M, "K": K, "N": N, "x": str(dtype)[6:],
                       "form": form, "ref_max": ref, "tol": tol}
                gem, xb_k, sum_k = tm._bf16_gemm_cuda(l, x, words, sv, K, N)
                errs = [(out.float() - plain.float()).abs().max().item(),
                        (gem.float() - plain.float()).abs().max().item()]
                row["rows_ok"] = _k6_rows_ok(torch, xb_k, sum_k, xb, sumx)
                row["copied_rows"] = xb_k is not None
                ok = row["rows_ok"]
                if M <= 16:
                    dec = tm._bf16_decode_cuda(l, x, words, sv, K, N)
                    dec2 = tm._bf16_decode_cuda(l, x, words, sv, K, N)
                    errs.append((dec.float() - plain.float()).abs().max().item())
                    row["decode_repeats"] = bool(torch.equal(dec, dec2))
                    row["wrapper_is_form"] = bool(torch.equal(
                        out, dec if form == "decode" else gem))
                    ok = ok and row["decode_repeats"]
                else:
                    again = tm.ternary_matmul_bf16(l, x, words, sv, K, N)
                    row["wrapper_is_form"] = bool(torch.equal(out, gem))
                    row["gemm_repeats"] = bool(torch.equal(out, again))
                    ok = ok and row["gemm_repeats"]
                row["max_abs_err"] = max(errs)
                row["ok"] = ok and row["wrapper_is_form"] and row["max_abs_err"] <= tol
                if dtype == torch.bfloat16 and M <= 16:
                    row["decode_ms"] = time_ms(torch, lambda i: tm._bf16_decode_cuda(
                        i % L, x, words, sv, K, N), L)
                    row["gemm_ms"] = time_ms(torch, lambda i: tm._bf16_gemm_cuda(
                        i % L, x, words, sv, K, N)[0], L)
                if dtype == torch.bfloat16 and M in (1, 512):
                    if dense is None:
                        dense = _dense_stack(torch, words, sv)
                    row["ms"] = time_ms(torch, lambda i: tm.ternary_matmul_bf16(
                        i % L, x, words, sv, K, N), L)
                    row["plain_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_bf16_plain(
                        xb, sumx, words[i % L], sv[i % L], N, x.dtype), 4)
                    row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
                        x, dense[i % len(dense)]), 2 * len(dense))
                    nbytes = M * K * 2 + K * N // 4 + M * N * 2 + N * 4
                    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * K * N, "bf16")
                res["k6"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K6 mismatch: {row}")
        del words, sv, dense


def check_k6_forms(torch, dev, g, res):
    """Every tile and K split of K6's GEMM form (BT rows a block x a split of
    1-8), forced past the plan: ragged M, K < Kp, N = 192 (a block whose
    second column half lies past Np) with f32 x in strided rows (copied by
    the row kernel) and N = 640 with bf16 x (read by TMA as it is), against
    the plain version (check_k6's tolerances); then one call of each form
    under the profiler: the decode form one kernel, the GEMM form two, and
    no ATen op but ``aten::empty``."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    Kp, K = 2048, 1952
    for N, dtype in ((192, torch.float32), (640, torch.bfloat16)):
        words, sv = _stack(torch, g, Kp, N, dev, min_bytes=0)
        for bt in tm.BLOCKSCALE_GEMM_ROWS:
            for split in (1, 2, 4, 8):
                M = bt + 1
                x = torch.randn((M, K + 64), generator=g, device=dev).to(dtype)
                x = x[:, :K] if dtype == torch.float32 else x[:, :K].contiguous()
                with mock.patch.object(tm, "blockscale_gemm_plan", lambda *a: (bt, split)):
                    out, xb_k, sum_k = tm._bf16_gemm_cuda(1, x, words, sv, K, N)
                xb, sumx = tm.colscale_rows_plain(x, Kp)
                plain = tm.ternary_matmul_bf16_plain(xb, sumx, words[1], sv[1], N, dtype)
                ref = plain.float().abs().max().item()
                tol = (8e-3 if dtype == torch.bfloat16 else 1e-4) * ref
                row = {"path": "forms", "M": M, "K": K, "Kp": Kp, "N": N, "bt": bt,
                       "split": split, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": (out.float() - plain.float()).abs().max().item(),
                       "tol": tol, "copied_rows": xb_k is not None,
                       "rows_ok": _k6_rows_ok(torch, xb_k, sum_k, xb, sumx)}
                row["ok"] = row["max_abs_err"] <= tol and row["rows_ok"]
                res["k6"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K6 form mismatch: {row}")
    for key in ("k6_decode_profile", "k6_gemm_profile"):
        if not res[key]["ok"]:
            raise AssertionError(f"K6 launched other than its kernels: {res[key]}")


def check_k5(torch, dev, g, res):
    """K5 (v1 decode attention) against its plain version at S in {1024,
    4096}, pos in {0, 1, 777, S-1}, B in {1, 2}, and at B=8, S=1024
    (``exp_r4_attn``'s ``perb``) also with every slot full; timed at B=1,
    pos=S-1."""
    from bitnet_tpu_torch.ops import decode_attention as dk

    H, KV, D = 20, 5, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for S in (1024, 4096):
        for B in (1, 2, 8) if S == 1024 else (1, 2):
            L = max(2, math.ceil((120 << 20) / (2 * B * S * KV * D * 2)))
            kc = torch.randn((L, B, S, KV * D), generator=g, device=dev).to(torch.bfloat16)
            vc = torch.randn((L, B, S, KV * D), generator=g, device=dev).to(torch.bfloat16)
            q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
            kn = torch.randn((B, KV, D), generator=g, device=dev).to(torch.bfloat16)
            vn = torch.randn((B, KV, D), generator=g, device=dev).to(torch.bfloat16)
            cases = [[(p + 300 * b) % S for b in range(B)] for p in (0, 1, 777, S - 1)]
            if B == 8:      # every slot full, as exp_r4_attn's perb runs it
                cases.append([S - 1] * B)
            for ps in cases:
                p = ps[0]
                pos = torch.tensor(ps, dtype=torch.int32, device=dev)
                l = 1
                out = dk.decode_attention(l, q, kn, vn, kc, vc, pos)
                plain = dk.decode_attention_plain(q, kn, vn, kc[l], vc[l], pos)
                err = (out.float() - plain.float()).abs().max().item()
                ref = plain.float().abs().max().item()
                # float tolerance: the kernel rounds its bf16 softmax weights
                # against the running max of its split's 64-row stages, the
                # plain version (as the TPU kernel) against running maxima
                # over chunks of min(1024, S) rows
                tol = 1e-2 * ref + 2e-3
                row = {"S": S, "B": B, "pos": ps, "max_abs_err": err,
                       "ref_max": ref, "tol": tol, "ok": err <= tol}
                if B == 1 and p == S - 1:
                    row["ms"] = time_ms(torch, lambda i: dk.decode_attention(
                        i % L, q, kn, vn, kc, vc, pos), L)
                    row["plain_ms"] = time_ms(torch, lambda i: dk.decode_attention_plain(
                        q, kn, vn, kc[i % L], vc[i % L], pos), 4)
                    mask = (torch.arange(S, device=dev) < p).view(1, 1, 1, S)
                    q4 = q.view(1, H, 1, D)
                    row["library_ms"] = time_ms(torch, lambda i: sdpa(
                        q4, kc[i % L].view(1, S, KV, D).transpose(1, 2),
                        vc[i % L].view(1, S, KV, D).transpose(1, 2),
                        attn_mask=mask, enable_gqa=True), L)
                    nbytes = (2 * p * KV * D * 2 + q.numel() * 2 + 2 * kn.numel() * 2
                              + H * D * 2 + 4)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * H * (p + 1) * D,
                                                             "bf16")
                res["k5"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K5 mismatch: {row}")
            del kc, vc


H20, KV5, D128 = 20, 5, 128           # 2B-4T attention: 20 / 5 heads of 128
ATTN_S = (1024, 4096)                 # cache rows of the K7 / K8 / K9 checks
POOL_B = (3, 8, 18, 64)               # pools of the K8 / K9 checks
QUANT = (("int8", "int8"), ("fp8", "float8_e4m3fn"))


def _codes(torch, g, shape, dtype, dev):
    """Random cache codes: int8 in [-127, 127], or fp8-e4m3 values of
    random magnitude (never NaN)."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    return (torch.randn(shape, generator=g, device=dev) * 64).to(dtype)


def _quant_stack(torch, g, L, B, S, dtype, dev):
    """Cache codes [L, B, S, KV*D] for k and v and their f32 scales
    [L, B, S, KV]."""
    kc, vc = (_codes(torch, g, (L, B, S, KV5 * D128), dtype, dev) for _ in range(2))
    ks, vs = ((torch.rand((L, B, S, KV5), generator=g, device=dev) + 0.5) * 0.01
              for _ in range(2))
    return kc, vc, ks, vs


def _dequant(torch, kc, ks):
    """[L, B, S, KV*D] codes × [L, B, S, KV] scales → bf16 (the library
    yardstick's cache)."""
    L, B, S, _ = kc.shape
    return (kc.view(L, B, S, KV5, D128).float() * ks[..., None]).to(
        torch.bfloat16).view(L, B, S, KV5 * D128)


def _sdpa(torch, q, kc, vc, pos):
    """One PyTorch call with the same function: GQA attention of q [B, H, D]
    over bf16 caches [B, S, KV*D] with rows < pos valid (the port never
    calls it)."""
    B, S = kc.shape[:2]
    mask = (torch.arange(S, device=q.device)[None, :] < pos[:, None].long()
            ).view(B, 1, 1, S)
    return torch.nn.functional.scaled_dot_product_attention(
        q.view(B, H20, 1, D128), kc.view(B, S, KV5, D128).transpose(1, 2),
        vc.view(B, S, KV5, D128).transpose(1, 2), attn_mask=mask, enable_gqa=True)


def _same(torch, a, b) -> bool:
    """Bit equality (fp8 compared as bytes)."""
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return bool(torch.equal(a, b))


def _attn_bound(pos, B_rows, esz, quant):
    """Bytes and operations of one decode-attention call over ``pos`` (the
    valid rows of each slot, summed) — codes (or bf16) of k and v, their
    scales, q, the new rows and the output; 4·H·D operations a row."""
    rows = int(sum(pos)) + B_rows
    nbytes = (2 * rows * KV5 * D128 * esz + (2 * rows * KV5 * 4 if quant else 0)
              + B_rows * (H20 + 2 * KV5) * D128 * 2 + B_rows * H20 * D128 * 2)
    return bound(nbytes, 4.0 * H20 * D128 * rows, "bf16")


def check_k7(torch, dev, g, res):
    """K7 (rope-fused decode attention over an int8 / fp8 cache) against
    its plain version at B in {1, 2}, S in {1024, 4096}, a full cache; the
    new rows' codes and scales must be equal; timed at B=1."""
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    H, KV, D = H20, KV5, D128
    for kv, tname in QUANT:
        dt = getattr(torch, tname)
        for S in ATTN_S:
            for B in (1, 2):
                L = max(2, math.ceil((120 << 20) / (2 * B * S * KV * D)))
                kc, vc, ks, vs = _quant_stack(torch, g, L, B, S, dt, dev)
                qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev
                                  ).to(torch.bfloat16)
                ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
                sin, cos = torch.sin(ang), torch.cos(ang)
                ps = [S - 1] if B == 1 else [S - 1, S // 2]
                pos = torch.tensor(ps, dtype=torch.int32, device=dev)
                l = 1
                out = da.decode_attention_qkv_quant(l, qkv, sin, cos, kc, vc, ks,
                                                    vs, pos, H, KV)
                pl = da.decode_attention_qkv_quant_plain(
                    qkv, sin, cos, kc[l], vc[l], ks[l], vs[l], pos, H, KV)
                err = (out[0].float() - pl[0].float()).abs().max().item()
                ref = pl[0].float().abs().max().item()
                # float tolerance: K2's (the split softmax rounds its bf16
                # weights against other maxima than the chunked plain version)
                tol = 1e-2 * ref + 2e-3
                row = {"kv": kv, "S": S, "B": B, "pos": ps, "max_abs_err": err,
                       "ref_max": ref, "tol": tol,
                       "rows_exact": all(_same(torch, a, b)
                                         for a, b in zip(out[1:], pl[1:]))}
                row["ok"] = row["rows_exact"] and err <= tol
                if B == 1:
                    row["ms"] = time_ms(torch, lambda i: da.decode_attention_qkv_quant(
                        i % L, qkv, sin, cos, kc, vc, ks, vs, pos, H, KV), L)
                    row["plain_ms"] = time_ms(torch, lambda i: da.decode_attention_qkv_quant_plain(
                        qkv, sin, cos, kc[i % L], vc[i % L], ks[i % L], vs[i % L], pos,
                        H, KV), 4)
                    kb, vb = _dequant(torch, kc, ks), _dequant(torch, vc, vs)
                    q = pl[0]
                    row["library_ms"] = time_ms(torch, lambda i: _sdpa(
                        torch, q, kb[i % L], vb[i % L], pos), L)
                    del kb, vb
                    row["bound_ms"], row["bound_by"] = _attn_bound(ps, B, 1, True)
                res["k7"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K7 mismatch: {row}")
                del kc, vc, ks, vs


def check_k8_k9(torch, dev, g, res):
    """K8 (bf16) and K9 (int8, fp8) pool decode attention against their
    plain versions at B in {3, 8, 18, 64}, S in {1024, 4096}: once with
    mixed lengths and an idle slot (pos 0), once with a full cache (timed)."""
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    H, KV, D = H20, KV5, D128
    for kv in ("bf16", "int8", "fp8"):
        quant = kv != "bf16"
        dt = getattr(torch, dict(QUANT).get(kv, "bfloat16"))
        key = "k9" if quant else "k8"
        for S in ATTN_S:
            for B in POOL_B:
                esz = 1 if quant else 2
                L = max(2, math.ceil((120 << 20) / (2 * B * S * KV * D * esz)))
                if quant:
                    kc, vc, ks, vs = _quant_stack(torch, g, L, B, S, dt, dev)
                else:
                    kc, vc = (torch.randn((L, B, S, KV * D), generator=g, device=dev
                                          ).to(torch.bfloat16) for _ in range(2))
                q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
                kn, vn = (torch.randn((B, KV, D), generator=g, device=dev)
                          for _ in range(2))
                if quant:       # the new rows arrive round-tripped, in bf16
                    kn, vn = (da.dequantize_kv(*da.quantize_kv(x, dt)) for x in (kn, vn))
                kn, vn = kn.to(torch.bfloat16), vn.to(torch.bfloat16)
                mixed = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                                      dtype=torch.int32)
                mixed[B // 2] = 0
                full = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
                l = 1
                if quant:
                    def run(i, pos):
                        return da.decode_attention_quant_batched(
                            i, q, kn, vn, kc, vc, ks, vs, pos)

                    def plain(i, pos):
                        return da.decode_attention_quant_batched_plain(
                            q, kn, vn, kc[i], vc[i], ks[i], vs[i], pos)
                else:
                    def run(i, pos):
                        return da.decode_attention_batched(i, q, kn, vn, kc, vc, pos)

                    def plain(i, pos):
                        return da.decode_attention_batched_plain(
                            q, kn, vn, kc[i], vc[i], pos)
                for name, pos in (("mixed", mixed), ("full", full)):
                    out, pl = run(l, pos), plain(l, pos)
                    err = (out.float() - pl.float()).abs().max().item()
                    ref = pl.float().abs().max().item()
                    # float tolerance: as K5's (bf16 softmax weights rounded
                    # against split maxima, the plain version against the TPU
                    # kernel's chunk maxima)
                    tol = 1e-2 * ref + 2e-3
                    row = {"kv": kv, "S": S, "B": B, "pos": name,
                           "max_abs_err": err, "ref_max": ref, "tol": tol,
                           "ok": err <= tol}
                    # an idle slot's output is the new token's v
                    if name == "mixed":
                        idle = out[B // 2].float().view(KV, H // KV, D)
                        row["idle_is_v"] = bool(torch.equal(
                            idle, vn[B // 2].float()[:, None, :].expand_as(idle)))
                        row["ok"] = row["ok"] and row["idle_is_v"]
                    if name == "full":
                        row["ms"] = time_ms(torch, lambda i: run(i % L, pos), L)
                        row["plain_ms"] = time_ms(torch, lambda i: plain(i % L, pos), 2)
                        if quant:
                            kb, vb = _dequant(torch, kc[:2], ks[:2]), _dequant(torch, vc[:2], vs[:2])
                        else:
                            kb, vb = kc, vc
                        nl = kb.shape[0]
                        row["library_ms"] = time_ms(torch, lambda i: _sdpa(
                            torch, q, kb[i % nl], vb[i % nl], pos), nl)
                        del kb, vb
                        row["bound_ms"], row["bound_by"] = _attn_bound(
                            pos.tolist(), B, esz, quant)
                    res[key].append(row)
                    if not row["ok"]:
                        raise AssertionError(f"{key.upper()} mismatch: {row}")
                del kc, vc
                if quant:
                    del ks, vs


def check_k3_quant(torch, dev, g, res):
    """K3 on int8 / fp8 rows with their scales, at a B=8 pool of the 2B-4T
    shapes (L=30, S=1024), pos >= S included: bit for bit."""
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    L, B, S = 30, 8, 1024
    for kv, tname in QUANT:
        dt = getattr(torch, tname)
        kc, vc, ks, vs = _quant_stack(torch, g, L, B, S, dt, dev)
        kr, vr, ksr, vsr = _quant_stack(torch, g, L, B, 1, dt, dev)
        pos = torch.tensor([5, S - 1, S, S + 7, 0, 100, 200, 1000],
                           dtype=torch.int32, device=dev)
        ref = [t.clone() for t in (kc, vc, ks, vs)]
        da.scatter_kv_rows(kc, vc, kr, vr, pos, ks, vs, ksr, vsr)
        da.scatter_kv_rows_plain(*ref[:2], kr, vr, pos, *ref[2:], ksr, vsr)
        exact = all(_same(torch, a, b) for a, b in zip((kc, vc, ks, vs), ref))
        row = {"kv": kv, "B": B, "tol": 0.0, "exact": exact, "max_abs_err": 0.0 if exact
               else float("inf")}
        row["ms"] = time_ms(torch, lambda i: da.scatter_kv_rows(
            kc, vc, kr, vr, pos, ks, vs, ksr, vsr))
        row["plain_ms"] = time_ms(torch, lambda i: da.scatter_kv_rows_plain(
            kc, vc, kr, vr, pos, ks, vs, ksr, vsr))
        row["bound_ms"], row["bound_by"] = bound(2 * L * B * (KV5 * D128 + KV5 * 4) * 2,
                                                 0, "bf16")
        row["ok"] = exact
        res["k3q"].append(row)
        if not row["ok"]:
            raise AssertionError(f"K3 (quantized) mismatch: {row}")
        del kc, vc, ks, vs, ref


def _block_stack(torch, g, K, N, dev, min_bytes=120 << 20):
    """Words and f32 block scales [L, K/32, N] (f16 values in the loader's
    range), enough layers that cycling through them exceeds the L2."""
    L = max(2, math.ceil(min_bytes / (K * N // 4 + K * N // 8)))
    words = torch.randint(-2**31, 2**31, (L, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
    s = (torch.rand((L, K // 32, N), generator=g, device=dev) * 0.02 + 0.01).half().float()
    return words, s


def _dense_block_stack(torch, words, s, lut_bias, min_bytes=120 << 20):
    """bf16 dense copies (the dequantized weights, value times scale) of the
    first layers of a block-scale stack: the library yardstick's weights."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    K, N = words.shape[1] * 16, words.shape[2]
    n = min(words.shape[0], max(2, math.ceil(min_bytes / (K * N * 2))))
    return [tm.block_weights(words[l], s[l], lut_bias, True) for l in range(n)]


def _block_bytes(M, K, N, x_bytes, out_bytes, extra=0):
    """Words, f32 block scales, activations and outputs of one call."""
    return K * N // 4 + K * N // 8 + M * K * x_bytes + M * N * out_bytes + extra


# K10's extra shapes: the 8B down projection (K = 14336) and the tl phase's
# (d) down projection, K = 6784 < Kp = 6912 (x rows past K read as 0)
K10_WIDE = (("down_8b", 14336, 4096, "8b"), ("down_6784", 6784, 2560, "unaligned"))
# the GEMM form's rows over the fused four, each timed (the M table)
K10_TIMED = (17, 64, 128, 512, 2048)


def _sum32_ok(torch, got, want, xb):
    """32-row sums of the same bf16 values in two orders: within the f32
    bound of either order, 2·31·2^-24·Σ|x| a block."""
    abs32 = xb.float().abs().view(xb.shape[0], -1, 32).sum(-1)
    return bool(((got - want).abs() <= 2 * 31 * 2.0**-24 * abs32).all())


def check_k10(torch, dev, g, res):
    """K10 against its plain version: the generic path's seven unfused
    shapes at M in {1, 2, 4, 8, 16, 512} (the ``:1177`` site's decode, and a
    prefill bucket), the fused four at M in {1} + K10_TIMED (M=1: the stacked
    ``:555`` site's decode; more rows: the GEMM form of every bitnet32 / TL
    prefill), K = 14336 and K = 6784 (K < Kp) at M in {1, 2, MB, MB + 1, 77};
    lut_bias both ways, bf16 and f32 x.  At M <= 16 both forms (the decode
    form and the GEMM) are held against the plain version and timed side by
    side (the MB table), the wrapper's output equals the form it takes bit
    for bit, and two decode-form calls give the same bits.  Past MB the GEMM
    form's bf16 rows equal ``blockscale_rows_plain``'s bit for bit, its
    32-row sums agree to f32 order (their bf16 split is
    ``blockscale_sums_split`` of them bit for bit), and two calls give the
    same bits.
    Wrapper times (``ms``, plain and library) on TL weights and bf16 x at
    M=1 and 512, and at every K10_TIMED M on the fused four, with the time
    of the f32 correction matmul the GEMM form no longer runs
    (``corr_ms``)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    MB = tm.BLOCKSCALE_DECODE_MAX_M
    cells = ([("unfused", n, K, N, (1, 2, 4, 8, 16, 512)) for n, K, N, *_ in UNFUSED_SHAPES]
             + [("fused", n, K, N, (1,) + K10_TIMED) for n, K, N, *_ in K1_SHAPES]
             + [(path, n, K, N, sorted({1, 2, MB, MB + 1, 77}))
                for n, K, N, path in K10_WIDE])
    for path, name, K, N, Ms in cells:
        Kp = -(-K // 256) * 256
        words, s = _block_stack(torch, g, Kp, N, dev)
        s[:, K // 32:] = 0                    # as the loader pads them
        L = words.shape[0]
        for M in Ms:
            for lut_bias in (False, True):
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                    l = 1
                    out = tm.ternary_matmul_blockscale_bf16(l, x, words, s, K, N, lut_bias)
                    xb, sum32 = tm.blockscale_rows_plain(x, Kp)
                    corr = tm.blockscale_correction(sum32, s[l])
                    plain = tm.ternary_matmul_blockscale_bf16_plain(
                        xb, corr, words[l], s[l], N, lut_bias, dtype)
                    ref = plain.float().abs().max().item()
                    # float tolerance: the exact bf16 x bf16 products are
                    # summed in f32 in another order (lanes and warps over
                    # K, a cluster's partials; tensor-core tiles; one
                    # matmul), so a bf16 output can move by one ulp: two
                    # ulps of the largest output.  f32 outputs: the decode
                    # form's IEEE f32 sums of K terms of random sign stay
                    # within ~sqrt(K) * 2^-24 of their magnitudes, under
                    # 1e-6 of the largest output here: 1e-5 of it; the
                    # GEMM's wgmma accumulates without IEEE rounding (its
                    # addends are aligned and truncated), as mma.sync did
                    # (up to 2.3e-5 of the largest output seen on the
                    # H100): 1e-4 of it
                    if dtype == torch.bfloat16:
                        tol = tol_gemm = 8e-3 * ref
                    else:
                        tol, tol_gemm = 1e-5 * ref, 1e-4 * ref
                    form = "decode" if M <= MB else "gemm"
                    row = {"path": path, "shape": name, "M": M, "K": K, "N": N,
                           "lut_bias": lut_bias, "x": str(dtype)[6:], "ref_max": ref,
                           "tol": tol, "tol_gemm": tol_gemm, "form": form}
                    errs = [(out.float() - plain.float()).abs().max().item()]
                    ok = errs[0] <= (tol if form == "decode" else tol_gemm)
                    gem, gxb, gsum, gsplit = tm._blockscale_gemm_cuda(l, x, words, s, K, N,
                                                                      lut_bias)
                    row["rows_exact"] = bool(torch.equal(gxb, xb) and torch.equal(
                        gsplit, tm.blockscale_sums_split(gsum)))
                    row["sum32_ok"] = _sum32_ok(torch, gsum, sum32, xb)
                    ok = ok and row["rows_exact"] and row["sum32_ok"]
                    if M <= 16:
                        dec = tm._blockscale_decode_cuda(l, x, words, s, K, N, lut_bias)
                        dec2 = tm._blockscale_decode_cuda(l, x, words, s, K, N, lut_bias)
                        row["decode_err"] = (dec.float() - plain.float()).abs().max().item()
                        row["gemm_err"] = (gem.float() - plain.float()).abs().max().item()
                        row["wrapper_is_form"] = bool(torch.equal(
                            out, dec if form == "decode" else gem))
                        row["decode_repeats"] = bool(torch.equal(dec, dec2))
                        errs += [row["decode_err"], row["gemm_err"]]
                        ok = (ok and row["decode_err"] <= tol
                              and row["gemm_err"] <= tol_gemm
                              and row["wrapper_is_form"] and row["decode_repeats"])
                    else:
                        again = tm.ternary_matmul_blockscale_bf16(l, x, words, s, K, N,
                                                                  lut_bias)
                        row["wrapper_is_form"] = bool(torch.equal(out, gem))
                        row["gemm_repeats"] = bool(torch.equal(out, again))
                        ok = ok and row["wrapper_is_form"] and row["gemm_repeats"]
                    row["max_abs_err"] = max(errs)
                    row["ok"] = ok
                    bf16_tl = not lut_bias and dtype == torch.bfloat16
                    if bf16_tl and M <= 16 and path in ("unfused", "fused"):
                        row["decode_ms"] = time_ms(torch, lambda i: tm._blockscale_decode_cuda(
                            i % L, x, words, s, K, N, False), L)
                        row["gemm_ms"] = time_ms(torch, lambda i: tm._blockscale_gemm_cuda(
                            i % L, x, words, s, K, N, False)[0], L)
                    timed = M in (1, 512) or (path == "fused" and M in K10_TIMED)
                    if bf16_tl and timed and path in ("unfused", "fused"):
                        row["ms"] = time_ms(torch, lambda i: tm.ternary_matmul_blockscale_bf16(
                            i % L, x, words, s, K, N, False), L)
                        row["plain_ms"] = time_ms(torch, lambda i: (
                            tm.ternary_matmul_blockscale_bf16_plain(
                                xb, corr, words[i % L], s[i % L], N, False, x.dtype)), 4)
                        dense = _dense_block_stack(torch, words, s, False)
                        row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
                            x, dense[i % len(dense)]), 2 * len(dense))
                        del dense
                        if M > MB:
                            row["corr_ms"] = time_ms(torch, lambda i: tm.blockscale_correction(
                                sum32, s[i % L]), L)
                        row["bound_ms"], row["bound_by"] = bound(
                            _block_bytes(M, K, N, 2, 2), 2.0 * M * K * N, "bf16")
                    res["k10"].append(row)
                    if not ok:
                        raise AssertionError(f"K10 mismatch: {row}")
        del words, s


# The kernels phase's profiled calls, in a fresh process that runs nothing
# else: in a process that had run much else the profiler on the card now and
# then caught no kernel at all.  For each call (``PROFILES``, passed as JSON)
# the child builds the operands from a seed, makes one call to build and
# warm up, profiles one call after another in the profiler's warm-up step
# (without it the tracer now and then lost the first kernel it traced), and
# prints one line: the kernels, the ATen ops and the launches the wrapper
# counted.  Its first session pays the tracer's start; one process a call,
# one after the other, took most of the phase.
_PROFILE_CHILD = """
import json, sys, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da
from bitnet_tpu_torch.ops import ternary_matmul as tm
dev = torch.device("cuda", 0)
def words(K, N, scale_rows):
    return (torch.randint(-2**31, 2**31, (2, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev),
            torch.rand((2, K // 32, N) if scale_rows else (2, N), generator=g,
                       device=dev) * 0.02 + 0.01)
for key, (setup, call, counter, _kernels, module) in json.loads(sys.argv[1]).items():
    g = torch.Generator(device=dev).manual_seed(0)
    exec(setup)
    fn = eval("lambda: " + call)
    fn()
    torch.cuda.synchronize()
    ctr = getattr(globals()[module], counter)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in range(2):
            before = ctr.launches
            fn()
            torch.cuda.synchronize()
            prof.step()
    print(json.dumps({"key": key,
        "kernels": [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")],
        "aten_ops": sorted({e.name for e in prof.events() if e.name.startswith("aten::")}),
        "launches": ctr.launches - before}), flush=True)
"""


def _k11_profile(K, N, glu):
    return (f"w, s = words({K}, {N}, True)\n"
            f"gamma = torch.rand((2, {K}), generator=g, device=dev) + 0.5\n"
            f"x = torch.randn((1, {2 * K if glu else K}), generator=g, device=dev)"
            f".bfloat16()\n"
            f"r = torch.randn((1, {N}), generator=g, device=dev).bfloat16()",
            f"tm.ternary_matmul_tl_w2a8_normed(1, x, w, s, gamma, {K}, {N}, 1e-5, {glu}, r)",
            "ternary_matmul_tl_w2a8_normed", 1, "tm")


_K6_SETUP = ("w, _s = words(2560, 640, False)\n"
             "s = torch.rand((2, 640), generator=g, device=dev) * 0.02 + 0.01\n")
_ATTN_SETUP = ("kc = torch.randn((2, 1, 4096, 640), generator=g, device=dev).bfloat16()\n"
               "vc = torch.randn_like(kc)\n"
               "pos = torch.tensor([4095], dtype=torch.int32, device=dev)\n"
               "q = torch.randn((1, 20, 128), generator=g, device=dev).bfloat16()\n"
               "kn = torch.randn((1, 5, 128), generator=g, device=dev).bfloat16()\n"
               "qkv = torch.randn((1, 30, 128), generator=g, device=dev).bfloat16()\n"
               "ang = torch.rand((1, 64), generator=g, device=dev)\n"
               "sin, cos = ang.sin(), ang.cos()")
# the kernels phase's profiled calls, key -> (setup, call, the wrapper's
# counter, the kernels it must launch, its module); the checks named in
# each comment read their results
PROFILES = {
    # check_k4_forms: K4's two kernels
    "k4_profile": ("w, sv = words(2048, 640, False)\n"
                   "x = torch.randn((512, 2048), generator=g, device=dev).bfloat16()",
                   "tm.ternary_matmul_w2a8(1, x, w, sv, 2048, 640)",
                   "ternary_matmul_w2a8", 2, "tm"),
    # check_k6_forms: K6's decode form one kernel, its GEMM form two
    "k6_decode_profile": (
        _K6_SETUP + "x = torch.randn((1, 2560), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_bf16(1, x, w, s, 2560, 640)", "ternary_matmul_bf16", 1, "tm"),
    "k6_gemm_profile": (
        _K6_SETUP + "x = torch.randn((512, 2560), generator=g, device=dev).bfloat16()",
        "tm.ternary_matmul_bf16(1, x, w, s, 2560, 640)", "ternary_matmul_bf16", 2, "tm"),
    # check_k10_forms: K10's GEMM form and K12, two kernels each
    "k10_profile": ("w, s = words(2560, 640, True)\n"
                    "x = torch.randn((512, 2560), generator=g, device=dev).bfloat16()",
                    "tm.ternary_matmul_blockscale_bf16(1, x, w, s, 2560, 640, False)",
                    "ternary_matmul_blockscale_bf16", 2, "tm"),
    "k12_profile": ("w, s = words(2560, 640, True)\n"
                    "gamma = torch.rand((2, 2560), generator=g, device=dev) + 0.5\n"
                    "x = torch.randn((8, 2560), generator=g, device=dev).bfloat16()\n"
                    "r = torch.randn((8, 640), generator=g, device=dev).bfloat16()",
                    "tm.ternary_matmul_tl_bf16_normed(1, x, w, s, gamma, 2560, 640, 1e-5, "
                    "False, r)", "ternary_matmul_tl_bf16_normed", 2, "tm"),
    # check_k11_profile: K11 at K = 2560 and 14336 (the 8B down projection,
    # SwiGLU and the residual), one kernel
    "k11_profile_2560": _k11_profile(2560, 2560, False),
    "k11_profile_14336": _k11_profile(14336, 4096, True),
    # check_attn_profiles: K5 and K2 at B=1, S=4096, one launch each
    "k5_profile": (_ATTN_SETUP, "dk.decode_attention(1, q, kn, kn, kc, vc, pos)",
                   "decode_attention", 1, "dk"),
    "k2_profile": (_ATTN_SETUP,
                   "da.decode_attention_qkv(1, qkv, sin, cos, kc, vc, pos, 20, 5)",
                   "decode_attention_qkv", 1, "da"),
}


def _profile_calls():
    """Every call of ``PROFILES`` under the profiler, in one fresh process
    (``_PROFILE_CHILD``).  A result is ok when the wrapper
    (``{module}.{counter}``: ``tm`` the ternary matmuls, ``dk`` / ``da`` the
    decode attention's two modules) counted one launch, the profiler saw the
    row's number of kernels and no ATen op but ``aten::empty``."""
    r = subprocess.run([sys.executable, "-c", _PROFILE_CHILD, json.dumps(PROFILES)],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    if r.returncode != 0:
        raise AssertionError(f"profiled calls failed: {r.stderr[-3000:]}")
    out = {}
    for line in r.stdout.splitlines():
        if not line.startswith('{"key"'):
            continue
        row = json.loads(line)
        key = row.pop("key")
        row["ok"] = (row["launches"] == 1 and len(row["kernels"]) == PROFILES[key][3]
                     and set(row["aten_ops"]) <= {"aten::empty"})
        out[key] = row
    if set(out) != set(PROFILES):
        raise AssertionError(f"profiled calls missing: {set(PROFILES) - set(out)}")
    return out


def check_k10_forms(torch, dev, g, res, eps=1e-5):
    """Every form of the block-scale GEMM (BT rows a block x a K split of
    1-8), forced past the plan, for K10's GEMM form and K12: ragged M, N =
    192 (a block whose second column half lies past Np) and 640, f32 and
    bf16 x, K10 at K < Kp, K12 with SwiGLU, norm and the residual, against
    the plain versions (the tolerances of check_k10 and check_k11_k12); then
    one call each under the profiler: two kernels and no ATen op but
    ``aten::empty``."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    Kp = 2048
    for N, dtype in ((192, torch.float32), (640, torch.bfloat16)):
        words, s = _block_stack(torch, g, Kp, N, dev, min_bytes=0)
        s[:, (Kp - 96) // 32:] = 0            # K10's K < Kp, as the loader pads
        gamma = torch.rand((words.shape[0], Kp), generator=g, device=dev) + 0.5
        for bt in tm.BLOCKSCALE_GEMM_ROWS:
            for split in (1, 2, 4, 8):
                M, K = bt + 1, Kp - 96
                with mock.patch.object(tm, "blockscale_gemm_plan", lambda *a: (bt, split)):
                    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                    out, xb_k, sum_k, split_k = tm._blockscale_gemm_cuda(1, x, words, s, K,
                                                                        N, True)
                    x12 = torch.randn((M, 2 * Kp), generator=g, device=dev).to(dtype)
                    r12 = torch.randn((M, N), generator=g, device=dev).to(dtype)
                    out12 = tm._tl_bf16_launch(1, x12, words, s, gamma, Kp, N, eps, True,
                                               r12, False)
                xb, sum32 = tm.blockscale_rows_plain(x, Kp)
                plain = tm.ternary_matmul_blockscale_bf16_plain(
                    xb, tm.blockscale_correction(sum32, s[1]), words[1], s[1], N, True,
                    dtype)
                plain12 = tm.ternary_matmul_tl_bf16_normed_plain(
                    x12, words[1], s[1], gamma[1], eps, True, r12, N, False)
                ref = plain.float().abs().max().item()
                ref12 = plain12.float().abs().max().item()
                err = (out.float() - plain.float()).abs().max().item()
                err12 = (out12.float() - plain12.float()).abs().max().item()
                tol = (8e-3 if dtype == torch.bfloat16 else 1e-4) * ref
                tol12 = 1e-2 * ref12 + 1e-3
                row = {"path": "forms", "M": M, "K": K, "Kp": Kp, "N": N, "bt": bt,
                       "split": split, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err, "tol": tol, "k12_err": err12, "k12_tol": tol12,
                       "rows_exact": bool(torch.equal(xb_k, xb) and torch.equal(
                           split_k, tm.blockscale_sums_split(sum_k))),
                       "sum32_ok": _sum32_ok(torch, sum_k, sum32, xb)}
                row["ok"] = (err <= tol and err12 <= tol12 and row["rows_exact"]
                             and row["sum32_ok"])
                res["k10"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K10 / K12 form mismatch: {row}")
    for key in ("k10_profile", "k12_profile"):
        if not res[key]["ok"]:
            raise AssertionError(f"{key[:3].upper()} launched more than its two "
                                 f"kernels: {res[key]}")


def _k11_row(torch, tm, l, x, words, s, gamma, K, N, eps, glu, resid, lut_bias, atol):
    """One K11 call against its gates: within K1's gate of its plain
    version, its int8 rows, scales and sums K1's on the same input bit for
    bit, the wrapper's output the launch's bit for bit, and its output the
    exact block partials of its own rows to f32 rounding (``atol``: the f32
    sums' order where outputs cancel to near zero)."""
    L = words.shape[0]
    g_l = None if gamma is None else gamma[l]
    out = tm.ternary_matmul_tl_w2a8_normed(l, x, words, s, gamma, K, N, eps, glu, resid,
                                           lut_bias)
    plain = tm.ternary_matmul_tl_w2a8_normed_plain(x, words[l], s[l], g_l, eps, glu, resid,
                                                   N, lut_bias)
    out2, xq, sx, sumq = tm._tl_w2a8_cuda(l, x, words, s, gamma, K, N, eps, glu, resid,
                                          lut_bias)
    ones = torch.ones((L, N), device=x.device)
    _o, xq1, sx1, sumq1 = tm._w2a8_normed_cuda(l, x, words, ones, gamma, K, N, eps, glu,
                                               None)
    part = tm.tl_block_partials(xq, words[l], lut_bias).float()
    y = (part * s[l][:, None, :]).sum(0) * sx[:, None]
    if resid is not None:
        y = y + resid.float()
    err = (out.float() - plain.float()).abs().max().item()
    ref = plain.float().abs().max().item()
    tol = 2e-2 * ref + 1e-3               # K1's: an int8 activation one step off
    row = {"M": x.shape[0], "K": K, "N": N, "lut_bias": lut_bias, "max_abs_err": err,
           "ref_max": ref, "tol": tol,
           "rows_equal_k1": bool(torch.equal(xq, xq1) and torch.equal(sx, sx1)
                                 and torch.equal(sumq, sumq1)),
           "wrapper_equals_launch": bool(torch.equal(out, out2)),
           # the bf16 output is y rounded once (f32 order aside)
           "partials_epilogue_ok": bool(
               ((out.float() - y).abs() <= 2**-8 * y.abs() + atol).all())}
    row["ok"] = (err <= tol and row["rows_equal_k1"] and row["wrapper_equals_launch"]
                 and row["partials_epilogue_ok"])
    return row


def _k11_time(torch, tm, row, x, words, s, gamma, K, N, eps, glu, resid):
    """K11's ms, its plain version's, the library's (``torch.matmul`` of the
    preamble's bf16 rows and the dequantized bf16 weights) and its bound (its
    words, block scales, x, gamma, resid and out, each moved once)."""
    L, M = words.shape[0], x.shape[0]
    g_l = None if gamma is None else gamma[1]
    row["ms"] = time_ms(torch, lambda i: tm.ternary_matmul_tl_w2a8_normed(
        i % L, x, words, s, gamma, K, N, eps, glu, resid, False), L)
    row["plain_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_tl_w2a8_normed_plain(
        x, words[i % L], s[i % L], g_l, eps, glu, resid, N, False), 4)
    dense = _dense_block_stack(torch, words, s, False)
    xin = tm.w2a8_preamble_plain(x, g_l, eps, glu).to(torch.bfloat16)
    row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
        xin, dense[i % len(dense)]), 2 * len(dense))
    del dense
    nbytes = _block_bytes(M, K, N, 0, 2, x.numel() * 2
                          + (M * N * 2 if resid is not None else 0)
                          + (K * 4 if gamma is not None else 0))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * K * N, "int8")


# K11's timed rows (the M table, kernels.k11_m): M = 1 and 2, TL codes
K11_TIMED = (1, 2)


def check_k11_k12(torch, dev, g, res, eps=1e-5):
    """K11 (W2A8 with block scales, M in {1, 2}) and K12 (bf16 rows x the
    unbiased block-scaled weights, M in {3, 8, 33, 64}) at the fused path's
    four shapes, against their plain versions, lut_bias both ways.  K11's
    int8 rows are K1's on the same input bit for bit, and its output equals
    the exact block partials of its own rows to f32 rounding; two K12 calls
    give the same bits.  Timed at M = 1, 2 (K11) and M = 8, 64 (K12)."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    for name, K, N, has_g, glu, has_r in K1_SHAPES:
        words, s = _block_stack(torch, g, K, N, dev)
        L = words.shape[0]
        gamma = (torch.rand((L, K), generator=g, device=dev) + 0.5) if has_g else None
        for M in (1, 2):
            for lut_bias in (False, True):
                x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev
                                ).to(torch.bfloat16)
                resid = (torch.randn((M, N), generator=g, device=dev)
                         .to(torch.bfloat16) if has_r else None)
                row = {"shape": name, **_k11_row(torch, tm, 1, x, words, s, gamma, K, N,
                                                 eps, glu, resid, lut_bias, 1e-6)}
                if not lut_bias and M in K11_TIMED:
                    _k11_time(torch, tm, row, x, words, s, gamma, K, N, eps, glu, resid)
                res["k11"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K11 mismatch: {row}")
        fn, pfn = tm.ternary_matmul_tl_bf16_normed, tm.ternary_matmul_tl_bf16_normed_plain
        for M in (3, 8, 33, 64):
            for lut_bias in (False, True):
                x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev
                                ).to(torch.bfloat16)
                resid = (torch.randn((M, N), generator=g, device=dev)
                         .to(torch.bfloat16) if has_r else None)
                l = 1
                g_l = None if gamma is None else gamma[l]
                out = fn(l, x, words, s, gamma, K, N, eps, glu, resid, lut_bias)
                plain = pfn(x, words[l], s[l], g_l, eps, glu, resid, N, lut_bias)
                err = (out.float() - plain.float()).abs().max().item()
                ref = plain.float().abs().max().item()
                # float tolerance: a bf16 row value one ulp off plus two ulps
                # of output rounding
                tol = 1e-2 * ref + 1e-3
                row = {"shape": name, "M": M, "K": K, "N": N, "lut_bias": lut_bias,
                       "max_abs_err": err, "ref_max": ref, "tol": tol}
                again = fn(l, x, words, s, gamma, K, N, eps, glu, resid, lut_bias)
                row["repeats"] = bool(torch.equal(out, again))    # the same bits
                row["ok"] = err <= tol and row["repeats"]
                if not lut_bias and M in (8, 64):
                    row["ms"] = time_ms(torch, lambda i: fn(
                        i % L, x, words, s, gamma, K, N, eps, glu, resid, False), L)
                    row["plain_ms"] = time_ms(torch, lambda i: pfn(
                        x, words[i % L], s[i % L], g_l, eps, glu, resid, N, False), 4)
                    dense = _dense_block_stack(torch, words, s, False)
                    xin = tm.w2a8_preamble_plain(x, g_l, eps, glu).to(torch.bfloat16)
                    row["library_ms"] = time_ms(torch, lambda i: torch.matmul(
                        xin, dense[i % len(dense)]), 2 * len(dense))
                    del dense
                    nbytes = _block_bytes(M, K, N, 0, 2, x.numel() * 2
                                          + (M * N * 2 if has_r else 0)
                                          + (K * 4 if has_g else 0))
                    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * M * K * N,
                                                             "bf16")
                res["k12"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K12 mismatch: {row}")
        del words, s


# Slice 6: the 8B-class model (Llama-3-8B-1.58 shapes: H=4096, F=14336)
H8B, F8B = 4096, 14336
# K1 at its fused four (no sub-norms: o and down take no gamma; down its
# SwiGLU in the preamble and the residual): (name, K, N, gamma, glu, resid)
K1_8B_SHAPES = (("qkv_8b", H8B, 6144, True, False, False),
                ("o_8b", H8B, H8B, False, False, True),
                ("gate_up_8b", H8B, 2 * F8B, True, False, False),
                ("down_8b", F8B, H8B, False, True, True))
# K4 at the 8B fused four: qkv (32 + 2·8 heads of 128), o, gate|up, down
K4_8B_SHAPES = (("qkv_8b", H8B, 6144), ("o_8b", H8B, H8B),
                ("gate_up_8b", H8B, 2 * F8B), ("down_8b", F8B, H8B))


def check_k11_wide(torch, dev, g, res, eps=1e-5):
    """K11 at the 8B fused four (``K1_8B_SHAPES`` with block scales: qkv, o,
    gate|up at K = 4096 and the down projection at K = 14336, with SwiGLU
    and the residual, no gamma; one launch at every K), M in {1, 2},
    lut_bias both ways: against its plain version (K1's gate), its int8
    rows against K1's bit for bit, its output against the exact block
    partials of its own rows.  Timed at M = 1 and 2; the M table
    (``k11_m``) sums each path's shapes per M."""
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    for name, K, N, has_g, glu, has_r in K1_8B_SHAPES:
        words, s = _block_stack(torch, g, K, N, dev)
        L = words.shape[0]
        gamma = (torch.rand((L, K), generator=g, device=dev) + 0.5) if has_g else None
        for M in (1, 2):
            for lut_bias in (False, True):
                x = torch.randn((M, 2 * K if glu else K), generator=g, device=dev
                                ).to(torch.bfloat16)
                resid = (torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
                         if has_r else None)
                row = {"shape": name, **_k11_row(torch, tm, 1, x, words, s, gamma, K, N,
                                                 eps, glu, resid, lut_bias, 1e-5)}
                if not lut_bias and M in K11_TIMED:
                    _k11_time(torch, tm, row, x, words, s, gamma, K, N, eps, glu, resid)
                res["k11_8b"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K11 (8B) mismatch: {row}")
        del words, s
    fields = ("ms", "library_ms", "bound_ms", "plain_ms")
    res["k11_m"] = [
        {"path": path, "M": M, **{f: sum(r[f] for r in res[key] if r["M"] == M
                                         and "ms" in r and pick(r)) for f in fields}}
        for path, key, pick in (("2b four", "k11", lambda r: True),
                                ("8b four", "k11_8b", lambda r: True),
                                ("8b down", "k11_8b", lambda r: r["shape"] == "down_8b"))
        for M in K11_TIMED]


def check_k11_profile(res):
    """One K11 call at M=1 under the profiler at K = 2560 and 14336 (the 8B
    down projection, SwiGLU and the residual): one kernel, K1's decode
    kernel in its block-scale mode, and no ATen op but ``aten::empty``."""
    rows = []
    for K in (2560, 14336):
        row = res.pop(f"k11_profile_{K}")
        row["K"] = K
        row["ok"] = row["ok"] and "w2a8_decode" in row["kernels"][0]
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"K11 is not one launch of w2a8_decode: {row}")
    res["k11_profile"] = rows


def _k24_stacks(torch, g, K, F, H, dev, min_bytes=120 << 20):
    """gate|up words [L, K/16, 2F] and column scales [L, 2F], down words
    [L, F/16, H] and scales [L, H], enough layers to exceed the L2."""
    L = max(2, math.ceil(min_bytes / (K * 2 * F // 4 + F * H // 4)))
    gu = torch.randint(-2**31, 2**31, (L, K // 16, 2 * F), dtype=torch.int32,
                       generator=g, device=dev)
    sg = (torch.rand((L, 2 * F), generator=g, device=dev) + 0.5) * 0.02
    dw = torch.randint(-2**31, 2**31, (L, F // 16, H), dtype=torch.int32,
                       generator=g, device=dev)
    sd = torch.full((L, H), 0.02, device=dev)
    return gu, sg, dw, sd


# K24's edges at a depth of two layers, (K, Kp, F, H, Ms, dtypes): every BT
# boundary at the 8B widths; F = 2304 (bf = 256, n_f = 9: more tiles than a
# portable cluster, so a rank holds two and the tile-order sum crosses
# ranks); Hp = 320 (a down block with one column half); x unpadded with
# K < Kp (rows past K quantize to zeros)
K24_EDGES = ((H8B, H8B, F8B, H8B, (9, 16, 17), ("bfloat16",)),
             (512, 512, 2304, 512, (1, 17), ("bfloat16",)),
             (512, 512, 512, 320, (3, 32), ("bfloat16", "float32")),
             (416, 512, 1024, 384, (1, 9), ("bfloat16", "float32")))
K24_MB = (1, 2, 4, 8, 16, 32)


def check_k24(torch, dev, g, res):
    """K24 (the fused W2A8 FFN) against its plain version at the 8B FFN
    shapes (K = H = 4096, F = 14336: bf = 3584, four requantization tiles),
    M in {1, 8, 32}, bf16 and f32 x, at F = 512 (``_pick_bf``'s fallback:
    bf = 256, two tiles), and at ``K24_EDGES``.  The int8 rows of x equal
    the plain version's bit for bit; the activation is the plain SiLU·up of
    the kernel's own rows to f32 rounding; the requantized tiles are the
    plain requantization of the kernel's own activation and the output the
    plain down projection of the kernel's own tiles, both bit for bit; the
    output within 1e-2 of the plain version's largest (an activation on a
    requantization boundary may take the neighbouring code, which moves a
    row by 2·sa·sd); a second call equals the first bit for bit.  Timed at
    M = 1 and 32 (bf16) beside its bound, the plain version, the library
    chain (no single PyTorch call computes this function: ``torch.matmul``
    on the dequantized bf16 gate|up, SiLU·up, ``torch.matmul`` on the
    dequantized down) and the unfused pair it replaces, K1(gate|up) +
    K1(down, glu); and at every M of ``K24_MB`` (``k24_mb``)."""
    from bitnet_tpu_torch.ops import ffn_fused as ff
    from bitnet_tpu_torch.ops import ternary_matmul as tm

    cases = [(H8B, H8B, F8B, H8B, (1, 8, 32), (torch.bfloat16, torch.float32), None),
             (512, 512, 512, 512, (1, 32), (torch.bfloat16,), None),
             *((K, Kp, F, H, Ms, tuple(getattr(torch, d) for d in dts), 0)
               for K, Kp, F, H, Ms, dts in K24_EDGES)]
    for K, Kp, F, H, Ms, dtypes, min_bytes in cases:
        gu, sg, dw, sd = (_k24_stacks(torch, g, Kp, F, H, dev) if min_bytes is None
                          else _k24_stacks(torch, g, Kp, F, H, dev, min_bytes))
        L = gu.shape[0]
        bf = ff._pick_bf(F)
        for M in Ms:
            for dtype in dtypes:
                x = torch.randn((M, K), generator=g, device=dev).to(dtype)
                l = 1
                out = ff.ffn_w2a8_fused(l, x, gu, sg, dw, sd, F, H)
                out2, (xq, sx, sumq, act, aq, sa, sq2) = ff._ffn_cuda(l, x, gu, sg, dw,
                                                                      sd, F, H)
                again = ff.ffn_w2a8_fused(l, x, gu, sg, dw, sd, F, H)
                plain, xq_p, sx_p, sumq_p, *_ = ff.ffn_w2a8_fused_plain(
                    x, gu[l], sg[l], dw[l], sd[l], F, H, parts=True)
                act_p = ff.gateup_act(xq, sx, sumq, gu[l], sg[l], F)
                aq_p, sa_p, sq2_p = ff.requant_tiles(act, bf)
                down = ff.down_from_tiles(aq, sa, sq2, dw[l], sd[l], bf)[:, :H].to(dtype)
                err = (out.float() - plain.float()).abs().max().item()
                ref = plain.float().abs().max().item()
                tol = 1e-2 * ref
                row = {"K": K, "Kp": Kp, "F": F, "H": H, "bf": bf, "n_f": F // bf,
                       "M": M, "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                       "ref_max": ref, "tol": tol,
                       "xq_exact": bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)
                                        and torch.equal(sumq, sumq_p)),
                       "act_max_rel_err": ((act - act_p).abs()
                                           / act_p.abs().clamp_min(1e-30)).max().item(),
                       "tiles_exact": bool(torch.equal(aq, aq_p) and torch.equal(sa, sa_p)
                                           and torch.equal(sq2, sq2_p)),
                       "down_exact": bool(torch.equal(down, out)),
                       "wrapper_equals_launch": bool(torch.equal(out, out2)),
                       "repeat_exact": bool(torch.equal(out, again)),
                       "aq_codes_off": int((aq != ff.requant_tiles(
                           ff.gateup_act(xq_p, sx_p, sumq_p, gu[l], sg[l], F), bf)[0]
                       ).sum().item())}
                row["ok"] = (err <= tol and row["xq_exact"] and row["tiles_exact"]
                             and row["down_exact"] and row["wrapper_equals_launch"]
                             and row["repeat_exact"] and row["act_max_rel_err"] <= 1e-5)
                if min_bytes is None and K == H8B and M in (1, 32) and dtype == torch.bfloat16:
                    _time_k24(torch, ff, tm, row, x, gu, sg, dw, sd, K, F, H, L)
                res["k24"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K24 mismatch: {row}")
        if min_bytes is None and K == H8B:
            # the MB table: the wrapper's ms per M at the 8B FFN, bf16
            res["k24_mb"] = []
            for M in K24_MB:
                x = torch.randn((M, K), generator=g, device=dev).bfloat16()
                res["k24_mb"].append({"M": M, "ms": time_ms(torch, lambda i: (
                    ff.ffn_w2a8_fused(i % L, x, gu, sg, dw, sd, F, H)), L)})
        del gu, sg, dw, sd


def _time_k24(torch, ff, tm, row, x, gu, sg, dw, sd, K, F, H, L):
    """K24's ms, plain ms, bound, library chain and unfused K1 pair at one
    shape (layers cycled past the L2)."""
    from bitnet_tpu_torch.ops.linear import codes_to_values, unpack_packed

    M = x.shape[0]
    row["ms"] = time_ms(torch, lambda i: ff.ffn_w2a8_fused(
        i % L, x, gu, sg, dw, sd, F, H), L)
    row["plain_ms"] = time_ms(torch, lambda i: ff.ffn_w2a8_fused_plain(
        x, gu[i % L], sg[i % L], dw[i % L], sd[i % L], F, H), 2)
    # the unfused pair: K1 on gate|up (rows already normed), K1 on down with
    # SwiGLU in its preamble
    row["unfused_k1_pair_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8_normed(
        i % L, tm.ternary_matmul_w2a8_normed(i % L, x, gu, sg, None, K, 2 * F),
        dw, sd, None, F, H, glu=True), L)
    nd = 2                                   # > 50 MB of dense weights at 8B
    dense_gu = [(codes_to_values(unpack_packed(gu[l])) * sg[l][None, :]).to(torch.bfloat16)
                for l in range(nd)]
    dense_d = [(codes_to_values(unpack_packed(dw[l])) * sd[l][None, :]).to(torch.bfloat16)
               for l in range(nd)]
    xb = x.to(torch.bfloat16)

    def chain(i):
        y = torch.matmul(xb, dense_gu[i % nd])
        act = torch.nn.functional.silu(y[:, :F]) * y[:, F:]
        return torch.matmul(act, dense_d[i % nd])
    row["library_ms"] = time_ms(torch, chain, 2 * nd)
    row["library_call"] = "matmul(gate|up) -> silu*up -> matmul(down), bf16 dense"
    del dense_gu, dense_d
    nbytes = (K * 2 * F // 4 + F * H // 4 + 2 * F * 4 + H * 4
              + M * K * x.element_size() + M * H * x.element_size())
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, 2.0 * M * K * 2 * F + 2.0 * M * F * H, "int8")


# ---------------------------------------------------------------------------
# slice 7: K25-K27, the f32 instance of the split-S kernel and K3, K28-K32
# ---------------------------------------------------------------------------
def _layers(S, B, esz, per_row=2 * KV5 * D128):
    """Layers of a cache stack whose cycling exceeds the 50 MB L2."""
    return max(2, math.ceil((120 << 20) / (B * S * per_row * esz)))


def _attn_row(torch, out, plain, tol_rel, tol_abs, **extra):
    err = (out.float() - plain.float()).abs().max().item()
    ref = plain.float().abs().max().item()
    tol = tol_rel * ref + tol_abs
    return {**extra, "max_abs_err": err, "ref_max": ref, "tol": tol, "ok": err <= tol}


# float tolerances of the decode-attention checks: over a bf16 cache K5's
# (the kernel rounds its bf16 softmax weights against the running max of its
# split's 64-row stages, the plain version against its chunks' maxima); over
# an f32 cache with f32 activations nothing rounds to bf16, so only the order
# of f32 sums differs
ATTN_TOL = {"bf16": (1e-2, 2e-3), "f32": (1e-5, 0.0)}


def check_k25_k27(torch, dev, g, res):
    """K25 (the 5-D stacked K5) and K26 (K25 that writes the new rows in
    place) at B=1, S=4096 (4095 rows cached), B=2, S=1024 and B=8, S=1024
    (``exp_r4_attn``'s shape: every slot full, then mixed lengths with an
    empty slot), on bf16 and f32 caches (f32 activations over f32), at l = 0
    and L-1; K26 with write_pos = pos, < pos (attention must read the
    pre-write row) and = S (dropped): its stacks must equal the plain
    version's bit for bit (the rows cast, every other byte unchanged).  K27 (the per-b v2 kernel over
    one layer's 4-D cache) at B=8, S in {1024, 4096}, mixed lengths with an
    empty slot, then full.  Timed: K25 / K26 at B=1, S=4096, K27 at B=8,
    S=1024, full, both dtypes."""
    from bitnet_tpu_torch.ops import decode_attention as dk
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    H, KV, D = H20, KV5, D128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kv in ("bf16", "f32"):
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        esz = 2 if kv == "bf16" else 4
        for B, S in ((1, 4096), (2, 1024), (8, 1024)):
            timed = B == 1
            L = _layers(S, B, esz) if timed else 3
            kc, vc = (torch.randn((L, B, S, KV, D), generator=g, device=dev).to(dt)
                      for _ in range(2))
            q, kn, vn = (torch.randn(s, generator=g, device=dev).to(dt)
                         for s in ((B, H, D), (B, KV, D), (B, KV, D)))
            flat_k, flat_v = kc.view(L, B, S, KV * D), vc.view(L, B, S, KV * D)
            # B=8: every slot full, as exp_r4_attn's stacked variants run
            # them, and mixed lengths with an empty slot
            cases = ([[S - 1, S // 2][:B]] if B <= 2 else
                     [[S - 1] * B, [S - 1, 0, 1, 63, 64, 511, 700, S // 2]])
            for ps, l in itertools.product(cases, (0, L - 1)):
                pos = torch.tensor(ps, dtype=torch.int32, device=dev)
                out = dk.decode_attention_stacked(l, q, kn, vn, kc, vc, pos)
                pl = dk.decode_attention_stacked_plain(q, kn, vn, flat_k[l], flat_v[l], pos)
                row = _attn_row(torch, out, pl, *ATTN_TOL[kv], kv=kv, B=B, S=S, l=l,
                                pos=ps)
                res["k25"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K25 mismatch: {row}")
                for where, wp in (("pos", pos), ("before", (pos - 7).clamp_min(0)),
                                  ("past", torch.full_like(pos, S))):
                    k2, v2, k3, v3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                    out2, kr, vr = dk.decode_attention_stacked_inplace(
                        l, q, kn, vn, k2, v2, pos, wp)
                    pl2 = dk.decode_attention_stacked_inplace_plain(
                        q, kn, vn, k3.view(L, B, S, -1)[l], v3.view(L, B, S, -1)[l], pos,
                        wp)
                    row = _attn_row(torch, out2, pl2, *ATTN_TOL[kv], kv=kv, B=B, S=S,
                                    l=l, pos=ps, write=where)
                    wl = wp.tolist()
                    row["rows_written"] = all(
                        torch.equal(k2[l, b, w], kn[b].to(dt)) for b, w in enumerate(wl)
                        if w < S)
                    row["stacks_exact"] = bool(torch.equal(k2, k3) and torch.equal(v2, v3)
                                               and kr is k2 and vr is v2)
                    row["ok"] = row["ok"] and row["rows_written"] and row["stacks_exact"]
                    res["k26"].append(row)
                    if not row["ok"]:
                        raise AssertionError(f"K26 mismatch: {row}")
                    del k2, v2, k3, v3
            if timed:
                rows = (res["k25"][-2], res["k26"][-6])        # l = 0 rows
                fns = (lambda i: dk.decode_attention_stacked(i % L, q, kn, vn, kc, vc, pos),
                       lambda i: dk.decode_attention_stacked_inplace(
                           i % L, q, kn, vn, kc, vc, pos))
                for row, fn in zip(rows, fns):
                    row["ms"] = time_ms(torch, fn, L)
                    row["plain_ms"] = time_ms(torch, lambda i: dk.decode_attention_stacked_plain(
                        q, kn, vn, flat_k[i % L], flat_v[i % L], pos), 2)
                    mask = (torch.arange(S, device=dev) < ps[0]).view(1, 1, 1, S)
                    row["library_ms"] = time_ms(torch, lambda i: sdpa(
                        q.view(1, H, 1, D), kc[i % L].transpose(1, 2),
                        vc[i % L].transpose(1, 2), attn_mask=mask, enable_gqa=True), L)
                    writes = 2 * KV * D * esz if row is rows[1] else 0
                    nbytes = (2 * ps[0] * KV * D * esz + (q.numel() + 2 * kn.numel()
                                                          + H * D) * esz + writes)
                    row["bound_ms"], row["bound_by"] = bound(
                        nbytes, 4.0 * H * (ps[0] + 1) * D, "bf16")
            del kc, vc, flat_k, flat_v
        for S in (1024, 4096):
            B = 8
            L = _layers(S, B, esz)
            kc, vc = (torch.randn((L, B, S, KV, D), generator=g, device=dev).to(dt)
                      for _ in range(2))
            q, kn, vn = (torch.randn(s, generator=g, device=dev).to(dt)
                         for s in ((B, H, D), (B, KV, D), (B, KV, D)))
            mixed = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                                  dtype=torch.int32)
            mixed[B // 2] = 0
            full = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
            for name, pos in (("mixed", mixed), ("full", full)):
                l = 1
                out = da.decode_attention_perb_v2(q, kn, vn, kc[l], vc[l], pos)
                pl = da.decode_attention_perb_v2_plain(
                    q, kn, vn, kc[l].view(B, S, -1), vc[l].view(B, S, -1), pos)
                row = _attn_row(torch, out, pl, *ATTN_TOL[kv], kv=kv, B=B, S=S, pos=name)
                if name == "full" and S == 1024:
                    row["ms"] = time_ms(torch, lambda i: da.decode_attention_perb_v2(
                        q, kn, vn, kc[i % L], vc[i % L], pos), L)
                    row["plain_ms"] = time_ms(torch, lambda i: da.decode_attention_perb_v2_plain(
                        q, kn, vn, kc[i % L].view(B, S, -1), vc[i % L].view(B, S, -1),
                        pos), 2)
                    row["library_ms"] = time_ms(torch, lambda i: _sdpa(
                        torch, q, kc[i % L].view(B, S, -1), vc[i % L].view(B, S, -1),
                        pos), L)
                    rows_read = B * (S - 1)
                    nbytes = (2 * rows_read * KV * D * esz
                              + (q.numel() + 2 * kn.numel() + B * H * D) * esz)
                    row["bound_ms"], row["bound_by"] = bound(
                        nbytes, 4.0 * H * D * (rows_read + B), "bf16")
                res["k27"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"K27 mismatch: {row}")
            del kc, vc


# K33 (paged decode attention): (site, B, S, page, page dtype, q dtype, fill)
K33_CASES = (("exp", 8, 1024, 128, "bf16", "bf16", "full"),
             ("exp", 8, 1024, 128, "bf16", "bf16", "ragged"),
             ("pool", 8, 1024, 16, "bf16", "f32", "full"),
             ("pool", 8, 1024, 16, "bf16", "f32", "ragged"),
             ("pool", 8, 1024, 24, "bf16", "f32", "ragged"),
             ("pool", 8, 1024, 16, "f32", "f32", "ragged"),
             ("pool", 64, 1024, 16, "bf16", "f32", "ragged"),
             ("pool", 1, 4096, 16, "bf16", "f32", "full"))


def check_k33(torch, dev, g, res):
    """K33 against its plain version (gather, mask, f32 softmax): the paged
    variant of ``exp_r4_attn`` (B=8, S=1024, 128-row pages in the stock
    layout, slot b's pages contiguous, bf16 q, every slot full; then
    shuffled pages and ragged lengths with an empty slot) and the paged
    scheduler's step (2B heads, 16-row pages, q in f32 as the ``paged`` plan
    passes it, bf16 and f32 pages, B=8 full and ragged, 24-row pages whose
    reach (1008) ends before a length, B=64, and B=1 at S=4096); a second
    call bit for bit.  Tolerance: bf16 output 1e-2 of the max + 2e-3; f32
    output (q and the softmax weights split into two bf16 halves on bf16
    pages, f32 sums in another order) 2e-5 of the max.  Timed: both sites
    at B=8, S=1024, full, cycling layers past the L2, beside the plain
    version and the library's gather + ``scaled_dot_product_attention``
    (q cast to the pages' dtype, which SDPA wants)."""
    from bitnet_tpu_torch.ops import paged_attention as pa

    H, KV, D = H20, KV5, D128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    for site, B, S, page, kv, qd, fill in K33_CASES:
        esz = 2 if kv == "bf16" else 4
        npg = S // page
        P = B * npg + 1
        timed = fill == "full" and B == 8
        L = _layers(S, B, esz) if timed else 1
        kp = torch.randn((L, KV, P, page, D), generator=g, device=dev).to(dts[kv])
        vp = torch.randn((L, KV, P, page, D), generator=g, device=dev).to(dts[kv])
        q = (torch.randn((B, H, D), generator=g, device=dev) * 0.1).to(dts[qd])
        if fill == "full":
            table = torch.arange(B * npg, device=dev, dtype=torch.int32).view(B, npg)
            lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        else:
            table = torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))[
                :B * npg].view(B, npg).to(torch.int32).to(dev)
            lens = torch.randint(1, S + 1, (B,), generator=g, device=dev).to(torch.int32)
            lens[0] = S
            if B > 2:
                lens[1] = 0
        out = pa.paged_attention(q, kp[0], vp[0], lens, table)
        pl = pa.paged_attention_plain(q, kp[0], vp[0], lens, table)
        tol = (1e-2, 2e-3) if qd == "bf16" else (2e-5, 0.0)
        row = _attn_row(torch, out, pl, *tol, site=site, B=B, S=S, page=page, kv=kv,
                        q=qd, fill=fill, splits=pa.paged_plan(B, KV, npg * page, 132)[0])
        row["repeat_exact"] = bool(torch.equal(out, pa.paged_attention(
            q, kp[0], vp[0], lens, table)))
        row["ok"] = row["ok"] and row["repeat_exact"]
        if timed:
            row["ms"] = time_ms(torch, lambda i: pa.paged_attention(
                q, kp[i % L], vp[i % L], lens, table), L)
            row["plain_ms"] = time_ms(torch, lambda i: pa.paged_attention_plain(
                q, kp[i % L], vp[i % L], lens, table), 4)

            def lib(i):
                k = kp[i % L][:, table].reshape(KV, B, S, D).transpose(0, 1)
                v = vp[i % L][:, table].reshape(KV, B, S, D).transpose(0, 1)
                return sdpa(q.view(B, H, 1, D).to(k.dtype), k, v, enable_gqa=True,
                            scale=1.0)
            row["library_ms"] = time_ms(torch, lib, L)
            n = int(lens.sum())
            nbytes = (2 * n * KV * D * esz + 2 * q.numel() * q.element_size()
                      + table.numel() * 4 + B * 4)
            row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * H * D * n, "bf16")
        res["k33"].append(row)
        if not row["ok"]:
            raise AssertionError(f"K33 mismatch: {row}")
        del kp, vp


def check_f32_instances(torch, dev, g, res):
    """The split-S kernel's f32-cache instance under K2 (B=1, S=4096, 4095
    rows), K5 (B=1 and 2, S=4096) and K8 (B=8, S=1024, full and mixed), with
    f32 activations: within 1e-5 of the plain versions' max (nothing rounds
    to bf16; only the order of f32 sums differs), K2's rows exact; K3 on
    f32 rows at the 2B-4T stack (L=30, B=1, S=4096) bit for bit.  Timed
    with bounds: K2 and K5 at B=1, S=4096 (beside the bf16 K5 of the same
    shape in res["k5"]) and K8 at B=8, S=1024."""
    from bitnet_tpu_torch.ops import decode_attention as dk
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    H, KV, D = H20, KV5, D128
    tol_rel = ATTN_TOL["f32"][0]
    # K2
    S = 4096
    L = _layers(S, 1, 4)
    kc, vc = (torch.randn((L, 1, S, KV * D), generator=g, device=dev) for _ in range(2))
    qkv = torch.randn((1, H + 2 * KV, D), generator=g, device=dev)
    ang = torch.rand((1, D // 2), generator=g, device=dev) * 6.283
    sin, cos = torch.sin(ang), torch.cos(ang)
    pos = torch.tensor([S - 1], dtype=torch.int32, device=dev)
    out = da.decode_attention_qkv(1, qkv, sin, cos, kc, vc, pos, H, KV)
    pl = da.decode_attention_qkv_plain(qkv, sin, cos, kc[1], vc[1], pos, H, KV)
    row = _attn_row(torch, out[0], pl[0], tol_rel, 0.0, kernel="K2", B=1, S=S)
    row["rows_exact"] = bool(torch.equal(out[1], pl[1]) and torch.equal(out[2], pl[2]))
    row["ok"] = row["ok"] and row["rows_exact"]
    row["ms"] = time_ms(torch, lambda i: da.decode_attention_qkv(
        i % L, qkv, sin, cos, kc, vc, pos, H, KV), L)
    row["plain_ms"] = time_ms(torch, lambda i: da.decode_attention_qkv_plain(
        qkv, sin, cos, kc[i % L], vc[i % L], pos, H, KV), 2)
    row["bound_ms"], row["bound_by"] = _attn_bound([S - 1], 1, 4, False)
    res["f32"].append(row)
    # K5 at B = 1 and 2, then K8
    del kc, vc
    for kernel, fn, plain, B, S in (
            ("K5", dk.decode_attention, dk.decode_attention_plain, 1, 4096),
            ("K5", dk.decode_attention, dk.decode_attention_plain, 2, 4096),
            ("K8", da.decode_attention_batched, da.decode_attention_batched_plain, 8, 1024)):
        L = _layers(S, B, 4)
        kc, vc = (torch.randn((L, B, S, KV * D), generator=g, device=dev)
                  for _ in range(2))
        qb, knb, vnb = (torch.randn(s, generator=g, device=dev)
                        for s in ((B, H, D), (B, KV, D), (B, KV, D)))
        full = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        mixed = torch.randint(0, S, (B,), generator=g, device=dev, dtype=torch.int32)
        for name, pos in (("full", full), ("mixed", mixed)):
            out = fn(1, qb, knb, vnb, kc, vc, pos)
            pl = plain(qb, knb, vnb, kc[1], vc[1], pos)
            row = _attn_row(torch, out, pl, tol_rel, 0.0, kernel=kernel, B=B, S=S,
                            pos=name)
            if name == "full" and B != 2:
                row["ms"] = time_ms(torch, lambda i: fn(i % L, qb, knb, vnb, kc, vc, pos), L)
                row["plain_ms"] = time_ms(torch, lambda i: plain(
                    qb, knb, vnb, kc[i % L], vc[i % L], pos), 2)
                row["bound_ms"], row["bound_by"] = _attn_bound(pos.tolist(), B, 4, False)
            res["f32"].append(row)
        del kc, vc
    # K3 on f32 rows, pos >= S included
    L, B, S, KVD = 30, 1, 4096, KV * D
    kc, vc = (torch.randn((L, B, S, KVD), generator=g, device=dev) for _ in range(2))
    for p in (5, S - 1, S + 7):
        rows = torch.randn((2, L, B, 1, KVD), generator=g, device=dev)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        k2, v2 = kc.clone(), vc.clone()
        da.scatter_kv_rows(kc, vc, rows[0], rows[1], pos)
        da.scatter_kv_rows_plain(k2, v2, rows[0], rows[1], pos)
        exact = bool(torch.equal(kc, k2) and torch.equal(vc, v2))
        res["f32"].append({"kernel": "K3", "pos": p, "tol": 0.0, "exact": exact,
                           "max_abs_err": 0.0 if exact else float("inf"), "ok": exact})
        del k2, v2
    del kc, vc
    for row in res["f32"]:
        if not row["ok"]:
            raise AssertionError(f"f32 instance mismatch: {row}")


# ---------------------------------------------------------------------------
# the one-launch split-S decode attention
# ---------------------------------------------------------------------------
ATTN_CACHES = ("bf16", "f32", "int8", "fp8")


def _attn_case(torch, dev, g, rope, kv, B, S, L=2):
    """Operands of one decode-attention call at the 2B-4T heads over a
    ``kv`` cache (f32 activations over f32, else bf16): returns (run(l,
    pos), plain(l, pos)), each giving (attn, new rows...) -- K2 / K7 with
    RoPE, K5 / K15 without."""
    from bitnet_tpu_torch.ops import decode_attention as dk
    from bitnet_tpu_torch.ops import decode_attention_v2 as da

    H, KV, D = H20, KV5, D128
    quant = kv in dict(QUANT)
    cdt = getattr(torch, dict(QUANT).get(kv, "float32" if kv == "f32" else "bfloat16"))
    act = torch.float32 if kv == "f32" else torch.bfloat16
    if quant:
        kc, vc, ks, vs = _quant_stack(torch, g, L, B, S, cdt, dev)
        sc = (ks, vs)
    else:
        kc, vc = (torch.randn((L, B, S, KV * D), generator=g, device=dev).to(cdt)
                  for _ in range(2))
        sc = ()
    if rope:
        qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev).to(act)
        ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
        sin, cos = torch.sin(ang), torch.cos(ang)
        fn, plain = ((da.decode_attention_qkv_quant, da.decode_attention_qkv_quant_plain)
                     if quant else (da.decode_attention_qkv, da.decode_attention_qkv_plain))
        return (lambda l, pos: fn(l, qkv, sin, cos, kc, vc, *sc, pos, H, KV),
                lambda l, pos: plain(qkv, sin, cos, kc[l], vc[l], *(t[l] for t in sc), pos,
                                     H, KV))
    q, kn, vn = (torch.randn(s_, generator=g, device=dev)
                 for s_ in ((B, H, D), (B, KV, D), (B, KV, D)))
    if quant:       # the new rows arrive round-tripped
        kn, vn = (_round_trip(torch, x, cdt) for x in (kn, vn))
    q, kn, vn = q.to(act), kn.to(act), vn.to(act)
    fn, plain = ((dk.decode_attention_quant, dk.decode_attention_quant_plain) if quant
                 else (dk.decode_attention, dk.decode_attention_plain))
    return (lambda l, pos: (fn(l, q, kn, vn, kc, vc, *sc, pos),),
            lambda l, pos: (plain(q, kn, vn, kc[l], vc[l], *(t[l] for t in sc), pos),))


def check_attn_edges(torch, dev, g, res):
    """The split-S kernel against its plain version with pos at the edges
    of the plan's splits, over every cache dtype, with RoPE (K2, K7) and
    without (K5, K15): B=1, S=4096 (R=256 on 132 SMs, 128 over a 1-byte
    cache) at pos 0, 1, R-1, R, R+1, S-1, S one call each; a pool of 7
    slots, S=1000 (not a multiple of its R=512, or 256), one slot at each
    edge.  Tolerances: ATTN_TOL; the new rows (codes and scales) bit for
    bit."""
    from bitnet_tpu_torch.ops import decode_attention as dk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kv, rope in itertools.product(ATTN_CACHES, (False, True)):
        tol = ATTN_TOL["f32" if kv == "f32" else "bf16"]
        for B, S in ((1, 4096), (7, 1000)):
            R = dk.attn_plan(B, KV5, S, sms, 1 if kv in dict(QUANT) else 4 if kv == "f32" else 2)
            edges = [0, 1, R - 1, R, R + 1, S - 1, S]
            run, plain = _attn_case(torch, dev, g, rope, kv, B, S)
            cases = [[p] for p in edges] if B == 1 else [edges]
            for ps in cases:
                pos = torch.tensor(ps, dtype=torch.int32, device=dev)
                out, pl = run(1, pos), plain(1, pos)
                row = _attn_row(torch, out[0], pl[0], *tol, kv=kv, rope=rope, B=B, S=S,
                                R=R, pos=ps)
                row["rows_exact"] = all(_same(torch, a, b) for a, b in zip(out[1:], pl[1:]))
                row["ok"] = row["ok"] and row["rows_exact"]
                res["attn_edges"].append(row)
                if not row["ok"]:
                    raise AssertionError(f"split-S kernel at a split edge: {row}")
            del run, plain


def check_attn_repeats(torch, dev, g, res):
    """Three calls in a row, and ten calls replayed in one CUDA graph, give
    the same bits (K5 / K2 / K7 int8 at B=1, S=4096: 32 splits a kv head
    folded by the last to arrive; K8 at B=8, S=1024), and every arrival
    counter is zero after them."""
    from bitnet_tpu_torch.ops import decode_attention as dk

    for name, rope, kv, B, S in (("K5", False, "bf16", 1, 4096), ("K2", True, "bf16", 1, 4096),
                                 ("K7", True, "int8", 1, 4096), ("K8", False, "bf16", 8, 1024)):
        run, _ = _attn_case(torch, dev, g, rope, kv, B, S)
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        first = run(1, pos)
        same = [all(_same(torch, a, b) for a, b in zip(first, run(1, pos))) for _ in range(2)]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [run(1, pos) for _ in range(10)]
        graph.replay()
        torch.cuda.synchronize()
        replays = [all(_same(torch, a, b) for a, b in zip(first, o)) for o in outs]
        zero = int(dk.attn_counters(dev).abs().sum()) == 0
        row = {"kernel": name, "kv": kv, "B": B, "S": S, "repeats_exact": all(same),
               "graph_replays_exact": all(replays), "counters_zero": zero,
               "max_abs_err": 0.0, "tol": 0.0}
        row["ok"] = all(same) and all(replays) and zero
        res["attn_repeats"].append(row)
        if not row["ok"]:
            raise AssertionError(f"split-S kernel not repeatable: {row}")
        del graph, outs, run


def check_attn_profiles(res):
    """One K5 and one K2 call at B=1, S=4096 under the profiler: one launch
    of the split-S kernel and no ATen op but ``aten::empty``."""
    for key in ("k5_profile", "k2_profile"):
        if not (res[key]["ok"] and "attn_decode" in res[key]["kernels"][0]):
            raise AssertionError(f"{key}: not one split-S launch: {res[key]}")


def check_exp_w2a8(torch, dev, g, res):
    """K28-K31 (the probes) bit for bit against their expected results on
    the script's inputs; K29 exact through dp4a and the int8 MMA, on the
    script's inputs and on shapes past one slab or one block (and dp4a's
    ragged M, N and K); K32 at the script's shape (K=2560, N=13824) with M
    in {1, 16, 17, 33} (33 crosses a 32-row tile; bf16 x, and f32 at 33):
    the int8 codes, row scales and sums of its M rows bit for bit, its
    output within one bf16 ulp of the plain version.  Timed: each probe at
    its shape (launch-bound), K29 at (128x256)·(256x256) beside
    ``torch._int_mm``, K32 at M=1 and 16 beside K1 on the same words and
    ``torch.matmul`` on the dequantized bf16 weights."""
    import numpy as np

    from bitnet_tpu_torch.experiments import exp_w2a8 as ew
    from bitnet_tpu_torch.ops import w2a8_probes as wp
    from bitnet_tpu_torch.ops import ternary_matmul as tm
    from bitnet_tpu_torch.ops.linear import codes_to_values, unpack_packed

    words_in = {"k28": ew.p1_inputs(), "k30": ew.p3_inputs(), "k31": ew.p4_inputs()[1]}
    for key, fn, plain in (("k28", wp.bitcast_i32_to_i8, wp.bitcast_i32_to_i8_plain),
                           ("k30", wp.bytes_to_bf16, wp.bytes_to_bf16_plain),
                           ("k31", wp.unpack_words, wp.unpack_words_plain)):
        w = torch.from_numpy(words_in[key])
        wd = w.to(dev)
        out = fn(wd)
        exact = bool(torch.equal(out.cpu(), plain(w)))
        row = {"shape": list(w.shape), "tol": 0.0, "exact": exact,
               "max_abs_err": 0.0 if exact else float("inf"), "ok": exact,
               "ms": time_ms(torch, lambda i: fn(wd)),
               "plain_ms": time_ms(torch, lambda i: plain(wd)), "library_ms": None}
        if key != "k31":      # no single PyTorch call unpacks K31's chain
            # one copy_: the words' bytes, moved to rows 4s+j (and for K30
            # converted to bf16), the probe's function exactly
            R, C = w.shape
            lib = torch.empty_like(out)
            src = wd.view(torch.int8).view(R, C, 4).transpose(1, 2)
            lib.view(R, 4, C).copy_(src)
            exact = exact and bool(torch.equal(lib, out))
            row["library_ms"] = time_ms(torch, lambda i: lib.view(R, 4, C).copy_(src))
            row["library_call"] = "Tensor.copy_ of the int8 view, rows 4s+j"
            row["ok"] = row["exact"] = exact
        row["bound_ms"], row["bound_by"] = bound(
            w.numel() * 4 + out.numel() * out.element_size(), 0, "int8")
        res[key].append(row)
        if not exact:
            raise AssertionError(f"{key.upper()} mismatch: {row}")
    codes4 = ew.p4_inputs()[0]
    if not np.array_equal(wp.unpack_words(torch.from_numpy(words_in["k31"]).to(dev))
                          .cpu().numpy(), codes4 + (codes4 >> 1)):
        raise AssertionError("K31 does not invert pack_w2a8_host")
    a, b, a2 = (torch.from_numpy(t).to(dev) for t in ew.p2_inputs())
    for lhs in (a, a2):
        ref = wp.int8_dot_plain(lhs.cpu(), b.cpu())
        for unit in ("dp4a", "mma"):
            out = wp.int8_dot(lhs, b, unit)
            exact = bool(torch.equal(out.cpu(), ref))
            row = {"unit": unit, "M": lhs.shape[0], "tol": 0.0, "exact": exact,
                   "max_abs_err": 0.0 if exact else float("inf"), "ok": exact}
            if lhs is a:
                M, K = lhs.shape
                N = b.shape[1]
                row["ms"] = time_ms(torch, lambda i: wp.int8_dot(lhs, b, unit))
                row["plain_ms"] = time_ms(torch, lambda i: wp.int8_dot_plain(lhs, b))
                bt = b.t().contiguous().t()
                row["library_ms"] = time_ms(torch, lambda i: torch._int_mm(lhs, bt))
                row["bound_ms"], row["bound_by"] = bound(M * K + K * N + 4 * M * N,
                                                         2.0 * M * K * N, "int8")
            res["k29"].append(row)
            if not exact:
                raise AssertionError(f"K29 mismatch: {row}")
    # past one 256-K slab and one 16 x 64 block; dp4a also at ragged shapes
    for (M, K, N), units in (((48, 1024, 72), ("dp4a", "mma")),
                             ((16, 32, 8), ("dp4a", "mma")),
                             ((33, 260, 20), ("dp4a",)), ((5, 12, 7), ("dp4a",))):
        lhs = torch.randint(-128, 128, (M, K), generator=g, device=dev).to(torch.int8)
        rhs = torch.randint(-128, 128, (K, N), generator=g, device=dev).to(torch.int8)
        ref = wp.int8_dot_plain(lhs.cpu(), rhs.cpu())
        for unit in units:
            exact = bool(torch.equal(wp.int8_dot(lhs, rhs, unit).cpu(), ref))
            row = {"unit": unit, "M": M, "K": K, "N": N, "tol": 0.0, "exact": exact,
                   "max_abs_err": 0.0 if exact else float("inf"), "ok": exact}
            res["k29"].append(row)
            if not exact:
                raise AssertionError(f"K29 mismatch: {row}")
    # K32 at the script's shape
    K, N, scale = 2560, 13824, 0.02
    codes = np.random.default_rng(2).integers(0, 4, size=(K, N)).astype(np.uint8)
    words = torch.from_numpy(wp.pack_w2a8_host(codes)).to(dev)
    L = max(2, math.ceil((120 << 20) / (K * N // 4)))
    wstack = torch.stack([words] * L)
    sv = torch.full((L, N), scale, device=dev)
    nd = 2                                         # 2 x 70.8 MB of bf16 weights
    dense = [(codes_to_values(unpack_packed(words)) * scale).to(torch.bfloat16)
             for _ in range(nd)]
    for M, xdt in ((1, torch.bfloat16), (16, torch.bfloat16), (17, torch.bfloat16),
                   (33, torch.bfloat16), (33, torch.float32)):
        x = torch.randn((M, K), generator=g, device=dev).to(xdt)
        out, xq, sx, sumq = wp._w2a8_matmul_cuda(x, words, scale)
        pq, psx, psum = wp.w2a8_quantize_plain(x, M)
        pl = wp.w2a8_matmul_plain(pq, psx, psum, words, scale, M)
        ulp = (pl.float().abs() * 2.0 ** -7).clamp_min(2.0 ** -133)   # one bf16 ulp
        err = (out.float() - pl.float()).abs()
        row = {"M": M, "K": K, "N": N, "x": str(xdt).split(".")[-1], "codes_exact": bool(
                   torch.equal(xq[:M], pq) and torch.equal(sumq[:M], psum)
                   and torch.equal(sx[:M], psx)),
               "bit_exact": bool(torch.equal(out, pl)), "max_abs_err": err.max().item(),
               "tol": "one bf16 ulp", "within_ulp": bool((err <= ulp).all())}
        row["ok"] = row["codes_exact"] and row["within_ulp"]
        if M in (1, 16):
            row["ms"] = time_ms(torch, lambda i: wp.w2a8_matmul(
                x, wstack[i % L], scale, bn=2304, bkt=2), L)
            row["plain_ms"] = time_ms(torch, lambda i: wp.w2a8_matmul_plain(
                *wp.w2a8_quantize_plain(x, M), wstack[i % L], scale, M), 2)
            row["k1_ms"] = time_ms(torch, lambda i: tm.ternary_matmul_w2a8_normed(
                i % L, x, wstack, sv, None, K, N), L)
            row["library_ms"] = time_ms(torch, lambda i: torch.matmul(x, dense[i % nd]), nd)
            row["library_call"] = "torch.matmul on the dequantized bf16 weights"
            row["bound_ms"], row["bound_by"] = bound(K * N // 4 + M * K * 2 + M * N * 2,
                                                     2.0 * M * K * N, "int8")
        res["k32"].append(row)
        if not row["ok"]:
            raise AssertionError(f"K32 mismatch: {row}")
    del wstack, dense


# Slice 5: the wrappers of every other decode-attention plan, all on the
# split-S kernel: (key, kernel id, rope-fused?, cache dtypes, batch sizes).
# The per-b kernels run at B in {1, 2}, the pool kernels at B in {3, 8}.
PLAN_KERNELS = (
    ("k13", "decode_attention_qkv_v1", True, ("bf16",), (1, 2)),
    ("k14", "decode_attention_qkv_quant_v1", True, ("int8", "fp8"), (1, 2)),
    ("k15", "decode_attention_quant", False, ("int8", "fp8"), (1, 2)),
    ("k16", "decode_attention_batched_v1", False, ("bf16",), (3, 8)),
    ("k17", "decode_attention_quant_batched_v1", False, ("int8", "fp8"), (3, 8)),
    ("k18", "decode_attention_qkv_batched", True, ("bf16",), (3, 8)),
    ("k19", "decode_attention_qkv_quant_batched", True, ("int8", "fp8"), (3, 8)),
    ("k20", "decode_attention_qkv_batched_v2", True, ("bf16",), (3, 8)),
    ("k21", "decode_attention_qkv_quant_batched_v2", True, ("int8", "fp8"), (3, 8)),
    ("k22", "decode_attention_batched_v2", False, ("bf16",), (3, 8)),
    ("k23", "decode_attention_quant_batched_v2", False, ("int8", "fp8"), (3, 8)),
)


def check_plan_kernels(torch, dev, g, res):
    """K13–K23 against their plain versions at S in {1024, 4096} over their
    cache dtypes and batch sizes; a per-b kernel with every slot's cache
    nearly full, a pool with mixed lengths and an idle slot (pos 0).  The
    rope-fused kernels' new rows (codes and scales) must be equal.  Timed
    where the plans phase runs them hardest: the per-b kernels at B=1,
    S=4096, the pool kernels at B=8, S=1024, a full cache, int8 for the
    quantized ones."""
    import importlib

    from bitnet_tpu_torch.ops.registry import REGISTRY

    specs = {spec.kernel_id: spec for spec in REGISTRY}
    H, KV, D = H20, KV5, D128
    for key, kid, rope, kvs, Bs in PLAN_KERNELS:
        fn = specs[kid].wrapper
        plain = getattr(importlib.import_module(fn.__module__), kid + "_plain")
        for kv in kvs:
            quant = kv != "bf16"
            dt = getattr(torch, dict(QUANT).get(kv, "bfloat16"))
            esz = 1 if quant else 2
            for S in ATTN_S:
                for B in Bs:
                    timed = kv == kvs[0] and (B, S) == ((1, 4096) if Bs[0] == 1
                                                        else (8, 1024))
                    L = (max(2, math.ceil((120 << 20) / (2 * B * S * KV * D * esz)))
                         if timed else 2)
                    if quant:
                        kc, vc, ks, vs = _quant_stack(torch, g, L, B, S, dt, dev)
                        scales = (ks, vs)
                    else:
                        kc, vc = (torch.randn((L, B, S, KV * D), generator=g, device=dev
                                              ).to(torch.bfloat16) for _ in range(2))
                        scales = ()
                    if B <= 2:
                        ps = [S - 1, S // 2][:B]
                    elif timed:
                        ps = [S - 1] * B
                    else:
                        ps = torch.randint(1, S + 1, (B,), generator=g, device=dev).tolist()
                        ps[0], ps[1] = S - 1, 0
                    pos = torch.tensor(ps, dtype=torch.int32, device=dev)
                    if rope:
                        qkv = torch.randn((B, H + 2 * KV, D), generator=g, device=dev
                                          ).to(torch.bfloat16)
                        ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
                        sin, cos = torch.sin(ang), torch.cos(ang)
                        args = (qkv, sin, cos)
                        kw = {"n_heads": H, "n_kv": KV}
                    else:
                        q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
                        kn, vn = (torch.randn((B, KV, D), generator=g, device=dev)
                                  for _ in range(2))
                        if quant:   # the new rows arrive round-tripped, in bf16
                            kn, vn = (_round_trip(torch, x, dt) for x in (kn, vn))
                        args = (q, kn.to(torch.bfloat16), vn.to(torch.bfloat16))
                        kw = {}

                    def run(i):
                        return fn(i, *args, kc, vc, *scales, pos, **kw)

                    def ref(i):
                        return plain(*args, kc[i], vc[i], *(s[i] for s in scales), pos,
                                     *kw.values())

                    l = 1
                    out, pl = run(l), ref(l)
                    attn, pattn = (out[0], pl[0]) if rope else (out, pl)
                    err = (attn.float() - pattn.float()).abs().max().item()
                    ref_max = pattn.float().abs().max().item()
                    # float tolerance: K5's (bf16 softmax weights rounded
                    # against split maxima, the plain version against the TPU
                    # kernel's chunk maxima)
                    tol = 1e-2 * ref_max + 2e-3
                    row = {"kv": kv, "S": S, "B": B, "pos": ps, "max_abs_err": err,
                           "ref_max": ref_max, "tol": tol, "ok": err <= tol}
                    if rope:
                        row["rows_exact"] = all(_same(torch, a, b)
                                                for a, b in zip(out[1:], pl[1:]))
                        row["ok"] = row["ok"] and row["rows_exact"]
                    if timed:
                        row["ms"] = time_ms(torch, lambda i: run(i % L), L)
                        row["plain_ms"] = time_ms(torch, lambda i: ref(i % L), 2)
                        nl = min(L, 2)
                        if quant:
                            kb, vb = _dequant(torch, kc[:nl], ks[:nl]), _dequant(torch, vc[:nl], vs[:nl])
                        else:
                            kb, vb = kc, vc
                        nl = kb.shape[0]
                        row["library_ms"] = time_ms(torch, lambda i: _sdpa(
                            torch, pattn, kb[i % nl], vb[i % nl], pos), nl)
                        del kb, vb
                        row["bound_ms"], row["bound_by"] = _attn_bound(ps, B, esz, quant)
                    res[key].append(row)
                    if not row["ok"]:
                        raise AssertionError(f"{key.upper()} ({kid}) mismatch: {row}")
                    del kc, vc, scales


def _round_trip(torch, x, dt):
    """Rows after the KV quantization round trip (the model's k_new, v_new
    for a quantized cache)."""
    from bitnet_tpu_torch.ops import decode_attention as dk

    return dk.dequantize_kv(*dk.quantize_kv(x, dt))


# One summary entry per TPU kernel site: (entry name, kernel id, the site
# it replaces, the serving phase whose launches it reports, the kernels-phase
# rows it sums).  A kernel that serves two sites has an entry for each, timed
# at its own path's shapes and counted on its own path's run.
TM, DA = "bitnet_tpu/ops/ternary_matmul.py", "bitnet_tpu/ops/decode_attention"
SITES = (
    ("ternary_matmul_w2a8_normed", "ternary_matmul_w2a8_normed", f"{TM}:375",
     "serving", "k1", lambda r: r["path"] == "fused" and r["M"] == 1),
    ("ternary_matmul_w2a8", "ternary_matmul_w2a8", f"{TM}:464",
     "serving", "k4", lambda r: r["path"] == "fused" and r["M"] == 512),
    ("decode_attention_qkv", "decode_attention_qkv", f"{DA}_v2.py:922",
     "serving", "k2", lambda r: "ms" in r and r["S"] == 4096),
    ("scatter_kv_rows", "scatter_kv_rows", f"{DA}_v2.py:1113",
     "serving", "k3", lambda r: "ms" in r),
    ("ternary_matmul_w2a8_normed (unstacked)", "ternary_matmul_w2a8_normed",
     f"{TM}:1073", "generic", "k1",
     lambda r: r["path"] == "unfused" and r["M"] == 1),
    ("ternary_matmul_w2a8 (unstacked)", "ternary_matmul_w2a8",
     f"{TM}:1177 (w2a8 body)", "generic", "k4",
     lambda r: r["path"] == "unfused" and r["M"] == 512),
    ("decode_attention", "decode_attention", f"{DA}.py:960",
     "generic", "k5", lambda r: "ms" in r and r["S"] == 4096),
    ("ternary_matmul_bf16", "ternary_matmul_bf16", f"{TM}:1177 (bf16 qk256 body)",
     "generic", "k6", lambda r: "ms" in r and r["M"] == 1),
    ("decode_attention_qkv_quant", "decode_attention_qkv_quant", f"{DA}_v2.py:1021",
     "batched", "k7", lambda r: "ms" in r and r["S"] == 4096 and r["kv"] == "int8"),
    ("decode_attention_batched", "decode_attention_batched", f"{DA}_v2.py:735",
     "batched", "k8", lambda r: "ms" in r and r["S"] == 1024 and r["B"] == 8),
    ("decode_attention_quant_batched", "decode_attention_quant_batched",
     f"{DA}_v2.py:820", "batched", "k9",
     lambda r: "ms" in r and r["S"] == 1024 and r["B"] == 8 and r["kv"] == "int8"),
    ("ternary_matmul_tl_w2a8_normed", "ternary_matmul_tl_w2a8_normed", f"{TM}:960",
     "tl_b1", "k11", lambda r: "ms" in r and r["M"] == 1),
    ("ternary_matmul_tl_bf16_normed", "ternary_matmul_tl_bf16_normed", f"{TM}:733",
     "tl_pool", "k12", lambda r: "ms" in r and r["M"] == 8),
    ("ternary_matmul_blockscale_bf16", "ternary_matmul_blockscale_bf16", f"{TM}:555",
     "tl_unaligned", "k10", lambda r: "ms" in r and r["path"] == "fused" and r["M"] == 1),
    ("ternary_matmul_blockscale_bf16 (unstacked)", "ternary_matmul_blockscale_bf16",
     f"{TM}:1177 (bitnet32/TL body)", "tl_generic", "k10",
     lambda r: "ms" in r and r["path"] == "unfused" and r["M"] == 1),
    # slice 5: counted over the plans phase's requests
    *((kid, kid, f"{DA}{site}", "plans", key, lambda r: "ms" in r)
      for (key, kid, *_), site in zip(PLAN_KERNELS, (
          ".py:488", ".py:859", ".py:655", ".py:1114", ".py:1262", ".py:1421",
          ".py:1609", "_v2.py:487", "_v2.py:582", "_v2.py:1193", "_v2.py:1291"))),
    # slice 6: one layer's FFN of a 32-token prefill at the 8B shapes,
    # counted over the llama8b phase's requests
    ("ffn_w2a8_fused", "ffn_w2a8_fused", "bitnet_tpu/ops/ffn_fused.py:148",
     "llama8b", "k24", lambda r: "ms" in r and r["M"] == 32),
    # slice 7: counted over the experiments phase's entry points; K25 / K26
    # at B=1, S=4096 and K27 at B=8, S=1024, bf16 caches
    ("decode_attention_stacked", "decode_attention_stacked", f"{DA}.py:204",
     "experiments", "k25", lambda r: "ms" in r and r["kv"] == "bf16"),
    ("decode_attention_stacked_inplace", "decode_attention_stacked_inplace",
     f"{DA}.py:334", "experiments", "k26", lambda r: "ms" in r and r["kv"] == "bf16"),
    ("decode_attention_perb_v2", "decode_attention_perb_v2", f"{DA}_v2.py:278",
     "experiments", "k27", lambda r: "ms" in r and r["kv"] == "bf16"),
    ("bitcast_i32_to_i8", "bitcast_i32_to_i8", "experiments/exp_w2a8.py:55",
     "experiments", "k28", lambda r: "ms" in r),
    ("int8_dot", "int8_dot", "experiments/exp_w2a8.py:75 and :84", "experiments",
     "k29", lambda r: "ms" in r and r["unit"] == "mma"),
    ("bytes_to_bf16", "bytes_to_bf16", "experiments/exp_w2a8.py:99", "experiments",
     "k30", lambda r: "ms" in r),
    ("unpack_words", "unpack_words", "experiments/exp_w2a8.py:146", "experiments",
     "k31", lambda r: "ms" in r),
    ("w2a8_matmul", "w2a8_matmul", "experiments/exp_w2a8.py:201", "experiments",
     "k32", lambda r: "ms" in r and r["M"] == 1),
    # slice 21: the stock paged attention (its pallas_call is in the JAX
    # library), timed at exp_r4_attn's paged shape, counted over the
    # scheduler phase (the paged pool's decode steps)
    ("paged_attention", "paged_attention",
     "jax.experimental.pallas.ops.tpu.paged_attention (called at "
     "experiments/exp_r4_attn.py:63-88)", "scheduler", "k33",
     lambda r: "ms" in r and r["site"] == "exp"),
)


def summarize(res, launches):
    """The ``kernels`` line, one entry per site (``SITES``): ms, plain,
    bound and library ms summed over the rows of that site's path (the
    fused path's four shapes or the generic path's seven at M=1, or at
    M=512 for the prefill GEMM; K2 and K5 at S=4096 with a full cache; K3
    all 30 rows of a B=1 step; K13–K15 at B=1, S=4096, K16–K23 at B=8,
    S=1024; K25 / K26 at B=1, S=4096 and K27 at B=8, S=1024, bf16 caches;
    K28–K31 at the probes' shapes, K29 through the MMA; K32 at M=1, K=2560,
    N=13824; K33 at B=8, S=1024, 128-row pages, every slot full, its
    library ms the page gather plus SDPA); ``launches[phase]`` holds each serving phase's counts, zeroed
    before its path and read after.  A library ms is null where no single
    PyTorch call computes the function (the byte probes)."""
    from bitnet_tpu_torch.ops.registry import REGISTRY

    specs = {spec.kernel_id: spec for spec in REGISTRY}
    out = []
    for name, kid, replaces, phase, key, pick in SITES:
        timed = [r for r in res[key] if pick(r)]
        every = [r for r in res[key]
                 if "path" not in r or r["path"] == timed[0].get("path")]

        def total(field):
            vals = [r[field] for r in timed]
            return None if None in vals else sum(vals)

        out.append({
            "name": name, "route": specs[kid].route, "source": specs[kid].source,
            "replaces": replaces, "launches": launches.get(phase, {}).get(kid, 0),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(timed, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total("library_ms")})
    return out


# ---------------------------------------------------------------------------
# phase: parity (cuda kernels vs cpu plain versions, full width, 2 layers)
# ---------------------------------------------------------------------------
def _logits_agree(torch, a, b):
    """The parity phase's rule on one row of logits ``a`` against the
    reference row ``b``: their cosine, and whether the argmaxes agree or
    b's top-2 margin is within the largest difference."""
    a, b = a.float().cpu(), b.float().cpu()
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    top2 = torch.topk(b, 2).values
    same = int(a.argmax()) == int(b.argmax()) or float(
        top2[0] - top2[1]) <= float((a - b).abs().max())
    return cos, same


@contextlib.contextmanager
def _shared_cpu_preparation():
    """The CPU reference engines built inside share their prepared weights:
    ``engine.prepare_params`` on the CPU memoised on the params object and
    the fields of the EngineConfig it reads (the card's engines prepare
    their own).  The int8 head and TL re-quantization took most of a
    reference engine's start; the engines only read their weights."""
    from bitnet_tpu_torch.engine import engine as engine_mod

    real, memo = engine_mod.prepare_params, {}

    def prepare(params, ec, device, kernel_path):
        if device.type != "cpu":
            return real(params, ec, device, kernel_path)
        key = (id(params), ec.compute_dtype, ec.weight_quant, ec.fuse_projections,
               ec.logits_dtype, kernel_path)
        if key not in memo:           # the params kept, so the id stays theirs
            memo[key] = (params, real(params, ec, device, kernel_path))
        return memo[key][1]
    with mock.patch.object(engine_mod, "prepare_params", prepare):
        yield


def _teacher_forced(torch, eg, ecpu, prompt, steps=3):
    """Prefill both engines, then feed both the card's greedy tokens: the
    logits of ``steps`` positions compared, the prefill's and those of
    ``steps - 1`` decode steps.  Returns per-step cosines, both argmaxes,
    and whether every step that parted was a near-tie (CPU top-2 margin <=
    largest logit difference)."""
    from bitnet_tpu_torch.engine.sampling import argmax

    lg_g, lg_c = eg.prefill(prompt), ecpu.prefill(prompt)
    toks_g, toks_c, cos, tie_ok = [], [], [], []
    pos = len(prompt)
    for i in range(steps):
        c, ok = _logits_agree(torch, lg_g[0], lg_c[0])
        cos.append(c)
        tie_ok.append(ok)
        tg, tc = int(argmax(lg_g)[0]), int(argmax(lg_c)[0])
        toks_g.append(tg)
        toks_c.append(tc)
        if i + 1 < steps:
            lg_g, lg_c = eg.decode_step(tg, pos), ecpu.decode_step(tg, pos)
            pos += 1
    return {"tokens_cuda": toks_g, "tokens_cpu": toks_c, "min_cosine": min(cos),
            "cosines": cos, "ties_only": all(tie_ok),
            "tokens_agree": sum(a == b for a, b in zip(toks_g, toks_c))}


def _teacher_forced_batch(torch, eg, ecpu, prompts, steps=3):
    """``_teacher_forced`` for a pool, through ``prefill_batch`` and
    ``decode_batch_step``: every slot holds a prompt and is fed the card's
    greedy token; cosines and ties over all slots and compared positions."""
    import numpy as np

    from bitnet_tpu_torch.engine.sampling import argmax

    lg_g, lg_c = eg.prefill_batch(prompts), ecpu.prefill_batch(prompts)
    pos = np.array([len(p) for p in prompts], np.int32)
    cos, tie_ok, agree, n = [], [], 0, 0
    for i in range(steps):
        a, b = lg_g.float().cpu(), lg_c.float()
        cos += torch.nn.functional.cosine_similarity(a, b, dim=1).tolist()
        tg, tc = argmax(lg_g).cpu(), argmax(lg_c)
        top2 = torch.topk(b, 2, dim=1).values
        diff = (a - b).abs().amax(1)
        tie_ok += ((tg == tc) | (top2[:, 0] - top2[:, 1] <= diff)).tolist()
        agree += int((tg == tc).sum())
        n += len(prompts)
        if i + 1 < steps:
            lg_g = eg.decode_batch_step(tg.to(eg.device), pos)
            lg_c = ecpu.decode_batch_step(tg, pos)
            pos = pos + 1
    return {"slots": len(prompts), "min_cosine": min(cos), "ties_only": all(tie_ok),
            "tokens_agree": agree, "tokens": n}


@_shared_cpu_preparation()
def phase_parity(torch, dev):
    """The same 2-layer full-width model through the CUDA kernels and
    through the plain versions on the CPU, teacher-forced with the CUDA
    run's greedy tokens: the prefill's logits and those of two decode
    steps, at B = 1 and in a pool (cut from three decode steps at B = 1,
    and from a last decode step a call that ran uncompared, to make room
    for the server phase; halved before from 8 and 6 steps to keep the
    script inside its time limit on a slower host; the plans phase's
    2-layer parity likewise).  The CPU references share their prepared
    weights (``_shared_cpu_preparation``).  Every step's logits
    keep cosine >= 0.99, and the two pick the same token wherever the
    CPU's top-2 logit margin exceeds the largest logit difference: the
    decode attention kernels round their softmax weights to bf16 against
    other maxima than the plain versions, and int8 requantization
    amplifies that (``python -m
    bitnet_tpu_torch.tools.parity_probe``), so a near-tie may go either
    way.  The fused stacked path (slice 1) also requires equal tokens at
    f32.  The unfused generic path runs as the CLI builds it (bf16
    activations and tied head) on kernel paths w2a8 and pallas.  Slice 4
    adds the model re-quantized to TL2 and a bitnet32 model, each fused at
    B = 1 and in a pool of 3, and generic."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T.replace(num_layers=2)
    prompt = [int(t) for t in torch.randint(
        0, cfg.vocab_size, (24,), generator=torch.Generator().manual_seed(3))]
    params = build_synthetic(cfg, seed=7, device="cpu")
    cases = [(f"fused_{dt}", EngineConfig(
                 max_seq_len=256, logits_dtype="int8", kv_cache_dtype="bf16",
                 compute_dtype=dt, kernel_path="w2a8", fuse_projections=True))
             for dt in ("f32", "bf16")]
    cases += [(f"unfused_{kp}", EngineConfig(max_seq_len=256, kernel_path=kp))
              for kp in ("w2a8", "pallas")]
    # slice 3: quantized caches and pools (fused, bf16 activations, int8
    # head), and the CLI's engine with an int8 cache
    fused = dict(max_seq_len=256, logits_dtype="int8", kernel_path="w2a8",
                 fuse_projections=True)
    cases += [("fused_int8_B1", EngineConfig(kv_cache_dtype="int8", **fused)),
              ("fused_fp8_B2", EngineConfig(kv_cache_dtype="fp8", max_batch_size=2,
                                            **fused)),
              ("fused_bf16_B8", EngineConfig(kv_cache_dtype="bf16", max_batch_size=8,
                                             **fused)),
              ("fused_auto_B8", EngineConfig(kv_cache_dtype="auto", max_batch_size=8,
                                             **fused)),
              ("unfused_int8", EngineConfig(max_seq_len=256, kv_cache_dtype="int8"))]
    # slice 7: an f32 cache on the fused path at B=1 (K2) and in a pool of 8
    # (K8), and on the generic path (K5)
    cases += [("fused_f32kv_B1", EngineConfig(kv_cache_dtype="f32", **fused)),
              ("fused_f32kv_B8", EngineConfig(kv_cache_dtype="f32", max_batch_size=8,
                                              **fused)),
              ("unfused_f32kv", EngineConfig(max_seq_len=256, kv_cache_dtype="f32"))]
    # slice 4: TL2 re-quantization of the same model and a bitnet32 model,
    # fused at B = 1 (K11) and in a pool of 3 (K12), and generic (K10)
    b32 = build_synthetic(cfg, seed=7, device="cpu", kind="bitnet32")
    tl_fused = dict(fused, kv_cache_dtype="bf16")
    for kind, wq, p in (("tl2", "tl2", params), ("bitnet32", "none", b32)):
        cases += [(f"{kind}_fused_B1", EngineConfig(weight_quant=wq, **tl_fused), p),
                  (f"{kind}_fused_B3", EngineConfig(weight_quant=wq, max_batch_size=3,
                                                    **tl_fused), p),
                  (f"{kind}_generic", EngineConfig(max_seq_len=256, weight_quant=wq), p)]
    gen = torch.Generator().manual_seed(5)
    out = {}
    for case in cases:
        name, ec = case[:2]
        p = case[2] if len(case) > 2 else params
        t0 = time.perf_counter()
        eg = InferenceEngine(cfg, p, ec, device=dev)
        ecpu = InferenceEngine(cfg, p, ec, device="cpu")
        B = ec.max_batch_size
        if B > 1:
            pool = [[int(t) for t in torch.randint(0, cfg.vocab_size,
                                                   (int(n),), generator=gen)]
                    for n in torch.randint(8, 41, (B,), generator=gen)]
            r = _teacher_forced_batch(torch, eg, ecpu, pool)
            r["plan"] = eg.decode_plan()
        else:
            r = _teacher_forced(torch, eg, ecpu, prompt)
        r["ok"] = (r["min_cosine"] >= 0.99 and r["ties_only"]
                   and (name != "fused_f32" or r["tokens_cuda"] == r["tokens_cpu"]))
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        del eg, ecpu
        if not r["ok"]:
            raise AssertionError(f"parity failed for {name}: {r}")
    # slice 6: a 2-layer model at the 8B widths (no sub-norms), fused B=1;
    # its prefill through K24 (BITNET_FUSED_FFN=1, BITNET_STACKED_PREFILL=0,
    # a 24-token prompt: 32 rows); re-quantized to TL1 (K11, two kernels on
    # the K = 14336 down projection).  Each case must launch its kernel.
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.ops import registry

    cfg8 = LLAMA3_8B_158.replace(num_layers=2)
    p8 = build_synthetic(cfg8, seed=7, device="cpu")
    knobs = {"BITNET_FUSED_FFN": "1", "BITNET_STACKED_PREFILL": "0"}
    for name, ec, env, kid in (
            ("llama8b_fused_B1", EngineConfig(**tl_fused), {}, "ternary_matmul_w2a8_normed"),
            ("llama8b_ffn_fused_prefill", EngineConfig(**tl_fused), knobs, "ffn_w2a8_fused"),
            ("llama8b_tl1_fused_B1", EngineConfig(weight_quant="tl1", **tl_fused), {},
             "ternary_matmul_tl_w2a8_normed")):
        with mock.patch.dict(os.environ, env):
            eg = InferenceEngine(cfg8, p8, ec, device=dev)
            ecpu = InferenceEngine(cfg8, p8, ec, device="cpu")
            registry.reset_launch_counts()
            r = _teacher_forced(torch, eg, ecpu, prompt)
            r["launches"] = {kid: registry.launch_counts()[kid]}
            if env:         # the size of the other functions at 2 layers
                lg = eg.prefill(prompt).float().cpu()
                with mock.patch.dict(os.environ, {"BITNET_FUSED_FFN": "0"}):
                    lg0 = eg.prefill(prompt).float().cpu()
                with mock.patch.dict(os.environ, {"BITNET_FUSED_FFN": "0",
                                                  "BITNET_STACKED_PREFILL": "1"}):
                    ref = eg.prefill(prompt).float().cpu()
                for key, a, b in (("k24_vs_layer_loop", lg, lg0),
                                  ("layer_loop_vs_stacked", lg0, ref)):
                    r[f"cosine_{key}"] = float(
                        torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
        r["ok"] = r["min_cosine"] >= 0.99 and r["ties_only"] and r["launches"][kid] > 0
        out[name] = r
        del eg, ecpu
        if not r["ok"]:
            raise AssertionError(f"parity failed for {name}: {r}")
    out["ok"] = True
    return out


# ---------------------------------------------------------------------------
# phases: serving at the full 2B-4T shapes (fused stacked, then generic)
# ---------------------------------------------------------------------------
def _request(eng, prompt, gc, want):
    """One request with the launch counters zeroed before it and read
    after; ``want(prefill_bucket, decode_steps)`` gives the expected counts
    of every kernel (the others must stay 0)."""
    from bitnet_tpu_torch.ops import registry

    registry.reset_launch_counts()
    r = eng.generate(prompt, gc)
    n = registry.launch_counts()
    m = eng.last_metrics
    steps = m.decode_steps
    expect = {k.kernel_id: 0 for k in registry.REGISTRY}
    expect.update(want(eng._bucket(len(prompt)), steps))
    if n != expect:
        raise AssertionError(f"launch counts {n} != {expect}")
    return r, {"prompt": len(prompt), "generated": len(r.token_ids),
               "decode_steps": steps, "prefill_ms": m.prefill_s * 1e3,
               "decode_ms_per_token": m.decode_s * 1e3 / max(steps, 1),
               "decode_tok_s": steps / m.decode_s if m.decode_s else 0.0,
               "launches": n}


def _prompts(torch, cfg):
    gen = torch.Generator().manual_seed(11)
    return [[int(t) for t in torch.randint(0, cfg.vocab_size, (n,), generator=gen)]
            for n in (32, 128, 500)]


def _add(totals, launches):
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def phase_serving(torch, dev):
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=dev)
    ec = EngineConfig(max_seq_len=4096, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True)
    eng = InferenceEngine(cfg, params, ec, device=dev)
    # slice 7: the same engine over an f32 cache (K2's and K3's f32 instances)
    eng32 = InferenceEngine(cfg, params, ec.replace(kv_cache_dtype="f32"), device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg)
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    eng.generate(prompts[0], gc)                          # warm-up (allocator)

    def want(bucket, steps):
        return {"ternary_matmul_w2a8_normed": 4 * L * steps,
                "decode_attention_qkv": L * steps,
                "scatter_kv_rows": steps, "ternary_matmul_w2a8": 4 * L}

    runs, totals = [], {}
    for rep in range(2):
        toks = []
        for p in prompts:
            r, run = _request(eng, p, gc, want)
            _add(totals, run["launches"])
            toks.append(r.token_ids)
            runs.append({"rep": rep, **run})
        if rep == 0:
            first = toks
        elif toks != first:
            raise AssertionError("two runs gave different tokens")
    eng32.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))
    _r, run = _request(eng32, prompts[1], gc, want)
    _add(totals, run["launches"])
    runs.append({"rep": "f32_kv", **run})
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    weights = L * (H * (H + 2 * KVD) + H * H + H * 2 * F + F * H) / 4
    head = V * H

    def step_bytes(S, esz=2):
        return weights + head + 2 * L * S * KVD * esz

    return {"build_s": build_s, "runs": runs, "launch_totals": totals,
            "tokens": first, "decode_bytes_S1024": step_bytes(1024),
            "decode_bound_ms_S1024": step_bytes(1024) / HBM_BPS * 1e3,
            "decode_bytes_S1024_f32kv": step_bytes(1024, 4),
            "decode_bound_ms_S1024_f32kv": step_bytes(1024, 4) / HBM_BPS * 1e3,
            "bandwidth": "data sheet 3.35 TB/s (H100 SXM)", "ok": True}


def phase_batched(torch, dev):
    """Slice 3 at the full 2B-4T shapes (seed 0), fused, int8 head, w2a8:
    ``generate_batch`` pools of 8 prompts of 32-500 random tokens at
    max_seq_len 1024 — bf16 KV (``bench.py``'s B=8 row; twice, same tokens
    required), ``auto`` (→ int8) and fp8 — and of 64 prompts with int8 KV;
    then ``generate`` at B=1 with a 4096-row ``auto`` (→ int8) cache.  32 new
    tokens a request.  Launch counts per run: K1 4L, the plan's attention
    kernel L (K7 at B <= 2, K8 / K9 on pools) and K3 once a decode step, K4
    4L a prefill, every other kernel 0."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic
    from bitnet_tpu_torch.ops import registry

    cfg = BITNET_2B4T
    L, V = cfg.num_layers, cfg.vocab_size
    params = build_synthetic(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(21)

    def pool(n):
        return [[int(t) for t in torch.randint(0, V, (int(k),), generator=gen)]
                for k in torch.randint(32, 501, (n,), generator=gen)]

    attn_kernel = {"qkv_v2s": "decode_attention_qkv",
                   "qkv_quant_v2s": "decode_attention_qkv_quant",
                   "batched_v2": "decode_attention_batched",
                   "quant_batched_v2": "decode_attention_quant_batched"}
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    pool8, pool64 = pool(8), pool(64)
    cases = (("a_B8_bf16", 8, 1024, "bf16", pool8, 2),
             ("b_B8_auto", 8, 1024, "auto", pool8, 1),
             ("c_B64_int8", 64, 1024, "int8", pool64, 1),
             ("d_B1_S4096_auto", 1, 4096, "auto", _prompts(torch, cfg), 1),
             ("e_B8_fp8", 8, 1024, "fp8", pool8, 1))
    runs, totals = [], {}
    for name, B, S, kv, prompts, reps in cases:
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_seq_len=S, max_batch_size=B, kv_cache_dtype=kv, logits_dtype="int8",
            kernel_path="w2a8", fuse_projections=True), device=dev)
        plan = eng.decode_plan()
        if not eng.stacked_decode():
            raise AssertionError(f"{name}: not on the stacked decode loop")
        if B == 1:
            eng.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))
        else:
            eng.generate_batch([p[:8] for p in prompts[:2]],
                               GenerationConfig(max_new_tokens=2, greedy=True))
        first = None
        for rep in range(reps):
            # one pool request, or (B=1) one request a prompt
            for req in ([prompts] if B > 1 else [[p] for p in prompts]):
                registry.reset_launch_counts()
                if B > 1:
                    outs = [r.token_ids for r in eng.generate_batch(req, gc)]
                else:
                    outs = [eng.generate(req[0], gc).token_ids]
                n = registry.launch_counts()
                m = eng.last_metrics
                steps = m.decode_steps
                expect = {k.kernel_id: 0 for k in registry.REGISTRY}
                expect.update({"ternary_matmul_w2a8_normed": 4 * L * steps,
                               attn_kernel[plan]: L * steps,
                               "scatter_kv_rows": steps,
                               "ternary_matmul_w2a8": 4 * L})
                if n != expect:
                    raise AssertionError(f"{name}: launch counts {n} != {expect}")
                if any(len(t) != 32 or not all(0 <= x < V for x in t) for t in outs):
                    raise AssertionError(f"{name}: a slot did not give 32 tokens")
                generated = sum(len(t) for t in outs)
                runs.append({
                    "case": name, "rep": rep, "B": B, "S": S,
                    "kv": eng.kv_dtype, "plan": plan, "prompts": len(req),
                    "prompt_tokens": sum(len(p) for p in req),
                    "generated": generated, "decode_steps": steps,
                    "prefill_ms": m.prefill_s * 1e3,
                    "decode_ms_per_step": m.decode_s * 1e3 / max(steps, 1),
                    "decode_tok_s": generated / m.decode_s if m.decode_s else 0.0,
                    "aggregate_tok_s": generated / (m.prefill_s + m.decode_s),
                    "launches": n})
                _add(totals, n)
                if B > 1:
                    if first is None:
                        first = outs
                    elif outs != first:
                        raise AssertionError(f"{name}: two runs gave different tokens")
        del eng
        torch.cuda.empty_cache()
    return {"runs": runs, "launch_totals": totals, "ok": True}


def _run_requests(name, eng, reqs, gc, want, V):
    """Each request (one prompt → ``generate``; a pool, or any request of a
    pooled engine → ``generate_batch``) with the launch counters zeroed
    before it and read after; ``want(prefill_bucket, decode_steps)`` gives
    the expected counts (every other kernel 0).  Returns (tokens per
    request, one row per request, launch totals)."""
    from bitnet_tpu_torch.ops import registry

    out, rows, totals = [], [], {}
    for req in reqs:
        registry.reset_launch_counts()
        if len(req) > 1 or eng.engine_cfg.max_batch_size > 1:
            toks = [r.token_ids for r in eng.generate_batch(req, gc)]
        else:
            toks = [eng.generate(req[0], gc).token_ids]
        n = registry.launch_counts()
        m = eng.last_metrics
        steps = m.decode_steps
        expect = {k.kernel_id: 0 for k in registry.REGISTRY}
        expect.update(want(eng._bucket(max(len(p) for p in req)), steps))
        if n != expect:
            raise AssertionError(f"{name}: launch counts {n} != {expect}")
        if any(len(t) != gc.max_new_tokens or not all(0 <= x < V for x in t)
               for t in toks):
            raise AssertionError(f"{name}: a request did not give its tokens")
        generated = sum(len(t) for t in toks)
        rows.append({"case": name, "prompts": len(req),
                     "prompt_tokens": sum(len(p) for p in req),
                     "generated": generated, "decode_steps": steps,
                     "prefill_ms": m.prefill_s * 1e3,
                     "decode_ms_per_step": m.decode_s * 1e3 / max(steps, 1),
                     "decode_tok_s": generated / m.decode_s if m.decode_s else 0.0,
                     "launches": n})
        _add(totals, n)
        out.append(toks)
    return out, rows, totals


def phase_tl(torch, dev):
    """Slice 4 at the full 2B-4T shapes: bitnet32 and TL weights.
    (a) the synthetic QK256 model (seed 0) re-quantized with
    ``weight_quant="tl1"``, fused, B = 1, bf16 KV, int8 head, prompts of
    32 / 128 / 500 tokens, greedy, twice (equal tokens): per step K11 4L,
    K2 L, K3 1; per prefill K10 4L (the layer loop: the stacked prefill
    takes qk256 only).  (b) the same weights as a pool of 8 over bf16 KV:
    per step K12 4L, K8 L, K3 1.  (c) a synthetic bitnet32 model on the
    CLI's unfused engine (auto → w2a8, bf16 KV and tied head): per step
    K10 7L and K5 L, per prefill K10 7L.  (d) one request on a 2-layer
    bitnet32 model whose FFN width (6784) is a multiple of 128 but not of
    256: the stacked loop runs K10 on the stacked weights (``:555``), 4L a
    step and a prefill.  32 new tokens a request; launch counts checked
    per request, zeroed before it and read after."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T
    L, V = cfg.num_layers, cfg.vocab_size
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    prompts = _prompts(torch, cfg)
    gen = torch.Generator().manual_seed(31)
    pool8 = [[int(t) for t in torch.randint(0, V, (int(k),), generator=gen)]
             for k in torch.randint(32, 501, (8,), generator=gen)]
    fused = dict(kv_cache_dtype="bf16", logits_dtype="int8", kernel_path="w2a8",
                 fuse_projections=True)

    def run(name, eng, reqs, want, Lm=L):
        return _run_requests(name, eng, reqs, gc, lambda _b, steps: want(steps, Lm), V)

    runs, launches = [], {}
    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=dev)
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=1024, weight_quant="tl1",
                                                    **fused), device=dev)
    torch.cuda.synchronize()
    requant_s = time.perf_counter() - t0
    if not (eng.stacked_decode() and eng.params.blocks.wqkv.kind == "tl"
            and "ternary_matmul_tl_w2a8_stacked" in eng.kernel_recorder):
        raise AssertionError("(a) is not on the stacked TL W2A8 loop")
    eng.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))

    def want_a(steps, Lm):
        return {"ternary_matmul_tl_w2a8_normed": 4 * Lm * steps,
                "decode_attention_qkv": Lm * steps, "scatter_kv_rows": steps,
                "ternary_matmul_blockscale_bf16": 4 * Lm}
    first = None
    launches["tl_b1"] = {}
    for rep in range(2):
        toks, rows, tot = run("a_tl1_B1", eng, [[p] for p in prompts], want_a)
        runs += [dict(r, rep=rep) for r in rows]
        _add(launches["tl_b1"], tot)
        if first is None:
            first = toks
        elif toks != first:
            raise AssertionError("(a): two runs gave different tokens")
    del eng
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=1024, weight_quant="tl1",
                                                    max_batch_size=8, **fused), device=dev)
    del params
    if eng.decode_plan() != "batched_v2" or not eng.stacked_decode():
        raise AssertionError("(b) is not on the stacked batched_v2 loop")
    eng.generate_batch([p[:8] for p in pool8[:2]],
                       GenerationConfig(max_new_tokens=2, greedy=True))

    def want_b(steps, Lm):
        return {"ternary_matmul_tl_bf16_normed": 4 * Lm * steps,
                "decode_attention_batched": Lm * steps, "scatter_kv_rows": steps,
                "ternary_matmul_blockscale_bf16": 4 * Lm}
    _t, rows, launches["tl_pool"] = run("b_tl1_B8", eng, [pool8], want_b)
    runs += rows
    del eng
    torch.cuda.empty_cache()

    b32 = build_synthetic(cfg, seed=0, device=dev, kind="bitnet32")
    eng = InferenceEngine(cfg, b32, EngineConfig(max_seq_len=2048), device=dev)
    del b32
    if eng.kernel_path != "w2a8" or eng.params.blocks.wqkv is not None:
        raise AssertionError("(c) must run unfused on w2a8")
    eng.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))

    def want_c(steps, Lm):
        return {"ternary_matmul_blockscale_bf16": 7 * Lm * (steps + 1),
                "decode_attention": Lm * steps}
    _t, rows, launches["tl_generic"] = run("c_bitnet32_generic", eng,
                                           [[p] for p in prompts], want_c)
    runs += rows
    del eng
    torch.cuda.empty_cache()

    ucfg = cfg.replace(num_layers=2, intermediate_size=6784)
    ub = build_synthetic(ucfg, seed=0, device=dev, kind="bitnet32")
    eng = InferenceEngine(ucfg, ub, EngineConfig(max_seq_len=1024, **fused), device=dev)
    if not eng.stacked_decode():
        raise AssertionError("(d) must take the stacked loop")

    def want_d(steps, Lm):
        return {"ternary_matmul_blockscale_bf16": 4 * Lm * (steps + 1),
                "decode_attention_qkv": Lm * steps, "scatter_kv_rows": steps}
    _t, rows, launches["tl_unaligned"] = run("d_unaligned_bitnet32", eng,
                                             [[prompts[0]]], want_d, Lm=2)
    runs += rows
    del eng, ub
    torch.cuda.empty_cache()
    H, F, KVD = cfg.hidden_size, cfg.intermediate_size, cfg.num_kv_heads * cfg.head_dim
    n_w = L * (H * (H + 2 * KVD) + H * H + 3 * H * F)
    words_scales = n_w / 4 + n_w / 8

    def step_bytes(S, head):
        return words_scales + head + 2 * L * S * KVD * 2
    return {"requant_build_s": requant_s, "runs": runs, "launch_totals": launches,
            "decode_bytes_S1024_fused": step_bytes(1024, V * H),
            "decode_bound_ms_S1024_fused": step_bytes(1024, V * H) / HBM_BPS * 1e3,
            "decode_bytes_S1024_generic": step_bytes(1024, 2 * V * H),
            "decode_bound_ms_S1024_generic": step_bytes(1024, 2 * V * H) / HBM_BPS * 1e3,
            "bandwidth": "data sheet 3.35 TB/s (H100 SXM)", "ok": True}


def phase_llama8b(torch, dev):
    """Slice 6: the 8B-class model (Llama-3-8B-1.58 shapes: H=4096, F=14336,
    L=32, 32/8 heads of 128, vocab 128256, tied head, no sub-norms; random
    words from seed 0), 32 new tokens a request, launch counts checked per
    request (zeroed before it, read after; every other kernel 0):
    (a) fused B=1, bf16 KV, int8 head, w2a8, prompts of 32 / 128 / 500
        tokens, greedy, twice (equal tokens): a step K1 4L, K2 L, K3 1; a
        prefill K4 4L;
    (b) a fused pool of 8 (prompts of 32-500 tokens), bf16 KV: a step K1
        4L, K8 L, K3 1;
    (c) (a)'s engine under BITNET_FUSED_FFN=1 and BITNET_STACKED_PREFILL=0:
        prompts of 8 and 32 tokens prefill on the layer loop with K1 2L and
        K24 L (one fused FFN a layer), a 128-token prompt (M > 32) with K4
        4L and no K24; decode as (a).  The 32-token prefill's logits against
        (a)'s and against a control, the layer loop without K24: per-tile
        requantization, and the layer loop's norms in f32 inside K1 where
        the stacked prefill rounds them to bf16, are other functions, and
        32 layers of random weights amplify them (measured and reported;
        a floor of 0.8 catches a broken path);
    (d) re-quantized to TL1, fused B=1: a step K11 4L (the K = 14336 down
        projection on its two-kernel path), K2 L, K3 1; a prefill K10 4L;
    (e) the CLI's engine (EngineConfig(max_seq_len=2048): unfused, auto ->
        w2a8, bf16 KV and tied head): a step K1 7L and K5 L; a prefill of
        <= 64 rows K1 7L, else K4 7L."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158, build_synthetic

    cfg = LLAMA3_8B_158
    L, V, H, F = cfg.num_layers, cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    warm = GenerationConfig(max_new_tokens=2, greedy=True)
    prompts = _prompts(torch, cfg)
    gen = torch.Generator().manual_seed(21)
    pool8 = [[int(t) for t in torch.randint(0, V, (int(k),), generator=gen)]
             for k in torch.randint(32, 501, (8,), generator=gen)]
    fused = dict(kv_cache_dtype="bf16", logits_dtype="int8", kernel_path="w2a8",
                 fuse_projections=True)
    runs, totals, out = [], {}, {}

    def record(rows, tot, **extra):
        runs.extend(dict(r, **extra) for r in rows)
        _add(totals, tot)

    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=dev)
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=1024, **fused), device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    if not eng.stacked_decode() or eng.decode_plan() != "qkv_v2s":
        raise AssertionError("(a) is not on the stacked qkv_v2s loop")
    eng.generate(prompts[0][:8], warm)

    def want_a(bucket, steps):
        return {"ternary_matmul_w2a8_normed": 4 * L * steps,
                "decode_attention_qkv": L * steps, "scatter_kv_rows": steps,
                "ternary_matmul_w2a8": 4 * L}
    first = None
    for rep in range(2):
        toks, rows, tot = _run_requests("a_fused_B1", eng, [[p] for p in prompts], gc,
                                        want_a, V)
        record(rows, tot, rep=rep)
        if first is None:
            first = toks
        elif toks != first:
            raise AssertionError("(a): two runs gave different tokens")

    knobs = {"BITNET_FUSED_FFN": "1", "BITNET_STACKED_PREFILL": "0"}

    def want_c(bucket, steps):
        w = want_a(bucket, steps)
        if bucket <= 32:                     # the layer loop: K1 qkv and o, K24
            del w["ternary_matmul_w2a8"]
            w["ternary_matmul_w2a8_normed"] += 2 * L
            w["ffn_w2a8_fused"] = L
        return w
    ref = eng.prefill(prompts[0]).float().cpu()
    with mock.patch.dict(os.environ, knobs):
        eng.generate(prompts[0][:8], warm)
        _t, rows, tot = _run_requests("c_fused_ffn", eng, [[prompts[0][:8]], [prompts[0]],
                                                           [prompts[1]]], gc, want_c, V)
        lg = eng.prefill(prompts[0]).float().cpu()
    record(rows, tot)
    # the control: the same layer loop without K24 (K1 on all four
    # projections; its norms inside K1 in f32 where the stacked prefill
    # rounds them to bf16 first)
    with mock.patch.dict(os.environ, {"BITNET_STACKED_PREFILL": "0"}):
        lg0 = eng.prefill(prompts[0]).float().cpu()

    def cosine(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
    cos = {"c_vs_a": cosine(lg, ref), "c0_vs_a": cosine(lg0, ref),
           "c_vs_c0": cosine(lg, lg0)}
    out["prefill_logits_cosine"] = cos
    # Measurements of two functions that differ, not tolerances: over 32
    # layers of random weights the layer loop reads 0.913 against the
    # stacked prefill with or without K24 (PERF.md §6).  The floor catches
    # a broken path (a wrong kernel gives cosines near 0); the 2-layer
    # card-vs-CPU parity holds the kernels to >= 0.99.
    if min(cos.values()) < 0.8:
        raise AssertionError(f"(c): prefill logits cosines {cos}")
    del eng
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=1024, max_batch_size=8,
                                                    **fused), device=dev)
    if not eng.stacked_decode() or eng.decode_plan() != "batched_v2":
        raise AssertionError("(b) is not on the stacked batched_v2 loop")
    eng.generate_batch([p[:8] for p in pool8[:2]], warm)

    def want_b(bucket, steps):
        return {"ternary_matmul_w2a8_normed": 4 * L * steps,
                "decode_attention_batched": L * steps, "scatter_kv_rows": steps,
                "ternary_matmul_w2a8": 4 * L}
    _t, rows, tot = _run_requests("b_fused_B8", eng, [pool8], gc, want_b, V)
    record(rows, tot)
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=1024, weight_quant="tl1",
                                                    **fused), device=dev)
    torch.cuda.synchronize()
    out["tl1_requant_build_s"] = time.perf_counter() - t0
    if not (eng.stacked_decode() and eng.params.blocks.w_down.kind == "tl"
            and eng.params.blocks.w_down.k == F):
        raise AssertionError("(d) is not on the stacked TL loop")
    eng.generate(prompts[0][:8], warm)

    def want_d(bucket, steps):
        return {"ternary_matmul_tl_w2a8_normed": 4 * L * steps,
                "decode_attention_qkv": L * steps, "scatter_kv_rows": steps,
                "ternary_matmul_blockscale_bf16": 4 * L}
    _t, rows, tot = _run_requests("d_tl1_B1", eng, [[p] for p in prompts], gc, want_d, V)
    record(rows, tot)
    del eng
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=2048), device=dev)
    del params
    if eng.kernel_path != "w2a8" or eng.params.blocks.wqkv is not None:
        raise AssertionError("(e) the CLI's engine must run unfused on w2a8")
    eng.generate(prompts[0][:8], warm)

    def want_e(bucket, steps):
        w = {"ternary_matmul_w2a8_normed": 7 * L * steps, "decode_attention": L * steps}
        if bucket <= 64:
            w["ternary_matmul_w2a8_normed"] += 7 * L
        else:
            w["ternary_matmul_w2a8"] = 7 * L
        return w
    _t, rows, tot = _run_requests("e_cli_generic", eng, [[p] for p in prompts], gc,
                                  want_e, V)
    record(rows, tot)
    del eng
    torch.cuda.empty_cache()

    weights = L * (H * (H + 2 * KVD) + H * H + 3 * H * F) / 4

    def step_bytes(S, B, head):
        return weights + head + 2 * L * B * S * KVD * 2
    out.update({
        "runs": runs, "launch_totals": totals,
        "decode_bytes_S1024_B1": step_bytes(1024, 1, V * H),
        "decode_bound_ms_S1024_B1": step_bytes(1024, 1, V * H) / HBM_BPS * 1e3,
        "decode_bytes_S1024_B8": step_bytes(1024, 8, V * H),
        "decode_bound_ms_S1024_B8": step_bytes(1024, 8, V * H) / HBM_BPS * 1e3,
        "decode_bound_ms_S1024_generic": step_bytes(1024, 1, 2 * V * H) / HBM_BPS * 1e3,
        "bandwidth": "data sheet 3.35 TB/s (H100 SXM)", "ok": True})
    return out


def phase_generic(torch, dev):
    """The unfused generic path at the full 2B-4T shapes, engine built as
    the CLI builds it (EngineConfig(max_seq_len=2048): auto → w2a8 on the
    card, bf16 KV, bf16 tied head).  Per decode step 7L K1 + L K5 (no K2,
    no K3); a prefill bucket of <= 64 rows runs K1's two-kernel path, a
    larger one 7L K4.  On kernel_path="pallas" every projection is K6.  One
    greedy request over an f32 cache (kv_cache_dtype="f32") counts the same
    launches, K5 on its f32 instance."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=dev)
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=2048), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if eng.kernel_path != "w2a8" or eng.params.blocks.wqkv is not None:
        raise AssertionError("the CLI's engine must run unfused on w2a8")
    prompts = _prompts(torch, cfg)
    greedy = GenerationConfig(max_new_tokens=32, greedy=True)
    eng.generate(prompts[0], greedy)                      # warm-up (allocator)

    def want_w2a8(bucket, steps):
        pre = ({"ternary_matmul_w2a8_normed": 7 * L} if bucket <= 64
               else {"ternary_matmul_w2a8": 7 * L})
        pre["ternary_matmul_w2a8_normed"] = (pre.get("ternary_matmul_w2a8_normed", 0)
                                             + 7 * L * steps)
        pre["decode_attention"] = L * steps
        return pre

    def want_pallas(bucket, steps):
        return {"ternary_matmul_bf16": 7 * L * (1 + steps),
                "decode_attention": L * steps}

    runs, totals = [], {}
    for p in prompts:
        _r, run = _request(eng, p, greedy, want_w2a8)
        _add(totals, run["launches"])
        runs.append({"mode": "greedy", **run})
    sampled = []
    for rep in range(2):
        gc = GenerationConfig(max_new_tokens=32, temperature=1.0, seed=1234)
        toks = []
        for p in prompts:
            r, run = _request(eng, p, gc, want_w2a8)
            _add(totals, run["launches"])
            toks.append(r.token_ids)
            runs.append({"mode": f"seed1234_t1.0_rep{rep}", **run})
        sampled.append(toks)
    if sampled[0] != sampled[1]:
        raise AssertionError("the same seed gave different tokens")
    del eng
    # slice 7: the CLI's engine over an f32 cache (K5's f32 instance)
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=2048,
                                                    kv_cache_dtype="f32"), device=dev)
    eng.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))
    _r, run = _request(eng, prompts[1], greedy, want_w2a8)
    _add(totals, run["launches"])
    runs.append({"mode": "greedy_f32_kv", **run})
    del eng
    eng = InferenceEngine(cfg, params, EngineConfig(max_seq_len=2048,
                                                    kernel_path="pallas"),
                          device=dev)
    del params
    eng.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))
    _r, run = _request(eng, prompts[1], greedy, want_pallas)
    _add(totals, run["launches"])
    runs.append({"mode": "greedy_pallas", **run})
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    weights = L * (H * (H + 2 * KVD) + H * H + 3 * H * F) / 4
    head = V * H * 2                                  # the bf16 tied table

    def step_bytes(S):
        return weights + head + 2 * L * S * KVD * 2

    return {"build_s": build_s, "runs": runs, "launch_totals": totals,
            "decode_bytes_S1024": step_bytes(1024),
            "decode_bound_ms_S1024": step_bytes(1024) / HBM_BPS * 1e3,
            "bandwidth": "data sheet 3.35 TB/s (H100 SXM)", "ok": True}


# the plans phase: each knob setting of the JAX package's decode-attention
# selection, applied to the same engines as the default plans
PLAN_SETTINGS = (
    ("b1_attn_v1", {"BITNET_B1_ATTN": "v1"}),
    ("rope_fused_0", {"BITNET_ROPE_FUSED": "0"}),
    ("batched_attn_1", {"BITNET_BATCHED_ATTN": "1"}),
    ("batched_attn_v2qkv", {"BITNET_BATCHED_ATTN": "v2qkv"}),
    ("rope_fused_0_batched_attn_1", {"BITNET_ROPE_FUSED": "0",
                                     "BITNET_BATCHED_ATTN": "1"}),
    ("attn_stacked_0", {"BITNET_ATTN_STACKED": "0"}),
)


def _forced_logits(torch, eng, prompts, tokens, steps):
    """Logits [steps, B, V] (f32, host) of the prefill and of ``steps - 1``
    decode steps fed ``tokens`` (per slot) — teacher forcing."""
    import numpy as np

    B = eng.engine_cfg.max_batch_size
    if B == 1:
        lg = eng.prefill(prompts[0])
    else:
        lg = eng.prefill_batch(prompts)
    pos = np.array([len(p) for p in prompts], np.int32)
    out = [lg.float().cpu()]
    for t in range(steps - 1):
        tok = torch.tensor([toks[t] for toks in tokens], dtype=torch.int32)
        if B == 1:
            lg = eng.decode_step(int(tok[0]), int(pos[0]))
        else:
            lg = eng.decode_batch_step(tok.to(eng.device), pos)
        out.append(lg.float().cpu())
        pos = pos + 1
    return torch.stack(out)


def _against_default(torch, lg, ref):
    """Cosine of every slot's logits at every step against the default
    plan's, and whether every differing argmax is a near-tie (the default's
    top-2 margin no larger than the largest logit difference)."""
    cos = torch.nn.functional.cosine_similarity(lg, ref, dim=-1)
    top2 = torch.topk(ref, 2, dim=-1).values
    diff = (lg - ref).abs().amax(-1)
    same = lg.argmax(-1) == ref.argmax(-1)
    return {"min_cosine": float(cos.min()),
            "tokens_agree": int(same.sum()), "tokens": same.numel(),
            "ties_only": bool((same | (top2[..., 0] - top2[..., 1] <= diff)).all())}


def _plan_request(torch, eng, env, prompts, gc, L, ref=None, steps=8):
    """One request under ``env``: ``generate`` (B = 1) or ``generate_batch``
    with the counts zeroed before it and read after, then the same prompts
    teacher-forced with the default plan's tokens (``ref``)."""
    from bitnet_tpu_torch.models.bitnet import plan_attention
    from bitnet_tpu_torch.ops import registry

    B = eng.engine_cfg.max_batch_size
    with mock.patch.dict(os.environ, env):
        stacked = eng.stacked_decode()
        if stacked:
            plan = eng.decode_plan()
            rope_attn, split_attn = plan_attention(plan)
            attn = rope_attn or split_attn
            attn_name = None if attn is None else attn.__name__   # None: einsum
            family = ("einsum" if attn is None
                      else "rope_fused" if rope_attn is not None else "split")
        else:   # the generic path: K5, or K13 under BITNET_ROPE_FUSED=1
            plan = "generic"
            rope = env.get("BITNET_ROPE_FUSED") == "1"
            attn_name = "decode_attention_qkv_v1" if rope else "decode_attention"
            family = "rope_fused" if rope else "split"
        registry.reset_launch_counts()
        if B == 1:
            toks = [eng.generate(prompts[0], gc).token_ids]
        else:
            toks = [r.token_ids for r in eng.generate_batch(prompts, gc)]
        n = registry.launch_counts()
        m = eng.last_metrics
        lg = _forced_logits(torch, eng, prompts, ref["tokens"] if ref else toks, steps)
    n_steps = m.decode_steps
    if stacked:
        expect = {"ternary_matmul_w2a8_normed": 4 * L * n_steps,
                  "scatter_kv_rows": n_steps, "ternary_matmul_w2a8": 4 * L}
    else:       # fused projections on kernel_path="pallas": K6 for all four
        expect = {"ternary_matmul_bf16": 4 * L * (n_steps + 1)}
    if attn_name is not None:
        expect[attn_name] = L * n_steps
    want = {k.kernel_id: 0 for k in registry.REGISTRY}
    want.update(expect)
    if n != want:
        raise AssertionError(f"{env} B={B}: launch counts {n} != {want}")
    if any(len(t) != gc.max_new_tokens for t in toks):
        raise AssertionError(f"{env} B={B}: a slot did not give its tokens")
    rec = [r for r in eng.kernel_recorder if r.startswith("decode_")][-1]
    row = {"env": env, "B": B, "kv": eng.kv_dtype, "plan": plan,
           "recorder": rec, "attention_kernel": attn_name, "family": family,
           "prompt_tokens": sum(len(p) for p in prompts), "decode_steps": n_steps,
           "prefill_ms": m.prefill_s * 1e3,
           "decode_ms_per_step": m.decode_s * 1e3 / max(n_steps, 1),
           "launches": n, "tokens": toks, "logits": lg}
    if B == 1 and stacked and rec != f"decode_w2a8_attn_{plan}_x{gc.max_new_tokens}":
        raise AssertionError(f"{env}: the recorder says {rec}, the plan is {plan}")
    if ref is not None:
        row.update(_against_default(torch, lg, ref["logits"]))
        row["default_plan"] = ref["plan"]
        row["default_decode_ms_per_step"] = ref["decode_ms_per_step"]
        row["default_kernel_launches"] = (
            0 if ref["attention_kernel"] in (None, attn_name)
            else n[ref["attention_kernel"]])
        # the same function as the default plan (its v1 or v2 body, stacked
        # or per layer: only the softmax chunks differ) holds 0.99; another
        # function (RoPE and the rows' quantization in torch at the
        # activation dtype, or in f32 inside the kernel; the einsum tail's
        # plain attention) differs by a bf16 ulp a layer, which 30 layers of
        # W2A8 requantization amplify (0.965-0.983 on an H100, PERF.md §6)
        row["min_cosine_gate"] = 0.99 if family == ref["family"] else 0.95
        row["ok"] = (row["ties_only"] and row["default_kernel_launches"] == 0
                     and row["min_cosine"] >= row["min_cosine_gate"])
        del row["logits"]
        if not row["ok"]:
            raise AssertionError(f"{env} B={B}: against the default plan: "
                                 f"{ {k: v for k, v in row.items() if k != 'logits'} }")
    return row


def phase_plans(torch, dev):
    """Every other decode-attention plan at the full 2B-4T shapes (the
    serving phase's model, seed 0, 30 layers), fused, int8 head, w2a8: for
    B = 1 (``generate``, the 500-token prompt) and a pool of 8
    (``generate_batch``, prompts of 32–500 tokens), bf16 and int8 caches,
    one request under the default plans and one under each knob setting of
    ``PLAN_SETTINGS``, 32 new tokens each, then one generic-path request
    (fused projections on ``pallas``, bf16 cache, B = 1) with and without
    ``BITNET_ROPE_FUSED=1``.  Each request: the plan and the recorder's
    name; launch counts (K1 4L, the plan's attention wrapper L and K3 once
    a step, K4 4L a prefill, every other kernel 0; the default plan's
    wrapper 0 where the knob selects another); decode ms a step beside the
    default plan's of the same engine; the first 8 steps teacher-forced
    with the default plan's tokens: the same greedy token wherever the
    default's top-2 margin exceeds the largest logit difference, and logits
    cosine >= 0.99 where the plan computes the default's function (>= 0.95
    where the JAX package's plans themselves differ, see the gate).  Then
    each knob plan on a 2-layer model, card against CPU
    (:func:`_knob_parity`)."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T
    L, V = cfg.num_layers, cfg.vocab_size
    params = build_synthetic(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(21)
    pool8 = [[int(t) for t in torch.randint(0, V, (int(k),), generator=gen)]
             for k in torch.randint(32, 501, (8,), generator=gen)]
    one = [_prompts(torch, cfg)[2]]
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    runs, totals = [], {}
    engines = [(B, kv, EngineConfig(max_seq_len=1024, max_batch_size=B, kv_cache_dtype=kv,
                                    logits_dtype="int8", kernel_path="w2a8",
                                    fuse_projections=True), PLAN_SETTINGS)
               for B in (1, 8) for kv in ("bf16", "int8")]
    engines.append((1, "bf16", EngineConfig(max_seq_len=1024, kernel_path="pallas",
                                            fuse_projections=True),
                    (("generic_rope_fused_1", {"BITNET_ROPE_FUSED": "1"}),)))
    for B, kv, ec, settings in engines:
        eng = InferenceEngine(cfg, params, ec, device=dev)
        prompts = one if B == 1 else pool8
        if B == 1:
            eng.generate(prompts[0][:8], GenerationConfig(max_new_tokens=2, greedy=True))
        else:
            eng.generate_batch([p[:8] for p in prompts[:2]],
                               GenerationConfig(max_new_tokens=2, greedy=True))
        base = _plan_request(torch, eng, {}, prompts, gc, L)
        for name, env in settings:
            r = _plan_request(torch, eng, env, prompts, gc, L, ref=base)
            r["setting"] = name
            runs.append(r)
            _add(totals, r["launches"])
        base["setting"] = "default"
        runs.append(base)
        _add(totals, base["launches"])
        del eng
        torch.cuda.empty_cache()
    for r in runs:
        r.pop("logits", None)
    del params
    torch.cuda.empty_cache()
    return {"runs": runs, "launch_totals": totals,
            "parity": _knob_parity(torch, dev), "ok": True}


# (setting, B, cache dtype) of the 2-layer card-vs-CPU check: each knob
# plan that the 30-layer runs reach once
KNOB_PARITY = tuple(
    (name, B, kv) for name, Bs in (
        ("b1_attn_v1", (1,)), ("rope_fused_0", (1,)), ("attn_stacked_0", (1, 3)),
        ("batched_attn_1", (3,)), ("batched_attn_v2qkv", (3,)),
        ("rope_fused_0_batched_attn_1", (3,)), ("generic_rope_fused_1", (1,)))
    for B in Bs for kv in (("bf16",) if name.startswith("generic") else ("bf16", "int8")))


@_shared_cpu_preparation()
def _knob_parity(torch, dev):
    """Each knob plan on a 2-layer full-width model (seed 7), the card's
    kernels against the same engine's plain versions on the CPU, teacher
    forced as in the parity phase (its CPU references sharing their
    prepared weights): logits cosine >= 0.99 and equal tokens
    wherever the CPU's top-2 margin exceeds the logit difference — the
    kernels compute the port's plain functions, which the CPU tests hold
    to the JAX package's under the same knobs."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, build_synthetic

    cfg = BITNET_2B4T.replace(num_layers=2)
    params = build_synthetic(cfg, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(5)
    prompt = [int(t) for t in torch.randint(0, cfg.vocab_size, (24,), generator=gen)]
    pool = [[int(t) for t in torch.randint(0, cfg.vocab_size, (int(n),), generator=gen)]
            for n in torch.randint(8, 41, (3,), generator=gen)]
    settings = dict(PLAN_SETTINGS, generic_rope_fused_1={"BITNET_ROPE_FUSED": "1"})
    out = []
    for name, B, kv in KNOB_PARITY:
        generic = name.startswith("generic")
        ec = (EngineConfig(max_seq_len=256, kernel_path="pallas", fuse_projections=True)
              if generic else
              EngineConfig(max_seq_len=256, max_batch_size=B, kv_cache_dtype=kv,
                           logits_dtype="int8", kernel_path="w2a8", fuse_projections=True))
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, settings[name]):
            eg = InferenceEngine(cfg, params, ec, device=dev)
            ecpu = InferenceEngine(cfg, params, ec, device="cpu")
            plan = "generic" if generic else eg.decode_plan()
            r = (_teacher_forced(torch, eg, ecpu, prompt) if B == 1
                 else _teacher_forced_batch(torch, eg, ecpu, pool))
        r.update(setting=name, B=B, kv=kv, plan=plan,
                 ok=r["min_cosine"] >= 0.99 and r["ties_only"],
                 seconds=time.perf_counter() - t0)
        out.append(r)
        del eg, ecpu
        if not r["ok"]:
            raise AssertionError(f"knob parity failed under {name} B={B} {kv}: {r}")
    return out


def phase_kernel_bench(torch, dev):
    """``python -m bitnet_tpu_torch.cli benchmark-kernels`` three times, as
    a user runs it: the 2B decode shapes (K6), ``--attention all --m 1``,
    and ``--attention all --m 8 --seq-len 4096``.  Every result must carry
    the JAX tool's keys and a positive ``us_per_call``.  The CLI's ``main``
    runs in this process, its stdout captured (a process each cost ~7 s
    of start and card set-up; cut to make room for the checkpoints
    phase)."""
    import io

    from bitnet_tpu_torch import cli

    keys = ["name", "k", "n", "m", "us_per_call", "packed_mb", "gbps"]
    out = {}
    for name, argv in (("shapes_2b", []), ("attention_m1", ["--attention", "all", "--m", "1"]),
                       ("attention_m8_s4096", ["--attention", "all", "--m", "8",
                                               "--seq-len", "4096"])):
        t0 = time.perf_counter()
        so = io.StringIO()
        with contextlib.redirect_stdout(so):
            rc = cli.main(["benchmark-kernels", *argv])
        if rc != 0:
            raise AssertionError(f"benchmark-kernels {argv} failed: rc {rc}")
        rows = json.loads(so.getvalue())
        if not rows or any(list(row) != keys or not row["us_per_call"] > 0
                           for row in rows):
            raise AssertionError(f"benchmark-kernels {argv}: {rows}")
        out[name] = {"argv": argv, "seconds": time.perf_counter() - t0, "results": rows}
    out["ok"] = True
    return out


def phase_experiments(torch, dev):
    """The port's two experiment entry points as a user runs them.
    ``exp_w2a8``'s ``main`` (P1–P4 on K28–K31, P5 on K32 at K=2560,
    N=13824, timed beside K6 and K1): P1 must read ``ROW-MAJOR-LE``, P2 and
    P4 ``EXACT``, P5's cosine against K6 >= 0.99.  Then ``exp_r4_attn``'s
    bench of every variant (``paged`` on K33 since slice 21) at L=30, B=8,
    S=1024: µs a layer beside the stream floor.  Launch counts:
    the counters are zeroed before ``exp_w2a8``'s run and read after; for
    ``exp_r4_attn`` one untimed loop of each kernel variant, outside any
    CUDA graph (graph replays count nothing), must launch its kernel 30
    times and nothing else (K27 ×30 for ``v2p``)."""
    import contextlib
    import io
    import re

    from bitnet_tpu_torch.experiments import exp_r4_attn as ex
    from bitnet_tpu_torch.experiments import exp_w2a8 as ew
    from bitnet_tpu_torch.ops import registry

    out, totals = {}, {}
    registry.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ew.main([])
    text = buf.getvalue()
    counts = registry.launch_counts()
    _add(totals, counts)
    cos = re.search(r"cosine = ([0-9.]+)", text)
    w = {"rc": rc, "seconds": time.perf_counter() - t0, "stdout": text.splitlines(),
         "p1_row_major_le": "P1 ordering ROW-MAJOR-LE" in text,
         "p2_exact": text.count("P2 int8 dot") == 4 and "WRONG" not in text,
         "p4_exact": "P4 full unpack chain vs host: EXACT" in text,
         "p5_cosine": float(cos.group(1)) if cos else None,
         "launches": {k: v for k, v in counts.items() if v}}
    w["ok"] = (rc == 0 and w["p1_row_major_le"] and w["p2_exact"] and w["p4_exact"]
               and w["p5_cosine"] is not None and w["p5_cosine"] >= 0.99
               and all(counts[k] > 0 for k in ("bitcast_i32_to_i8", "int8_dot",
                                               "bytes_to_bf16", "unpack_words",
                                               "w2a8_matmul")))
    out["exp_w2a8"] = w
    if not w["ok"]:
        raise AssertionError(f"exp_w2a8 failed: {w}")
    L, B, S = 30, 8, 1024
    rows = []
    for variant in ex.ALL:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = ex.bench_variant(variant, L=L, B=B, S=S, device=dev)
        r["line"] = buf.getvalue().strip()
        if r["kernel"] is not None:         # one untimed loop, counted
            step, make_carry, fn, _ = ex.make_variant(variant, L, B, S, dev)
            registry.reset_launch_counts()
            y = step(make_carry(1), 0)
            torch.cuda.synchronize()
            counts = registry.launch_counts()
            r["untimed_launches"] = {k: v for k, v in counts.items() if v}
            r["finite"] = bool(torch.isfinite(y.float()).all())
            if r["untimed_launches"] != {fn.__name__: L} or not r["finite"]:
                raise AssertionError(f"exp_r4_attn {variant}: {r}")
            _add(totals, counts)
            del step, make_carry
        if not r["us_per_layer"] > 0:
            raise AssertionError(f"exp_r4_attn {variant}: {r}")
        rows.append(r)
    out["exp_r4_attn"] = rows
    out["launch_totals"] = totals
    out["ok"] = True
    return out


def phase_cli(torch, dev):
    """``bitnet_tpu_torch.cli run`` on the card, on mini QK256 and BitNet32
    GGUFs that the port's own fixtures write (hidden 256, F 512, 4/2 heads,
    embedded vocab): greedy, then seeded sampling, on the QK256 one (K1 and
    K5), greedy with ``--weight-quant tl2`` on it and greedy on the
    BitNet32 one (K10 and K5); 16 tokens each (EOS banned until 16 by
    --min-new-tokens)."""
    import contextlib
    import io
    import re

    from bitnet_tpu_torch import cli
    from bitnet_tpu_torch.gguf.fixtures import MiniModelSpec, generate_mini_gguf
    from bitnet_tpu_torch.ops import registry

    paths = {}
    for quant in ("qk256", "bitnet32"):
        paths[quant] = str(OUT_DIR / f"mini_{quant}.gguf")
        generate_mini_gguf(paths[quant], MiniModelSpec(
            hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
            quant=quant))
    out = {}
    mm_b = "ternary_matmul_blockscale_bf16"
    for mode, quant, extra, mm in (
            ("greedy", "qk256", ["--greedy"], "ternary_matmul_w2a8_normed"),
            ("seed0", "qk256", ["--seed", "0"], "ternary_matmul_w2a8_normed"),
            ("tl2_greedy", "qk256", ["--greedy", "--weight-quant", "tl2"], mm_b),
            ("bitnet32_greedy", "bitnet32", ["--greedy"], mm_b)):
        registry.reset_launch_counts()
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = cli.main(["run", "--model", paths[quant], "--prompt", "Hello world",
                           "--prompt-template", "raw", "-n", "16",
                           "--min-new-tokens", "16", *extra])
        n = registry.launch_counts()
        m = re.search(r"\[(\d+) tokens", se.getvalue())
        r = {"rc": rc, "text": so.getvalue(), "stderr": se.getvalue(),
             "tokens": int(m.group(1)) if m else None, "launches": n}
        r["ok"] = (rc == 0 and r["tokens"] == 16 and n[mm] > 0
                   and n["decode_attention"] > 0)
        out[mode] = r
        if not r["ok"]:
            raise AssertionError(f"cli run failed ({mode}): {r}")
    out["subcommands"] = _cli_subcommands(torch, paths["qk256"])
    out["ok"] = True
    return out


def _cli_call(argv, stdin=None):
    """``bitnet_tpu_torch.cli.main(argv)`` in this process: (rc, stdout,
    stderr), ``stdin`` fed to the REPL when given."""
    import contextlib
    import io

    from bitnet_tpu_torch import cli

    so, se = io.StringIO(), io.StringIO()
    with contextlib.ExitStack() as st:
        st.enter_context(contextlib.redirect_stdout(so))
        st.enter_context(contextlib.redirect_stderr(se))
        if stdin is not None:
            st.enter_context(mock.patch("sys.stdin", io.StringIO(stdin)))
        rc = cli.main(argv)
    return rc, so.getvalue(), se.getvalue()


def _cli_subcommands(torch, mini):
    """The JAX CLI's other subcommands on the card, on the mini QK256 GGUF:
    ``chat`` with redirected stdin (one turn of 8 tokens, /metrics, /clear,
    /exit; K1 and K5 launched), ``config`` on a file of its own (its model
    the default of ``tokenize``'s --model), ``list-templates``,
    ``list-architectures``, ``info`` and ``preflight`` (the H100,
    ``native_codec``, nvcc), ``bench-compare`` on two small JSON files (a
    regression: exit 1), ``download-model``'s refusal while downloads are
    off, and ``gate --require-native``."""
    import tempfile

    from bitnet_tpu_torch.ops import registry

    out, kind = {}, torch.cuda.get_device_name(0)
    registry.reset_launch_counts()
    rc, so, se = _cli_call(["chat", "-m", mini, "--greedy", "-n", "8",
                            "--min-new-tokens", "8"], "Hello\n/metrics\n/clear\n/exit\n")
    n = registry.launch_counts()
    metrics = [json.loads(x) for x in se.splitlines() if x.startswith("{")]
    out["chat"] = {"rc": rc, "reply": so.strip(), "metrics": metrics,
                   "cleared": "(history cleared)" in se, "launches": {
                       k: v for k, v in n.items() if v}}
    if (rc != 0 or not so.strip() or len(metrics) != 1
            or metrics[0].get("generated_tokens") != 8 or not out["chat"]["cleared"]
            or not n["ternary_matmul_w2a8_normed"] or not n["decode_attention"]):
        raise AssertionError(f"cli chat: {out['chat']} {se[-800:]}")
    with tempfile.TemporaryDirectory(prefix="cli_cfg_") as d:
        cfg = os.path.join(d, "config.json")
        with mock.patch.dict(os.environ, {"BITNET_TPU_CONFIG": cfg}):
            steps = [_cli_call(["config", "set", "model", mini]),
                     _cli_call(["config", "show"]), _cli_call(["config", "path"]),
                     _cli_call(["tokenize", "-p", "Hello world"])]
        toks = json.loads(steps[3][1])
        out["config"] = {"rc": [r[0] for r in steps], "show": json.loads(steps[1][1]),
                         "tokens_without_model": toks["count"]}
        if (out["config"]["rc"] != [0] * 4 or out["config"]["show"] != {"model": mini}
                or steps[2][1].strip() != cfg or toks["count"] < 2):
            raise AssertionError(f"cli config: {out['config']}")
        for name in ("list-templates", "list-architectures"):
            rc, so, _se = _cli_call([name])
            out[name] = {"rc": rc, "lines": len(so.splitlines())}
            if rc != 0 or not so.strip():
                raise AssertionError(f"cli {name}: {out[name]}")
        rc, so, _se = _cli_call(["info"])
        info = json.loads(so)
        out["info"] = {"rc": rc, **{k: info.get(k) for k in (
            "torch", "torch_cuda", "backend", "device", "recommended_kernel_path")}}
        if rc != 0 or info.get("backend") != "cuda" or \
                info["device"]["device_kind"] != kind or info["device"]["sm"] != [9, 0]:
            raise AssertionError(f"cli info: {out['info']}")
        rc, so, _se = _cli_call(["preflight"])
        out["preflight"] = pf = {"rc": rc, **json.loads(so)}
        if (rc != 0 or pf["device"]["device_kind"] != kind or not pf["native_codec"]
                or not pf["toolchain"]["nvcc"] or pf["recommended_kernel_path"] != "w2a8"):
            raise AssertionError(f"cli preflight: {pf}")
        files = []
        for name, v in (("base", 1.5), ("cand", 2.0)):
            files.append(os.path.join(d, f"{name}.json"))
            with open(files[-1], "w") as f:
                json.dump({"decode_ms_per_token_b1": v, "roofline_pct": 30 / v}, f)
        rc, so, _se = _cli_call(["bench-compare", *files, "--json"])
        out["bench_compare"] = {"rc": rc, **json.loads(so)}
        if rc != 1 or out["bench_compare"]["regressions"] != 2:
            raise AssertionError(f"cli bench-compare: {out['bench_compare']}")
    with mock.patch.dict(os.environ, {"BITNET_ALLOW_DOWNLOADS": ""}):
        rc, so, se = _cli_call(["download-model", "--repo", "org/model"])
    out["download_model"] = {"rc": rc, "stderr": se.strip()}
    if rc != 1 or "downloads disabled" not in se or so:
        raise AssertionError(f"cli download-model: {out['download_model']}")
    rc, so, _se = _cli_call(["gate", "--require-native"])
    out["gate_require_native"] = {"rc": rc, **json.loads(so)}
    if rc != 0 or not out["gate_require_native"]["checks"]["native_codec"]:
        raise AssertionError(f"cli gate --require-native: {out['gate_require_native']}")
    return out


# ---------------------------------------------------------------------------
# phase: requests (grammar, Mirostat, prefix cache, checkpoint, session on
# the full-width 2B fused engine)
# ---------------------------------------------------------------------------
REQ_SCHEMA = {"type": "object",
              "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"},
                             "tag": {"enum": ["a", "b"]}},
              "required": ["ok", "n"]}
REQ_KERNELS = ("ternary_matmul_w2a8_normed", "decode_attention_qkv",
               "scatter_kv_rows", "ternary_matmul_w2a8")


# ---------------------------------------------------------------------------
# phase: K-step decode segments (engine/loop.py), one CUDA graph of K steps
# ---------------------------------------------------------------------------
SEG_K = 8


def _segment_calls(eng) -> int:
    return sum(seg.calls for seg in eng._segments.values())


def _segment_leg(torch, name, eng, prompts, gcs, want):
    """Each prompt under each (name, GenerationConfig) of ``gcs`` at K = 1,
    then at K = ``SEG_K``, the counters zeroed before each request and read
    after: the tokens and the stop reason must be K = 1's; the counts must
    be ``want(bucket, decode_steps)`` at both K (every other kernel 0), so
    they are K = 1's kernel by kernel, per step: K = 8 decodes one more
    step where the last segment ends at ``max_new_tokens`` (the JAX rule
    runs a segment while ``remaining >= K``); and K = 8 must have replayed
    a graph for every K of its steps.  A request of K + 1 tokens at each K
    first (uncounted) captures the segment.  Host ms a step: the decode
    loop's clock, ending in a sync."""
    from bitnet_tpu_torch.ops import registry

    rows = []
    for gname, gc in gcs:
        for K in (1, SEG_K):
            eng.engine_cfg = eng.engine_cfg.replace(decode_steps_per_dispatch=K)
            eng.generate(prompts[0][:8], gc.replace(max_new_tokens=K + 1))
        for p in prompts:
            per = {}
            for K in (1, SEG_K):
                eng.engine_cfg = eng.engine_cfg.replace(decode_steps_per_dispatch=K)
                replays = _segment_calls(eng)
                registry.reset_launch_counts()
                r = eng.generate(p, gc)
                n = registry.launch_counts()
                m = eng.last_metrics
                steps = m.decode_steps
                expect = {k.kernel_id: 0 for k in registry.REGISTRY}
                expect.update(want(eng._bucket(len(p)), steps))
                if n != expect:
                    raise AssertionError(f"{name} {gname} K={K}: launch counts "
                                         f"{n} != {expect}")
                per[K] = {"tokens": r.token_ids, "stop": r.stop_reason.value,
                          "decode_steps": steps,
                          "replays": _segment_calls(eng) - replays,
                          "prefill_ms": m.prefill_s * 1e3,
                          "decode_ms_per_step": m.decode_s * 1e3 / max(steps, 1),
                          "launches": {k: v for k, v in n.items() if v}}
            one, seg = per[1], per[SEG_K]
            if (seg["tokens"] != one["tokens"] or seg["stop"] != one["stop"]
                    or len(one["tokens"]) != gc.max_new_tokens):
                raise AssertionError(f"{name} {gname}: K={SEG_K} tokens "
                                     f"{seg['tokens']} != K=1's {one['tokens']}")
            if one["replays"] or seg["replays"] != gc.max_new_tokens // SEG_K:
                raise AssertionError(f"{name} {gname}: replays {one['replays']} at "
                                     f"K=1, {seg['replays']} at K={SEG_K}")
            rows.append({"leg": name, "gen": gname, "prompt": len(p),
                         "tokens_equal": True, **{
                             f"k{K}_{key}": v for K, d in per.items()
                             for key, v in d.items() if key != "tokens"}})
    return rows


def _graph_ms(torch, eng):
    """(device ms a step, capture ms) of the engine's greedy segment: its
    graph replayed 4 times back to back (a 32-token request's segments)
    between two CUDA events, after one replay, going on from its last
    call's carry; the median of 3 such runs, over 4K steps."""
    seg = next(s for s in eng._segments.values()
               if s.graph is not None and s.chain.config.is_greedy)
    seg.graph.replay()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(4):
            seg.graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / (4 * seg.n_steps))
    return sorted(times)[1], seg.capture_s * 1e3


def phase_segments(torch, dev):
    """K-step decode segments on the card (``engine/loop.py``; ROADMAP #5):
    ``generate`` at K = 1 and K = 8 on the same engine (its
    ``decode_steps_per_dispatch`` switched), 32 new tokens a request:
    (a) the 2B fused B=1 engine (H=2560, F=6912, L=30, 20/5 heads of 128,
        vocab 128256; int8 head, bf16 cache, S=1024), prompts of 32, 128
        and 500, greedy and seeded top-k (K1 4L, K2 L, K3 1 a step; K4 4L
        a prefill);
    (b) the same words over an int8 cache (K7 for K2), greedy;
    (c) TL1 fused B=1 (K11 4L, K2 L, K3 1; K10 4L a prefill), greedy;
    (d) the CLI's generic engine (unfused, auto → w2a8, bf16 cache and tied
        head, S=2048; K1 7L and K5 L a step), greedy and seeded;
    (e) the 8B fused B=1 engine (Llama-3-8B-1.58 shapes, L=32), one
        request of 128 tokens, greedy.
    Each request: :func:`_segment_leg`'s gates.  Per leg: host ms a step at
    both K, the greedy graph's device ms a step (its replays between CUDA
    events) and capture ms, and the host's share of a K = 8 step."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import (BITNET_2B4T, LLAMA3_8B_158,
                                                   build_synthetic)

    cfg = BITNET_2B4T
    L = cfg.num_layers
    prompts = _prompts(torch, cfg)
    greedy = ("greedy", GenerationConfig(max_new_tokens=32, greedy=True))
    topk = ("topk40_t0.8_seed7", GenerationConfig(max_new_tokens=32, temperature=0.8,
                                                  top_k=40, seed=7))
    seeded = ("seed1234_t1.0", GenerationConfig(max_new_tokens=32, temperature=1.0,
                                                seed=1234))
    fused = dict(max_seq_len=1024, kv_cache_dtype="bf16", logits_dtype="int8",
                 kernel_path="w2a8", fuse_projections=True)

    def want_fused(attn, mm="ternary_matmul_w2a8_normed", pre="ternary_matmul_w2a8",
                   Lm=L):
        return lambda _bucket, steps: {mm: 4 * Lm * steps, attn: Lm * steps,
                                       "scatter_kv_rows": steps, pre: 4 * Lm}

    def want_generic(bucket, steps):
        pre = ({"ternary_matmul_w2a8_normed": 7 * L} if bucket <= 64
               else {"ternary_matmul_w2a8": 7 * L})
        pre["ternary_matmul_w2a8_normed"] = (pre.get("ternary_matmul_w2a8_normed", 0)
                                             + 7 * L * steps)
        pre["decode_attention"] = L * steps
        return pre

    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=dev)
    legs = (("a_2b_fused_bf16", EngineConfig(**fused), prompts, (greedy, topk),
             want_fused("decode_attention_qkv")),
            ("b_2b_fused_int8", EngineConfig(**{**fused, "kv_cache_dtype": "int8"}),
             prompts, (greedy,), want_fused("decode_attention_qkv_quant")),
            ("c_2b_tl1_fused", EngineConfig(weight_quant="tl1", **fused), prompts,
             (greedy,), want_fused("decode_attention_qkv",
                                   mm="ternary_matmul_tl_w2a8_normed",
                                   pre="ternary_matmul_blockscale_bf16")),
            ("d_2b_generic", EngineConfig(max_seq_len=2048), prompts, (greedy, seeded),
             want_generic))
    runs, split = [], {}
    for name, ec, ps, gcs, want in legs:
        eng = InferenceEngine(cfg, params, ec, device=dev)
        runs += _segment_leg(torch, name, eng, ps, gcs, want)
        split[name] = _graph_ms(torch, eng)
        del eng
        torch.cuda.empty_cache()
    del params
    cfg8 = LLAMA3_8B_158
    params = build_synthetic(cfg8, seed=0, device=dev)
    eng = InferenceEngine(cfg8, params, EngineConfig(**fused), device=dev)
    del params
    runs += _segment_leg(torch, "e_8b_fused", eng, [_prompts(torch, cfg8)[1]], (greedy,),
                         want_fused("decode_attention_qkv", Lm=cfg8.num_layers))
    split["e_8b_fused"] = _graph_ms(torch, eng)
    del eng
    torch.cuda.empty_cache()
    summary = {}
    for name, (dev_ms, cap_ms) in split.items():
        rs = [r for r in runs if r["leg"] == name and r["gen"] == "greedy"]
        k1 = sum(r["k1_decode_ms_per_step"] for r in rs) / len(rs)
        k8 = sum(r[f"k{SEG_K}_decode_ms_per_step"] for r in rs) / len(rs)
        summary[name] = {"host_ms_per_step_k1": k1, f"host_ms_per_step_k{SEG_K}": k8,
                         "graph_device_ms_per_step": dev_ms, "capture_ms": cap_ms,
                         f"host_share_k{SEG_K}": 1.0 - dev_ms / k8,
                         "host_share_k1": 1.0 - dev_ms / k1}
    return {"seconds": time.perf_counter() - t0, "runs": runs, "summary": summary,
            "ok": True}


def _sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _req_grammar(torch, dev, eng, prompt):
    """(a): a JSON-schema grammar, greedy and sampled (seed 0, T=0.8), 32
    tokens each; every token admissible under a fresh matcher over a vocab
    read anew from the tokenizer; ``root ::= "yes" | "no"`` gives one of
    the two.  The mask's host ms a step: the engine's work of a step (the
    matcher's mask, its copy to the card, the ``torch.where``) replayed
    over the greedy run's tokens, beside the run's decode ms a step."""
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.engine.sampling import NEG_INF
    from bitnet_tpu_torch.grammar import (Grammar, TokenVocab, VocabMatcher,
                                          json_schema_grammar)

    src = json_schema_grammar(REQ_SCHEMA)
    vocab = TokenVocab.from_tokenizer(eng.tokenizer)
    out = {"schema": REQ_SCHEMA}
    for name, gc in (("greedy", GenerationConfig(max_new_tokens=32, greedy=True,
                                                 grammar=src)),
                     ("sampled", GenerationConfig(max_new_tokens=32, temperature=0.8,
                                                  seed=0, grammar=src))):
        r = eng.generate(prompt, gc)
        m = VocabMatcher(Grammar.from_gbnf(src), vocab)
        bad = []
        for i, t in enumerate(r.token_ids):
            if not m.allowed_mask()[t]:
                bad.append((i, t))
            m.accept(t)
        if bad or not r.token_ids:
            raise AssertionError(f"grammar {name}: inadmissible tokens {bad} in "
                                 f"{r.token_ids}")
        met = eng.last_metrics
        out[name] = {"tokens": r.token_ids, "text": r.text,
                     "stop": r.stop_reason.value, "ttft_ms": met.ttft_s * 1e3,
                     "decode_ms_per_step": met.decode_s * 1e3 / max(met.decode_steps, 1),
                     "decode_steps": met.decode_steps}
    yn = eng.generate(prompt, GenerationConfig(max_new_tokens=8, greedy=True,
                                               grammar='root ::= "yes" | "no"'))
    if yn.text not in ("yes", "no"):
        raise AssertionError(f"yes/no grammar gave {yn.text!r} ({yn.token_ids})")
    out["yes_no"] = yn.text
    # the mask step alone, over the greedy run's tokens (warm: the engine's
    # vocab and compiled grammar, as a repeated request sees them)
    m = VocabMatcher(Grammar.from_gbnf(src), eng._grammar_vocab)
    lg = torch.zeros((1, eng.cfg.vocab_size), dtype=torch.bfloat16, device=dev)
    times = []
    for t in out["greedy"]["tokens"]:
        _, ms = _sync_ms(torch, lambda: torch.where(
            torch.tensor(m.allowed_mask(), device=dev)[None, :], lg, NEG_INF))
        times.append(ms)
        m.accept(t)
    out["mask_host_ms_per_step"] = sum(times) / len(times)
    return out


def _req_mirostat(torch, eng, prompt):
    """(b): Mirostat v1 and v2, 32 tokens each, seed 0.  tau and eta come
    from the prompt's first logits row: 2·tau (the first mu) is the
    surprise at its 5 % quantile, so v2 first keeps ~5 % of the vocab, and
    eta lets mu drift about half way to the top token's surprise in 32
    steps.  A second run of each, without the checks' host copies, must
    give the same tokens and gives the ms a step.  Each step's mu must equal mu − eta·(surprise − tau) within 1e-4,
    the surprise recomputed on the host (f32) from the same logits row; for
    v2 the token must have surprise <= the mu before the update whenever
    some token has; mu finite and moving."""
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.engine.sampling import MirostatState

    with torch.inference_mode():
        row = eng.prefill(prompt)[0].float().cpu()
    s = -torch.log_softmax(row, -1) / math.log(2.0)
    s_min, q05 = float(s.min()), float(torch.quantile(s, 0.05))
    tau = q05 / 2
    eta = max((q05 - s_min) / (32 * q05), 1e-4)
    out = {"surprise_bits": {"min": s_min, "q05": q05, "median": float(s.median()),
                             "max": float(s.max())}, "tau": tau, "eta": eta}
    real = MirostatState.sample_with_uniforms
    V = row.shape[0]
    for version in (1, 2):
        steps = []

        def spy(self, logits_row, u):
            mu0 = self.mu
            logp_dev = torch.log_softmax(logits_row.float(), -1)
            kept = int((self.truncate(logp_dev) > -1e29).sum())
            host = logits_row.float().cpu()
            tok = real(self, logits_row, u)
            sh = -torch.log_softmax(host, -1) / torch.log(torch.tensor(2.0))
            steps.append({"mu0": mu0, "mu1": self.mu, "tok": tok, "kept": kept,
                          "s_tok": float(sh[tok]),
                          "any_le": bool((sh <= mu0).any()),
                          "s_min": float(sh.min())})
            return tok

        gc = GenerationConfig(max_new_tokens=32, mirostat=version, mirostat_tau=tau,
                              mirostat_eta=eta, seed=0)
        with mock.patch.object(MirostatState, "sample_with_uniforms", spy):
            r = eng.generate(prompt, gc)
        # the same request without the spy's host copies: the step's time,
        # and the same tokens from the same seed
        if eng.generate(prompt, gc).token_ids != r.token_ids:
            raise AssertionError(f"mirostat v{version}: a second run parted")
        met = eng.last_metrics
        mus = [st["mu1"] for st in steps]
        upd = max(abs(st["mu1"] - (st["mu0"] - eta * (st["s_tok"] - tau)))
                  for st in steps)
        outside = [i for i, st in enumerate(steps)
                   if version == 2 and st["any_le"] and st["s_tok"] > st["mu0"] + 1e-4]
        nontrivial = sum(0 < st["kept"] < V for st in steps)
        res = {"tokens": r.token_ids, "steps": len(steps),
               "mu_first": steps[0]["mu0"] if steps else None, "mu_last": mus[-1] if mus else None,
               "mu_update_max_err": upd, "truncated_steps": nontrivial,
               "kept_min": min(st["kept"] for st in steps),
               "kept_max": max(st["kept"] for st in steps),
               "decode_ms_per_step": met.decode_s * 1e3 / max(met.decode_steps, 1)}
        out[f"v{version}"] = res
        if (len(steps) < 2 or not all(math.isfinite(m) for m in mus)
                or max(mus) == min(mus) == steps[0]["mu0"] or upd > 1e-4 or outside
                or nontrivial == 0):
            raise AssertionError(f"mirostat v{version}: {res} outside={outside}")
    return out


def _prefix_hits(torch, eng, cold, full, m):
    """Store ``full[:m]`` on ``eng``, then prefill ``full`` twice (hits
    restoring m and len(full)-1 rows) and ``full`` cold on ``cold``: the
    logits rows, the host ms of each prefill, the restores recorded, and
    whether the rows each hit restored equal its snapshot bit for bit."""
    from bitnet_tpu_torch.engine.prefix_cache import as_tensor

    out, seen = {}, []
    restore = eng._restore_prefix

    def spy(snap, n):
        seen.append(snap)
        restore(snap, n)

    with torch.inference_mode(), mock.patch.object(eng, "_restore_prefix", spy):
        cold.prefill(full)                                   # warm the bucket
        out["cold"], out["cold_ms"] = _sync_ms(torch, lambda: cold.prefill(full))
        _, out["store_ms"] = _sync_ms(torch, lambda: eng.prefill(full[:m]))
        for n in (m, len(full) - 1):
            lg, ms = _sync_ms(torch, lambda: eng.prefill(full))
            L = eng.cfg.num_layers
            rows = eng.cache.k[:, 0, :n].reshape(L, n, -1).cpu()
            out[f"m{n}"], out[f"m{n}_ms"] = lg, ms
            out[f"m{n}_rows_exact"] = torch.equal(
                rows.view(torch.uint8),
                as_tensor(seen[-1].k)[:, :n].reshape(L, n, -1).view(torch.uint8))
        out["recorded"] = [r for r in eng.kernel_recorder
                           if r.startswith("prefix_restore")][-2:]
    return out


def _req_prefix(torch, eng, cold, g):
    """(c): a 480-token shared prefix P prefilled alone, then P + 20 tokens
    (a hit at the stored 480: ``prefix_restore_m480``), then the same 500
    again (``prefix_restore_m499``: one token always runs); the rows each
    hit restored must equal its snapshot bit for bit, and each hit's
    last-token logits must keep cosine >= 0.99 against a cold prefill on
    the engine without the cache, with the same argmax wherever the cold
    top-2 margin exceeds the largest logit difference (the parity phase's
    rule).  Printed beside them: the cold engine's own decode route (P
    prefilled, the 20 tokens decoded one at a time) against its prefill,
    and the snapshot copies (device to host after a prefill, host to
    device at a hit) timed apart."""
    from bitnet_tpu_torch.engine.prefix_cache import snapshot_from_cache

    V = eng.cfg.vocab_size
    full = [int(t) for t in torch.randint(3, V, (500,), generator=g)]
    h = _prefix_hits(torch, eng, cold, full, 480)
    out = {"cold_ttft_ms": h["cold_ms"], "store_prefill_ms": h["store_ms"],
           "hit_m480_ttft_ms": h["m480_ms"], "hit_m499_ttft_ms": h["m499_ms"],
           "recorded": h["recorded"], "stats": eng.prefix_cache.stats()}
    for m in ("m480", "m499"):
        cos, same = _logits_agree(torch, h[m][0], h["cold"][0])
        out[f"{m}_cosine"], out[f"{m}_argmax_ok"] = cos, same
        out[f"{m}_rows_exact"] = h[f"{m}_rows_exact"]
        if cos < 0.99 or not same or not h[f"{m}_rows_exact"]:
            raise AssertionError(f"prefix hit {m}: {out}")
    if h["recorded"] != ["prefix_restore_m480", "prefix_restore_m499"]:
        raise AssertionError(f"prefix restores recorded {h['recorded']}")
    with torch.inference_mode():
        cold.prefill(full[:480])
        for i, t in enumerate(full[480:]):
            lg = cold.decode_step(t, 480 + i)
        out["decode_route_cosine"] = _logits_agree(torch, lg[0], h["cold"][0])[0]
        snap, out["snapshot_d2h_ms"] = _sync_ms(torch, lambda: snapshot_from_cache(
            eng.cache, 480, kv_heads=eng.cfg.num_kv_heads))
        _, out["restore_h2d_ms"] = _sync_ms(torch, lambda: eng._restore_prefix(snap, 480))
    out["snapshot_mb"] = snap.nbytes / 1e6
    return out


def _req_checkpoint(torch, eng, g):
    """(d): a greedy run of 32 tokens unbroken; then the same run broken
    off after 16 tokens, captured, saved, loaded and resumed on the reset
    engine (``kv_len`` = prompt + 15 at one step a round trip: the 16th
    token was yielded, not decoded; under K-step segments every segment
    that yielded a token decoded all its K, as in the JAX engine: prompt +
    16 at K = 8).  The 16 resumed tokens must equal the unbroken run's
    tail."""
    import tempfile

    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.engine import checkpoint as ck

    prompt = [int(t) for t in torch.randint(3, eng.cfg.vocab_size, (64,), generator=g)]
    gc = GenerationConfig(max_new_tokens=32, greedy=True)
    golden = eng.generate(prompt, gc).token_ids
    first = []
    for ev in eng.generate_stream(prompt, gc):
        first.append(ev.token_id)
        if len(first) == 16:
            break
    with tempfile.TemporaryDirectory(prefix="ckpt_") as d:
        path = os.path.join(d, "state")
        state, cap_ms = _sync_ms(torch, lambda: ck.capture(eng, prompt, first))
        (man, save_ms) = _sync_ms(torch, lambda: ck.save(state, path))
        loaded, load_ms = _sync_ms(torch, lambda: ck.load(path))
        eng.prefill([5, 6, 7])                                # the engine moves on
        res, resume_ms = _sync_ms(torch, lambda: ck.resume_generation(eng, loaded, gc))
    out = {"golden": golden, "first": first, "resumed": res.token_ids,
           "kv_len": man["kv_len"], "capture_ms": cap_ms, "save_ms": save_ms,
           "load_ms": load_ms, "resume_32_ms": resume_ms,
           "relogit_ms": res.metrics["ttft_s"] * 1e3}
    K = eng._segment_steps()
    out["decode_steps_per_dispatch"] = K
    if (man["kv_len"] != len(prompt) + (-(-16 // K) * K if K > 1 else 15)
            or first != golden[:16]
            or res.token_ids != golden[16:]):
        raise AssertionError(f"checkpoint resume: {out}")
    return out


def _req_session(eng):
    """(e): two chatml turns of 8 greedy tokens; the state ends DONE with
    5 messages (system, then user and assistant twice)."""
    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.engine.session import Session, SessionConfig, SessionState

    s = Session(eng, SessionConfig(system_prompt="You answer in one word.",
                                   template="chatml"))
    replies = [s.send(t, GenerationConfig(max_new_tokens=8, greedy=True))
               for t in ("Name a colour.", "And another?")]
    restores = [r for r in eng.kernel_recorder if r.startswith("prefix_restore")]
    out = {"replies": replies, "state": s.state.value, "messages": len(s.messages),
           "last_restore": restores[-1] if restores else None}
    if s.state != SessionState.DONE or len(s.messages) != 5:
        raise AssertionError(f"session: {out}")
    return out


def phase_requests(torch, dev):
    """The per-request state on the full-width 2B fused engine (synthetic
    qk256 words from seed 0, H=2560, F=6912, L=30, 20/5 heads, V=128256;
    int8 head, bf16 cache, S=1024, B=1; ``MockTokenizer(vocab_size=128256)``;
    ``prefix_cache_tokens=4096``): (a) grammar, (b) Mirostat, (c) prefix
    cache, (e) session on that engine, (d) checkpoint on its twin without
    the cache (a hit's suffix prefill rounds apart from a cold one's, and
    (d) needs the same bits twice).  The norm gains are set as
    ``tools/gen_2b_gguf.py`` sets its GGUF's (``condition_norms``): at
    gains of one no cosine gate at 30 layers tells a fault from rounding
    (``python -m bitnet_tpu_torch.tools.prefill_routes``).  Every check
    of each part must hold.  The launch counters are zeroed before the
    phase and read after: K1, K2, K3 and K4 must each have launched, every
    other kernel not at all."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import (BITNET_2B4T, build_synthetic,
                                                   condition_norms)
    from bitnet_tpu_torch.ops import registry
    from bitnet_tpu_torch.tokenizer import MockTokenizer
    from bitnet_tpu_torch.verify.receipts import generate_receipt

    cfg = BITNET_2B4T
    t0 = time.perf_counter()
    params = condition_norms(build_synthetic(cfg, seed=0, device=dev), cfg)
    tok = MockTokenizer(vocab_size=cfg.vocab_size)
    ec = EngineConfig(max_seq_len=1024, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True,
                      prefix_cache_tokens=4096)
    eng = InferenceEngine(cfg, params, ec, tokenizer=tok, device=dev)
    cold = InferenceEngine(cfg, params, ec.replace(prefix_cache_tokens=0),
                           tokenizer=tok, device=dev)
    del params
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    g = torch.Generator().manual_seed(19)
    prompt = [1] + [int(t) for t in torch.randint(3, 259, (40,), generator=g)]
    secs = out["seconds"] = {}
    registry.reset_launch_counts()
    for name, fn in (("grammar", lambda: _req_grammar(torch, dev, eng, prompt)),
                     ("mirostat", lambda: _req_mirostat(torch, eng, prompt)),
                     ("prefix", lambda: _req_prefix(torch, eng, cold, g)),
                     ("checkpoint", lambda: _req_checkpoint(torch, cold, g)),
                     ("session", lambda: _req_session(eng))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    n = registry.launch_counts()
    out["launches"] = {k: v for k, v in n.items() if v}
    missing = [k for k in REQ_KERNELS if not n[k]]
    extra = [k for k, v in n.items() if v and k not in REQ_KERNELS]
    if missing or extra:
        raise AssertionError(f"requests launches {n}: missing {missing}, other {extra}")
    out["receipt_kernels"] = _receipt_counts(
        generate_receipt(eng).kernels + generate_receipt(cold).kernels)
    out["ok"] = True
    return out


# ---------------------------------------------------------------------------
# phase: the continuous-batching scheduler (serve/scheduler.py) and K33
# ---------------------------------------------------------------------------
SCHED_S = 1024
SCHED_PAGE = 16
SCHED_LENS = (32, 500, 96, 250, 64, 420, 128, 300, 40, 180, 360, 72, 220, 480, 48,
              150, 270, 90, 390, 56, 200, 330, 110, 460)
SCHED_PREEMPT_AT = 20        # from this decode step, when every slot is busy


def _sched_script(torch, fork: bool, V: int):
    """24 staggered requests (prompts of 32–500 tokens): greedy, seeded
    top-k / top-p / typical, penalties with a logit bias (sampled and
    greedy), Mirostat v2, a JSON-schema grammar, logprobs, a min_new_tokens
    phase, one cancelled after 5 tokens, one with a 1 s deadline and one of
    priority -1 that arrives when every slot is busy (it preempts slot 0's
    request, greedy, 64 tokens).  Three a decode step from step 0, every
    other step.  ``fork``: requests 3 and 5 share a 160-token prefix (ten
    16-row pages)."""
    from bitnet_tpu_torch.config import GenerationConfig as G
    from bitnet_tpu_torch.grammar import json_schema_grammar

    g = torch.Generator().manual_seed(21)

    def prompt(n):
        return [1] + [int(t) for t in torch.randint(3, min(V, 30000), (n - 1,),
                                                    generator=g)]
    prompts = [prompt(n) for n in SCHED_LENS]
    if fork:
        prompts[5][:160] = prompts[3][:160]
    greedy = dict(max_new_tokens=32, greedy=True)
    gens = {
        0: dict(greedy, max_new_tokens=64), 1: greedy, 4: greedy, 11: greedy, 12: greedy,
        15: greedy, 17: greedy, 19: greedy, 21: greedy, 23: greedy,
        2: dict(max_new_tokens=32, temperature=0.8, top_k=40, seed=2),
        3: dict(max_new_tokens=32, temperature=0.9, top_p=0.9, seed=3),
        13: dict(max_new_tokens=32, temperature=0.7, top_k=20, seed=13),
        16: dict(max_new_tokens=32, temperature=1.0, top_p=0.8, seed=16),
        20: dict(max_new_tokens=32, temperature=0.8, typical_p=0.9, seed=20),
        22: dict(max_new_tokens=32, temperature=0.8, top_k=40, top_p=0.95, seed=22),
        5: dict(max_new_tokens=32, temperature=0.8, top_k=50, repetition_penalty=1.2,
                frequency_penalty=0.3, presence_penalty=0.2, seed=5,
                logit_bias=((7, 2.0), (11, -100.0))),
        14: dict(greedy, repetition_penalty=1.3, logit_bias=((13, 1.5),)),
        6: dict(max_new_tokens=32, mirostat=2, seed=6),
        7: dict(max_new_tokens=32, temperature=0.8, seed=7,
                grammar=json_schema_grammar(REQ_SCHEMA)),
        8: dict(greedy, logprobs=3),
        18: dict(max_new_tokens=32, min_new_tokens=8, temperature=0.9, seed=18),
        9: dict(greedy, max_new_tokens=400),
        10: dict(greedy, max_new_tokens=900),
    }
    kinds = {0: "greedy_long", 8: "logprobs", 6: "mirostat", 7: "grammar",
             9: "cancel", 10: "timeout", 23: "priority", 18: "min_tokens"}
    script = []
    for i in range(24):
        kw = {}
        if i == 10:
            kw["timeout_s"] = 1.0
        if i == 23:
            kw["priority"] = -1
        at = SCHED_PREEMPT_AT if i == 23 else 2 * (i // 3)
        kind = kinds.get(i, "greedy" if gens[i].get("greedy") else "sampled")
        script.append((at, prompts[i], G(**gens[i]), kw, kind))
    return script


def _sched_run(torch, sched, script, hook_ids=()):
    """Drive ``sched`` (built with ``start_loop=False``) over ``script``:
    each entry is submitted once the pool has decoded ``at`` steps; the
    cancel entry is cancelled at its fifth token.  With ``hook_ids``, the
    raw logits row of each token of those entries is kept (K=1 only).
    Returns per-entry tokens / reasons / times, the stats, the segments'
    counts a replay and capture ms, the launch counts and the wall time."""
    from bitnet_tpu_torch.ops import registry

    rows: dict[int, list] = {}
    by_req = {}
    if hook_ids:
        def hook(req, row):
            i = by_req.get(req.id)
            if i in hook_ids:
                rows.setdefault(i, []).append(row.float().clone())
        sched.logits_hook = hook
    reqs, t_sub = [None] * len(script), [0.0] * len(script)
    registry.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20000):
        busy = all(s.occupied for s in sched.slots) and not sched.pending.empty()
        for i, (at, prompt, gen, kw, kind) in enumerate(script):
            due = sched.stats["decode_steps"] >= at
            if kind == "priority":      # when it must preempt (or 40 steps late)
                due = due and (busy or sched.stats["decode_steps"] >= at + 40)
            if reqs[i] is None and due:
                t_sub[i] = time.perf_counter()
                reqs[i] = sched.submit(prompt, gen, **kw)
                by_req[reqs[i].id] = i
            if kind == "cancel" and reqs[i] is not None and len(reqs[i].token_times) >= 5:
                reqs[i].cancel()
        sched._step()
        if all(r is not None for r in reqs) and sched.pending.empty() and not any(
                s.occupied for s in sched.slots):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = []
    for i, r in enumerate(reqs):
        toks, reason = [], None
        while not r.out.empty():
            t, _, done, rs = r.out.get()
            if t is not None:
                toks.append(t)
            if done:
                reason = rs
        out.append({"tokens": toks, "reason": None if reason is None else reason.value,
                    "times": r.token_times, "t_submit": t_sub[i], "logprobs": r.logprobs,
                    "preempted": r.preemptions})
    segs = [{"k": seg.n_steps, "calls": seg.calls, "capture_ms": seg.capture_s * 1e3,
             "launches": dict(seg.launches)} for seg in sched._segments.values()]
    return {"reqs": out, "stats": dict(sched.stats), "segments": segs, "rows": rows,
            "launches": {k: v for k, v in registry.launch_counts().items() if v},
            "wall_s": wall, "plan": sched.plan()}


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def _sched_times(run, script):
    ttft = [(r["times"][0] - r["t_submit"]) * 1e3 for r in run["reqs"] if r["times"]]
    st = run["stats"]
    return {"ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
            "tok_s": st["tokens_generated"] / run["wall_s"], "wall_s": run["wall_s"],
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p90": _pct(ttft, 0.9),
            "capture_ms": [s["capture_ms"] for s in run["segments"]],
            "decode_steps": st["decode_steps"], "prefills": st["prefills"],
            "captures": st["captures"],
            "tokens": st["tokens_generated"], "preempted": st.get("preempted", 0),
            "evictions": st.get("evictions", 0),
            "prefix_forked_pages": st.get("prefix_forked_pages", 0)}


def _sched_gap_ms(run, i_long):
    """The largest gap between two tokens of the other streams whose span
    covers the long request's admission (its submit to its first token)."""
    r = run["reqs"][i_long]
    lo, hi = r["t_submit"], (r["times"][0] if r["times"] else r["t_submit"])
    gaps = [b - a for j, x in enumerate(run["reqs"]) if j != i_long
            for a, b in zip(x["times"], x["times"][1:]) if b >= lo and a <= hi]
    return max(gaps) * 1e3 if gaps else None


def _sched_want(plan, L):
    """Launches a decode step of the pool: K1 four a layer, the plan's
    attention one a layer, K3 once (dense) — K33 one a layer, no K3, paged."""
    from bitnet_tpu_torch.models.bitnet import ROPE_FUSED_ATTN, SPLIT_ATTN

    if plan == "paged":
        return {"ternary_matmul_w2a8_normed": 4 * L, "paged_attention": L}
    attn = (ROPE_FUSED_ATTN.get(plan) or SPLIT_ATTN[plan]).__name__
    return {"ternary_matmul_w2a8_normed": 4 * L, attn: L, "scatter_kv_rows": 1}


def _sched_gates(torch, name, r1, r8, script, L, b1, vocab, dev_type="cuda"):
    """The pool's gates (raise on a failure): K=8's tokens are K=1's (the
    cancelled, deadline, preempted and evicted requests aside); the cancel,
    deadline and preemption end as they must; grammar tokens admissible,
    logprobs one a token; each segment's launches a step are the want
    table's and K1's totals 4L a decode step; the first six greedy requests
    meet B=1 ``generate`` under the near-tie rule with every token's logits
    within cosine 0.99 of the B=1 engine's on the same tokens (its prefill,
    then its decode steps fed the pool's tokens)."""
    from bitnet_tpu_torch.grammar import Grammar, VocabMatcher

    info = {"plan": r1["plan"]}
    skip = set()
    for i, (_, _, _, _, kind) in enumerate(script):
        a, b = r1["reqs"][i], r8["reqs"][i]
        if kind in ("cancel", "timeout") or a["preempted"] or b["preempted"] or \
                "context_full" in (a["reason"], b["reason"]):
            skip.add(i)
            continue
        if a["tokens"] != b["tokens"] or a["reason"] != b["reason"]:
            raise AssertionError(f"{name}: request {i} ({kind}) K=8 {b['tokens']} "
                                 f"{b['reason']} != K=1 {a['tokens']} {a['reason']}")
    for run in (r1, r8):
        for i, (_, _, gen, _, kind) in enumerate(script):
            r = run["reqs"][i]
            want = {"cancel": "cancelled", "timeout": "timeout"}.get(kind)
            if want and r["reason"] != want:
                raise AssertionError(f"{name}: {kind} request ended {r['reason']}")
            if kind == "grammar":
                m = VocabMatcher(Grammar.from_gbnf(gen.grammar), vocab)
                for t in r["tokens"]:
                    if not m.allowed_mask()[t]:
                        raise AssertionError(f"{name}: inadmissible grammar token {t}")
                    m.accept(t)
            if kind == "logprobs" and len(r["logprobs"]) != len(r["tokens"]):
                raise AssertionError(f"{name}: logprobs {len(r['logprobs'])} entries")
        if any(k == "priority" for *_, k in script) and run["stats"].get(
                "preempted", 0) < 1 and len(script) <= 25:
            raise AssertionError(f"{name}: no preemption ({run['stats']})")
        if dev_type != "cuda":          # a rehearsal on the CPU: no kernel counts
            continue
        want = _sched_want(run["plan"], L)
        for seg in run["segments"]:
            per = {k: v / seg["k"] for k, v in seg["launches"].items()}
            if per != want:
                raise AssertionError(f"{name}: launches a step {per} != {want}")
        n = run["launches"]
        if n.get("ternary_matmul_w2a8_normed") != 4 * L * run["stats"]["decode_steps"]:
            raise AssertionError(f"{name}: K1 {n} for {run['stats']['decode_steps']} steps")
        if n.get("ternary_matmul_w2a8") != 4 * L * run["stats"]["prefills"]:
            raise AssertionError(f"{name}: K4 {n} for {run['stats']['prefills']} prefills")
    info["launches_per_step"] = _sched_want(r1["plan"], L)
    info["k_gate_requests"] = len(script) - len(skip)
    checked = []
    # a preempted greedy request first (its rows after the re-prefill too)
    order = sorted(range(len(script)), key=lambda i: not r1["reqs"][i]["preempted"])
    for i in order:
        _, prompt, gen, _, kind = script[i]
        if kind not in ("greedy", "greedy_long") or len(checked) >= 6 \
                or i not in r1["rows"] or not r1["reqs"][i]["tokens"]:
            continue
        toks = r1["reqs"][i]["tokens"]
        sched_rows = r1["rows"][i][:len(toks)]
        # B=1 generate's logits on these tokens: its prefill, then its
        # decode steps fed the pool's tokens
        with torch.inference_mode():
            ref = [b1.prefill(prompt)[0]]
            for j, t in enumerate(toks[:-1]):
                ref.append(b1.decode_step(t, len(prompt) + j)[0])
        gen_b1 = b1.generate(prompt, gen.replace(max_new_tokens=len(toks))).token_ids
        coss = []
        for j, row in enumerate(sched_rows):
            cos, same = _logits_agree(torch, row, ref[j])
            coss.append(cos)
            if not same:
                raise AssertionError(f"{name}: request {i} token {j} is not B=1's "
                                     "argmax and not a near tie")
        div = next((j for j, (a, b) in enumerate(zip(gen_b1, toks)) if a != b), None)
        if min(coss) < 0.99:
            raise AssertionError(f"{name}: request {i} cosine {min(coss)}")
        checked.append({"request": i, "kind": kind, "tokens": len(toks),
                        "preempted": r1["reqs"][i]["preempted"],
                        "min_cosine": min(coss), "b1_equal": gen_b1 == toks,
                        "b1_parts_at": div})
    if not checked:
        raise AssertionError(f"{name}: no greedy request checked against B=1")
    info["b1"] = checked
    return info


def phase_scheduler(torch, dev):
    """The continuous-batching scheduler on the full-width 2B fused engine
    (synthetic qk256 words from seed 0, ``condition_norms`` gains, 30
    layers, int8 head, S=1024, the mock tokenizer over 128256 ids; kernel
    path w2a8): (a) a pool of 8 bf16 slots, (b) kv 'auto' → int8, (c) paged
    with half of B·S/16 pages of 16 rows and a shared-prefix fork (K33 L
    times a step), (d) chunked prefill of 64 while a 900-token prompt joins
    the in-flight streams (the gap between tokens read on seven greedy
    streams of a warm pool, chunked and whole, when the prompt joins), (e)
    a pool of 64 on int8 (the 24 requests and 40 greedy fillers).  Each
    pool runs its script at K=1 and at K=8 (``decode_steps_per_dispatch``),
    each a fresh scheduler stepped by hand; gates in ``_sched_gates``.
    Times: ms a step (host clock of the dispatches: copies, replay, token
    read), decoded tok/s over the run's wall, TTFT p50 / p90, capture ms,
    the largest gap between tokens around the 900-token admission."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine, prepare_params
    from bitnet_tpu_torch.grammar import TokenVocab
    from bitnet_tpu_torch.models.synthetic import (BITNET_2B4T, build_synthetic,
                                                   condition_norms)
    from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    from bitnet_tpu_torch.tokenizer import MockTokenizer

    cfg, L = BITNET_2B4T, BITNET_2B4T.num_layers
    t0 = time.perf_counter()
    ec = EngineConfig(max_seq_len=SCHED_S, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True)
    params, _ = prepare_params(condition_norms(build_synthetic(cfg, seed=0, device=dev),
                                               cfg), ec, dev, "w2a8")
    tok = MockTokenizer(vocab_size=cfg.vocab_size)
    vocab = TokenVocab.from_tokenizer(tok)
    b1 = {kv: InferenceEngine(cfg, params, ec.replace(kv_cache_dtype=kv), tokenizer=tok,
                              device=dev) for kv in ("bf16", "int8")}
    torch.cuda.synchronize()
    out, totals = {"build_s": time.perf_counter() - t0, "pools": {}}, {}
    V = min(cfg.vocab_size, 20000)
    fill = [(0, [1] + [3 + (7 * j + 5 * i) % (V - 3) for j in range(31 + i)],
             GenerationConfig(max_new_tokens=24, greedy=True), {}, "filler")
            for i in range(40)]
    long_req = [(30, [1] + [3 + (11 * j) % (V - 3) for j in range(899)],
                 GenerationConfig(max_new_tokens=16, greedy=True), {}, "long")]
    pools = (
        ("a_bf16_b8", dict(num_slots=8), "bf16", False, []),
        ("b_auto_int8_b8", dict(num_slots=8, ecfg=dict(kv_cache_dtype="auto")), "int8",
         False, []),
        ("c_paged_b8", dict(num_slots=8, paged=True, page_size=SCHED_PAGE,
                            num_pages=8 * SCHED_S // SCHED_PAGE // 2), "bf16", True, []),
        ("d_chunked64_b8", dict(num_slots=8, chunked_prefill=64), "bf16", False,
         long_req),
        ("e_int8_b64", dict(num_slots=64, max_admissions_per_step=8,
                            ecfg=dict(kv_cache_dtype="int8")), "int8", False, fill),
    )
    for name, kw, kv, fork, extra in pools:
        t1 = time.perf_counter()
        script = _sched_script(torch, fork, cfg.vocab_size) + extra
        kw = dict(kw)
        e = ec.replace(**kw.pop("ecfg", {}))
        greedy_ids = {i for i, s in enumerate(script) if s[4] in ("greedy", "greedy_long")}

        def make(k, **more):
            return ContinuousBatchingScheduler(cfg, params, tok, e, start_loop=False,
                                               decode_steps_per_dispatch=k, device=dev,
                                               **{**kw, **more})
        s1 = make(1)
        r1 = _sched_run(torch, s1, script, hook_ids=greedy_ids)
        del s1
        s8 = make(SEG_K)
        r8 = _sched_run(torch, s8, script)
        del s8
        info = _sched_gates(torch, name, r1, r8, script, L, b1[kv], vocab, dev.type)
        info["k1"], info["k8"] = _sched_times(r1, script), _sched_times(r8, script)
        if name.startswith("c_") and info["k1"]["prefix_forked_pages"] < 1:
            raise AssertionError(f"{name}: no prefix fork ({r1['stats']})")
        if extra is long_req:
            # the gap: seven greedy streams in flight when the 900-token
            # prompt joins, on a chunked and on a whole-prompt pool, each
            # run twice and read the second time (its graphs captured)
            gap = [(0, [1] + [5 + (13 * j + i) % (V - 5) for j in range(40 + 8 * i)],
                    GenerationConfig(max_new_tokens=48, greedy=True), {}, "stream")
                   for i in range(7)] + [(8, *long_req[0][1:])]
            for key, chunk in (("chunked", 64), ("whole", None)):
                sg = make(1, chunked_prefill=chunk)
                _sched_run(torch, sg, gap)
                rg = _sched_run(torch, sg, gap)
                del sg
                info[f"gap_ms_{key}"] = _sched_gap_ms(rg, len(gap) - 1)
                info[f"gap_run_{key}"] = _sched_times(rg, gap)
        info["launches_k1"] = r1["launches"]
        info["seconds"] = time.perf_counter() - t1
        out["pools"][name] = info
        emit({"phase": f"scheduler.{name}", **{k: v for k, v in info.items()
                                                if k != "launches_k1"}})
        _add(totals, r1["launches"])
        _add(totals, r8["launches"])
        del r1, r8
        torch.cuda.empty_cache()
    out["launch_totals"] = totals
    out["ok"] = True
    return out


# the JAX gate's tokens (tools/gate_2b.py) and the reference's crossval
# threshold (crossval/src/logits_compare.rs:24)
GATE_TOKENS = "2,7,11,5"
GATE_MIN_COSINE = 0.99


def _receipt_counts(kernels):
    """``kernel_<registry id>_x<n>`` entries of a receipt, summed per
    kernel and named by their site's K number (``SITES``)."""
    k_of = {kid: key.upper() for _n, kid, _r, _p, key, _f in SITES}
    counts = {}
    for k in kernels:
        if k.startswith("kernel_") and "_x" in k:
            kid, n = k[len("kernel_"):].rsplit("_x", 1)
            label = f"{k_of.get(kid, '?')} {kid}"
            counts[label] = counts.get(label, 0) + int(n)
    return counts


def _gen_2b(kind, path):
    """``tools/gen_2b_gguf.py`` (run as it is, the checkout on its path)."""
    from bitnet_tpu_torch.tools.gate_2b import run

    rc, _out, err = run([sys.executable, "tools/gen_2b_gguf.py", kind, path], 600)
    if rc != 0:
        raise AssertionError(f"gen_2b_gguf.py {kind} failed: {err[-800:]}")


def _crossval_leg(torch, path, extra):
    """``cli crossval --backend cppref`` in this process, at the gate's
    tokens and --max-seq-len 256, on the card: the printed result and the
    kernels its eval_ids launched."""
    import contextlib
    import io

    from bitnet_tpu_torch import cli
    from bitnet_tpu_torch.ops import registry

    t0 = time.perf_counter()
    so = io.StringIO()
    registry.reset_launch_counts()
    with contextlib.redirect_stdout(so):
        rc = cli.main(["crossval", "-m", path, "--tokens", GATE_TOKENS,
                       "--backend", "cppref", "--max-seq-len", "256", *extra])
    n = {k: v for k, v in registry.launch_counts().items() if v}
    res = json.loads(so.getvalue())
    return {"rc": rc, **{k: res[k] for k in (
        "cosines", "min_cosine", "first_divergence", "ppl_ours", "ppl_theirs",
        "ppl_rel_delta")}, "launches": n, "seconds": time.perf_counter() - t0}


def phase_gate(torch, dev, workdir):
    """The port's 2B gate on the card: ``python -m
    bitnet_tpu_torch.tools.gate_2b`` on the full-width 2B qk256 GGUF of
    ``tools/gen_2b_gguf.py`` (generate, build the C++ golden, ``cli run
    --greedy --receipt``, ``cli gate --receipt --require-cuda``, ``cli
    crossval --backend cppref`` at tokens 2,7,11,5, --max-seq-len 256, the
    default path w2a8).  Fails unless every check passes, every
    per-position cosine is >= 0.99, and the receipt is strict-valid with
    backend cuda and K1 / K5 launch counts.  Then two legs for information
    (they must run; their cosines are not gated): the same GGUF on
    --kernel-path pallas (K6, bf16 activations) and the bitnet32 2B GGUF
    (K10 on the generic path)."""
    import tempfile

    from bitnet_tpu_torch.verify.receipts import InferenceReceipt, validate_receipt

    out = {}
    with tempfile.TemporaryDirectory(prefix="gate_2b_") as d:
        # the qk256 GGUF stays for the speculative phase's CLI leg
        qk = os.path.join(workdir, "bitnet2b_qk256.gguf")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "bitnet_tpu_torch.tools.gate_2b",
                            "--gguf", qk, "--kind", "qk256", "--tokens", GATE_TOKENS],
                           cwd=REPO, capture_output=True, text=True, timeout=900)
        lines = r.stdout.strip().splitlines()
        verdict = json.loads(lines[-1]) if lines else {}
        gate = {"rc": r.returncode, **verdict, "seconds_by_step": verdict.get("seconds"),
                "seconds": time.perf_counter() - t0}
        out["qk256_w2a8"] = gate
        rec = verdict.get("receipt") or {}
        counts = _receipt_counts(rec.get("kernels") or [])
        out["receipt_kernels"] = counts
        cos = (verdict.get("cppref") or {}).get("cosines") or []
        problems = validate_receipt(InferenceReceipt(
            kernels=rec.get("kernels") or [], compute_path=rec.get("compute_path")))
        ids = {label.split()[1] for label in counts}
        if (r.returncode != 0 or not verdict.get("pass") or len(cos) != 4
                or min(cos) < GATE_MIN_COSINE or problems
                or rec.get("backend") != "cuda"
                or not {"ternary_matmul_w2a8_normed", "decode_attention"} <= ids):
            raise AssertionError(f"2B gate failed: {gate} {problems} "
                                 f"{r.stderr[-1500:]}")
        out["pallas"] = _crossval_leg(torch, qk, ["--kernel-path", "pallas"])
        # the bitnet32 GGUF stays too: the server phase loads it as a second model
        b32 = os.path.join(workdir, "bitnet2b_bitnet32.gguf")
        t0 = time.perf_counter()
        _gen_2b("bitnet32", b32)
        out["bitnet32_generate_s"] = time.perf_counter() - t0
        out["bitnet32_w2a8"] = _crossval_leg(torch, b32, [])
    for leg in ("pallas", "bitnet32_w2a8"):
        if not out[leg]["launches"]:
            raise AssertionError(f"the {leg} leg launched no kernel: {out[leg]}")
    keys = ("cosines", "min_cosine", "ppl_rel_delta")
    out["legs"] = {"qk256_w2a8": {**{k: gate["cppref"][k] for k in keys},
                                  "seconds": gate["seconds"],
                                  "steps_s": gate.get("seconds_by_step")}}
    for leg in ("pallas", "bitnet32_w2a8"):
        out["legs"][leg] = {k: out[leg][k] for k in (*keys, "seconds", "launches")}
    out["ok"] = True
    return out


# ---------------------------------------------------------------------------
# phase: speculative decoding and pipelined serving (engine/speculative.py,
# the scheduler's speculative_k and pipeline_depth)
# ---------------------------------------------------------------------------
SPEC_K = 4
SPEC_TOKENS = 32


def _tie_rule(torch, name, ref, prompt, want, got):
    """Greedy tokens ``got`` held to ``want`` under the near-tie rule: equal
    up to the first position j where they part, and there the B=1 decode
    path's logits (``ref``'s prefill, then its decode steps fed ``want``)
    prefer ``want[j]`` over ``got[j]`` by no more than the largest
    difference between them and the prefill path's logits of the same
    context (``ref.eval_ids``: the verify's function), at cosine >= 0.99.
    Raises on a failure; returns where the lists parted and the margins."""
    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        if len(want) != len(got):
            raise AssertionError(f"{name}: {len(got)} tokens != {len(want)}")
        return {"equal": True, "tokens": len(got)}
    with torch.inference_mode():
        dec = ref.prefill(prompt)[0]
        for i, t in enumerate(want[:j]):
            dec = ref.decode_step(t, len(prompt) + i)[0]
    dec = dec.float().cpu()
    ver = torch.from_numpy(ref.eval_ids(prompt + want[:j])[-1]).float()
    diff = float((ver - dec).abs().max())
    gap = float(dec[want[j]] - dec[got[j]])
    cos = float(torch.nn.functional.cosine_similarity(ver, dec, dim=0))
    info = {"equal": False, "tokens": len(got), "parts_at": j, "gap": gap,
            "max_diff": diff, "cosine": cos}
    if gap > diff or cos < 0.99:
        raise AssertionError(f"{name}: token {j} {got[j]} != {want[j]} is not a "
                             f"near tie: {info}")
    return info


class _TimedDraft:
    """A draft source timed a round (its propose, synchronized)."""

    def __init__(self, torch, draft):
        self.torch, self.draft, self.s, self.n = torch, draft, 0.0, 0

    def begin(self, tokens):
        self.draft.begin(tokens)

    def propose(self, tokens, k):
        t0 = time.perf_counter()
        out = self.draft.propose(tokens, k)
        self.torch.cuda.synchronize()
        self.s += time.perf_counter() - t0
        self.n += 1
        return out


def _verify_ms(torch, dec, T):
    """(device ms a round, capture ms) of the decoder's verify of T tokens:
    its graph replayed 10 times between two CUDA events after one replay,
    the median of 3 (the rows it writes are rewritten in place)."""
    v = next(v for key, v in dec._verifies.items() if key[0] == T)
    if v.graph is None:               # a rehearsal on the CPU
        return None, None
    lengths = dec.engine.cache.lengths.clone()
    v.graph.replay()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(10):
            v.graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 10)
    dec.engine.cache.lengths.copy_(lengths)
    return sorted(times)[1], v.capture_s * 1e3


def _spec_request(torch, name, eng, dec, prompt, gc, plain, L, draft_eng=None):
    """One speculative request after a warm prefill: tokens against the
    plain greedy run under the near-tie rule, launch counts (K4 4L a
    verify and a prefill; a draft engine's K1 4L, attention L and K3 once
    a drafted token; no K33), ms per emitted token."""
    from bitnet_tpu_torch.ops import registry

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(prompt)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    base = dict(dec.stats.as_dict())
    pre_d = 0 if draft_eng is None else sum(
        r.startswith("prefill") for r in draft_eng.kernel_recorder)
    calls = sum(v.calls for v in dec._verifies.values())
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    r = dec.generate(prompt, gc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {k: v for k, v in registry.launch_counts().items() if v}
    st = {k: r.spec_stats[k] - base[k] for k in ("rounds", "proposed", "accepted")}
    # one verify a round, each a replay of its captured graph
    if sum(v.calls for v in dec._verifies.values()) - calls != st["rounds"] or (
            eng.device.type == "cuda"
            and any(v.graph is None for v in dec._verifies.values())):
        raise AssertionError(f"{name}: verifies {dec._verifies} for {st}")
    want = {"ternary_matmul_w2a8": 4 * L * (1 + st["rounds"])}
    if draft_eng is not None:
        d_pre = sum(r_.startswith("prefill") for r_ in draft_eng.kernel_recorder) - pre_d
        want["ternary_matmul_w2a8"] += 4 * L * d_pre
        want.update({"ternary_matmul_w2a8_normed": 4 * L * st["proposed"],
                     "decode_attention_qkv": L * st["proposed"],
                     "scatter_kv_rows": st["proposed"]})
    if n != want and eng.device.type == "cuda":     # (a CPU rehearsal counts none)
        raise AssertionError(f"{name}: launches {n} != {want} ({st})")
    tie = _tie_rule(torch, name, eng, prompt, plain.token_ids, r.token_ids)
    ntok = max(len(r.token_ids), 1)
    return {"prompt": len(prompt), **st, "tie": tie, "launches": n,
            "wall_ms": wall * 1e3, "prefill_ms": pre_s * 1e3,
            "ms_per_token": (wall - pre_s) * 1e3 / ntok,
            "plain_ms_per_step": plain.metrics["decode_s"] * 1e3 / max(
                plain.metrics["decode_steps"], 1)}


def _spec_script(torch, V, n_greedy, n_sampled, tokens):
    """Staggered requests for a pool: greedy ones (every other repetitive)
    and seeded top-k ones, prompts of 24-150 tokens."""
    from bitnet_tpu_torch.config import GenerationConfig as G

    g = torch.Generator().manual_seed(23)
    script = []
    for i in range(n_greedy + n_sampled):
        n = 24 + (37 * i) % 127
        p = [1] + [int(t) for t in torch.randint(3, min(V, 30000), (n,), generator=g)]
        if i < n_greedy and i % 2:
            p = [1] + p[1:17] * (n // 16 + 1)
        gen = (G(max_new_tokens=tokens, greedy=True) if i < n_greedy else
               G(max_new_tokens=tokens, temperature=0.8, top_k=40, seed=100 + i))
        script.append((2 * (i // 4), p, gen, {}, "greedy" if i < n_greedy else "sampled"))
    return script


def _pl_sched_run(torch, sched, script):
    """:func:`_sched_run` for a pipelined scheduler (its own step)."""
    sched._step = sched._step_pipelined
    try:
        out = _sched_run(torch, sched, script)
    finally:
        del sched._step             # the class's again, and no cycle
    sched._pl_drain()          # windows of finished slots only: nothing to emit
    return out


def phase_speculative(torch, dev, workdir):
    """Speculative decoding and pipelined serving on the card, on the
    scheduler phase's full-width 2B fused engine (synthetic qk256 words
    from seed 0, ``condition_norms`` gains, 30 layers, int8 head, bf16
    cache, S=1024, kernel path w2a8, the mock tokenizer):
    (a) ``SpeculativeDecoder`` with n-gram drafts, k=4, greedy, on prompts
        of 32 and 128 random tokens and a repetitive one of 65: tokens
        against the plain greedy ``generate`` (K=8 segments) under the
        near-tie rule; K4 4L a verify (one graph replay a round), nothing
        else;
    (b) ``EngineDraft`` over a second engine with the same weights (k=4
        steps as one K=4 segment replay): at least one draft accepted;
    (c) ``cli run --speculative 4 --greedy`` on the generic engine over
        the full-width 2B qk256 GGUF (the gate phase's, or generated): its
        text is the in-process decoder's, whose tokens meet the near-tie
        rule against plain greedy;
    (d) the scheduler with ``speculative_k=4`` on pool (a), B=8 bf16, and
        pool (b), auto → int8, K=8: sampled requests' tokens those of the
        same script without speculation, greedy ones the near-tie rule;
    (e) ``pipeline_depth`` 2 and 3 at K=8 on pool (a): every token the
        synchronous scheduler's.
    Every verify is one replay of its graph (a call a round).
    Figures: the verify graph's ms a round and capture ms, the draft's ms
    a round, the acceptance rate, ms per emitted token beside plain
    greedy's ms a step, the pool's ms a step (run wall over its steps,
    graphs captured in a first run) at depth 1, 2 and 3."""
    import contextlib
    import io
    import re

    from bitnet_tpu_torch import cli
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine, prepare_params
    from bitnet_tpu_torch.engine.speculative import (EngineDraft, NgramDraft,
                                                     SpeculativeConfig,
                                                     SpeculativeDecoder)
    from bitnet_tpu_torch.models.synthetic import (BITNET_2B4T, build_synthetic,
                                                   condition_norms)
    from bitnet_tpu_torch.ops import registry
    from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    from bitnet_tpu_torch.tokenizer import MockTokenizer

    cfg, L = BITNET_2B4T, BITNET_2B4T.num_layers
    t0 = time.perf_counter()
    ec = EngineConfig(max_seq_len=SCHED_S, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True)
    params, _ = prepare_params(condition_norms(build_synthetic(cfg, seed=0, device=dev),
                                               cfg), ec, dev, "w2a8")
    tok = MockTokenizer(vocab_size=cfg.vocab_size)
    eng = InferenceEngine(cfg, params, ec, tokenizer=tok, device=dev)
    out = {"build_s": time.perf_counter() - t0}
    gc = GenerationConfig(max_new_tokens=SPEC_TOKENS, greedy=True)
    g = torch.Generator().manual_seed(31)
    hi = min(cfg.vocab_size, 30000)
    rep = [1] + [int(t) for t in torch.randint(3, hi, (16,), generator=g)] * 4
    prompts = [[1] + [int(t) for t in torch.randint(3, hi, (n - 1,), generator=g)]
               for n in (32, 128)] + [rep]
    spec = SpeculativeConfig(num_draft_tokens=SPEC_K)

    # (a) n-gram drafts; a short request first captures the verify graphs
    ngram = _TimedDraft(torch, NgramDraft(spec.max_ngram))
    dec = SpeculativeDecoder(eng, ngram, spec)
    eng.generate(prompts[0][:8], gc.replace(max_new_tokens=9))
    dec.generate(prompts[0][:8], gc.replace(max_new_tokens=9))
    legs = {"a_ngram": []}
    for p in prompts:
        plain = eng.generate(p, gc)
        legs["a_ngram"].append(_spec_request(torch, "speculative (a)", eng, dec, p, gc,
                                             plain, L))
    verify_ms, capture_ms = _verify_ms(torch, dec, SPEC_K + 1)
    out["a_ngram"] = {"requests": legs["a_ngram"], "verify_ms": verify_ms,
                      "verify_capture_ms": capture_ms,
                      "draft_ms_per_round": ngram.s * 1e3 / max(ngram.n, 1),
                      "stats": dec.stats.as_dict()}

    # (b) a second engine with the same weights drafts
    draft_eng = InferenceEngine(cfg, params, ec, tokenizer=tok, device=dev)
    edraft = _TimedDraft(torch, EngineDraft(draft_eng))
    dec_b = SpeculativeDecoder(eng, edraft, spec)
    dec_b.generate(prompts[0][:8], gc.replace(max_new_tokens=9))
    edraft.s, edraft.n = 0.0, 0
    rows = []
    for p in prompts[:2]:
        plain = eng.generate(p, gc)
        rows.append(_spec_request(torch, "speculative (b)", eng, dec_b, p, gc, plain, L,
                                  draft_eng))
    if sum(r["accepted"] for r in rows) < 1:
        raise AssertionError(f"speculative (b): no draft accepted {rows}")
    out["b_engine_draft"] = {"requests": rows,
                             "draft_ms_per_round": edraft.s * 1e3 / max(edraft.n, 1),
                             "stats": dec_b.stats.as_dict()}
    del draft_eng, dec_b, edraft
    torch.cuda.empty_cache()

    # (c) the CLI on the generic engine over the full-width 2B GGUF
    gguf = os.path.join(workdir, "bitnet2b_qk256.gguf")
    if not os.path.exists(gguf):
        _gen_2b("qk256", gguf)
    argv = ["run", "-m", gguf, "--prompt", "The", "--prompt-template", "raw",
            "--greedy", "-n", str(SPEC_TOKENS), "--max-seq-len", "256"]
    registry.reset_launch_counts()
    so, se = io.StringIO(), io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main(argv + ["--speculative", str(SPEC_K)])
    cli_s = time.perf_counter() - t1
    n = {k: v for k, v in registry.launch_counts().items() if v}
    m = re.search(r"\[speculative: (\{.*\})\]", se.getvalue())
    if rc != 0 or m is None or n.get("paged_attention") or (
            dev.type == "cuda" and not n.get("ternary_matmul_w2a8_normed")):
        raise AssertionError(f"cli run --speculative failed: rc {rc} {n} "
                             f"{se.getvalue()[-800:]}")
    # the same engine, prompt and config in this process
    ap = argparse.ArgumentParser()
    cli._add_gen_flags(ap)
    ns = ap.parse_args(argv[1:])
    geng = cli._build_engine(ns)
    text, tspec = cli._prepare_prompt(ns)
    ids = geng.tokenizer.encode(text, add_bos=tspec.add_bos)
    gcc = cli._gen_config(ns, extra_stops=tspec.stop_sequences)
    plain = geng.generate(ids, gcc)
    gdec = SpeculativeDecoder(geng, spec_cfg=spec)
    got = gdec.generate(ids, gcc.replace(greedy=True))
    if got.text + "\n" != so.getvalue():
        raise AssertionError(f"cli text {so.getvalue()!r} != the decoder's {got.text!r}")
    tie = _tie_rule(torch, "speculative (c)", geng, ids, plain.token_ids, got.token_ids)
    v_ms, v_cap = _verify_ms(torch, gdec, SPEC_K + 1)
    out["c_cli"] = {"rc": rc, "stats": m.group(1), "launches": n, "seconds": cli_s,
                    "tie": tie, "verify_ms": v_ms, "verify_capture_ms": v_cap,
                    "plain_ms_per_step": plain.metrics["decode_s"] * 1e3 / max(
                        plain.metrics["decode_steps"], 1)}
    del geng, gdec
    torch.cuda.empty_cache()

    # (d) the scheduler's speculative_k, (e) its pipelined windows
    b1 = {"bf16": eng}
    pools = {"a_bf16_b8": ({}, "bf16"), "b_auto_int8_b8": ({"kv_cache_dtype": "auto"},
                                                           "int8")}
    script = _spec_script(torch, cfg.vocab_size, 6, 6, SPEC_TOKENS)
    totals = {}
    for pname, (ekw, kv) in pools.items():
        e = ec.replace(**ekw)
        if kv not in b1:
            b1[kv] = InferenceEngine(cfg, params, ec.replace(kv_cache_dtype=kv),
                                     tokenizer=tok, device=dev)

        def make(**kw):
            return ContinuousBatchingScheduler(cfg, params, tok, e, num_slots=8,
                                               start_loop=False, device=dev,
                                               decode_steps_per_dispatch=SEG_K, **kw)
        base = _sched_run(torch, make(), script)
        s = make(speculative_k=SPEC_K)
        run = _sched_run(torch, s, script)
        ties = []
        for i, (_, p, gen, _, kind) in enumerate(script):
            a, b = base["reqs"][i]["tokens"], run["reqs"][i]["tokens"]
            if kind == "sampled" and a != b:
                raise AssertionError(f"speculative (d) {pname}: sampled request {i} "
                                     f"{b} != {a}")
            if kind == "greedy":
                ties.append(_tie_rule(torch, f"speculative (d) {pname} {i}", b1[kv], p,
                                      a, b))
        st = run["stats"]
        verifies = sum(v.calls for v in s._verifies.values())
        nl = run["launches"]
        if verifies < 1 or (dev.type == "cuda" and (
                any(v.graph is None for v in s._verifies.values()) or
                nl.get("ternary_matmul_w2a8") != 4 * L * (verifies + st["prefills"])
                or nl.get("paged_attention"))):
            raise AssertionError(f"speculative (d) {pname}: launches {nl}, "
                                 f"{verifies} verifies, {st}")
        _add(totals, nl)
        out[f"d_{pname}"] = {
            "spec_drafted": st["spec_drafted"], "spec_accepted": st["spec_accepted"],
            "acceptance_rate": st["spec_accepted"] / max(st["spec_drafted"], 1),
            "verifies": verifies, "decode_steps": st["decode_steps"],
            "decode_steps_without": base["stats"]["decode_steps"],
            "wall_s": run["wall_s"], "wall_s_without": base["wall_s"],
            "ties": ties, "launches": nl}
        del s, base, run
        torch.cuda.empty_cache()
    e = ec
    pl_script = _spec_script(torch, cfg.vocab_size, 8, 8, 64)
    depths = {}
    for depth in (1, 2, 3):
        s = ContinuousBatchingScheduler(cfg, params, tok, e, num_slots=8, start_loop=False,
                                        device=dev, decode_steps_per_dispatch=SEG_K,
                                        pipeline_depth=depth)
        runner = _sched_run if depth == 1 else _pl_sched_run
        runner(torch, s, pl_script)                   # captures every graph
        run = runner(torch, s, pl_script)
        toks = [r["tokens"] for r in run["reqs"]]
        if depth > 1 and toks != depths[1]["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(toks, depths[1]["tokens"])) if a != b]
            raise AssertionError(f"speculative (e): depth {depth} requests {bad} differ "
                                 "from the synchronous scheduler's")
        st = run["stats"]
        _add(totals, run["launches"])
        depths[depth] = {"tokens": toks, "decode_steps": st["decode_steps"],
                         "wall_s": run["wall_s"],
                         "ms_per_step": run["wall_s"] * 1e3 / max(st["decode_steps"], 1),
                         "tok_s": st["tokens_generated"] / run["wall_s"]}
        del s
    out["e_pipelined"] = {f"depth{d}": {k: v for k, v in r.items() if k != "tokens"}
                          for d, r in depths.items()}
    out["launch_totals"] = totals
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = True
    return out


# ---------------------------------------------------------------------------
# phase: the HTTP server (serve/server.py on serve/http.py), in process and
# as `cli serve`
# ---------------------------------------------------------------------------
SERVER_S = 1024
SERVER_TOKENS = 32
SERVER_PROMPT = "The capital of France is"
SERVER_LONG = 200          # the request that decodes while (e) embeds
SERVER_CK = 96             # the streamed request (g) checkpoints
SERVER_LOAD = 128          # (i): requests in the load window (256 until the
                           # checkpoints phase needed the room)
SERVER_RATE = 6.0          # (i): their mean arrival rate a second (Poisson),
                           # under what the pool serves saturated (PERF.md §6)


def _http(url, method="GET", body=None, timeout=300.0):
    """(status, parsed JSON or text) of one request (urllib)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def _sse(port, path, body, timeout=300.0):
    """The events of one SSE response (http.client decodes the chunks) and
    the host seconds to the first one."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    if r.status != 200:
        raise AssertionError(f"{path}: {r.status} {r.read()[:400]!r}")
    events, first = [], None
    for line in iter(r.readline, b""):
        line = line.decode().rstrip("\n")
        if not line.startswith("data: "):
            continue
        if first is None:
            first = time.perf_counter() - t0
        data = line[len("data: "):]
        events.append(data if data == "[DONE]" else json.loads(data))
        if data == "[DONE]" or (isinstance(events[-1], dict) and events[-1].get("done")):
            break
    c.close()
    return events, first


def _ws(port, body, timeout=300.0):
    """One /v1/ws exchange by hand (RFC 6455: the handshake, a masked text
    frame, the server's frames until ``done``, a close)."""
    import base64
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    key = base64.b64encode(os.urandom(16))
    s.sendall(b"GET /v1/ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
              b"Connection: Upgrade\r\nSec-WebSocket-Key: " + key +
              b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    head, buf = buf.split(b"\r\n\r\n", 1)
    if not head.startswith(b"HTTP/1.1 101"):
        raise AssertionError(f"/v1/ws handshake: {head[:200]!r}")

    def take(n):
        nonlocal buf
        while len(buf) < n:
            buf += s.recv(65536)
        out, buf = buf[:n], buf[n:]
        return out
    payload, mask = json.dumps(body).encode(), os.urandom(4)
    n = len(payload)
    hdr = bytes([0x81, 0x80 | n]) if n < 126 else bytes([0x81, 0xFE]) + n.to_bytes(2, "big")
    s.sendall(hdr + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))
    msgs = []
    while True:
        b0, b1 = take(2)
        ln = b1 & 0x7F
        if ln == 126:
            ln = int.from_bytes(take(2), "big")
        elif ln == 127:
            ln = int.from_bytes(take(8), "big")
        data = take(ln)
        if b0 & 0x0F != 1:
            raise AssertionError(f"/v1/ws: frame opcode {b0 & 0x0F}")
        msgs.append(json.loads(data))
        if msgs[-1].get("done") or "error" in msgs[-1]:
            break
    s.sendall(bytes([0x88, 0x82]) + mask + bytes(c ^ mask[i % 4] for i, c in
                                               enumerate(b"\x03\xe8")))
    s.close()
    return msgs


def _http_load(port, n, rate, seed, vocab):
    """The client of the server phase's load window, in a process of its
    own so that its threads take no interpreter time from the server's:
    ``n`` requests to /v1/inference/stream (prompts of 8-128 random token
    ids after BOS, exactly ``SERVER_TOKENS`` greedy tokens each), sent at
    seeded Poisson arrivals of ``rate`` a second from 64 threads.  One row
    a request: host seconds of its send and its end, seconds to its first
    token event, its tokens, whether its last event was ``done``."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    rng = random.Random(seed)
    at, bodies, t = [], [], 0.0
    for _ in range(n):
        t += rng.expovariate(rate)
        at.append(t)
        bodies.append({"tokens": [1] + [rng.randrange(3, vocab) for _ in range(
            rng.randint(8, 128))], "max_new_tokens": SERVER_TOKENS,
            "min_new_tokens": SERVER_TOKENS, "greedy": True})

    def one(body):
        sent = time.perf_counter()
        ev, first = _sse(port, "/v1/inference/stream", body)
        return {"sent": sent, "end": time.perf_counter(), "ttft": first,
                "tokens": sum("token" in e for e in ev), "done": bool(ev[-1].get("done"))}
    start = time.perf_counter()
    with ThreadPoolExecutor(64) as ex:
        futs = []
        for a, body in zip(at, bodies):
            time.sleep(max(0.0, start + a - time.perf_counter()))
            futs.append(ex.submit(one, body))
        return [f.result() for f in futs]


def phase_server(torch, dev, workdir):
    """The HTTP server on the card, through the entry points a user calls.

    In process: ``BitNetServer`` over a ``ContinuousBatchingScheduler`` of
    the full-width 2B qk256 GGUF (the gate phase's, or generated), 4 slots,
    a bf16 cache, S=1024, K=8 pool graphs, fused projections on w2a8 (K4
    prefills, K1 at M = 4, K8, K3), served by ``serve/http.ServerThread``;
    then: (a) /v1/inference greedy, 32 tokens, against
    ``InferenceEngine.generate`` under the near-tie rule; (b)
    /v1/inference/stream: the same tokens; (c) /v1/chat/completions,
    streamed and not: the same text; (d) 8 concurrent requests, each its
    solo answer; (e) /v1/embeddings while the pool decodes a 200-token
    request: the idle vector (max abs diff <= 1e-6); (f) /v1/models/load of
    the bitnet32 2B GGUF, then one request to each model at once (two loops
    on the device's one device loop thread), each model's tokens against
    its own ``InferenceEngine.generate`` (near-tie rule); (g) /v1/admin/checkpoint of a
    streaming request and /v1/admin/resume: the resumed text is the
    stream's rest; (h) /v1/ws: the tokens of (a); /metrics; /v1/devices
    (platform gpu); (i) the load window: 128 streamed requests at seeded
    Poisson arrivals of 6 a second from a client process (``_http_load``),
    each 32 tokens.  Launches of K1, K3, K4 and K8 over the leg.
    As a process: ``python -m bitnet_tpu_torch.cli serve`` (the JAX serve's
    generic engine) on a free port: /health 200, one /v1/inference whose
    tokens meet the near-tie rule against the generic engine's
    ``generate``, SIGTERM then exit code 0; then ``cli serve --shard 2,1``
    the same way (two ranks of one host on this card: ``_cli_serve_shard``).
    Figures (host clock, over HTTP, from (i) alone): TTFT p50 / p90 / p99,
    the latency of a request p50 / p90, decoded tok/s over the window, the
    pool's ms a step in it."""
    import socket

    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.ops import registry
    from bitnet_tpu_torch.serve import http
    from bitnet_tpu_torch.serve.model_manager import ModelManager
    from bitnet_tpu_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                                  DeviceLoop, run_on_device)
    from bitnet_tpu_torch.serve.server import BitNetServer
    from bitnet_tpu_torch.tokenizer import load_tokenizer

    t_phase = time.perf_counter()
    out = {"seconds": {}}
    qk = os.path.join(workdir, "bitnet2b_qk256.gguf")
    b32 = os.path.join(workdir, "bitnet2b_bitnet32.gguf")
    for kind, path in (("qk256", qk), ("bitnet32", b32)):
        if not os.path.exists(path):
            _gen_2b(kind, path)
    t0 = time.perf_counter()
    cfg, params, _ = load_model(qk, device=dev)
    tok = load_tokenizer(qk)
    out["seconds"]["load"] = time.perf_counter() - t0
    ec = EngineConfig(max_seq_len=SERVER_S, kv_cache_dtype="bf16", kernel_path="w2a8",
                      fuse_projections=True)
    gc = GenerationConfig(max_new_tokens=SERVER_TOKENS, greedy=True)
    ids = tok.encode(SERVER_PROMPT, add_bos=True)
    # the references, before the scheduler drives the card
    ref = InferenceEngine(cfg, params, ec, tokenizer=tok, device=dev)
    plain = ref.generate(ids, gc)
    # (f)'s second model as the manager loads it (bf16 weights, the same
    # EngineConfig), and its reference
    cfg32, params32, _ = load_model(b32, device=dev)
    tok32 = load_tokenizer(b32)
    ids32 = tok32.encode(SERVER_PROMPT, add_bos=True)
    ref32 = InferenceEngine(cfg32, params32, ec, tokenizer=tok32, device=dev)
    plain32 = ref32.generate(ids32, gc)
    gec = EngineConfig(max_seq_len=SERVER_S, kv_cache_dtype="bf16")
    gref = InferenceEngine(cfg, params, gec, tokenizer=tok, device=dev)
    gplain = gref.generate(ids, gc)

    # earlier phases stepped schedulers by hand from this thread: each one's
    # claim on the card ends with it, and this loop's thread claims it next
    import gc as pygc

    pygc.collect()
    t0 = time.perf_counter()
    sched = ContinuousBatchingScheduler(cfg, params, tok, ec, num_slots=4, device=dev,
                                        decode_steps_per_dispatch=SEG_K)
    manager = ModelManager(ec, num_slots=4, device=dev)
    manager.adopt("bitnet-2b", sched, path=qk)
    server = BitNetServer(manager=manager, allowed_model_dirs=[workdir], device=dev)
    srv = http.ServerThread(server.build_app()).start()
    url, port = srv.url, srv.port
    out["seconds"]["start"] = time.perf_counter() - t0
    registry.reset_launch_counts()
    t_leg = time.perf_counter()
    try:
        # (a) greedy, against the B=1 engine under the near-tie rule
        st, a = _http(url + "/v1/inference", "POST", {"prompt": SERVER_PROMPT,
                                                     "max_new_tokens": SERVER_TOKENS,
                                                     "greedy": True})
        if st != 200 or a["prompt_tokens"] != len(ids):
            raise AssertionError(f"server (a): {st} {a}")
        # (b) the stream
        ev, _ = _sse(port, "/v1/inference/stream", {
            "prompt": SERVER_PROMPT, "max_new_tokens": SERVER_TOKENS, "greedy": True})
        if [e["token"] for e in ev if "token" in e] != a["tokens"] or not ev[-1]["done"]:
            raise AssertionError(f"server (b): stream {ev[-3:]} != {a['tokens']}")
        # (c) chat, streamed and not
        chat = {"messages": [{"role": "user", "content": "Hello"}], "max_tokens": 16,
                "greedy": True}
        st, c = _http(url + "/v1/chat/completions", "POST", chat)
        ev, _ = _sse(port, "/v1/chat/completions", {**chat, "stream": True})
        streamed = "".join(e["choices"][0]["delta"].get("content", "")
                           for e in ev if isinstance(e, dict))
        if st != 200 or ev[-1] != "[DONE]" or streamed != c["choices"][0]["message"][
                "content"]:
            raise AssertionError(f"server (c): {st} {c} / {streamed!r}")
        out["c_chat"] = {"prompt_tokens": c["usage"]["prompt_tokens"],
                         "completion_tokens": c["usage"]["completion_tokens"]}
        # (d) 8 concurrent requests, each its solo answer
        from concurrent.futures import ThreadPoolExecutor

        g = torch.Generator().manual_seed(41)
        bodies = [{"tokens": [1] + [int(t) for t in torch.randint(
            3, cfg.vocab_size, (n,), generator=g)], "max_new_tokens": SERVER_TOKENS,
            "greedy": True} for n in (8, 30, 60, 100, 17, 45, 80, 120)]
        solo = [_http(url + "/v1/inference", "POST", b)[1]["tokens"] for b in bodies]
        with ThreadPoolExecutor(8) as ex:
            together = list(ex.map(lambda b: _http(url + "/v1/inference", "POST", b),
                                   bodies))
        if [r[1]["tokens"] for r in together] != solo:
            raise AssertionError("server (d): a concurrent answer differs from its solo")
        out["d_concurrent"] = {"requests": 8,
                               "tokens": sum(len(r[1]["tokens"]) for r in together)}
        # (i) the load window
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        steps0, dec0 = sched.stats["decode_steps"], sched.stats["decode_s"]
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
            rows = ex.submit(_http_load, port, SERVER_LOAD, SERVER_RATE, 43,
                             cfg.vocab_size).result(timeout=600)
        if any(r["tokens"] != SERVER_TOKENS or not r["done"] for r in rows):
            raise AssertionError(f"server (i): {[r for r in rows if not r['done']][:3]}")
        steps = sched.stats["decode_steps"] - steps0
        window = max(r["end"] for r in rows) - min(r["sent"] for r in rows)
        ttft = [r["ttft"] * 1e3 for r in rows]
        lat = [(r["end"] - r["sent"]) * 1e3 for r in rows]
        out["i_load"] = {
            "requests": len(rows), "rate_per_s": SERVER_RATE, "window_s": window,
            "tokens": len(rows) * SERVER_TOKENS,
            "tok_s": len(rows) * SERVER_TOKENS / window,
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p90": _pct(ttft, 0.9),
            "ttft_ms_p99": _pct(ttft, 0.99), "latency_ms_p50": _pct(lat, 0.5),
            "latency_ms_p90": _pct(lat, 0.9), "decode_steps": steps,
            "ms_per_step": (sched.stats["decode_s"] - dec0) * 1e3 / max(steps, 1)}
        # (e) embeddings while the pool decodes
        emb = {"input": "hello world"}
        st, idle = _http(url + "/v1/embeddings", "POST", emb)
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_http, url + "/v1/inference", "POST", {
                "prompt": SERVER_PROMPT, "max_new_tokens": SERVER_LONG, "greedy": True,
                "min_new_tokens": SERVER_LONG})
            while sched.stats["active_slots"] == 0 and not fut.done():
                time.sleep(0.005)
            busy_at = sched.stats["decode_steps"]
            st2, busy = _http(url + "/v1/embeddings", "POST", emb)
            during = sched.stats["decode_steps"] > busy_at and not fut.done()
            long_run = fut.result()
        va = torch.tensor(idle["data"][0]["embedding"])
        vb = torch.tensor(busy["data"][0]["embedding"])
        diff = float((va - vb).abs().max())
        if st != 200 or st2 != 200 or long_run[0] != 200 or not during or diff > 1e-6:
            raise AssertionError(f"server (e): {st} {st2} {long_run[0]} during={during} "
                                 f"max diff {diff}")
        out["e_embeddings"] = {"dim": len(va), "max_abs_diff": diff, "during_decode": during}
        # (h) the WebSocket, metrics, devices
        msgs = _ws(port, {"prompt": SERVER_PROMPT, "max_new_tokens": SERVER_TOKENS,
                          "greedy": True})
        if [m["token"] for m in msgs if "token" in m] != a["tokens"]:
            raise AssertionError(f"server (h): ws {msgs[-3:]}")
        st, metrics = _http(url + "/metrics")
        st2, devices = _http(url + "/v1/devices")
        gpu = dev.type == "cuda"          # (a CPU rehearsal has no card)
        if (st != 200 or "bitnet_tokens_generated" not in metrics or st2 != 200
                or (gpu and (devices["device"]["platform"] != "gpu"
                             or not devices["device"]["memory"]["available"]))
                or not devices["healthy"]):
            raise AssertionError(f"server (h): {st} {st2} {devices}")
        out["h_devices"] = devices["device"]
        launches = {k: v for k, v in registry.launch_counts().items() if v}
        out["seconds"]["requests"] = time.perf_counter() - t_leg
        want = ("ternary_matmul_w2a8_normed", "ternary_matmul_w2a8", "scatter_kv_rows",
                "decode_attention_batched")
        if gpu and (any(not launches.get(k) for k in want)
                    or launches.get("paged_attention")):
            raise AssertionError(f"server: launches {launches}")
        out["launches"] = launches
        # (a)'s tokens against the B=1 engine, on the device's thread
        out["a_tie"] = run_on_device(dev, lambda: _tie_rule(
            torch, "server (a)", ref, ids, plain.token_ids, a["tokens"]))
        # (g) checkpoint a streaming request, then resume it
        ck = os.path.join(workdir, "server_ck")
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        c.request("POST", "/v1/inference/stream", json.dumps({
            "prompt": SERVER_PROMPT, "max_new_tokens": SERVER_CK, "greedy": True,
            "min_new_tokens": SERVER_CK}), {"Content-Type": "application/json"})
        r = c.getresponse()
        texts = []
        for line in iter(r.readline, b""):
            if line.startswith(b"data: "):
                e = json.loads(line[6:])
                if "token" in e:
                    texts.append(e["text"])
                if len(texts) == 10:
                    st, ckr = _http(url + "/v1/admin/checkpoint", "POST",
                                    {"directory": ck})
                if e.get("done"):
                    break
        c.close()
        meta = json.load(open(next(p for p in ckr["written"]
                                   if os.path.exists(p + ".req.json")) + ".req.json"))
        st2, res = _http(url + "/v1/admin/resume", "POST", {"directory": ck})
        n_done = meta["generated"]
        if (st != 200 or ckr["count"] != 1 or st2 != 200 or len(res["resumed"]) != 1
                or res["resumed"][0]["text"] != "".join(texts[n_done:])):
            raise AssertionError(f"server (g): {st} {ckr} {st2} {res} {n_done} "
                                 f"{''.join(texts[n_done:])!r}")
        out["g_checkpoint"] = {"generated_at_checkpoint": n_done,
                               "resumed_tokens": res["resumed"][0]["num_tokens"]}
        # (f) a second model while the first serves, then one request each
        t0 = time.perf_counter()
        st, info = _http(url + "/v1/models/load", "POST", {"name": "bitnet32",
                                                          "path": b32}, timeout=600)
        load_s = time.perf_counter() - t0
        drv = DeviceLoop.get(dev)
        if st != 200 or drv is None or len(drv._scheds) != 2:
            raise AssertionError(f"server (f): load {st} {info}")
        body = {"prompt": SERVER_PROMPT, "max_new_tokens": SERVER_TOKENS, "greedy": True}
        with ThreadPoolExecutor(2) as ex:
            both = list(ex.map(lambda m: _http(url + "/v1/inference", "POST",
                                               {**body, "model": m}),
                               ("bitnet-2b", "bitnet32")))
        again = _http(url + "/v1/inference", "POST", {**body, "model": "bitnet32"})
        if (any(r[0] != 200 for r in both) or both[0][1]["tokens"] != a["tokens"]
                or both[1][1]["prompt_tokens"] != len(ids32)
                or again[1]["tokens"] != both[1][1]["tokens"]):
            raise AssertionError(f"server (f): {both} {again}")
        out["f_second_model"] = {"load_s": load_s, "kind": "bitnet32",
                                 "tie": run_on_device(dev, lambda: _tie_rule(
                                     torch, "server (f) bitnet32", ref32, ids32,
                                     plain32.token_ids, both[1][1]["tokens"]))}
        st, _ = _http(url + "/v1/models/bitnet32", "DELETE")
        if st != 200:
            raise AssertionError(f"server (f): unload {st}")
    finally:
        srv.stop()
        manager.shutdown()
    del ref, ref32, params32, sched, manager, server
    torch.cuda.empty_cache()

    # the CLI's serve as a process (the generic engine), SIGTERM at the end
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        cport = so.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bitnet_tpu_torch.cli", "serve", "-m", qk, "--port",
         str(cport), "--max-seq-len", str(SERVER_S), "--kv-cache-dtype", "bf16",
         "--num-slots", "4", "--device", dev.type], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        curl = f"http://127.0.0.1:{cport}"
        while True:
            try:
                st, h = _http(curl + "/health", timeout=5)
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 400:
                    raise AssertionError(f"cli serve did not answer: {proc.poll()}")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        st2, r = _http(curl + "/v1/inference", "POST", {
            "prompt": SERVER_PROMPT, "max_new_tokens": SERVER_TOKENS, "greedy": True})
    finally:
        proc.terminate()
        try:
            log, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    if st != 200 or h != {"status": "ok"} or st2 != 200 or proc.returncode != 0:
        raise AssertionError(f"cli serve: {st} {h} {st2} rc {proc.returncode} "
                             f"{log[-1500:]}")
    out["cli_serve"] = {"up_s": up_s, "seconds": time.perf_counter() - t0,
                        "tie": _tie_rule(torch, "cli serve", gref, ids,
                                         gplain.token_ids, r["tokens"]),
                        "equal_to_in_process": r["tokens"] == a["tokens"]}
    out["cli_serve_shard"] = _cli_serve_shard(torch, dev, qk, gref, ids, gplain)
    del gref
    torch.cuda.empty_cache()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["ok"] = True
    return out


def _cli_serve_shard(torch, dev, qk, gref, ids, gplain):
    """``cli serve --shard 2,1`` as a process on this one card: it starts
    its follower itself (dp = 2: two ranks, two of the four slots each,
    gloo over a FileStore, ``BITNET_DIST_BACKEND=gloo`` since NCCL refuses
    two ranks on one GPU); /health, one greedy /v1/inference held to the
    generic engine by the near-tie rule, SIGTERM, exit 0."""
    import socket

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bitnet_tpu_torch.cli", "serve", "-m", qk, "--port",
         str(port), "--max-seq-len", str(SERVER_S), "--kv-cache-dtype", "bf16",
         "--num-slots", "4", "--shard", "2,1", "--device", dev.type], cwd=REPO,
        env={**os.environ, "BITNET_DIST_BACKEND": "gloo"}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        while True:
            try:
                st, h = _http(url + "/health", timeout=5)
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 400:
                    raise AssertionError(f"cli serve --shard did not answer: {proc.poll()}")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        st2, r = _http(url + "/v1/inference", "POST", {
            "prompt": SERVER_PROMPT, "max_new_tokens": SERVER_TOKENS, "greedy": True})
    finally:
        proc.terminate()
        try:
            log, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    if st != 200 or h != {"status": "ok"} or st2 != 200 or proc.returncode != 0:
        raise AssertionError(f"cli serve --shard 2,1: {st} {h} {st2} rc "
                             f"{proc.returncode} {log[-1500:]}")
    return {"up_s": up_s, "seconds": time.perf_counter() - t0,
            "tie": _tie_rule(torch, "cli serve --shard 2,1", gref, ids, gplain.token_ids,
                             r["tokens"])}


# ---------------------------------------------------------------------------
# phase: checkpoints (dense and GGML-classic linears, SafeTensors files and
# HF directories, the windowed ring cache): every checkpoint the JAX
# package loads, at the 2B's full width
# ---------------------------------------------------------------------------
CKPT_S = 1024
CKPT_REQUESTS = ((32, 32), (128, 128))   # (prompt tokens, new tokens), greedy
CKPT_WINDOW = 256
CKPT_RING = (64, 320)                    # prompt tokens, new tokens
CKPT_FLAT_MIB = 1.0                      # allowed drift of allocated memory
CKPT_SCORE_CHARS = 300                   # (e): score's text (~one <unk> id a character)
CKPT_LLAMA = (24, 32)                    # (f): prompt ids, greedy completion tokens
CKPT_PACK_LAYERS = 2                     # (d): the layers whose QK256 tensors are compared


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ckpt_ids(torch, n, V, seed):
    gen = torch.Generator().manual_seed(seed)
    return [int(t) for t in torch.randint(3, V, (n,), generator=gen)]


def _decode_path_logits(eng, prompt, tokens):
    """The B=1 decode path's logits after ``prompt`` + ``tokens`` (a
    prefill, then one decode step a token)."""
    import torch

    with torch.inference_mode():
        lg = eng.prefill(prompt)[0]
        for i, t in enumerate(tokens):
            lg = eng.decode_step(t, len(prompt) + i)[0]
    return lg.float().cpu()


def _pair_tie(torch, name, ref, eng, prompt, want, got):
    """``got`` (``eng``'s greedy tokens) held to ``want`` (``ref``'s) under
    the near-tie rule: equal up to the first position j where they part,
    and there ``ref``'s logits prefer ``want[j]`` over ``got[j]`` by no more
    than the largest difference between the two engines' logits of the
    same context (each its B=1 decode path), at cosine >= 0.99."""
    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        if len(want) != len(got):
            raise AssertionError(f"{name}: {len(got)} tokens != {len(want)}")
        return {"equal": True, "tokens": len(got)}
    a = _decode_path_logits(ref, prompt, want[:j])
    b = _decode_path_logits(eng, prompt, want[:j])
    diff = float((a - b).abs().max())
    gap = float(a[want[j]] - a[got[j]])
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    info = {"equal": False, "tokens": len(got), "parts_at": j, "gap": gap,
            "max_diff": diff, "cosine": cos}
    if gap > diff or cos < 0.99:
        raise AssertionError(f"{name}: token {j} {got[j]} != {want[j]} is not a "
                             f"near tie: {info}")
    return info


def _ckpt_requests(torch, dev, eng, prompts, gc_fn):
    """Each request greedy on ``eng``, its launches zeroed before and read
    after: tokens, prefill ms, decode ms a step, launches a step."""
    from bitnet_tpu_torch.ops import registry

    rows = []
    for prompt, n in prompts:
        registry.reset_launch_counts()
        r = eng.generate(prompt, gc_fn(n))
        _sync(torch, dev)
        m = eng.last_metrics
        counts = {k: v for k, v in registry.launch_counts().items() if v}
        rows.append({"prompt": len(prompt), "tokens": r.token_ids,
                     "prefill_ms": m.prefill_s * 1e3,
                     "decode_ms_per_step": m.decode_s * 1e3 / max(m.decode_steps, 1),
                     "decode_steps": m.decode_steps, "launches": counts})
    return rows


def _two_layers(params, cfg):
    """The first two layers of a loaded model (views of its stacks)."""
    import dataclasses

    from bitnet_tpu_torch.ops.linear import TernaryLinear

    def cut(x):
        if x is None:
            return None
        if isinstance(x, TernaryLinear):
            return dataclasses.replace(x, **{f: (None if getattr(x, f) is None
                                                 else getattr(x, f)[:2])
                                             for f in ("weight", "packed", "scales",
                                                       "col_scales")})
        return x[:2]
    b = params.blocks
    blocks = dataclasses.replace(b, **{f.name: cut(getattr(b, f.name))
                                       for f in dataclasses.fields(b)})
    return dataclasses.replace(params, blocks=blocks), cfg.replace(num_layers=2)


def _dense_step_bytes(eng, kv_rows):
    """Bytes a dense B=1 decode step must move: every dense linear's
    weight, the tied head's table (or the untied head's weight) and
    ``kv_rows`` K / V rows of each layer's cache (each read once)."""
    import dataclasses

    b, p, cfg = eng.params.blocks, eng.params, eng.cfg
    lin = [getattr(b, f.name) for f in dataclasses.fields(b)
           if getattr(getattr(b, f.name), "kind", None) == "dense"]
    w = sum(t.weight.numel() * t.weight.element_size() for t in lin)
    head = (p.lm_head.weight if p.lm_head is not None else p.embed)
    kv = 2 * cfg.num_layers * kv_rows * cfg.num_kv_heads * cfg.head_dim * \
        eng.cache.k.element_size()
    return {"linears": w, "head": head.numel() * head.element_size(), "kv": int(kv)}


def _ring_vs_window_mask(torch, eng, seq, n_prompt):
    """Teacher-forced over ``seq``: the ring engine's logits at every
    position from the prompt's last on (its prefill of ``seq[:n_prompt]``,
    then one decode step a token), against ``models.bitnet.forward(...,
    window=W)`` over a dense ``CKPT_S``-row cache of the ring's dtype (its
    calls over ``seq``: the prompt, then chunks of W, each small enough
    for the plain attention that the ring's steps take; the same kernel
    path and head): per-position logits cosine, split at W, and the
    argmaxes, which agree unless the reference's top-2 margin is within
    the largest logit difference."""
    from bitnet_tpu_torch.models.bitnet import forward
    from bitnet_tpu_torch.models.bitnet import logits as model_logits

    W, cfg, params, dev = eng.engine_cfg.sliding_window, eng.cfg, eng.params, eng.device
    n = len(seq)
    with torch.inference_mode():
        ring = [eng.prefill(seq[:n_prompt])[0]]
        for p in range(n_prompt, n - 1):
            ring.append(eng.decode_step(seq[p], p)[0])
        ring = torch.stack(ring).float()
        kc = torch.zeros((cfg.num_layers, 1, CKPT_S, cfg.num_kv_heads * cfg.head_dim),
                         dtype=eng.cache.k.dtype, device=dev)
        vc = torch.zeros_like(kc)
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)   # noqa: E731
        ref, done = [], 0
        for end in [n_prompt, *range(n_prompt + W, n - 1, W), n - 1]:
            h, _k, _v = forward(cfg, params, i32([seq[done:end]]),
                                i32([list(range(done, end))]), kc, vc, i32([done]),
                                end - done, eng.kernel_path, window=W)
            ref.append(model_logits(cfg, params, h, eng.kernel_path)[0].float())
            done = end
        ref = torch.cat(ref)[n_prompt - 1:]
        del kc, vc, h
    cos = torch.nn.functional.cosine_similarity(ring, ref, dim=1).cpu()
    top2 = torch.topk(ref, 2, dim=1).values
    same = ring.argmax(1) == ref.argmax(1)
    tie = (top2[:, 0] - top2[:, 1]) <= (ring - ref).abs().amax(1)
    pos = torch.arange(n_prompt - 1, n - 1)
    inside, past = cos[pos < W], cos[pos >= W]
    return {"positions": int(pos.numel()), "first": n_prompt - 1, "last": n - 2,
            "past_window": int(past.numel()),
            "cosine_first": float(cos[0]),
            "min_cosine_in_window": float(inside.min()),
            "min_cosine_past_window": float(past.min()),
            "mean_cosine_in_window": float(inside.mean()),
            "mean_cosine_past_window": float(past.mean()),
            "argmax_agree": int(same.sum()), "ties_only": bool((same | tie).all())}


def _hf_tensors(eng):
    """A loaded dense model's weights in HF names: linears [out, in] and the
    embedding in f16, norms in f32 (numpy, on the host)."""
    import numpy as np

    import torch

    b, p, cfg = eng.params.blocks, eng.params, eng.cfg
    # transposed and cast on the card, so the host copies contiguous rows
    f16 = lambda t: t.contiguous().to(torch.float16).cpu().numpy()   # noqa: E731
    f32 = lambda t: t.to(torch.float32).cpu().numpy()        # noqa: E731
    out = {"model.embed_tokens.weight": f16(p.embed),
           "model.norm.weight": f32(p.final_norm)}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    norms = {"attn_norm": "input_layernorm", "ffn_norm": "post_attention_layernorm",
             "attn_sub_norm": "self_attn.inner_attn_ln", "ffn_sub_norm": "mlp.ffn_layernorm"}
    for i in range(cfg.num_layers):
        for role, hf in names.items():
            out[f"model.layers.{i}.{hf}.weight"] = f16(getattr(b, role).weight[i].t())
        for role, hf in norms.items():
            if getattr(b, role) is not None:
                out[f"model.layers.{i}.{hf}.weight"] = f32(getattr(b, role)[i])
    assert all(np.isfinite(a).all() for a in out.values())
    return out


def _write_hf_dir(eng, d):
    """Two f16 shards (the globals and the first half of the layers; the
    rest), ``model.safetensors.index.json`` and ``config.json``."""
    from bitnet_tpu_torch.tools.safetensors_io import save_file

    cfg = eng.cfg
    t = _hf_tensors(eng)
    half = cfg.num_layers // 2
    shard_of = {}
    for k in t:
        late = k.startswith("model.layers.") and int(k.split(".")[2]) >= half
        shard_of[k] = f"model-0000{2 if late else 1}-of-00002.safetensors"
    os.makedirs(d)
    for fn in sorted(set(shard_of.values())):
        save_file({k: v for k, v in t.items() if shard_of[k] == fn}, os.path.join(d, fn))
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": int(sum(a.nbytes for a in t.values()))},
                   "weight_map": shard_of}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["BitNetForCausalLM"], "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                   "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_base,
                   "max_position_embeddings": cfg.max_seq_len}, f)
    return int(sum(a.nbytes for a in t.values()))


def _pack_leg(torch, dev, qk):
    """(d) The QK256 tensors of the 2B's first ``CKPT_PACK_LAYERS`` layers
    (not all 210: the numpy side of every tensor took 11-17 s of the
    phase) packed on the card
    (``qk256_linear_from_payload_torch``) against the numpy route on the
    host, bit for bit: seconds of each side and the largest rise of
    allocated device memory over one tensor's pack (its temporaries and
    words)."""
    from bitnet_tpu_torch.gguf.constants import GGMLType
    from bitnet_tpu_torch.gguf.reader import GGUFReader
    from bitnet_tpu_torch.ops.linear import (qk256_linear_from_payload,
                                             qk256_linear_from_payload_torch)

    n, card_s, plain_s, peak = 0, 0.0, 0.0, 0
    with GGUFReader(qk) as r:
        L = int(r.arch_key("block_count"))
        for info in r:
            if info.ggml_type != GGMLType.I2_S or not any(
                    info.name.startswith(f"blk.{l}.") for l in range(CKPT_PACK_LAYERS)):
                continue
            rows, cols = info.logical_shape
            payload = r.tensor_bytes(info.name)
            _sync(torch, dev)
            if dev.type == "cuda":
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            got = qk256_linear_from_payload_torch(payload, rows, cols, device=dev)
            _sync(torch, dev)
            card_s += time.perf_counter() - t0
            if dev.type == "cuda":
                peak = max(peak, torch.cuda.max_memory_allocated(dev) - base)
            t0 = time.perf_counter()
            want = qk256_linear_from_payload(payload, rows, cols)
            plain_s += time.perf_counter() - t0
            if not torch.equal(got.packed.cpu(), want.packed) or (got.k, got.n) != (
                    want.k, want.n):
                raise AssertionError(f"the card's QK256 pack of {info.name} differs "
                                     "from the numpy route's")
            n += 1
            del got, want
    if n != 7 * min(L, CKPT_PACK_LAYERS):
        raise AssertionError(f"{n} QK256 tensors in the 2B GGUF's first layers, not 7 a "
                             "layer")
    return {"tensors": n, "bit_for_bit": True, "card_s": card_s, "plain_s": plain_s,
            "peak_pack_mib": peak / 2**20}


def _cli_leg(torch, dev, qk, workdir):
    """(e) The CLI at full width, in this process, on the card: ``benchmark
    -n 64`` (decode tok/s, TTFT), ``score`` over CKPT_SCORE_CHARS ids
    (perplexity, seconds), and ``tokenize``, ``inspect``, ``fingerprint``,
    ``ln-check`` and ``compat-check`` (rc and keys: each exits 1 where it
    finds a fault); the engine commands' launches."""
    from bitnet_tpu_torch.ops import registry

    text = os.path.join(workdir, "score.txt")
    with open(text, "w") as f:
        f.write("abcdefghij" * (CKPT_SCORE_CHARS // 10))
    want_keys = {"benchmark": {"prompt_tokens", "generated_tokens", "wall_s",
                               "decode_tok_s", "ttft_s", "kernel_path"},
                 "score": {"tokens", "nll", "perplexity"},
                 "tokenize": {"text", "ids", "pieces", "count"},
                 "inspect": {"path", "version", "n_tensors", "n_kv", "architecture",
                             "alignment", "quantization_histogram", "metadata"},
                 "fingerprint": {"path", "format", "size_bytes", "mtime", "created_unix",
                                 "fingerprint", "algorithm", "architecture",
                                 "num_tensors"},
                 "ln-check": {"checked", "warnings", "rejected", "rms"},
                 "compat-check": {"path", "errors", "warnings", "fixes"}}
    on = ["--device", dev.type]
    argv = {"benchmark": ["-n", "64", "-p", "Hello", "--max-seq-len", str(CKPT_S), *on],
            "score": ["--file", text, "--max-seq-len", "512", *on],
            "tokenize": ["-p", "Hello world"], "inspect": [], "fingerprint": [],
            "ln-check": [], "compat-check": []}
    out, launches = {}, {}
    for name, extra in argv.items():
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        rc, so, se = _cli_call([name, "-m", qk, *extra])
        _sync(torch, dev)
        secs = time.perf_counter() - t0
        n = {k: v for k, v in registry.launch_counts().items() if v}
        res = json.loads(so)
        row = {"rc": rc, "seconds": secs, "keys_ok": set(res) == want_keys[name]}
        if name in ("benchmark", "score"):
            row.update({k: res[k] for k in ("decode_tok_s", "ttft_s", "wall_s",
                                            "generated_tokens", "kernel_path", "tokens",
                                            "perplexity", "nll") if k in res})
            row["launches"] = n
            _add(launches, n)
        elif name == "ln-check":
            row.update(checked=res["checked"], rejected=len(res["rejected"]))
        elif name == "compat-check":
            row["errors"] = res["errors"]
        out[name] = row
        # ln-check and compat-check exit 1 on what they find (the synthetic
        # 2B's conditioned norm gains lie under the BitNet envelope)
        fail = {"ln-check": bool(res.get("rejected")),
                "compat-check": bool(res.get("errors"))}.get(name, False)
        ok = rc == int(fail) and row["keys_ok"]
        if name == "benchmark":
            ok = ok and res["generated_tokens"] >= 1 and (dev.type != "cuda" or (
                res["kernel_path"] == "w2a8" and n.get("ternary_matmul_w2a8_normed", 0) > 0
                and n.get("decode_attention", 0) > 0))
        if name == "score":
            ok = ok and res["tokens"] >= CKPT_SCORE_CHARS and math.isfinite(
                res["perplexity"])
        if not ok:
            raise AssertionError(f"cli {name} at the 2B: {row} {se[-800:]}")
    return out, launches


def _llama_leg(torch, dev, qk):
    """(f) ``Llama(qk, n_ctx=512)`` on the card: a greedy ``create_completion``
    of CKPT_LLAMA's tokens from a prompt of ids, its text that of
    ``InferenceEngine.generate`` greedy on the same GGUF and device (the
    synthetic vocabulary's pieces are one a token, so equal text is equal
    tokens); a streamed ``create_chat_completion`` whose chunks join to the
    unstreamed text; ``create_embedding`` (n_embd finite values: 2560); ``eval`` +
    ``sample(temperature=0)``, the completion's first token or a near tie;
    ``save_state`` / ``load_state`` round-tripping ``n_past`` and the next
    greedy token.  Launches of the whole leg."""
    from bitnet_tpu_torch.compat.llama import Llama
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.ops import registry

    n_prompt, n_new = CKPT_LLAMA
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    llm = Llama(qk, n_ctx=512, seed=0, verbose=False, device=dev)
    out = {"load_s": time.perf_counter() - t0}
    ids = _ckpt_ids(torch, n_prompt, llm.n_vocab, 13)
    t0 = time.perf_counter()
    res = llm.create_completion(ids, max_tokens=n_new, temperature=0.0, repeat_penalty=1.0)
    _sync(torch, dev)
    out["completion_s"] = time.perf_counter() - t0
    n = {k: v for k, v in registry.launch_counts().items() if v}
    ref = InferenceEngine.from_gguf(qk, EngineConfig(max_seq_len=512), device=dev)
    want = ref.generate(ids, GenerationConfig(max_new_tokens=n_new, greedy=True))
    got_text = res["choices"][0]["text"]
    out["completion"] = {"tokens": res["usage"]["completion_tokens"],
                         "equal_to_generate": got_text == want.text,
                         "finish_reason": res["choices"][0]["finish_reason"]}
    if got_text != want.text or res["usage"]["completion_tokens"] != len(want.token_ids):
        raise AssertionError(f"Llama's completion {got_text[:200]!r} is not generate's "
                             f"{want.text[:200]!r}")
    msgs = [{"role": "user", "content": "Hello"}]
    plain = llm.create_chat_completion(msgs, max_tokens=16, temperature=0.0)
    chunks = list(llm.create_chat_completion(msgs, max_tokens=16, temperature=0.0,
                                             stream=True))
    joined = "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks)
    out["chat_stream"] = {"chunks": len(chunks),
                          "joined_equal": joined == plain["choices"][0]["message"]["content"],
                          "finish_reason": chunks[-1]["choices"][0]["finish_reason"]}
    if not out["chat_stream"]["joined_equal"] or chunks[-1]["choices"][0][
            "finish_reason"] != plain["choices"][0]["finish_reason"]:
        raise AssertionError(f"the streamed chat parts from the unstreamed: {out}")
    emb = llm.create_embedding("Hello world")["data"][0]["embedding"]
    out["embedding"] = {"width": len(emb), "finite": all(map(math.isfinite, emb))}
    if len(emb) != llm.n_embd or not out["embedding"]["finite"]:
        raise AssertionError(f"the embedding: {out['embedding']}")
    llm.reset()
    llm.eval(ids)
    first = llm.sample(temperature=0.0, repeat_penalty=1.0)
    out["eval_sample"] = {"token": first, "completion_first": want.token_ids[0],
                          "equal": first == want.token_ids[0]}
    if first != want.token_ids[0]:
        a = torch.from_numpy(llm._last_logits.copy())
        with torch.inference_mode():
            b = ref.prefill(ids)[0].float().cpu()
        diff, gap = float((a - b).abs().max()), float(a[first] - a[want.token_ids[0]])
        out["eval_sample"].update(max_diff=diff, gap=gap)
        if gap > diff:
            raise AssertionError(f"eval + sample is not the completion's first token "
                                 f"nor a near tie: {out['eval_sample']}")
    st = llm.save_state()
    nxt = llm.sample(temperature=0.0, repeat_penalty=1.0)
    llm.eval([nxt])
    after = llm.sample(temperature=0.0, repeat_penalty=1.0)
    llm.eval([5, 6, 7])
    llm.load_state(st)
    n_past = llm._n_past
    llm.eval([nxt])
    again = llm.sample(temperature=0.0, repeat_penalty=1.0)
    out["state"] = {"kv_len": st.kv_len, "n_past": n_past, "next": after,
                    "next_after_load": again}
    if n_past != n_prompt or st.kv_len != n_prompt or again != after:
        raise AssertionError(f"save_state / load_state: {out['state']}")
    _sync(torch, dev)
    launches = {k: v for k, v in registry.launch_counts().items() if v}
    out["launches"] = launches
    out["completion_launches"] = n
    if dev.type == "cuda" and not (n.get("ternary_matmul_w2a8_normed")
                                   and n.get("decode_attention")):
        raise AssertionError(f"Llama's completion launched {n}")
    del llm, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, launches


def phase_checkpoints(torch, dev, workdir):
    """Every checkpoint the JAX package loads, at the 2B's full width (the
    gate's 2B qk256 GGUF of ``tools/gen_2b_gguf.py``, generated here unless
    an earlier phase left it):

    (a) dense: the GGUF loaded with ``mode="dense"`` (30 layers of bf16
        dense linears, the torch unpack on the card), B=1 greedy requests
        of 32 and 128 tokens on the CLI's engine (the per-layer loop, K5's
        decode attention, K=8 graphs): prefill ms, decode ms a step beside
        the byte bound of the request's steps (the KV rows they read), load s, launches a step (K5 L times a step
        and nothing else); the tokens held to the same GGUF on
        ``kernel_path="pallas"`` (K6: bf16 x, the same function up to
        rounding) under the near-tie rule; its first two layers card vs
        CPU, logits cosine >= 0.99 over a prefill and two decode steps;
    (b) an HF directory: (a)'s weights written with the port's SafeTensors
        writer as two f16 shards, ``model.safetensors.index.json`` and
        ``config.json``; the conversion timed (``_resolve_checkpoint``),
        ``InferenceEngine.from_gguf(dir)`` reusing its cache (mtime
        unchanged), (a)'s requests under the near-tie rule against (a)'s
        tokens; ``python -m bitnet_tpu_torch.cli run -m <dir> -n 16
        --greedy`` in a process of its own (the mock tokenizer, by the JAX
        package's rule), the cache still unchanged; the files deleted;
    (c) the ring: the packed GGUF with ``sliding_window=256`` (bf16 KV), a
        64-token prompt and 320 greedy tokens, eager (K = 1, K1 at the
        generic site): while the window holds every position its tokens
        are the plain engine's (near-tie rule); allocated memory flat
        after the first window; decode ms a step and launches a step; then
        teacher-forced over the prompt and those 512 tokens, the ring's
        logits at each of their positions held to ``forward(window=W)``
        over a dense 1024-row cache, cosine >= 0.99 on both sides of W;
    (d) the QK256 pack on the card (``_pack_leg``), (e) the CLI at the 2B
        (``_cli_leg``), (f) the llama-cpp-python drop-in (``_llama_leg``)."""
    import shutil

    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.loader import _resolve_checkpoint
    from bitnet_tpu_torch.ops import registry

    qk = os.path.join(workdir, "bitnet2b_qk256.gguf")
    if not os.path.exists(qk):
        _gen_2b("qk256", qk)
    greedy = lambda n: GenerationConfig(max_new_tokens=n, greedy=True)   # noqa: E731
    out = {"a_dense": {}, "b_hf_dir": {}, "c_ring": {}}
    launches: dict = {}

    # (a) mode="dense", and the packed GGUF on K6 beside it
    a = out["a_dense"]
    t0 = time.perf_counter()
    dense = InferenceEngine.from_gguf(qk, EngineConfig(max_seq_len=CKPT_S), device=dev,
                                      mode="dense")
    _sync(torch, dev)
    a["load_s"] = time.perf_counter() - t0
    rep, cfg = dense.load_report, dense.cfg
    if set(rep.kinds.values()) != {"dense"} or len(rep.dequantized) != 7 * cfg.num_layers:
        raise AssertionError(f"mode='dense' kept packed linears: {rep.kinds}")
    if dense.params.blocks.wq.weight.dtype != torch.bfloat16 or dense.stacked_decode():
        raise AssertionError("the dense model is not bf16 on the per-layer loop")
    V = cfg.vocab_size
    prompts = [(_ckpt_ids(torch, n, V, 40 + i), m) for i, (n, m) in enumerate(CKPT_REQUESTS)]
    rows = _ckpt_requests(torch, dev, dense, prompts, greedy)
    for r in rows:
        k5 = r["launches"].get("decode_attention", 0)
        if dev.type == "cuda" and (set(r["launches"]) != {"decode_attention"}
                                   or k5 != cfg.num_layers * r["decode_steps"]):
            raise AssertionError(f"dense decode launched {r['launches']} over "
                                 f"{r['decode_steps']} steps (want K5 L times a step)")
        r["launches_per_step"] = {k: v / r["decode_steps"] for k, v in r["launches"].items()}
        _add(launches, r["launches"])
    for r in rows:
        # K5 reads the valid rows: p + 1 at the step of position p, so the
        # request's steps read P + (steps + 1) / 2 rows on average
        r["step_bytes"] = nbytes = _dense_step_bytes(
            dense, r["prompt"] + (r["decode_steps"] + 1) / 2)
        r["bound_ms"] = sum(nbytes.values()) / HBM_BPS * 1e3
    t0 = time.perf_counter()
    packed = InferenceEngine.from_gguf(qk, EngineConfig(max_seq_len=CKPT_S,
                                                        kernel_path="pallas"), device=dev)
    _sync(torch, dev)
    a["packed_load_s"] = time.perf_counter() - t0
    ref_rows = _ckpt_requests(torch, dev, packed, prompts, greedy)
    for r, rr, (prompt, _n) in zip(rows, ref_rows, prompts):
        r["vs_k6"] = _pair_tie(torch, f"dense vs K6 ({len(prompt)})", packed, dense,
                               prompt, rr["tokens"], r["tokens"])
        r["k6_decode_ms_per_step"] = rr["decode_ms_per_step"]
        r["k6_launches_per_step"] = {k: v / rr["decode_steps"]
                                     for k, v in rr["launches"].items()}
        _add(launches, rr["launches"])
    a["requests"] = rows
    p2, cfg2 = _two_layers(dense.params, cfg)
    ec2 = EngineConfig(max_seq_len=256)
    eg = InferenceEngine(cfg2, p2, ec2, device=dev)
    ecpu = InferenceEngine(cfg2, p2, ec2, device="cpu")
    a["two_layers_card_vs_cpu"] = tf = _teacher_forced(torch, eg, ecpu, prompts[0][0])
    del eg, ecpu, p2
    if tf["min_cosine"] < 0.99 or not tf["ties_only"]:
        raise AssertionError(f"2-layer dense card vs CPU: {tf}")

    # (b) the same weights as an HF checkpoint directory
    b = out["b_hf_dir"]
    d = os.path.join(workdir, "bitnet2b_hf")
    cache = d + ".converted.gguf"
    try:
        t0 = time.perf_counter()
        b["shard_bytes"] = _write_hf_dir(dense, d)
        b["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if _resolve_checkpoint(d) != cache:
            raise AssertionError("the directory did not resolve to its cache")
        b["convert_s"] = time.perf_counter() - t0
        m0 = os.path.getmtime(cache)
        b["gguf_bytes"] = os.path.getsize(cache)
        t0 = time.perf_counter()
        hf = InferenceEngine.from_gguf(d, EngineConfig(max_seq_len=CKPT_S), device=dev)
        _sync(torch, dev)
        b["load_s"] = time.perf_counter() - t0
        b["second_load_cached"] = os.path.getmtime(cache) == m0
        if not b["second_load_cached"] or set(hf.load_report.kinds.values()) != {"dense"}:
            raise AssertionError(f"the HF directory's second load: {b} "
                                 f"{hf.load_report.kinds}")
        hrows = _ckpt_requests(torch, dev, hf, prompts, greedy)
        b["requests"] = [{"prompt": len(prompt),
                          "vs_dense": _pair_tie(torch, f"HF dir vs dense ({len(prompt)})",
                                                dense, hf, prompt, r["tokens"], hr["tokens"]),
                          "decode_ms_per_step": hr["decode_ms_per_step"]}
                         for r, hr, (prompt, _n) in zip(rows, hrows, prompts)]
        del hf
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "bitnet_tpu_torch.cli", "run", "-m", d,
                            "-n", "16", "--greedy", "--max-seq-len", str(CKPT_S),
                            "--device", dev.type],
                           cwd=REPO, capture_output=True, text=True, timeout=600)
        b["cli"] = {"rc": r.returncode, "seconds": time.perf_counter() - t0,
                    "stdout": r.stdout[-300:], "stderr": r.stderr[-300:],
                    "cache_unchanged": os.path.getmtime(cache) == m0}
        if r.returncode != 0 or "[16 tokens" not in r.stderr or not b["cli"]["cache_unchanged"]:
            raise AssertionError(f"cli run -m <dir> failed: {b['cli']} {r.stderr[-1500:]}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
        if os.path.exists(cache):
            os.remove(cache)
    del dense

    # (c) the ring on the packed weights (K1 at the generic site)
    c = out["c_ring"]
    n_prompt, n_new = CKPT_RING
    prompt = _ckpt_ids(torch, n_prompt, V, 7)
    plain = InferenceEngine(packed.cfg, packed.params, EngineConfig(max_seq_len=CKPT_S),
                            device=dev)
    win = InferenceEngine(packed.cfg, packed.params, EngineConfig(
        max_seq_len=CKPT_S, sliding_window=CKPT_WINDOW, kv_cache_dtype="bf16"), device=dev)
    del packed
    if not win.windowed or win.cache.k.shape[2] != CKPT_WINDOW or win.kernel_path != (
            "w2a8" if dev.type == "cuda" else "xla"):
        raise AssertionError("the ring engine is not a w2a8 ring of the window")
    in_window = CKPT_WINDOW - n_prompt        # tokens while every position is resident
    want = plain.generate(prompt, greedy(in_window)).token_ids
    got, mem = [], []
    for ev in win.generate_stream(prompt, greedy(n_new)):
        if ev.index == 0:                     # after the prefill: count the decode only
            _sync(torch, dev)
            registry.reset_launch_counts()
        got.append(ev.token_id)
        if n_prompt + ev.index >= CKPT_WINDOW and dev.type == "cuda":
            mem.append(torch.cuda.memory_allocated(dev))
    _sync(torch, dev)
    m = win.last_metrics
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    _add(launches, counts)
    c.update({"tokens": len(got), "decode_steps": m.decode_steps,
              "prefill_ms": m.prefill_s * 1e3,
              "decode_ms_per_step": m.decode_s * 1e3 / max(m.decode_steps, 1),
              "launches_per_step": {k: v / max(m.decode_steps, 1)
                                    for k, v in counts.items()},
              "in_window": _pair_tie(torch, "ring vs plain", plain, win, prompt, want,
                                     got[:in_window])})
    # the ring's function on the card: teacher-forced over the prompt and
    # the tokens it generated, against the window mask over a dense cache
    # (both sides of W: the ring wraps past its first W rows)
    c["vs_window_mask"] = vm = _ring_vs_window_mask(torch, win, prompt + got, n_prompt)
    del plain, win
    if min(vm["min_cosine_in_window"], vm["min_cosine_past_window"]) < 0.99 \
            or not vm["ties_only"]:
        raise AssertionError(f"the ring parts from forward(window=W): {vm}")
    if mem:
        c["allocated_mib"] = {"min": min(mem) / 2**20, "max": max(mem) / 2**20,
                              "samples": len(mem)}
        if (max(mem) - min(mem)) / 2**20 > CKPT_FLAT_MIB:
            raise AssertionError(f"the ring's allocated memory grew: {c['allocated_mib']}")
    if len(got) != n_new or (dev.type == "cuda"
                             and "ternary_matmul_w2a8_normed" not in counts):
        raise AssertionError(f"the ring run: {len(got)} tokens, launches {counts}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) the QK256 pack on the card; (e) the CLI and (f) Llama at the 2B
    out["d_pack"] = _pack_leg(torch, dev, qk)
    out["e_cli"], n = _cli_leg(torch, dev, qk, workdir)
    _add(launches, n)
    out["f_llama"], n = _llama_leg(torch, dev, qk)
    _add(launches, n)
    return out, launches


# ---------------------------------------------------------------------------
# phase: parallel (the parallel modes: ranks of torch.distributed, one
# process a rank; two ranks share the one card)
# ---------------------------------------------------------------------------
PAR_PROMPT = 100          # prompt tokens of (a) and (b): a prefill of 128 rows (K4)
PAR_TOKENS = 32           # new tokens a request of (a) and (b)
PAR_POOL = (12, 40, 24, 60)   # (c): the pool's prompt lengths
PAR_POOL_TOKENS = 16
PAR_SEQ = 1024            # (d): the sequence and ring modes' prompt
PAR_PIPE = (2, 64, 2)     # (d): the pipeline's batch, tokens, microbatches
PAR_SERVE_LAYERS = 4      # (e): the follower's model, the 8B widths cut to depth
PAR_PALLAS_LAYERS = 4     # (b)'s pallas step: K6 at the local shapes
PAR_PALLAS_TOKENS = 8
PAR_TIMEOUT = 600


def phase_parallel(torch, dev, workdir):
    """The parallel modes (``bitnet_tpu_torch/parallel``), in one group of
    two worker processes (``--parallel-rank``: gloo over a FileStore, both
    on this card, so the collectives are host-staged where gloo needs it
    and nothing here is a scaling figure; NCCL across cards is not checked
    here).  Every leg is held to the one-process engine on the same
    weights, in the same run, at bf16: per-step logits cosine >= 0.99 and
    the near-tie rule where argmaxes part (``_pair_rows``).
    (a) NCCL, one rank (a group of rank 0 alone): the 8B (32 layers)
        through ``shard_to_mesh`` on a (1, 1) mesh of that group, two
        requests of 32 teacher-forced steps and 32 greedy tokens;
    (b) gloo, tp = 2: the 8B at full width and depth sharded over both
        ranks (16 / 4 heads, FFN 7168 a rank): K1, K4 and K5 launched at
        the local shapes (counted), teacher-forced logits then greedy
        tokens; ms a step and the host-staged collectives' share of it;
        then a short ``pallas`` run (4 layers, 8 steps) with K6 counted at
        the same local shapes;
    (c) gloo, dp = 2: the 2B, a pool of 4 through ``prefill_batch`` /
        ``decode_batch_step`` teacher-forced, then ``generate_batch``;
    (d) two pipeline stages, and sequence-parallel and ring prefill of a
        1024-token prompt, over the 8B widths at 2 layers, each against
        the one-process forward;
    (e) a frontend and one follower (tp = 2, a ControlChannel) serving
        two greedy requests and one seeded Mirostat request at the 8B
        widths cut to 4 layers, against the one-process scheduler (logits
        rows of the hook, the near-tie rule at the first parting; the
        Mirostat tokens equal)."""
    out_dir = Path(workdir) / "parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(r),
         "--parallel-dir", str(out_dir)], cwd=REPO,
        env={**os.environ, "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(10.0, PAR_TIMEOUT - (
                time.perf_counter() - t0)))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError("parallel: the ranks timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    (OUT_DIR / "parallel_ranks.log").write_text("\n".join(
        f"== rank {r}\n{log}" for r, log in enumerate(logs)))
    res = out_dir / "rank0.json"
    if any(p.returncode for p in procs) or not res.exists():
        raise AssertionError(f"parallel: ranks exited {[p.returncode for p in procs]}: "
                             f"{logs[0][-2000:]}\n{logs[1][-2000:]}")
    out = json.loads(res.read_text())
    out["seconds"] = time.perf_counter() - t0
    return out


def _par_forced(torch, eng, prompt, toks):
    """Logits rows [len(toks) + 1, V] f32 of ``eng``: the prompt's prefill,
    then a decode step of each of ``toks`` (teacher-forced)."""
    with torch.inference_mode():
        rows = [eng.prefill(prompt)[0].float()]
        for i, t in enumerate(toks):
            rows.append(eng.decode_step(int(t), len(prompt) + i)[0].float())
    return torch.stack(rows)


def _pair_rows(torch, name, ref, rows, want, got=None):
    """The parallel phase's rule: rows of logits [n, V] of a sharded run,
    teacher-forced on ``want`` (the one-process run's greedy tokens), against
    the one-process rows ``ref``: each step's cosine >= 0.99, and where the
    argmaxes part the one-process top-2 margin within the largest
    difference.  ``got``: the sharded run's own greedy tokens, equal to
    ``want`` up to the first parting, which must be such a near tie of the
    two runs' rows at that (common) context.  Raises on a failure."""
    ref, rows = ref.float(), rows.float()
    cos = torch.nn.functional.cosine_similarity(ref, rows, dim=-1)
    diff = (ref - rows).abs().amax(-1)
    top2 = torch.topk(ref, 2, dim=-1).values
    same = ref.argmax(-1) == rows.argmax(-1)
    tie = same | (top2[..., 0] - top2[..., 1] <= diff)
    info = {"min_cosine": float(cos.min()), "argmax_agree": int(same.sum()),
            "steps": int(same.numel()), "max_abs_diff": float(diff.max()),
            "bit_equal": bool(torch.equal(ref, rows))}
    if info["min_cosine"] < 0.99 or not bool(tie.all()):
        raise AssertionError(f"parallel {name}: {info}")
    if got is not None:
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        info["tokens_equal"] = j is None and len(got) == len(want)
        if j is not None:
            r, x = ref.reshape(-1, ref.shape[-1])[j], rows.reshape(-1, ref.shape[-1])[j]
            gap = float(r[want[j]] - r[got[j]])
            info["parts_at"], info["gap"] = j, gap
            if gap > float((r - x).abs().max()):
                raise AssertionError(f"parallel {name}: token {j} is no near tie: {info}")
    return info


def _par_greedy(torch, eng, prompt, n):
    """The one-process engine's greedy tokens and its rows, teacher-forced
    on them (its own argmax chain)."""
    with torch.inference_mode():
        rows, toks = [eng.prefill(prompt)[0].float()], []
        for i in range(n):
            toks.append(int(rows[-1].argmax()))
            rows.append(eng.decode_step(toks[-1], len(prompt) + i)[0].float())
    return toks, torch.stack(rows)


def _par_prompts(cfg, n, length, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (length,), generator=g).tolist()
            for _ in range(n)]


def _par_model(torch, dev, cfg, seed=7):
    from bitnet_tpu_torch.models.synthetic import build_synthetic, condition_norms

    return condition_norms(build_synthetic(cfg, seed, device=dev), cfg)


def _par_leg_nccl(torch, dev, rank, dist):
    """(a): rank 0 alone in an NCCL group; rank 1 waits."""
    pg = dist.new_group([0], backend="nccl" if dev.type == "cuda" else "gloo")
    if rank != 0:
        return None
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.parallel.comm import Group
    from bitnet_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

    cfg = LLAMA3_8B_158
    g = Group([0], 0, pg, dist.get_backend(pg))
    mesh = Mesh({DATA_AXIS: g, MODEL_AXIS: g}, g, dev)
    ec = EngineConfig(max_seq_len=256, max_batch_size=1, kv_cache_dtype="bf16")
    params = _par_model(torch, dev, cfg)
    ref = InferenceEngine(cfg, params, ec, device=dev)
    eng = InferenceEngine(cfg, params, ec, device=dev).shard_to_mesh(mesh)
    out = {"requests": []}
    for prompt in _par_prompts(cfg, 2, PAR_PROMPT, 1):
        want, rrows = _par_greedy(torch, ref, prompt, PAR_TOKENS)
        rows = _par_forced(torch, eng, prompt, want)
        got = eng.generate(prompt, GenerationConfig(max_new_tokens=PAR_TOKENS,
                                                    greedy=True)).token_ids
        out["requests"].append(_pair_rows(torch, "(a)", rrows, rows, want, got))
    out["segment_steps"] = eng._segment_steps()
    return out


def _par_leg_tp(torch, dev, rank, dist):
    """(b): the 8B, tp = 2 over the two ranks."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.ops import registry
    from bitnet_tpu_torch.parallel import comm, make_mesh

    cfg = LLAMA3_8B_158
    ec = EngineConfig(max_seq_len=256, max_batch_size=1, kv_cache_dtype="bf16")
    prompts = _par_prompts(cfg, 2, PAR_PROMPT, 2)
    refs = [None, None]
    if rank == 0:
        ref = InferenceEngine(cfg, _par_model(torch, dev, cfg), ec, device=dev)
        refs = [_par_greedy(torch, ref, p, PAR_TOKENS) for p in prompts]
        del ref
        torch.cuda.empty_cache()
    wants = [None if r is None else r[0] for r in refs]
    dist.broadcast_object_list(wants, src=0)
    mesh = make_mesh(dp=1, tp=2, device=dev)
    eng = InferenceEngine(cfg, _par_model(torch, dev, cfg), ec, device=dev).shard_to_mesh(mesh)
    out = {"requests": [], "local": {
        "wq_n": eng.params.blocks.wq.n, "wk_n": eng.params.blocks.wk.n,
        "w_gate_n": eng.params.blocks.w_gate.n, "wo_k": eng.params.blocks.wo.k,
        "w_down_k": eng.params.blocks.w_down.k, "cache": list(eng.cache.k.shape)}}
    registry.reset_launch_counts()
    for p, want, ref in zip(prompts, wants, refs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = _par_forced(torch, eng, p, want)
        torch.cuda.synchronize()
        forced_s = time.perf_counter() - t0
        got = eng.generate(p, GenerationConfig(max_new_tokens=PAR_TOKENS,
                                               greedy=True)).token_ids
        r = {"forced_s": forced_s, "decode_ms_step": eng.last_metrics.decode_s * 1e3
             / max(1, eng.last_metrics.decode_steps)}
        if rank == 0:
            r.update(_pair_rows(torch, "(b)", ref[1], rows, want, got))
        out["requests"].append(r)
    out["launches"] = {k: v for k, v in registry.launch_counts().items() if v}
    for kid in ("ternary_matmul_w2a8_normed", "ternary_matmul_w2a8", "decode_attention"):
        if not out["launches"].get(kid):
            raise AssertionError(f"parallel (b): {kid} not launched: {out['launches']}")
    # the host-staged collectives' share of a step: the same steps, each
    # collective timed between device synchronizations
    comm.reset_stats()
    comm.timing(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _par_forced(torch, eng, prompts[0], wants[0][:8])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    comm.timing(False)
    st = comm.stats()
    out["collectives"] = {**st, "wall_s": wall, "staged_share": st["staged_seconds"] / wall,
                          "share": st["seconds"] / wall,
                          "note": "two ranks time-share one card over gloo: not a "
                                  "scaling figure"}
    del eng
    torch.cuda.empty_cache()
    out["pallas"] = _par_tp_pallas(torch, dev, rank, dist, prompts[0])
    return out


def _par_tp_pallas(torch, dev, rank, dist, prompt):
    """(b)'s ``pallas`` step: K6 at the 8B's tp = 2 local shapes (the row-
    parallel branch: the norm in torch, K6 on f32 x, the f32 partial sums
    all-reduced), the 8B widths at PAR_PALLAS_LAYERS layers, teacher-forced
    on the one-process pallas engine's greedy tokens."""
    import dataclasses

    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.ops import registry
    from bitnet_tpu_torch.parallel import make_mesh

    cfg = dataclasses.replace(LLAMA3_8B_158, num_layers=PAR_PALLAS_LAYERS)
    ec = EngineConfig(max_seq_len=256, max_batch_size=1, kv_cache_dtype="bf16",
                      kernel_path="pallas")
    ref = [None, None]
    if rank == 0:
        one = InferenceEngine(cfg, _par_model(torch, dev, cfg), ec, device=dev)
        ref = list(_par_greedy(torch, one, prompt, PAR_PALLAS_TOKENS))
        del one
        torch.cuda.empty_cache()
    want = ref[:1]
    dist.broadcast_object_list(want, src=0)
    eng = InferenceEngine(cfg, _par_model(torch, dev, cfg), ec, device=dev).shard_to_mesh(
        make_mesh(dp=1, tp=2, device=dev))
    registry.reset_launch_counts()
    rows = _par_forced(torch, eng, prompt, want[0])
    torch.cuda.synchronize()
    out = {"layers": PAR_PALLAS_LAYERS,
           "launches": {k: v for k, v in registry.launch_counts().items() if v}}
    if not out["launches"].get("ternary_matmul_bf16"):
        raise AssertionError(f"parallel (b) pallas: K6 not launched: {out['launches']}")
    if rank == 0:
        out.update(_pair_rows(torch, "(b) pallas", ref[1], rows, want[0]))
    return out


def _par_leg_dp(torch, dev, rank, dist):
    """(c): the 2B, dp = 2: a pool of 4, two slots a rank."""
    import numpy as np

    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T
    from bitnet_tpu_torch.parallel import make_mesh

    cfg = BITNET_2B4T
    ec = EngineConfig(max_seq_len=256, max_batch_size=4, kv_cache_dtype="bf16")
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PAR_POOL]
    gc = GenerationConfig(max_new_tokens=PAR_POOL_TOKENS, greedy=True)
    pos0 = np.array(PAR_POOL, np.int32)

    def forced(eng, toks):
        with torch.inference_mode():
            rows = [eng.prefill_batch(prompts).float()]
            for i in range(toks.shape[0]):
                rows.append(eng.decode_batch_step(toks[i].to(eng.device),
                                                  pos0 + i).float())
        return torch.stack(rows)               # [steps + 1, B, V]
    want = [None]
    if rank == 0:
        ref = InferenceEngine(cfg, _par_model(torch, dev, cfg), ec, device=dev)
        with torch.inference_mode():
            rows, toks = [ref.prefill_batch(prompts).float()], []
            for i in range(PAR_POOL_TOKENS):
                toks.append(rows[-1].argmax(-1))
                rows.append(ref.decode_batch_step(toks[-1], pos0 + i).float())
        rref = torch.stack(rows)
        want = [torch.stack(toks).cpu()]
        ref_batch = [r.token_ids for r in ref.generate_batch(prompts, gc)]
        del ref
        torch.cuda.empty_cache()
    dist.broadcast_object_list(want, src=0)
    eng = InferenceEngine(cfg, _par_model(torch, dev, cfg), ec, device=dev).shard_to_mesh(
        make_mesh(dp=2, tp=1, device=dev))
    rows = forced(eng, want[0])
    got = [r.token_ids for r in eng.generate_batch(prompts, gc)]
    out = {"local_cache": list(eng.cache.k.shape)}
    if rank == 0:
        out["slots"] = [_pair_rows(torch, f"(c) slot {b}", rref[:, b], rows[:, b],
                                   want[0][:, b].tolist(), got[b])
                        for b in range(len(prompts))]
        out["equal_to_one_process_generate_batch"] = got == ref_batch
    return out


def _par_leg_modes(torch, dev, rank, dist):
    """(d): pipeline, sequence and ring at the 8B widths, 2 layers."""
    import dataclasses

    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import prepare_params
    from bitnet_tpu_torch.models.bitnet import forward, logits
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.parallel.pipeline import (make_pipeline_mesh, pipeline_forward,
                                                    shard_pipeline_params)
    from bitnet_tpu_torch.parallel.ring import ring_parallel_prefill
    from bitnet_tpu_torch.parallel.sequence import make_seq_mesh, sequence_parallel_prefill

    cfg = dataclasses.replace(LLAMA3_8B_158, num_layers=2)
    params, _ = prepare_params(_par_model(torch, dev, cfg), EngineConfig(), dev, "w2a8")
    KVD = cfg.num_kv_heads * cfg.head_dim

    def one_process(tokens):
        B, T = tokens.shape
        kc = torch.zeros((cfg.num_layers, B, T, KVD), dtype=torch.bfloat16, device=dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T).contiguous()
        h, _, _ = forward(cfg, params, tokens, pos, kc, torch.zeros_like(kc),
                          torch.zeros(B, dtype=torch.int32, device=dev), T, "w2a8")
        return logits(cfg, params, h, "w2a8")
    out = {}
    with torch.inference_mode():
        B, T, M = PAR_PIPE
        toks = torch.tensor(_par_prompts(cfg, B, T, 4), device=dev)
        want = one_process(toks)
        mesh = make_pipeline_mesh(2, device=dev)
        pp = shard_pipeline_params(mesh, cfg, params)
        kc = torch.zeros((1, B, T, KVD), dtype=torch.bfloat16, device=dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T).contiguous()
        lg, _, _ = pipeline_forward(cfg, pp, toks, pos, kc, torch.zeros_like(kc),
                                    torch.zeros(B, dtype=torch.int32, device=dev), mesh, M)
        out["pipeline"] = _pair_rows(torch, "(d) pipeline", want, lg, [])
        toks = torch.tensor(_par_prompts(cfg, 1, PAR_SEQ, 5), device=dev)
        want = one_process(toks)
        Tl = PAR_SEQ // 2
        mine = want[:, rank * Tl:(rank + 1) * Tl]
        smesh = make_seq_mesh(2, device=dev)
        for name, fn in (("sequence", sequence_parallel_prefill),
                         ("ring", ring_parallel_prefill)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _, _ = fn(cfg, params, toks, smesh, "w2a8")
            torch.cuda.synchronize()
            out[name] = dict(_pair_rows(torch, f"(d) {name}", mine, lg, []),
                             s=time.perf_counter() - t0)
    return out


def _par_leg_follower(torch, dev, rank, dist):
    """(e): a frontend (rank 0) and a follower (rank 1), tp = 2."""
    import dataclasses

    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.parallel.multihost import host_mesh
    from bitnet_tpu_torch.serve.follower import ControlChannel
    from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = dataclasses.replace(LLAMA3_8B_158, num_layers=PAR_SERVE_LAYERS)
    ec = EngineConfig(max_seq_len=256, kv_cache_dtype="bf16")
    prompts = _par_prompts(cfg, 3, 24, 6)
    gens = [GenerationConfig(max_new_tokens=16, greedy=True),
            GenerationConfig(max_new_tokens=16, greedy=True),
            GenerationConfig(max_new_tokens=8, mirostat=2, seed=11)]

    def serve(sched):
        rows = {}
        sched.logits_hook = lambda req, row: rows.setdefault(req.id, []).append(
            row.float().clone())
        toks = []
        try:
            for p, gen in zip(prompts, gens):
                req = sched.submit(p, gen)
                toks.append([t for t, _ in sched.stream(req, timeout=300)])
                toks[-1] = (toks[-1], torch.stack(rows[req.id]))
        finally:
            sched.shutdown()
        return toks
    ref = None
    if rank == 0:
        ref = serve(ContinuousBatchingScheduler(cfg, _par_model(torch, dev, cfg), None, ec,
                                                num_slots=2, device=dev))
    dist.barrier()
    mesh = host_mesh(tp=2, device=dev)
    ch = ControlChannel()
    params = _par_model(torch, dev, cfg)
    if rank != 0:
        ContinuousBatchingScheduler(cfg, params, None, ec, num_slots=2, mesh=mesh,
                                    channel=ch, start_loop=False, device=dev).follow()
        return None
    t0 = time.perf_counter()
    got = serve(ContinuousBatchingScheduler(cfg, params, None, ec, num_slots=2,
                                            mesh=mesh, channel=ch, device=dev))
    out = {"serve_s": time.perf_counter() - t0, "requests": []}
    for i, ((gt, grows), (wt, wrows)) in enumerate(zip(got, ref)):
        if i < 2:
            n = min(len(grows), len(wrows))
            out["requests"].append(_pair_rows(torch, f"(e) request {i}", wrows[:n],
                                              grows[:n], wt, gt))
        else:
            # the seeded draw meets the one-process scheduler's token for
            # token: the sharded logits are the unsharded function's
            if len(gt) != gens[2].max_new_tokens or gt != wt:
                raise AssertionError(f"parallel (e): Mirostat gave {gt}, one process {wt}")
            out["requests"].append({"mirostat_tokens": len(gt),
                                    "equal_to_one_process": True})
    return out


PAR_LEGS = (("a_nccl", _par_leg_nccl), ("b_tp", _par_leg_tp), ("c_dp", _par_leg_dp),
            ("d_modes", _par_leg_modes), ("e_follower", _par_leg_follower))


def parallel_worker(rank: int, out_dir: str, device: str = "cuda") -> int:
    """One rank of the parallel phase (``--parallel-rank``): joins the
    two-rank gloo group, runs every leg in order, writes its results;
    rank 0's are the phase's."""
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from bitnet_tpu_torch.parallel.multihost import init_distributed

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed("file://" + os.path.join(out_dir, "store"), 2, rank,
                     backend="gloo", timeout_s=120, device=dev)
    res = {"rank": rank, "nvidia_smi": nvidia_smi_line()}
    try:
        for name, fn in PAR_LEGS:
            t0 = time.perf_counter()
            r = fn(torch, dev, rank, dist)
            torch.cuda.synchronize()
            res[name] = r
            res.setdefault("leg_s", {})[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            dist.barrier()
    except Exception:            # noqa: BLE001 — the parent reads the log
        traceback.print_exc()
        return 1
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res, default=str))
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.parallel_rank is not None:           # a rank of the parallel phase
        return parallel_worker(args.parallel_rank, args.parallel_dir)
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
    import tempfile

    # files that phases share (the gate's 2B GGUF), removed at the end
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    dev = torch.device("cuda", 0)
    report, smi = {}, None
    seconds = report["seconds"] = {}          # wall time of each phase

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out
    try:
        smi = nvidia_smi_line()
        probe = require_sm90(0)
        report["probe"] = {"phase": "probe", "nvidia_smi": smi, "sm": probe.sm,
                           "device": probe.device_kind, "torch": torch.__version__,
                           "cuda": torch.version.cuda}
        emit(report["probe"])
        if any(p in phases for p in ("build", "kernels", "k1", "k11", "k24", "k33", "w2a8",
                                     "segments", "requests", "scheduler", "gate",
                                     "speculative", "server", "checkpoints",
                                     "parallel")):
            secs = _cuda.build()
            report["build"] = {"phase": "build", "seconds": secs}
            (OUT_DIR / "ptxas.txt").write_text(
                "\n".join(f"== {k}\n{v}" for k, v in _cuda.BUILD_LOG.items()))
            emit(report["build"])
        if "kernels" in phases:
            res = timed("kernels", phase_kernels, torch, dev)
            report["kernels"] = res
            for k, rows in res.items():
                emit({"phase": f"kernels.{k}", "rows": rows})
        if "k1" in phases:
            res = {"k1": []}
            g1 = torch.Generator(device=dev).manual_seed(1234)
            res["rowstats"] = []
            timed("k1", lambda: (check_k1_all(torch, dev, g1, res),
                                 check_rowstats(torch, dev, g1, res)))
            report["k1"] = res
            for k, rows in res.items():
                emit({"phase": f"k1.{k}", "nvidia_smi": smi, "rows": rows})
        if "k11" in phases:
            res = {"k11": [], "k12": [], "k11_8b": []}
            g11 = torch.Generator(device=dev).manual_seed(1234)
            timed("k11", lambda: (check_k11_k12(torch, dev, g11, res),
                                  check_k11_wide(torch, dev, g11, res)))
            report["k11"] = res
            for k, rows in res.items():
                emit({"phase": f"k11.{k}", "nvidia_smi": smi, "rows": rows})
        if "k24" in phases:
            res = {"k24": []}
            timed("k24", check_k24, torch, dev, torch.Generator(device=dev).manual_seed(1234),
                  res)
            report["k24"] = res
            for k, rows in res.items():
                emit({"phase": f"k24.{k}", "rows": rows})
        if "k33" in phases:
            res = {"k33": []}
            timed("k33", check_k33, torch, dev, torch.Generator(device=dev).manual_seed(1234),
                  res)
            report["k33"] = res
            emit({"phase": "k33.k33", "nvidia_smi": smi, "rows": res["k33"]})
        if "w2a8" in phases:
            res = {f"k{n}": [] for n in range(28, 33)}
            timed("w2a8", check_exp_w2a8, torch, dev,
                  torch.Generator(device=dev).manual_seed(1234), res)
            report["w2a8"] = res
            for k, rows in res.items():
                emit({"phase": f"w2a8.{k}", "nvidia_smi": smi, "rows": rows})
        if "parity" in phases:
            report["parity"] = timed("parity", phase_parity, torch, dev)
            emit({"phase": "parity", **report["parity"]})
        launches = {}
        if "serving" in phases:
            report["serving"] = timed("serving", phase_serving, torch, dev)
            s = report["serving"]
            launches["serving"] = s["launch_totals"]
            emit({"phase": "serving", "nvidia_smi": smi,
                  **{k: v for k, v in s.items() if k != "tokens"}})
        if "batched" in phases:
            report["batched"] = timed("batched", phase_batched, torch, dev)
            s = report["batched"]
            launches["batched"] = s["launch_totals"]
            emit({"phase": "batched", "nvidia_smi": smi, **s})
        if "tl" in phases:
            report["tl"] = timed("tl", phase_tl, torch, dev)
            launches.update(report["tl"]["launch_totals"])
            emit({"phase": "tl", "nvidia_smi": smi, **report["tl"]})
        if "llama8b" in phases:
            report["llama8b"] = timed("llama8b", phase_llama8b, torch, dev)
            launches["llama8b"] = report["llama8b"]["launch_totals"]
            emit({"phase": "llama8b", "nvidia_smi": smi, **report["llama8b"]})
        if "generic" in phases:
            report["generic"] = timed("generic", phase_generic, torch, dev)
            s = report["generic"]
            launches["generic"] = s["launch_totals"]
            emit({"phase": "generic", "nvidia_smi": smi, **s})
        if "plans" in phases:
            report["plans"] = timed("plans", phase_plans, torch, dev)
            launches["plans"] = report["plans"]["launch_totals"]
            emit({"phase": "plans", "nvidia_smi": smi, "runs": [
                {k: v for k, v in r.items() if k not in ("tokens", "launches")}
                for r in report["plans"]["runs"]], "parity": [
                {k: v for k, v in r.items() if k not in ("cosines",)}
                for r in report["plans"]["parity"]]})
        if "kernel_bench" in phases:
            report["kernel_bench"] = timed("kernel_bench", phase_kernel_bench, torch, dev)
            emit({"phase": "kernel_bench", "nvidia_smi": smi, **report["kernel_bench"]})
        if "experiments" in phases:
            report["experiments"] = timed("experiments", phase_experiments, torch, dev)
            launches["experiments"] = report["experiments"]["launch_totals"]
            emit({"phase": "experiments", "nvidia_smi": smi,
                  "exp_w2a8": {k: v for k, v in report["experiments"]["exp_w2a8"].items()
                               if k != "stdout"},
                  "exp_r4_attn": [r["line"] for r in report["experiments"]["exp_r4_attn"]]})
        if "cli" in phases:
            report["cli"] = timed("cli", phase_cli, torch, dev)
            emit({"phase": "cli", **{k: v if not isinstance(v, dict) else
                                     {kk: vv for kk, vv in v.items() if kk != "stderr"}
                                     for k, v in report["cli"].items()}})
        if "segments" in phases:
            report["segments"] = r = timed("segments", phase_segments, torch, dev)
            launches["segments"] = {}
            for row in r["runs"]:
                _add(launches["segments"], row[f"k{SEG_K}_launches"])
            emit({"phase": "segments", "nvidia_smi": smi, "seconds": seconds["segments"],
                  "summary": r["summary"],
                  "runs": [{k: v for k, v in row.items() if not k.endswith("launches")}
                           for row in r["runs"]]})
        if "requests" in phases:
            report["requests"] = r = timed("requests", phase_requests, torch, dev)
            emit({"phase": "requests", "nvidia_smi": smi, "seconds": seconds["requests"],
                  "receipt_kernels": r["receipt_kernels"], "launches": r["launches"],
                  "build_s": r["build_s"], "parts_s": r["seconds"],
                  "grammar": {k: v for k, v in r["grammar"].items() if k != "schema"},
                  "mirostat": {k: ({kk: vv for kk, vv in v.items() if kk != "tokens"}
                                   if isinstance(v, dict) else v)
                               for k, v in r["mirostat"].items()},
                  "prefix": r["prefix"],
                  "checkpoint": {k: v for k, v in r["checkpoint"].items()
                                 if k not in ("golden", "first")},
                  "session": r["session"]})
        if "scheduler" in phases:
            report["scheduler"] = r = timed("scheduler", phase_scheduler, torch, dev)
            launches["scheduler"] = r["launch_totals"]
            emit({"phase": "scheduler", "nvidia_smi": smi,
                  "seconds": seconds["scheduler"], "build_s": r["build_s"],
                  "pools": r["pools"]})
        if "gate" in phases:
            report["gate"] = timed("gate", phase_gate, torch, dev, workdir.name)
            g = report["gate"]
            emit({"phase": "gate", "nvidia_smi": smi, "seconds": seconds["gate"],
                  "receipt_kernels": g["receipt_kernels"], "legs": g["legs"]})
        if "speculative" in phases:
            report["speculative"] = r = timed("speculative", phase_speculative, torch,
                                              dev, workdir.name)
            launches["speculative"] = r["launch_totals"]
            emit({"phase": "speculative", "nvidia_smi": smi,
                  "seconds": seconds["speculative"],
                  **{k: v for k, v in r.items() if k != "launch_totals"}})
        if "server" in phases:
            report["server"] = r = timed("server", phase_server, torch, dev, workdir.name)
            launches["server"] = r["launches"]
            emit({"phase": "server", "nvidia_smi": smi, "seconds": seconds["server"],
                  **r})
        if "checkpoints" in phases:
            r, launches["checkpoints"] = timed("checkpoints", phase_checkpoints, torch,
                                               dev, workdir.name)
            report["checkpoints"] = r
            a = r["a_dense"]
            emit({"phase": "checkpoints", "nvidia_smi": smi,
                  "seconds": seconds["checkpoints"],
                  "a_dense": {**{k: v for k, v in a.items() if k != "requests"},
                              "requests": [{k: v for k, v in row.items() if k != "tokens"}
                                           for row in a["requests"]]},
                  "b_hf_dir": r["b_hf_dir"], "c_ring": r["c_ring"],
                  "d_pack": r["d_pack"], "e_cli": r["e_cli"],
                  "f_llama": r["f_llama"], "launches": launches["checkpoints"]})
        if "parallel" in phases:
            report["parallel"] = r = timed("parallel", phase_parallel, torch, dev,
                                           workdir.name)
            launches["parallel"] = dict(r["b_tp"]["launches"])
            _add(launches["parallel"], r["b_tp"]["pallas"]["launches"])
            emit({"phase": "parallel", "nvidia_smi": smi, "seconds": seconds["parallel"],
                  **{k: v for k, v in r.items() if k not in ("seconds",)}})
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        report["error"] = repr(e)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                            default=str))
        print(f"chip_smoke: FAILED: {e!r}", file=sys.stderr)
        return 1
    finally:
        workdir.cleanup()
    emit({"phase": "seconds", **seconds})
    summary = summarize(report["kernels"], launches) if "kernels" in report else []
    for row, (_n, kid, _r, phase, *_rest) in zip(summary, SITES):
        # the server phase's launches of each kernel, on the site of its
        # path: it runs the fused engine, so a kernel that the unstacked
        # path's site shares (K1, K4, K10) counts on the fused site alone
        row["server_launches"] = (0 if phase in ("generic", "tl_generic") else
                                  launches.get("server", {}).get(kid, 0))
        # the checkpoints phase runs the generic path: its counts go on the
        # unstacked sites (K1, K4, K5, K6)
        row["checkpoints_launches"] = (launches.get("checkpoints", {}).get(kid, 0)
                                       if phase == "generic" else 0)
        # so does the parallel phase's leg (b): rank 0's launches at the 8B's
        # tp = 2 local shapes
        row["parallel_launches"] = (launches.get("parallel", {}).get(kid, 0)
                                    if phase == "generic" else 0)
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
