"""Where the host time of an eager decode step goes, at the full
bitnet-b1.58-2B-4T shapes (random weights from seed 0).

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.decode_host_profile [--path generic]
    python -m bitnet_tpu_torch.tools.decode_host_profile --path pool --batch 8 --kv auto
    python -m bitnet_tpu_torch.tools.decode_host_profile --path tl
    python -m bitnet_tpu_torch.tools.decode_host_profile --decode-steps 8

``--path fused`` (the default) is slice 1's stacked path (S=4096, int8
head, B=1); ``--path tl`` the same with every linear re-quantized to TL1
at init (its four projections a layer on K11); ``--path generic`` the
unfused path as the CLI builds its
engine (S=2048, auto → w2a8, bf16 tied head, B=1); ``--path pool`` the
fused path over a pool of ``--batch`` slots, each holding a 32-token
prompt, with a ``--kv`` cache (S=1024, one ``decode_batch_step`` a step).
Prints one JSON line: the host
enqueue time of a decode step (no sync inside the timed loop), the step
time with the sync, the device time of the step's kernels from
``torch.profiler`` (in all, so the share of the step the card idles, and
by kernel), and the functions with the most own time per step under
cProfile (µs per step and calls per step), beside the card's name and
power limit.  ``--decode-steps K`` (the B=1 paths) adds ``segments``:
host ms a token of greedy ``generate`` requests (64 new tokens, the decode
loop's clock ending in a sync) at one step a round trip and in K-step
segments (one CUDA graph of K steps, ``engine/loop.py``), and the device
ms a token of the segment's graph: its replays between CUDA events and
its kernels' sum under ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..config import EngineConfig, GenerationConfig
from ..device_probe import require_sm90
from ..engine.engine import InferenceEngine
from ..models.synthetic import BITNET_2B4T, build_synthetic
from ..ops import _cuda

STEPS, TOP = 30, 12


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("fused", "tl", "generic", "pool"), default="fused")
    ap.add_argument("--batch", type=int, default=8, help="pool slots (--path pool)")
    ap.add_argument("--kv", default="bf16", choices=("bf16", "int8", "fp8", "auto"),
                    help="KV cache dtype (--path pool)")
    ap.add_argument("--decode-steps", type=int, default=0, metavar="K",
                    help="also time generate in K-step segments beside K=1 "
                         "(B=1 paths)")
    args = ap.parse_args(argv)
    if args.decode_steps and (args.path == "pool" or args.decode_steps < 2):
        ap.error("--decode-steps takes K >= 2 on the B=1 paths (segments run "
                 "in generate)")
    require_sm90(0)
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    fused = dict(logits_dtype="int8", kernel_path="w2a8", fuse_projections=True)
    ec = {"fused": EngineConfig(max_seq_len=4096, **fused),
          "tl": EngineConfig(max_seq_len=4096, weight_quant="tl1", **fused),
          "generic": EngineConfig(max_seq_len=2048),
          "pool": EngineConfig(max_seq_len=1024, max_batch_size=args.batch,
                               kv_cache_dtype=args.kv, **fused)}[args.path]
    eng = InferenceEngine(BITNET_2B4T, build_synthetic(BITNET_2B4T, 0, "cuda"), ec)
    prompt = list(range(1, 33))
    B = ec.max_batch_size
    if args.path == "pool":
        tokens = torch.full((B,), 5, dtype=torch.int32, device="cuda")

        def reset():
            eng.prefill_batch([prompt] * B)

        def step(i):
            eng.decode_batch_step(tokens, np.full((B,), len(prompt) + i, np.int32))
    else:
        def reset():
            eng.prefill(prompt)

        def step(i):
            eng.decode_step(5, len(prompt) + i)
    eng.generate(prompt, GenerationConfig(max_new_tokens=8, greedy=True))        # warm-up
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        step(i)
    enqueue = (time.perf_counter() - t0) / STEPS
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS
    reset()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for i in range(STEPS):
        step(i)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        for i in range(STEPS):
            step(i)
        torch.cuda.synchronize()
    kernels = {}                                  # device kernels, not aten ops
    for e in tp.key_averages():
        if e.device_time_total > 0 and not e.key.startswith("aten::"):
            key = e.key.replace("(anonymous namespace)::", "").split("(")[0][-60:]
            kernels[key] = kernels.get(key, 0.0) + e.device_time_total / STEPS
    device_us = sum(kernels.values())
    segments = (None if not args.decode_steps
                else _segments(eng, prompt, args.decode_steps))
    print(json.dumps({
        "card": smi, "path": args.path, "kernel_path": eng.kernel_path,
        "batch": B, "kv": eng.kv_dtype,
        "enqueue_ms_per_step": enqueue * 1e3, "step_ms": step_s * 1e3,
        "device_ms_per_step": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e3 / (step_s * 1e3),
        "device_us_per_step_by_kernel": {
            k: round(v, 1) for k, v in sorted(kernels.items(),
                                              key=lambda kv: -kv[1])[:TOP]},
        "own_us_per_step": {f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})":
                            round(v[2] / STEPS * 1e6, 1) for k, v in top},
        "calls_per_step": {f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})":
                           v[1] / STEPS for k, v in top},
        "segments": segments}))


def _device_us(prof) -> float:
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_time_total > 0 and not e.key.startswith("aten::"))


def _segments(eng, prompt, K: int, tokens: int = 64) -> dict:
    """Greedy ``generate`` of ``tokens`` tokens at K=1 and at K (each once
    to warm up and capture, then timed), then the K-step graph replayed
    alone (each replay goes on from the last one's carry): between CUDA
    events and under the profiler."""
    gc = GenerationConfig(max_new_tokens=tokens, greedy=True)
    host, toks = {}, {}
    for k in (1, K):
        eng.engine_cfg = eng.engine_cfg.replace(decode_steps_per_dispatch=k)
        eng.generate(prompt, gc)
        r = eng.generate(prompt, gc)
        m = eng.last_metrics
        host[k] = m.decode_s * 1e3 / m.decode_steps
        toks[k] = r.token_ids
    seg = next(s for s in eng._segments.values() if s.graph is not None)
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        seg.graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / K)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        seg.graph.replay()
        torch.cuda.synchronize()
    return {"K": K, "tokens_equal": toks[1] == toks[K],
            "host_ms_per_token_k1": host[1], f"host_ms_per_token_k{K}": host[K],
            "replay_ms_per_token": sorted(times)[2],
            "profiled_device_ms_per_token": _device_us(tp) / 1e3 / K,
            "capture_ms": seg.capture_s * 1e3}


if __name__ == "__main__":
    main()
