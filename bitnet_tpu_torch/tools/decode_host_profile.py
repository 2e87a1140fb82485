"""Where the host time of an eager decode step goes, at the full
bitnet-b1.58-2B-4T shapes (random weights from seed 0, B=1, S=4096).

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.decode_host_profile

Prints one JSON line: the host enqueue time of a decode step (no sync
inside the timed loop), the step time with the sync, and the functions
with the most own time per step under cProfile (µs per step and calls per
step), beside the card's name and power limit.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import time

import torch

from ..config import EngineConfig, GenerationConfig
from ..device_probe import require_sm90
from ..engine.engine import InferenceEngine
from ..models.synthetic import BITNET_2B4T, build_synthetic
from ..ops import _cuda

STEPS, TOP = 30, 12


def main() -> None:
    require_sm90(0)
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    eng = InferenceEngine(BITNET_2B4T, build_synthetic(BITNET_2B4T, 0, "cuda"),
                          EngineConfig(max_seq_len=4096, logits_dtype="int8"))
    prompt = list(range(1, 33))
    eng.generate(prompt, GenerationConfig(max_new_tokens=8))        # warm-up
    eng.prefill(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        eng.decode_step(5, len(prompt) + i)
    enqueue = (time.perf_counter() - t0) / STEPS
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / STEPS
    eng.prefill(prompt)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for i in range(STEPS):
        eng.decode_step(5, len(prompt) + i)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    print(json.dumps({
        "card": smi, "enqueue_ms_per_step": enqueue * 1e3,
        "step_ms": step * 1e3,
        "own_us_per_step": {f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})":
                            round(v[2] / STEPS * 1e6, 1) for k, v in top},
        "calls_per_step": {f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})":
                           v[1] / STEPS for k, v in top}}))


if __name__ == "__main__":
    main()
