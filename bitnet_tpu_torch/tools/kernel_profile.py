"""Device time of each CUDA kernel behind the four wrappers, at the main
path's bitnet-b1.58-2B-4T shapes, from ``torch.profiler`` (CUPTI).

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.kernel_profile

It splits what ``chip_smoke.py`` times per wrapper into the kernels that
ran (K1's fused GEMV, K4's GEMM apart from the PyTorch quantization of its
activations, K2's two passes) and prints one JSON line per case with the
card's name and power limit.  Weights and caches cycle over 8 layers.
"""

from __future__ import annotations

import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..device_probe import require_sm90
from ..ops import _cuda
from ..ops import decode_attention_v2 as da
from ..ops import ternary_matmul as tm

SHAPES = (("qkv", 2560, 3840, False, False), ("o", 2560, 2560, False, True),
          ("gate_up", 2560, 13824, False, False), ("down", 6912, 2560, True, True))
REPS, LAYERS = 40, 8


def _cases(dev, g):
    for name, K, N, glu, res in SHAPES:
        w = torch.randint(-2**31, 2**31, (LAYERS, K // 16, N), dtype=torch.int32,
                          generator=g, device=dev)
        sv = (torch.rand((LAYERS, N), generator=g, device=dev) + 0.5) * 0.02
        gam = torch.rand((LAYERS, K), generator=g, device=dev) + 0.5
        x = torch.randn((1, 2 * K if glu else K), generator=g, device=dev).bfloat16()
        r = torch.randn((1, N), generator=g, device=dev).bfloat16() if res else None
        yield f"K1 {name} M=1", lambda i, w=w, sv=sv, gam=gam, x=x, r=r, K=K, N=N, glu=glu: (
            tm.ternary_matmul_w2a8_normed(i % LAYERS, x, w, sv, gam, K, N, 1e-5, glu, r))
        x4 = torch.randn((512, K), generator=g, device=dev).bfloat16()
        yield f"K4 {name} M=512", lambda i, w=w, sv=sv, x4=x4, K=K, N=N: (
            tm.ternary_matmul_w2a8(i % LAYERS, x4, w, sv, K, N))
    for S in (1024, 4096):
        kc = torch.randn((LAYERS, 1, S, 640), generator=g, device=dev).bfloat16()
        vc = torch.randn_like(kc)
        qkv = torch.randn((1, 30, 128), generator=g, device=dev).bfloat16()
        a = torch.rand((1, 64), generator=g, device=dev)
        pos = torch.tensor([S - 1], dtype=torch.int32, device=dev)
        yield f"K2 S={S} pos={S - 1}", lambda i, kc=kc, vc=vc, qkv=qkv, a=a, pos=pos: (
            da.decode_attention_qkv(i % LAYERS, qkv, a.sin(), a.cos(), kc, vc, pos, 20, 5))


def main() -> None:
    require_sm90(0)
    dev = torch.device("cuda", 0)
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    for name, fn in _cases(dev, g):
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
                          "device_us_per_call": {k: round(v, 2) for k, v in
                                                 sorted(kernels.items(),
                                                        key=lambda kv: -kv[1])}}))


if __name__ == "__main__":
    main()
