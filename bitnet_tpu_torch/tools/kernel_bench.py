"""Kernel micro-benchmarks: one kernel at given shapes, device time per call.

Counterpart of ``bitnet_tpu/tools/kernel_bench.py`` (the CLI's
``benchmark-kernels``), with its result keys, shapes and attention
variants.  Times come from :func:`~bitnet_tpu_torch.obs.timing.chain_timer`
(CUDA-graph replays of two chain lengths, minima differenced, fresh inputs
each replay).  Every chain cycles through a stack of weights or caches
larger than the H100's 50 MB L2, so each call reads its operands from
device memory as the decode step does (a B=1, S=1024 bf16 cache is 2.6 MB,
a 2560x2560 weight 1.6 MB: one of them alone would stay in the L2).

- :func:`bench_ternary_kernel`: the JAX tool's ``ternary_matmul_pallas``
  with its default variant ``pallas``, which is K6 (bf16 rows x the
  ternary words); ``packed_mb`` and ``gbps`` count the packed words.
- :func:`bench_decode_attention`: one ``decode_attn_plan`` variant —
  ``einsum`` the plain torch attention over the cache with the new row
  written, ``flash`` K5, ``qkv`` K13, ``qkv_quant`` K14, ``quant`` K15,
  ``batched`` K16, ``quant_batched`` K17, ``qkv_batched`` K18,
  ``qkv_quant_batched`` K19 (the v1 kernels, as the JAX tool calls them);
  the quantized variants over an int8 cache.  ``packed_mb`` and ``gbps``
  count the cache (k and v).  The JAX tool's chain also writes each new
  row into its cache (so XLA keeps the cache in HBM); here a step is the
  wrapper's call alone.

On the CPU (``device="cpu"``, tests only) it times the plain versions
with the host clock; such a number is never the card's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device_probe import resolve_device
from ..obs.timing import chain_timer

L2_CYCLE_BYTES = 120 << 20        # what a chain cycles through (> 50 MB L2)


@dataclasses.dataclass
class KernelBenchResult:
    name: str
    k: int
    n: int
    m: int
    us_per_call: float
    packed_mb: float
    gbps: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


DECODE_SHAPES_2B = [
    ("wq/wo", 2560, 2560),
    ("wk/wv", 2560, 640),
    ("gate/up", 2560, 6912),
    ("down", 6912, 2560),
]


def _layers(dev: torch.device, layer_bytes: int) -> int:
    """Stack depth whose cycle exceeds the L2 on the card (2 on the CPU)."""
    if dev.type == "cpu":
        return 2
    return max(2, math.ceil(L2_CYCLE_BYTES / layer_bytes))


def _result(name, k, n, m, dt, mb) -> KernelBenchResult:
    return KernelBenchResult(name=name, k=k, n=n, m=m,
                             us_per_call=round(dt * 1e6, 2),
                             packed_mb=round(mb, 2),
                             gbps=round(mb / 1e3 / dt, 1) if dt > 0 else 0.0)


def bench_ternary_kernel(k: int, n: int, m: int = 1, name: str = "",
                         n_hi: int = 2048, n_lo: int = 512, pairs: int = 2,
                         seed: int = 0, device="cuda") -> KernelBenchResult:
    """Time ``ternary_matmul_pallas`` (variant ``pallas``: K6) at
    [m, k] @ [k, n] with random QK256 words and a 0.02 scale."""
    from ..ops.linear import TernaryLinear, with_col_scales
    from ..ops.ternary_matmul import ternary_matmul_pallas

    dev = resolve_device(device)
    kp, npad = -(-k // 256) * 256, -(-n // 128) * 128
    L = _layers(dev, kp // 4 * npad)
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-2**31, 2**31, (L, kp // 16, npad), dtype=torch.int32,
                           generator=g, device=dev)
    lin = with_col_scales(TernaryLinear(kind="qk256", k=k, n=n, packed=packed,
                                        scales=torch.full((L,), 0.02, device=dev)))

    def step(x, i):
        ternary_matmul_pallas(lin, x, layer=i % L)
        return x

    def mk(salt):
        gs = torch.Generator(device=dev).manual_seed(seed * 7919 + salt)
        return torch.randn((m, k), generator=gs, device=dev).to(torch.bfloat16)

    dt = chain_timer(step, mk, n_hi, n_lo, pairs)
    return _result(name or f"{k}x{n}", k, n, m, dt, (kp // 4) * npad / 1e6)


def bench_decode_shapes(m: int = 1, device="cuda", **kw) -> list[KernelBenchResult]:
    return [bench_ternary_kernel(k, n, m=m, name=name, device=device, **kw)
            for name, k, n in DECODE_SHAPES_2B]


ATTN_VARIANTS = ("einsum", "flash", "qkv", "quant", "qkv_quant",
                 "batched", "qkv_batched", "quant_batched",
                 "qkv_quant_batched")


def bench_decode_attention(variant: str, B: int = 1, S: int = 1024,
                           n_kv: int = 5, G: int = 4, D: int = 128,
                           n_hi: int = 1024, n_lo: int = 256, pairs: int = 2,
                           seed: int = 0, device="cuda") -> KernelBenchResult:
    """Time one decode-attention variant (``decode_attn_plan`` names) over
    a cache of S rows, B slots of S/2 + (salt % 8) valid rows each."""
    from ..ops import decode_attention as dk
    from ..ops.attention import attention
    from ..ops.rope import build_rope_tables

    if variant not in ATTN_VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}; one of "
                         f"{', '.join(ATTN_VARIANTS)}")
    dev = resolve_device(device)
    H = n_kv * G
    quant = "quant" in variant
    esz = 1 if quant else 2
    L = _layers(dev, 2 * B * S * n_kv * D * esz)
    g = torch.Generator(device=dev).manual_seed(seed)
    if quant:
        kc, vc = (torch.randint(-127, 128, (L, B, S, n_kv * D), generator=g,
                                device=dev, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((L, B, S, n_kv), generator=g, device=dev) * 0.019 + 1e-3
                  for _ in range(2))
        scales = (ks, vs)
    else:
        kc, vc = ((torch.randn((L, B, S, n_kv * D), generator=g, device=dev) * 0.3
                   ).to(torch.bfloat16) for _ in range(2))
        scales = ()
    sin_t, cos_t = build_rope_tables(D, S, 10000.0, device=dev)

    def mk(salt):
        gs = torch.Generator(device=dev).manual_seed(seed * 7919 + salt)
        qkv = torch.randn((B, H + 2 * n_kv, D), generator=gs, device=dev)
        pos = torch.full((B,), S // 2 + salt % 8, dtype=torch.int32, device=dev)
        return (qkv, qkv[:, :H].contiguous(), qkv[:, H:H + n_kv].contiguous(),
                qkv[:, H + n_kv:].contiguous(), pos, sin_t[pos.long()],
                cos_t[pos.long()])

    rope_fused = {"qkv": dk.decode_attention_qkv_v1,
                  "qkv_quant": dk.decode_attention_qkv_quant_v1,
                  "qkv_batched": dk.decode_attention_qkv_batched,
                  "qkv_quant_batched": dk.decode_attention_qkv_quant_batched}
    split = {"flash": dk.decode_attention, "quant": dk.decode_attention_quant,
             "batched": dk.decode_attention_batched_v1,
             "quant_batched": dk.decode_attention_quant_batched_v1}
    b_idx = torch.arange(B, device=dev)

    def step(carry, i):
        qkv, q, kn, vn, pos, sin_r, cos_r = carry
        l = i % L
        if variant in rope_fused:
            rope_fused[variant](l, qkv, sin_r, cos_r, kc, vc, *scales, pos,
                                n_heads=H, n_kv=n_kv)
        elif variant in split:
            split[variant](l, q, kn, vn, kc, vc, *scales, pos)
        else:      # einsum: plain attention over the cache with the row written
            kw = kc[l].view(B, S, n_kv, D).float()
            vw = vc[l].view(B, S, n_kv, D).float()
            kw[b_idx, pos.long()] = kn
            vw[b_idx, pos.long()] = vn
            attention(q[:, None], kw, vw, pos[:, None], pos + 1)
        return carry

    dt = chain_timer(step, mk, n_hi, n_lo, pairs)
    return _result(f"attn_{variant}", S, n_kv * D, B, dt,
                   2 * B * S * n_kv * D * esz / 1e6)
