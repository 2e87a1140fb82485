"""KV cache: preallocated flat ``[L, B, S, KV*D]`` buffers, bf16, f32 or
quantized (int8 / fp8-e4m3 with f32 per-row, per-head scales).

Counterpart of ``bitnet_tpu/engine/cache.py:74-117`` in the flat layout
that every stacked decode plan of the port reads natively.  The scales
keep the canonical ``[L, B, S, KV]`` layout, initialised to ones as
``allocate_cache`` does.  JAX donates the buffers through jit so XLA
updates them in place; here the forward pass writes them in place
(prefill and generic index writes, the K3 row scatter at decode).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..device_probe import resolve_device

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
           "fp8": torch.float8_e4m3fn}


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # [L, B, S, KV*D]
    v: torch.Tensor
    lengths: torch.Tensor    # [B] int32 valid rows per slot
    k_scale: torch.Tensor | None = None   # [L, B, S, KV] f32 (int8 / fp8)
    v_scale: torch.Tensor | None = None


def allocate_cache(cfg: ModelConfig, batch_size: int, max_seq_len: int,
                   dtype: str = "bf16", device="cuda") -> KVCache:
    """The cache on the card (as the JAX ``allocate_cache`` places it on
    the accelerator); without CUDA it raises unless the caller passes
    ``device="cpu"``."""
    if dtype not in _DTYPES:
        raise ValueError(f"bad KV cache dtype {dtype!r}")
    device = resolve_device(device)
    L, KV = cfg.num_layers, cfg.num_kv_heads
    shape = (L, batch_size, max_seq_len, KV * cfg.head_dim)
    quantized = dtype in ("int8", "fp8")
    scales = (lambda: torch.ones((L, batch_size, max_seq_len, KV),
                                 dtype=torch.float32, device=device))
    return KVCache(
        k=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        v=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        k_scale=scales() if quantized else None,
        v_scale=scales() if quantized else None)


def reset_cache(cache: KVCache) -> KVCache:
    """Logical reset: zero the lengths (rows are overwritten on use)."""
    cache.lengths.zero_()
    return cache
