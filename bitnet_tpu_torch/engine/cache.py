"""KV cache: preallocated flat ``[L, B, S, KV*D]`` bf16 buffers.

Counterpart of ``bitnet_tpu/engine/cache.py:74-117`` in the flat layout
that the ``qkv_v2s`` decode plan reads natively.  JAX donates the buffers
through jit so XLA updates them in place; here the forward pass writes
them in place (prefill index writes, the K3 row scatter at decode).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig

_DTYPES = {"bf16": torch.bfloat16}


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # [L, B, S, KV*D]
    v: torch.Tensor
    lengths: torch.Tensor    # [B] int32 valid rows per slot


def allocate_cache(cfg: ModelConfig, batch_size: int, max_seq_len: int,
                   dtype: str = "bf16", device="cpu") -> KVCache:
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"a {dtype} KV cache is not ported yet (ROADMAP.md queue 1 #8)")
    shape = (cfg.num_layers, batch_size, max_seq_len,
             cfg.num_kv_heads * cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        v=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device))


def reset_cache(cache: KVCache) -> KVCache:
    """Logical reset: zero the lengths (rows are overwritten on use)."""
    cache.lengths.zero_()
    return cache
