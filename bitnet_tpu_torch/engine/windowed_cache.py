"""Windowed (ring-buffer) KV cache for sliding-window attention.

Counterpart of ``bitnet_tpu/engine/windowed_cache.py``: the cache is a
fixed ring of W rows a slot, in the port's flat layout ``[L, B, W,
KV*D]``; the token at absolute position ``p`` lives at row ``p % W``, and
``positions [B, W]`` records each row's true position (-1 = empty), so
attention masks by position, not by row.  Every shape is fixed and every
write in place, so a stream of any length runs in constant device memory.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..device_probe import resolve_device
from ..errors import InferenceError
from .cache import _DTYPES


@dataclasses.dataclass
class WindowedKVCache:
    """k / v: [L, B, W, KV*D]; positions: [B, W] int32 absolute positions
    (-1 = empty); lengths: [B] int32 tokens ever written (not capped at W);
    a 1-byte cache's f32 scales [L, B, W, KV]."""

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    window: int = 0
    quantized: bool = False

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]


def allocate_windowed_cache(cfg: ModelConfig, batch_size: int, window: int,
                            dtype: str = "bf16", device="cuda") -> WindowedKVCache:
    """The ring on the card (as ``allocate_cache`` places the dense cache);
    without CUDA it raises unless the caller passes ``device="cpu"``."""
    if dtype not in _DTYPES:
        raise ValueError(f"bad KV cache dtype {dtype!r}")
    device = resolve_device(device)
    L, KV = cfg.num_layers, cfg.num_kv_heads
    shape = (L, batch_size, window, KV * cfg.head_dim)
    quantized = dtype in ("int8", "fp8")
    scales = (lambda: torch.ones((L, batch_size, window, KV), dtype=torch.float32,
                                 device=device))
    return WindowedKVCache(
        k=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        v=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        positions=torch.full((batch_size, window), -1, dtype=torch.int32,
                             device=device),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        k_scale=scales() if quantized else None,
        v_scale=scales() if quantized else None,
        window=window, quantized=quantized)


def reset_windowed_cache(cache: WindowedKVCache) -> WindowedKVCache:
    """Logical reset: positions back to -1 (a row is valid by its position,
    so stale rows must be invalidated) and lengths to 0."""
    cache.positions.fill_(-1)
    cache.lengths.zero_()
    return cache


def forward_windowed(cfg: ModelConfig, params, tokens: torch.Tensor,
                     q_positions: torch.Tensor, cache: WindowedKVCache,
                     num_real_tokens: torch.Tensor | int | None = None,
                     kernel_path: str = "xla", pad_marker: int | None = None):
    """Sliding-window forward: write at ``pos % W``, attend by true
    position (``bitnet_tpu/engine/windowed_cache.py:86-136``).  Queries at
    ``pad_marker`` (the engine's padding position) neither write nor count.
    Returns (hidden [B, T, H], cache), the cache updated in place.

    More than W tokens a call raise: two tokens a window apart would go to
    one ring row in one call, and which write wins is unspecified (in JAX's
    scatter as in torch's ``index_put_``).  Padding's writes go to row W,
    outside the ring, and are dropped."""
    from ..models.bitnet import forward

    W = cache.window
    B, T = tokens.shape
    if T > W:
        raise InferenceError(
            f"forward_windowed got {T} tokens > window {W}; chunk the prefill "
            f"into ≤{W}-token calls")
    if num_real_tokens is None:
        num_real_tokens = T
    slots = torch.remainder(q_positions, W)
    if pad_marker is not None:
        slots = torch.where(q_positions != pad_marker, slots, torch.full_like(slots, W))
    # a spare column W takes the padding's writes; the ring's T ≤ W real
    # rows a slot are distinct, so no two real writes meet
    ext = torch.cat([cache.positions, torch.full((B, 1), -1, dtype=torch.int32,
                                                 device=cache.positions.device)], 1)
    ext.scatter_(1, slots.to(torch.int64), q_positions.to(torch.int32))
    cache.positions.copy_(ext[:, :W])
    h, _k, _v = forward(cfg, params, tokens, q_positions, cache.k, cache.v,
                        cache.lengths, num_real_tokens, kernel_path,
                        cache.k_scale, cache.v_scale, write_slots=slots,
                        kv_positions=cache.positions, window=W)
    cache.lengths += num_real_tokens
    return h, cache
