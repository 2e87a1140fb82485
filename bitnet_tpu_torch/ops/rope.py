"""Rotary position embeddings, split (LLaMA) layout — plain PyTorch.

Counterpart of ``bitnet_tpu/ops/rope.py``: ``x = [r_0..r_{d/2-1},
i_0..i_{d/2-1}]`` and ``inv_freq_j = base^(-2j/d)``; tables are f32
``[S, D/2]`` computed in float64 on the host, exactly as the JAX package
builds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device_probe import resolve_device


def build_rope_tables(head_dim: int, max_seq_len: int, base: float = 10000.0,
                      device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) f32 tables of shape [max_seq_len, head_dim // 2], on the
    card unless the caller passes ``device="cpu"`` (without CUDA it
    raises)."""
    device = resolve_device(device)
    if head_dim % 2 != 0:
        raise ValueError(f"head_dim must be even for RoPE, got {head_dim}")
    half = head_dim // 2
    inv_freq = base ** (-np.arange(0, half, dtype=np.float64) * 2.0 / head_dim)
    freqs = np.outer(np.arange(max_seq_len, dtype=np.float64), inv_freq)
    return (torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, T, heads, D] by pre-gathered rows ``sin``/``cos``
    [B, T, D/2] (f32).  Math in f32, result in ``x.dtype``."""
    half = x.shape[-1] // 2
    s = sin[:, :, None, :]
    c = cos[:, :, None, :]
    x0 = x[..., :half].to(torch.float32)
    x1 = x[..., half:].to(torch.float32)
    return torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).to(x.dtype)
