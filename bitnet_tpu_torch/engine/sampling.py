"""Greedy sampling (the slice's only sampler; the SamplerChain is ROADMAP
queue 1 #5).  ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does, so ties break the same way in both packages."""

from __future__ import annotations

import torch


def argmax(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] logits → [B] int32 token ids."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
