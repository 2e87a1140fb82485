"""Structured attention pattern masks (plain PyTorch).

Counterpart of ``bitnet_tpu/ops/attention_patterns.py``: a pattern is a
pure function from (query positions, key positions) to a boolean mask,
ANDed into ``ops.attention(extra_mask=...)``.  Every builder keeps fixed
shapes (no shape depends on the data).
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class PatternKind(enum.Enum):
    DENSE = "dense"                  # every key (no causality!)
    CAUSAL = "causal"                # key_pos <= q_pos
    SLIDING_WINDOW = "sliding_window"  # causal ∧ key > q - window
    DILATED = "dilated"              # causal ∧ (q - key) % rate == 0, within span
    GLOBAL_LOCAL = "global_local"    # causal ∧ (local window ∨ global keys)
    BLOCK_SPARSE = "block_sparse"    # causal ∧ same-or-earlier block stride


@dataclasses.dataclass(frozen=True)
class AttentionPattern:
    """- ``window``: local span for SLIDING_WINDOW / DILATED / GLOBAL_LOCAL;
    - ``rate``: dilation rate for DILATED (1 == plain sliding window);
    - ``num_global``: the first N absolute positions, attendable by every
      query (Longformer-style global tokens);
    - ``block_size`` / ``stride``: BLOCK_SPARSE — a query in block ``i``
      attends keys in blocks ``i, i-stride, i-2*stride, ...`` plus block 0."""

    kind: PatternKind = PatternKind.CAUSAL
    window: int = 0
    rate: int = 1
    num_global: int = 0
    block_size: int = 64
    stride: int = 1


def pattern_mask(pattern: AttentionPattern,
                 q_positions: torch.Tensor,      # [B, Tq] absolute positions
                 key_positions: torch.Tensor,    # [B, S] (-1 = hole)
                 ) -> torch.Tensor:
    """Boolean [B, Tq, S]: True where attention is allowed.  Invalid key
    slots (position < 0) are always masked; every kind but DENSE is
    causal."""
    qp = q_positions[:, :, None].to(torch.int32)
    kp = key_positions[:, None, :].to(torch.int32)
    valid = kp >= 0
    causal = (kp <= qp) & valid
    kind = pattern.kind
    if kind == PatternKind.DENSE:
        return valid & torch.ones_like(causal)
    if kind == PatternKind.CAUSAL:
        return causal
    if kind == PatternKind.SLIDING_WINDOW:
        return causal & (kp > qp - pattern.window)
    if kind == PatternKind.DILATED:
        dist = qp - kp
        span = pattern.window * pattern.rate
        # floor modulo, as jnp's %
        return causal & (dist < span) & (torch.remainder(dist, pattern.rate) == 0)
    if kind == PatternKind.GLOBAL_LOCAL:
        return causal & ((kp > qp - pattern.window) | (kp < pattern.num_global))
    if kind == PatternKind.BLOCK_SPARSE:
        qb = torch.div(qp, pattern.block_size, rounding_mode="floor")
        kb = torch.div(kp, pattern.block_size, rounding_mode="floor")
        hit = (torch.remainder(qb - kb, pattern.stride) == 0) | (kb == 0)
        return causal & hit
    raise ValueError(f"unknown pattern kind {kind!r}")


def effective_kv_footprint(pattern: AttentionPattern, seq_len: int) -> int:
    """Upper bound on the keys one query can see (sizing windowed caches)."""
    if pattern.kind in (PatternKind.DENSE, PatternKind.CAUSAL):
        return seq_len
    if pattern.kind in (PatternKind.SLIDING_WINDOW, PatternKind.DILATED):
        return min(pattern.window, seq_len)
    if pattern.kind == PatternKind.GLOBAL_LOCAL:
        return min(pattern.window + pattern.num_global, seq_len)
    if pattern.kind == PatternKind.BLOCK_SPARSE:
        blocks = -(-seq_len // pattern.block_size)
        hit = -(-blocks // pattern.stride) + 1
        return min(hit * pattern.block_size, seq_len)
    raise ValueError(pattern.kind)
