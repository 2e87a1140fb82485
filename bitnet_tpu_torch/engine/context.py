"""Context-window management for long conversations (a copy of
``bitnet_tpu/engine/context.py``).

Host-side policy layer matching the reference's context-window machinery
(``bitnet-gpu-hal/src/context_window.rs:15-277`` chunking / eviction /
importance scoring, and the engine's keep-half truncation at overflow,
``bitnet-inference/src/engine.rs:1222-1227``).

These operate on *token lists* before prefill — the device-side answer to
long context is the ring-buffer windowed cache (``windowed_cache.py``);
this module is for the host decision "which tokens do we even keep"
when a chat transcript outgrows ``max_seq_len``.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import Counter


class EvictionPolicy(enum.Enum):
    KEEP_HALF = "keep_half"          # reference engine.rs:1222 default
    KEEP_RECENT = "keep_recent"      # plain tail window
    HEAD_AND_TAIL = "head_and_tail"  # system prompt + recent turns
    IMPORTANCE = "importance"        # score-based (rarity heuristic)


@dataclasses.dataclass(frozen=True)
class ContextWindowConfig:
    max_tokens: int
    policy: EvictionPolicy = EvictionPolicy.KEEP_HALF
    head_keep: int = 0           # tokens pinned at the start (system prompt)
    protect_last: int = 64       # tokens never evicted from the tail


def importance_scores(token_ids: list[int]) -> list[float]:
    """Rarity-weighted importance (context_window.rs importance scoring):
    rare tokens score high, runs of repeats decay, recency adds a ramp."""
    n = len(token_ids)
    if n == 0:
        return []
    counts = Counter(token_ids)
    scores = []
    prev = None
    run = 0
    for i, t in enumerate(token_ids):
        run = run + 1 if t == prev else 0
        prev = t
        rarity = 1.0 / counts[t]
        recency = 0.5 * (i + 1) / n
        scores.append(rarity / (1 + run) + recency)
    return scores


def evict(token_ids: list[int], cfg: ContextWindowConfig) -> list[int]:
    """Shrink ``token_ids`` to fit ``cfg.max_tokens`` under the policy.

    Always returns a list ≤ max_tokens; a no-op when already within budget.
    """
    n = len(token_ids)
    if n <= cfg.max_tokens:
        return list(token_ids)
    m = cfg.max_tokens

    if cfg.policy == EvictionPolicy.KEEP_HALF:
        return list(token_ids[-(m // 2):])
    if cfg.policy == EvictionPolicy.KEEP_RECENT:
        return list(token_ids[-m:])
    if cfg.policy == EvictionPolicy.HEAD_AND_TAIL:
        head = min(cfg.head_keep, m)
        tail = m - head
        return list(token_ids[:head]) + list(token_ids[n - tail:])
    if cfg.policy == EvictionPolicy.IMPORTANCE:
        head = min(cfg.head_keep, m)
        tail = min(cfg.protect_last, m - head)
        budget = m - head - tail
        mid_start, mid_end = head, n - tail
        mid = list(range(mid_start, mid_end))
        if budget <= 0:
            keep = []
        else:
            scores = importance_scores(token_ids)
            mid.sort(key=lambda i: scores[i], reverse=True)
            keep = sorted(mid[:budget])
        idx = list(range(head)) + keep + list(range(n - tail, n))
        return [token_ids[i] for i in idx]
    raise ValueError(f"unknown policy {cfg.policy!r}")
