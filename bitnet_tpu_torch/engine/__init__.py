"""Inference engine: decode loop, KV cache, sampling, stop criteria, and
the per-request state (prefix cache, checkpoint / resume, sessions,
context eviction).

The names of ``bitnet_tpu/engine/__init__.py`` that the port has, loaded
on first use (``models.convert`` imports ``engine.cache`` while the model
modules load, so this package imports nothing eagerly).
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "checkpoint": "checkpoint",
    "ContextWindowConfig": "context", "EvictionPolicy": "context",
    "evict": "context", "importance_scores": "context",
    "PrefixCache": "prefix_cache", "PrefixSnapshot": "prefix_cache",
    "PagedKVCache": "paged_cache", "PagePool": "paged_cache",
    "allocate_paged_cache": "paged_cache",
    "EngineDraft": "speculative", "NgramDraft": "speculative",
    "SpeculativeConfig": "speculative", "SpeculativeDecoder": "speculative",
    "Session": "session", "SessionConfig": "session", "SessionState": "session",
    "StateTracker": "session",
    "KVCache": "cache", "allocate_cache": "cache", "reset_cache": "cache",
    "GenerationResult": "engine", "InferenceEngine": "engine",
    "PerformanceMetrics": "engine", "TokenEvent": "engine",
    "prefill_buckets": "engine",
    "MirostatState": "sampling", "SamplerChain": "sampling",
    "apply_min_p": "sampling", "apply_repetition_penalty": "sampling",
    "apply_temperature": "sampling", "apply_top_k": "sampling",
    "apply_top_p": "sampling", "apply_typical_p": "sampling",
    "argmax": "sampling",
    "StopCriteria": "stop", "StopReason": "stop",
    "WindowedKVCache": "windowed_cache", "allocate_windowed_cache": "windowed_cache",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    m = importlib.import_module(f".{mod}", __name__)
    return m if name == mod else getattr(m, name)
