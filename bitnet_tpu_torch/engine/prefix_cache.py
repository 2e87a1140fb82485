"""Prefix cache: a trie of prompt-token prefixes → host KV snapshots.

Counterpart of ``bitnet_tpu/engine/prefix_cache.py``: repeated prompts
(system prompts, chat history, few-shot preambles) skip the prefill of
their shared prefix.  Snapshots live on the host in the canonical
``[L, length, KV, D]`` layout (and a 1-byte cache's ``[L, length, KV]``
scales), as numpy arrays, or CPU tensors where numpy lacks the dtype (bf16,
fp8); the card holds exactly one live cache.  The port's cache is flat
(``[L, B, S, KV*D]``), so taking a snapshot is a view, one device-to-host
copy and a reshape, and restoring one (``InferenceEngine._restore_prefix``)
one host-to-device copy a buffer.

LRU eviction by total cached tokens; lookup walks the token trie to the
deepest node with a snapshot (the longest usable prefix).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

# torch dtypes numpy has, and so the snapshots and checkpoints hold as
# numpy arrays
_NUMPY_DTYPES = (torch.float32, torch.float16, torch.int8, torch.uint8,
                 torch.int32)


def to_host(t: torch.Tensor):
    """A device tensor → a numpy array, or a CPU tensor where numpy lacks
    its dtype."""
    t = t.detach().to("cpu", copy=True)      # never a view of a CPU cache
    return t.numpy() if t.dtype in _NUMPY_DTYPES else t


def as_tensor(a) -> torch.Tensor:
    """A snapshot's array (numpy or CPU tensor) as a CPU tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


@dataclasses.dataclass
class PrefixSnapshot:
    """KV state for one prompt prefix (a B=1 slice, on the host)."""

    length: int
    k: np.ndarray | torch.Tensor            # [L, length, KV, D]
    v: np.ndarray | torch.Tensor
    k_scale: np.ndarray | None = None       # [L, length, KV] (1-byte caches)
    v_scale: np.ndarray | None = None
    last_used: float = 0.0

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.k) + _nbytes(self.v)
        if self.k_scale is not None:
            n += _nbytes(self.k_scale) + _nbytes(self.v_scale)
        return n


class _Node:
    __slots__ = ("children", "snapshot")

    def __init__(self):
        self.children: dict[int, _Node] = {}
        self.snapshot: Optional[PrefixSnapshot] = None


class PrefixCache:
    """Token-trie prefix cache with LRU-by-tokens eviction."""

    def __init__(self, max_tokens: int = 16384):
        self.max_tokens = max_tokens
        self._root = _Node()
        self._total_tokens = 0
        self.hits = 0
        self.misses = 0

    # -- core ----------------------------------------------------------------
    def lookup(self, tokens: list[int]) -> tuple[int, PrefixSnapshot | None]:
        """Longest stored prefix of ``tokens`` → (match_len, snapshot).

        Returns (0, None) on a complete miss.  Touches the entry for LRU.
        """
        node = self._root
        best_len, best = 0, None
        for i, t in enumerate(tokens):
            node = node.children.get(t)
            if node is None:
                break
            if node.snapshot is not None:
                best_len, best = i + 1, node.snapshot
        if best is not None:
            best.last_used = time.monotonic()
            self.hits += 1
        else:
            self.misses += 1
        return best_len, best

    def insert(self, tokens: list[int], snapshot: PrefixSnapshot) -> None:
        if snapshot.length != len(tokens):
            raise ValueError(
                f"snapshot length {snapshot.length} != tokens {len(tokens)}")
        if snapshot.length > self.max_tokens:
            return                       # would evict everything; skip
        node = self._root
        for t in tokens:
            node = node.children.setdefault(t, _Node())
        if node.snapshot is None:
            self._total_tokens += snapshot.length
        snapshot.last_used = time.monotonic()
        node.snapshot = snapshot
        self._evict_if_needed()

    # -- eviction --------------------------------------------------------------
    def _walk(self, node: _Node, path: list[int], out: list):
        if node.snapshot is not None:
            out.append((list(path), node))
        for t, child in node.children.items():
            path.append(t)
            self._walk(child, path, out)
            path.pop()

    def _evict_if_needed(self) -> None:
        while self._total_tokens > self.max_tokens:
            entries: list = []
            self._walk(self._root, [], entries)
            if not entries:
                return
            path, node = min(entries, key=lambda e: e[1].snapshot.last_used)
            self._total_tokens -= node.snapshot.length
            node.snapshot = None
            self._prune(path)

    def _prune(self, path: list[int]) -> None:
        """Drop now-empty trie branches."""
        chain = [(None, self._root)]
        node = self._root
        for t in path:
            node = node.children[t]
            chain.append((t, node))
        for i in range(len(chain) - 1, 0, -1):
            t, node = chain[i]
            if node.snapshot is None and not node.children:
                del chain[i - 1][1].children[t]
            else:
                break

    # -- stats ----------------------------------------------------------------
    @property
    def cached_tokens(self) -> int:
        return self._total_tokens

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "cached_tokens": self._total_tokens,
            "max_tokens": self.max_tokens,
        }


def canonical_rows(cache, length: int, slot: int = 0,
                   kv_heads: int | None = None):
    """Slot ``slot``'s first ``length`` rows of a flat ``[L, B, S, KV*D]``
    cache as host ``[L, length, KV, D]`` arrays (k, v), and a 1-byte
    cache's ``[L, length, KV]`` scales (else None, None)."""
    KV = (kv_heads if kv_heads is not None
          else cache.k_scale.shape[3] if cache.k_scale is not None else 1)
    L = cache.k.shape[0]
    k, v = (to_host(a[:, slot, :length].reshape(L, length, KV, -1))
            for a in (cache.k, cache.v))
    ks = vs = None
    if cache.k_scale is not None:
        ks, vs = (to_host(a[:, slot, :length])
                  for a in (cache.k_scale, cache.v_scale))
    return k, v, ks, vs


def snapshot_from_cache(cache, length: int, slot: int = 0,
                        kv_heads: int | None = None) -> PrefixSnapshot:
    """A host snapshot of one slot of ``cache`` (an engine ``KVCache``):
    canonical ``[L, length, KV, D]`` rows; pass ``kv_heads``
    (``cfg.num_kv_heads``)."""
    k, v, ks, vs = canonical_rows(cache, length, slot, kv_heads)
    return PrefixSnapshot(length=length, k=k, v=v, k_scale=ks, v_scale=vs)
