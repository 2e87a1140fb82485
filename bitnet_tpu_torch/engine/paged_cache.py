"""Paged KV cache: a shared page pool + per-sequence block tables.

Counterpart of ``bitnet_tpu/engine/paged_cache.py``: a host-side
refcounted :class:`PagePool` (the same page ids in the same order), block
tables mapping logical position ``p`` of slot b to page
``tables[b, p // page]``, prefix forks of refcounted pages, and
:func:`paged_forward`.

Layout: ``k`` / ``v`` are ``[L, KV, P + 1, page, D]``: a layer's
``[KV, P, page, D]`` is the stock paged-attention kernel's page layout, so
K33 (``ops/paged_attention.py``) reads one layer as a view.  The JAX pool
is ``[L, P, page, KV, D]`` (:func:`to_jax_layout` permutes).  Page ``P``,
past the pool's ids, is a scratch page no table names: writes that the
JAX package drops (padding, idle slots, positions past the table) land
there.

:func:`paged_forward` keeps the JAX form for prefills and chunks (gather
a dense ``[L, B, S_view, KV*D]`` view, run ``forward``, scatter the new
rows back into their pages).  A decode step (one token a slot) on the
stacked w2a8 path builds no view: ``models/bitnet.forward_paged_decode``
writes each layer's new rows into their pages and attends through K33.
The JAX package gathers there too only because XLA would copy a written
pool that a Pallas kernel reads (``bitnet_tpu/engine/paged_cache.py:18-25``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ModelConfig
from ..device_probe import resolve_device
from ..errors import InferenceError

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class PagePool:
    """Host-side page allocator with refcounts (prefix sharing / CoW)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise InferenceError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def retain(self, pages: list[int]) -> None:
        """Share pages with another sequence (prefix fork)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise InferenceError(f"retain of free page {p}")
            self._refs[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
            elif self._refs[p] < 0:
                raise InferenceError(f"double free of page {p}")

    def refcount(self, page: int) -> int:
        return int(self._refs[page])


@dataclasses.dataclass
class PagedKVCache:
    """k / v: [L, KV, P + 1, page, D] (page P is scratch); tables: [B, NB]
    int32 page ids (-1 empty); lengths: [B] int32 valid tokens a slot.
    The scheduler writes every field in place (a captured CUDA graph holds
    their addresses)."""

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor
    page_size: int = 16

    @property
    def view_len(self) -> int:
        return self.tables.shape[1] * self.page_size

    @property
    def batch_size(self) -> int:
        return self.tables.shape[0]

    @property
    def scratch_page(self) -> int:
        return self.k.shape[2] - 1


def allocate_paged_cache(cfg: ModelConfig, batch_size: int, num_pages: int,
                         page_size: int = 16, max_blocks_per_seq: int | None = None,
                         dtype: str = "bf16", device="cuda"
                         ) -> tuple[PagedKVCache, PagePool]:
    """The pool on the card (without CUDA it raises unless the caller
    passes ``device="cpu"``); bf16 or f32 pages."""
    if max_blocks_per_seq is None:
        max_blocks_per_seq = num_pages
    if dtype not in _DTYPES:
        raise InferenceError("paged cache: quantized pages not yet supported")
    device = resolve_device(device)
    L, KV, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shape = (L, KV, num_pages + 1, page_size, D)
    cache = PagedKVCache(
        k=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        v=torch.zeros(shape, dtype=_DTYPES[dtype], device=device),
        tables=torch.full((batch_size, max_blocks_per_seq), -1, dtype=torch.int32,
                          device=device),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        page_size=page_size)
    return cache, PagePool(num_pages)


def to_jax_layout(pages: torch.Tensor) -> torch.Tensor:
    """[L, KV, P + 1, page, D] → the JAX pool's [L, P, page, KV, D]."""
    return pages[:, :, :-1].permute(0, 2, 3, 1, 4)


def assign_pages(cache: PagedKVCache, slot: int, pages: list[int],
                 start_block: int = 0) -> PagedKVCache:
    """Host-side: write page ids into one slot's block table (in place)."""
    if pages:
        cache.tables[slot, start_block:start_block + len(pages)] = torch.tensor(
            pages, dtype=torch.int32)
    return cache


def pages_needed(length: int, page_size: int) -> int:
    return -(-length // page_size)


def ensure_capacity(cache: PagedKVCache, pool: PagePool, slot: int,
                    new_length: int) -> PagedKVCache:
    """Allocate pages so ``slot`` can hold ``new_length`` tokens."""
    have = pages_needed(int(cache.lengths[slot]), cache.page_size)
    # count actually-assigned blocks (restored slots may differ from length)
    tab = cache.tables[slot].cpu().numpy()
    have = max(have, int((tab >= 0).sum()))
    need = pages_needed(new_length, cache.page_size)
    if need > cache.tables.shape[1]:
        raise InferenceError(
            f"sequence of {new_length} tokens exceeds block table "
            f"({cache.tables.shape[1]} × {cache.page_size})")
    if need > have:
        cache = assign_pages(cache, slot, pool.alloc(need - have), have)
    return cache


def release_slot(cache: PagedKVCache, pool: PagePool, slot: int) -> PagedKVCache:
    """Free a finished sequence's pages and clear its table."""
    tab = cache.tables[slot].cpu().numpy()
    pool.release([int(p) for p in tab if p >= 0])
    cache.tables[slot] = -1
    cache.lengths[slot] = 0
    return cache


def fork_slot(cache: PagedKVCache, pool: PagePool, src: int, dst: int,
              length: int | None = None) -> PagedKVCache:
    """Share ``src``'s pages with ``dst`` (copy-on-write prefix fork).

    ``dst`` must only *append* at positions ≥ its fork length; appends that
    land inside a shared page must copy it first (not automated: the
    scheduler forks on page boundaries)."""
    if length is None:
        length = int(cache.lengths[src])
    nb = pages_needed(length, cache.page_size)
    pages = [int(p) for p in cache.tables[src, :nb].cpu().numpy()]
    if any(p < 0 for p in pages):
        raise InferenceError("fork: source pages not assigned")
    if length % cache.page_size != 0:
        raise InferenceError("fork length must be a page-boundary multiple")
    pool.retain(pages)
    assign_pages(cache, dst, pages)
    cache.lengths[dst] = length
    return cache


# ---------------------------------------------------------------------------
# where a token's row lives
# ---------------------------------------------------------------------------
def row_slots(cache: PagedKVCache, q_positions: torch.Tensor):
    """(page, offset) [B, T] int64 of each token's row; positions at or past
    the table's reach, and unassigned blocks, go to the scratch page."""
    page, NB = cache.page_size, cache.tables.shape[1]
    pos = q_positions.to(torch.int64)
    valid = pos < NB * page
    blk = torch.clamp(pos // page, 0, NB - 1)
    gpage = torch.gather(cache.tables.to(torch.int64), 1, blk)
    ok = valid & (gpage >= 0)
    return (torch.where(ok, gpage, cache.scratch_page),
            torch.where(ok, pos % page, 0))


def gather_view(cache: PagedKVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense view [L, B, S_view, KV*D] of every slot's pages (a copy;
    unassigned blocks read page 0, as the JAX gather does)."""
    L, KV, _, page, D = cache.k.shape
    B, NB = cache.tables.shape
    idx = cache.tables.to(torch.int64).clamp(min=0)

    def view(pool):
        g = pool[:, :, idx]                           # [L, KV, B, NB, page, D]
        return g.permute(0, 2, 3, 4, 1, 5).reshape(L, B, NB * page, KV * D)
    return view(cache.k), view(cache.v)


def scatter_rows(cache: PagedKVCache, k_view: torch.Tensor, v_view: torch.Tensor,
                 q_positions: torch.Tensor) -> None:
    """Write the rows the forward wrote into the view at ``q_positions``
    [B, T] back into their pages (padding to the scratch page)."""
    L, KV, _, page, D = cache.k.shape
    B, T = q_positions.shape
    S_view = k_view.shape[2]
    gpage, goff = row_slots(cache, q_positions)
    local = torch.clamp(q_positions.to(torch.int64), max=S_view - 1)
    b_idx = torch.arange(B, device=local.device)[:, None].expand(B, T)
    for pool, view in ((cache.k, k_view), (cache.v, v_view)):
        rows = view[:, b_idx, local].view(L, B * T, KV, D).permute(0, 2, 1, 3)
        pool[:, :, gpage.reshape(-1), goff.reshape(-1)] = rows.to(pool.dtype)


def paged_forward(cfg: ModelConfig, params, tokens: torch.Tensor,
                  q_positions: torch.Tensor, cache: PagedKVCache,
                  num_real_tokens: torch.Tensor | int | None = None,
                  kernel_path: str = "xla"):
    """Forward pass reading and writing the page pool in place.

    ``q_positions`` [B, T] are logical positions; padding and idle slots
    carry the view length or more, so their writes drop (the JAX
    ``pad_marker``).  Returns (hidden [B, T, H], cache) with ``lengths``
    advanced by ``num_real_tokens``."""
    from ..models.bitnet import forward, forward_paged_decode, stacked_decode_ok

    B, T = tokens.shape
    if num_real_tokens is None:
        num_real_tokens = T
    if stacked_decode_ok(cfg, params, T, B, kernel_path):
        h = forward_paged_decode(cfg, params, tokens, q_positions, cache,
                                 num_real_tokens)
    else:
        k_view, v_view = gather_view(cache)
        h, k_view, v_view = forward(cfg, params, tokens, q_positions, k_view, v_view,
                                    cache.lengths, num_real_tokens, kernel_path)
        scatter_rows(cache, k_view, v_view, q_positions)
    cache.lengths += num_real_tokens
    return h, cache
