"""K33: paged decode attention (``csrc/paged_attention.cu``).

Counterpart of JAX's stock Pallas kernel
``jax.experimental.pallas.ops.tpu.paged_attention`` (its ``pallas_call``
sits in the JAX library; the repo calls it at
``experiments/exp_r4_attn.py:63-88``).  One kernel serves two call sites:
the ``paged`` variant of :mod:`bitnet_tpu_torch.experiments.exp_r4_attn`
(128-row pages in the stock layout ``[KV, P, page, D]``) and the paged
scheduler's decode step (``models/bitnet._decode_stacked`` under the
``paged`` plan), whose pool ``[L, KV, P, page, D]`` hands the kernel one
layer's ``[KV, P, page, D]`` view.

The function: for each slot b and query head h, attention of ``q[b, h]``
over the positions ``p < lengths[b]`` of kv head ``h // (H / KV)``, the
row of position p read from page ``page_indices[b, p // page]`` at offset
``p % page``; no softmax scale (the caller scales q); masked positions
weigh nothing (the stock ``mask_value`` is added and underflows once one
position is valid); a slot of length 0 gives zeros.  The output has q's
dtype; every sum is f32.  Two cases the stock kernel leaves undefined
take the JAX paged gather's meaning (``bitnet_tpu/engine/paged_cache.py:
225-228``), which the scheduler's K-step windows reach when a slot runs
past the pages it will use: a negative (unassigned) table entry reads page
0, and positions past the table's reach (pages a slot × page) are not
attended.

On f32 pages K33 (and its plain version) reads k and v at f32, which the
scheduler's JAX reference wants (it attends over a dense f32 view it
gathers, ``bitnet_tpu/engine/paged_cache.py``); the stock kernel rounds f32
pages to bf16 before its dots (``paged_attention_kernel.py:94-109``:
``wait_and_get_loaded`` → ``_maybe_dequantize`` → ``astype(bfloat16)``), so
on f32 pages the stock kernel is this function over bf16-rounded pages.

:func:`paged_attention` runs :func:`paged_attention_plain` (gather, mask,
softmax in PyTorch) for CPU tensors only; for CUDA tensors it launches K33
(one kernel a call: a TMA page ring, tensor-core products over bf16 pages,
the splits combined in the same launch through the device's arrival
counters, ``decode_attention.attn_counters``) or raises.  The launch count
is per call.
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_attention import ATTN_COUNTERS, _sm_count, attn_counters

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
PAGED_MIN_ROWS = 64          # the least positions a split
PAGED_MAX_SPLITS = 64


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, lengths: torch.Tensor,
                          page_indices: torch.Tensor) -> torch.Tensor:
    """The function in PyTorch: gather each slot's pages into
    ``[B, KV, S, D]``, add ``MASK_VALUE`` at positions >= length, softmax
    in f32, weighted sum of the values; q's dtype out."""
    B, H, D = q.shape
    KV, _, page, _ = k_pages.shape
    G = H // KV
    npg = page_indices.shape[1]
    idx = page_indices.to(torch.int64).clamp(min=0)
    # [KV, B, npg, page, D] -> [B, KV, npg*page, D]
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KV, npg * page, D)
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KV, npg * page, D)
    qf = q.to(torch.float32).view(B, KV, G, D)
    s = torch.einsum("bkgd,bktd->bkgt", qf, k.to(torch.float32))
    pos = torch.arange(npg * page, device=q.device)
    valid = pos[None, :] < lengths.to(torch.int64)[:, None]            # [B, S]
    s = s + torch.where(valid, 0.0, MASK_VALUE)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.to(torch.float32))
    out = torch.where((lengths > 0).view(B, 1, 1, 1), out, 0.0)
    return out.reshape(B, H, D).to(q.dtype)


def paged_plan(B: int, KV: int, S: int, sms: int) -> tuple[int, int]:
    """(splits, R): positions a split R, the least power of two >=
    ``PAGED_MIN_ROWS`` whose B·KV·⌈S/R⌉ blocks fit two to an SM and give at
    most ``PAGED_MAX_SPLITS`` splits; S is the table's reach (pages a slot ×
    page), so the plan depends on shapes only and a CUDA graph keeps it."""
    R = PAGED_MIN_ROWS
    while R < S and (B * KV * -(-S // R) > 2 * sms or -(-S // R) > PAGED_MAX_SPLITS):
        R *= 2
    return max(1, -(-S // R)), R


def _check(q, k_pages, v_pages, lengths, page_indices):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"K33 takes q [B, H, D] and pages [KV, P, page, D]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, D = q.shape
    KV = k_pages.shape[0]
    if H % KV != 0 or k_pages.shape[-1] != D:
        raise ValueError(f"K33: {H} query heads over {KV} kv heads of "
                         f"{k_pages.shape[-1]} values, q of {D}")
    if lengths.shape != (B,) or page_indices.dim() != 2 or page_indices.shape[0] != B:
        raise ValueError("K33: lengths [B] and page_indices [B, pages] of q's batch")
    if q.dtype not in (torch.bfloat16, torch.float32) or k_pages.dtype not in (
            torch.bfloat16, torch.float32) or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"K33 takes bf16 / f32 q and pages, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    lengths: torch.Tensor, page_indices: torch.Tensor) -> torch.Tensor:
    """K33: out [B, H, D] in q's dtype (module docstring)."""
    _check(q, k_pages, v_pages, lengths, page_indices)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths, page_indices)
    B, H, D = q.shape
    KV, _, page, _ = k_pages.shape
    if D not in (64, 128) or H // KV > 8:
        raise ValueError(f"K33's kernel takes D 64 / 128 and at most 8 query heads "
                         f"a kv head; got D={D}, G={H // KV}")
    esz = k_pages.element_size()
    if (k_pages.stride() != v_pages.stride() or k_pages.stride(-1) != 1
            or any(st * esz % 16 for st in k_pages.stride()[:3])
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16):
        raise ValueError(f"K33 maps the pages through TMA: k and v of one layout, D "
                         f"contiguous, 16-byte aligned, strides multiples of 16 bytes; "
                         f"got strides {k_pages.stride()} / {v_pages.stride()} of "
                         f"{esz}-byte elements")
    if (lengths.dtype != torch.int32 or page_indices.dtype != torch.int32
            or page_indices.stride(-1) != 1 or not lengths.is_contiguous()):
        raise ValueError("K33: int32 lengths and an int32 table of contiguous rows")
    if B * KV > ATTN_COUNTERS:
        raise ValueError(f"K33: B*KV = {B * KV} exceeds the {ATTN_COUNTERS} arrival "
                         "counters")
    dev = q.device
    q = q.contiguous()
    npg = page_indices.shape[1]
    splits, R = paged_plan(B, KV, npg * page, _sm_count(dev.index))
    out = torch.empty_like(q)
    part = (torch.empty(B * H * splits * (D + 2), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    sk = k_pages.stride()
    lib = _cuda.library("paged_attention")
    rc = lib.bn_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
        page_indices.data_ptr(), page_indices.stride(0), npg, B, H, KV, D,
        k_pages.shape[1], page, sk[0], sk[1], sk[2], R, int(q.dtype == torch.float32),
        int(k_pages.dtype == torch.float32), out.data_ptr(),
        None if part is None else part.data_ptr(), attn_counters(dev).data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(lib, "paged_attention", rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
