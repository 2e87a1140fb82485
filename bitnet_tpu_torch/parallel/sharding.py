"""Each rank's shard of the parameters and the KV cache: the counterpart of
``bitnet_tpu/parallel/sharding.py:33-236``.

The JAX package annotates the whole tree with PartitionSpecs and lets GSPMD
partition the program.  Here each rank slices its own shard once
(:func:`shard_params`) and the forward pass runs the local shapes, with the
collectives GSPMD implies written out (``ops/linear.py``, ``models/bitnet.py``):

- column-parallel q / k / v / gate / up: the words' N columns (the rank's
  heads and FFN columns), with their column scales; a qk256 linear's
  per-tensor scale stays whole;
- row-parallel o / down: the words' K rows, in whole 256-row granules of
  the int32 words (a granule is one interleave tile), a bitnet32 / TL
  linear's per-32-row block scales with them; qk256 column scales stay
  whole.  Each rank's output is a partial sum, all-reduced over the model
  axis; the norm and the int8 scale of a row take its statistics reduced
  over the axis first;
- the 2B-4T sub-norm gains follow the column-parallel activations;
- an untied ``lm_head`` column-parallel on the vocab, its slices gathered;
  the embedding and a tied head replicated;
- the KV cache: the rank's KV heads, and its rows of the batch on the data
  axis (:func:`allocate_sharded_cache`).

Fused q|k|v and gate|up are refused (:func:`validate_mesh_for`), as in the
JAX package: their column blocks would cut across head boundaries.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..errors import ConfigError, InferenceError
from ..ops.linear import KT_PACK, LinearShard, TernaryLinear
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

# the column block of the kernels: a column-parallel slice of words must be
# whole blocks (``ops/ternary_matmul._check_stack``)
COL_GRANULE = 64

COL_LINEARS = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_LINEARS = ("wo", "w_down")


def _tp(mesh: Mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def _dp(mesh: Mesh) -> int:
    return mesh.shape.get(DATA_AXIS, 1)


def validate_mesh_for(cfg: ModelConfig, batch_size: int, mesh: Mesh,
                      params=None) -> None:
    """The JAX package's checks (``:145-167``): the batch / slot count
    divisible by the data axis, the KV heads by the model axis, unfused
    projections.  And what a rank's slice of the words needs, which the JAX
    package does not check: each sharded dimension of a packed linear whole
    256-row granules (K / tp of o and down) or whole 64-column blocks (N / tp
    of q, k, v, gate, up and an untied head).  The JAX package's comment
    (``:37-41``) holds that K / tp stays whole granules for every BitNet
    shape at tp ≤ 8; the 2B's F = 6912 is not a multiple of 5 · 256, and
    tp ∈ {1, 5} are its only KV splits, so the 2B cannot shard on the model
    axis: here that is a ConfigError, where the JAX package's GSPMD slices
    the words across granules."""
    ndp, ntp = _dp(mesh), _tp(mesh)
    if ndp < 1 or ntp < 1:
        raise ConfigError(f"degenerate mesh shape dp={ndp} tp={ntp}")
    if batch_size % ndp != 0:
        raise ConfigError(
            f"batch/slot count {batch_size} not divisible by data axis {ndp}")
    if cfg.num_kv_heads % ntp != 0:
        raise ConfigError(
            f"num_kv_heads {cfg.num_kv_heads} not divisible by model axis {ntp}")
    if params is None:
        return
    b = params.blocks
    if b.wqkv is not None or b.w_gateup is not None:
        raise ConfigError(
            "mesh sharding requires unfused projections "
            "(EngineConfig(fuse_projections=False))")
    if ntp == 1:
        return
    if cfg.intermediate_size % ntp:
        raise ConfigError(f"intermediate_size {cfg.intermediate_size} not divisible "
                          f"by model axis {ntp}")
    lins = [(n, getattr(b, n), "col") for n in COL_LINEARS]
    lins += [(n, getattr(b, n), "row") for n in ROW_LINEARS]
    if params.lm_head is not None:
        lins.append(("lm_head", params.lm_head, "col"))
    for name, lin, kind in lins:
        dim = lin.n if kind == "col" else lin.k
        if dim % ntp:
            raise ConfigError(f"{name}: {'N' if kind == 'col' else 'K'} = {dim} not "
                              f"divisible by model axis {ntp}")
        if lin.kind == "dense":
            continue
        gran = COL_GRANULE if kind == "col" else KT_PACK
        if (dim // ntp) % gran:
            raise ConfigError(
                f"{name}: {'N' if kind == 'col' else 'K'} / tp = {dim // ntp} is not "
                f"whole {gran}-{'column blocks' if kind == 'col' else 'row granules'} "
                f"of the packed words (model axis {ntp})")


def _slice(t: torch.Tensor | None, dim: int, i: int, n: int):
    if t is None:
        return None
    w = t.shape[dim] // n
    return t.narrow(dim, i * w, w).contiguous()


def shard_linear(lin: TernaryLinear, kind: str, group) -> TernaryLinear:
    """This rank's slice (group index i of n) of a stacked linear:
    ``kind`` ``"col"`` slices N, ``"row"`` K (whole granules: checked by
    :func:`validate_mesh_for`).  Marks the slice with its
    :class:`~..ops.linear.LinearShard`."""
    i, n = group.index, group.size
    full = lin.n if kind == "col" else lin.k
    sh = LinearShard(kind=kind, group=group, full=full)
    if lin.kind == "dense":
        w = lin.weight
        d = w.ndim - (1 if kind == "col" else 2)
        return dataclasses.replace(lin, weight=_slice(w, d, i, n), shard=sh,
                                   k=lin.k if kind == "col" else lin.k // n,
                                   n=lin.n // n if kind == "col" else lin.n)
    stacked = lin.packed.ndim == 3
    if kind == "col":
        nl = lin.n // n
        packed = lin.packed.narrow(-1, i * nl, nl).contiguous()
        scales = lin.scales
        if scales is not None and scales.ndim >= 2 and scales.shape[-1] > 1:
            # per-column (fused qk256) or block scales follow N
            scales = scales.narrow(-1, i * nl, nl).contiguous()
        cs = None if lin.col_scales is None else lin.col_scales.narrow(
            -1, i * nl, nl).contiguous()
        return dataclasses.replace(lin, n=nl, packed=packed, scales=scales,
                                   col_scales=cs, shard=sh)
    if lin.kind == "qk256" and lin.col_scales is not None:
        sh.unit_scales = torch.ones_like(lin.col_scales)
    kl = lin.k // n
    rd = 1 if stacked else 0
    packed = lin.packed.narrow(rd, i * kl // 16, kl // 16).contiguous()
    scales = lin.scales
    if lin.kind in ("bitnet32", "tl"):
        # the per-32-row block scales follow the words' rows
        scales = scales.narrow(rd, i * kl // 32, kl // 32).contiguous()
    return dataclasses.replace(lin, k=kl, packed=packed, scales=scales, shard=sh)


def shard_params(mesh: Mesh, cfg: ModelConfig, params):
    """This rank's shard of prepared parameters (column scales attached,
    unfused), marked with the mesh: ``models/bitnet.forward`` then runs the
    rank's heads and rows, with the model axis's collectives.  Where the
    model axis has one rank (a data-only mesh, or one process), nothing is
    split: the parameters are the model's, unsliced and unmarked, and run
    as the one-process engine runs them (K1 fused)."""
    mg = mesh.axis(MODEL_AXIS)
    if mg.size == 1:
        return dataclasses.replace(params, mesh=mesh)
    b = params.blocks
    n, i = mg.size, mg.index
    blocks = dataclasses.replace(b, **{
        name: shard_linear(getattr(b, name), "col", mg) for name in COL_LINEARS
        if getattr(b, name) is not None})
    blocks = dataclasses.replace(blocks, **{
        name: shard_linear(getattr(b, name), "row", mg) for name in ROW_LINEARS})
    # the sub-norm gains follow the column-parallel activations
    if b.attn_sub_norm is not None:
        blocks.attn_sub_norm = _slice(b.attn_sub_norm, 1, i, n)
    if b.ffn_sub_norm is not None:
        blocks.ffn_sub_norm = _slice(b.ffn_sub_norm, 1, i, n)
    lm_head = params.lm_head
    if lm_head is not None:
        lm_head = shard_linear(lm_head, "col", mg)
    return dataclasses.replace(params, blocks=blocks, lm_head=lm_head, mesh=mesh)


def allocate_sharded_cache(mesh: Mesh, cfg: ModelConfig, batch_size: int,
                           max_seq_len: int, dtype: str = "bf16", device=None):
    """The rank's own flat cache ``[L, B / dp, S, (KV / tp) · D]`` (and a
    1-byte cache's scales), allocated on its device directly: the whole
    pool is never allocated first (``:170-197``)."""
    from ..engine.cache import allocate_cache

    return allocate_cache(mesh.local_cfg(cfg), batch_size // _dp(mesh), max_seq_len,
                          dtype, device=mesh.device if device is None else device)


def allocate_sharded_paged_cache(mesh: Mesh, cfg: ModelConfig, batch_size: int,
                                 num_pages: int, page_size: int = 16,
                                 max_blocks_per_seq: int | None = None,
                                 dtype: str = "bf16", device=None):
    """The rank's page pool (``:200-236``): the KV heads on the model axis,
    the pages, block tables and lengths whole on every rank of the data
    axis (pages have no batch identity: the JAX pool is replicated over
    ``data``, so its data shards compute the same pool step)."""
    from ..engine.paged_cache import allocate_paged_cache

    if dtype in ("int8", "fp8"):
        raise InferenceError("paged cache: quantized pages not yet supported")
    if max_blocks_per_seq is None:
        max_blocks_per_seq = num_pages
    return allocate_paged_cache(mesh.local_cfg(cfg), batch_size, num_pages, page_size,
                                max_blocks_per_seq, dtype,
                                device=mesh.device if device is None else device)
