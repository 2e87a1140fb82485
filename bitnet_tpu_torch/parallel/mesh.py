"""Meshes of ranks: the counterpart of ``bitnet_tpu/parallel/mesh.py:24-52``.

The JAX package builds one ``jax.sharding.Mesh`` over the devices of one
controller and lets GSPMD place the collectives.  PyTorch on GPUs runs one
process per card with ``torch.distributed`` between them, so here a mesh
is a set of ranks, each with its own device, and one process group per
axis (:class:`~.comm.Group`).  Every rank runs the same program on its own
shard (SPMD, as the JAX multi-host path already is).

Axes: ``data`` (batch / slot parallelism) and ``model`` (tensor
parallelism), laid out as the JAX ``(dp, tp)`` device array: rank
``d * tp + m`` is data index d, model index m, so a model group is ``tp``
consecutive ranks (inside a host, ``multihost.host_mesh``).  The pipeline
and sequence modes build one-axis meshes (``stage``, ``seq``) over the
same ranks.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..errors import ConfigError
from .comm import Group

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """A named-axis mesh over ``torch.distributed`` ranks.  ``axes`` maps
    each axis to this rank's :class:`Group` on it, ``world`` is the group of
    every rank of the mesh, ``device`` this rank's device."""

    axes: dict
    world: Group
    device: torch.device

    @property
    def shape(self) -> dict:
        return {name: g.size for name, g in self.axes.items()}

    def axis(self, name: str) -> Group:
        return self.axes[name]

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def live(self) -> bool:
        """Whether the mesh's collectives go through ``torch.distributed``."""
        return self.world.live

    # -- the (data, model) mesh's view of one rank's work ---------------------
    def local_cfg(self, cfg):
        """The model as one rank of the model axis runs it: its query and
        KV heads and FFN columns (``num_heads / tp``, ``num_kv_heads / tp``,
        ``intermediate_size / tp``); the rest is the model's."""
        tp = self.shape.get(MODEL_AXIS, 1)
        if tp == 1:
            return cfg
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                   num_kv_heads=cfg.num_kv_heads // tp,
                                   intermediate_size=cfg.intermediate_size // tp)

    def data_rows(self, t, n_local: int):
        """This data rank's rows of a batch-major tensor of the whole batch
        (``dp · n_local`` rows); anything else (a local tensor, an int)
        as it is."""
        g = self.axes.get(DATA_AXIS)
        if (g is None or g.size == 1 or not isinstance(t, torch.Tensor) or t.ndim == 0
                or t.shape[0] != g.size * n_local):
            return t
        return t[g.index * n_local:(g.index + 1) * n_local]

    def gather_rows(self, t):
        """The whole batch from each data rank's rows (an all-gather over the
        data axis; the identity at dp = 1)."""
        g = self.axes.get(DATA_AXIS)
        return t if g is None or g.size == 1 else g.all_gather(t.contiguous(), dim=0)


def world() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed``, (0, 1) without it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(rank: int | None = None, device="cuda") -> torch.device:
    """This rank's device: the card unless the caller asks for ``"cpu"``
    (without a card a ``ConfigError``, never a silent CPU run).  A card
    named without an index is ``cuda:$LOCAL_RANK``, else ``cuda:(rank mod
    the card count)``; ranks that share a card (gloo) get the same one."""
    from ..device_probe import resolve_device

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        if "LOCAL_RANK" in os.environ:
            idx = int(os.environ["LOCAL_RANK"])
        else:
            idx = world()[0] if rank is None else rank
        dev = torch.device("cuda", idx % torch.cuda.device_count())
    return resolve_device(dev)


def _groups(ranks_of, n_groups: int):
    """Create one process group per entry (every rank must call this for
    every group, in the same order); return ``pg``s by group index."""
    import torch.distributed as dist

    return [dist.new_group(ranks_of(i)) for i in range(n_groups)]


def make_axes(shape: list[tuple[str, int]], device="cuda") -> Mesh:
    """A mesh of the named axes over ranks ``0 … Π sizes − 1`` (row-major:
    the last axis varies fastest), on this rank's card unless the caller
    asks for the CPU (:func:`rank_device`).  Needs ``torch.distributed``
    initialized with that many ranks, except for a mesh of one rank, which
    a single process builds without it."""
    import torch.distributed as dist

    names = [n for n, _ in shape]
    sizes = [s for _, s in shape]
    if any(s < 1 for s in sizes):
        raise ConfigError(f"degenerate mesh shape {dict(shape)}")
    n = 1
    for s in sizes:
        n *= s
    rank, wsize = world()
    dev = rank_device(rank, device)
    if wsize == 1 and not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise ConfigError(
                f"a mesh of {n} ranks needs torch.distributed initialized with "
                f"{n} processes, one a rank (parallel.multihost.init_distributed); "
                "this is a single process")
        axes = {nm: Group([0], 0) for nm in names}
        return Mesh(axes, Group([0], 0), dev)
    if n != wsize:
        raise ConfigError(f"mesh {dict(shape)} has {n} ranks, torch.distributed "
                          f"has {wsize}")
    backend = dist.get_backend()
    coords = []
    r = rank
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    coords = coords[::-1]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    axes = {}
    for a, (nm, s) in enumerate(shape):
        # the groups along axis a: all other coordinates fixed
        others = [i for i in range(n) if (i // strides[a]) % s == 0]

        def members(base, a=a, s=s):
            return [base + j * strides[a] for j in range(s)]
        pgs = _groups(lambda g: members(others[g]), len(others))
        base = rank - coords[a] * strides[a]
        g = others.index(base)
        axes[nm] = Group(members(base), coords[a], pgs[g], backend)
    wpg = dist.new_group(list(range(n)))
    return Mesh(axes, Group(list(range(n)), rank, wpg, backend), dev)


def make_mesh(dp: int | None = None, tp: int | None = None,
              device="cuda") -> Mesh:
    """A (data, model) mesh, ``make_mesh``'s defaults: tp = every rank,
    dp = 1.  ``dp * tp`` must equal the world size."""
    _, n = world()
    if tp is None and dp is None:
        dp, tp = 1, n
    elif tp is None:
        tp = max(1, n // dp)
    elif dp is None:
        dp = max(1, n // tp)
    return make_axes([(DATA_AXIS, dp), (MODEL_AXIS, tp)], device)


def single_device_mesh(device="cuda") -> Mesh:
    """The (1, 1) mesh of this process alone (no process group is used), on
    the card unless the caller asks for the CPU."""
    dev = rank_device(0, device)
    return Mesh({DATA_AXIS: Group([0], 0), MODEL_AXIS: Group([0], 0)},
                Group([0], 0), dev)
