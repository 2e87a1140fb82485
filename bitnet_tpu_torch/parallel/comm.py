"""The collectives of the parallel modes, over ``torch.distributed``.

The JAX package names four collectives and leaves their transport to XLA:
``psum`` (GSPMD's implied all-reduce, and the sequence modes'),
``all_gather``, ``ppermute`` (the ring shift of the pipeline and ring
modes) and ``broadcast_one_to_all`` (the multi-host control channel).  A
:class:`Group` gives the same four over one process group of the port's
one-process-per-rank design (``parallel/mesh.py``):

- ``all_reduce(t, "sum" | "max")`` in place;
- ``all_gather(t, dim)`` → the ranks' tensors concatenated along ``dim``;
- ``ring_shift(t)`` → the tensor of the rank before this one (rank r
  sends to r + 1 mod n), the JAX ``ppermute`` of ``[(i, (i + 1) % n)]``;
- ``broadcast(t, src)`` in place, ``src`` the group-local index.

The transport is the process group's backend, chosen by the caller
(``parallel/multihost.init_distributed``).  NCCL takes CUDA tensors.
gloo takes CPU tensors, and CUDA tensors only in ``all_reduce`` and
``broadcast``: under gloo every other op on a CUDA tensor is staged through
host memory here.  Every gloo op on a CUDA tensor goes through host memory
(gloo's own copies for ``all_reduce`` and ``broadcast``, this module's for
the rest) and counts as staged (:func:`stats`).  Nothing switches from one
backend to the other by itself.

A group of one rank with no process group (a single process, no
``torch.distributed``) is the identity.
"""

from __future__ import annotations

import time

import torch

# ops issued, ops staged through the host, and (with timing on) the
# seconds spent in them, device work before each op synchronized out
_STATS = {"ops": 0, "staged": 0, "seconds": 0.0, "staged_seconds": 0.0}
_TIMING = [False]


def stats() -> dict:
    """A copy of the counters: ``ops``, ``staged`` (host-staged ops),
    ``seconds`` and ``staged_seconds`` (only while :func:`timing` is on)."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(ops=0, staged=0, seconds=0.0, staged_seconds=0.0)


def timing(on: bool) -> None:
    """Time every op (a device synchronize before and after each one):
    for measurements only, it serializes the stream."""
    _TIMING[0] = bool(on)


class Group:
    """One axis of a mesh: ``ranks`` (global ranks, in axis order),
    ``index`` (this process's place in them), the process group ``pg``
    (None for a single process) and its backend name."""

    def __init__(self, ranks: list[int], index: int, pg=None,
                 backend: str | None = None):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.pg = pg
        self.backend = backend

    def __repr__(self) -> str:
        return (f"Group(ranks={self.ranks}, index={self.index}, "
                f"backend={self.backend})")

    @property
    def live(self) -> bool:
        """Whether ops go through ``torch.distributed``."""
        return self.pg is not None

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def _run(self, staged: bool, fn):
        _STATS["ops"] += 1
        _STATS["staged"] += staged
        if not _TIMING[0]:
            return fn()
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _STATS["seconds"] += dt
        if staged:
            _STATS["staged_seconds"] += dt
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the group in place (``sum`` or ``max``)."""
        import torch.distributed as dist

        if not self.live:
            return t
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run(self._staged(t),
                         lambda: (dist.all_reduce(t, rop, group=self.pg), t)[1])

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of group index ``src`` on every rank, in place."""
        import torch.distributed as dist

        if not self.live:
            return t
        return self._run(self._staged(t), lambda: (
            dist.broadcast(t, self.ranks[src], group=self.pg), t)[1])

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along ``dim``."""
        import torch.distributed as dist

        if not self.live:
            return t
        staged = self._staged(t)

        def run():
            src = (t.cpu() if staged else t).contiguous()
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.pg)
            out = torch.cat(parts, dim=dim)
            return out.to(t.device) if staged else out
        return self._run(staged, run)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor of the rank before this one: rank r sends ``t`` to
        r + 1 (mod n) and receives from r - 1."""
        import torch.distributed as dist

        if not self.live or self.size == 1:
            return t
        staged = self._staged(t)

        def run():
            src = (t.cpu() if staged else t).contiguous()
            buf = torch.empty_like(src)
            nxt = self.ranks[(self.index + 1) % self.size]
            prv = self.ranks[(self.index - 1) % self.size]
            ops = [dist.P2POp(dist.isend, src, nxt, group=self.pg),
                   dist.P2POp(dist.irecv, buf, prv, group=self.pg)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return buf.to(t.device) if staged else buf
        return self._run(staged, run)
