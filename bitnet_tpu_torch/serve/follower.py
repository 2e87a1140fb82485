"""Multi-rank serving: the control channel and the followers' loop (the
counterpart of ``bitnet_tpu/serve/follower.py:42-105``).

Every scheduler decision (admission, sampling, eviction) is host state that
lives only on the frontend (rank 0).  What every rank must do alike are the
device calls over the sharded weights and cache, whose collectives pair the
ranks: a slot's prefill, its length, its bias row, a pool step.  Before each
the frontend sends a small record over :class:`ControlChannel`; the other
ranks sit in ``ContinuousBatchingScheduler.follow`` and replay it on their
own shard.  Device values never cross the channel.
"""

from __future__ import annotations

import pickle
import time

import torch

_MAGIC = b"bnt1"


class ControlChannel:
    """Frontend → follower broadcast of pickled records over a gloo group
    of every rank (host tensors, whatever the mesh's backend): one
    broadcast of the length, then one of the payload, which starts with a
    magic.  Every rank builds its channel at the same point of its program
    (the group's creation is collective); each ``send`` on rank 0 pairs
    with one ``recv`` on every other rank."""

    def __init__(self) -> None:
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.primary = self.rank == 0
        self.pg = dist.new_group(list(range(dist.get_world_size())), backend="gloo")
        self.last_send = time.time()

    def _bc(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.broadcast(t, 0, group=self.pg)
        return t

    def send(self, record: tuple) -> None:
        assert self.primary, "only the frontend sends control records"
        payload = _MAGIC + pickle.dumps(record)
        self._bc(torch.tensor([len(payload)], dtype=torch.int64))
        self._bc(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
        self.last_send = time.time()

    def recv(self) -> tuple:
        assert not self.primary, "the frontend does not recv"
        n = int(self._bc(torch.zeros(1, dtype=torch.int64))[0])
        raw = self._bc(torch.empty(n, dtype=torch.uint8)).numpy().tobytes()
        if raw[:4] != _MAGIC:
            raise RuntimeError("control channel desync: bad record magic")
        return pickle.loads(raw[4:])


def worker_loop(model_path: str, engine_cfg, num_slots: int, mesh=None,
                tp: int | None = None, device="cuda") -> None:
    """A follower's whole life (blocking): the same mesh, channel and
    scheduler as the frontend's, built in the same order (their process
    groups are made collectively), the model loaded from its own copy of
    the file onto this rank's card (the CPU only where the caller asks for
    it), then :meth:`follow` until ``stop``.  ``mesh``, where given, fixes
    the device."""
    from ..models.loader import load_model
    from ..parallel.multihost import host_mesh
    from .scheduler import ContinuousBatchingScheduler

    if mesh is None:
        mesh = host_mesh(tp=tp, device=device)
    channel = ControlChannel()
    dev = mesh.device
    cfg, params, _ = load_model(model_path, param_dtype=(
        torch.float32 if engine_cfg.compute_dtype == "f32" else torch.bfloat16),
        device=dev)
    if engine_cfg.max_seq_len > cfg.max_seq_len:
        # the frontend's clamp: the ranks' shapes must agree
        engine_cfg = engine_cfg.replace(max_seq_len=cfg.max_seq_len)
    sched = ContinuousBatchingScheduler(
        cfg, params, None, engine_cfg, num_slots=num_slots, mesh=mesh,
        channel=channel, start_loop=False, device=dev)
    sched.follow()
