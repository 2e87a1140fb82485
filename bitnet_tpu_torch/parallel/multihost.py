"""Joining a group of ranks: the counterpart of
``bitnet_tpu/parallel/multihost.py:56-231``.

The JAX package joins every host's devices into one pool with
``jax.distributed.initialize`` and one process a host.  Here a process
drives one card (a rank), so a cluster is ``torch.distributed`` over one
process a card, and the mesh puts tensor-parallel groups inside a host
(consecutive ranks) and the data axis across hosts.

Launch contract (one process a rank; the port's own rank numbering)::

    BITNET_COORDINATOR=host0:8476 BITNET_NUM_PROCESSES=4 \\
    BITNET_PROCESS_ID=$RANK LOCAL_RANK=$LOCAL LOCAL_WORLD_SIZE=4 \\
    python -m bitnet_tpu_torch.cli serve -m m.gguf --shard 1,4

``BITNET_COORDINATOR`` is ``host:port`` (TCP) or a ``file://`` path (a
``FileStore``, for ranks of one host).  The backend is NCCL where CUDA is
there, or ``BITNET_DIST_BACKEND`` (``gloo`` lets ranks share a card:
NCCL refuses two ranks on one GPU); nothing falls back from one to the
other.  On one host, ``serve --shard DP,TP`` without a coordinator starts
its dp·tp − 1 followers itself (``serve/server.py``).

Programmatically::

    from bitnet_tpu_torch.parallel.multihost import init_distributed, host_mesh
    init_distributed()                 # env-driven
    mesh = host_mesh(tp=4)             # dp = ranks / 4

CPU validation: :func:`dryrun_multihost` runs gloo processes on the CPU.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import textwrap

import torch

from ..errors import ConfigError
from .mesh import Mesh, make_mesh, rank_device, world

COORD_ENV = "BITNET_COORDINATOR"
NPROC_ENV = "BITNET_NUM_PROCESSES"
PID_ENV = "BITNET_PROCESS_ID"
BACKEND_ENV = "BITNET_DIST_BACKEND"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 1800.0, device="cuda") -> bool:
    """Join the group of ranks (a no-op for one process).

    Arguments default to ``BITNET_COORDINATOR`` / ``BITNET_NUM_PROCESSES``
    / ``BITNET_PROCESS_ID`` / ``BITNET_DIST_BACKEND``.  Returns True when
    ``torch.distributed`` is on (already initialized counts).  The ranks
    run on the card unless the caller asks for ``device="cpu"``: without a
    card that is a ``ConfigError`` before any group is joined.  The backend
    is NCCL on the card and gloo on the CPU unless named (gloo lets ranks
    share a card; NCCL takes no CPU rank).  Under NCCL the rank's card is
    made current first (``LOCAL_RANK``, else the rank mod the card count)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(COORD_ENV)
    if coordinator_address is None:
        return False
    n = num_processes if num_processes is not None else int(
        os.environ.get(NPROC_ENV, "1"))
    pid = process_id if process_id is not None else int(os.environ.get(PID_ENV, "0"))
    dev = rank_device(pid, device)
    backend = backend or os.environ.get(BACKEND_ENV) or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ConfigError("NCCL takes ranks on the card; the CPU needs gloo")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init, world_size=n, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE``, else the card count (one
    rank a card), else every rank (the CPU)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    _, n = world()
    return min(n, torch.cuda.device_count()) if torch.cuda.is_available() else n


def host_mesh(tp: int | None = None, dp: int | None = None, device="cuda") -> Mesh:
    """The (data, model) mesh over every rank with tensor parallelism
    inside a host: a model group is ``tp`` consecutive ranks of one host,
    the data axis spans hosts.  On the card unless the caller asks for the
    CPU."""
    rank_device(None, device)        # no card and no "cpu": refuse first
    _, n = world()
    local = local_world_size()
    if tp is None:
        tp = local if dp is None else n // dp
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    if tp > local or local % tp != 0:
        raise ValueError(
            f"tp={tp} must divide the {local} ranks of a host so a model group "
            f"stays inside one (got {n} ranks)")
    return make_mesh(dp=dp, tp=tp, device=device)


def is_primary() -> bool:
    """True on the frontend (rank 0: the server and the scheduler)."""
    return world()[0] == 0


# ---------------------------------------------------------------------------
# CPU dryrun: gloo processes over a FileStore, one sharded prefill
# ---------------------------------------------------------------------------
_WORKER = textwrap.dedent("""
    import os, sys
    pid, nproc, store, tp, root, model = (int(sys.argv[1]), int(sys.argv[2]),
                                          sys.argv[3], int(sys.argv[4]),
                                          sys.argv[5], sys.argv[6])
    sys.path.insert(0, root)
    import torch
    from bitnet_tpu_torch.parallel.multihost import init_distributed, host_mesh
    init_distributed("file://" + store, nproc, pid, backend="gloo", device="cpu")
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    mesh = host_mesh(tp=tp, device="cpu")
    dp = mesh.shape["data"]
    eng = InferenceEngine.from_gguf(model, EngineConfig(
        max_seq_len=32, max_batch_size=2 * dp, compute_dtype="f32",
        kv_cache_dtype="f32"), device="cpu")
    eng.shard_to_mesh(mesh)
    B, T = 2 * dp, 8
    toks = [[t % eng.cfg.vocab_size for t in range(T)] for _ in range(B)]
    lg = eng.prefill_batch(toks)
    nxt = torch.argmax(lg, -1).tolist()
    if pid == 0:
        print("MULTIHOST_TOKENS", ",".join(map(str, nxt)), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
""")


def dryrun_multihost(model: str, num_processes: int = 2, tp: int = 2,
                     repo_root: str | None = None, timeout_s: float = 240.0) -> list[int]:
    """Spawn ``num_processes`` gloo processes on the CPU (a FileStore, no
    port) and run one sharded prefill of the GGUF ``model`` (a mini: its
    dimensions must split into whole granules at ``tp``).  Returns rank 0's
    next-token ids; raises on failure."""
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), str(num_processes), store,
             str(tp), repo_root, model],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
            for pid in range(num_processes)]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError("multihost dryrun timed out")
            outs.append((p.returncode, out.decode(), err.decode()))
    for rc, _out, err in outs:
        if rc != 0:
            raise RuntimeError(f"multihost worker failed (rc={rc}): {err[-800:]}")
    for _rc, out, _err in outs:
        for line in out.splitlines():
            if line.startswith("MULTIHOST_TOKENS"):
                return [int(t) for t in line.split()[1].split(",")]
    raise RuntimeError("no MULTIHOST_TOKENS line from rank 0")
