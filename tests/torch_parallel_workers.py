"""Ranks of the port's parallel modes for the CPU tests: a group of gloo
processes (a ``FileStore`` under the test's temporary directory, no port)
runs named legs and saves each rank's results.  Imports torch and the port
only, never JAX: the tests compare the saved results with the JAX package
in their own process.

``run_group(n, legs, args, out_dir)`` starts ``n`` processes of this file
and returns each rank's ``{leg: result}`` (a leg that raised holds
``{"error": traceback}``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROMPTS = [[2, 7, 11, 5], [3, 9, 1], [40, 41, 2, 6], [9, 10]]
SERVE_PROMPTS = ([1, 7, 20, 3], [3, 5, 8], [2, 9, 4])
SCHED_PROMPTS = [[2, 7, 11], [3, 5, 8, 12], [40, 41], [9, 10, 12]]


def run_group(n: int, legs: list[str], args: dict, out_dir: str,
              timeout_s: float = 240.0) -> list[dict]:
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"n": n, "legs": legs, "args": args, "out": out_dir,
                   "store": os.path.join(out_dir, "store")}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "2", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([REPO, os.path.dirname(__file__)])}
    procs = [subprocess.Popen([sys.executable, __file__, spec, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout_s)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("parallel group timed out:\n" + "\n".join(logs))
    out = []
    for r in range(n):
        path = os.path.join(out_dir, f"rank{r}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} saved nothing:\n{logs[r][-3000:]}")
        out.append(torch.load(path, weights_only=False))
    return out


# --------------------------------------------------------------------------
# the legs (run in every rank of the group)
# --------------------------------------------------------------------------
def _engine(path, kp, B, dtype="f32", **kw):
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine

    return InferenceEngine.from_gguf(path, EngineConfig(
        max_seq_len=64, max_batch_size=B, compute_dtype=dtype, kv_cache_dtype=dtype,
        kernel_path=kp, **kw), device="cpu")


def leg_tp(args, dp=1, tp=2):
    """The sharded engine on each kernel path: a prefill's logits at every
    position and one decode step's (``forward_cache``, the JAX tests'
    step), a greedy generation, and at dp > 1 a ``generate_batch``."""
    import numpy as np

    from bitnet_tpu_torch.config import GenerationConfig
    from bitnet_tpu_torch.models.bitnet import forward_cache, logits

    out = {}
    B, T = 2 * dp, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (B, T)))
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T).contiguous()
    for kp in ("xla", "w2a8", "pallas"):
        eng = _engine(args["qk"], kp, B).shard_to_mesh(dp=dp, tp=tp)
        h, cache = forward_cache(eng.cfg, eng.params, toks, pos, eng.cache, T, kp)
        lg = logits(eng.cfg, eng.params, h, kp)
        nxt = torch.argmax(lg[:, -1], -1)
        h2, _ = forward_cache(eng.cfg, eng.params, nxt[:, None].int(),
                              torch.full((B, 1), T, dtype=torch.int32), cache, 1, kp)
        r = {"prefill": lg, "decode": logits(eng.cfg, eng.params, h2, kp),
             "tokens": eng.generate([2, 7, 11], GenerationConfig(
                 max_new_tokens=6, greedy=True)).token_ids,
             "local_k": tuple(eng.cache.k.shape),
             "row_marked": eng.params.blocks.wo.shard is not None}
        if dp > 1:
            r["batch"] = [g.token_ids for g in eng.generate_batch(
                PROMPTS[:B], GenerationConfig(max_new_tokens=4, greedy=True))]
        out[kp] = r
    return out


def leg_dptp(args):
    return leg_tp(args, dp=2, tp=2)


def leg_dp(args):
    return leg_tp(args, dp=2, tp=1)


def leg_paged(args):
    """The page pool over the model axis: a sharded pool and weights, two
    prompts' prefill then two decode steps through ``paged_forward``."""
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel import make_mesh
    from bitnet_tpu_torch.parallel.sharding import (allocate_sharded_paged_cache,
                                                    shard_params, validate_mesh_for)

    cfg, params, _ = load_model(args["qk"], param_dtype=torch.float32, device="cpu")
    mesh = make_mesh(dp=1, tp=2, device="cpu")
    validate_mesh_for(cfg, 2, mesh, params)
    params = shard_params(mesh, cfg, params)
    return paged_run(cfg, params, allocate_sharded_paged_cache(
        mesh, cfg, 2, num_pages=8, page_size=8, max_blocks_per_seq=4, dtype="f32"))


def paged_run(cfg, params, cache_pool):
    """Prefill two prompts into fresh pages, then two greedy decode steps;
    the logits of each call.  Shared with the unsharded reference."""
    from bitnet_tpu_torch.engine.paged_cache import paged_forward
    from bitnet_tpu_torch.models.bitnet import logits

    cache, pool = cache_pool
    tables = torch.full_like(cache.tables, -1)
    for b in range(2):
        tables[b, :4] = torch.tensor(pool.alloc(4), dtype=torch.int32)
    cache.tables.copy_(tables)
    T = 4
    toks = torch.tensor([p[:T] + [0] * (T - len(p[:T])) for p in PROMPTS[:2]])
    n = torch.tensor([min(T, len(p)) for p in PROMPTS[:2]], dtype=torch.int32)
    pos = torch.where(torch.arange(T)[None] < n[:, None], torch.arange(T)[None],
                      torch.tensor(cache.view_len))
    h, cache = paged_forward(cfg, params, toks, pos, cache, n, "xla")
    out = [logits(cfg, params, h)]
    nxt = torch.argmax(out[0][torch.arange(2), n.long() - 1], -1)
    for _ in range(2):
        p = cache.lengths.clone()
        h, cache = paged_forward(cfg, params, nxt[:, None].int(), p[:, None], cache, 1,
                                 "xla")
        out.append(logits(cfg, params, h))
        nxt = torch.argmax(out[-1][:, -1], -1)
    return out


def leg_pipeline(args):
    import numpy as np

    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel.pipeline import (make_pipeline_mesh, pipeline_forward,
                                                    shard_pipeline_params)

    cfg, params, _ = load_model(args["f32"], param_dtype=torch.float32, device="cpu")
    mesh = make_pipeline_mesh(2, device="cpu")
    pp = shard_pipeline_params(mesh, cfg, params)
    out = {}
    for name, (B, T, S, M, seed) in {"m2": (4, 6, 32, 2, 1), "m1": (2, 4, 16, 1, 2)}.items():
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, T)).astype(np.int64))
        pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T).contiguous()
        L = pp.blocks.attn_norm.shape[0]
        kc = torch.zeros((L, B, S, cfg.num_kv_heads * cfg.head_dim))
        vc = torch.zeros_like(kc)
        lg, kc, vc = pipeline_forward(cfg, pp, toks, pos, kc, vc,
                                      torch.zeros(B, dtype=torch.int32), mesh, M)
        out[name] = {"logits": lg, "k": kc, "v": vc}
    return out


def _seq_legs(args, prefill):
    import dataclasses

    import numpy as np

    from bitnet_tpu_torch.models.bitnet import fuse_block_params
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel.sequence import make_seq_mesh

    mesh = make_seq_mesh(2, device="cpu")
    out = {}
    cfg, params, _ = load_model(args["f32"], param_dtype=torch.float32, device="cpu")
    sn_cfg, sn, _ = load_model(args["sn"], param_dtype=torch.float32, device="cpu")
    sn = dataclasses.replace(sn, blocks=fuse_block_params(sn.blocks))
    assert sn.blocks.wqkv is not None and sn.blocks.attn_sub_norm is not None
    for name, (c, p, B, T, seed) in {"dense": (cfg, params, 2, 16, 4),
                                     "long": (cfg, params, 1, 32, 8),
                                     "fused": (sn_cfg, sn, 2, 16, 11)}.items():
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, c.vocab_size, (B, T)).astype(np.int64))
        lg, k, v = prefill(c, p, toks, mesh)
        out[name] = {"logits": lg, "k": k, "v": v}
    return out


def leg_seq(args):
    from bitnet_tpu_torch.parallel.sequence import sequence_parallel_prefill

    return _seq_legs(args, sequence_parallel_prefill)


def leg_ring(args):
    from bitnet_tpu_torch.parallel.ring import ring_parallel_prefill

    return _seq_legs(args, ring_parallel_prefill)


def _collect(req):
    toks = []
    while True:
        t, _, done, _ = req.out.get(timeout=120)
        if t is not None:
            toks.append(t)
        if done:
            return toks


def _serve(path, gens, prompts, num_slots, tp, paged=False):
    """A frontend and its followers: rank 0 serves ``prompts`` through a
    scheduler over the mesh with a ``ControlChannel``, the other ranks
    follow; rank 0 returns the tokens."""
    import torch.distributed as dist

    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel.multihost import host_mesh
    from bitnet_tpu_torch.serve.follower import ControlChannel, worker_loop
    from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
    from bitnet_tpu_torch.tokenizer import load_tokenizer

    os.environ["LOCAL_WORLD_SIZE"] = str(dist.get_world_size())
    ec = EngineConfig(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32")
    if dist.get_rank() != 0:
        worker_loop(path, ec, num_slots=num_slots, tp=tp, device="cpu")
        return None
    mesh = host_mesh(tp=tp, device="cpu")
    ch = ControlChannel()
    cfg, params, _ = load_model(path, param_dtype=torch.float32, device="cpu")
    s = ContinuousBatchingScheduler(cfg, params, load_tokenizer(path), ec,
                                    num_slots=num_slots, mesh=mesh, channel=ch,
                                    device="cpu")
    try:
        return {"tokens": [_collect(s.submit(p, g)) for p, g in zip(prompts, gens)],
                "local_k": tuple(s.cache.k.shape), "stats": dict(s.stats)}
    finally:
        s.shutdown()


def serve_gens():
    from bitnet_tpu_torch.config import GenerationConfig

    return [GenerationConfig(max_new_tokens=5, greedy=True),
            GenerationConfig(max_new_tokens=5, greedy=True),
            GenerationConfig(max_new_tokens=4, mirostat=2, seed=11)]


def leg_serve(args):
    return _serve(args["f32"], serve_gens(), SERVE_PROMPTS, 2, tp=2)


def leg_sched(args):
    from bitnet_tpu_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=6, greedy=True)
    return _serve(args["f32"], [gen] * 4, SCHED_PROMPTS, 4, tp=2)


LEGS = {name[4:]: fn for name, fn in globals().items() if name.startswith("leg_")}


def _main(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    from bitnet_tpu_torch.parallel.multihost import init_distributed

    init_distributed("file://" + spec["store"], spec["n"], rank, backend="gloo",
                     timeout_s=120, device="cpu")
    res = {}
    for leg in spec["legs"]:
        try:
            res[leg] = LEGS[leg](spec["args"])
        except Exception:      # noqa: BLE001 — the test reads it
            res[leg] = {"error": traceback.format_exc()}
        dist.barrier()
    torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))
