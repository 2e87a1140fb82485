"""Data × tensor parallelism (dp = 2, tp = 2) of the port on the CPU, held
to the JAX package: the sharded engine and the continuous-batching
scheduler over the mesh, a frontend and three followers.

One group of four gloo processes (``torch_parallel_workers.py``) runs both
legs once for the module.  Tolerances: logits within 5e-4 of the JAX
sharded forward at f32 (``tests/test_parallel.py``); tokens equal
(``tests/test_serve.py:253-295``, ``tests/test_sharded_engine.py:96-102``).
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from bitnet_tpu_torch.gguf.fixtures import MiniModelSpec, generate_mini_gguf
from test_torch_parallel import _np, jax_sharded_step, jax_tokens, leg, port_tokens

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def paths(tmp_path_factory, mini_gguf_f32):
    d = tmp_path_factory.mktemp("pardp")
    qk = str(d / "qk.gguf")
    generate_mini_gguf(qk, MiniModelSpec(hidden_size=512, intermediate_size=1024,
                                         num_heads=4, num_kv_heads=2, quant="qk256",
                                         sub_norm=True, tie_embeddings=False))
    return {"qk": qk, "f32": mini_gguf_f32.path, "dir": str(d)}


@pytest.fixture(scope="module")
def group(paths):
    return W.run_group(4, ["dptp", "sched"], {"qk": paths["qk"], "f32": paths["f32"]},
                       os.path.join(paths["dir"], "group"))


def test_dp_tp_logits_meet_the_jax_sharded_forward(group, paths):
    """(dp, tp) = (2, 2) on the xla path: every rank's logits (each data
    rank computed its two rows, the hidden states gathered) within 5e-4 of
    the JAX sharded forward; each rank's cache holds 2 of 4 slots and 1 of
    2 KV heads."""
    want = jax_sharded_step(paths["qk"], 2, 2, "xla", 4, 8)
    for r in range(4):
        got = leg(group, "dptp", r)["xla"]
        np.testing.assert_allclose(_np(got["prefill"]), want, **TOL)
        assert got["local_k"][1] == 2 and got["local_k"][-1] == 128


@pytest.mark.parametrize("kp", ["xla", "w2a8", "pallas"])
def test_dp_tp_tokens_are_the_unsharded_engines(group, paths, kp):
    """Greedy tokens through ``generate`` and a pool of four through
    ``generate_batch`` equal the unsharded engine's on the same path (w2a8:
    the unsharded function, as the JAX sharded w2a8 engine computes it)."""
    from bitnet_tpu_torch.config import GenerationConfig

    got = leg(group, "dptp")[kp]
    assert got["tokens"] == port_tokens(paths["qk"], kp, B=4) == jax_tokens(
        paths["qk"], kp, B=4)
    batch = [g.token_ids for g in W._engine(paths["qk"], kp, 4).generate_batch(
        W.PROMPTS, GenerationConfig(max_new_tokens=4, greedy=True))]
    assert got["batch"] == batch


def test_scheduler_over_the_mesh_is_the_unsharded_schedulers(group, paths):
    """Continuous batching over a (2, 2) mesh (a frontend and three
    followers; a slot's prefill on the data rank that holds it) gives the
    JAX unsharded scheduler's greedy tokens (``tests/test_serve.py:253``)."""
    import jax.numpy as jnp

    from bitnet_tpu.config import EngineConfig, GenerationConfig
    from bitnet_tpu.models import load_model
    from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler
    from bitnet_tpu.tokenizer import load_tokenizer

    got = leg(group, "sched")
    assert all(group[r]["sched"] is None for r in (1, 2, 3))
    cfg, params, _ = load_model(paths["f32"], param_dtype=jnp.float32)
    s0 = ContinuousBatchingScheduler(
        cfg, params, load_tokenizer(paths["f32"]),
        EngineConfig(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32"),
        num_slots=4)
    gen = GenerationConfig(max_new_tokens=6, greedy=True)
    try:
        golden = [W._collect(s0.submit(p, gen)) for p in W.SCHED_PROMPTS]
    finally:
        s0.shutdown()
    assert got["tokens"] == golden
    assert got["local_k"][1] == 2           # 2 of the 4 slots on each data rank
