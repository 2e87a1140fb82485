"""The port's parallel modes on the CPU, held to the JAX package: tensor
parallelism (tp = 2) and data parallelism (dp = 2) on every kernel path,
the page pool over the model axis, the pipeline (two stages), sequence and
ring prefill, and a frontend with one follower serving three requests.

One group of two gloo processes (``torch_parallel_workers.py``, a
``FileStore`` under the test's temporary directory) runs every leg once for
the module; the tests read its saved results.  The JAX side runs here on
the 8 virtual CPU devices (GSPMD sharding, ``shard_map`` for the pipeline
and sequence modes).  Tolerances: sharded logits within 5e-4 of the JAX
sharded forward at f32 (``tests/test_parallel.py``: the reductions are
split across ranks, so sums round differently); pipeline, sequence and
ring within 2e-4 of the JAX functions (``tests/test_pipeline_sp.py``'s),
2e-3 on the fused sub-norm fixture (its own); w2a8 tokens equal the
unsharded w2a8 tokens (``tests/test_sharded_engine.py:96-102``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_parallel_workers as W
from bitnet_tpu_torch.gguf.fixtures import MiniModelSpec, generate_mini_gguf

TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def paths(tmp_path_factory, mini_gguf_f32):
    d = tmp_path_factory.mktemp("par")
    qk = str(d / "qk.gguf")
    generate_mini_gguf(qk, MiniModelSpec(hidden_size=512, intermediate_size=1024,
                                         num_heads=4, num_kv_heads=2, quant="qk256",
                                         sub_norm=True, tie_embeddings=False))
    sn = str(d / "sn.gguf")
    generate_mini_gguf(sn, MiniModelSpec(hidden_size=256, intermediate_size=512,
                                         num_heads=4, num_kv_heads=2, quant="qk256",
                                         sub_norm=True))
    return {"qk": qk, "sn": sn, "f32": mini_gguf_f32.path, "dir": str(d)}


@pytest.fixture(scope="module")
def group(paths):
    ranks = W.run_group(2, ["tp", "dp", "paged", "pipeline", "seq", "ring", "serve"],
                        {k: v for k, v in paths.items() if k != "dir"},
                        os.path.join(paths["dir"], "group"))
    return ranks


def leg(group, name, rank=0):
    r = group[rank][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"rank {rank} leg {name}:\n{r['error']}")
    return r


def _np(t):
    return t.detach().to(torch.float32).numpy()


def jax_sharded_step(path, dp, tp, kp, B, T, S=32):
    """The JAX sharded forward (``tests/test_parallel.py``'s step) on the
    worker's tokens: logits [B, T, V]."""
    from bitnet_tpu.engine.cache import allocate_cache
    from bitnet_tpu.models import load_model
    from bitnet_tpu.models.bitnet import forward_cache, logits
    from bitnet_tpu.parallel import make_mesh, shard_cache, shard_params, token_pspec

    cfg, params, _ = load_model(path, param_dtype=jnp.float32)
    toks = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    sp = shard_params(mesh, cfg, params)
    sc = shard_cache(mesh, allocate_cache(cfg, B, S, "f32"))
    ts = NamedSharding(mesh, token_pspec())

    def step(p, t, q, c):
        h, c = forward_cache(cfg, p, t, q, c, T, kp)
        return logits(cfg, p, h, kp)
    with mesh:
        return np.asarray(jax.jit(step)(sp, jax.device_put(toks, ts),
                                        jax.device_put(pos, ts), sc))


def jax_tokens(path, kp, prompt=(2, 7, 11), n=6, B=2):
    from bitnet_tpu.config import EngineConfig, GenerationConfig
    from bitnet_tpu.engine.engine import InferenceEngine
    from bitnet_tpu.models import load_model

    cfg, params, _ = load_model(path, param_dtype=jnp.float32)
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_seq_len=64, max_batch_size=B, kv_cache_dtype="f32", compute_dtype="f32",
        kernel_path=kp))
    return eng.generate(list(prompt), GenerationConfig(max_new_tokens=n,
                                                      greedy=True)).token_ids


def port_tokens(path, kp, prompt=(2, 7, 11), n=6, B=2):
    from bitnet_tpu_torch.config import GenerationConfig

    return W._engine(path, kp, B).generate(list(prompt), GenerationConfig(
        max_new_tokens=n, greedy=True)).token_ids


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kp", ["xla", "w2a8", "pallas"])
def test_tp_logits_meet_the_jax_sharded_forward(group, paths, kp):
    """tp = 2 on each kernel path: every position's logits within 5e-4 of
    the JAX sharded forward (GSPMD) on the same path, on both ranks alike;
    each rank holds its half of the KV heads.  On ``w2a8`` the JAX forward
    is the unsharded function (a ``pallas_call`` is not partitioned), which
    the port's row-parallel linears compute from each row's reduced
    statistics.  On ``pallas`` within 1e-2, the tolerance
    ``test_tp_decode_meets_the_unsharded_port`` states for K6's split K."""
    tol = dict(rtol=1e-2, atol=1e-2) if kp == "pallas" else TOL
    r0, r1 = leg(group, "tp", 0)[kp], leg(group, "tp", 1)[kp]
    want = jax_sharded_step(paths["qk"], 1, 2, kp, 2, 8)
    np.testing.assert_allclose(_np(r0["prefill"]), want, **tol)
    assert torch.equal(r0["prefill"], r1["prefill"])
    assert r0["local_k"][-1] == 128          # 1 of 2 KV heads, D = 128


@pytest.mark.parametrize("kp", ["xla", "w2a8", "pallas"])
def test_tp_decode_meets_the_unsharded_port(group, paths, kp):
    """The prefill and the decode step after it, on each path, within 5e-4
    of the unsharded port (itself held to the JAX engine by its own tests);
    on ``pallas`` within 1e-2: K6 accumulates the biased codes' products in
    f32 before it subtracts 2·Σx (a sum about 4·K·|x| that cancels), so a K
    split in two rounds it otherwise (0.0084 at most on this fixture)."""
    from bitnet_tpu_torch.models.bitnet import forward_cache, logits

    tol = dict(rtol=1e-2, atol=1e-2) if kp == "pallas" else TOL
    r = leg(group, "tp")[kp]
    eng = W._engine(paths["qk"], kp, 2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8)))
    pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8).contiguous()
    h, cache = forward_cache(eng.cfg, eng.params, toks, pos, eng.cache, 8, kp)
    lg = logits(eng.cfg, eng.params, h, kp)
    np.testing.assert_allclose(_np(r["prefill"]), _np(lg), **tol)
    nxt = torch.argmax(lg[:, -1], -1)
    assert torch.equal(nxt, torch.argmax(r["prefill"][:, -1], -1))
    h2, _ = forward_cache(eng.cfg, eng.params, nxt[:, None].int(),
                          torch.full((2, 1), 8, dtype=torch.int32), cache, 1, kp)
    np.testing.assert_allclose(_np(r["decode"]), _np(logits(eng.cfg, eng.params, h2, kp)),
                               **tol)


@pytest.mark.parametrize("kp", ["xla", "w2a8", "pallas"])
def test_tp_tokens_are_the_unsharded_engines(group, paths, kp):
    """Greedy tokens of the sharded engine equal the unsharded JAX
    engine's on the same path: for w2a8 the sharded engine must compute the
    unsharded function (each row's norm and int8 scale reduced over the
    model axis), as the JAX package's sharded w2a8 engine does."""
    got = leg(group, "tp")[kp]["tokens"]
    assert got == port_tokens(paths["qk"], kp) == jax_tokens(paths["qk"], kp)


@pytest.mark.parametrize("kp", ["xla", "w2a8", "pallas"])
def test_dp_mesh_is_the_unsharded_function(group, paths, kp):
    """dp = 2, tp = 1 (the 2B's one parallel mode): nothing is split, so the
    linears stay the model's (no row-parallel slice; on ``w2a8`` K1 fuses
    the norm and the residual as in one process) and each rank runs its
    rows of the batch.  Logits within 5e-4 of the JAX sharded forward on a
    (2, 1) mesh, on both ranks alike; ``generate_batch``'s tokens equal the
    unsharded port's.  On ``pallas`` within 1e-2: each linear rounds its
    input to bf16, so the two packages' f32 differences (another summation
    order) flip a rounding now and then, a 2^-8 step that the layers carry
    on (0.009 at most on this fixture, with nothing split)."""
    from bitnet_tpu_torch.config import GenerationConfig

    tol = dict(rtol=1e-2, atol=1e-2) if kp == "pallas" else TOL
    r0, r1 = leg(group, "dp", 0)[kp], leg(group, "dp", 1)[kp]
    assert not r0["row_marked"] and not r1["row_marked"]
    want = jax_sharded_step(paths["qk"], 2, 1, kp, 4, 8)
    np.testing.assert_allclose(_np(r0["prefill"]), want, **tol)
    assert torch.equal(r0["prefill"], r1["prefill"])
    batch = [g.token_ids for g in W._engine(paths["qk"], kp, 4).generate_batch(
        W.PROMPTS[:4], GenerationConfig(max_new_tokens=4, greedy=True))]
    assert r0["batch"] == batch


# --------------------------------------------------------------------------
# the page pool over the model axis
# --------------------------------------------------------------------------
def test_paged_pool_over_the_model_axis(group, paths):
    """The page pool sharded on the KV heads with tp = 2 weights: a
    prefill and two decode steps through ``paged_forward`` meet the
    unsharded pool within 5e-4, and the prefill's full-length row meets
    the JAX dense forward."""
    from bitnet_tpu.engine.cache import allocate_cache
    from bitnet_tpu.models import load_model as jload
    from bitnet_tpu.models.bitnet import forward_cache as jfc, logits as jlg
    from bitnet_tpu_torch.engine.paged_cache import allocate_paged_cache
    from bitnet_tpu_torch.models.loader import load_model

    got = leg(group, "paged")
    cfg, params, _ = load_model(paths["qk"], param_dtype=torch.float32, device="cpu")
    want = W.paged_run(cfg, params, allocate_paged_cache(cfg, 2, 8, 8, 4, "f32",
                                                         device="cpu"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    jcfg, jparams, _ = jload(paths["qk"], param_dtype=jnp.float32)
    t = jnp.asarray([W.PROMPTS[0]], jnp.int32)
    h, _ = jfc(jcfg, jparams, t, jnp.arange(4, dtype=jnp.int32)[None],
               allocate_cache(jcfg, 1, 32, "f32"), 4, "xla")
    np.testing.assert_allclose(_np(got[0][:1]), np.asarray(jlg(jcfg, jparams, h)), **TOL)


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("strategy,L,S,costs,want", [
    ("uniform", 30, 4, None, [8, 8, 7, 7]),
    ("cost", 6, 2, [1, 1, 1, 3, 3, 3], [4, 2]),
    ("weight_balanced", 8, 3, None, [3, 3, 2]),
    ("weight_balanced", 6, 2, [1, 1, 1, 3, 3, 3], [4, 2])])
def test_plan_stages_is_the_jax_planners(strategy, L, S, costs, want):
    from bitnet_tpu.config import ModelConfig as JModelConfig
    from bitnet_tpu.parallel.pipeline import plan_stages as jplan
    from bitnet_tpu_torch.config import ModelConfig
    from bitnet_tpu_torch.parallel.pipeline import plan_stages

    got = plan_stages(ModelConfig(num_layers=L), S, strategy, costs)
    ref = jplan(JModelConfig(num_layers=L), S, strategy, costs)
    assert got.layers_per_stage == ref.layers_per_stage == want
    assert got.bounds == ref.bounds


@pytest.mark.parametrize("args", [(2, 3, None), (4, 2, "nope"), (0, 2, None)])
def test_plan_stages_refusals_are_the_jax_planners(args):
    from bitnet_tpu.config import ModelConfig as JModelConfig
    from bitnet_tpu.errors import ConfigError as JConfigError
    from bitnet_tpu.parallel.pipeline import plan_stages as jplan
    from bitnet_tpu_torch.config import ModelConfig
    from bitnet_tpu_torch.errors import ConfigError
    from bitnet_tpu_torch.parallel.pipeline import plan_stages

    L, S, strategy = args
    L = max(L, 1)
    kw = {} if strategy is None else {"strategy": strategy}
    with pytest.raises(JConfigError) as want:
        jplan(JModelConfig(num_layers=L), S, **kw)
    with pytest.raises(ConfigError) as got:
        plan_stages(ModelConfig(num_layers=L), S, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,B,T,S,M,seed", [("m2", 4, 6, 32, 2, 1),
                                               ("m1", 2, 4, 16, 1, 2)])
def test_pipeline_forward_meets_the_jax_pipeline(group, paths, name, B, T, S, M, seed):
    """Two stages, GPipe over M microbatches: logits on both ranks and each
    stage's KV layers within 2e-4 of the JAX ``pipeline_forward``."""
    from bitnet_tpu.models import load_model
    from bitnet_tpu.parallel.pipeline import (make_pipeline_mesh, pipeline_forward,
                                              shard_pipeline_params)

    r0, r1 = leg(group, "pipeline", 0)[name], leg(group, "pipeline", 1)[name]
    cfg, params, _ = load_model(paths["f32"], param_dtype=jnp.float32)
    mesh = make_pipeline_mesh(2)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = jnp.tile(jnp.arange(T, dtype=jnp.int32)[None], (B, 1))
    kc = jnp.zeros((cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim), jnp.float32)
    with mesh:
        lg, kc, vc = pipeline_forward(cfg, shard_pipeline_params(mesh, cfg, params),
                                      jnp.asarray(toks), pos, kc, jnp.zeros_like(kc),
                                      jnp.zeros(B, jnp.int32), mesh, num_microbatches=M)
    for r in (r0, r1):
        np.testing.assert_allclose(_np(r["logits"]), np.asarray(lg), rtol=2e-4, atol=2e-4)
    k = torch.cat([r0["k"], r1["k"]]).reshape(np.asarray(kc).shape)
    v = torch.cat([r0["v"], r1["v"]]).reshape(np.asarray(vc).shape)
    np.testing.assert_allclose(_np(k), np.asarray(kc), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(v), np.asarray(vc), rtol=2e-4, atol=2e-4)


def test_pipeline_refuses_an_uneven_microbatch_split(paths):
    from bitnet_tpu_torch.errors import ConfigError
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel.mesh import single_device_mesh
    from bitnet_tpu_torch.parallel.pipeline import STAGE_AXIS, pipeline_forward

    cfg, params, _ = load_model(paths["f32"], param_dtype=torch.float32, device="cpu")
    m = single_device_mesh("cpu")
    mesh = type(m)({STAGE_AXIS: m.world}, m.world, m.device)
    kc = torch.zeros((cfg.num_layers, 3, 8, cfg.num_kv_heads * cfg.head_dim))
    with pytest.raises(ConfigError, match="not divisible by microbatches"):
        pipeline_forward(cfg, params, torch.zeros((3, 4), dtype=torch.int64),
                         torch.zeros((3, 4), dtype=torch.int32), kc, kc.clone(),
                         torch.zeros(3, dtype=torch.int32), mesh, 2)


# --------------------------------------------------------------------------
# sequence and ring prefill
# --------------------------------------------------------------------------
def _jax_fused_subnorm(path):
    import dataclasses

    from bitnet_tpu.models import load_model
    from bitnet_tpu.models.bitnet import fuse_block_params

    cfg, params, _ = load_model(path, param_dtype=jnp.float32)
    return cfg, dataclasses.replace(params, blocks=fuse_block_params(params.blocks))


@pytest.mark.parametrize("mode", ["seq", "ring"])
@pytest.mark.parametrize("name,B,T,seed", [("dense", 2, 16, 4), ("long", 1, 32, 8),
                                           ("fused", 2, 16, 11)])
def test_sequence_modes_meet_the_jax_functions(group, paths, mode, name, B, T, seed):
    """Each rank's chunk of the logits and of the K / V rows, joined, within
    2e-4 of the JAX ``sequence_parallel_prefill`` / ``ring_parallel_prefill``
    on two devices (2e-3 on the fused sub-norm fixture, its test's own)."""
    from bitnet_tpu.models import load_model
    from bitnet_tpu.parallel.ring import ring_parallel_prefill
    from bitnet_tpu.parallel.sequence import make_seq_mesh, sequence_parallel_prefill

    r0, r1 = leg(group, mode, 0)[name], leg(group, mode, 1)[name]
    if name == "fused":
        cfg, params = _jax_fused_subnorm(paths["sn"])
        tol = dict(rtol=2e-3, atol=2e-3)
    else:
        cfg, params, _ = load_model(paths["f32"], param_dtype=jnp.float32)
        tol = dict(rtol=2e-4, atol=2e-4)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    fn = sequence_parallel_prefill if mode == "seq" else ring_parallel_prefill
    mesh = make_seq_mesh(2)
    with mesh:
        lg, k, v = fn(cfg, params, jnp.asarray(toks), mesh)
    np.testing.assert_allclose(_np(torch.cat([r0["logits"], r1["logits"]], 1)),
                               np.asarray(lg), **tol)
    np.testing.assert_allclose(_np(torch.cat([r0["k"], r1["k"]], 2)), np.asarray(k), **tol)
    np.testing.assert_allclose(_np(torch.cat([r0["v"], r1["v"]], 2)), np.asarray(v), **tol)


# --------------------------------------------------------------------------
# the follower
# --------------------------------------------------------------------------
def test_follower_serve_is_the_single_process_schedulers(group, paths):
    """A frontend and one follower (tp = 2, a ControlChannel) serve two
    greedy requests and one seeded Mirostat request
    (``tests/test_multihost.py:131``).  The greedy tokens equal the JAX
    single-process scheduler's; the Mirostat request's equal the port's
    single-process scheduler's (the packages' PRNG streams differ; the
    port's sampler is held to the JAX one on shared uniforms by its own
    tests)."""
    from bitnet_tpu.config import EngineConfig, GenerationConfig
    from bitnet_tpu.models import load_model
    from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler
    from bitnet_tpu.tokenizer import load_tokenizer
    from bitnet_tpu_torch.config import EngineConfig as PEngineConfig
    from bitnet_tpu_torch.models.loader import load_model as pload
    from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler as PSched
    from bitnet_tpu_torch.tokenizer import load_tokenizer as ptok

    got = leg(group, "serve")
    assert group[1]["serve"] is None              # the follower returned
    cfg, params, _ = load_model(paths["f32"], param_dtype=jnp.float32)
    sched = ContinuousBatchingScheduler(
        cfg, params, load_tokenizer(paths["f32"]),
        EngineConfig(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32"),
        num_slots=2)
    gens = [GenerationConfig(max_new_tokens=5, greedy=True),
            GenerationConfig(max_new_tokens=5, greedy=True)]
    try:
        golden = [W._collect(sched.submit(list(p), g))
                  for p, g in zip(W.SERVE_PROMPTS, gens)]
    finally:
        sched.shutdown()
    pcfg, pparams, _ = pload(paths["f32"], param_dtype=torch.float32, device="cpu")
    psched = PSched(pcfg, pparams, ptok(paths["f32"]), PEngineConfig(
        max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32"), num_slots=2,
        device="cpu")
    try:
        pgold = [W._collect(psched.submit(list(p), g))
                 for p, g in zip(W.SERVE_PROMPTS, W.serve_gens())]
    finally:
        psched.shutdown()
    assert got["tokens"][:2] == golden == pgold[:2]
    assert got["tokens"][2] == pgold[2] and len(pgold[2]) == 4
    assert got["local_k"][-1] == cfg.num_kv_heads // 2 * cfg.head_dim
