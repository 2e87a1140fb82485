"""The scheduler's pipelined issue-ahead mode (``pipeline_depth > 1``,
``engine/loop.PoolPipeline``) on the CPU.

Mirrors ``tests/test_scheduler_pipelined.py`` on the mini QK256 GGUF at
``compute_dtype="f32"``, an f32 cache and ``kernel_path="xla"`` (the JAX
package's own tests use the F32 fixture; its dense linears load in the
port too, ``tests/test_torch_dense.py``): greedy tokens equal the JAX pipelined scheduler's; every
sampled config of ``PARITY_CONFIGS`` equals the port's own synchronous
scheduler (JAX and torch random streams differ), and so do staggered
requests; Mirostat and a min-tokens phase fall back to the synchronous
step and keep its tokens; a cancel ends a request with windows in flight;
``pause`` drains the windows; a paged pool or ``speculative_k`` raise as
the JAX package's do.
"""

import time

import jax.numpy as jnp
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.errors import InferenceError as JInferenceError
from bitnet_tpu.models import load_model as jload_model
from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from bitnet_tpu.tokenizer import load_tokenizer as jload_tokenizer
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.stop import StopReason
from bitnet_tpu_torch.errors import InferenceError
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
from bitnet_tpu_torch.tokenizer import load_tokenizer

torch.set_num_threads(1)

KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
PROMPT = [1, 7, 20, 3]

# tests/test_scheduler_pipelined.py:68-81
PARITY_CONFIGS = {
    "greedy": dict(max_new_tokens=9, greedy=True),
    "top-k": dict(max_new_tokens=9, temperature=0.8, top_k=5, seed=42),
    "top-p": dict(max_new_tokens=9, temperature=0.9, top_p=0.7, seed=7),
    "combined": dict(max_new_tokens=9, temperature=0.8, top_k=8, top_p=0.9,
                     min_p=0.02, seed=11),
    "typical-p": dict(max_new_tokens=9, temperature=0.8, typical_p=0.8, seed=13),
}


@pytest.fixture(scope="module")
def model(mini_gguf_qk256):
    cfg, params, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32,
                                device="cpu")
    return cfg, params, load_tokenizer(mini_gguf_qk256.path)


@pytest.fixture(scope="module")
def jmodel(mini_gguf_qk256):
    cfg, params, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    return cfg, params, jload_tokenizer(mini_gguf_qk256.path)


def make(model, **kw):
    cfg, params, tok = model
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_steps_per_dispatch", 2)
    return ContinuousBatchingScheduler(cfg, params, tok, EngineConfig(**KW),
                                       device="cpu", **kw)


@pytest.fixture(scope="module")
def pl_sched(model):
    s = make(model, pipeline_depth=3)
    yield s
    s.shutdown()


@pytest.fixture(scope="module")
def sync_sched(model):
    s = make(model)
    yield s
    s.shutdown()


def collect(req, timeout=120):
    toks = []
    while True:
        tok, _, done, reason = req.out.get(timeout=timeout)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks, reason


@pytest.mark.parametrize("depth", [2, 3])
def test_greedy_tokens_are_the_jax_pipelined_schedulers(model, jmodel, depth):
    """Three staggered greedy requests (one stopped by a stop id) on both
    pipelined schedulers."""
    gens = [dict(max_new_tokens=9, greedy=True), dict(max_new_tokens=7, greedy=True),
            dict(max_new_tokens=9, greedy=True, stop_token_ids=(0,))]
    prompts = [PROMPT, [2, 9, 14, 5, 6], [3, 5, 8]]
    kw = dict(num_slots=2, decode_steps_per_dispatch=2, pipeline_depth=depth)
    s = make(model, **kw)
    cfg, params, tok = jmodel
    j = JScheduler(cfg, params, tok, JEngineConfig(**KW), **kw)
    try:
        got = [collect(s.submit(p, GenerationConfig(**g))) for p, g in zip(prompts, gens)]
        want = [collect(j.submit(p, JGen(**g))) for p, g in zip(prompts, gens)]
    finally:
        s.shutdown()
        j.shutdown()
    assert [(t, r.value) for t, r in got] == [(t, r.value) for t, r in want]
    assert all(t for t, _ in got) and s.stats["decode_steps"] > 0


@pytest.mark.parametrize("name", list(PARITY_CONFIGS))
def test_matches_the_sync_scheduler(pl_sched, sync_sched, name):
    a, ra = collect(pl_sched.submit(PROMPT, GenerationConfig(**PARITY_CONFIGS[name])))
    b, rb = collect(sync_sched.submit(PROMPT, GenerationConfig(**PARITY_CONFIGS[name])))
    assert a == b and len(a) == 9
    assert ra == rb


def test_concurrent_staggered_requests(pl_sched, sync_sched):
    """More requests than slots in a burst: every stream the sync
    scheduler's for the same seed."""
    gens = [GenerationConfig(max_new_tokens=7, temperature=0.7, top_k=6, seed=100 + i)
            for i in range(5)]
    prompts = [[2 + i, 9, 14] for i in range(5)]
    a = [collect(r)[0] for r in [pl_sched.submit(p, g) for p, g in zip(prompts, gens)]]
    b = [collect(r)[0] for r in [sync_sched.submit(p, g) for p, g in zip(prompts, gens)]]
    assert a == b and all(len(t) == 7 for t in a)


@pytest.mark.parametrize("gen", [dict(max_new_tokens=6, mirostat=2, seed=5),
                                 dict(max_new_tokens=6, min_new_tokens=4, greedy=True)],
                         ids=["mirostat", "min_tokens"])
def test_hostside_slots_fall_back_to_the_sync_step(pl_sched, sync_sched, gen):
    before = pl_sched.stats.get("pipeline_fallback_steps", 0)
    a, _ = collect(pl_sched.submit(PROMPT, GenerationConfig(**gen)))
    b, _ = collect(sync_sched.submit(PROMPT, GenerationConfig(**gen)))
    assert a == b and len(a) == 6
    assert pl_sched.stats.get("pipeline_fallback_steps", 0) > before


def test_a_sampled_stream_survives_a_fallback(model):
    """A seeded request in flight while a Mirostat request passes through:
    the pipelined state goes back to the host and is rebuilt, and the
    seeded stream is still the sync scheduler's."""
    g = GenerationConfig(max_new_tokens=30, temperature=0.8, top_k=8, seed=21)
    m = GenerationConfig(max_new_tokens=4, mirostat=2, seed=5)
    out = []
    for depth in (3, 1):
        s = make(model, pipeline_depth=depth, start_loop=False)
        a = s.submit([4, 8, 15], g)
        (s._step_pipelined if depth > 1 else s._step)()
        if depth > 1:             # three windows issued, the oldest read
            assert len(s._pl_inflight) == 2 and s._pl.segments
        for _ in range(3):
            (s._step_pipelined if depth > 1 else s._step)()
        b = s.submit(PROMPT, m)
        for _ in range(200):
            (s._step_pipelined if depth > 1 else s._step)()
            if not any(sl.occupied for sl in s.slots) and s.pending.empty() \
                    and not s._pl_inflight:
                break
        out.append((collect(a, 0), collect(b, 0)))
        if depth > 1:
            assert s.stats.get("pipeline_fallback_steps", 0) > 0
    assert out[0] == out[1] and len(out[0][0][0]) == 30


def test_cancel_with_windows_in_flight(pl_sched):
    req = pl_sched.submit(PROMPT, GenerationConfig(max_new_tokens=4096, temperature=0.9,
                                                   seed=3))
    tok, _, done, _ = req.out.get(timeout=120)
    assert tok is not None and not done
    req.cancel()
    _, reason = collect(req)
    assert reason == StopReason.CANCELLED


def test_pause_drains_the_windows_in_flight(model):
    s = make(model, pipeline_depth=3)
    try:
        req = s.submit(PROMPT, GenerationConfig(max_new_tokens=4096, greedy=True))
        req.out.get(timeout=120)
        s.pause()
        assert not s._pl_inflight
        n = req.out.qsize()
        time.sleep(0.1)
        assert req.out.qsize() == n            # quiesced
        s.unpause()
        req.out.get(timeout=120)
        req.cancel()
        assert collect(req)[1] == StopReason.CANCELLED
    finally:
        s.shutdown()


@pytest.mark.parametrize("kw", [dict(paged=True, pipeline_depth=2),
                                dict(speculative_k=2, pipeline_depth=2)],
                         ids=["paged", "speculative"])
def test_rejects_incompatible_modes(model, jmodel, kw):
    with pytest.raises(JInferenceError) as want:
        JScheduler(*jmodel, JEngineConfig(**KW), num_slots=2, start_loop=False, **kw)
    with pytest.raises(InferenceError) as got:
        make(model, start_loop=False, **kw)
    assert str(got.value) == str(want.value)
