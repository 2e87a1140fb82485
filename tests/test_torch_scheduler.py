"""The continuous-batching scheduler (``bitnet_tpu_torch/serve/scheduler.py``)
on the CPU, held to the JAX package's scheduler and to the port's engine.

On the mini QK256 GGUF at ``compute_dtype="f32"``, an f32 cache and
``kernel_path="xla"`` (the port does not load the F32 fixture's dense
linears, ROADMAP #7; the JAX package's own scheduler tests use that
fixture).  Mirrors ``tests/test_scheduler_{parity,chunked,stress}.py``:

- greedy tokens equal the JAX scheduler's, K=1 and K=4, whole and chunked
  prefill, with staggered submits (both schedulers stepped by hand in
  lockstep, so the admissions interleave the same way);
- sampled tokens of every ``PARITY_CONFIGS`` config (plus a grammar and a
  logprobs request), mixed in one pool, equal the port engine's
  ``generate`` with the same seed, at K=1 and at K=4;
- the pooled sampler's rows equal ``SamplerChain``'s with the same
  uniforms;
- cancellation, deadlines, queue timeouts and preemption end with the JAX
  ``StopReason``s;
- the refusals of what the port leaves out (``pipeline_depth`` and
  ``speculative_k``, ported, raise the JAX package's error on a paged pool:
  ``tests/test_torch_speculative.py`` and ``test_torch_pipelined.py`` hold
  the modes; ``checkpoint_requests`` / ``resume_requests``, ported, are held
  in ``tests/test_torch_server_units.py``), the card default, the
  one-thread guard on a device's attention counters, and the card's CUDA
  graph mocked (a failed capture raises; replays add the capture's counts).

The paged pool, K33 and the ``paged`` plan are in
``tests/test_torch_paged.py``; the card's own tests in
``tests/test_torch_cuda.py``.
"""

import contextlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine.stop import StopReason as JStopReason
from bitnet_tpu.models import load_model as jload_model
from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from bitnet_tpu.tokenizer import load_tokenizer as jload_tokenizer
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import loop
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.engine.sampling import SamplerChain, pooled_sample
from bitnet_tpu_torch.engine.stop import StopReason
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.ops import registry
from bitnet_tpu_torch.ops.decode_attention import attn_counters, claim_device, release_device
from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
from bitnet_tpu_torch.tokenizer import load_tokenizer

torch.set_num_threads(1)

KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
PROMPT = [1, 7, 20, 3]
LONG = [(7 * i + 3) % 250 for i in range(41)]     # several chunks at C=8

# tests/test_scheduler_parity.py:53-87
PARITY_CONFIGS = {
    "greedy": dict(max_new_tokens=6, greedy=True),
    "rep-penalty": dict(max_new_tokens=6, greedy=True, repetition_penalty=3.0),
    "top-k": dict(max_new_tokens=6, temperature=0.8, top_k=5, seed=42),
    "top-p": dict(max_new_tokens=6, temperature=0.9, top_p=0.7, seed=7),
    "combined": dict(max_new_tokens=6, temperature=0.8, top_k=8, top_p=0.9, min_p=0.02,
                     repetition_penalty=1.3, seed=11),
    "typical-p": dict(max_new_tokens=6, temperature=0.8, typical_p=0.8, seed=13),
    "mirostat-v2": dict(max_new_tokens=6, mirostat=2, seed=5),
    "freq-pres-greedy": dict(max_new_tokens=6, greedy=True, frequency_penalty=0.8,
                             presence_penalty=0.4),
    "freq-pres-sampled": dict(max_new_tokens=6, temperature=0.8, top_k=8,
                              frequency_penalty=1.2, presence_penalty=-0.5, seed=17),
    "logit-bias-greedy": dict(max_new_tokens=6, greedy=True, logit_bias=((23, 6.5),)),
    "logit-bias-ban-sampled": dict(max_new_tokens=6, temperature=0.9, top_k=4, seed=3,
                                   logit_bias=((5, -100.0), (9, 2.0))),
}
# the port engine's per-request state, in the same pool
EXTRA_CONFIGS = {
    "mirostat-v1": dict(max_new_tokens=6, mirostat=1, seed=9),
    "grammar": dict(max_new_tokens=8, temperature=0.9, seed=21,
                    grammar='root ::= [ab]{4} "!"'),
    "logprobs": dict(max_new_tokens=6, temperature=0.7, seed=23, logprobs=2),
    "min-tokens": dict(max_new_tokens=8, min_new_tokens=4, temperature=0.9, seed=29),
}
ALL_CONFIGS = {**PARITY_CONFIGS, **EXTRA_CONFIGS}


@pytest.fixture(scope="module")
def model(mini_gguf_qk256):
    cfg, params, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32,
                                device="cpu")
    return cfg, params, load_tokenizer(mini_gguf_qk256.path)


@pytest.fixture(scope="module")
def jmodel(mini_gguf_qk256):
    cfg, params, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    return cfg, params, jload_tokenizer(mini_gguf_qk256.path)


@pytest.fixture(scope="module")
def engine(mini_gguf_qk256):
    return InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**KW),
                                     device="cpu")


def make(model, **kw):
    cfg, params, tok = model
    kw.setdefault("num_slots", 2)
    ecfg = EngineConfig(**{**KW, **kw.pop("ecfg", {})})
    return ContinuousBatchingScheduler(cfg, params, tok, ecfg, device="cpu", **kw)


def make_jax(jmodel, **kw):
    cfg, params, tok = jmodel
    kw.setdefault("num_slots", 2)
    return JScheduler(cfg, params, tok, JEngineConfig(**KW), **kw)


def drain(req):
    toks = []
    while True:
        tok, _, done, reason = req.out.get(timeout=0)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks, reason


def collect(req, timeout=120):
    toks = []
    while True:
        tok, _, done, reason = req.out.get(timeout=timeout)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks, reason


def run_lockstep(sched, script, max_steps=400):
    """Drive a scheduler built with ``start_loop=False``: ``script`` maps a
    step number to the (prompt, gen, kw) submitted before that step; steps
    until every request is done.  Returns [(tokens, reason value)]."""
    reqs = []
    for step in range(max_steps):
        for prompt, gen, kw in script.get(step, ()):
            reqs.append(sched.submit(prompt, gen, **kw))
        sched._step()
        if step >= max(script) and all(
                not s.occupied for s in sched.slots) and sched.pending.empty():
            break
    out = []
    for r in reqs:
        toks, reason = drain(r)
        out.append((toks, reason.value))
    return out


# --------------------------------------------------------------------------
# greedy tokens: the JAX scheduler's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [None, 8], ids=["whole", "chunked8"])
@pytest.mark.parametrize("k", [1, 4])
def test_greedy_tokens_are_the_jax_schedulers(model, jmodel, k, chunked):
    """Staggered submits of a short, a 41-token and a stopped request; the
    same steps drive both schedulers."""
    g = dict(max_new_tokens=9, greedy=True)
    script = {0: [(PROMPT, g, {})], 2: [(LONG, g, {})],
              3: [([3, 5, 8], dict(g, stop_token_ids=(0,)), {})]}
    kw = dict(start_loop=False, decode_steps_per_dispatch=k, chunked_prefill=chunked)
    got = run_lockstep(make(model, **kw), {s: [(p, GenerationConfig(**gg), x)
                                               for p, gg, x in v]
                                           for s, v in script.items()})
    want = run_lockstep(make_jax(jmodel, **kw), {s: [(p, JGen(**gg), x)
                                                     for p, gg, x in v]
                                                 for s, v in script.items()})
    assert got == want
    assert all(t for t, _ in got)


# --------------------------------------------------------------------------
# sampled tokens: the port engine's, every config mixed in one pool
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[1, 4], ids=["k1", "k4"])
def mixed_pool(request, model):
    """Every config of ALL_CONFIGS submitted at once to a pool of 4."""
    s = make(model, num_slots=4, decode_steps_per_dispatch=request.param)
    try:
        reqs = {name: s.submit(PROMPT, GenerationConfig(**kw))
                for name, kw in ALL_CONFIGS.items()}
        yield {name: (collect(r), r.logprobs) for name, r in reqs.items()}
    finally:
        s.shutdown()


@pytest.mark.parametrize("name", list(ALL_CONFIGS))
def test_sampled_tokens_are_the_engines(mixed_pool, engine, name):
    (toks, reason), lps = mixed_pool[name]
    want = engine.generate(PROMPT, GenerationConfig(**ALL_CONFIGS[name]))
    assert toks == want.token_ids
    assert reason == want.stop_reason
    if lps is not None:
        assert [e["token_id"] for e in lps] == [e["token_id"] for e in want.logprobs]
        np.testing.assert_allclose([e["logprob"] for e in lps],
                                   [e["logprob"] for e in want.logprobs], rtol=1e-6)


@pytest.mark.parametrize("name", list(PARITY_CONFIGS))
def test_pooled_sampler_rows_are_the_chains(name):
    """One pooled call over every config, each row against the chain of
    its config on the same logits, history and uniforms."""
    cfgs = [GenerationConfig(**kw) for kw in PARITY_CONFIGS.values()]
    names = list(PARITY_CONFIGS)
    B, V = len(cfgs), 301
    g = torch.Generator().manual_seed(names.index(name))
    raw = torch.randn(B, V, generator=g) * 3
    hist = torch.randint(-1, V, (B, 64), generator=g)
    u = torch.rand(B, V, generator=g).clamp(min=1e-30)
    bias = torch.zeros(B, V)
    for i, c in enumerate(cfgs):
        for t, v in c.logit_bias:
            bias[i, t] = v

    def col(f):
        return torch.tensor([f(c) for c in cfgs], dtype=torch.float32)
    got = pooled_sample(
        raw, col(lambda c: 0.0 if c.is_greedy else c.temperature),
        torch.tensor([c.top_k for c in cfgs]), col(lambda c: c.top_p),
        col(lambda c: c.min_p), col(lambda c: c.typical_p),
        col(lambda c: c.repetition_penalty), col(lambda c: c.frequency_penalty),
        col(lambda c: c.presence_penalty), bias, hist, u, use_typical=True)
    i = names.index(name)
    want = SamplerChain(cfgs[i]).sample_with_uniforms(raw[i:i + 1], hist[i:i + 1],
                                                      u[i:i + 1])
    assert int(got[i]) == int(want[0])


# --------------------------------------------------------------------------
# lifecycle: the JAX StopReasons
# --------------------------------------------------------------------------
def test_cancel_mid_generation_then_slot_frees(model):
    s = make(model, num_slots=1)
    try:
        req = s.submit([1, 5, 9], GenerationConfig(max_new_tokens=10_000, greedy=True))
        _, _, done, _ = req.out.get(timeout=120)
        assert not done
        req.cancel()
        toks, reason = collect(req, 60)
        assert reason == StopReason.CANCELLED
        assert reason.value == JStopReason.CANCELLED.value
        toks, reason = collect(s.submit([1, 2, 3], GenerationConfig(max_new_tokens=2,
                                                                    greedy=True)))
        assert len(toks) == 2 and reason == StopReason.MAX_TOKENS
        assert s.stats["cancelled"] == 1
    finally:
        s.shutdown()


@pytest.mark.parametrize("case", ["cancel_queued", "deadline", "queue_timeout",
                                  "context_full"])
def test_lifecycle_stops_are_the_jax_schedulers(model, jmodel, case):
    """The same scenario stepped by hand on both schedulers (one slot)."""
    def scenario(sched, G):
        occupy = sched.submit([1, 5, 9], G(max_new_tokens=30, greedy=True))
        sched._step()
        if case == "cancel_queued":
            r = sched.submit([2, 6], G(max_new_tokens=4))
            r.cancel()
        elif case == "deadline":
            r = sched.submit([2, 6], G(max_new_tokens=10_000, greedy=True),
                             priority=-1, timeout_s=0.0)
        elif case == "queue_timeout":
            r = sched.submit([2, 6], G(max_new_tokens=4), queue_timeout_s=0.0)
        else:
            r = sched.submit(list(range(1, 65)), G(max_new_tokens=4))
        time.sleep(0.01)
        for _ in range(60):
            sched._step()
        occupy.cancel()
        sched._step()
        return drain(r)[1].value, drain(occupy)[1].value
    got = scenario(make(model, num_slots=1, start_loop=False), GenerationConfig)
    want = scenario(make_jax(jmodel, num_slots=1, start_loop=False), JGen)
    assert got == want
    assert got[0] == {"cancel_queued": "cancelled", "deadline": "timeout",
                      "queue_timeout": "timeout", "context_full": "context_full"}[case]


def test_preemption_resumes_the_same_stream(model, jmodel):
    """A higher-priority arrival preempts the running low-priority request;
    both finish with the JAX scheduler's tokens, the preempted one with the
    tokens of an uninterrupted run."""
    def scenario(sched, G):
        low = sched.submit([1, 5, 9], G(max_new_tokens=12, temperature=0.8, top_k=6,
                                        seed=4), priority=5)
        for _ in range(4):
            sched._step()
        high = sched.submit([2, 6, 8], G(max_new_tokens=5, greedy=True), priority=0)
        for _ in range(80):
            sched._step()
        return drain(low), drain(high), sched.stats.get("preempted", 0)
    (lt, lr), (ht, hr), n = scenario(make(model, num_slots=1, start_loop=False),
                                     GenerationConfig)
    (jlt, jlr), (jht, jhr), jn = scenario(make_jax(jmodel, num_slots=1,
                                                   start_loop=False), JGen)
    assert n == jn == 1
    assert (ht, hr.value) == (jht, jhr.value)
    assert lr.value == jlr.value == "max_tokens" and len(lt) == len(jlt) == 12
    s = make(model, num_slots=1)
    try:
        alone, _ = collect(s.submit([1, 5, 9], GenerationConfig(
            max_new_tokens=12, temperature=0.8, top_k=6, seed=4)))
    finally:
        s.shutdown()
    assert lt == alone


def test_max_admissions_per_step_bounds_prefills(model):
    s = make(model, num_slots=4, start_loop=False, max_admissions_per_step=1)
    reqs = [s.submit([1, 2 + i], GenerationConfig(max_new_tokens=10, greedy=True))
            for i in range(3)]
    s._step()
    assert sum(sl.occupied for sl in s.slots) == 1
    s._step()
    assert sum(sl.occupied for sl in s.slots) == 2
    for _ in range(40):
        s._step()
    assert all(drain(r)[1] == StopReason.MAX_TOKENS for r in reqs)
    assert s.stats["completed"] == s.stats["requests"] == 3


def test_stop_sequence_and_stop_id_inside_a_window(model, engine):
    """A stop inside a K=4 window ends the request where K=1 ends it."""
    full = engine.generate(PROMPT, GenerationConfig(max_new_tokens=12,
                                                    greedy=True)).token_ids
    at = next(j for j in range(2, 12) if full[j] not in full[:j])
    gen = GenerationConfig(max_new_tokens=12, greedy=True, stop_token_ids=(full[at],))
    s = make(model, decode_steps_per_dispatch=4)
    try:
        toks, reason = collect(s.submit(PROMPT, gen))
    finally:
        s.shutdown()
    assert toks == full[:at] and reason == StopReason.STOP_TOKEN


# --------------------------------------------------------------------------
# refusals, the card default, the one-thread guard
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw,item", [
    # ported (they raised naming #12 (b)): on a paged pool both raise the
    # JAX package's InferenceError
    pytest.param({"pipeline_depth": 2}, None, id="kw0-#12 \\(b\\)"),
    pytest.param({"speculative_k": 2}, None, id="kw1-#12 \\(b\\)"),
    ({"mesh": object()}, "#13"), ({"channel": object()}, "#13")])
def test_out_of_slice_options_raise(model, jmodel, kw, item):
    if item is None:
        from bitnet_tpu.errors import InferenceError as JInferenceError
        from bitnet_tpu_torch.errors import InferenceError

        with pytest.raises(JInferenceError) as want:
            make_jax(jmodel, paged=True, start_loop=False, **kw)
        with pytest.raises(InferenceError) as got:
            make(model, paged=True, start_loop=False, **kw)
        assert str(got.value) == str(want.value)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        make(model, **kw)


@pytest.mark.parametrize("call,item", [
    # ported (they raised naming #12 (c)): an idle pool checkpoints nothing
    # and an empty directory resumes nothing, as in the JAX scheduler
    pytest.param(lambda s, d: s.checkpoint_requests(d), None,
                 id="<lambda>-#12 \\(c\\)0"),
    pytest.param(lambda s, d: s.resume_requests(d), None,
                 id="<lambda>-#12 \\(c\\)1"),
    (lambda s, d: s.follow(), "#13")])
def test_out_of_slice_methods_raise(model, jmodel, tmp_path, call, item):
    s = make(model, start_loop=False)
    if item is None:
        js = make_jax(jmodel, start_loop=False)
        assert call(s, str(tmp_path / "p")) == call(js, str(tmp_path / "j")) == []
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        call(s, str(tmp_path))


def test_the_card_is_the_default_device(model):
    cfg, params, tok = model
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="(?i)cuda"):
        ContinuousBatchingScheduler(cfg, params, tok, EngineConfig(**KW))


def test_a_second_thread_on_the_schedulers_device_raises():
    """While a scheduler's loop holds a device, decode attention from any
    other thread raises naming the cause (no CUDA call is reached)."""
    dev = torch.device("cuda", 0)
    ready, done = threading.Event(), threading.Event()
    holder = {}

    def hold():
        claim_device(dev, "a ContinuousBatchingScheduler's loop")
        holder["id"] = threading.get_ident()
        ready.set()
        done.wait(30)
    t = threading.Thread(target=hold)
    t.start()
    try:
        ready.wait(30)
        with pytest.raises(RuntimeError, match="another thread while a Continuous"):
            attn_counters(dev)
        with pytest.raises(RuntimeError, match="already driven"):
            claim_device(dev, "a second scheduler")
    finally:
        done.set()
        t.join()
        release_device(dev, holder["id"])


# --------------------------------------------------------------------------
# the card's graph, mocked: raise, never fall back; the counters
# --------------------------------------------------------------------------
class _FakeGraph:
    def __init__(self, replay_error=None):
        self.replay_error = replay_error
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        if self.replay_error is not None:
            raise self.replay_error
        for g in self.generators:          # the replay's draws
            g.state = g.state + 1


class _FakeGen:
    def __init__(self, device=None):
        self.state = torch.zeros(2)

    def get_state(self):
        return self.state.clone()

    def set_state(self, s):
        self.state = s.clone()


def _cuda_pool_segment(model, monkeypatch, use_sampling=False):
    s = make(model, num_slots=2, start_loop=False)
    seg = loop.PoolSegment(s.cfg, s.params, s.cache, "xla", 4, 64,
                           torch.device("cuda", 0), use_sampling=use_sampling)
    monkeypatch.setattr(loop, "attn_counters", lambda dev: None)
    monkeypatch.setattr(torch, "Generator", _FakeGen)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(
        a[0] if a else k["size"], dtype=k.get("dtype")))
    return s, seg


def _pool_inputs(B=2):
    ints = np.zeros((B, loop.INT_COLS + loop.HISTORY_W), np.int64)
    ints[:, loop.INT_COLS:] = -1
    ints[0, :4] = (5, 3, 1, 0)
    return ints, np.zeros((B, loop.FLOAT_COLS), np.float32)


def test_a_failed_pool_capture_raises(model, monkeypatch):
    s, seg = _cuda_pool_segment(model, monkeypatch)

    @contextlib.contextmanager
    def failing(graph, pool=None):
        raise RuntimeError("capture failed: operation not permitted when stream "
                           "is capturing")
        yield

    def no_eager(*a, **k):
        raise AssertionError("the pool body ran outside a capture")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", failing)
    monkeypatch.setattr(seg, "_body", no_eager)
    counts = registry.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        seg(*_pool_inputs(), [None, None])
    assert seg.graph is None and registry.launch_counts() == counts


def test_pool_replays_add_the_captures_counts_and_carry_generators(model, monkeypatch):
    """The capture's counts are taken back and added on every replay; with
    sampling, every slot's generator is registered and a live slot's state
    goes in before a replay and comes back after."""
    s, seg = _cuda_pool_segment(model, monkeypatch, use_sampling=True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())

    def body(ints, fl, gens):
        registry.add_launch_counts({"paged_attention": 3})
        return torch.zeros((4, 2), dtype=torch.int32), None, None
    monkeypatch.setattr(seg, "_body", body)
    registry.reset_launch_counts()
    mine = [_FakeGen(), _FakeGen()]
    seg(*_pool_inputs(), mine)
    assert seg.launches == {"paged_attention": 3}
    assert registry.launch_counts()["paged_attention"] == 3
    assert seg.graph.generators == seg._gens and len(seg._gens) == 2
    assert [float(g.state[0]) for g in mine] == [1.0, 0.0]   # slot 1 idle
    seg(*_pool_inputs(), mine)
    assert registry.launch_counts()["paged_attention"] == 6
    assert [float(g.state[0]) for g in mine] == [2.0, 0.0]
    assert seg.calls == 2
