"""K-step decode segments (``bitnet_tpu_torch/engine/loop.py``) on the CPU.

The port's engine at ``decode_steps_per_dispatch=4`` against its own K=1
and against the JAX engine's K=4 segments (``bitnet_tpu/engine/loop.py``),
on the mini QK256 GGUF at f32 with an f32 cache on the ``xla`` path (and
one case on the F32 fixture's dense linears): the same
tokens and stop reasons for the JAX test's three generation configs
(``tests/test_engine.py:196-212``), a stop token in the middle of a segment,
the cache lengths a mid-segment stop leaves, the requests that keep single
steps (grammar, logprobs, Mirostat), the ``min_new_tokens`` phase and the
context shift.  On the CPU the segment runs its body K times eagerly; the
card's CUDA graph is mocked here only to show that a failed capture or
replay raises (no eager fallback) and that the launch counters of a capture
are taken back and added on every replay.  The card's own tests are in
``tests/test_torch_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import loop
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.engine.sampling import SamplerChain, apply_logit_bias
from bitnet_tpu_torch.engine.stop import StopReason
from bitnet_tpu_torch.ops import registry

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
PROMPT = [1, 5, 9]
# tests/test_engine.py:201-207
JAX_GENS = [dict(max_new_tokens=11, greedy=True),
            dict(max_new_tokens=10, temperature=0.9, top_k=12, seed=7),
            dict(max_new_tokens=9, temperature=0.8, top_p=0.9, repetition_penalty=1.2,
                 seed=3)]


@pytest.fixture(scope="module")
def jax_k4(mini_gguf_qk256):
    """The JAX engine at K = 4 (its segments: ``bitnet_tpu/engine/loop.py``)."""
    return JEngine.from_gguf(mini_gguf_qk256.path,
                             JEngineConfig(decode_steps_per_dispatch=4, **KW))


@pytest.fixture(scope="module")
def engines(mini_gguf_qk256):
    """The port's engine at K = 1 and K = 4, built on first use."""
    built = {}

    def get(k, **kw):
        key = (k, tuple(sorted(kw.items())))
        if key not in built:
            built[key] = InferenceEngine.from_gguf(
                mini_gguf_qk256.path,
                EngineConfig(decode_steps_per_dispatch=k, **{**KW, **kw}), device="cpu")
        return built[key]
    return get


def _calls(eng) -> int:
    return sum(seg.calls for seg in eng._segments.values())


@pytest.mark.parametrize("gen", JAX_GENS, ids=["greedy", "topk_seed7", "topp_rep_seed3"])
def test_segments_give_the_single_step_tokens(engines, gen):
    e1, e4 = engines(1), engines(4)
    before = _calls(e4)
    r1 = e1.generate(PROMPT, GenerationConfig(**gen))
    r4 = e4.generate(PROMPT, GenerationConfig(**gen))
    assert r1.token_ids == r4.token_ids and len(r4.token_ids) == gen["max_new_tokens"]
    assert r1.stop_reason == r4.stop_reason == StopReason.MAX_TOKENS
    # segments ran while at least 4 tokens remained; the rest single steps
    assert _calls(e4) - before == gen["max_new_tokens"] // 4
    assert not e1._segments


@pytest.mark.parametrize("n", [8, 11])
def test_greedy_segments_are_the_jax_segments(engines, jax_k4, n):
    """K=4 greedy tokens equal the JAX engine's at K=4, and the cache
    lengths it leaves (a last segment that ends at max_new_tokens decodes
    all its steps in both)."""
    je = jax_k4
    e4 = engines(4)
    got = e4.generate(PROMPT, GenerationConfig(max_new_tokens=n, greedy=True))
    want = je.generate(PROMPT, JGen(max_new_tokens=n, greedy=True))
    assert got.token_ids == want.token_ids
    assert got.stop_reason.value == want.stop_reason.value
    assert int(e4.cache.lengths[0]) == int(np.asarray(je.cache.lengths)[0])
    assert got.metrics["decode_steps"] == (n if n % 4 == 0 else n - 1)


def test_stop_token_mid_segment(engines):
    """tests/test_engine.py:214-224: the first token is a stop id: nothing
    is emitted."""
    e4 = engines(4)
    first = e4.generate([1, 5], GenerationConfig(max_new_tokens=1, greedy=True)).token_ids[0]
    r = e4.generate([1, 5], GenerationConfig(max_new_tokens=8, greedy=True,
                                             stop_token_ids=(first,)))
    assert r.stop_reason == StopReason.STOP_TOKEN
    assert r.token_ids == []


@pytest.mark.parametrize("at", [1, 5, 6])
def test_mid_segment_stop_leaves_the_jax_cache_lengths(engines, jax_k4, at):
    """A stop id first met at token ``at`` (0-based) inside a segment: the
    tokens before it, STOP_TOKEN, and ``cache.lengths`` / the decode steps
    of every segment run in full, as the JAX engine leaves them
    (``engine/checkpoint.capture`` reads ``lengths[0]``)."""
    e1, e4 = engines(1), engines(4)
    full = e1.generate(PROMPT, GenerationConfig(max_new_tokens=12, greedy=True)).token_ids
    at = next(j for j in range(at, 12) if full[j] not in full[:j])
    kw = dict(max_new_tokens=12, greedy=True, stop_token_ids=(full[at],))
    got = e4.generate(PROMPT, GenerationConfig(**kw))
    je = jax_k4
    want = je.generate(PROMPT, JGen(**kw))
    assert got.token_ids == want.token_ids == full[:at]
    assert got.stop_reason == StopReason.STOP_TOKEN
    ran = -(-(at + 1) // 4) * 4
    assert int(e4.cache.lengths[0]) == int(np.asarray(je.cache.lengths)[0]) \
        == len(PROMPT) + ran
    assert got.metrics["decode_steps"] == ran


def test_stop_sequence_mid_segment(engines):
    """A stop sequence ends the request at the token that completes it
    (emitted, STOP_SEQUENCE), as at K=1."""
    e1, e4 = engines(1), engines(4)
    full = e1.generate(PROMPT, GenerationConfig(max_new_tokens=12, greedy=True))
    text = next(p for p in (e1.tokenizer.token_to_piece(t) for t in full.token_ids[5:])
                if p.strip())
    kw = dict(max_new_tokens=12, greedy=True, stop_sequences=(text,))
    r1 = e1.generate(PROMPT, GenerationConfig(**kw))
    r4 = e4.generate(PROMPT, GenerationConfig(**kw))
    assert r1.token_ids == r4.token_ids and r1.stop_reason == r4.stop_reason
    assert r4.stop_reason == StopReason.STOP_SEQUENCE


@pytest.mark.parametrize("kind", ["grammar", "logprobs", "mirostat1", "mirostat2"])
def test_per_step_host_state_keeps_single_steps(engines, kind):
    """Grammar, logprobs and Mirostat requests at K=4 give the K=1 tokens
    and run no segment (``tests/test_grammar.py:304``,
    ``tests/test_logprobs.py:119``)."""
    e1, e4 = engines(1), engines(4)
    kw = {"grammar": dict(max_new_tokens=12, greedy=True, grammar='root ::= [ab]{8} "!"'),
          "logprobs": dict(max_new_tokens=9, greedy=True, logprobs=2),
          "mirostat1": dict(max_new_tokens=10, mirostat=1, seed=3),
          "mirostat2": dict(max_new_tokens=10, mirostat=2, seed=3)}[kind]
    before = _calls(e4)
    r1 = e1.generate(PROMPT, GenerationConfig(**kw))
    r4 = e4.generate(PROMPT, GenerationConfig(**kw))
    assert r1.token_ids == r4.token_ids and r1.stop_reason == r4.stop_reason
    assert r1.logprobs == r4.logprobs
    assert _calls(e4) == before


@pytest.mark.parametrize("gen", [
    dict(max_new_tokens=13, min_new_tokens=5, temperature=0.9, seed=5),
    dict(max_new_tokens=13, greedy=True, logit_bias=((7, 2.5), (9, -100.0))),
    dict(max_new_tokens=12, temperature=0.7, top_k=20, presence_penalty=0.5,
         frequency_penalty=0.3, repetition_window=4, seed=11)],
    ids=["min_phase", "logit_bias", "penalties_window4"])
def test_min_phase_bias_and_penalties_as_single_steps(engines, gen):
    """The min_new_tokens phase runs single steps, then segments; a logit
    bias (its vectors built once a chain) and presence / frequency
    penalties over a rolled window give the K=1 tokens."""
    r1 = engines(1).generate(PROMPT, GenerationConfig(**gen))
    r4 = engines(4).generate(PROMPT, GenerationConfig(**gen))
    assert r1.token_ids == r4.token_ids and r1.stop_reason == r4.stop_reason


def test_context_shift_continues_as_single_steps(engines):
    """3 prompt + 24 tokens in a 16-token context: the keep-half shift at
    K=4 continues as at K=1 (segments only where pos + K <= S)."""
    gc = GenerationConfig(max_new_tokens=24, greedy=True)
    e1, e4 = engines(1, max_seq_len=16), engines(4, max_seq_len=16)
    r1, r4 = e1.generate(PROMPT, gc), e4.generate(PROMPT, gc)
    assert r1.token_ids == r4.token_ids and len(r4.token_ids) == 24
    assert r4.stop_reason == StopReason.MAX_TOKENS
    assert any(k.startswith("context_shift") for k in e4.kernel_recorder)
    assert e4._segments
    stop = GenerationConfig(max_new_tokens=24, greedy=True)
    e1s = engines(1, max_seq_len=16, context_overflow="stop")
    e4s = engines(4, max_seq_len=16, context_overflow="stop")
    a, b = e1s.generate(PROMPT, stop), e4s.generate(PROMPT, stop)
    assert a.token_ids == b.token_ids and b.stop_reason == StopReason.CONTEXT_FULL


def test_segment_steps_auto_rule(engines):
    """0 = auto: 8 on the card, 1 elsewhere (the JAX rule with the card as
    the accelerator); a set K is kept."""
    eng = engines(0)
    assert eng._segment_steps() == 1
    dev = eng.device
    try:
        eng.device = torch.device("cuda", 0)
        assert eng._segment_steps() == 8
    finally:
        eng.device = dev
    assert engines(4)._segment_steps() == 4


def test_warmup_builds_the_segment_a_request_replays(engines):
    """``warmup`` decodes one K-step segment's tokens, so the segment that
    the next request under the same sampler config replays is built before
    it (on the card, its CUDA graph captured); the request's tokens are
    those of K = 1."""
    gcfg = GenerationConfig(**JAX_GENS[0])
    e4 = engines(4)
    e4._segments.clear()
    e4.warmup(PROMPT, gcfg)
    assert len(e4._segments) == 1 and e4.last_metrics.generated_tokens == 4
    key = next(iter(e4._segments))
    got = e4.generate(PROMPT, gcfg)
    assert list(e4._segments) == [key]
    assert got.token_ids == engines(1).generate(PROMPT, gcfg).token_ids


def test_segments_are_keyed_and_dropped_with_their_buffers(engines, monkeypatch):
    """One segment per K and sampler config (and kernel knob setting); a
    replaced cache drops the engine's segments, so none replays a graph
    over buffers the engine no longer holds."""
    from bitnet_tpu_torch.engine.cache import allocate_cache

    e4 = engines(4)
    g = GenerationConfig(max_new_tokens=8, greedy=True)
    a = e4._get_segment(g, 4)
    assert e4._get_segment(g.replace(max_new_tokens=20, seed=9), 4) is a
    assert e4._get_segment(g.replace(top_k=3), 4) is not a
    assert e4._get_segment(g, 2) is not a
    monkeypatch.setenv("BITNET_B1_ATTN", "v1")
    assert e4._get_segment(g, 4) is not a
    monkeypatch.delenv("BITNET_B1_ATTN")
    assert e4._get_segment(g, 4) is a
    old = e4.cache
    try:
        e4.cache = allocate_cache(e4.cfg, 1, e4.engine_cfg.max_seq_len, "f32", device="cpu")
        b = e4._get_segment(g, 4)
        assert b is not a and b.cache is e4.cache and list(e4._segments.values()) == [b]
        assert e4.generate(PROMPT, GenerationConfig(max_new_tokens=8, greedy=True)).token_ids \
            == engines(1).generate(PROMPT, GenerationConfig(max_new_tokens=8,
                                                            greedy=True)).token_ids
    finally:
        e4.cache = old
        e4._segments.clear()


def test_logit_bias_vectors_are_built_once_a_chain():
    chain = SamplerChain(GenerationConfig(logit_bias=((3, 2.5), (7, -100.0), (500, 1.0))))
    v1 = chain.prepare(100, "cpu")
    assert chain.prepare(100, torch.device("cpu")) is v1
    x = torch.randn(2, 100, generator=torch.Generator().manual_seed(0))
    assert torch.equal(apply_logit_bias(x, chain.config.logit_bias, v1),
                       apply_logit_bias(x, chain.config.logit_bias))
    assert SamplerChain(GenerationConfig()).prepare(100, "cpu") is None


# --------------------------------------------------------------------------
# the card's graph, mocked: raise, never fall back; the counters' arithmetic
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


def _cuda_segment(eng, gen_cfg, monkeypatch, K=4):
    """A segment typed for the card over the CPU engine's tensors; its
    eager body must never run."""
    seg = loop.build_decode_segment(eng.cfg, eng.params, eng.cache, eng.kernel_path,
                                    SamplerChain(gen_cfg), K, eng.engine_cfg.max_seq_len,
                                    torch.device("cuda", 0))
    monkeypatch.setattr(loop, "attn_counters", lambda dev: None)

    def no_eager(*a, **k):
        raise AssertionError("the eager body ran for a CUDA segment")
    monkeypatch.setattr(seg, "_eager", no_eager)
    return seg


def _inputs(eng):
    V = eng.cfg.vocab_size
    return (torch.zeros((1, V)), torch.tensor([3], dtype=torch.int32),
            torch.full((1, 8), -1, dtype=torch.int64), torch.Generator().manual_seed(0),
            torch.ones((1,), dtype=torch.int32))


def test_a_failed_capture_raises(engines, monkeypatch):
    e4 = engines(4)
    seg = _cuda_segment(e4, GenerationConfig(greedy=True), monkeypatch)

    @contextlib.contextmanager
    def failing(graph, pool=None):
        raise RuntimeError("capture failed: operation not permitted when stream "
                           "is capturing")
        yield
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", failing)
    lengths = e4.cache.lengths.clone()
    counts = registry.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        seg(*_inputs(e4))
    assert seg.graph is None
    assert torch.equal(e4.cache.lengths, lengths)
    assert registry.launch_counts() == counts


def test_a_failed_replay_raises(engines, monkeypatch):
    e4 = engines(4)
    seg = _cuda_segment(e4, GenerationConfig(temperature=0.8, seed=1), monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: _FakeGraph(RuntimeError("replay failed")))
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(loop, "forward_cache", lambda *a, **k: (None, None))
    monkeypatch.setattr(loop, "model_logits",
                        lambda cfg, p, h, kp: torch.zeros((1, 1, e4.cfg.vocab_size)))
    with pytest.raises(RuntimeError, match="replay failed"):
        seg(*_inputs(e4))
    assert seg.graph.generators == [seg._gen]        # sampled: registered


def test_capture_takes_back_its_counts_and_replays_add_them(engines, monkeypatch):
    """The wrappers' Python runs once, at capture, where nothing launches:
    its counts are taken back; every replay adds them."""
    e4 = engines(4)
    seg = _cuda_segment(e4, GenerationConfig(greedy=True), monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())

    def step(lg, pos, hist, gen, active, live):
        registry.add_launch_counts({"scatter_kv_rows": 1, "decode_attention_qkv": 2})
        return lg, pos + active, hist, pos
    monkeypatch.setattr(seg, "_step", step)
    registry.reset_launch_counts()
    seg(*_inputs(e4))
    assert seg.launches == {"scatter_kv_rows": 4, "decode_attention_qkv": 8}
    seg(*_inputs(e4))
    n = registry.launch_counts()
    assert n["scatter_kv_rows"] == 8 and n["decode_attention_qkv"] == 16
    assert seg.calls == 2


def test_segments_on_the_f32_mini_are_the_jax_segments(mini_gguf_f32):
    """The F32 mini GGUF (dense linears): K=4 greedy tokens equal the port's
    K=1 and the JAX engine's K=4."""
    e4 = InferenceEngine.from_gguf(mini_gguf_f32.path,
                                   EngineConfig(decode_steps_per_dispatch=4, **KW),
                                   device="cpu")
    e1 = InferenceEngine.from_gguf(mini_gguf_f32.path,
                                   EngineConfig(decode_steps_per_dispatch=1, **KW),
                                   device="cpu")
    je = JEngine.from_gguf(mini_gguf_f32.path, JEngineConfig(decode_steps_per_dispatch=4, **KW))
    got = e4.generate(PROMPT, GenerationConfig(max_new_tokens=11, greedy=True))
    assert got.token_ids == e1.generate(PROMPT, GenerationConfig(
        max_new_tokens=11, greedy=True)).token_ids
    assert got.token_ids == je.generate(PROMPT, JGen(max_new_tokens=11, greedy=True)).token_ids
    assert _calls(e4) == 11 // 4
