"""The port's sessions and context eviction (``engine.session``,
``engine.context``) against the JAX package's.

``evict`` and ``importance_scores`` are the JAX package's pure-Python
policy, copied: on seeded token lists every policy keeps the same tokens
and the scores are equal.  A two-turn chatml ``Session`` on the mini QK256
model (f32, ``xla`` on the CPU) renders, evicts and generates greedily
exactly as the JAX session does: the same replies, the same messages and
the same state machine.
"""

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.engine import context as jctx
from bitnet_tpu.engine import session as jsess
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import context as ctx
from bitnet_tpu_torch.engine import session as sess
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import InferenceError

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _tokens(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 40, n)]


@pytest.mark.parametrize("n", [0, 5, 50, 300])
def test_importance_scores_are_jax(n):
    ids = _tokens(n, n)
    assert ctx.importance_scores(ids) == jctx.importance_scores(ids)


@pytest.mark.parametrize("policy", list(ctx.EvictionPolicy), ids=lambda p: p.value)
@pytest.mark.parametrize("n,m,head,protect", [(300, 64, 8, 16), (300, 64, 0, 64),
                                              (40, 64, 4, 4), (100, 10, 20, 30)])
def test_evict_keeps_what_jax_keeps(policy, n, m, head, protect):
    ids = _tokens(n + m, n)
    got = ctx.evict(ids, ctx.ContextWindowConfig(m, policy, head, protect))
    want = jctx.evict(ids, jctx.ContextWindowConfig(
        m, jctx.EvictionPolicy(policy.value), head, protect))
    assert got == want and len(got) <= m


def test_state_machine_is_jax():
    states = list(sess.SessionState)
    assert [s.value for s in states] == [s.value for s in jsess.SessionState]
    for a in states:
        for b in states:
            assert a.can_transition(b) == jsess.SessionState(a.value).can_transition(
                jsess.SessionState(b.value))
    t = sess.StateTracker()
    with pytest.raises(InferenceError, match="illegal session transition"):
        t.transition(sess.SessionState.DONE)
    t.fail()
    assert t.state == sess.SessionState.ERROR
    t.transition(sess.SessionState.IDLE)


KW = dict(max_seq_len=128, compute_dtype="f32", kv_cache_dtype="f32",
          kernel_path="xla")


@pytest.mark.parametrize("keep_history", [True, False])
def test_two_turn_session_is_jax(mini_gguf_qk256, keep_history):
    pe = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**KW),
                                   device="cpu")
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(**KW))
    kw = dict(system_prompt="Be brief.", template="chatml",
              max_history_tokens=96, keep_history=keep_history)
    ps = sess.Session(pe, sess.SessionConfig(**kw))
    js = jsess.Session(je, jsess.SessionConfig(**kw))
    for turn in ("Hi there", "And again?"):
        got = ps.send(turn, GenerationConfig(max_new_tokens=8, greedy=True))
        want = js.send(turn, JGen(max_new_tokens=8, greedy=True))
        assert got == want
        assert ps.state == sess.SessionState.DONE and js.state.value == "done"
    assert ps.messages == js.messages
    assert len(ps.messages) == (5 if keep_history else 1)
    assert [h[1] for h in ps.tracker.history] == [h[1] for h in js.tracker.history]
    ps.reset()
    assert ps.messages == [{"role": "system", "content": "Be brief."}]
    assert ps.state == sess.SessionState.IDLE


def test_session_error_state(mini_gguf_qk256):
    """A failing generation leaves the session in ERROR, as in the JAX
    package; a tokenizer is required."""
    pe = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**KW),
                                   device="cpu")
    s = sess.Session(pe)
    with pytest.raises(Exception):
        s.send("x", GenerationConfig(max_new_tokens=4, greedy=True,
                                     grammar="root ::"))
    assert s.state == sess.SessionState.ERROR
    pe.tokenizer = None
    with pytest.raises(InferenceError, match="tokenizer"):
        sess.Session(pe).send("x")


def test_two_turn_session_on_the_f32_mini_is_jax(mini_gguf_f32):
    """The F32 mini GGUF (dense linears): a two-turn session's replies and
    history are the JAX session's."""
    pe = InferenceEngine.from_gguf(mini_gguf_f32.path, EngineConfig(**KW), device="cpu")
    je = JEngine.from_gguf(mini_gguf_f32.path, JEngineConfig(**KW))
    kw = dict(system_prompt="Be brief.", template="chatml", max_history_tokens=96)
    ps = sess.Session(pe, sess.SessionConfig(**kw))
    js = jsess.Session(je, jsess.SessionConfig(**kw))
    for turn in ("Hi there", "And again?"):
        assert (ps.send(turn, GenerationConfig(max_new_tokens=8, greedy=True))
                == js.send(turn, JGen(max_new_tokens=8, greedy=True)))
    assert ps.messages == js.messages
