"""Speculative decoding in the port (``bitnet_tpu_torch/engine/speculative.py``,
the scheduler's ``speculative_k``) held to the JAX package on the CPU.

On the mini QK256 GGUF at ``compute_dtype="f32"``, an f32 cache and
``kernel_path="xla"`` on both sides (the JAX package's own speculative
tests use the F32 fixture; one case here runs it, dense linears).  Mirrors ``tests/test_speculative.py`` and
``tests/test_serve.py:967-1075``:

- ``NgramDraft``'s proposals over seeded histories, ``SpeculativeConfig``'s
  errors and ``AcceptanceStats`` are the JAX package's;
- greedy speculative tokens (n-gram and ``EngineDraft``) and the
  ``threshold`` policy give the JAX decoder's tokens and stats (rounds,
  proposed, accepted), and greedy ones the port's plain greedy tokens;
  near the context's end ``k_eff`` shrinks as in the JAX decoder; a stop
  token ends the text where plain decoding ends it; grammar, logprobs and
  sampling under the greedy policy raise;
- the verify leaves the rows of the slots it masks untouched (f32 and int8
  caches);
- the scheduler: spec tokens equal ``generate``'s in fewer dispatches than
  tokens, a sampled slot beside spec slots keeps its tokens, two spec slots
  verify in one dispatch, a paged pool raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.engine import speculative as jspec
from bitnet_tpu.errors import InferenceError as JInferenceError
from bitnet_tpu.models import load_model as jload_model
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import speculative as spec
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import InferenceError
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
from bitnet_tpu_torch.tokenizer import load_tokenizer

torch.set_num_threads(1)

KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
PROMPTS = {"plain": [2, 7, 11, 13, 17], "repetitive": [1, 7, 20, 3, 1, 7, 20, 3, 1, 7]}


@pytest.fixture(scope="module")
def jmodel(mini_gguf_qk256):
    cfg, params, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    return cfg, params


def jengine(jmodel):
    return JEngine(*jmodel, JEngineConfig(**KW))


def engine(path, **kw):
    return InferenceEngine.from_gguf(path, EngineConfig(**{**KW, **kw}), device="cpu")


# --------------------------------------------------------------------------
# the host parts: drafts, config, stats
# --------------------------------------------------------------------------
@pytest.mark.parametrize("max_ngram", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("seed", range(4))
def test_ngram_proposals_are_the_jax_packages(seed, k, max_ngram):
    """Seeded histories over a small alphabet (repeats, so suffixes match),
    every prefix length: the same proposal, padding and fallback."""
    rng = np.random.default_rng(seed)
    hist = [int(t) for t in rng.integers(0, 5, 24)]
    mine, theirs = spec.NgramDraft(max_ngram), jspec.NgramDraft(max_ngram)
    for n in range(0, len(hist) + 1):
        assert mine.propose(hist[:n], k) == theirs.propose(hist[:n], k)


@pytest.mark.parametrize("tokens,k,want", [
    ([1, 5, 6, 7, 9, 5, 6, 7], 3, None), ([5, 6, 7, 9, 2, 5, 6, 7], 2, [9, 2]),
    ([3, 1, 4], 3, [4, 4, 4]), ([7, 8, 7], 4, None)])
def test_ngram_cases_of_the_jax_tests(tokens, k, want):
    got = spec.NgramDraft(max_ngram=1 if k == 4 else 3).propose(tokens, k)
    assert got == jspec.NgramDraft(max_ngram=1 if k == 4 else 3).propose(tokens, k)
    assert len(got) == k and (want is None or got == want)


@pytest.mark.parametrize("kw", [dict(num_draft_tokens=0), dict(policy="bogus"),
                                dict(num_draft_tokens=-3, policy="threshold")])
def test_config_errors_are_the_jax_packages(kw):
    with pytest.raises(JInferenceError) as want:
        jspec.SpeculativeConfig(**kw)
    with pytest.raises(InferenceError) as got:
        spec.SpeculativeConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("counts", [(0, 0, 0), (2, 8, 6), (7, 28, 8), (3, 9, 1)])
def test_acceptance_stats_are_the_jax_packages(counts):
    mine, theirs = spec.AcceptanceStats(*counts), jspec.AcceptanceStats(*counts)
    assert mine.acceptance_rate == theirs.acceptance_rate
    assert mine.as_dict() == theirs.as_dict()


# --------------------------------------------------------------------------
# the decoder against the JAX decoder
# --------------------------------------------------------------------------
def _pair(jmodel, path, draft, cfg_kw):
    if draft == "engine":
        jd, d = jspec.EngineDraft(jengine(jmodel)), spec.EngineDraft(engine(path))
    else:
        jd = d = None
    return (jspec.SpeculativeDecoder(jengine(jmodel), jd, jspec.SpeculativeConfig(**cfg_kw)),
            spec.SpeculativeDecoder(engine(path), d, spec.SpeculativeConfig(**cfg_kw)))


def _counts(stats):
    return {k: stats[k] for k in ("rounds", "proposed", "accepted")}


@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("draft,k", [("ngram", 4), ("ngram", 2), ("engine", 3)])
def test_greedy_tokens_are_the_jax_decoders(jmodel, mini_gguf_qk256, draft, k, prompt):
    gen = dict(max_new_tokens=16, greedy=True)
    p = PROMPTS[prompt]
    jdec, dec = _pair(jmodel, mini_gguf_qk256.path, draft, dict(num_draft_tokens=k))
    want = jdec.generate(p, JGen(**gen))
    got = dec.generate(p, GenerationConfig(**gen))
    plain = engine(mini_gguf_qk256.path).generate(p, GenerationConfig(**gen))
    assert got.token_ids == want.token_ids == plain.token_ids
    assert got.stop_reason.value == want.stop_reason.value
    assert _counts(got.spec_stats) == _counts(want.spec_stats)
    assert got.spec_stats["rounds"] > 0
    if draft == "engine":           # the same model drafts every token
        assert got.spec_stats["acceptance_rate"] == 1.0
    assert [r for r in dec.engine.kernel_recorder if r.startswith("spec_verify")]


@pytest.mark.parametrize("threshold", [0.05, 0.004, 0.0])
def test_threshold_policy_is_the_jax_decoders(jmodel, mini_gguf_qk256, threshold):
    gen = dict(max_new_tokens=12, greedy=True)
    jdec, dec = _pair(jmodel, mini_gguf_qk256.path, "ngram",
                      dict(num_draft_tokens=3, policy="threshold",
                           accept_threshold=threshold))
    want = jdec.generate([2, 7, 11], JGen(**gen))
    got = dec.generate([2, 7, 11], GenerationConfig(**gen))
    assert got.token_ids == want.token_ids and len(got.token_ids) <= 12
    assert _counts(got.spec_stats) == _counts(want.spec_stats)
    if threshold == 0.0:            # every draft passes
        assert got.spec_stats["acceptance_rate"] == 1.0


def test_k_eff_shrinks_near_the_context_end(jmodel, mini_gguf_qk256):
    """A prompt 8 short of S: the last rounds verify fewer than k drafts,
    and the text ends at the context's end as the JAX decoder's does."""
    p = [(5 * i + 3) % 200 for i in range(56)]
    gen = dict(max_new_tokens=32, greedy=True)
    jdec, dec = _pair(jmodel, mini_gguf_qk256.path, "ngram", dict(num_draft_tokens=4))
    want = jdec.generate(p, JGen(**gen))
    got = dec.generate(p, GenerationConfig(**gen))
    assert got.token_ids == want.token_ids and len(got.token_ids) < 32
    assert got.stop_reason.value == want.stop_reason.value
    assert _counts(got.spec_stats) == _counts(want.spec_stats)
    assert got.spec_stats["proposed"] < 4 * got.spec_stats["rounds"]


def test_stop_token_is_respected(jmodel, mini_gguf_qk256):
    gen = dict(max_new_tokens=16, greedy=True)
    p = PROMPTS["plain"]
    golden = engine(mini_gguf_qk256.path).generate(p, GenerationConfig(**gen)).token_ids
    stop_at = golden[5]
    jdec, dec = _pair(jmodel, mini_gguf_qk256.path, "ngram", {})
    want = jdec.generate(p, JGen(**gen, stop_token_ids=(stop_at,)))
    got = dec.generate(p, GenerationConfig(**gen, stop_token_ids=(stop_at,)))
    cut = golden.index(stop_at)
    assert got.token_ids == want.token_ids == golden[:cut]
    assert got.stop_reason.value == want.stop_reason.value == "stop_token"


@pytest.mark.parametrize("gen_kw", [dict(greedy=True, grammar='root ::= "a"'),
                                    dict(greedy=True, logprobs=2),
                                    dict(temperature=0.8, seed=3)],
                         ids=["grammar", "logprobs", "sampled"])
def test_refusals_are_the_jax_decoders(jmodel, mini_gguf_qk256, gen_kw):
    jdec, dec = _pair(jmodel, mini_gguf_qk256.path, "ngram", {})
    with pytest.raises(JInferenceError) as want:
        jdec.generate([1, 2, 3], JGen(max_new_tokens=4, **gen_kw))
    with pytest.raises(InferenceError) as got:
        dec.generate([1, 2, 3], GenerationConfig(max_new_tokens=4, **gen_kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_verify_leaves_masked_slots_untouched(mini_gguf_qk256, kv):
    """A pool of 3: slot 1 verifies 5 tokens, slots 0 and 2 (holding rows)
    are masked; their rows (and an int8 cache's scales) are bit for bit
    what they were, slot 1's length moved by 5 and its logits rows are the
    same rows as a verify of slot 1 alone."""
    eng = engine(mini_gguf_qk256.path, max_batch_size=3, kv_cache_dtype=kv)
    eng.prefill_batch([[1, 5, 9, 4], [2, 6, 8], [3, 7, 11, 12, 13]])
    c = eng.cache
    before = {n: getattr(c, n).clone() for n in ("k", "v", "k_scale", "v_scale")
              if getattr(c, n) is not None}
    T, S = 5, eng.engine_cfg.max_seq_len
    inp = spec.verify_input(3, T, S)
    inp[1, :T] = [40, 41, 42, 43, 44]
    inp[1, T:2 * T] = np.arange(3, 3 + T)
    inp[1, 2 * T], inp[1, 2 * T + 1] = 3, T
    step = spec.VerifyStep(eng.cfg, eng.params, c, "xla", T, 3, True, "cpu")
    best, probs = step(inp)
    assert best.shape == (3, T) and probs.shape == (3, T - 1)
    assert c.lengths.tolist() == [4, 8, 5]
    for n, t in before.items():
        now = getattr(c, n)
        for b in (0, 2):
            assert torch.equal(now[:, b], t[:, b]), (n, b)
        assert not torch.equal(now[:, 1], t[:, 1])
    c.lengths[1] = 3
    alone = spec.verify_input(3, T, S)
    alone[1] = inp[1]
    best2, _ = spec.VerifyStep(eng.cfg, eng.params, c, "xla", T, 3, False, "cpu")(alone)
    np.testing.assert_array_equal(best2[1], best[1])


# --------------------------------------------------------------------------
# the scheduler's speculative_k (tests/test_serve.py:967-1075)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model(mini_gguf_qk256):
    cfg, params, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32,
                                device="cpu")
    return cfg, params, load_tokenizer(mini_gguf_qk256.path)


def scheduler(model, **kw):
    cfg, params, tok = model
    kw.setdefault("num_slots", 2)
    return ContinuousBatchingScheduler(cfg, params, tok, EngineConfig(**KW),
                                       device="cpu", **kw)


def collect(req, timeout=120):
    toks = []
    while True:
        tok, _, done, reason = req.out.get(timeout=timeout)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks, reason


@pytest.mark.parametrize("k", [4, 2])
def test_scheduler_spec_tokens_are_generates(model, mini_gguf_qk256, k):
    gen = GenerationConfig(max_new_tokens=24, greedy=True)
    prompt = PROMPTS["repetitive"]
    want = engine(mini_gguf_qk256.path).generate(prompt, gen)
    s = scheduler(model, speculative_k=k)
    try:
        toks, reason = collect(s.submit(prompt, gen))
    finally:
        s.shutdown()
    assert toks == want.token_ids and reason == want.stop_reason
    assert s.stats["spec_drafted"] > 0 and s.stats["spec_accepted"] > 0
    assert s.stats["decode_steps"] < len(toks)


def test_scheduler_mixed_pool_keeps_the_sampled_tokens(model, mini_gguf_qk256):
    g_greedy = GenerationConfig(max_new_tokens=12, greedy=True)
    g_sampled = GenerationConfig(max_new_tokens=12, temperature=0.9, seed=17)
    eng = engine(mini_gguf_qk256.path)
    want_g = eng.generate([1, 7, 20, 1, 7], g_greedy).token_ids
    want_s = eng.generate([2, 9, 4], g_sampled).token_ids
    s = scheduler(model, speculative_k=3)
    try:
        a = s.submit([1, 7, 20, 1, 7], g_greedy)
        b = s.submit([2, 9, 4], g_sampled)
        assert collect(a)[0] == want_g
        assert collect(b)[0] == want_s
    finally:
        s.shutdown()


def test_scheduler_two_spec_slots_verify_in_one_dispatch(model, mini_gguf_qk256):
    eng = engine(mini_gguf_qk256.path)
    gen = GenerationConfig(max_new_tokens=16, greedy=True)
    pa, pb = [1, 7, 20, 3, 1, 7, 20, 3], [2, 9, 4, 2, 9, 4]
    want_a, want_b = eng.generate(pa, gen).token_ids, eng.generate(pb, gen).token_ids
    s = scheduler(model, speculative_k=4, start_loop=False)
    a, b = s.submit(pa, gen), s.submit(pb, gen)
    for _ in range(100):
        s._step()
        if not any(sl.occupied for sl in s.slots) and s.pending.empty():
            break
    calls = sum(v.calls for v in s._verifies.values())
    ta, tb = collect(a, 0)[0], collect(b, 0)[0]
    assert ta == want_a and tb == want_b
    # both slots in every verify: one call a step, fewer steps than tokens
    assert calls == s.stats["decode_steps"] < len(ta) + len(tb)


@pytest.mark.parametrize("kw", [dict(paged=True, num_pages=8),
                                dict(paged=True, num_pages=8, num_slots=1)])
def test_scheduler_spec_on_a_paged_pool_raises(model, jmodel, kw):
    from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler as JScheduler

    jkw = {"num_slots": 2, **kw}
    with pytest.raises(JInferenceError) as want:
        JScheduler(*jmodel, None, JEngineConfig(**KW), speculative_k=2,
                   start_loop=False, **jkw)
    with pytest.raises(InferenceError) as got:
        scheduler(model, speculative_k=2, start_loop=False, **jkw)
    assert str(got.value) == str(want.value)


def test_greedy_tokens_on_the_f32_mini_are_the_jax_decoders(mini_gguf_f32):
    """The F32 mini GGUF (dense linears; the JAX speculative tests'
    fixture): n-gram k=4 greedy tokens and acceptance counts are the JAX
    decoder's, and the plain engine's tokens."""
    p = mini_gguf_f32.path
    gen = dict(max_new_tokens=16, greedy=True)
    prompt = PROMPTS["repetitive"]
    jdec = jspec.SpeculativeDecoder(JEngine.from_gguf(p, JEngineConfig(**KW)), None,
                                    jspec.SpeculativeConfig(num_draft_tokens=4))
    dec = spec.SpeculativeDecoder(engine(p), None, spec.SpeculativeConfig(num_draft_tokens=4))
    want = jdec.generate(prompt, JGen(**gen))
    got = dec.generate(prompt, GenerationConfig(**gen))
    assert got.token_ids == want.token_ids == engine(p).generate(
        prompt, GenerationConfig(**gen)).token_ids
    assert _counts(got.spec_stats) == _counts(want.spec_stats)
