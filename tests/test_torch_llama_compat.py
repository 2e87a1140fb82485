"""``bitnet_tpu_torch.compat.llama`` (the llama-cpp-python drop-in) against
``bitnet_tpu.compat.llama`` on an f32 mini GGUF, both engines at f32
(compute and KV cache: the test swaps each module's ``EngineConfig`` for
one with those defaults), the port with ``device="cpu"``, ``n_ctx`` 64:

- ``tokenize`` / ``detokenize`` equal; ``eval``'s last logits within 2e-5
  of the largest (the same weights, f32 sums in another order);
- greedy ``create_completion`` and ``create_chat_completion``, streamed and
  not, with a grammar and with a ``logit_bias``, the same text, tokens and
  usage; the streamed chunks join to the unstreamed text;
- ``create_embedding`` within 2e-5 of the largest value (the final-normed
  hidden state's mean, f32);
- ``save_state`` / ``load_state`` round-trip ``n_past`` and the next greedy
  token, and the rows within 2e-5;
- sampled ``sample`` held through the same uniform draws, not through
  sampled tokens (the packages' PRNG streams differ): the port's uniforms
  replaced by ``jax.random.uniform`` of the key the JAX class builds from
  the same seed, which its ``torch.Generator`` carries (seed, seed + 1, …).
"""

import functools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bitnet_tpu.compat import llama as jllama
from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.gguf.fixtures import MiniModelSpec, generate_mini_gguf
from bitnet_tpu_torch.compat import llama as tllama
from bitnet_tpu_torch.config import EngineConfig
from bitnet_tpu_torch.engine import sampling

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

F32 = dict(compute_dtype="f32", kv_cache_dtype="f32")
N_CTX = 64
SEED = 7
PROMPT = "The quick brown fox"


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    p = tmp_path_factory.mktemp("llama") / "mini.gguf"
    generate_mini_gguf(str(p), MiniModelSpec(hidden_size=128, intermediate_size=256,
                                             quant="f32", max_seq_len=128))
    return str(p)


def _pair(mini, **kw):
    mp = pytest.MonkeyPatch()
    mp.setattr(jllama, "EngineConfig", functools.partial(JEngineConfig, **F32))
    mp.setattr(tllama, "EngineConfig", functools.partial(EngineConfig, **F32))
    try:
        return (tllama.Llama(mini, n_ctx=N_CTX, seed=SEED, verbose=False, device="cpu",
                             **kw),
                jllama.Llama(mini, n_ctx=N_CTX, seed=SEED, verbose=False, **kw))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def pair(mini):
    """(port, JAX) ``Llama`` over the same GGUF at f32, seed 7."""
    return _pair(mini)


@pytest.fixture(scope="module")
def chat_pair(mini):
    """The same with ``chat_format="instruct"`` (the mini's own template
    renders a prompt longer than ``n_ctx``)."""
    return _pair(mini, chat_format="instruct")


def _close(got, want, rel=2e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_the_engine_is_f32_on_the_cpu_and_the_knobs_are_the_jax_ones(pair):
    t, j = pair
    assert t._engine.device.type == "cpu"
    assert t._engine.engine_cfg.compute_dtype == j._engine.engine_cfg.compute_dtype == "f32"
    assert (t.n_ctx, t.n_embd, t.n_vocab, t.n_vocab_()) == (j.n_ctx, j.n_embd, j.n_vocab,
                                                           j.n_vocab_())
    assert list(t.metadata) == list(j.metadata) and t._template.value == j._template.value
    assert {k: v for k, v in t.metadata.items() if isinstance(v, (int, float, str))} == {
        k: v for k, v in j.metadata.items() if isinstance(v, (int, float, str))}


@pytest.mark.parametrize("text", ["Hello world", PROMPT, "a, b; c!", b"bytes in"])
@pytest.mark.parametrize("add_bos", [True, False])
def test_tokenize_and_detokenize_are_the_jax_ones(pair, text, add_bos):
    t, j = pair
    ids = t.tokenize(text, add_bos=add_bos)
    assert ids == j.tokenize(text, add_bos=add_bos) and ids
    assert t.detokenize(ids) == j.detokenize(ids)


def test_eval_gives_the_jax_logits(pair):
    t, j = pair
    for llm in pair:
        llm.reset()
        llm.eval(llm.tokenize(PROMPT))
    _close(t._last_logits, j._last_logits)
    for llm in pair:
        llm.eval([5, 9])
    assert t._n_past == j._n_past == len(t.tokenize(PROMPT)) + 2
    _close(t._last_logits, j._last_logits)
    with pytest.raises(RuntimeError, match="eval"):
        t.reset() or t.sample()
    j.reset()


def _completion(llm, **kw):
    out = llm.create_completion(PROMPT, max_tokens=8, temperature=0.0, **kw)
    for k in ("id", "created", "model"):
        out.pop(k)
    return out


def _joined(chunks, chat):
    key = "delta" if chat else None
    parts, last = [], None
    for c in chunks:
        ch = c["choices"][0]
        parts.append((ch[key].get("content") or "") if chat else ch["text"])
        last = ch["finish_reason"]
    return "".join(parts), last


@pytest.mark.parametrize("kw", [
    {}, {"logit_bias": {5: 5.0, 7: -100.0}},
    {"grammar": 'root ::= [a-z ]{4,12} "."\n'},
    {"stop": ["e"]}, {"echo": True}, {"logprobs": 2}],
    ids=["greedy", "logit_bias", "grammar", "stop", "echo", "logprobs"])
def test_greedy_completions_are_the_jax_ones(pair, kw):
    t, j = pair
    kt = dict(kw)
    if "grammar" in kw:
        kt["grammar"] = tllama.LlamaGrammar.from_string(kw["grammar"])
        kw = dict(kw, grammar=jllama.LlamaGrammar.from_string(kw["grammar"]))
    got, want = _completion(t, **kt), _completion(j, **kw)
    glp, wlp = got["choices"][0].pop("logprobs"), want["choices"][0].pop("logprobs")
    assert got == want and got["usage"]["completion_tokens"] >= 1
    if "logprobs" in kw:
        assert glp["tokens"] == wlp["tokens"] and glp["text_offset"] == wlp["text_offset"]
        _close(glp["token_logprobs"], wlp["token_logprobs"], 1e-4)
    else:
        assert glp is wlp is None
    if "echo" not in kw and "logprobs" not in kw:
        stream = t.create_completion(PROMPT, max_tokens=8, temperature=0.0,
                                     stream=True, **kt)
        text, reason = _joined(stream, chat=False)
        assert (text, reason) == (got["choices"][0]["text"],
                                  got["choices"][0]["finish_reason"])


def test_a_batch_of_prompts_is_the_jax_merge(pair):
    t, j = pair
    got = t.create_completion([PROMPT, "Hello"], max_tokens=4, temperature=0.0)
    want = j.create_completion([PROMPT, "Hello"], max_tokens=4, temperature=0.0)
    assert got["choices"] == want["choices"] and got["usage"] == want["usage"]


MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Hi"}]


@pytest.mark.parametrize("stream", [False, True])
def test_greedy_chat_completions_are_the_jax_ones(chat_pair, stream):
    t, j = chat_pair
    kw = dict(max_tokens=8, temperature=0.0, stream=stream)
    got, want = t.create_chat_completion(MESSAGES, **kw), \
        j.create_chat_completion(MESSAGES, **kw)
    if stream:
        got, want = list(got), list(want)
        assert [c["choices"] for c in got] == [c["choices"] for c in want]
        assert got[0]["choices"][0]["delta"] == {"role": "assistant"}
        text, reason = _joined(got, chat=True)
        plain = t.create_chat_completion(MESSAGES, max_tokens=8, temperature=0.0)
        assert (text, reason) == (plain["choices"][0]["message"]["content"],
                                  plain["choices"][0]["finish_reason"])
    else:
        assert got["choices"] == want["choices"] and got["usage"] == want["usage"]
        assert got["object"] == "chat.completion"


def test_embeddings_are_the_jax_ones(pair):
    t, j = pair
    got, want = t.create_embedding(["Hello world", PROMPT]), \
        j.create_embedding(["Hello world", PROMPT])
    assert got["usage"] == want["usage"] and len(got["data"]) == 2
    for a, b in zip(got["data"], want["data"]):
        assert a["index"] == b["index"] and len(a["embedding"]) == t.n_embd
        _close(a["embedding"], b["embedding"])
    _close(t.embed("Hello world"), j.embed("Hello world"))


def test_save_and_load_state_round_trip_as_jax(pair):
    ids = pair[0].tokenize(PROMPT)
    nxt = []
    for llm in pair:
        llm.reset()
        llm.eval(ids)
        st = llm.save_state()
        tok = llm.sample(temperature=0.0)
        llm.eval([3, 4, 5])
        llm.load_state(st)
        assert llm._n_past == st.kv_len == len(ids)
        llm.eval([tok])
        nxt.append((tok, llm.sample(temperature=0.0), st))
    (t1, t2, ts), (j1, j2, js) = nxt
    assert (t1, t2) == (j1, j2)
    _close(np.asarray(ts.k, np.float32), np.asarray(js.k, np.float32))


def test_generate_yields_the_jax_tokens(pair):
    outs = []
    for llm in pair:
        gen = llm.generate(llm.tokenize(PROMPT), temperature=0.0)
        outs.append([next(gen) for _ in range(4)])
    assert outs[0] == outs[1]


@pytest.fixture
def jax_uniforms(monkeypatch):
    """The port's uniforms replaced by the JAX key's of the same seed; the
    seeds the port's generators carried, in order."""
    seeds = []

    def draw(shape, generator, device):
        seed = generator.initial_seed()
        seeds.append(seed)
        u = jax.random.uniform(jax.random.PRNGKey(seed), tuple(shape), jnp.float32,
                               minval=sampling.TINY, maxval=1.0)
        return torch.from_numpy(np.array(u)).to(device)

    monkeypatch.setattr(sampling, "draw_uniforms", draw)
    return seeds


@pytest.mark.parametrize("kw", [
    {}, {"temperature": 1.2, "top_k": 0, "top_p": 1.0, "repeat_penalty": 1.0},
    {"top_k": 5, "frequency_penalty": 0.5, "presence_penalty": 0.3,
     "logit_bias": {3: 4.0, 11: -100.0}},
    {"mirostat_mode": 2, "mirostat_tau": 3.0},
    {"mirostat_mode": 1, "mirostat_tau": 4.0}],
    ids=["defaults", "plain", "penalties", "mirostat2", "mirostat1"])
def test_sample_takes_the_jax_uniforms(pair, jax_uniforms, kw):
    t, j = pair
    ids = t.tokenize(PROMPT) + [3, 3, 11]
    for llm in pair:
        llm.reset()
        llm._seed = 100
        llm.eval(ids)
    got = [t.sample(**kw) for _ in range(6)]
    want = [j.sample(**kw) for _ in range(6)]
    assert got == want and jax_uniforms == list(range(100, 106))
    assert t._seed == j._seed == 106
    assert len(set(got)) > 1 or "mirostat_mode" in kw


def test_an_unseeded_sample_uses_the_clock(mini, monkeypatch):
    monkeypatch.setattr(tllama, "EngineConfig", functools.partial(EngineConfig, **F32))
    llm = tllama.Llama(mini, n_ctx=N_CTX, verbose=False, device="cpu", n_gpu_layers=99,
                       n_threads=4, tensor_split=[1.0])
    assert llm._seed is None
    llm.eval(llm.tokenize("Hi"))
    assert 0 <= llm.sample() < llm.n_vocab and llm._seed is None


def test_grammar_cache_and_backend_helpers_are_the_jax_ones(tmp_path):
    from bitnet_tpu_torch.grammar import GrammarError

    with pytest.raises(GrammarError):
        tllama.LlamaGrammar.from_string("root ::= (")
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
    assert str(tllama.LlamaGrammar.from_json_schema(schema)) == str(
        jllama.LlamaGrammar.from_json_schema(schema))
    f = tmp_path / "g.gbnf"
    f.write_text('root ::= "yes" | "no"\n')
    assert str(tllama.LlamaGrammar.from_file(str(f))) == 'root ::= "yes" | "no"\n'
    c = tllama.LlamaCache(capacity=8)
    c.data["k"] = 1
    assert pickle.loads(pickle.dumps(c)).data == {"k": 1}
    assert tllama.llama_backend_init() is None and tllama.llama_backend_free() is None
    from bitnet_tpu_torch import compat

    assert compat.__all__ == ["Llama", "LlamaCache", "LlamaGrammar",
                              "llama_backend_init", "llama_backend_free"]
