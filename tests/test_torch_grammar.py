"""The port's grammar-constrained decoding (``bitnet_tpu_torch.grammar`` and
the engine's mask step) against the JAX package's.

The GBNF parser and matcher, the JSON-schema compiler and the vocab masks
are the port's own copies of pure-Python / numpy modules, so they are held
to the JAX package exactly: the same accept / reject verdicts, the same
GBNF text for the same schemas, and masks equal bit for bit after every
token of a seeded random walk on the mini GGUF's vocab.  The engine runs
greedy grammar-constrained generation on the mini QK256 model at f32 (the
``xla`` path on the CPU), and on the F32 mini GGUF of the JAX tests (dense
linears), and must emit the JAX engine's tokens.
"""

import json

import numpy as np
import pytest
import torch

from bitnet_tpu import grammar as jg
from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.tokenizer import load_tokenizer as jload_tokenizer
from bitnet_tpu_torch import grammar as tg
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.engine.stop import StopReason
from bitnet_tpu_torch.errors import ConfigError, InferenceError
from bitnet_tpu_torch.tokenizer import load_tokenizer

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

# (grammar source, [texts]) from tests/test_grammar.py's GBNF cases
GBNF_CASES = [
    ('root ::= "yes" | "no"', ["yes", "no", "maybe", "ye", ""]),
    ('root ::= [a-cx] [^0-9]', ["aZ", "x!", "dZ", "a5"]),
    ('root ::= "a"* "b"+ "c"?', ["b", "ab", "aaabbc", "bbb", "bc", "", "a",
                                 "ac", "cb"]),
    ('root ::= [0-9]{2,4}', ["1", "12", "1234", "12345"]),
    ('root ::= "x"{3,}', ["xx", "xxx", "x" * 10]),
    ('root ::= "(" root ")" | ""', ["", "((()))", "(()"]),
    (r'root ::= ("ab" | "cd")+ "\n" .', ["abcd\nZ", "ab\nZ\n"]),
    ('# top\nroot ::= a\n       | b  # tail\na ::= "aa"\nb ::= "bb"\n',
     ["aa", "bb", "ab"]),
    (r'root ::= "\x41" [B-D]', ["AB", "AD", "AE"]),
    (jg.JSON_GRAMMAR, ['{}', '[]', '"s"', '0', '-1.5e3', 'true', 'false', 'null',
                       '{"a": [1, 2.5], "b": {"c": null}, "d": "q\\"uote"}',
                       '[{"x": [[]]}, -0.125]', '{', '{"a":}', '{,}', '[1,]',
                       '01', '+1', "'s'", 'tru', '{"a" 1}', 'nul']),
]
BAD_GBNF = ['root ::= undefined_rule', 'noroot ::= "x"', 'root ::= "unterminated',
            'root ::= [0-9]{4,2}', 'root ::', 'root ::= "a" | | "b"']
SCHEMAS = [
    {"type": "object",
     "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                    "mood": {"enum": ["happy", "sad"]}},
     "required": ["name", "age"]},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 1, "maxItems": 2},
    {"$defs": {"leaf": {"type": "object", "properties": {"v": {"type": "number"}},
                        "required": ["v"], "additionalProperties": False}},
     "type": "object",
     "properties": {"l": {"$ref": "#/$defs/leaf"},
                    "alt": {"anyOf": [{"type": "null"}, {"type": "string"}]}},
     "required": ["l", "alt"]},
    {"type": "object", "properties": {"k": {"const": "fixed"},
                                      "n": {"type": ["integer", "null"]}},
     "required": ["k", "n"]},
    {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]},
]
BAD_SCHEMAS = [{"type": "string", "pattern": "^a+$"},
               {"$ref": "http://remote/schema"}, "{not json"]


def _verdicts(mod, src, texts):
    g = mod.Grammar.from_gbnf(src)
    out = []
    for t in texts:
        m = mod.GrammarMatcher(g)
        fed = m.feed_text(t)
        out.append((fed, fed and m.can_complete, m.would_accept("a")))
    return out


@pytest.mark.parametrize("src,texts", GBNF_CASES, ids=range(len(GBNF_CASES)))
def test_gbnf_accepts_and_rejects_as_jax(src, texts):
    assert _verdicts(tg, src, texts) == _verdicts(jg, src, texts)


@pytest.mark.parametrize("bad", BAD_GBNF)
def test_gbnf_parse_errors_raise_in_both(bad):
    with pytest.raises(jg.GrammarError):
        jg.Grammar.from_gbnf(bad)
    with pytest.raises(tg.GrammarError):
        tg.Grammar.from_gbnf(bad)
    assert issubclass(tg.GrammarError, ConfigError)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_gbnf_text_is_jax(i):
    s = SCHEMAS[i]
    assert tg.json_schema_grammar(s) == jg.json_schema_grammar(s)
    assert tg.json_schema_grammar(json.dumps(s)) == jg.json_schema_grammar(json.dumps(s))
    assert tg.JSON_GRAMMAR == jg.JSON_GRAMMAR


@pytest.mark.parametrize("bad", BAD_SCHEMAS, ids=range(len(BAD_SCHEMAS)))
def test_bad_schemas_raise_in_both(bad):
    with pytest.raises(jg.GrammarError):
        jg.json_schema_grammar(bad)
    with pytest.raises(tg.GrammarError):
        tg.json_schema_grammar(bad)


@pytest.mark.parametrize("which", ["json", "schema"])
def test_vocab_masks_equal_bit_for_bit_on_a_random_walk(mini_gguf_qk256, which):
    """Both packages' VocabMatchers on the mini GGUF's vocab: after each
    token of a walk that draws uniformly among the admissible tokens
    (seed 0), the two masks are equal bit for bit."""
    src = jg.JSON_GRAMMAR if which == "json" else jg.json_schema_grammar(SCHEMAS[0])
    tv = tg.TokenVocab.from_tokenizer(load_tokenizer(mini_gguf_qk256.path))
    jv = jg.TokenVocab.from_tokenizer(jload_tokenizer(mini_gguf_qk256.path))
    assert tv.pieces == jv.pieces and tv.eos_token_id == jv.eos_token_id
    tm = tg.VocabMatcher(tg.Grammar.from_gbnf(src), tv)
    jm = jg.VocabMatcher(jg.Grammar.from_gbnf(src), jv)
    rng = np.random.default_rng(0)
    steps = 0
    for _ in range(48):
        a, b = tm.allowed_mask(), jm.allowed_mask()
        assert a.dtype == b.dtype == np.bool_ and np.array_equal(a, b)
        ok = np.flatnonzero(a)
        assert ok.size, "the walk reached a dead end"
        t = int(rng.choice(ok))
        if t == tv.eos_token_id:
            break
        tm.accept(t)
        jm.accept(t)
        steps += 1
    assert steps >= 8
    assert tm.exhausted == jm.exhausted


# ------------------------------------------------------------------ engine
KW = dict(max_seq_len=128, compute_dtype="f32", kv_cache_dtype="f32",
          kernel_path="xla")
PROMPT = [1, 7, 20, 3]


@pytest.fixture(scope="module")
def engines(mini_gguf_qk256):
    return (InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**KW),
                                      device="cpu"),
            JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(**KW)))


GRAMMARS = {
    "yes_no": 'root ::= "yes" | "no"',
    "zzz_digits": 'root ::= "zzz" [0-9]*',
    "schema": jg.json_schema_grammar(SCHEMAS[4]),
    "json": jg.JSON_GRAMMAR,
    "ab_bang": 'root ::= [ab]{8} "!"',
}


@pytest.mark.parametrize("name", list(GRAMMARS))
def test_greedy_grammar_generation_is_jax(engines, name):
    pe, je = engines
    kw = dict(max_new_tokens=24, greedy=True, grammar=GRAMMARS[name])
    got = pe.generate(PROMPT, GenerationConfig(**kw))
    want = je.generate(PROMPT, JGen(**kw))
    assert got.token_ids == want.token_ids and got.text == want.text
    assert got.stop_reason.value == want.stop_reason.value
    # every token admissible under a fresh matcher
    m = tg.VocabMatcher(tg.Grammar.from_gbnf(GRAMMARS[name]), pe._grammar_vocab)
    for t in got.token_ids:
        assert m.allowed_mask()[t]
        m.accept(t)
    if name == "yes_no":
        assert got.text in ("yes", "no") and got.stop_reason == StopReason.EOS


def test_sampled_grammar_output_stays_in_the_grammar(engines):
    pe, _ = engines
    gc = GenerationConfig(max_new_tokens=24, temperature=1.5, seed=11,
                          grammar=GRAMMARS["ab_bang"])
    r = pe.generate(PROMPT, gc)
    assert len(r.text) == 9 and r.text.endswith("!") and set(r.text[:8]) <= {"a", "b"}
    assert r.stop_reason == StopReason.EOS
    assert pe.generate(PROMPT, gc).token_ids == r.token_ids


def test_min_tokens_dead_end_stops_as_jax(engines):
    """A grammar that completes after one token while min_new_tokens bans
    EOS: both engines stop at the dead end with EOS."""
    pe, je = engines
    kw = dict(max_new_tokens=8, min_new_tokens=4, greedy=True,
              grammar='root ::= "y"')
    got = pe.generate(PROMPT, GenerationConfig(**kw))
    want = je.generate(PROMPT, JGen(**kw))
    assert got.token_ids == want.token_ids
    assert got.stop_reason == StopReason.EOS
    assert "grammar_dead_end" in pe.kernel_recorder


def test_batch_api_refuses_a_grammar_with_the_jax_wording(engines):
    pe, je = engines
    with pytest.raises(InferenceError) as got:
        pe.generate_batch([PROMPT], GenerationConfig(grammar=jg.JSON_GRAMMAR))
    with pytest.raises(Exception) as want:
        je.generate_batch([PROMPT], JGen(grammar=jg.JSON_GRAMMAR))
    assert str(got.value) == str(want.value)


def test_bad_grammar_raises(engines):
    with pytest.raises(tg.GrammarError):
        engines[0].generate(PROMPT, GenerationConfig(grammar="root ::"))


def test_a_mask_over_another_vocab_raises(mini_gguf_qk256):
    """A tokenizer whose vocab is not the model's: the mask never
    broadcasts against the logits, it raises."""
    from bitnet_tpu_torch.tokenizer import MockTokenizer

    pe = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**KW),
                                   tokenizer=MockTokenizer(300), device="cpu")
    with pytest.raises(InferenceError, match="grammar mask over 300 tokens"):
        pe.generate(PROMPT, GenerationConfig(greedy=True, grammar='root ::= "a"'))


def test_greedy_grammar_on_the_f32_mini_is_jax(mini_gguf_f32):
    """The F32 mini GGUF (dense linears, the JAX tests' fixture): greedy
    grammar-constrained tokens equal the JAX engine's."""
    pe = InferenceEngine.from_gguf(mini_gguf_f32.path, EngineConfig(**KW), device="cpu")
    je = JEngine.from_gguf(mini_gguf_f32.path, JEngineConfig(**KW))
    kw = dict(max_new_tokens=24, greedy=True, grammar=GRAMMARS["schema"])
    got = pe.generate(PROMPT, GenerationConfig(**kw))
    want = je.generate(PROMPT, JGen(**kw))
    assert got.token_ids == want.token_ids and got.text == want.text
    assert pe.load_report.kinds["wq"] == "dense"
