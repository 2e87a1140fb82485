"""The port's decode-state checkpoints (``engine.checkpoint``) against the
JAX package's, in both directions.

Both packages write the same files (``<path>.npz`` + ``<path>.json``: the
same array names, schema version and sha256; bf16 as a ``uint16`` view and
fp8 as a ``uint8`` view named in ``packed_dtypes``).  On the mini QK256
model (f32 compute, ``xla`` on the CPU) with bf16, f32, int8 (with scales)
and fp8 caches:

- a generation broken off after 5 tokens, captured, saved, loaded and
  resumed on a reset engine gives the unbroken run's tokens exactly (the
  5th token was yielded but not decoded, so ``kv_len`` is the prompt plus
  4; the resume decodes it again);
- a state the JAX package writes loads in the port with the same bytes,
  and restored there resumes to the JAX engine's greedy tokens;
- a state the port writes loads in the JAX package with the same bytes,
  and the JAX engine resumes it to its own greedy tokens;
- the integrity check, the shape check and ``save_diff`` / ``apply_diff``
  behave as ``tests/test_checkpoint_obs.py:37-116`` has them in the JAX
  package, and a diff crosses packages too.
"""

import json

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.engine import checkpoint as jck
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import checkpoint as ck
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import InferenceError

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KVS = ["bf16", "f32", "int8", "fp8"]
PROMPT = [2, 7, 11, 13, 17]
N, BREAK = 12, 5
KEY = np.array([0, 5], np.uint32)


def _kw(kv):
    return dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype=kv,
                kernel_path="xla")


@pytest.fixture(scope="module")
def engines(mini_gguf_qk256):
    """(port, JAX) engines of one cache dtype, built on first use."""
    built = {}

    def get(kv):
        if kv not in built:
            p = mini_gguf_qk256.path
            built[kv] = (
                InferenceEngine.from_gguf(p, EngineConfig(**_kw(kv)), device="cpu"),
                JEngine.from_gguf(p, JEngineConfig(**_kw(kv))))
        return built[kv]
    return get


def _broken(eng, gen):
    """The first BREAK tokens of a stream, then the stream abandoned."""
    first = []
    for ev in eng.generate_stream(PROMPT, gen):
        first.append(ev.token_id)
        if len(first) == BREAK:
            break
    return first


def _bytes(a) -> np.ndarray:
    """A state array's raw bytes (numpy, torch bf16 / fp8, or ml_dtypes)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def _same_state(a, b):
    assert a.prompt_ids == b.prompt_ids and a.generated_ids == b.generated_ids
    assert a.kv_len == b.kv_len
    for name in ("k", "v", "k_scale", "v_scale"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert tuple(x.shape) == tuple(y.shape), name
            assert np.array_equal(_bytes(x), _bytes(y)), name
    assert np.array_equal(np.asarray(a.rng_key), np.asarray(b.rng_key))


@pytest.mark.parametrize("kv", KVS)
def test_resume_matches_the_unbroken_run(engines, tmp_path, kv):
    pe, _ = engines(kv)
    gen = GenerationConfig(max_new_tokens=N, greedy=True)
    golden = pe.generate(PROMPT, gen).token_ids
    first = _broken(pe, gen)
    state = ck.capture(pe, PROMPT, first, rng_key=KEY)
    man = ck.save(state, str(tmp_path / "gen"))
    assert man["kv_len"] == len(PROMPT) + BREAK - 1
    pe.prefill([9, 9, 9])                      # the engine moves on
    res = ck.resume_generation(pe, ck.load(str(tmp_path / "gen")), gen)
    assert first + res.token_ids == golden
    assert "resume_relogit" in pe.kernel_recorder


@pytest.mark.parametrize("kv", KVS)
def test_a_jax_checkpoint_loads_and_resumes_in_the_port(engines, tmp_path, kv):
    pe, je = engines(kv)
    jgen = JGen(max_new_tokens=N, greedy=True)
    golden = je.generate(PROMPT, jgen).token_ids
    first = _broken(je, jgen)
    jstate = jck.capture(je, PROMPT, first, rng_key=KEY)
    path = str(tmp_path / "jax")
    jman = jck.save(jstate, path)
    state = ck.load(path)
    _same_state(state, jck.load(path))
    if kv in ("bf16", "fp8"):
        assert isinstance(state.k, torch.Tensor)
        assert jman["packed_dtypes"] == {"k": jman["kv_dtype"], "v": jman["kv_dtype"]}
    res = ck.resume_generation(pe, state, GenerationConfig(max_new_tokens=N,
                                                          greedy=True))
    assert first + res.token_ids == golden


@pytest.mark.parametrize("kv", KVS)
def test_a_port_checkpoint_loads_and_resumes_in_jax(engines, tmp_path, kv):
    pe, je = engines(kv)
    gen = GenerationConfig(max_new_tokens=N, greedy=True)
    first = _broken(pe, gen)
    state = ck.capture(pe, PROMPT, first, rng_key=KEY)
    path = str(tmp_path / "port")
    man = ck.save(state, path)
    jstate = jck.load(path)
    _same_state(state, jstate)
    with open(path + ".json") as f:
        assert set(json.load(f)) == set(man)
    golden = je.generate(PROMPT, JGen(max_new_tokens=N, greedy=True)).token_ids
    res = jck.resume_generation(je, jstate, JGen(max_new_tokens=N, greedy=True))
    assert first + res.token_ids == golden


@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_manifests_name_the_same_fields_and_dtypes(engines, tmp_path, kv):
    pe, je = engines(kv)
    pe.prefill([1, 2, 3])
    je.prefill([1, 2, 3])
    man = ck.save(ck.capture(pe, [1, 2, 3], []), str(tmp_path / "p"))
    jman = jck.save(jck.capture(je, [1, 2, 3], []), str(tmp_path / "j"))
    assert set(man) == set(jman)
    for k in ("schema_version", "kv_len", "prompt_tokens", "generated_tokens",
              "kv_shape", "kv_dtype", "packed_dtypes"):
        assert man[k] == jman[k], k


def test_integrity_check(engines, tmp_path):
    pe, _ = engines("f32")
    pe.prefill([1, 2, 3])
    path = str(tmp_path / "c")
    ck.save(ck.capture(pe, [1, 2, 3], []), path)
    with open(path + ".json") as f:
        man = json.load(f)
    man["sha256"] = "0" * 64
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    with pytest.raises(InferenceError, match="integrity"):
        ck.load(path)
    assert ck.load(path, verify=False).kv_len == 3
    with pytest.raises(InferenceError, match="not found"):
        ck.load(str(tmp_path / "missing"))


def test_shape_mismatch_rejected(engines):
    pe, _ = engines("f32")
    bad = ck.DecodeState(prompt_ids=[1], generated_ids=[], rng_key=None, kv_len=1,
                         k=np.zeros((99, 1, 2, 4), np.float32),
                         v=np.zeros((99, 1, 2, 4), np.float32))
    with pytest.raises(InferenceError, match="shape"):
        ck.restore(pe, bad)
    long = ck.DecodeState(prompt_ids=[1], generated_ids=[], rng_key=None, kv_len=65,
                          k=np.zeros((2, 65, 2, 64), np.float32),
                          v=np.zeros((2, 65, 2, 64), np.float32))
    with pytest.raises(InferenceError, match="max_seq_len"):
        ck.restore(pe, long)


@pytest.mark.parametrize("kv", ["f32", "int8", "bf16"])
def test_diff_roundtrip(engines, tmp_path, kv):
    pe, _ = engines(kv)
    gen = GenerationConfig(max_new_tokens=8, greedy=True)
    toks, base = [], None
    for ev in pe.generate_stream([3, 5, 8], gen):
        toks.append(ev.token_id)
        if len(toks) == 3:
            base = ck.capture(pe, [3, 5, 8], list(toks))
    cur = ck.capture(pe, [3, 5, 8], toks)
    dpath = str(tmp_path / "d")
    man = ck.save_diff(base, cur, dpath)
    assert man["rows"] == cur.kv_len - base.kv_len
    merged = ck.apply_diff(base, dpath)
    _same_state(merged, cur)
    # the JAX package applies the port's diff to the port's base
    bpath = str(tmp_path / "b")
    ck.save(base, bpath)
    jmerged = jck.apply_diff(jck.load(bpath), dpath)
    assert jmerged.generated_ids == cur.generated_ids
    assert np.array_equal(_bytes(jmerged.k), _bytes(cur.k))
    if cur.k_scale is not None:
        assert np.array_equal(_bytes(jmerged.k_scale), _bytes(cur.k_scale))
    with pytest.raises(InferenceError, match="older"):
        ck.save_diff(cur, base, dpath)


def test_diff_base_mismatch(engines, tmp_path):
    pe, _ = engines("f32")
    pe.prefill([1, 2, 3, 4])
    a = ck.capture(pe, [1, 2, 3, 4], [])
    pe.prefill([1, 2, 3, 4, 5, 6])
    b = ck.capture(pe, [1, 2, 3, 4], [5, 6])
    dpath = str(tmp_path / "d2")
    ck.save_diff(a, b, dpath)
    with pytest.raises(InferenceError, match="base_len"):
        ck.apply_diff(b, dpath)
    with pytest.raises(InferenceError, match="different prompts"):
        ck.save_diff(a, ck.capture(pe, [9], [5, 6]), dpath)


def test_resume_with_a_grammar_replays_the_generated_tokens(engines, tmp_path):
    """The matcher is rebuilt at the generation point: the tokens generated
    before the break are replayed through it, so the resumed output
    completes the grammar as the unbroken run does, and equals the JAX
    engine's resume from the same state."""
    pe, je = engines("f32")
    src = 'root ::= [ab]{6} "!"'
    gen = GenerationConfig(max_new_tokens=10, greedy=True, grammar=src)
    golden = pe.generate(PROMPT, gen)
    first = []
    for ev in pe.generate_stream(PROMPT, gen):
        first.append(ev.token_id)
        if len(first) == 3:
            break
    path = str(tmp_path / "g")
    ck.save(ck.capture(pe, PROMPT, first), path)
    res = ck.resume_generation(pe, ck.load(path), gen)
    assert first + res.token_ids == golden.token_ids
    text = pe.tokenizer.decode(first + res.token_ids)
    assert len(text) == 7 and text.endswith("!")
    jres = jck.resume_generation(je, jck.load(path), JGen(max_new_tokens=10,
                                                          greedy=True, grammar=src))
    assert jres.token_ids == res.token_ids


def test_resume_on_the_f32_mini_matches_the_unbroken_run(mini_gguf_f32, tmp_path):
    """The F32 mini GGUF (dense linears): a run broken after BREAK tokens,
    checkpointed and resumed, gives the unbroken run's tokens, which are
    the JAX engine's."""
    p = mini_gguf_f32.path
    pe = InferenceEngine.from_gguf(p, EngineConfig(**_kw("f32")), device="cpu")
    je = JEngine.from_gguf(p, JEngineConfig(**_kw("f32")))
    gen = GenerationConfig(max_new_tokens=N, greedy=True)
    golden = pe.generate(PROMPT, gen).token_ids
    assert golden == je.generate(PROMPT, JGen(max_new_tokens=N, greedy=True)).token_ids
    first = _broken(pe, gen)
    ck.save(ck.capture(pe, PROMPT, first, rng_key=KEY), str(tmp_path / "gen"))
    pe.prefill([9, 9, 9])
    res = ck.resume_generation(pe, ck.load(str(tmp_path / "gen")), gen)
    assert first + res.token_ids == golden
