"""The port's crossval harness against the JAX package's on the mini GGUFs
of ``gguf/fixtures.py``: per-token comparison (the same results), the
golden weights (bit for bit), ``InferenceEngine.eval_ids`` on the CPU
(paths xla and w2a8, f32 activations, within 1e-5 of the largest logit;
on w2a8 a position that one int8 rounding flip moves, cosine >= 0.9999),
the C++ golden leg (cosines within 1e-5 of the JAX package's, both
passing), the external-C++ leg through the in-repo llamastub, and the
repair of the reference's silent ``make`` failure."""

import json
import os
import stat
import subprocess

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.errors import InferenceError as JInferenceError
from bitnet_tpu.gguf.fixtures import MiniModelSpec as JMiniModelSpec
from bitnet_tpu.gguf.fixtures import generate_mini_gguf as jgenerate_mini_gguf
from bitnet_tpu.verify import crossval as jcv
from bitnet_tpu_torch.config import EngineConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import InferenceError
from bitnet_tpu_torch.verify import crossval as cv

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = [2, 7, 11, 13, 17]
KINDS = ("qk256", "bitnet32", "qk256_sub_norm")


@pytest.fixture(scope="module")
def minis(tmp_path_factory):
    """The mini GGUFs the port loads (qk256, bitnet32; the 2B-4T
    sub-norms on one, none on the others) and an f32 one for the golden
    weights."""
    d = tmp_path_factory.mktemp("crossval")
    specs = {"f32": JMiniModelSpec(quant="f32"),
             "qk256": JMiniModelSpec(hidden_size=256, intermediate_size=512,
                                     quant="qk256"),
             "bitnet32": JMiniModelSpec(quant="bitnet32"),
             "qk256_sub_norm": JMiniModelSpec(quant="qk256", sub_norm=True)}
    return {k: jgenerate_mini_gguf(str(d / f"{k}.gguf"), s) for k, s in specs.items()}


def _engines(path, kp):
    """The JAX and the port engine on one GGUF, f32 activations and cache."""
    je = JEngine.from_gguf(path, JEngineConfig(
        kernel_path=kp, max_seq_len=64, kv_cache_dtype="f32", compute_dtype="f32"))
    pe = InferenceEngine.from_gguf(path, EngineConfig(
        kernel_path=kp, max_seq_len=64, kv_cache_dtype="f32", compute_dtype="f32"),
        device="cpu")
    return je, pe


# -- per-token comparison ----------------------------------------------------
def _pairs():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((6, 32)).astype(np.float32)
    b = a + 0.02 * rng.standard_normal((6, 32)).astype(np.float32)
    flipped = a.copy()
    flipped[3] = -flipped[3]                  # cosine -1 at position 3
    return {"identical": (a, a.copy()), "close": (a, b), "flipped": (a, flipped)}


@pytest.mark.parametrize("case", ["identical", "close", "flipped"])
@pytest.mark.parametrize("tokens", [None, [1, 5, 9, 2, 30, 7]])
def test_compare_per_token_is_the_jax_one(case, tokens):
    ours, theirs = _pairs()[case]
    got = cv.compare_per_token(ours, theirs, tokens=tokens, backend="cppref",
                               elapsed_s=1.23456)
    want = jcv.compare_per_token(ours, theirs, tokens=tokens, backend="cppref",
                                 elapsed_s=1.23456)
    assert got.as_dict() == want.as_dict()
    assert got.first_divergence == {"identical": None, "close": None, "flipped": 3}[case]
    assert (got.ppl_rel_delta is None) == (tokens is None)


def test_compare_per_token_refuses_a_shape_mismatch():
    a, b = np.zeros((2, 4), np.float32), np.zeros((3, 4), np.float32)
    with pytest.raises(InferenceError, match="shape") as e:
        cv.compare_per_token(a, b)
    with pytest.raises(JInferenceError) as je:
        jcv.compare_per_token(a, b)
    assert str(e.value) == str(je.value)


def test_record_baseline_appends_the_jax_entries(tmp_path):
    lg = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    got, want = cv.compare_per_token(lg, lg), jcv.compare_per_token(lg, lg)
    for mod, res, name in ((cv, got, "port"), (jcv, want, "jax")):
        p = str(tmp_path / f"{name}.json")
        mod.record_baseline(res, p, {"model": "x"})
        mod.record_baseline(res, p)
    entries = [json.loads((tmp_path / f"{n}.json").read_text())["entries"]
               for n in ("port", "jax")]
    for e in entries:
        for x in e:
            x.pop("timestamp")
    assert entries[0] == entries[1] and len(entries[0]) == 2
    assert entries[0][0]["model"] == "x" and entries[0][0]["passed"]


# -- the golden weights and eval_ids ----------------------------------------
@pytest.mark.parametrize("kind", ["f32", *KINDS])
def test_golden_weights_are_the_jax_ones(minis, kind):
    got = cv.golden_weights_from_gguf(minis[kind].path)
    want = jcv.golden_weights_from_gguf(minis[kind].path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kp", ["xla", "w2a8"])
@pytest.mark.parametrize("kind", KINDS)
def test_eval_ids_matches_the_jax_engine(minis, kind, kp):
    """Per-position logits of one bucketed prefill: the JAX engine's
    ``eval_ids`` (w2a8 through its Pallas kernels in interpret mode) and
    the port's plain versions, f32, within 1e-5 of the largest logit.  On
    w2a8 an f32 ulp of a norm can round one int8 activation code the
    other way (ROADMAP §3, "W2A8 requantization amplifies rounding"): a
    position so moved (on qk256, position 2 by 4.4e-3 of the largest
    logit) is held to cosine >= 0.9999 instead, and most positions must
    still agree within 1e-5."""
    je, pe = _engines(minis[kind].path, kp)
    want = je.eval_ids(TOKENS)
    got = pe.eval_ids(TOKENS)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(TOKENS), 256)
    err = np.abs(got - want).max(axis=1) / np.abs(want).max()
    if kp == "xla":
        assert err.max() <= 1e-5, err
    else:
        assert (err <= 1e-5).sum() >= len(TOKENS) - 2, err
        cos = [cv.cosine_similarity(g, w) for g, w in zip(got, want)]
        assert min(cos) >= 0.9999, cos
    assert pe.kernel_recorder == [f"eval_{kp}_T8"]      # no kernel on the CPU
    # the engine's cache is reset: a second call gives the same logits
    assert np.array_equal(pe.eval_ids(TOKENS), got)


def test_eval_ids_last_row_is_the_prefill_logits(minis):
    pe = InferenceEngine.from_gguf(minis["qk256"].path, EngineConfig(
        kernel_path="w2a8", max_seq_len=64, compute_dtype="f32"), device="cpu")
    lg = pe.eval_ids(TOKENS)
    last = pe.prefill(TOKENS)[0].numpy()
    assert np.abs(lg[-1] - last).max() <= 1e-5 * np.abs(last).max()


# -- the backends ------------------------------------------------------------
@pytest.fixture(scope="module")
def golden_binary():
    """The in-repo C++ golden, built if missing (``make -C native``)."""
    return cv.cppref_binary()


@pytest.mark.parametrize("kp", ["xla", "w2a8"])
@pytest.mark.parametrize("kind", KINDS)
def test_crossval_cppref_matches_the_jax_package(minis, golden_binary, kind, kp):
    je, pe = _engines(minis[kind].path, kp)
    want = jcv.crossval_cppref(je, minis[kind].path, TOKENS)
    got = cv.crossval_cppref(pe, minis[kind].path, TOKENS)
    assert got.passed and want.passed, (got.as_dict(), want.as_dict())
    assert got.backend == "cppref" and got.prompt_tokens == TOKENS
    assert np.abs(np.subtract(got.cosines, want.cosines)).max() <= 1e-5
    assert got.min_cosine > cv.COSINE_SIMILARITY_THRESHOLD


@pytest.mark.parametrize("kind", KINDS)
def test_crossval_golden_gguf_matches_the_jax_package(minis, kind):
    je, pe = _engines(minis[kind].path, "w2a8")
    want = jcv.crossval_golden_gguf(je, minis[kind].path, TOKENS)
    got = cv.crossval_golden_gguf(pe, minis[kind].path, TOKENS)
    assert got.passed and want.passed
    assert np.abs(np.subtract(got.cosines, want.cosines)).max() <= 1e-5
    fixture = cv.crossval_golden(pe, minis[kind], TOKENS)   # the float weights
    assert fixture.passed and fixture.backend == "golden"


def test_crossval_trace_records_the_eval(minis, golden_binary):
    from bitnet_tpu_torch.verify.trace import TraceSink

    _je, pe = _engines(minis["qk256_sub_norm"].path, "w2a8")
    sink = TraceSink()
    res = cv.crossval_cppref(pe, minis["qk256_sub_norm"].path, TOKENS, trace=sink)
    assert res.passed
    assert [r.name for r in sink.records][1:3] == ["blk.0.out", "blk.1.out"]


def test_failed_golden_build_raises_with_makes_output(tmp_path, monkeypatch):
    """The JAX ``cppref_binary`` returns None when ``make`` fails; the port
    raises with make's output (no silent fallback)."""
    (tmp_path / "Makefile").write_text(
        "build/bitnet_golden:\n\t@echo no-compiler-here >&2; exit 3\n")
    monkeypatch.setattr(cv, "_repo_native_dir", lambda: str(tmp_path))
    with pytest.raises(InferenceError, match="no-compiler-here"):
        cv.cppref_binary()
    assert cv.cppref_binary(build=False) is None
    with pytest.raises(InferenceError, match="failed"):
        cv.eval_cppref_logits("model.gguf", [1], 8)


@pytest.fixture(scope="module")
def stub_dir():
    """The in-repo llamastub (a llama.h-compatible libllama.so backed by
    the golden) and the eval shim compiled against it, as against a real
    llama.cpp: ``make -C native llamastub``."""
    d = os.path.join(REPO, "native", "build", "llamastub")
    if not os.path.exists(os.path.join(d, "bitnet-eval-shim")):
        r = subprocess.run(["make", "-C", "native", "llamastub"], capture_output=True,
                           text=True, cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stderr[-800:]
    return d


def test_external_cpp_leg_through_the_llamastub(minis, stub_dir, monkeypatch):
    monkeypatch.setenv("BITNET_CPP_DIR", stub_dir)
    assert cv.cpp_reference_available() == jcv.cpp_reference_available() is not None
    path = minis["qk256"].path
    pe = InferenceEngine.from_gguf(path, EngineConfig(max_seq_len=64,
                                                      compute_dtype="f32"),
                                   device="cpu")
    res = cv.crossval_cpp(pe, path, [1, 7, 20])
    assert res.passed and res.backend == "cpp", res.as_dict()
    assert res.min_cosine > 0.999
    assert res.ppl_rel_delta is not None and res.ppl_rel_delta < 0.01
    theirs = cv.eval_cpp_logits(path, [1, 7, 20], 256)
    assert np.array_equal(theirs, jcv.eval_cpp_logits(path, [1, 7, 20], 256))


def _write_stub_shim(path, n_vocab: int, wrong_size: bool = False):
    """An executable honouring the bitnet-eval-shim CLI contract."""
    path.write_text(f"""#!/usr/bin/env python3
import sys, struct
args = sys.argv[1:]
toks = [int(t) for t in args[args.index("--tokens") + 1].split(",")]
out = args[args.index("--out") + 1]
T = len(toks) - (1 if {wrong_size} else 0)
with open(out, "wb") as f:
    for t in range(max(T, 0)):
        for v in range({n_vocab}):
            f.write(struct.pack("<f", float(toks[min(t, len(toks)-1)] + v)))
""")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.mark.parametrize("case", ["parses", "wrong_size", "missing", "no_env"])
def test_eval_cpp_shim_contract(case, monkeypatch, tmp_path):
    if case != "missing":
        _write_stub_shim(tmp_path / "bitnet-eval-shim", n_vocab=8,
                         wrong_size=case == "wrong_size")
    if case == "no_env":
        monkeypatch.delenv("BITNET_CPP_DIR", raising=False)
    else:
        monkeypatch.setenv("BITNET_CPP_DIR", str(tmp_path))
    assert cv.cpp_reference_available() == jcv.cpp_reference_available()
    if case == "parses":
        lg = cv.eval_cpp_logits("model.gguf", [3, 5], n_vocab=8)
        np.testing.assert_array_equal(lg, np.stack([3.0 + np.arange(8),
                                                    5.0 + np.arange(8)]))
        return
    match = {"wrong_size": "size", "missing": "shim", "no_env": "shim"}[case]
    with pytest.raises(InferenceError, match=match):
        cv.eval_cpp_logits("model.gguf", [3, 5], n_vocab=8)
