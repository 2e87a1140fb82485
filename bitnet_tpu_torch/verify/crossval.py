"""Cross-validation harness: per-token logits vs an independent reference.

Counterpart of ``bitnet_tpu/verify/crossval.py`` (the reference's
``crossval/src/logits_compare.rs:55-98`` per-position cosine and
first-divergence detection, ``src/cpp_bindings.rs:438`` ``eval_bitnet``,
``baselines.json`` recording).  The port's side of every comparison is
``InferenceEngine.eval_ids``: one bucketed prefill on the engine's device,
so on the card it runs the port's kernels.  Each ``crossval_*`` takes an
optional ``trace`` (a ``verify.trace.TraceSink``) that records that
prefill's layers, for ``trace-diff`` against another device's run.

Backends:
- ``golden`` — the independent numpy float implementation
  (``verify/reference.py``) fed the GGUF's dequantized weights (or a
  fixture's float weights).
- ``cppref`` — the in-repo independent C++ forward pass
  (``native/bitnet_golden.cpp``), built by ``make -C native CXX=g++
  build/bitnet_golden``.  A failed build raises with make's output; it is
  never skipped.
- ``cpp`` — an external bitnet.cpp / llama.cpp build holding the eval shim,
  located through ``BITNET_CPP_DIR`` exactly like the reference
  (xtask main.rs:3146-3218).  Absent shim → an error, never a mock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np

from ..errors import InferenceError
from .reference import cosine_similarity

COSINE_SIMILARITY_THRESHOLD = 0.99   # logits_compare.rs:24


@dataclasses.dataclass
class CrossvalResult:
    prompt_tokens: list[int]
    cosines: list[float]
    min_cosine: float
    first_divergence: int | None     # first position below threshold
    passed: bool
    backend: str
    elapsed_s: float
    # perplexity parity on the shared token set (reference records ppl in
    # baselines/cpu-main.json:19-21), both sides from the SAME per-position
    # logits that feed the cosine gate
    ppl_ours: float | None = None
    ppl_theirs: float | None = None
    ppl_rel_delta: float | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _perplexity(logits: np.ndarray, tokens: list[int]) -> float | None:
    """exp(mean next-token NLL): positions 0..T-2 predict tokens[1..]."""
    T = min(logits.shape[0], len(tokens))
    if T < 2:
        return None
    x = logits[: T - 1].astype(np.float64)
    x = x - x.max(axis=1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
    nll = -np.mean([logp[i, tokens[i + 1]] for i in range(T - 1)])
    return float(np.exp(nll))


def compare_per_token(ours: np.ndarray, theirs: np.ndarray,
                      threshold: float = COSINE_SIMILARITY_THRESHOLD,
                      backend: str = "golden",
                      tokens: list[int] | None = None,
                      elapsed_s: float = 0.0) -> CrossvalResult:
    """Per-position cosine compare (logits_compare.rs:55-98)."""
    if ours.shape != theirs.shape:
        raise InferenceError(
            f"logit shape mismatch: {ours.shape} vs {theirs.shape}")
    cosines = [cosine_similarity(ours[t], theirs[t])
               for t in range(ours.shape[0])]
    first_div = next((i for i, c in enumerate(cosines) if c < threshold),
                     None)
    po = _perplexity(ours, tokens) if tokens else None
    pt = _perplexity(theirs, tokens) if tokens else None
    rel = (abs(po - pt) / pt if po is not None and pt else None)
    return CrossvalResult(
        prompt_tokens=list(tokens or []),
        cosines=[round(c, 6) for c in cosines],
        min_cosine=round(min(cosines), 6),
        first_divergence=first_div,
        passed=first_div is None,
        backend=backend,
        elapsed_s=round(elapsed_s, 3),
        ppl_ours=None if po is None else round(po, 4),
        ppl_theirs=None if pt is None else round(pt, 4),
        ppl_rel_delta=None if rel is None else round(rel, 6),
    )


def crossval_golden(engine, mini_model, token_ids: list[int],
                    threshold: float = COSINE_SIMILARITY_THRESHOLD,
                    trace=None) -> CrossvalResult:
    """Engine vs the independent numpy golden model on a fixture's float
    weights."""
    from .reference import reference_forward

    t0 = time.time()
    ours = engine.eval_ids(token_ids, trace=trace)       # [T, V]
    theirs = reference_forward(engine.cfg, mini_model.weights, token_ids)
    return compare_per_token(ours, theirs, threshold, "golden", token_ids,
                             time.time() - t0)


def golden_weights_from_gguf(path: str) -> dict[str, np.ndarray]:
    """Dequantize every GGUF tensor to a float dict for the numpy golden
    model (the CLI's ``--backend golden``: any GGUF the port loads)."""
    from ..gguf.reader import GGUFReader
    from ..models.loader import _to_float

    with GGUFReader(path) as reader:
        return {info.name: np.asarray(_to_float(reader, info), np.float32)
                for info in reader.tensors.values()}


def crossval_golden_gguf(engine, gguf_path: str, token_ids: list[int],
                         threshold: float = COSINE_SIMILARITY_THRESHOLD,
                         trace=None) -> CrossvalResult:
    """Engine vs the numpy golden model fed dequantized GGUF weights."""
    from .reference import reference_forward

    t0 = time.time()
    ours = engine.eval_ids(token_ids, trace=trace)
    weights = golden_weights_from_gguf(gguf_path)
    theirs = reference_forward(engine.cfg, weights, token_ids)
    return compare_per_token(ours, theirs, threshold, "golden", token_ids,
                             time.time() - t0)


# ---------------------------------------------------------------------------
# cppref backend: the in-repo independent C++ golden (native/bitnet_golden.cpp)
# ---------------------------------------------------------------------------
def _repo_native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native")


def cppref_binary(build: bool = True) -> str | None:
    """Path to the in-repo C++ golden binary, building it on demand with
    ``g++`` (the Makefile's default compiler: the golden needs OpenMP, and
    an environment ``CXX`` may name a toolchain without libgomp, as on the
    card's machine).  A build that fails raises with make's output (the
    JAX package returns None there)."""
    native = _repo_native_dir()
    path = os.path.join(native, "build", "bitnet_golden")
    if os.path.exists(path):
        return path
    if not build:
        return None
    try:
        r = subprocess.run(["make", "-C", native, "CXX=g++", "build/bitnet_golden"],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise InferenceError(
            f"cannot build the C++ golden (make -C {native} CXX=g++ "
            f"build/bitnet_golden): {e}") from e
    if r.returncode != 0 or not os.path.exists(path):
        raise InferenceError(
            f"make -C {native} CXX=g++ build/bitnet_golden failed (rc="
            f"{r.returncode}):\n{(r.stdout + r.stderr)[-2000:]}")
    return path


def _logits_from(binary: str, model_flag: str, gguf_path: str,
                 token_ids: list[int], n_vocab: int, what: str) -> np.ndarray:
    """Run ``binary <model_flag> MODEL --tokens a,b,c --out FILE`` and read
    the T x n_vocab f32 dump from a file of its own under ``TMPDIR``."""
    T = len(token_ids)
    with tempfile.TemporaryDirectory(prefix="crossval_") as d:
        out_file = os.path.join(d, "logits.bin")
        r = subprocess.run([binary, model_flag, gguf_path,
                            "--tokens", ",".join(str(t) for t in token_ids),
                            "--out", out_file], capture_output=True, timeout=1800)
        if r.returncode != 0 or not os.path.exists(out_file):
            raise InferenceError(
                f"{what} eval failed (rc={r.returncode}): {r.stderr[-500:]!r}")
        raw = np.fromfile(out_file, dtype=np.float32)
    if raw.size != T * n_vocab:
        raise InferenceError(
            f"{what} logits dump size {raw.size} != {T}x{n_vocab}")
    return raw.reshape(T, n_vocab)


def eval_cppref_logits(gguf_path: str, token_ids: list[int],
                       n_vocab: int) -> np.ndarray:
    """Per-position logits from the in-repo independent C++ golden."""
    return _logits_from(cppref_binary(), "--model", gguf_path, token_ids,
                        n_vocab, "C++ golden")


def crossval_cppref(engine, gguf_path: str, token_ids: list[int],
                    threshold: float = COSINE_SIMILARITY_THRESHOLD,
                    trace=None) -> CrossvalResult:
    """Engine vs the in-repo independent C++ forward pass — the merge gate
    in a zero-egress environment."""
    t0 = time.time()
    ours = engine.eval_ids(token_ids, trace=trace)
    theirs = eval_cppref_logits(gguf_path, token_ids, engine.cfg.vocab_size)
    return compare_per_token(ours, theirs, threshold, "cppref", token_ids,
                             time.time() - t0)


# ---------------------------------------------------------------------------
# cpp backend: external bitnet.cpp / llama.cpp via the eval shim
# ---------------------------------------------------------------------------
def cpp_reference_available() -> str | None:
    """Locate the eval shim in an external C++ build (BITNET_CPP_DIR).

    llama.cpp / bitnet.cpp ship no CLI that dumps raw per-position logits;
    the shim (``native/cpp_shim/bitnet_eval_shim.cpp``: llama.h
    ``llama_decode`` + ``llama_get_logits``) is compiled into the external
    build dir as ``bitnet-eval-shim``.
    """
    d = os.environ.get("BITNET_CPP_DIR")
    if not d:
        return None
    for name in ("bitnet-eval-shim",):
        for p in (os.path.join(d, "bin", name), os.path.join(d, name)):
            if os.path.exists(p):
                return p
    return None


def eval_cpp_logits(gguf_path: str, token_ids: list[int],
                    n_vocab: int) -> np.ndarray:
    """Per-position logits from the external C++ build via the eval shim.

    Shim CLI contract (native/cpp_shim/bitnet_eval_shim.cpp):
    ``bitnet-eval-shim -m MODEL --tokens 1,2,3 --out FILE`` writing
    T*n_vocab float32 LE.  Raises when the shim is missing (no silent
    mock).
    """
    binary = cpp_reference_available()
    if binary is None:
        raise InferenceError(
            "no C++ reference shim (set BITNET_CPP_DIR to a bitnet.cpp/"
            "llama.cpp build containing bitnet-eval-shim; source in "
            "native/cpp_shim/)")
    return _logits_from(binary, "-m", gguf_path, token_ids, n_vocab,
                        "C++ reference")


def crossval_cpp(engine, gguf_path: str, token_ids: list[int],
                 threshold: float = COSINE_SIMILARITY_THRESHOLD,
                 trace=None) -> CrossvalResult:
    t0 = time.time()
    ours = engine.eval_ids(token_ids, trace=trace)
    theirs = eval_cpp_logits(gguf_path, token_ids, engine.cfg.vocab_size)
    return compare_per_token(ours, theirs, threshold, "cpp", token_ids,
                             time.time() - t0)


# ---------------------------------------------------------------------------
# baselines.json recording (crossval/baselines.json parity)
# ---------------------------------------------------------------------------
def record_baseline(result: CrossvalResult, path: str,
                    extra: dict | None = None) -> dict:
    entry = {
        "timestamp": time.time(),
        "backend": result.backend,
        "min_cosine": result.min_cosine,
        "passed": result.passed,
        "positions": len(result.cosines),
        **(extra or {}),
    }
    data = {"entries": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except json.JSONDecodeError:
            pass
    data.setdefault("entries", []).append(entry)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
    return entry
