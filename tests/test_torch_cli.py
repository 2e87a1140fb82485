"""``python -m bitnet_tpu_torch.cli run`` against ``bitnet_tpu.cli run`` on
the mini QK256 fixture: with ``--device cpu --greedy`` (auto → xla on the
CPU) the port prints the text the JAX package's CLI prints with
``--greedy --kernel-path xla``, on every kernel path the port has.
Without ``--device cpu`` it refuses to run when CUDA is absent, and flags
of paths not ported yet raise, naming their ROADMAP item (``--decode-steps
8`` and ``--speculative K [--draft-model]``, ported, print the plain greedy
text, and so does ``--sliding-window 64``, over the ring cache).
``convert``, ``st-inspect`` and ``st-merge`` are held to the JAX CLI in
``test_torch_safetensors.py``.  ``--grammar-file``
and ``--json-schema`` constrain the text as the JAX CLI's do.  The
verification subcommands (``run --receipt``, ``crossval``, ``gate``,
``verify-receipt``, ``replay``, ``trace-diff``) print the JAX CLI's JSON
keys and exit with its codes on the same inputs."""

import json

import pytest
import torch

from bitnet_tpu import cli as jcli
from bitnet_tpu_torch import cli

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

ARGS = ["--prompt", "Hello world", "--prompt-template", "raw", "-n", "12"]


def _run(main, argv, capsys):
    assert main(["run", *argv]) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.mark.parametrize("kp", [None, "w2a8", "pallas"])
def test_cli_prints_the_reference_text(mini_gguf_qk256, capsys, kp):
    m = ["--model", mini_gguf_qk256.path]
    want, _ = _run(jcli.main, m + ARGS + ["--greedy", "--kernel-path", "xla"],
                   capsys)
    extra = [] if kp is None else ["--kernel-path", kp]
    got, err = _run(cli.main, m + ARGS + ["--greedy", "--device", "cpu"] + extra,
                    capsys)
    assert got == want and len(got.strip()) > 0
    assert "[12 tokens" in err


def test_cli_seeded_sampling_repeats(mini_gguf_qk256, capsys):
    argv = ["--model", mini_gguf_qk256.path, *ARGS, "--device", "cpu",
            "--seed", "5", "--top-k", "40", "--logprobs", "2"]
    a, err = _run(cli.main, argv, capsys)
    b, _ = _run(cli.main, argv, capsys)
    assert a == b and "[lp " in err


def test_cli_needs_cuda_unless_asked_for_cpu(mini_gguf_qk256, monkeypatch):
    from bitnet_tpu_torch.errors import ConfigError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        cli.main(["run", "--model", mini_gguf_qk256.path, *ARGS])


@pytest.mark.parametrize("flags,item", [
    # ported (they raised naming #12): speculative decoding, with n-gram
    # drafts or a draft GGUF, prints the plain greedy text
    pytest.param(["--speculative", "4"], None, id="flags0-#12"),
    pytest.param(["--speculative", "3", "--draft-model", "MODEL"], None,
                 id="flags1-#12"),
    # ported (it raised naming #7): a window wider than the request prints
    # the plain greedy text
    pytest.param(["--sliding-window", "64"], None, id="flags2-#7"),
    # ported (it raised naming #5): K-step segments print the K=1 text
    pytest.param(["--decode-steps", "8"], None, id="flags3-#5")])
def test_cli_refuses_unported_flags(mini_gguf_qk256, flags, item, capsys):
    argv = ["--model", mini_gguf_qk256.path, *ARGS, "--device", "cpu", "--greedy"]
    if item is None:
        # the speculative text is the decoded ids, as --no-stream prints them
        plain = ["--no-stream"] if "--speculative" in flags else ["--decode-steps", "1"]
        one, _ = _run(cli.main, argv + plain, capsys)
        flags = [mini_gguf_qk256.path if f == "MODEL" else f for f in flags]
        got, err = _run(cli.main, argv + flags, capsys)
        assert got == one and len(got.strip()) > 0
        if "--speculative" in flags:
            stats = err[err.index("[speculative: "):].splitlines()[0]
            assert "'rounds'" in stats and "'proposed'" in stats
            if "--draft-model" in flags:     # the same model drafts every token
                assert "'acceptance_rate': 1.0" in stats
        else:
            assert "[12 tokens" in err
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        cli.main(["run", *argv, *flags])


GBNF = 'root ::= [a-z]{3,6} ("!" | "?")\n'
SCHEMA = ('{"type": "object", "properties": {"ok": {"type": "boolean"}}, '
          '"required": ["ok"]}')


@pytest.mark.parametrize("kind", ["json_any", "json_inline", "json_file",
                                  "gbnf_file"])
def test_cli_grammar_flags_print_the_reference_text(mini_gguf_qk256, capsys,
                                                    tmp_path, kind):
    """``run --json-schema`` (``any``, an inline schema, a schema file) and
    ``run --grammar-file`` with ``--greedy --device cpu``: the text is the
    JAX CLI's, and every token of it is admissible under the grammar.  Both
    run at f32 (compute and cache): a grammar leaves few candidates, and at
    bf16 two of them can tie within the packages' rounding differences."""
    from bitnet_tpu_torch.grammar import (JSON_GRAMMAR, Grammar, TokenVocab,
                                          VocabMatcher, json_schema_grammar)
    from bitnet_tpu_torch.tokenizer import load_tokenizer

    gpath, spath = tmp_path / "g.gbnf", tmp_path / "s.json"
    gpath.write_text(GBNF)
    spath.write_text(SCHEMA)
    flags, src = {
        "json_any": (["--json-schema", "any"], JSON_GRAMMAR),
        "json_inline": (["--json-schema", SCHEMA], json_schema_grammar(SCHEMA)),
        "json_file": (["--json-schema", str(spath)], json_schema_grammar(SCHEMA)),
        "gbnf_file": (["--grammar-file", str(gpath)], GBNF)}[kind]
    m = ["--model", mini_gguf_qk256.path, *ARGS, "--greedy", "--compute-dtype",
         "f32", "--kv-cache-dtype", "f32", *flags]
    want, _ = _run(jcli.main, m + ["--kernel-path", "xla"], capsys)
    got, err = _run(cli.main, m + ["--device", "cpu"], capsys)
    assert got == want and len(got.strip()) > 0 and "tokens" in err
    tok = load_tokenizer(mini_gguf_qk256.path)
    matcher = VocabMatcher(Grammar.from_gbnf(src), TokenVocab.from_tokenizer(tok))
    assert matcher.matcher.feed_text(got[:-1])       # the text less print's newline


def test_cli_grammar_flags_exclude_each_other(mini_gguf_qk256, tmp_path):
    from bitnet_tpu_torch.errors import ConfigError

    g = tmp_path / "g.gbnf"
    g.write_text(GBNF)
    with pytest.raises(ConfigError, match="exclusive"):
        cli.main(["run", "--model", mini_gguf_qk256.path, *ARGS, "--device", "cpu",
                  "--grammar-file", str(g), "--json-schema", "any"])


@pytest.mark.parametrize("kv", ["int8", "fp8", "f32"])
def test_cli_quantized_cache_prints_the_reference_text(mini_gguf_qk256, capsys, kv):
    """The generic path with an int8 / fp8 cache (quantized rows written,
    the cache dequantized to f32 for attention), or an f32 cache (which
    raised naming #18 until slice 7), as the JAX CLI runs it."""
    m = ["--model", mini_gguf_qk256.path, "--kv-cache-dtype", kv]
    want, _ = _run(jcli.main, m + ARGS + ["--greedy", "--kernel-path", "xla"],
                   capsys)
    got, err = _run(cli.main, m + ARGS + ["--greedy", "--device", "cpu"], capsys)
    assert got == want and "[12 tokens" in err


def _json(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.fixture
def receipts(mini_gguf_qk256, tmp_path, capsys):
    """``run --greedy --no-stream --receipt`` on each package (the port on
    the CPU), and a receipt with a mock kernel."""
    m = ["--model", mini_gguf_qk256.path, *ARGS, "--greedy", "--no-stream"]
    out = {"port": str(tmp_path / "port.json"), "jax": str(tmp_path / "jax.json"),
           "mock": str(tmp_path / "mock.json")}
    _run(cli.main, m + ["--device", "cpu", "--receipt", out["port"]], capsys)
    _run(jcli.main, m + ["--kernel-path", "xla", "--receipt", out["jax"]], capsys)
    with open(out["port"]) as f:
        mock = json.load(f)
    mock["kernels"] = mock["kernels"] + ["mock_gemm"]
    with open(out["mock"], "w") as f:
        json.dump(mock, f)
    return out


def test_run_receipt_is_strict_valid_in_both_packages(receipts, capsys):
    from bitnet_tpu.verify.receipts import InferenceReceipt, validate_receipt

    with open(receipts["port"]) as f:
        rec = json.load(f)
    assert rec["backend"] == "cpu" and rec["compute_path"] == "real"
    assert rec["kernels"] == ["prefill_xla_T32", "decode_xla_x12"]
    assert rec["environment"]["device"] == "cpu"
    assert rec["performance"]["generated_tokens"] == 12
    assert len(rec["request"]["output_ids"]) == 12 and rec["request"]["gen"]["greedy"]
    with open(receipts["port"]) as f:
        assert validate_receipt(InferenceReceipt.from_json(f.read()), strict=True) == []
    rc, out = _json(cli.main, ["verify-receipt", receipts["port"]], capsys)
    assert rc == 0 and out == {"receipt": receipts["port"], "problems": [], "valid": True}


@pytest.mark.parametrize("which,tolerant", [("port", False), ("jax", False),
                                            ("mock", False), ("mock", True)])
def test_verify_receipt_prints_the_jax_verdict(receipts, capsys, which, tolerant):
    argv = ["verify-receipt", receipts[which]] + (["--tolerant"] if tolerant else [])
    got = _json(cli.main, argv, capsys)
    want = _json(jcli.main, argv, capsys)
    assert got == want
    assert got[0] == (1 if which == "mock" and not tolerant else 0)


@pytest.mark.parametrize("backend,threshold", [("cppref", "0.99"), ("golden", "0.99"),
                                               ("cppref", "1.01")])
def test_crossval_prints_the_jax_keys_and_exit_code(mini_gguf_qk256, capsys,
                                                    backend, threshold):
    argv = ["crossval", "-m", mini_gguf_qk256.path, "--tokens", "2,7,11,5",
            "--backend", backend, "--max-seq-len", "64", "--threshold", threshold]
    wrc, want = _json(jcli.main, argv + ["--kernel-path", "xla"], capsys)
    grc, got = _json(cli.main, argv + ["--device", "cpu"], capsys)
    assert grc == wrc == (0 if threshold == "0.99" else 1)
    assert list(got) == list(want)
    assert got["backend"] == backend and got["prompt_tokens"] == [2, 7, 11, 5]
    assert max(abs(a - b) for a, b in zip(got["cosines"], want["cosines"])) < 1e-3


def test_crossval_needs_cuda_unless_asked_for_cpu(mini_gguf_qk256, monkeypatch):
    from bitnet_tpu_torch.errors import ConfigError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        cli.main(["crossval", "-m", mini_gguf_qk256.path, "--tokens", "1,2"])


@pytest.mark.parametrize("which", ["port", "jax", "mock", "missing"])
def test_gate_receipt_prints_the_jax_checks(receipts, capsys, which):
    path = receipts.get(which, "/nonexistent/receipt.json")
    wrc, want = _json(jcli.main, ["gate", "--receipt", path], capsys)
    grc, got = _json(cli.main, ["gate", "--receipt", path, "--device", "cpu"], capsys)
    assert (grc, got) == (wrc, want)
    assert got["checks"]["receipt_valid"] == (which in ("port", "jax"))


def test_gate_needs_the_card_it_is_asked_for(capsys, monkeypatch):
    """``--require-cuda`` (the JAX ``--require-tpu``) fails on the CPU, as
    does the default device without a card; ``--require-native`` checks
    that the loader packs QK256 on the device (the JAX native codec's key):
    the JAX checks' keys, true on the CPU, false without the card asked
    for."""
    rc, out = _json(cli.main, ["gate", "--device", "cpu", "--require-cuda"], capsys)
    assert rc == 1 and out["checks"] == {"device_reachable": True,
                                         "native_codec": True, "cuda": False}
    wrc, want = _json(jcli.main, ["gate", "--require-tpu"], capsys)
    assert wrc == 1 and not want["checks"]["tpu"]
    rc, out = _json(cli.main, ["gate", "--device", "cpu", "--require-native"], capsys)
    _wrc, want = _json(jcli.main, ["gate", "--require-native"], capsys)
    assert list(out["checks"]) == list(want["checks"]) and list(out) == list(want)
    assert rc == 0 and out["checks"]["native_codec"] and out["passed"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _json(cli.main, ["gate"], capsys)
    assert rc == 1 and not out["checks"]["device_reachable"] and not out["passed"]
    rc, out = _json(cli.main, ["gate", "--require-native"], capsys)
    assert rc == 1 and not out["checks"]["native_codec"]


def test_gate_crossval_model_prints_the_jax_keys(mini_gguf_qk256, capsys):
    argv = ["gate", "--crossval-model", mini_gguf_qk256.path,
            "--crossval-tokens", "2,7,11"]
    wrc, want = _json(jcli.main, argv, capsys)
    grc, got = _json(cli.main, argv + ["--device", "cpu"], capsys)
    assert grc == wrc == 0
    assert list(got) == list(want) and list(got["crossval"]) == list(want["crossval"])
    assert got["checks"]["crossval_cppref"] and got["crossval"]["min_cosine"] > 0.99


@pytest.mark.parametrize("tamper", [False, True])
def test_replay_prints_the_jax_report(mini_gguf_qk256, receipts, capsys, tamper):
    paths = [receipts["port"], receipts["jax"]]
    if tamper:
        for p in paths:
            with open(p) as f:
                r = json.load(f)
            r["request"]["output_ids"][2] += 1
            with open(p, "w") as f:
                json.dump(r, f)
    m = ["--model", mini_gguf_qk256.path, "--max-seq-len", "64"]
    wrc, want = _json(jcli.main, ["replay", "--receipt-in", paths[1], *m,
                                  "--kernel-path", "xla"], capsys)
    grc, got = _json(cli.main, ["replay", "--receipt-in", paths[0], *m,
                                "--device", "cpu"], capsys)
    assert grc == wrc == (1 if tamper else 0)
    assert list(got) == list(want)
    assert got["first_divergence"] == want["first_divergence"] == (2 if tamper else None)


def test_trace_diff_prints_the_jax_mismatches(mini_gguf_qk256, tmp_path, capsys):
    """``crossval --trace-out`` on two kernel paths and on one twice:
    ``trace-diff`` in both packages prints the same mismatches."""
    traces = {}
    for name, kp in (("a", "xla"), ("b", "xla"), ("c", "w2a8")):
        traces[name] = str(tmp_path / f"{name}.json")
        _json(cli.main, ["crossval", "-m", mini_gguf_qk256.path, "--tokens", "2,7,11",
                         "--device", "cpu", "--kernel-path", kp, "--max-seq-len", "64",
                         "--trace-out", traces[name]], capsys)
    for x, y, tol in (("a", "b", "0.02"), ("a", "c", "0.02"), ("a", "c", "1e-9")):
        argv = ["trace-diff", traces[x], traces[y], "--rms-tol", tol]
        got, want = _json(cli.main, argv, capsys), _json(jcli.main, argv, capsys)
        assert got == want
        assert got[0] == (1 if got[1]["mismatches"] else 0)
    assert _json(cli.main, ["trace-diff", traces["a"], traces["b"]], capsys) == (
        0, {"mismatches": []})
    assert _json(cli.main, ["trace-diff", traces["a"], traces["c"], "--rms-tol", "1e-9"],
                 capsys)[0] == 1


def test_gate_2b_tool_runs_its_steps_on_the_cpu(mini_gguf_qk256, tmp_path):
    """``python -m bitnet_tpu_torch.tools.gate_2b`` on a mini GGUF with
    ``--device cpu``: run --receipt, gate, crossval against the C++ golden
    and the numpy golden, and the traced CPU crossval with trace-diff (the
    card's GGUF is 851 MB and runs only on the card); one JSON verdict."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "bitnet_tpu_torch.tools.gate_2b",
                        "--gguf", mini_gguf_qk256.path, "--device", "cpu",
                        "--kernel-path", "w2a8", "--with-golden",
                        "--trace-dir", str(tmp_path)],
                       cwd=repo, capture_output=True, text=True, timeout=600)
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and verdict["pass"], (verdict, r.stderr[-2000:])
    assert verdict["checks"] == {"gguf_generated": True, "golden_built": True,
                                 "cli_generate": True, "receipt_valid": True,
                                 "crossval_cppref": True, "crossval_golden": True}
    assert verdict["receipt"]["backend"] == "cpu"
    assert verdict["cppref"]["min_cosine"] > 0.99
    assert verdict["cpu_cppref"]["cosines"] == verdict["cppref"]["cosines"]
    assert verdict["trace_diff"] == {"mismatches": 0, "first": None}
