"""The port's CLI subcommands against ``bitnet_tpu.cli.main`` on the minis:
the two parsers have the same set of subcommands, and each subcommand
prints the JAX CLI's JSON keys (or text) and exits with its code on the
same inputs.  Where the value comes from the same function on the same
file (``tokenize``, ``inspect``, ``fingerprint``, ``ln-check``,
``compat-check``, ``config``, ``list-templates``, ``list-architectures``,
``bench-compare``, ``download-model``'s refusals) it is the same value.
The engine-building ones (``chat``, ``score``, ``benchmark``) run with
``--device cpu`` at f32 (compute and cache) against the JAX CLI on
``--kernel-path xla`` at f32: the same text and tokens, the perplexity
within 1e-4 (relative; f32 sums in another order), and they refuse to run
without a card unless given ``--device cpu``.  ``info`` and ``preflight``
report torch and the card in place of JAX and the TPU: the same keys but
those."""

import argparse
import io
import json
import sys

import pytest
import torch

from bitnet_tpu import cli as jcli
from bitnet_tpu_torch import cli
from bitnet_tpu_torch.gguf.writer import GGUFWriter

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

F32 = ["--compute-dtype", "f32", "--kv-cache-dtype", "f32", "--max-seq-len", "128"]
DEV = {"port": ["--device", "cpu"], "jax": ["--kernel-path", "xla"]}


class _Parsed(Exception):
    pass


def _subcommands(main, monkeypatch):
    """The subcommand names of ``main``'s parser (caught at parse time)."""
    def grab(self, *_a, **_kw):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            main(["run"])
    ap = e.value.args[0]
    subs = [a for a in ap._actions if isinstance(a, argparse._SubParsersAction)]
    return set(subs[0].choices)


def test_the_parsers_have_the_same_subcommands(monkeypatch):
    got, want = _subcommands(cli.main, monkeypatch), _subcommands(jcli.main, monkeypatch)
    assert got == want and len(want) == 26


def _out(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _json(main, argv, capsys):
    rc, out, err = _out(main, argv, capsys)
    return rc, json.loads(out)


@pytest.fixture(autouse=True)
def _config(tmp_path, monkeypatch):
    """Every test reads and writes its own config file."""
    monkeypatch.setenv("BITNET_TPU_CONFIG", str(tmp_path / "cfg" / "config.json"))


@pytest.mark.parametrize("argv", [["-p", "Hello world"], ["-p", "Hi there", "--no-bos"]])
def test_tokenize_is_the_jax_one(mini_gguf_qk256, capsys, argv):
    a = ["tokenize", "-m", mini_gguf_qk256.path, *argv]
    got, want = _json(cli.main, a, capsys), _json(jcli.main, a, capsys)
    assert got == want and got[1]["count"] > 1


@pytest.mark.parametrize("fixture", ["mini_gguf_qk256", "mini_gguf_bitnet32",
                                     "mini_gguf_f32"])
@pytest.mark.parametrize("tensors", [False, True])
def test_inspect_is_the_jax_one(request, capsys, fixture, tensors):
    a = ["inspect", "-m", request.getfixturevalue(fixture).path] + (
        ["--tensors"] if tensors else [])
    got, want = _json(cli.main, a, capsys), _json(jcli.main, a, capsys)
    assert got == want and ("tensors" in got[1]) == tensors


@pytest.fixture(scope="module")
def broken_gguf(tmp_path_factory):
    """A GGUF with no architecture and a norm far outside the envelope."""
    import numpy as np

    path = str(tmp_path_factory.mktemp("cli") / "broken.gguf")
    w = GGUFWriter()
    w.add_tensor("blk.0.attn_norm.weight", np.full(64, 1000.0, np.float32))
    w.add_tensor("output_norm.weight", np.ones(64, np.float32))
    w.write(path)
    return path


@pytest.mark.parametrize("which", ["mini_gguf_qk256", "mini_gguf_f32", "broken"])
def test_fingerprint_and_ln_check_are_the_jax_ones(request, capsys, which, broken_gguf):
    path = broken_gguf if which == "broken" else request.getfixturevalue(which).path
    grc, got = _json(cli.main, ["fingerprint", "-m", path], capsys)
    wrc, want = _json(jcli.main, ["fingerprint", "-m", path], capsys)
    got.pop("created_unix"), want.pop("created_unix")
    assert (grc, got) == (wrc, want) == (0, want)
    got = _json(cli.main, ["ln-check", "-m", path], capsys)
    want = _json(jcli.main, ["ln-check", "-m", path], capsys)
    assert got == want and (which != "broken" or got[0] == 1)


@pytest.mark.parametrize("which", ["mini_gguf_qk256", "broken"])
@pytest.mark.parametrize("fix", [False, True])
def test_compat_check_is_the_jax_one(request, capsys, tmp_path, which, fix, broken_gguf):
    path = broken_gguf if which == "broken" else request.getfixturevalue(which).path
    res = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        extra = ["--fix-out", str(tmp_path / f"{name}.gguf")] if fix else []
        res[name] = _json(main, ["compat-check", "-m", path, *extra], capsys)
        res[name][1].pop("out_path", None)
    assert res["port"] == res["jax"]
    if which == "broken" and not fix:
        assert res["port"][0] == 1 and res["port"][1]["errors"]


def test_config_is_the_jax_one_and_defaults_every_model_flag(mini_gguf_qk256, capsys,
                                                            tmp_path, monkeypatch):
    steps = [["path"], ["show"], ["set", "model", mini_gguf_qk256.path],
             ["set", "n", "5"], ["set", "name", "two words"], ["show"],
             ["unset", "n"], ["set", "only_key"], ["unset"], ["show"]]
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        monkeypatch.setenv("BITNET_TPU_CONFIG", str(tmp_path / name / "c.json"))
        outs[name] = [_out(main, ["config", *s], capsys) for s in steps]
    for (grc, gout, gerr), (wrc, wout, werr) in zip(outs["port"], outs["jax"]):
        assert (grc, gerr) == (wrc, werr)
        assert gout.replace("/port/", "/jax/") == wout
    assert [o[0] for o in outs["port"]] == [0] * 7 + [2, 2, 0]
    assert json.loads(outs["port"][5][1]) == {"model": mini_gguf_qk256.path, "n": 5,
                                              "name": "two words"}
    # --model falls back to the config's model in every subcommand that takes it
    want = _json(cli.main, ["tokenize", "-m", mini_gguf_qk256.path, "-p", "Hi"], capsys)
    assert _json(cli.main, ["tokenize", "-p", "Hi"], capsys) == want
    assert _json(cli.main, ["inspect"], capsys)[1]["path"] == mini_gguf_qk256.path
    monkeypatch.setenv("BITNET_TPU_CONFIG", str(tmp_path / "none.json"))
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(["fingerprint"])
        assert e.value.code == 2
    assert "config set model" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["list-templates", "list-architectures"])
def test_the_catalogs_are_the_jax_ones(capsys, cmd):
    got, want = _out(cli.main, [cmd], capsys), _out(jcli.main, [cmd], capsys)
    assert got == want and got[0] == 0 and got[1].count("\n") > 2


@pytest.mark.parametrize("form", ["plain", "parsed", "stdout", "tail"])
@pytest.mark.parametrize("as_json", [False, True])
def test_bench_compare_is_the_jax_one(capsys, tmp_path, form, as_json):
    base = {"metric": "decode", "value": 100.0, "decode_ms_per_token_b1": 1.5,
            "prefill_tok_s": 4000.0, "roofline_pct": 20.0, "only_base": 1}
    cand = {"metric": "decode", "value": 90.0, "decode_ms_per_token_b1": 1.45,
            "prefill_tok_s": 4500.0, "roofline_pct": 20.5, "only_cand": 2}
    paths = []
    for name, d in (("a", base), ("b", cand)):
        p = tmp_path / f"{name}.json"
        text = {"plain": json.dumps(d), "parsed": json.dumps({"parsed": d}),
                "stdout": "log line\n" + json.dumps(d) + "\n",
                "tail": json.dumps({"tail": "x\n" + json.dumps(d)})}[form]
        p.write_text(text)
        paths.append(str(p))
    a = ["bench-compare", *paths] + (["--json"] if as_json else [])
    got, want = _out(cli.main, a, capsys), _out(jcli.main, a, capsys)
    assert got == want and got[0] == 1            # value fell 10 %
    a += ["--threshold", "0.2"]
    assert _out(cli.main, a, capsys) == _out(jcli.main, a, capsys)


def test_download_model_refuses_offline_as_jax(capsys, monkeypatch):
    """Disabled by default; opened, but with no hub client importable (the
    test hides any that is installed), still refused.  No network."""
    a = ["download-model", "--repo", "org/model"]
    monkeypatch.delenv("BITNET_ALLOW_DOWNLOADS", raising=False)
    got, want = _out(cli.main, a, capsys), _out(jcli.main, a, capsys)
    assert got == want and got[0] == 1 and "downloads disabled" in got[2]
    monkeypatch.setenv("BITNET_ALLOW_DOWNLOADS", "1")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    got, want = _out(cli.main, a, capsys), _out(jcli.main, a, capsys)
    assert got == want and got[0] == 1 and "huggingface_hub unavailable" in got[2]


def test_info_reports_torch_and_the_device(capsys):
    grc, got = _json(cli.main, ["info"], capsys)
    wrc, want = _json(jcli.main, ["info"], capsys)
    assert grc == wrc == 0
    assert set(got) - {"torch", "torch_cuda"} == set(want) - {"jax", "jaxlib"}
    for k in ("python", "platform", "numpy", "config_file"):
        assert got[k] == want[k]
    assert got["torch"] == torch.__version__ and got["backend"] == "cpu"
    assert got["device"]["platform"] == "cpu" and got["recommended_kernel_path"] == "xla"


def test_preflight_reports_the_card_and_the_pack(capsys, monkeypatch):
    """The port's ``preflight`` has the JAX keys; ``native_codec`` (the
    loader packs QK256 on the card) is true where the probe finds a card
    and false on the CPU."""
    from bitnet_tpu_torch import device_probe

    grc, got = _json(cli.main, ["preflight"], capsys)
    wrc, want = _json(jcli.main, ["preflight"], capsys)
    assert grc == wrc == 0 and set(got) == set(want)
    assert got["native_codec"] is False and set(got["toolchain"]) == {"nvcc", "gxx"}
    assert got["cpp_reference"] == want["cpp_reference"]
    assert got["device"]["platform"] == "cpu"
    card = device_probe.DeviceProbe("gpu", "NVIDIA H100 80GB HBM3", 1, (9, 0), True)
    monkeypatch.setattr(device_probe, "probe_device", lambda index=0: card)
    grc, got = _json(cli.main, ["preflight"], capsys)
    assert grc == 0 and got["native_codec"] is True
    assert got["device"]["device_kind"] == card.device_kind
    assert got["recommended_kernel_path"] == "w2a8"


def _chat(main, path, extra, capsys, monkeypatch, lines):
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(f"{x}\n" for x in lines)))
    return _out(main, ["chat", "-m", path, "--greedy", "-n", "6", *F32, *extra], capsys)


def test_chat_prints_the_jax_replies(mini_gguf_qk256, capsys, monkeypatch):
    lines = ["/metrics", "Hello", "/metrics", "/help", "/clear", "Hi", "/exit", "never"]
    grc, gout, gerr = _chat(cli.main, mini_gguf_qk256.path, DEV["port"], capsys,
                            monkeypatch, lines)
    wrc, wout, werr = _chat(jcli.main, mini_gguf_qk256.path, DEV["jax"], capsys,
                            monkeypatch, lines)
    assert (grc, gout) == (wrc, wout) == (0, wout) and len(gout.strip()) > 0
    assert gout.count("\n") == 2                    # two replies, nothing after /exit
    gm = [json.loads(x) for x in gerr.splitlines() if x.startswith("{")]
    wm = [json.loads(x) for x in werr.splitlines() if x.startswith("{")]
    assert gm[0] == wm[0] == {}                     # before the first turn
    assert set(gm[1]) >= {"generated_tokens", "ttft_s", "decode_tok_s"}
    assert gm[1]["generated_tokens"] == wm[1]["generated_tokens"]
    for text in ("/help /clear /metrics /exit", "(history cleared)"):
        assert text in gerr and text in werr


def test_score_and_benchmark_are_the_jax_ones(mini_gguf_qk256, capsys, tmp_path):
    f = tmp_path / "text.txt"
    f.write_text("The quick brown fox jumps over the lazy dog. " * 3)
    m = ["-m", mini_gguf_qk256.path, *F32]
    grc, got = _json(cli.main, ["score", *m, "--file", str(f), *DEV["port"]], capsys)
    wrc, want = _json(jcli.main, ["score", *m, "--file", str(f), *DEV["jax"]], capsys)
    assert grc == wrc == 0 and list(got) == list(want) and got["tokens"] == want["tokens"]
    assert got["nll"] == pytest.approx(want["nll"], rel=1e-4)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-4)
    assert _out(cli.main, ["score", *m, "-p", "", *DEV["port"]], capsys)[0] == 1
    b = ["benchmark", *m, "-n", "8", "-p", "Hello world"]
    grc, got = _json(cli.main, b + DEV["port"], capsys)
    wrc, want = _json(jcli.main, b + DEV["jax"], capsys)
    assert grc == wrc == 0 and list(got) == list(want)
    for k in ("prompt_tokens", "generated_tokens", "kernel_path"):
        assert got[k] == want[k]
    assert got["generated_tokens"] >= 1 and got["decode_tok_s"] > 0


@pytest.mark.parametrize("cmd", [["chat"], ["score", "-p", "a b c"],
                                 ["benchmark", "-n", "2"]])
def test_engine_commands_need_cuda_unless_asked_for_cpu(mini_gguf_qk256, monkeypatch, cmd):
    from bitnet_tpu_torch.errors import ConfigError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO("/exit\n"))
    with pytest.raises(ConfigError, match="CUDA is not available"):
        cli.main([*cmd[:1], "-m", mini_gguf_qk256.path, *cmd[1:]])
