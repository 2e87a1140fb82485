"""``python -m bitnet_tpu_torch.cli run`` against ``bitnet_tpu.cli run`` on
the mini QK256 fixture: with ``--device cpu --greedy`` (auto → xla on the
CPU) the port prints the text the JAX package's CLI prints with
``--greedy --kernel-path xla``, on every kernel path the port has.
Without ``--device cpu`` it refuses to run when CUDA is absent, and flags
of paths not ported yet raise, naming their ROADMAP item."""

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
    (["--speculative", "4"], "#12"), (["--draft-model", "d.gguf"], "#12"),
    (["--grammar-file", "g.gbnf"], "#15"), (["--json-schema", "any"], "#15"),
    (["--receipt", "r.json"], "#11"),
    (["--sliding-window", "64"], "#7"), (["--decode-steps", "8"], "#5")])
def test_cli_refuses_unported_flags(mini_gguf_qk256, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        cli.main(["run", "--model", mini_gguf_qk256.path, *ARGS,
                  "--device", "cpu", *flags])


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
