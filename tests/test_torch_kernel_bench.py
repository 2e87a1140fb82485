"""``benchmark-kernels`` of the port against the JAX package's tool.

The port's ``tools/kernel_bench.py`` keeps the JAX tool's result keys,
its 2B decode shapes and its attention variants, and the CLI prints the
same JSON.  On the CPU (``--device cpu``) it times the plain versions
with the host clock, which only shows here that every variant runs; the
card's times come from CUDA-graph replays (``obs/timing.py``).  Without
``--device cpu`` it needs the card.
"""

import contextlib
import dataclasses
import io
import json

import pytest
import torch

from bitnet_tpu.tools import kernel_bench as jkb
from bitnet_tpu_torch import cli
from bitnet_tpu_torch.errors import ConfigError
from bitnet_tpu_torch.obs.timing import chain_timer
from bitnet_tpu_torch.tools import kernel_bench as kb

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KEYS = [f.name for f in dataclasses.fields(jkb.KernelBenchResult)]


def _run(argv) -> list[dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["benchmark-kernels", *argv]) == 0
    return json.loads(out.getvalue())


def test_the_tool_keeps_the_jax_tools_keys_shapes_and_variants():
    assert [f.name for f in dataclasses.fields(kb.KernelBenchResult)] == KEYS
    assert kb.DECODE_SHAPES_2B == jkb.DECODE_SHAPES_2B
    assert kb.ATTN_VARIANTS == jkb.ATTN_VARIANTS


def test_benchmark_kernels_shape_on_cpu():
    rows = _run(["--shape", "512x256", "--m", "2", "--device", "cpu"])
    assert len(rows) == 1 and list(rows[0]) == KEYS
    r = rows[0]
    assert (r["name"], r["k"], r["n"], r["m"]) == ("512x256", 512, 256, 2)
    assert r["us_per_call"] > 0 and r["packed_mb"] == round(512 // 4 * 256 / 1e6, 2)


def test_benchmark_kernels_attention_all_on_cpu():
    rows = _run(["--attention", "all", "--seq-len", "64", "--m", "3",
                 "--device", "cpu"])
    assert [r["name"] for r in rows] == [f"attn_{v}" for v in jkb.ATTN_VARIANTS]
    for r in rows:
        assert list(r) == KEYS and (r["k"], r["n"], r["m"]) == (64, 640, 3)
        assert r["us_per_call"] > 0
        quant = "quant" in r["name"]
        assert r["packed_mb"] == round(2 * 3 * 64 * 640 * (1 if quant else 2) / 1e6, 2)


def test_benchmark_kernels_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        cli.main(["benchmark-kernels", "--shape", "256x128"])
    with pytest.raises(ValueError, match="unknown attention variant"):
        kb.bench_decode_attention("flash_v3", S=64, device="cpu")


def test_chain_timer_differences_two_chain_lengths():
    """The host-clock path: a positive time a step; two chains of one
    length are refused."""
    def step(x, i):
        return x + 1.0

    assert chain_timer(step, lambda salt: torch.zeros(4), 40, 20) > 0
    with pytest.raises(ValueError):
        chain_timer(step, lambda salt: torch.zeros(4), 20, 20)
