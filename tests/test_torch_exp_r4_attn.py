"""The port's per-layer decode-attention bench
(``bitnet_tpu_torch.experiments.exp_r4_attn``) against the script it ports
(``experiments/exp_r4_attn.py``): every variant runs on the CPU at a small
size (the plain versions; host times, never the card's), each kernel
variant is the port's wrapper for the JAX function the script calls for
it (read from the script's source, and found by the registry's site line
inside that function in the JAX package; the port's two variants over the
5-D stack run K25 and K26; ``paged`` runs K33, the stock paged attention),
and unknown names raise."""

import ast
import math
from pathlib import Path

import pytest
import torch

from bitnet_tpu_torch.experiments import exp_r4_attn as ex
from bitnet_tpu_torch.ops import registry

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_MODULES = {"da": "bitnet_tpu/ops/decode_attention.py",
               "da2": "bitnet_tpu/ops/decode_attention_v2.py"}


def _script_table() -> dict[str, tuple[str, str]]:
    """variant -> (JAX file, function) from the script's two dict literals."""
    tree = ast.parse((REPO / "experiments" / "exp_r4_attn.py").read_text())
    table = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and all(
                isinstance(k, ast.Constant) for k in node.keys):
            for k, v in zip(node.keys, node.values):
                if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name):
                    table[k.value] = (JAX_MODULES[v.value.id], v.attr)
    return table


def _enclosing_function(path: str, line: int) -> str:
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.lineno <= line <= node.end_lineno:
            return node.name
    raise AssertionError(f"{path}:{line} is in no function")


# the port's two variants beyond the script's: the JAX functions they run
OWN = {"stacked": (JAX_MODULES["da"], "decode_attention_stacked"),
       "stacked_inplace": (JAX_MODULES["da"], "decode_attention_stacked_inplace")}


def test_the_script_table_is_the_ports():
    assert set(_script_table()) | set(OWN) == set(ex.VARIANTS)


@pytest.mark.parametrize("variant", sorted(ex.VARIANTS))
def test_variant_runs_the_kernel_of_the_scripts_function(variant):
    path, jfn = {**_script_table(), **OWN}[variant]
    wrapper = ex.VARIANTS[variant][0]
    spec, = [s for s in registry.REGISTRY if s.wrapper is wrapper]
    site_file, site_line = spec.replaces.split(" ")[0].rsplit(":", 1)
    assert site_file == path
    assert _enclosing_function(path, int(site_line)) == jfn


@pytest.mark.parametrize("variant", [v for v in ex.ALL if v != "paged"])
def test_every_variant_runs_on_the_cpu(variant, capsys):
    registry.reset_launch_counts()
    r = ex.bench_variant(variant, L=2, B=3, S=64, device="cpu", n_hi=3, n_lo=1)
    assert r["device"] == "cpu" and math.isfinite(r["us_per_layer"])
    assert r["us_per_layer"] > 0
    assert r["kernel"] == (None if variant in ex.PLAIN
                           else ex.VARIANTS[variant][0].__name__)
    quant = variant in ex.VARIANTS and ex.VARIANTS[variant][2]
    assert r["floor_us_per_layer"] == pytest.approx(
        2 * 3 * 64 * 5 * 128 * (1 if quant else 2) / 3.35e12 * 1e6)
    assert f"{variant}: " in capsys.readouterr().out
    assert all(n == 0 for n in registry.launch_counts().values())


def test_one_untimed_loop_is_finite_and_keeps_its_shape():
    step, make_carry, fn, _ = ex.make_variant("v2p", L=2, B=3, S=64, device="cpu")
    c = make_carry(1)
    out = step(c, 0)
    assert fn.__name__ == "decode_attention_perb_v2"
    assert out.shape == c.shape and bool(torch.isfinite(out.float()).all())


def test_paged_and_unknown_variants_raise(monkeypatch, capsys):
    """Unknown names raise; ``paged`` (which raised naming #12 until K33
    ported the stock kernel) runs from the script's environment."""
    with pytest.raises(ValueError, match="unknown variant"):
        ex.make_variant("v3", device="cpu")
    monkeypatch.setenv("ONLY", "paged")
    monkeypatch.setenv("S", "256")
    monkeypatch.setattr(ex, "bench_variant", lambda only, B, S, device: ex.make_variant(
        only, L=2, B=B, S=S, device=device)[0](ex.make_variant(
            only, L=2, B=B, S=S, device=device)[1](0), 0))
    assert ex.main(["--device", "cpu"]) == 0
    assert "ONLY=paged" in capsys.readouterr().out


def test_paged_variant_runs_on_the_cpu(capsys):
    registry.reset_launch_counts()
    r = ex.bench_variant("paged", L=2, B=2, S=256, device="cpu", n_hi=3, n_lo=1)
    assert r["kernel"] == "paged_attention" and math.isfinite(r["us_per_layer"])
    assert r["floor_us_per_layer"] == pytest.approx(2 * 2 * 256 * 5 * 128 * 2
                                                    / 3.35e12 * 1e6)
    assert "paged: " in capsys.readouterr().out
    assert all(n == 0 for n in registry.launch_counts().values())


def test_main_reads_the_scripts_environment(monkeypatch, capsys):
    monkeypatch.setattr(ex, "bench_variant",
                        lambda only, **kw: print("ran", only, sorted(kw.items())))
    for k, v in {"ONLY": "v1kb", "B": "3", "S": "64", "CHUNK": "128"}.items():
        monkeypatch.setenv(k, v)
    assert ex.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selects nothing on the card" in out
    assert "ran v1kb [('B', 3), ('S', 64), ('device', 'cpu')]" in out
