"""``bitnet_tpu_torch.models.validation`` against ``bitnet_tpu.models.validation``:
the LayerNorm envelope's rules, actions, RMS values and corrected weights,
the whole-model report, the fingerprint and the checkpoint metadata, on
the mini GGUFs and on a GGUF whose norms fall on every side of the
envelope (one stored quantized).  Each function runs on its own package's
``GGUFReader``; the results are equal (the RMS values are the same f32
numpy arithmetic, so equal exactly), ``created_unix`` aside (the clock)."""

import json

import numpy as np
import pytest

from bitnet_tpu.errors import ModelError as JModelError
from bitnet_tpu.gguf.reader import GGUFReader as JReader
from bitnet_tpu.models import validation as jv
from bitnet_tpu_torch.errors import ModelError
from bitnet_tpu_torch.gguf.constants import GGMLType
from bitnet_tpu_torch.gguf.reader import GGUFReader
from bitnet_tpu_torch.gguf.writer import GGUFWriter
from bitnet_tpu_torch.models import validation as tv


@pytest.fixture(scope="module")
def bad_norms(tmp_path_factory):
    """norms at RMS 1 (accept), 0.3 (warn), 100 (reject), one stored Q8_0."""
    path = str(tmp_path_factory.mktemp("ln") / "norms.gguf")
    w = GGUFWriter()
    w.add_metadata("general.architecture", "bitnet-25")
    rng = np.random.default_rng(3)
    w.add_tensor("blk.0.attn_norm.weight", np.ones(64, np.float32))
    w.add_tensor("blk.0.ffn_norm.weight", np.full(64, 0.3, np.float16))
    w.add_tensor("blk.1.attn_norm.weight", np.full(64, 100.0, np.float32))
    w.add_quantized_tensor("blk.1.ffn_norm.weight", (64,), GGMLType.Q8_0,
                           bytes(2 * 34))
    w.add_tensor("blk.0.attn_q.weight", rng.standard_normal((64, 64)).astype(np.float32))
    w.add_tensor("output_norm.weight", (1 + 0.1 * rng.standard_normal(64)).astype(
        np.float32))
    w.write(path)
    return path


def _paths(request, names):
    return {n: (request.getfixturevalue(n) if n == "bad_norms"
                else request.getfixturevalue(n).path) for n in names}


MODELS = ["mini_gguf_f32", "mini_gguf_qk256", "mini_gguf_bitnet32", "bad_norms"]


def test_actions_and_rules_are_the_jax_ones():
    assert [(a.name, a.value) for a in tv.CorrectionAction] == [
        (a.name, a.value) for a in jv.CorrectionAction]
    for arch in ("bitnet-25", "BitNet-b1.58", "llama", "", None):
        assert (tv.detect_rules(arch).__dict__ == jv.detect_rules(arch).__dict__)
    assert tv.LNRules().__dict__ == jv.LNRules().__dict__


W = {"unit": np.ones(64, np.float32), "drift": np.full(64, 0.3, np.float32),
     "high": np.full(64, 100.0, np.float32), "tiny": np.full(64, 1e-3, np.float32),
     "noise": (1 + 0.4 * np.random.default_rng(5).standard_normal(96)).astype(
         np.float32), "empty": np.zeros(0, np.float32)}


@pytest.mark.parametrize("policy", ["warn", "rescale", "strict"])
@pytest.mark.parametrize("arch", ["bitnet-25", "llama"])
@pytest.mark.parametrize("which", list(W))
def test_check_layernorm_is_the_jax_one(policy, arch, which):
    rules = dict(tv.detect_rules(arch).__dict__, policy=policy)
    w = W[which]
    try:
        want = jv.check_layernorm("x", w, jv.LNRules(**rules))
    except JModelError as e:
        with pytest.raises(ModelError, match="RMS"):
            tv.check_layernorm("x", w, tv.LNRules(**rules))
        assert "RMS" in str(e)
        return
    got = tv.check_layernorm("x", w, tv.LNRules(**rules))
    assert (got[0].value, got[1]) == (want[0].value, want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_check_layernorm_refuses_non_finite_as_jax():
    w = np.array([1.0, np.nan], np.float32)
    with pytest.raises(JModelError, match="non-finite"):
        jv.check_layernorm("x", w, jv.LNRules())
    with pytest.raises(ModelError, match="non-finite"):
        tv.check_layernorm("x", w, tv.LNRules())


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("rules", [None, "strict_high"])
def test_validate_model_lns_is_the_jax_report(request, name, rules):
    path = _paths(request, [name])[name]
    kw = {} if rules is None else dict(rms_min=0.95, warn_min=0.99)
    with GGUFReader(path) as r:
        got = tv.validate_model_lns(r, tv.LNRules(**kw) if kw else None)
    with JReader(path) as r:
        want = jv.validate_model_lns(r, jv.LNRules(**kw) if kw else None)
    assert got == want and got["checked"] > 0
    if name == "bad_norms" and rules is None:
        assert len(got["warnings"]) == 1 and len(got["rejected"]) == 2
        assert any("stored quantized" in r.get("error", "") for r in got["rejected"])


@pytest.mark.parametrize("name", MODELS)
def test_fingerprint_and_metadata_are_the_jax_ones(request, name, tmp_path):
    path = _paths(request, [name])[name]
    assert tv.fingerprint_model(path) == jv.fingerprint_model(path)
    assert tv.fingerprint_model(path, 64) == jv.fingerprint_model(path, 64)
    got, want = tv.checkpoint_metadata(path), jv.checkpoint_metadata(path)
    assert got.pop("created_unix") >= want.pop("created_unix") - 60
    assert got == want and got["format"] == "gguf"
    out = tv.write_checkpoint_metadata(path, str(tmp_path / "m.json"))
    with open(out) as f:
        written = json.load(f)
    written.pop("created_unix")
    assert written == want
    if name == "bad_norms":            # this module's own file: a sibling is fine
        assert tv.write_checkpoint_metadata(path) == path + ".meta.json"


def test_metadata_of_a_file_that_is_not_a_gguf(tmp_path):
    p = tmp_path / "w.safetensors"
    p.write_bytes(b"\x08\x00\x00\x00\x00\x00\x00\x00{}      ")
    got, want = tv.checkpoint_metadata(str(p)), jv.checkpoint_metadata(str(p))
    got.pop("created_unix"), want.pop("created_unix")
    assert got == want and got["format"] == "safetensors"
