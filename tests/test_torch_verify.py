"""The port's verification modules against the JAX package's on the same
inputs: the numpy golden forward (bit for bit), receipt validation (the
same problem lists), activation traces (dump / load / compare) and GGUF
compatibility diagnosis (the same dicts), plus receipts built from the
port's engine on the CPU."""

import json

import numpy as np
import pytest
import torch

from bitnet_tpu.gguf.fixtures import MiniModelSpec as JMiniModelSpec
from bitnet_tpu.gguf.fixtures import generate_mini_gguf as jgenerate_mini_gguf
from bitnet_tpu.verify import compat as jcompat
from bitnet_tpu.verify import receipts as jreceipts
from bitnet_tpu.verify import reference as jreference
from bitnet_tpu.verify import trace as jtrace
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.gguf.reader import GGUFReader
from bitnet_tpu_torch.models.config import config_from_gguf
from bitnet_tpu_torch.verify import compat, receipts, reference, trace

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

TOKENS = [2, 7, 11, 13, 17]


@pytest.fixture(scope="module")
def mini_models(tmp_path_factory):
    """Mini GGUFs written by the JAX fixtures (their float reference
    weights beside them): f32, qk256, bitnet32, and qk256 with the 2B-4T
    sub-norms."""
    d = tmp_path_factory.mktemp("verify")
    specs = {"f32": JMiniModelSpec(quant="f32"),
             "qk256": JMiniModelSpec(hidden_size=256, intermediate_size=512,
                                     quant="qk256"),
             "bitnet32": JMiniModelSpec(quant="bitnet32"),
             "qk256_sub_norm": JMiniModelSpec(quant="qk256", sub_norm=True)}
    return {k: jgenerate_mini_gguf(str(d / f"{k}.gguf"), s) for k, s in specs.items()}


@pytest.mark.parametrize("kind", ["f32", "qk256", "bitnet32", "qk256_sub_norm"])
def test_reference_forward_is_the_jax_one_bit_for_bit(mini_models, kind):
    m = mini_models[kind]
    with GGUFReader(m.path) as r:
        cfg = config_from_gguf(r)
    want = jreference.reference_forward(cfg, m.weights, TOKENS)
    got = reference.reference_forward(cfg, m.weights, TOKENS)
    assert got.dtype == np.float32 and got.shape == (len(TOKENS), cfg.vocab_size)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("threshold", [0.99, 0.999999])
def test_compare_logits_is_the_jax_one(threshold):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 32)).astype(np.float32)
    b = a + 0.05 * rng.standard_normal((6, 32)).astype(np.float32)
    b[4] = -b[4]
    assert (reference.compare_logits(a, b, threshold)
            == jreference.compare_logits(a, b, threshold))
    assert reference.cosine_similarity(np.zeros(3), np.zeros(3)) == 1.0
    assert reference.cosine_similarity(np.zeros(3), np.ones(3)) == 0.0


# (name, receipt fields, strict): every problem the JAX validator finds
RECEIPTS = [
    ("valid", dict(kernels=["prefill_w2a8_T8", "decode_w2a8_x4",
                            "kernel_ternary_matmul_w2a8_normed_x30"]), True),
    ("mock_kernel", dict(kernels=["mock_matmul"]), True),
    ("mock_kernel_tolerant", dict(kernels=["Fake_GEMM"]), False),
    ("mock_compute_path", dict(compute_path="mock", kernels=["k"]), True),
    ("mock_compute_path_tolerant", dict(compute_path="mock", kernels=["k"]), False),
    ("bad_compute_path", dict(compute_path="emulated", kernels=["k"]), True),
    ("empty_kernels", dict(), True),
    ("bad_kernel_id", dict(kernels=["", "x" * 129]), True),
    ("failed_parity", dict(kernels=["k"], parity={"passed": False}), True),
    ("wrong_schema", dict(schema_version="0.9.0", kernels=["k"]), True),
    ("mock_tokenizer", dict(compute_path="mock",
                            kernels=["prefill_xla_T8", "tokenizer_mock"]), True),
]


@pytest.mark.parametrize("name,fields,strict", RECEIPTS, ids=[r[0] for r in RECEIPTS])
def test_validate_receipt_gives_the_jax_problems(name, fields, strict):
    got = receipts.validate_receipt(receipts.InferenceReceipt(**fields), strict)
    want = jreceipts.validate_receipt(jreceipts.InferenceReceipt(**fields), strict)
    assert got == want
    assert bool(got) == (name not in ("valid", "mock_kernel_tolerant",
                                      "mock_compute_path_tolerant"))


def test_receipt_json_round_trip_and_fingerprint():
    r = receipts.InferenceReceipt(kernels=["prefill_xla_T8"], backend="cpu",
                                  request={"prompt_ids": [1], "output_ids": [2],
                                           "gen": {"greedy": True}})
    r2 = receipts.InferenceReceipt.from_json(r.to_json())
    assert r2 == r and r2.fingerprint() == r.fingerprint()
    # a receipt the JAX package writes reads back in the port, and back
    j = jreceipts.InferenceReceipt(kernels=["k"], backend="tpu")
    p = receipts.InferenceReceipt.from_json(j.to_json())
    assert p.to_dict() == j.to_dict()
    assert receipts.validate_receipt(p) == jreceipts.validate_receipt(j) == []


@pytest.mark.parametrize("kp", ["xla", "w2a8"])
def test_engine_receipt_on_the_cpu(mini_gguf_qk256, kp):
    """A receipt from the port's engine: backend cpu, real compute, the
    path recorded, no kernel launch counted (plain versions ran), the
    request kept for replay; strict-valid under both validators."""
    eng = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(max_seq_len=64, kernel_path=kp,
                                           compute_dtype="f32"), device="cpu")
    out = eng.generate([1, 5, 9], GenerationConfig(max_new_tokens=2, greedy=True))
    rec = receipts.generate_receipt(eng, metrics={"decode_tok_s": 1.0})
    assert rec.backend == "cpu" and rec.compute_path == "real"
    assert rec.kernels == [f"prefill_{kp}_T8", f"decode_{kp}_x2"]
    assert rec.environment["torch"] == torch.__version__
    assert rec.environment["device"] == "cpu" and "nvidia_smi" not in rec.environment
    assert rec.model_info["num_layers"] == 2
    assert rec.request["output_ids"] == out.token_ids
    assert receipts.validate_receipt(rec) == []
    j = jreceipts.InferenceReceipt.from_json(rec.to_json())
    assert jreceipts.validate_receipt(j, strict=True) == []


def test_mock_tokenizer_makes_a_mock_receipt(mini_gguf_qk256):
    from bitnet_tpu_torch.tokenizer import MockTokenizer

    eng = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(max_seq_len=64, compute_dtype="f32"),
        tokenizer=MockTokenizer(), device="cpu")
    eng.generate("x", GenerationConfig(max_new_tokens=2, greedy=True))
    rec = receipts.generate_receipt(eng)
    assert rec.compute_path == "mock" and rec.kernels[-1] == "tokenizer_mock"
    assert receipts.validate_receipt(rec, strict=True) != []
    assert (receipts.validate_receipt(rec, strict=True)
            == jreceipts.validate_receipt(
                jreceipts.InferenceReceipt.from_json(rec.to_json()), strict=True))


def _traces(mod):
    a = mod.TraceSink()
    a.record("a", np.ones(8))
    a.record("b", np.full((2, 4), 2.0))
    a.record("c", np.asarray([3.0, 4.0]))
    b = mod.TraceSink()
    b.record("a", np.ones(8))
    b.record("b", np.full((2, 4), 2.1))        # rms off by 5 %
    b.record("c", np.asarray([3.0, 4.0, 0.0]))  # another shape
    return a, b


def test_trace_dump_load_compare_is_the_jax_one(tmp_path):
    pa, pb = _traces(trace)
    ja, jb = _traces(jtrace)
    assert [r.to_dict() for r in pa.records] == [r.to_dict() for r in ja.records]
    pa.dump(str(tmp_path / "a.json"))
    ja.dump(str(tmp_path / "ja.json"))
    assert (json.loads((tmp_path / "a.json").read_text())
            == json.loads((tmp_path / "ja.json").read_text()))
    loaded = trace.TraceSink.load(str(tmp_path / "ja.json"))
    assert trace.compare_records(loaded.records, pa.records) == []
    for rtol in (0.02, 0.1):
        got = trace.compare_records(pa.records, pb.records, rtol)
        assert got == jtrace.compare_records(ja.records, jb.records, rtol)
    assert [d["name"] for d in trace.compare_records(pa.records, pb.records)] == ["b", "c"]
    assert trace.compare_records(pa.records, [])[0]["error"] == "missing in other trace"


def test_trace_record_of_a_torch_tensor():
    """A bf16 tensor (on any device) is recorded as its f32 values."""
    t = torch.tensor([[3.0, 4.0]], dtype=torch.bfloat16)
    r = trace.TraceRecord.of("x", t)
    assert r.shape == (1, 2) and r.first == [3.0, 4.0]
    assert r.rms == pytest.approx(np.sqrt(12.5))


def test_eval_ids_trace_names_every_layer(mini_gguf_qk256):
    eng = InferenceEngine.from_gguf(mini_gguf_qk256.path,
                                    EngineConfig(max_seq_len=64), device="cpu")
    sink = trace.TraceSink()
    eng.eval_ids(TOKENS, trace=sink)
    assert [r.name for r in sink.records] == [
        "token_embd", "blk.0.out", "blk.1.out", "output_norm"]
    assert all(r.shape == (len(TOKENS), 256) for r in sink.records)


def _bad_ggufs(tmp_path, writer_cls):
    garbage = tmp_path / "garbage.gguf"
    garbage.write_bytes(b"garbage")
    noarch = str(tmp_path / "noarch.gguf")
    writer_cls().write(noarch)
    return [str(garbage), noarch]


def test_compat_diagnose_gives_the_jax_dicts(mini_models, tmp_path):
    from bitnet_tpu.gguf.writer import GGUFWriter as JWriter

    paths = [m.path for m in mini_models.values()] + _bad_ggufs(tmp_path, JWriter)
    for p in paths:
        got = compat.diagnose(p)
        assert got == jcompat.diagnose(p), p
    assert compat.diagnose(mini_models["f32"].path)["errors"] == []
    assert compat.diagnose(paths[-2])["errors"]
    assert any("general.architecture" in e for e in compat.diagnose(paths[-1])["errors"])


def test_compat_export_fixed_matches_the_jax_one(mini_models, tmp_path):
    """A GGUF stripped of its architecture keys: both packages apply the
    same fixes and write files that diagnose alike and load alike."""
    from bitnet_tpu_torch.gguf.writer import GGUFWriter

    src = mini_models["qk256"].path
    stripped = str(tmp_path / "stripped.gguf")
    with GGUFReader(src) as r:
        w = GGUFWriter()
        for k, v in r.metadata.items():
            if not k.startswith(("general.architecture", r.architecture + ".")):
                w.add_metadata(k, v)
        for info in r.tensors.values():
            w.add_quantized_tensor(info.name, tuple(info.logical_shape),
                                   info.ggml_type, bytes(r.tensor_bytes(info.name)))
        w.write(stripped)
    got = compat.export_fixed(stripped, str(tmp_path / "port.gguf"))
    want = jcompat.export_fixed(stripped, str(tmp_path / "jax.gguf"))
    assert got["applied"] == want["applied"] and got["applied"]
    assert compat.diagnose(str(tmp_path / "port.gguf"))["errors"] == []
    with GGUFReader(str(tmp_path / "port.gguf")) as a, \
            GGUFReader(str(tmp_path / "jax.gguf")) as b:
        assert list(a.metadata) == list(b.metadata)
        assert all(np.array_equal(np.asarray(a.metadata[k]), np.asarray(b.metadata[k]))
                   for k in a.metadata)
        assert list(a.tensors) == list(b.tensors)
