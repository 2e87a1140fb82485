"""The bitnet32 / TL slice of the port end to end against the JAX package.

- ``EngineConfig(weight_quant="tl1"|"tl2")`` on the mini QK256 model, and a
  BitNet32-F16 GGUF, at f32: the same greedy tokens as the JAX engine, on
  the fused stacked path (B = 1 and a pool of 3) and on the generic
  unfused path, with the reference's kernel choice mirrored: K11 for B ≤ 2
  with every K a multiple of 256, K12 for larger pools, K10 on the
  generic path and in the stacked loop of a model whose widths are
  multiples of 128 but not of 256 (``ternary_matmul_stacked_tl``, ``:555``).
  Every prefill of these kinds runs the layer loop on K10.
- The loaders agree bit for bit on BitNet32-F16 and on Split32 with
  sibling scales; the port's fixture writer writes the JAX package's
  BitNet32 GGUF byte for byte; the synthetic bitnet32 model and the CLI
  (``--weight-quant``, a BitNet32 GGUF) run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu import cli as jcli
from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.gguf.fixtures import MiniModelSpec as JSpec
from bitnet_tpu.gguf.fixtures import generate_mini_gguf as jgenerate
from bitnet_tpu_torch import cli
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models import bitnet as pbitnet
from bitnet_tpu_torch.ops import ternary_matmul as tm

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

PROMPT = [1, 5, 9, 14, 200, 77, 3]
POOL = [PROMPT, PROMPT[:4], [9, 8, 7]]
MINI = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module")
def b32_gguf(tmp_path_factory):
    """A BitNet32-F16 mini model wide enough to fuse (K = 256 / 512)."""
    path = tmp_path_factory.mktemp("b32") / "mini_b32_h256.gguf"
    jgenerate(str(path), JSpec(quant="bitnet32", **MINI))
    return str(path)


@pytest.fixture(scope="module")
def h384_gguf(tmp_path_factory):
    """Widths multiples of 128 but not of 256: the TL stacked loop leaves
    its fused kernels for K10 on the stacked weights."""
    path = tmp_path_factory.mktemp("h384") / "mini_h384.gguf"
    jgenerate(str(path), JSpec(hidden_size=384, intermediate_size=512,
                               num_heads=3, num_kv_heads=1, quant="qk256"))
    return str(path)


@pytest.fixture
def spy(monkeypatch):
    """Calls of each block-scale wrapper from the model, by name."""
    calls = {"k10": 0, "k11": 0, "k12": 0}
    for key, name in (("k10", "ternary_matmul_blockscale_bf16"),
                      ("k11", "ternary_matmul_tl_w2a8_normed"),
                      ("k12", "ternary_matmul_tl_bf16_normed")):
        fn = getattr(tm, name)

        def wrapped(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(pbitnet, name, wrapped)
        monkeypatch.setattr(tm, name, wrapped)
    return calls


def _run(path, B, **kw):
    """Greedy tokens of the JAX engine and of the port's (CPU) engine."""
    kw = dict(max_seq_len=64, compute_dtype="f32", max_batch_size=B, **kw)
    je = JEngine.from_gguf(path, JEngineConfig(**kw))
    pe = InferenceEngine.from_gguf(path, EngineConfig(**kw), device="cpu")
    if B == 1:
        want = je.generate(PROMPT, JGenerationConfig(max_new_tokens=8, greedy=True))
        got = pe.generate(PROMPT, GenerationConfig(max_new_tokens=8, greedy=True))
        want, got = [want.token_ids], [got.token_ids]
    else:
        gc = dict(max_new_tokens=6, greedy=True)
        want = [r.token_ids for r in je.generate_batch(POOL, JGenerationConfig(**gc))]
        got = [r.token_ids for r in pe.generate_batch(POOL, GenerationConfig(**gc))]
    return je, pe, want, got


@pytest.mark.parametrize("wq,B,fuse,kp,kernel", [
    ("tl1", 1, True, "w2a8", "k11"), ("tl2", 1, True, "w2a8", "k11"),
    ("tl1", 3, True, "w2a8", "k12"), ("tl2", 3, True, "w2a8", "k12"),
    ("tl2", 1, False, "w2a8", "k10"), ("tl1", 1, False, "pallas", "k10"),
    ("tl2", 1, False, "xla", None)])
def test_tl_requant_greedy_matches_jax(mini_gguf_qk256, spy, wq, B, fuse, kp, kernel):
    je, pe, want, got = _run(mini_gguf_qk256.path, B, weight_quant=wq,
                             fuse_projections=fuse, kernel_path=kp)
    assert got == want
    assert pe.params.blocks.w_down.kind == "tl"
    assert pe.kernel_recorder[:2] == je.kernel_recorder[:2]
    assert pe.kernel_recorder[0] == f"weight_quant_{wq}"
    assert (("ternary_matmul_tl_w2a8_stacked" in pe.kernel_recorder)
            == (fuse and kp == "w2a8"))
    steps = sum(len(t) for t in got) // B - 1
    n_mm = (4 if fuse else 7) * 2                      # matmuls a step, 2 layers
    others = {k: v for k, v in spy.items() if k not in (kernel, "k10")}
    assert not any(others.values()), spy
    if kernel in ("k11", "k12"):                       # decode fused, prefill K10
        assert spy[kernel] == n_mm * steps and spy["k10"] == n_mm
    elif kernel == "k10":
        assert spy["k10"] == n_mm * (steps + 1)


@pytest.mark.parametrize("fuse,kp,B", [(True, "w2a8", 1), (False, "w2a8", 1),
                                       (False, "pallas", 1), (True, "w2a8", 3)])
def test_bitnet32_gguf_greedy_matches_jax(b32_gguf, fuse, kp, B):
    je, pe, want, got = _run(b32_gguf, B, fuse_projections=fuse, kernel_path=kp)
    assert got == want
    assert pe.params.blocks.w_down.kind == "bitnet32"
    assert pe.kernel_recorder[:1] == je.kernel_recorder[:1]


@pytest.mark.parametrize("kp", ["w2a8", "xla"])
def test_mini_bitnet32_fixture_matches_jax(mini_gguf_bitnet32, kp):
    """The suite's BitNet32 fixture (H = 64: q|k|v cannot fuse at 128-column
    granularity, so both engines fall back to the unfused path and say so)."""
    je, pe, want, got = _run(mini_gguf_bitnet32.path, 1, fuse_projections=True,
                             kernel_path=kp)
    assert got == want
    assert "fuse_projections_fallback" in pe.kernel_recorder
    assert "fuse_projections_fallback" in je.kernel_recorder


def test_unaligned_tl_model_runs_k10_in_the_stacked_loop(h384_gguf, spy):
    """K = 384: no fused TL kernel; the stacked loop runs K10 on the
    stacked weights with SwiGLU, the norm and the residual in torch
    (``bitnet_tpu/models/bitnet.py:490-499``), and decode stays stacked."""
    je, pe, want, got = _run(h384_gguf, 1, weight_quant="tl2",
                             fuse_projections=True, kernel_path="w2a8")
    assert got == want
    assert pe.stacked_decode()
    assert "ternary_matmul_tl_w2a8_stacked" not in pe.kernel_recorder
    assert spy["k11"] == spy["k12"] == 0
    steps = len(got[0]) - 1
    assert spy["k10"] == 4 * 2 * (steps + 1)


def test_bf16_tl_logits_cosine(mini_gguf_qk256):
    """bf16 activations, fused, B = 1: per-step logits cosine ≥ 0.99."""
    kw = dict(max_seq_len=64, weight_quant="tl2", fuse_projections=True,
              kernel_path="w2a8")
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(**kw))
    pe = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**kw),
                                   device="cpu")
    jl, tl = je.prefill(PROMPT), pe.prefill(PROMPT)
    decode = je._get_decode()
    pos, cos = len(PROMPT), []
    for _ in range(5):
        a = np.asarray(jl[0], np.float32)
        b = tl[0].float().numpy()
        cos.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
        tok = int(np.argmax(a))
        jl, je.cache = decode(je.params, jnp.asarray([[tok]], jnp.int32),
                              je.cache, jnp.asarray([[pos]], jnp.int32))
        tl = pe.decode_step(tok, pos)
        pos += 1
    assert min(cos) >= 0.99, cos


# --------------------------------------------------------------------------
# loaders, fixtures, synthetic model
# --------------------------------------------------------------------------
def test_bitnet32_loader_matches_jax(b32_gguf):
    from bitnet_tpu.models.loader import load_model as jload
    from bitnet_tpu_torch.models.loader import load_model

    _c, jp, _m = jload(b32_gguf, param_dtype=jnp.float32)
    _c, p, _m = load_model(b32_gguf, param_dtype=torch.float32, device="cpu")
    for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        t, j = getattr(p.blocks, n), getattr(jp.blocks, n)
        assert (t.kind, t.k, t.n) == (j.kind, j.k, j.n) == ("bitnet32", t.k, t.n)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))


def _one_tensor_gguf(path, name, shape, payload, sibling=None):
    from bitnet_tpu_torch.gguf.constants import GGMLType
    from bitnet_tpu_torch.gguf.writer import GGUFWriter

    w = GGUFWriter()
    w.add_metadata("general.architecture", "bitnet-25")
    w.add_quantized_tensor(name, shape, GGMLType.I2_S, payload)
    if sibling is not None:
        w.add_tensor(name.replace(".weight", ".weight_scale"), sibling,
                     GGMLType.F32)
    w.write(path)


@pytest.mark.parametrize("layout", ["split32", "split32_transposed_uniform",
                                    "bitnet32_transposed", "split32_no_sibling"])
def test_split32_and_transposed_loads_match_jax(tmp_path, layout):
    """Split32 (K = 96 so QK256 does not claim the bytes) with a sibling
    scale tensor, or none (scales 1.0); a transposed tensor with one
    uniform scale carries over; a transposed tensor with per-block scales
    is densified by both packages."""
    from bitnet_tpu.gguf.reader import GGUFReader as JReader
    from bitnet_tpu.models.loader import LoadReport
    from bitnet_tpu.models.loader import _load_linear as jload_linear
    from bitnet_tpu_torch.gguf.reader import GGUFReader
    from bitnet_tpu_torch.models.loader import _load_linear
    from bitnet_tpu_torch.quant.i2s import quantize_bitnet32, quantize_split32

    rng = np.random.default_rng(9)
    out_dim, in_dim = 128, 96
    transposed = "transposed" in layout
    shape = (in_dim, out_dim) if transposed else (out_dim, in_dim)
    w = rng.standard_normal(shape).astype(np.float32)
    sibling = None
    if layout.startswith("split32"):
        payload, s = quantize_split32(w)
        if layout == "split32":
            sibling = s
        elif layout == "split32_transposed_uniform":
            sibling = np.float32([0.125])
    else:
        payload = quantize_bitnet32(w)
    name = "blk.0.attn_q.weight"
    path = str(tmp_path / "one.gguf")
    _one_tensor_gguf(path, name, shape, payload, sibling)
    with JReader(path) as jr:
        j = jload_linear(jr, name, out_dim, in_dim, "auto",
                         LoadReport(path, {}, {}, []), "wq")
        with GGUFReader(path) as r:
            t = _load_linear(r, name, out_dim, in_dim)
    if layout == "bitnet32_transposed":
        # densified by both packages (the port used to refuse it, naming #7):
        # the same bf16 weight, bit for bit
        assert (t.kind, t.k, t.n) == (j.kind, j.k, j.n) == ("dense", in_dim, out_dim)
        np.testing.assert_array_equal(
            t.weight.float().numpy(), np.asarray(j.weight.astype(jnp.float32)))
        return
    assert (t.kind, t.k, t.n) == (j.kind, j.k, j.n) == ("bitnet32", in_dim, out_dim)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    js = np.asarray(j.scales)
    np.testing.assert_array_equal(t.scales.numpy()[: js.shape[0]], js)
    assert not t.scales.numpy()[js.shape[0]:].any()


def test_port_fixture_writes_the_jax_bitnet32_gguf(tmp_path):
    from bitnet_tpu_torch.gguf.fixtures import MiniModelSpec, generate_mini_gguf

    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    mp = generate_mini_gguf(a, MiniModelSpec(quant="bitnet32", **MINI))
    mj = jgenerate(b, JSpec(quant="bitnet32", **MINI))
    assert open(a, "rb").read() == open(b, "rb").read()
    for k, v in mj.weights.items():
        np.testing.assert_array_equal(mp.weights[k], v)


@pytest.mark.parametrize("fuse,B", [(True, 1), (True, 3), (False, 1)])
def test_synthetic_bitnet32_model_runs(fuse, B):
    """``build_synthetic(kind="bitnet32")``: f16 block scales in the
    loader's [1e-3, 1e3], zero in the padded rows and columns; the engine
    takes the fused loop (K11 / K12) or the generic path (K10)."""
    from bitnet_tpu_torch.config import ModelConfig
    from bitnet_tpu_torch.models.synthetic import build_synthetic

    cfg = ModelConfig(vocab_size=64, hidden_size=256, intermediate_size=384,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=32, use_sub_norm=True)
    p = build_synthetic(cfg, seed=1, device="cpu", kind="bitnet32")
    lin = p.blocks.w_down                              # K = 384 → Kp = 512
    s = lin.scales
    live = s[:, : lin.k // 32, : lin.n]
    assert live.min() >= 1e-3 and live.max() <= 1e3
    assert torch.equal(live, live.half().float())
    assert not s[:, lin.k // 32:].any() and not s[..., lin.n:].any()
    eng = InferenceEngine(cfg, p, EngineConfig(
        max_seq_len=32, kernel_path="w2a8", fuse_projections=fuse,
        max_batch_size=B), device="cpu")
    assert eng.stacked_decode() == fuse
    gc = GenerationConfig(max_new_tokens=4, greedy=True, min_new_tokens=4)
    if B == 1:
        toks = [eng.generate([1, 2, 3], gc).token_ids]
    else:
        toks = [r.token_ids for r in eng.generate_batch([[1, 2], [3], [4, 5, 6]], gc)]
    assert all(len(t) == 4 and all(0 <= x < 64 for x in t) for t in toks)


@pytest.mark.parametrize("wq", ["tl1", "tl2", "none"])
def test_weight_quant_is_ported(wq):
    """``weight_quant`` no longer raises (#10 is done); other values do."""
    from bitnet_tpu_torch.errors import ConfigError

    assert EngineConfig(weight_quant=wq).weight_quant == wq
    with pytest.raises((ConfigError, ValueError)):
        EngineConfig(weight_quant="tl3")


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
ARGS = ["--prompt", "Hello world", "--prompt-template", "raw", "-n", "12",
        "--greedy"]


def _cli(main, argv, capsys):
    assert main(["run", *argv]) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.mark.parametrize("src,extra", [("qk256", ["--weight-quant", "tl2"]),
                                       ("qk256", ["--weight-quant", "tl1",
                                                  "--kernel-path", "w2a8"]),
                                       ("b32", []), ("b32", ["--kernel-path", "pallas"])])
def test_cli_prints_the_reference_text(mini_gguf_qk256, b32_gguf, capsys, src, extra):
    path = mini_gguf_qk256.path if src == "qk256" else b32_gguf
    jextra = [a for a in extra if a not in ("--kernel-path", "w2a8", "pallas")]
    # the JAX CLI on the CPU runs xla (the port's CPU default)
    want, _ = _cli(jcli.main, ["--model", path, *ARGS, *jextra, "--kernel-path",
                               "xla"], capsys)
    got, err = _cli(cli.main, ["--model", path, *ARGS, "--device", "cpu", *extra],
                    capsys)
    assert got == want and len(got.strip()) > 0
    assert "[12 tokens" in err


def test_recorder_names_tl_w2a8_from_wqkv_alone(tmp_path, spy):
    """The reference records ``ternary_matmul_tl_w2a8_stacked`` when the
    fused q|k|v K is a multiple of 256, while its stacked loop takes the
    fused TL kernels only when every K is: with F = 384 both engines
    record the kernel and neither runs it (K10 runs).  The port mirrors
    the reference's receipt (ROADMAP.md §3)."""
    path = str(tmp_path / "f384.gguf")
    jgenerate(path, JSpec(quant="bitnet32", hidden_size=256, intermediate_size=384,
                          num_heads=4, num_kv_heads=2))
    je, pe, want, got = _run(path, 1, fuse_projections=True, kernel_path="w2a8")
    assert got == want
    assert "ternary_matmul_tl_w2a8_stacked" in je.kernel_recorder
    assert "ternary_matmul_tl_w2a8_stacked" in pe.kernel_recorder
    assert spy["k11"] == spy["k12"] == 0 and spy["k10"] > 0


@pytest.mark.parametrize("src", ["tl2", "bitnet32"])
def test_converted_block_params_match_jax(mini_gguf_qk256, b32_gguf, src):
    """``models/convert.py`` carries the JAX package's fused tl / bitnet32
    stacks across (scales zero-padded to Kp/32 rows): the same greedy
    tokens at f32 without re-quantizing again."""
    import dataclasses

    from bitnet_tpu_torch.config import ModelConfig
    from bitnet_tpu_torch.models.convert import params_from_arrays

    def tree(obj):
        if obj is None or isinstance(obj, (str, int, float, bool)):
            return obj
        if dataclasses.is_dataclass(obj):
            return {f.name: tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        return np.asarray(obj)

    path, wq = (mini_gguf_qk256.path, "tl2") if src == "tl2" else (b32_gguf, "none")
    kw = dict(max_seq_len=64, compute_dtype="f32", kernel_path="w2a8",
              fuse_projections=True)
    je = JEngine.from_gguf(path, JEngineConfig(weight_quant=wq, **kw))
    want = je.generate(PROMPT, JGenerationConfig(max_new_tokens=8, greedy=True))
    params = params_from_arrays(tree(je.params), device="cpu")
    assert params.blocks.wqkv.kind == ("tl" if src == "tl2" else "bitnet32")
    assert params.blocks.wqkv.scales.shape[-2] * 32 == params.blocks.wqkv.packed.shape[-2] * 16
    cfg = ModelConfig(**{f.name: getattr(je.cfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    pe = InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu")
    got = pe.generate(PROMPT, GenerationConfig(max_new_tokens=8, greedy=True))
    assert got.token_ids == want.token_ids
