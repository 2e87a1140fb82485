"""Dense linears in the port (``ops/linear.py``'s ``dense`` kind, the
loader's densifying routes and ``mode="dense"``) against the JAX package.

- The F32 mini GGUF (every linear F32, the JAX tests' fixture): prefill
  and decode logits within 1e-5 of their largest magnitude and equal
  greedy tokens, on every plan the JAX package lets a dense model take
  (paths ``xla`` / ``pallas`` / ``w2a8``, fused or not, the tied f32 or int8
  head, B = 1 and pools of 2 and 3);
- ``mode="dense"`` of the QK256 mini: the weights are the JAX
  ``mode="dense"`` weights bit for bit (the port unpacks QK256 in torch),
  and the logits agree within 1e-5;
- a BitNet32 mini stored transposed (per-block scales along N): both
  packages densify it and decode the same tokens;
- BF16, F64 and IQ2_S tensors load as the JAX loader loads them, bit for
  bit;
- ``models/convert.py`` carries the JAX package's dense params across.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.gguf.fixtures import MiniModelSpec as JSpec
from bitnet_tpu.gguf.fixtures import generate_mini_gguf as jgenerate
from bitnet_tpu.models.loader import load_model as jload_model
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig, ModelConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models.convert import params_from_arrays
from bitnet_tpu_torch.models.loader import LoadReport, load_model, qk256_dense_kn

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

F32 = dict(compute_dtype="f32", kv_cache_dtype="f32")
PROMPT = [2, 7, 11, 5, 3, 9]


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _np_tree(obj):
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: _np_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def _teacher_forced(pe, je, prompt, steps):
    """Prefill, then ``steps`` decode steps fed the JAX engine's argmax:
    logits of both at each step."""
    out = [(pe.prefill(prompt).numpy()[0], np.asarray(je.prefill(prompt))[0])]
    decode = je._get_decode()
    pos = len(prompt)
    B = je.engine_cfg.max_batch_size
    for _ in range(steps):
        tok = int(np.argmax(out[-1][1]))
        tk = np.zeros((B, 1), np.int32)
        tk[0, 0] = tok
        jpos = np.full((B, 1), je.engine_cfg.max_seq_len, np.int32)
        jpos[0, 0] = pos
        jl, je.cache = decode(je.params, jnp.asarray(tk), je.cache, jnp.asarray(jpos))
        out.append((pe.decode_step(tok, pos).numpy()[0], np.asarray(jl)[0]))
        pos += 1
    return out


PLANS = [("xla", False, "auto"), ("pallas", False, "auto"), ("w2a8", False, "auto"),
         ("w2a8", True, "auto"), ("w2a8", False, "int8"), ("pallas", True, "auto")]


@pytest.mark.parametrize("kp,fuse,head", PLANS,
                         ids=[f"{k}-{'fused' if f else 'unfused'}-{h}" for k, f, h in PLANS])
def test_f32_mini_is_jax_on_every_plan(mini_gguf_f32, kp, fuse, head):
    """B = 1 on the F32 mini: the w2a8 / pallas decode takes the fast
    decode (the JAX Pallas ``decode_attention`` in interpret mode, the
    port's K5 plain version); logits within 1e-5 at the prefill and four
    teacher-forced steps, then 10 greedy tokens equal."""
    kw = dict(max_seq_len=64, kernel_path=kp, fuse_projections=fuse,
              logits_dtype=head, **F32)
    pe = InferenceEngine.from_gguf(mini_gguf_f32.path, EngineConfig(**kw), device="cpu")
    je = JEngine.from_gguf(mini_gguf_f32.path, JEngineConfig(**kw))
    assert set(pe.load_report.kinds.values()) == {"dense"}
    assert (pe.params.blocks.wqkv is not None) == fuse
    assert not pe.stacked_decode()
    for got, want in _teacher_forced(pe, je, PROMPT, 4):
        _close(got, want)
    gc = dict(max_new_tokens=10, greedy=True)
    assert (pe.generate(PROMPT, GenerationConfig(**gc)).token_ids
            == je.generate(PROMPT, JGen(**gc)).token_ids)


@pytest.mark.parametrize("B", [2, 3])
def test_f32_mini_pools_are_jax(mini_gguf_f32, B):
    kw = dict(max_seq_len=64, kernel_path="w2a8", max_batch_size=B, **F32)
    pe = InferenceEngine.from_gguf(mini_gguf_f32.path, EngineConfig(**kw), device="cpu")
    je = JEngine.from_gguf(mini_gguf_f32.path, JEngineConfig(**kw))
    prompts = [PROMPT, [4, 8, 15], [16, 23, 42, 1]][:B]
    gc = dict(max_new_tokens=8, greedy=True)
    got = [r.token_ids for r in pe.generate_batch(prompts, GenerationConfig(**gc))]
    want = [r.token_ids for r in je.generate_batch(prompts, JGen(**gc))]
    assert got == want


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_mode_of_the_qk256_mini_is_jax_dense_mode(mini_gguf_qk256, dtype):
    td, jd = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                          jnp.bfloat16)}[dtype]
    cfg, p, rep = load_model(mini_gguf_qk256.path, mode="dense", param_dtype=td,
                             device="cpu")
    _jc, jp, jrep = jload_model(mini_gguf_qk256.path, mode="dense", param_dtype=jd)
    assert rep.kinds == jrep.kinds and set(rep.kinds.values()) == {"dense"}
    assert rep.dequantized == jrep.dequantized and rep.flavors == jrep.flavors == {}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        a, b = getattr(p.blocks, name), getattr(jp.blocks, name)
        assert (a.kind, a.k, a.n) == (b.kind, b.k, b.n)
        assert a.weight.dtype == td
        np.testing.assert_array_equal(a.weight.float().numpy(),
                                      np.asarray(b.weight.astype(jnp.float32)))
    np.testing.assert_array_equal(p.embed.float().numpy(),
                                  np.asarray(jp.embed.astype(jnp.float32)))
    if dtype == "f32":
        kw = dict(max_seq_len=64, kernel_path="xla", **F32)
        pe = InferenceEngine(cfg, p, EngineConfig(**kw), device="cpu")
        je = JEngine(_jc, jp, JEngineConfig(**kw))
        _close(pe.prefill(PROMPT).numpy(), np.asarray(je.prefill(PROMPT)))
        # the packed load computes the same function (JAX's own check)
        pa = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**kw),
                                       device="cpu")
        a, b = pa.prefill(PROMPT).numpy()[0], pe.prefill(PROMPT).numpy()[0]
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qk256_unpacked_in_torch_equals_the_numpy_route(transposed, dtype):
    from bitnet_tpu.quant.qk256 import dequantize_qk256, quantize_qk256

    rows, cols = (96, 300) if not transposed else (300, 96)
    w = np.random.default_rng(1).standard_normal((rows, cols)).astype(np.float32)
    payload = np.frombuffer(quantize_qk256(w), np.uint8)
    want = dequantize_qk256(payload, rows, cols)
    want = want if transposed else want.T
    got = qk256_dense_kn(payload, rows, cols, transposed, dtype, "cpu")
    assert got.dtype == dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_transposed_bitnet32_mini_is_densified_as_jax(tmp_path):
    """Non-square linears stored [in, out] with per-block scales: the
    scale blocks run along N, so both packages densify them; the rest stays
    packed (square ones are not flipped), and greedy tokens agree."""
    path = str(tmp_path / "b32t.gguf")
    jgenerate(path, JSpec(quant="bitnet32", transposed=True, hidden_size=256,
                          intermediate_size=512, num_heads=4, num_kv_heads=2))
    kw = dict(max_seq_len=64, kernel_path="xla", **F32)
    pe = InferenceEngine.from_gguf(path, EngineConfig(**kw), device="cpu")
    je = JEngine.from_gguf(path, JEngineConfig(**kw))
    assert pe.load_report.kinds == je.load_report.kinds
    assert "dense" in pe.load_report.kinds.values()
    assert pe.load_report.dequantized == je.load_report.dequantized
    _close(pe.prefill(PROMPT).numpy(), np.asarray(je.prefill(PROMPT)))
    gc = dict(max_new_tokens=8, greedy=True)
    assert (pe.generate(PROMPT, GenerationConfig(**gc)).token_ids
            == je.generate(PROMPT, JGen(**gc)).token_ids)


def _one_tensor(path, name, shape, gtype, payload):
    from bitnet_tpu_torch.gguf.writer import GGUFWriter

    w = GGUFWriter()
    w.add_metadata("general.architecture", "bitnet-25")
    w.add_quantized_tensor(name, shape, gtype, payload)
    w.write(path)


@pytest.mark.parametrize("kind", ["bf16", "f64", "iq2s", "iq2s_transposed", "f16"])
def test_bf16_f64_and_iq2s_tensors_load_as_jax(tmp_path, kind):
    """A linear stored as BF16, F64, F16 or IQ2_S: ``_to_float`` and the
    dense linear are the JAX loader's, bit for bit (bf16 params)."""
    from bitnet_tpu.gguf.reader import GGUFReader as JReader
    from bitnet_tpu.models.loader import LoadReport as JReport
    from bitnet_tpu.models.loader import _load_linear as jload_linear
    from bitnet_tpu.models.loader import _to_float as jto_float
    from bitnet_tpu_torch.gguf.constants import GGMLType
    from bitnet_tpu_torch.gguf.reader import GGUFReader
    from bitnet_tpu_torch.models.loader import _load_linear, _to_float
    from bitnet_tpu_torch.quant.qk256 import quantize_iq2s

    out_dim, in_dim = 256, 512
    shape = (in_dim, out_dim) if kind.endswith("transposed") else (out_dim, in_dim)
    w = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    if kind == "bf16":
        gtype, payload = GGMLType.BF16, (w.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    elif kind == "f64":
        gtype, payload = GGMLType.F64, w.astype(np.float64).tobytes()
    elif kind == "f16":
        gtype, payload = GGMLType.F16, w.astype(np.float16).tobytes()
    else:
        gtype, payload = GGMLType.IQ2_S, quantize_iq2s(w)
    name = "blk.0.attn_q.weight"
    path = str(tmp_path / "one.gguf")
    _one_tensor(path, name, shape, gtype, payload)
    rep = LoadReport(path, {}, {}, [])
    with JReader(path) as jr, GGUFReader(path) as r:
        np.testing.assert_array_equal(_to_float(r, r.tensors[name]),
                                      jto_float(jr, jr.tensors[name]))
        t = _load_linear(r, name, out_dim, in_dim, "auto", rep, "wq")
        j = jload_linear(jr, name, out_dim, in_dim, "auto", JReport(path, {}, {}, []),
                         "wq")
    assert (t.kind, t.k, t.n) == (j.kind, j.k, j.n) == ("dense", in_dim, out_dim)
    assert rep.kinds == {"wq": "dense"} and rep.dequantized == [name]
    assert t.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.weight.float().numpy(),
                                  np.asarray(j.weight.astype(jnp.float32)))


def test_convert_carries_dense_params(mini_gguf_f32):
    """The JAX engine's dense params (fused, f32) carried across: the same
    weights and the same prefill logits within 1e-5."""
    kw = dict(max_seq_len=64, kernel_path="xla", fuse_projections=True, **F32)
    je = JEngine.from_gguf(mini_gguf_f32.path, JEngineConfig(**kw))
    params = params_from_arrays(_np_tree(je.params), device="cpu")
    b = params.blocks
    assert b.wqkv.kind == "dense" and b.wqkv.weight.dtype == torch.float32
    np.testing.assert_array_equal(b.wqkv.weight.numpy(), np.asarray(je.params.blocks.wqkv.weight))
    cfg = ModelConfig(**{f.name: getattr(je.cfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    pe = InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu")
    _close(pe.prefill(PROMPT).numpy(), np.asarray(je.prefill(PROMPT)))


def test_load_report_is_the_jax_report(mini_gguf_bitnet32):
    """``load_model`` returns the JAX ``LoadReport``'s fields (plus the
    GGUF's EOS id, which the port's callers read)."""
    from bitnet_tpu.models.loader import LoadReport as JReport

    names = [f.name for f in dataclasses.fields(LoadReport)]
    assert names[:len(dataclasses.fields(JReport))] == [
        f.name for f in dataclasses.fields(JReport)]
    _c, _p, rep = load_model(mini_gguf_bitnet32.path, device="cpu")
    _jc, _jp, jrep = jload_model(mini_gguf_bitnet32.path)
    assert (rep.flavors, rep.kinds, rep.dequantized) == (jrep.flavors, jrep.kinds,
                                                         jrep.dequantized)
    assert rep.eos_token_id == 2 and rep.path == mini_gguf_bitnet32.path
    with pytest.raises(Exception, match="mode"):
        load_model(mini_gguf_bitnet32.path, mode="packed", device="cpu")
