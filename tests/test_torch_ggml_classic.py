"""The port's GGML-classic and IQ2_S codecs and activation int8 quantizer
(``bitnet_tpu_torch/quant/{ggml_classic,qk256,int8}.py``) against the JAX
package's, and the Q8_0 mini GGUF end to end.

Every dequantizer is held bit for bit to the JAX one on seeded payloads
(random bytes with finite f16 scales, so each block type's every bit
pattern is reached), each quantizer to the same bytes, and the Q8_0 mini
GGUF's greedy tokens to the JAX engine's at f32 (logits within 1e-5 of
their largest magnitude).
"""

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.gguf.fixtures import MiniModelSpec as JSpec
from bitnet_tpu.gguf.fixtures import generate_mini_gguf as jgenerate
from bitnet_tpu.quant import ggml_classic as jgc
from bitnet_tpu.quant import int8 as jint8
from bitnet_tpu.quant import qk256 as jqk
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import QuantizationError
from bitnet_tpu_torch.quant import ggml_classic as gc
from bitnet_tpu_torch.quant import int8
from bitnet_tpu_torch.quant import qk256

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

# (name, block elems, block bytes, offsets of the f16 fields)
TYPES = [("q8_0", 32, 34, (0,)), ("q4_0", 32, 18, (0,)), ("q4_1", 32, 20, (0, 2)),
         ("q5_0", 32, 22, (0,)), ("q5_1", 32, 24, (0, 2)),
         ("q4_k", 256, 144, (0, 2)), ("q6_k", 256, 210, (208,))]


def _payload(rng, nb, bpb, f16_at):
    """Random blocks whose f16 fields hold finite, moderate values."""
    raw = rng.integers(0, 256, (nb, bpb), dtype=np.uint8)
    for off in f16_at:
        vals = rng.uniform(-2.0, 2.0, nb).astype(np.float16)
        raw[:, off:off + 2] = vals.view(np.uint8).reshape(nb, 2)
    return raw.reshape(-1)


@pytest.mark.parametrize("name,block,bpb,f16_at", TYPES, ids=[t[0] for t in TYPES])
@pytest.mark.parametrize("nb", [1, 7])
def test_dequantizers_are_the_jax_ones_bit_for_bit(name, block, bpb, f16_at, nb):
    rng = np.random.default_rng(nb * 100 + bpb)
    raw = _payload(rng, nb, bpb, f16_at)
    got = getattr(gc, f"dequantize_{name}")(raw, nb * block)
    want = getattr(jgc, f"dequantize_{name}")(raw, nb * block)
    assert got.dtype == want.dtype == np.float32 and got.shape == (nb * block,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # bytes in, the same answer
    np.testing.assert_array_equal(
        getattr(gc, f"dequantize_{name}")(raw.tobytes(), nb * block), want)


@pytest.mark.parametrize("name", ["q8_0", "q4_0"])
@pytest.mark.parametrize("scale", [0.0, 1e-3, 3.0])
def test_quantizers_give_the_jax_bytes(name, scale):
    x = (np.random.default_rng(5).standard_normal(4 * 32) * scale).astype(np.float32)
    got = getattr(gc, f"quantize_{name}")(x)
    assert got == getattr(jgc, f"quantize_{name}")(x)
    back = getattr(gc, f"dequantize_{name}")(got, x.size)
    np.testing.assert_array_equal(back, getattr(jgc, f"dequantize_{name}")(got, x.size))


def test_classic_codecs_refuse_what_jax_refuses():
    for mod, err in ((gc, QuantizationError), (jgc, Exception)):
        with pytest.raises(err):
            mod.dequantize_q8_0(np.zeros(34, np.uint8), 33)
        with pytest.raises(err):
            mod.dequantize_q4_k(np.zeros(100, np.uint8), 256)
        with pytest.raises(err):
            mod.quantize_q4_0(np.zeros(31, np.float32))


@pytest.mark.parametrize("shape", [(256,), (3, 512)])
def test_iq2s_is_the_jax_codec(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    payload = qk256.quantize_iq2s(x)
    assert payload == jqk.quantize_iq2s(x)
    n = int(np.prod(shape))
    got = qk256.dequantize_iq2s(payload, n)
    np.testing.assert_array_equal(got, jqk.dequantize_iq2s(payload, n))
    raw = np.random.default_rng(9).integers(0, 256, n // 256 * 82, dtype=np.uint8)
    raw.reshape(-1, 82)[:, 0:2] = np.float16(0.5).reshape(1).view(np.uint8)
    np.testing.assert_array_equal(qk256.dequantize_iq2s(raw, n),
                                  jqk.dequantize_iq2s(raw, n))
    with pytest.raises(QuantizationError):
        qk256.dequantize_iq2s(payload, n + 1)


def test_activation_int8_is_the_jax_quantizer():
    x = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    x[1] = 0.0
    q, s = int8.quantize_activations_int8(x)
    jq, js = jint8.quantize_activations_int8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(int8.dequantize_activations_int8(q, s),
                                  jint8.dequantize_activations_int8(jq, js))


KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")


def test_q8_0_mini_gguf_runs_as_jax(tmp_path):
    """The port's fixture writes the JAX package's Q8_0 mini GGUF byte for
    byte; loaded as dense linears, its greedy tokens are the JAX engine's
    and its prefill logits agree within 1e-5 of their largest magnitude."""
    from bitnet_tpu_torch.gguf.fixtures import MiniModelSpec, generate_mini_gguf

    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    mp = generate_mini_gguf(a, MiniModelSpec(quant="q8_0"))
    mj = jgenerate(b, JSpec(quant="q8_0"))
    assert open(a, "rb").read() == open(b, "rb").read()
    for k, v in mj.weights.items():
        np.testing.assert_array_equal(mp.weights[k], v)
    pe = InferenceEngine.from_gguf(a, EngineConfig(**KW), device="cpu")
    je = JEngine.from_gguf(a, JEngineConfig(**KW))
    assert set(pe.load_report.kinds.values()) == {"dense"}
    prompt = [2, 7, 11, 5, 3]
    lg = pe.prefill(prompt).numpy()[0]
    jlg = np.asarray(je.prefill(prompt))[0]
    np.testing.assert_allclose(lg, jlg, rtol=0, atol=1e-5 * np.abs(jlg).max())
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=12, greedy=True))
    want = je.generate(prompt, JGen(max_new_tokens=12, greedy=True))
    assert got.token_ids == want.token_ids and len(got.token_ids) == 12
