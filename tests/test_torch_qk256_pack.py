"""The QK256 pack on the load device (``ops/linear.qk256_linear_from_payload_torch``,
the port's counterpart of the JAX native codec) against the numpy route
(``qk256_linear_from_payload``) and the JAX loader's words, bit for bit.

On mini QK256 GGUFs stored ``[out, in]`` and ``[in, out]`` (transposed),
at widths where N is not a multiple of 128 and K not one of 256: every
QK256 tensor packed both ways, the words and their padding equal, and equal
to the words of the JAX ``load_model``; the port's ``load_model`` takes the
torch route for every QK256 linear (the numpy route is never called) and a
loaded mini's logits match the JAX engine's at f32 (within 2e-5 of the
largest logit: the same words, f32 sums in another order)."""

import inspect

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.gguf.fixtures import MiniModelSpec, generate_mini_gguf
from bitnet_tpu.models.loader import load_model as jload_model
from bitnet_tpu_torch.config import EngineConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.gguf.constants import GGMLType
from bitnet_tpu_torch.gguf.reader import GGUFReader
from bitnet_tpu_torch.models import loader
from bitnet_tpu_torch.ops import linear as tl

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

# name → spec: N = 32 for k / v at hidden 64 (heads of 16), K = 64 < 256
MINIS = {
    "qk256": dict(hidden_size=256, intermediate_size=512, num_heads=4,
                  num_kv_heads=2),
    "qk256_transposed": dict(hidden_size=256, intermediate_size=384, num_heads=4,
                             num_kv_heads=2, transposed=True),
    "qk256_narrow": dict(hidden_size=64, intermediate_size=192),
}
ROLES = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv", "attn_output": "wo",
         "ffn_gate": "w_gate", "ffn_up": "w_up", "ffn_down": "w_down"}


@pytest.fixture(scope="module")
def minis(tmp_path_factory):
    d = tmp_path_factory.mktemp("qk256_pack")
    paths = {}
    for name, kw in MINIS.items():
        paths[name] = str(d / f"{name}.gguf")
        generate_mini_gguf(paths[name], MiniModelSpec(quant="qk256", **kw))
    return paths


def _qk256_tensors(path):
    """(name, stored rows, stored cols, payload) of every QK256 tensor."""
    with GGUFReader(path) as r:
        return [(i.name, *i.logical_shape, np.array(r.tensor_bytes(i.name)))
                for i in r if i.ggml_type == GGMLType.I2_S]


@pytest.mark.parametrize("name", list(MINIS))
def test_every_tensor_packs_as_the_numpy_route_and_the_jax_loader(minis, name):
    path = minis[name]
    cfg, jparams, _rep = jload_model(path)
    H, F, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    dims = {"attn_q": (cfg.num_heads * D, H), "attn_k": (cfg.num_kv_heads * D, H),
            "attn_v": (cfg.num_kv_heads * D, H), "attn_output": (H, cfg.num_heads * D),
            "ffn_gate": (F, H), "ffn_up": (F, H), "ffn_down": (H, F)}
    tensors = _qk256_tensors(path)
    assert len(tensors) == 7 * 2
    widths = set()
    for tname, rows, cols, payload in tensors:
        # the loader's [out, in]; a tensor stored [in, out] is transposed
        out_dim, in_dim = dims[tname.split(".")[2]]
        flipped = (rows, cols) != (out_dim, in_dim)
        assert flipped == (MINIS[name].get("transposed", False) and rows != cols)
        want = tl.qk256_linear_from_payload(payload, out_dim, in_dim, flipped)
        got = tl.qk256_linear_from_payload_torch(payload, out_dim, in_dim, flipped,
                                                 device="cpu")
        assert got.packed.dtype == torch.int32 and got.packed.is_contiguous()
        assert torch.equal(got.packed, want.packed), tname
        assert (got.k, got.n, float(got.scales)) == (want.k, want.n, 1.0)
        layer, role = int(tname.split(".")[1]), ROLES[tname.split(".")[2]]
        jw = np.asarray(getattr(jparams.blocks, role).packed[layer])
        np.testing.assert_array_equal(got.packed.numpy(), jw)
        widths.add((in_dim, out_dim))
    if name == "qk256_narrow":
        assert any(n % 128 for _k, n in widths) and any(k % 256 for k, _n in widths)


@pytest.mark.parametrize("name", list(MINIS))
def test_the_loader_packs_every_qk256_linear_in_torch(minis, name, monkeypatch):
    calls = []
    real = loader.qk256_linear_from_payload_torch

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw)

    def numpy_route(*_a, **_kw):
        raise AssertionError("the load called the numpy route")

    monkeypatch.setattr(loader, "qk256_linear_from_payload_torch", spy)
    monkeypatch.setattr(tl, "qk256_linear_from_payload", numpy_route)
    cfg, params, report = loader.load_model(minis[name], device="cpu")
    assert len(calls) == 7 * cfg.num_layers and set(map(str, calls)) == {"cpu"}
    assert set(report.kinds.values()) == {"qk256"}
    jcfg, jparams, _ = jload_model(minis[name])
    for role in ROLES.values():
        np.testing.assert_array_equal(getattr(params.blocks, role).packed.numpy(),
                                      np.asarray(getattr(jparams.blocks, role).packed))


@pytest.mark.parametrize("name", ["qk256", "qk256_transposed"])
def test_a_loaded_mini_gives_the_jax_logits(minis, name):
    kw = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32",
              kernel_path="xla")
    pe = InferenceEngine.from_gguf(minis[name], EngineConfig(**kw), device="cpu")
    je = JEngine.from_gguf(minis[name], JEngineConfig(**kw))
    ids = [2, 7, 11, 13, 17, 19]
    got, want = pe.eval_ids(ids), np.asarray(je.eval_ids(ids))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_the_torch_pack_on_random_payloads_and_its_device(monkeypatch):
    """A random [200, 300] weight (N not a multiple of 128, K not one of
    256) in both orientations packs on the CPU as the numpy route packs it,
    bit for bit; the torch route defaults to the card and raises without
    one."""
    from bitnet_tpu_torch.errors import ConfigError
    from bitnet_tpu_torch.quant import qk256

    rng = np.random.default_rng(0)
    for transposed in (False, True):
        rows, cols = (300, 200) if transposed else (200, 300)
        w = rng.standard_normal((rows, cols)).astype(np.float32)
        payload = np.frombuffer(qk256.quantize_qk256(w), np.uint8)
        want = tl.qk256_linear_from_payload(payload, 200, 300, transposed)
        got = tl.qk256_linear_from_payload_torch(payload, 200, 300, transposed, "cpu")
        assert torch.equal(got.packed, want.packed)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        tl.qk256_linear_from_payload_torch(np.zeros(2 * 64, np.uint8), 2, 256)
    assert inspect.signature(tl.qk256_linear_from_payload_torch).parameters[
        "device"].default == "cuda"
