"""Five places where slice 1 of the port computed something other than the
JAX package it is held against, each with the test that shows the repair.

1. ``EngineConfig`` defaults are the reference's (``fuse_projections=False``).
2. The engine fuses the projections only when asked.
3. ``GenerationConfig`` defaults are the reference's (sampling at
   temperature 1.0, not greedy).
4. ``kernel_path='auto'`` is ``w2a8`` on the card and ``xla`` elsewhere.
5. The bf16 tied head never widens the whole [V, H] table to f32.
"""

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig, ModelConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.models.bitnet import logits
from bitnet_tpu_torch.models.synthetic import build_synthetic

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

CFG = ModelConfig(vocab_size=2304, hidden_size=256, intermediate_size=256,
                  num_layers=1, num_heads=4, num_kv_heads=2, head_dim=64,
                  max_seq_len=32)


def _common(port, ref):
    """The fields both configs have, as plain values; a nested dataclass
    (the two packages' StrictMode classes differ) as the dict of the
    fields both of its classes have."""
    names = {f.name for f in dataclasses.fields(port)} & {
        f.name for f in dataclasses.fields(ref)}
    pv, rv = {}, {}
    for n in names:
        a, b = getattr(port, n), getattr(ref, n)
        if dataclasses.is_dataclass(a):
            _, a, b = _common(a, b)
        pv[n], rv[n] = a, b
    return names, pv, rv


def test_fault1_engine_config_defaults_are_the_references():
    names, port, ref = _common(EngineConfig(), JEngineConfig())
    assert {"fuse_projections", "kernel_path", "logits_dtype"} <= names
    assert port == ref
    assert EngineConfig().fuse_projections is False


def test_fault2_engine_fuses_only_when_asked():
    params = build_synthetic(CFG, seed=0, device="cpu")
    plain = InferenceEngine(CFG, params, EngineConfig(max_seq_len=32), device="cpu")
    assert plain.params.blocks.wqkv is None and plain.params.blocks.wq is not None
    fused = InferenceEngine(CFG, params, EngineConfig(max_seq_len=32,
                                                      fuse_projections=True),
                            device="cpu")
    assert fused.params.blocks.wqkv is not None and fused.params.blocks.wq is None


def test_fault3_generation_config_defaults_are_the_references():
    names, port, ref = _common(GenerationConfig(), JGenerationConfig())
    assert {"greedy", "temperature", "top_k", "seed", "add_bos"} <= names
    assert port == ref
    assert not GenerationConfig().is_greedy


def test_fault4_auto_kernel_path_follows_the_device():
    from bitnet_tpu_torch.config import resolve_kernel_path

    assert resolve_kernel_path("auto", torch.device("cuda", 0)) == "w2a8"
    assert resolve_kernel_path("auto", torch.device("cpu")) == "xla"
    assert resolve_kernel_path("pallas", torch.device("cpu")) == "pallas"
    params = build_synthetic(CFG, seed=0, device="cpu")
    eng = InferenceEngine(CFG, params, EngineConfig(max_seq_len=32), device="cpu")
    assert eng.kernel_path == "xla"


class _Recorder(TorchDispatchMode):
    """Every tensor an operator returns: (dtype, shape)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.seen.append((t.dtype, tuple(t.shape)))
        return out


def test_fault5_bf16_head_never_widens_the_table():
    params = build_synthetic(CFG, seed=1, device="cpu")
    V, H = CFG.vocab_size, CFG.hidden_size
    assert params.embed.dtype == torch.bfloat16
    hidden = torch.randn((1, 2, H)).to(torch.bfloat16)
    with _Recorder() as rec:
        out = logits(CFG, params, hidden)
    assert out.dtype == torch.float32 and out.shape == (1, 2, V)
    big = [s for d, s in rec.seen if d == torch.float32 and s in ((V, H), (H, V))]
    assert not big, big
    # bf16 x bf16 products are exact in f32; only the f32 sums' order differs
    want = (hidden.double().reshape(2, H) @ params.embed.double().t()).numpy()
    np.testing.assert_allclose(out.reshape(2, V).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
