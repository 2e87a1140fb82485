"""Two places where the port's configuration and loading parted from the
JAX package, each with the test that shows the repair.

1. The port's configs dropped fields that the reference accepts
   (``EngineConfig.context_overflow``, ``prefix_cache_tokens``,
   ``prefill_chunk``, ``donate_cache``, ``StrictMode.allow_fallback``,
   ``GenerationConfig.mirostat_tau`` / ``mirostat_eta``), so a caller's
   config raised a TypeError and ``context_overflow="stop"`` could not be
   asked for.  The field names and defaults are now held to the JAX
   package's, and both overflow policies give the JAX engine's tokens and
   stop reason.
2. The port loaded GGUFs that the reference refuses: its ``load_model``
   checked neither the architecture envelope nor the memory estimate
   (``bitnet_tpu/models/loader.py:352-359``).
"""

import dataclasses
import warnings

import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.config import ModelConfig as JModelConfig
from bitnet_tpu.config import StrictMode as JStrictMode
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.errors import ModelError as JModelError
from bitnet_tpu.gguf.fixtures import MiniModelSpec, generate_mini_gguf
from bitnet_tpu.models import memory as jmemory
from bitnet_tpu.models.loader import load_model as jload_model
from bitnet_tpu_torch.config import (EngineConfig, GenerationConfig, ModelConfig,
                                     StrictMode)
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import ModelError
from bitnet_tpu_torch.models import memory
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.models.synthetic import BITNET_2B4T, LLAMA3_8B_158
from bitnet_tpu_torch.obs.warn_once import reset_warnings

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _fields(cls):
    """(name, default) of every field, in order; a nested config as the
    dict of its fields."""
    obj = cls()
    out = []
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        out.append((f.name, dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v))
    return out


@pytest.mark.parametrize("port,ref", [(EngineConfig, JEngineConfig),
                                      (GenerationConfig, JGenerationConfig),
                                      (StrictMode, JStrictMode)],
                         ids=["EngineConfig", "GenerationConfig", "StrictMode"])
def test_fault1_config_fields_and_defaults_are_the_references(port, ref):
    assert _fields(port) == _fields(ref)


def test_fault1_dropped_fields_are_accepted():
    ec = EngineConfig(prefill_chunk=256, donate_cache=False, context_overflow="stop")
    assert (ec.prefill_chunk, ec.donate_cache, ec.context_overflow) == (256, False, "stop")
    assert StrictMode(allow_fallback=False).allow_fallback is False
    gc = GenerationConfig(mirostat_tau=3.0, mirostat_eta=0.2)
    assert (gc.mirostat_tau, gc.mirostat_eta) == (3.0, 0.2)
    # Mirostat, a grammar and the prefix cache are ported (they used to
    # raise naming #16, #15 and #12)
    assert GenerationConfig(mirostat=1, mirostat_tau=3.0).mirostat == 1
    assert GenerationConfig(mirostat=2).mirostat == 2
    assert GenerationConfig(grammar='root ::= "a"').grammar == 'root ::= "a"'
    assert EngineConfig(prefix_cache_tokens=64).prefix_cache_tokens == 64
    with pytest.raises(Exception, match="mirostat"):
        GenerationConfig(mirostat=3)
    # K-step decode segments are ported (they raised naming #5)
    assert EngineConfig(decode_steps_per_dispatch=4).decode_steps_per_dispatch == 4
    with pytest.raises(Exception, match="decode_steps_per_dispatch"):
        EngineConfig(decode_steps_per_dispatch=-1)
    # the windowed ring cache is ported (it raised naming #7): the JAX
    # validations and 'auto' → bf16 under a window
    assert EngineConfig(sliding_window=64).sliding_window == 64
    assert EngineConfig(sliding_window=64, kv_cache_dtype="auto",
                        max_batch_size=8).resolve_kv_cache_dtype() == "bf16"
    for kw in ({"sliding_window": 8}, {"sliding_window": 4096},
               {"sliding_window": 64, "prefix_cache_tokens": 64},
               {"sliding_window": 64, "kv_cache_dtype": "int8"}):
        with pytest.raises(Exception, match="sliding_window|prefix_cache"):
            EngineConfig(**kw)
        with pytest.raises(Exception, match="sliding_window|prefix_cache"):
            JEngineConfig(**kw)
    with pytest.raises(Exception, match="context_overflow"):
        EngineConfig(context_overflow="wrap")


@pytest.mark.parametrize("policy", ["stop", "shift"])
def test_fault1_context_overflow_matches_jax(mini_gguf_qk256, policy):
    """A 20-token prompt in a 32-token context asked for 24 tokens: 'stop'
    ends at the context's end with CONTEXT_FULL, 'shift' keeps the last
    half and goes on; tokens and stop reason are the JAX engine's (f32,
    greedy, the xla path)."""
    kw = dict(kernel_path="xla", max_seq_len=32, compute_dtype="f32",
              context_overflow=policy)
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(**kw))
    pe = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**kw),
                                   device="cpu")
    prompt = [1] + [(7 * i) % 250 + 3 for i in range(19)]
    gc = dict(max_new_tokens=24, greedy=True)
    want = je.generate(prompt, JGenerationConfig(**gc))
    got = pe.generate(prompt, GenerationConfig(**gc))
    assert got.token_ids == want.token_ids
    assert got.stop_reason.value == want.stop_reason.value
    if policy == "stop":
        assert got.stop_reason.value == "context_full" and len(got.token_ids) == 12
    else:
        assert len(got.token_ids) == 24 and "context_shift_keep16" in pe.kernel_recorder


ENGINE_CFGS = [dict(), dict(max_seq_len=4096), dict(max_batch_size=8),
               dict(max_batch_size=64, max_seq_len=1024, kv_cache_dtype="int8"),
               dict(kv_cache_dtype="fp8", prefill_chunk=256),
               dict(kv_cache_dtype="auto", max_batch_size=2, max_seq_len=4096)]


@pytest.mark.parametrize("ek", ENGINE_CFGS, ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()) or "default")
@pytest.mark.parametrize("cfg", [BITNET_2B4T, LLAMA3_8B_158], ids=["2b4t", "8b"])
def test_fault2_memory_estimate_is_the_references(cfg, ek):
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    for packed in (True, False):
        got = memory.estimate_memory(cfg, EngineConfig(**ek), packed)
        want = jmemory.estimate_memory(jcfg, JEngineConfig(**ek), packed)
        assert got.as_dict() == want.as_dict()


def test_fault2_memory_check_warns_raises_and_skips_the_cpu():
    cfg, jcfg = LLAMA3_8B_158, JModelConfig(**dataclasses.asdict(LLAMA3_8B_158))
    small = 1 << 30
    with pytest.raises(ModelError, match="GiB"):
        memory.validate_memory(cfg, hbm_bytes=small, strict=True)
    with pytest.raises(JModelError, match="GiB"):
        jmemory.validate_memory(jcfg, hbm_bytes=small, strict=True)
    reset_warnings()
    with pytest.warns(RuntimeWarning, match="GiB"):
        memory.validate_memory(cfg, hbm_bytes=small)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        est = memory.validate_memory(cfg, device="cpu")    # no limit: no check
    assert est.total_bytes > small
    assert memory.device_memory_bytes("cpu") is None


@pytest.mark.parametrize("key,value", [("block_count", 201),
                                       ("embedding_length", 40000)])
def test_fault2_gguf_outside_the_envelope_is_refused(tmp_path, key, value):
    """The metadata claims 201 layers (envelope 200) or a hidden width of
    40000 (envelope 32768): both loaders refuse it before reading a tensor."""
    path = str(tmp_path / "outside.gguf")
    generate_mini_gguf(path, MiniModelSpec(
        hidden_size=256, intermediate_size=512, quant="qk256",
        extra_metadata={f"bitnet-25.{key}": value}))
    with pytest.raises(JModelError, match="exceeds envelope"):
        jload_model(path)
    with pytest.raises(ModelError, match="exceeds envelope"):
        load_model(path, device="cpu")


def test_fault2_config_type_is_the_ports():
    """The estimate reads the port's own configs (no JAX object needed)."""
    est = memory.estimate_memory(ModelConfig(), EngineConfig())
    assert est.total_bytes == est.param_bytes + est.kv_cache_bytes + est.activation_bytes
