"""The windowed ring cache in the port (``engine/windowed_cache.py``, the
engine's ``sliding_window``) against the JAX package: the cases of
``tests/test_windowed_engine.py``, each held to the JAX engine's tokens on
the F32 mini GGUF at f32 (and its greedy stream past 4x the window), and
the ring forward's logits within 1e-5 of the JAX one's, chunk by chunk
and step by step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.engine.windowed_cache import allocate_windowed_cache as jallocate
from bitnet_tpu.engine.windowed_cache import forward_windowed as jforward_windowed
from bitnet_tpu.models import forward as jforward
from bitnet_tpu.models import load_model as jload_model
from bitnet_tpu.models import logits as jlogits
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.engine.windowed_cache import (allocate_windowed_cache,
                                                    forward_windowed,
                                                    reset_windowed_cache)
from bitnet_tpu_torch.errors import ConfigError, InferenceError
from bitnet_tpu_torch.models.bitnet import logits as model_logits
from bitnet_tpu_torch.models.loader import load_model

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

F32 = dict(kv_cache_dtype="f32", compute_dtype="f32")


@pytest.fixture(scope="module")
def model(mini_gguf_f32):
    cfg, params, _ = load_model(mini_gguf_f32.path, param_dtype=torch.float32,
                                device="cpu")
    jcfg, jparams, _ = jload_model(mini_gguf_f32.path, param_dtype=jnp.float32)
    return cfg, params, jcfg, jparams


def _pair(model, **kw):
    cfg, params, jcfg, jparams = model
    return (InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu"),
            JEngine(jcfg, jparams, JEngineConfig(**kw)))


def _greedy(pair, prompt, n):
    pe, je = pair
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=n, greedy=True))
    want = je.generate(prompt, JGen(max_new_tokens=n, greedy=True))
    assert got.token_ids == want.token_ids and len(got.token_ids) == n
    return got.token_ids


# -- the config validations (test_windowed_engine.py::TestConfigValidation)
@pytest.mark.parametrize("kw", [
    {"sliding_window": 8},
    {"max_seq_len": 64, "sliding_window": 128},
    {"max_seq_len": 128, "sliding_window": 32, "prefix_cache_tokens": 64},
    {"max_seq_len": 128, "sliding_window": 32, "kv_cache_dtype": "int8"}],
    ids=["too_small", "exceeds_stream_bound", "prefix_cache", "quantized_kv"])
def test_config_validation_is_jax(kw):
    with pytest.raises(ConfigError):
        EngineConfig(**kw)
    with pytest.raises(Exception):
        JEngineConfig(**kw)


def test_auto_kv_resolves_bf16():
    kw = dict(max_seq_len=128, sliding_window=32, kv_cache_dtype="auto")
    assert (EngineConfig(**kw).resolve_kv_cache_dtype()
            == JEngineConfig(**kw).resolve_kv_cache_dtype() == "bf16")


# -- the engine (test_windowed_engine.py::TestWindowedEngine) ------------------
def test_parity_with_dense_within_window(model):
    """While prompt + generated fit the window, the ring engine gives the
    dense engine's tokens, which are the JAX ring engine's."""
    pe, je = pair = _pair(model, max_seq_len=64, sliding_window=32, **F32)
    dense, _ = _pair(model, max_seq_len=64, **F32)
    got = _greedy(pair, [2, 5, 3, 11, 7], 10)
    assert got == dense.generate([2, 5, 3, 11, 7], GenerationConfig(
        max_new_tokens=10, greedy=True)).token_ids
    assert pe.cache.k.shape[2] == 32 and pe.windowed


def test_matches_manual_window_mask_past_window(model):
    """Past the window the ring tracks a dense cache under the window mask
    (``forward(window=W)``): the port's engine, the port's masked loop and
    the JAX engine agree."""
    cfg, params = model[:2]
    W, prompt, n = 16, list(range(2, 8)), 20
    got = _greedy(_pair(model, max_seq_len=64, sliding_window=W, **F32), prompt, n)
    from bitnet_tpu_torch.models.bitnet import forward

    S = 64
    kc = torch.zeros((cfg.num_layers, 1, S, cfg.num_kv_heads * cfg.head_dim))
    vc = torch.zeros_like(kc)
    h, _, _ = forward(cfg, params, torch.tensor([prompt], dtype=torch.int32),
                      torch.arange(len(prompt), dtype=torch.int32)[None], kc, vc,
                      torch.zeros(1, dtype=torch.int32), len(prompt), window=W)
    lg = model_logits(cfg, params, h[:, -1:])[0, -1]
    want, p = [], len(prompt)
    for _ in range(n):
        t = int(torch.argmax(lg))
        want.append(t)
        h, _, _ = forward(cfg, params, torch.tensor([[t]], dtype=torch.int32),
                          torch.tensor([[p]], dtype=torch.int32), kc, vc,
                          torch.tensor([p], dtype=torch.int32), 1, window=W)
        lg = model_logits(cfg, params, h)[0, -1]
        p += 1
    assert got == want


def test_long_prompt_chunked_prefill(model):
    """A prompt over 2W streams through in chunks of at most W, as the JAX
    engine's, and the recorder names the chunks."""
    cfg = model[0]
    pe, je = pair = _pair(model, max_seq_len=128, sliding_window=16, **F32)
    prompt = [(i * 7 + 3) % cfg.vocab_size for i in range(40)]
    _greedy(pair, prompt, 4)
    assert "prefill_windowed_xla_W16_chunks3" in pe.kernel_recorder
    assert any(k.startswith("prefill_windowed") for k in je.kernel_recorder)


def test_constant_memory_past_4x_window(model):
    """4W tokens: the ring keeps its shape, every token arrives, and the
    tokens are the JAX engine's."""
    cfg = model[0]
    pe, je = pair = _pair(model, max_seq_len=128, sliding_window=16, **F32)
    shape = tuple(pe.cache.k.shape)
    _greedy(pair, [2, 3], 4 * 16)
    assert tuple(pe.cache.k.shape) == shape == (
        cfg.num_layers, 1, 16, cfg.num_kv_heads * cfg.head_dim)
    assert any("attn_windowed_W16_x64" in k for k in pe.kernel_recorder)
    assert int(pe.cache.lengths[0]) == 2 + 4 * 16 - 1


def test_reset_between_requests(model):
    pair = _pair(model, max_seq_len=64, sliding_window=32, **F32)
    a = _greedy(pair, [5, 9, 4], 12)
    _greedy(pair, [17, 2, 8, 1], 20)                  # pollute the ring
    assert _greedy(pair, [5, 9, 4], 12) == a


def test_checkpoint_capture_refused(model):
    from bitnet_tpu_torch.engine import checkpoint as ck

    pe, _ = pair = _pair(model, max_seq_len=64, sliding_window=32, **F32)
    _greedy(pair, [2, 3], 2)
    with pytest.raises(InferenceError, match="dense cache"):
        ck.capture(pe, [2, 3], [])


def test_resume_refused(model):
    pe, _ = _pair(model, max_seq_len=64, sliding_window=32, **F32)
    with pytest.raises(InferenceError, match="dense cache"):
        list(pe.generate_stream([2, 3], GenerationConfig(max_new_tokens=2,
                                                         greedy=True), resume=True))


def test_pool_and_bf16_ring_are_jax(model):
    """A pool of 3 over the ring past its window, and a bf16 ring (the
    'auto' cache under a window), decode the JAX engine's tokens."""
    pe, je = _pair(model, max_seq_len=64, sliding_window=16, max_batch_size=3, **F32)
    prompts = [[2, 7, 11], [5, 3], [9, 9, 4, 1]]
    gc = dict(max_new_tokens=20, greedy=True)
    assert ([r.token_ids for r in pe.generate_batch(prompts, GenerationConfig(**gc))]
            == [r.token_ids for r in je.generate_batch(prompts, JGen(**gc))])
    _greedy(_pair(model, max_seq_len=64, sliding_window=16, kv_cache_dtype="auto",
                  compute_dtype="f32"), [2, 7, 11, 5], 24)


def test_forward_windowed_is_jax_chunk_by_chunk(model):
    """The ring forward alone: positions, lengths and logits against the
    JAX ``forward_windowed`` over three chunks (one padded) and two
    steps; more than W tokens a call are refused by both."""
    cfg, params, jcfg, jparams = model
    W, S = 16, 64
    c = allocate_windowed_cache(cfg, 1, W, "f32", device="cpu")
    jc = jallocate(jcfg, 1, W, "f32")
    toks = [(i * 5 + 1) % cfg.vocab_size for i in range(40)]
    pos = 0
    for n, Tp in ((16, 16), (11, 16), (1, 1), (1, 1)):
        t = np.zeros((1, Tp), np.int32)
        t[0, :n] = toks[pos:pos + n]
        q = np.full((1, Tp), S, np.int32)
        q[0, :n] = np.arange(pos, pos + n)
        h, c = forward_windowed(cfg, params, torch.from_numpy(t), torch.from_numpy(q),
                                c, torch.tensor([n], dtype=torch.int32), "xla",
                                pad_marker=S)
        jh, jc = jforward_windowed(jcfg, jparams, jnp.asarray(t), jnp.asarray(q), jc,
                                   jnp.asarray([n], jnp.int32), "xla", pad_marker=S)
        np.testing.assert_array_equal(c.positions.numpy(), np.asarray(jc.positions))
        np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
        want = np.asarray(jlogits(jcfg, jparams, jh[:, n - 1:n]))
        got = model_logits(cfg, params, h[:, n - 1:n]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        pos += n
    big = torch.zeros((1, W + 1), dtype=torch.int32)
    with pytest.raises(InferenceError, match="window"):
        forward_windowed(cfg, params, big, big, c)
    reset_windowed_cache(c)
    assert int(c.positions.max()) == -1 and int(c.lengths[0]) == 0


def test_manual_window_forward_is_jax(model):
    """``forward(window=W)`` over a dense cache (no ring) is the JAX one's."""
    cfg, params, jcfg, jparams = model
    from bitnet_tpu_torch.models.bitnet import forward

    prompt = [(i * 3 + 2) % cfg.vocab_size for i in range(30)]
    S, W = 32, 16
    kc = torch.zeros((cfg.num_layers, 1, S, cfg.num_kv_heads * cfg.head_dim))
    h, _, _ = forward(cfg, params, torch.tensor([prompt], dtype=torch.int32),
                      torch.arange(30, dtype=torch.int32)[None], kc, kc.clone(),
                      torch.zeros(1, dtype=torch.int32), 30, window=W)
    jk = jnp.zeros((cfg.num_layers, 1, S, cfg.num_kv_heads, cfg.head_dim), jnp.float32)
    jh, *_ = jforward(jcfg, jparams, jnp.asarray([prompt], jnp.int32),
                      jnp.arange(30, dtype=jnp.int32)[None], jk, jk,
                      jnp.zeros(1, jnp.int32), 30, "xla", window=W)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jh)).max()))


def test_speculation_over_a_ring_is_refused(model):
    """The verify writes rows at absolute positions, which a ring does not
    hold: the decoder refuses a windowed engine (the JAX one writes past
    the ring's rows unchecked)."""
    from bitnet_tpu_torch.engine.speculative import SpeculativeDecoder

    pe, _ = _pair(model, max_seq_len=64, sliding_window=32, **F32)
    with pytest.raises(InferenceError, match="ring"):
        SpeculativeDecoder(pe)
