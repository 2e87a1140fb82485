"""The generic per-layer path of the port (unfused projections, what the
CLI runs) against the JAX package's InferenceEngine on the mini QK256
fixture, on kernel paths w2a8, pallas and xla.

At f32 activations both packages compute the same numbers up to the order
of f32 sums, and greedy decoding must pick the same tokens.  At bf16 the
two round activations at the same places but their f32 sums differ in
order, and a bf16 (or int8) rounding boundary crossed once spreads: the
logits are held to cosine >= 0.99 (the reference's crossval gate).  The
generic path's cache writes drop positions >= S (JAX ``mode="drop"``);
they do not clamp to S-1 as the fused path's decode scatter does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

PATHS = ("w2a8", "pallas", "xla")


@pytest.mark.parametrize("kp", PATHS)
def test_greedy_tokens_match_jax_f32(mini_gguf_qk256, kp):
    prompt = [1, 5, 9, 14, 200, 77, 3]
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(
        kernel_path=kp, max_seq_len=64, compute_dtype="f32"))
    want = je.generate(prompt, JGenerationConfig(max_new_tokens=8, greedy=True))
    pe = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(kernel_path=kp, max_seq_len=64,
                                           compute_dtype="f32"), device="cpu")
    assert pe.params.blocks.wqkv is None            # unfused: the generic path
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=8, greedy=True))
    assert got.token_ids == want.token_ids
    assert got.text == want.text
    assert got.stop_reason.value == want.stop_reason.value
    assert f"decode_{kp}_x{len(want.token_ids)}" in pe.kernel_recorder


@pytest.mark.parametrize("kp", PATHS)
def test_bf16_logits_cosine(mini_gguf_qk256, kp):
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(
        kernel_path=kp, max_seq_len=64))
    pe = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(kernel_path=kp, max_seq_len=64),
        device="cpu")
    prompt = [1, 7, 3, 250, 9, 44, 12]
    jl, tl = je.prefill(prompt), pe.prefill(prompt)
    decode = je._get_decode()
    pos, cos = len(prompt), []
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


@pytest.mark.parametrize("kp", PATHS)
def test_generic_cache_write_drops_positions_past_s(mini_gguf_qk256, kp):
    S = 16
    pe = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(kernel_path=kp, max_seq_len=S,
                                           compute_dtype="f32"), device="cpu")
    pe.prefill(list(range(3, 3 + S)))               # rows 0..S-1 all written
    k0, v0 = pe.cache.k.clone(), pe.cache.v.clone()
    lg = pe.decode_step(7, S)                       # position S: dropped
    assert torch.isfinite(lg).all()
    assert torch.equal(pe.cache.k, k0) and torch.equal(pe.cache.v, v0)
    pe.decode_step(7, S - 1)                        # position S-1: written
    assert not torch.equal(pe.cache.k[:, 0, S - 1], k0[:, 0, S - 1])
    assert torch.equal(pe.cache.k[:, 0, : S - 1], k0[:, 0, : S - 1])


def test_context_shift_matches_jax(mini_gguf_qk256):
    """Past max_seq_len both engines keep the last half of the context,
    prefill it again and go on: the same greedy tokens at f32."""
    prompt = [1, 9, 33, 250, 7, 80, 12, 5, 61, 2]
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(
        kernel_path="w2a8", max_seq_len=16, compute_dtype="f32"))
    want = je.generate(prompt, JGenerationConfig(max_new_tokens=14, greedy=True,
                                                 min_new_tokens=14))
    pe = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(kernel_path="w2a8", max_seq_len=16,
                                           compute_dtype="f32"), device="cpu")
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=14, greedy=True,
                                               min_new_tokens=14))
    assert len(got.token_ids) == 14 and got.token_ids == want.token_ids
    assert "context_shift_keep8" in pe.kernel_recorder


@pytest.mark.parametrize("kp", ["w2a8", "xla"])
def test_untied_head_matches_jax(tmp_path, kp):
    """A GGUF with its own ``output.weight``: both loaders read it as a
    ternary linear and both heads run it through ``linear_apply``."""
    from bitnet_tpu.gguf.fixtures import MiniModelSpec, generate_mini_gguf

    path = str(tmp_path / "untied.gguf")
    generate_mini_gguf(path, MiniModelSpec(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
        quant="qk256", tie_embeddings=False))
    prompt = [1, 5, 9, 14, 200]
    je = JEngine.from_gguf(path, JEngineConfig(kernel_path=kp, max_seq_len=64,
                                               compute_dtype="f32"))
    want = je.generate(prompt, JGenerationConfig(max_new_tokens=6, greedy=True))
    pe = InferenceEngine.from_gguf(path, EngineConfig(
        kernel_path=kp, max_seq_len=64, compute_dtype="f32"), device="cpu")
    assert pe.params.lm_head is not None and pe.params.lm_head.n == 256
    got = pe.generate(prompt, GenerationConfig(max_new_tokens=6, greedy=True))
    assert got.token_ids == want.token_ids
