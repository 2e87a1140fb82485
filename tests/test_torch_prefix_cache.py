"""The port's prompt-prefix cache (``engine.prefix_cache`` and the engine's
restore + suffix prefill) against the JAX package's.

The trie is the JAX package's class, so the same inserts and lookups give
the same matches, evictions and stats.  On the mini QK256 model at f32
(``xla`` on the CPU), a hit's last-token logits equal a cold prefill's
within rtol 1e-4, atol 1e-5 (``tests/test_kv_caches.py:82-101``), for the
same prompt and for an extension of a stored one, and the port's greedy
tokens after a hit are the JAX engine's.  The suffix also attends over the
restored rows of an int8 / fp8 cache (dequantized read) and on the stacked
prefill of the fused path (plain kernel versions on the CPU), held there to
the same engine's cold prefill within the same tolerance.
"""

import numpy as np
import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import InferenceEngine as JEngine
from bitnet_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from bitnet_tpu.engine.prefix_cache import PrefixSnapshot as JSnap
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import PrefixCache, PrefixSnapshot
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.engine.prefix_cache import snapshot_from_cache

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _snap(cls, n):
    return cls(length=n, k=np.zeros((1, n, 1, 2), np.float32),
               v=np.zeros((1, n, 1, 2), np.float32))


@pytest.mark.parametrize("max_tokens", [8, 12, 1000])
def test_trie_matches_jax(max_tokens):
    """The same inserts and lookups on both tries (LRU eviction by tokens,
    a snapshot longer than the budget skipped): the same match lengths,
    cached tokens and stats after each operation."""
    ops = [("ins", [1, 2, 3]), ("look", [1, 2, 3, 4]), ("ins", [1, 2, 3, 4, 5]),
           ("look", [1, 2, 3, 4, 9]), ("look", [7]), ("ins", [7, 8, 9, 10]),
           ("look", [1, 2]), ("ins", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]),
           ("look", [7, 8, 9, 10, 11]), ("look", [1, 2, 3, 4, 5, 6]),
           ("ins", [1, 2]), ("look", [1, 2, 3])]
    pc, jc = PrefixCache(max_tokens), JPrefixCache(max_tokens)
    for op, toks in ops:
        if op == "ins":
            pc.insert(toks, _snap(PrefixSnapshot, len(toks)))
            jc.insert(toks, _snap(JSnap, len(toks)))
        else:
            (m, s), (jm, js) = pc.lookup(toks), jc.lookup(toks)
            assert m == jm and (s is None) == (js is None)
        assert pc.stats() == jc.stats() and pc.cached_tokens == jc.cached_tokens
    with pytest.raises(ValueError, match="snapshot length"):
        pc.insert([1, 2], _snap(PrefixSnapshot, 3))


KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32",
          kernel_path="xla")


@pytest.fixture(scope="module")
def engines(mini_gguf_qk256):
    p = mini_gguf_qk256.path
    return {"port": InferenceEngine.from_gguf(
                p, EngineConfig(**KW, prefix_cache_tokens=256), device="cpu"),
            "cold": InferenceEngine.from_gguf(p, EngineConfig(**KW), device="cpu"),
            "jax": JEngine.from_gguf(p, JEngineConfig(**KW, prefix_cache_tokens=256))}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_hit_reproduces_the_full_prefill_logits(engines):
    eng = engines["port"]
    prompt = [2, 7, 11, 13, 17, 19, 23, 29]
    before = eng.prefix_cache.stats()
    first = _np(eng.prefill(prompt))                    # miss: the whole prompt
    again = _np(eng.prefill(prompt))                    # hit: restore + 1 token
    after = eng.prefix_cache.stats()
    assert (after["misses"] - before["misses"], after["hits"] - before["hits"]) == (1, 1)
    assert f"prefix_restore_m{len(prompt) - 1}" in eng.kernel_recorder
    np.testing.assert_allclose(first, again, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(again, _np(engines["cold"].prefill(prompt)),
                               rtol=1e-4, atol=1e-5)


def test_extension_prompt_uses_the_prefix(engines):
    eng = engines["port"]
    base = [3, 5, 8, 12]
    ext = base + [30, 31]
    eng.prefill(base)
    lg = _np(eng.prefill(ext))
    assert eng.kernel_recorder[-2:] == ["prefix_restore_m4", "prefill_xla_T8"]
    np.testing.assert_allclose(lg, _np(engines["cold"].prefill(ext)),
                               rtol=1e-4, atol=1e-5)
    # against the JAX engine's hit on the same prompts
    je = engines["jax"]
    je.prefill(base)
    np.testing.assert_allclose(lg, np.asarray(je.prefill(ext)), rtol=1e-4, atol=1e-5)
    assert je.kernel_recorder[-2] == "prefix_restore_m4"


def test_generation_after_a_hit_is_jax(engines):
    """A shared prefix stored by a first request, then a request that
    extends it: greedy tokens equal the JAX engine's, with the same
    restore length recorded."""
    sys_prompt = [1, 40, 41, 42, 43, 44, 45, 46, 47, 48]
    gc = dict(max_new_tokens=12, greedy=True)
    for e in (engines["port"], engines["jax"]):
        e.prefill(sys_prompt)
    got = engines["port"].generate(sys_prompt + [9, 8, 7], GenerationConfig(**gc))
    want = engines["jax"].generate(sys_prompt + [9, 8, 7], JGen(**gc))
    assert got.token_ids == want.token_ids and len(got.token_ids) == 12
    m = [r for r in engines["port"].kernel_recorder if r.startswith("prefix_restore")]
    jm = [r for r in engines["jax"].kernel_recorder if r.startswith("prefix_restore")]
    assert m[-1] == jm[-1] == f"prefix_restore_m{len(sys_prompt)}"


def test_eval_ids_and_embed_ids_stay_cold(engines):
    """``eval_ids`` and ``embed_ids`` never read or fill the prefix cache;
    ``embed_ids`` gives the JAX engine's final-normed rows."""
    eng = engines["port"]
    ids = [1, 9, 8, 7, 6, 5]
    s0 = eng.prefix_cache.stats()
    h = eng.embed_ids(ids)
    eng.eval_ids(ids)
    assert eng.prefix_cache.stats() == s0
    assert h.shape == (len(ids), eng.cfg.hidden_size) and h.dtype == np.float32
    np.testing.assert_allclose(h, engines["jax"].embed_ids(ids), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv,kp,fuse", [("int8", "xla", False), ("fp8", "xla", False),
                                         ("bf16", "w2a8", True), ("int8", "w2a8", True)])
def test_suffix_attends_over_the_restored_rows(mini_gguf_qk256, kv, kp, fuse):
    """A 1-byte cache (the suffix reads the restored codes dequantized with
    their restored scales) and the fused path's stacked prefill (plain
    kernel versions on the CPU): the hit's logits equal a cold prefill's
    on the same engine within rtol 1e-4, atol 1e-5, and differ by more
    than 1e-3 from a prefill of the suffix alone (the logits here are
    about 0.2 in size)."""
    eng = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(max_seq_len=64, kv_cache_dtype=kv,
                                           kernel_path=kp, fuse_projections=fuse,
                                           prefix_cache_tokens=256), device="cpu")
    prompt = [1] + [(5 * i) % 200 + 3 for i in range(21)]
    eng.prefill(prompt[:16])
    hit = _np(eng.prefill(prompt))
    assert "prefix_restore_m16" in eng.kernel_recorder
    eng.prefix_cache = None
    cold = _np(eng.prefill(prompt))
    alone = _np(eng.prefill(prompt[16:]))
    np.testing.assert_allclose(hit[0], cold[0], rtol=1e-4, atol=1e-5)
    assert np.abs(alone[0] - cold[0]).max() > 1e-3


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
def test_snapshot_is_canonical_on_the_host(mini_gguf_qk256, kv):
    """Snapshots are ``[L, m, KV, D]`` on the host: numpy for f32 / int8,
    CPU tensors for bf16 / fp8, with ``[L, m, KV]`` f32 scales for a
    1-byte cache; restoring one writes back the same rows bit for bit."""
    eng = InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(max_seq_len=64, kv_cache_dtype=kv,
                                           kernel_path="xla"), device="cpu")
    cfg = eng.cfg
    eng.prefill([1, 4, 9, 16, 25, 36])
    s = snapshot_from_cache(eng.cache, 6, kv_heads=cfg.num_kv_heads)
    assert tuple(s.k.shape) == (cfg.num_layers, 6, cfg.num_kv_heads, cfg.head_dim)
    assert isinstance(s.k, torch.Tensor) == (kv in ("bf16", "fp8"))
    assert (s.k_scale is None) == (kv in ("f32", "bf16"))
    if s.k_scale is not None:
        assert s.k_scale.shape == (cfg.num_layers, 6, cfg.num_kv_heads)
        assert s.k_scale.dtype == np.float32
    rows = eng.cache.k[:, 0, :6].clone()
    eng.cache.k.zero_()
    eng._restore_prefix(s, 6)
    assert torch.equal(eng.cache.k[:, 0, :6].view(torch.uint8), rows.view(torch.uint8))
    assert int(eng.cache.lengths[0]) == 6
    assert s.nbytes == 2 * rows.numel() * rows.element_size() + (
        0 if s.k_scale is None else 2 * s.k_scale.nbytes)


def test_route_probe_and_conditioned_norms():
    """``tools/prefill_routes.routes`` on a small synthetic model on the
    CPU: every route present, the repeat exact, each route's cosine near
    1; ``condition_norms`` sets the pre-norm gains from H and the sub-norm
    gains to 0.05."""
    from bitnet_tpu_torch.config import ModelConfig
    from bitnet_tpu_torch.models.synthetic import build_synthetic, condition_norms
    from bitnet_tpu_torch.tools.prefill_routes import routes

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=1024, use_sub_norm=True)
    params = condition_norms(build_synthetic(cfg, seed=0, device="cpu"), cfg)
    assert torch.allclose(params.blocks.attn_norm, torch.full_like(
        params.blocks.attn_norm, 1 / (0.02 * (256 * 2.5) ** 0.5)))
    assert torch.equal(params.blocks.ffn_sub_norm,
                       torch.full_like(params.blocks.ffn_sub_norm, 0.05))
    toks = [int(t) for t in torch.randint(3, 512, (40,),
                                          generator=torch.Generator().manual_seed(1))]
    r = routes(cfg, params, "cpu", toks, m=32)
    assert set(r) == {"repeat", "hit", "decode20", "plain_attention", "argmax_agree"}
    assert r["repeat"] == pytest.approx(1.0, abs=1e-6)
    assert min(r[k] for k in ("hit", "decode20", "plain_attention")) > 0.99


def test_generation_after_a_hit_on_the_f32_mini_is_jax(mini_gguf_f32):
    """The F32 mini GGUF (dense linears): a prefix stored, then a request
    that extends it; greedy tokens and the restore length are the JAX
    engine's."""
    p = mini_gguf_f32.path
    pe = InferenceEngine.from_gguf(p, EngineConfig(**KW, prefix_cache_tokens=256),
                                   device="cpu")
    je = JEngine.from_gguf(p, JEngineConfig(**KW, prefix_cache_tokens=256))
    sys_prompt = [1, 40, 41, 42, 43, 44, 45, 46]
    gc = dict(max_new_tokens=10, greedy=True)
    for e in (pe, je):
        e.prefill(sys_prompt)
    got = pe.generate(sys_prompt + [9, 8], GenerationConfig(**gc))
    want = je.generate(sys_prompt + [9, 8], JGen(**gc))
    assert got.token_ids == want.token_ids
    assert f"prefix_restore_m{len(sys_prompt)}" in pe.kernel_recorder
