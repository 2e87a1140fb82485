"""The paged KV cache, K33 and the paged scheduler on the CPU.

- K33's plain version (``ops/paged_attention.paged_attention_plain``, what
  the wrapper runs for CPU tensors) against JAX's stock Pallas
  ``paged_attention`` under ``pltpu.force_tpu_interpret_mode()``, f32 and
  bf16, grouped heads, ragged lengths and shuffled page tables, and over
  bf16-rounded f32 pages against the stock kernel over the f32 pages
  (which it rounds to bf16 itself) within 1e-5 of the max.  Tolerance:
  the interpret-mode kernel's dots run at reduced precision (about 3e-3 of
  the largest output at f32 on unit-scale pages, measured), and its bf16
  form rounds its running output to bf16 after every compute block; so
  f32 within 1e-2 + 1e-2·max and bf16 within 4e-2·max;
- ``engine/paged_cache.py`` against ``bitnet_tpu/engine/paged_cache.py``:
  the ``PagePool`` and its fork / release sequences give the JAX page ids,
  the table helpers the JAX tables, and ``paged_forward`` (the gather form)
  the JAX hidden states and pools (layouts permuted);
- the ``paged`` plan of the stacked decode (``models/bitnet
  .forward_paged_decode``: rows into their pages, K33's plain version)
  against the dense stacked decode on the same rows;
- the paged scheduler's greedy tokens against the JAX paged scheduler's
  (K=1 and K=4, whole and chunked prefill, staggered submits stepped in
  lockstep), its sampled tokens against the port engine's, shared-prefix
  forks, a pool smaller than B×S, eviction and re-queueing as in
  ``tests/test_scheduler_paged.py``.

On the mini QK256 GGUF at f32 (``kernel_path="xla"`` unless a test says
``w2a8``, whose kernels run their plain versions here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.paged_attention import paged_attention as stock

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import paged_cache as jpc
from bitnet_tpu.models import load_model as jload_model
from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from bitnet_tpu.tokenizer import load_tokenizer as jload_tokenizer
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import paged_cache as pc
from bitnet_tpu_torch.engine.cache import allocate_cache
from bitnet_tpu_torch.engine.engine import InferenceEngine, prepare_params
from bitnet_tpu_torch.engine.stop import StopReason
from bitnet_tpu_torch.models.bitnet import forward
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.ops import registry
from bitnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                  paged_attention_plain, paged_plan)
from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
from bitnet_tpu_torch.tokenizer import load_tokenizer

torch.set_num_threads(1)

KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")


# --------------------------------------------------------------------------
# K33 against the stock kernel
# --------------------------------------------------------------------------
K33_CASES = {
    # B, H, KV, D, page, pages a slot, P, lengths
    "g4_d128_p16": (3, 8, 2, 128, 16, 4, 20, [5, 64, 33]),
    "g1_d64_p8": (2, 2, 2, 64, 8, 6, 16, [48, 1]),
    "g5_d128_p128": (2, 10, 2, 128, 128, 2, 5, [256, 130]),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(K33_CASES))
def test_k33_plain_is_the_stock_paged_attention(case, dt):
    B, H, KV, D, page, npg, P, lengths = K33_CASES[case]
    rng = np.random.default_rng(len(case) + (dt == "bf16"))
    q = rng.standard_normal((B, H, D)).astype(np.float32) * 0.1
    kp = rng.standard_normal((KV, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((KV, P, page, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    pidx = rng.permutation(P)[:B * npg].reshape(B, npg).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16,
                                                                  torch.bfloat16)
    ppcb = 2 if npg % 2 == 0 else 1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(stock(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                                jnp.asarray(vp, jdt), jnp.asarray(lens),
                                jnp.asarray(pidx), pages_per_compute_block=ppcb)
                          ).astype(np.float32)
    got = paged_attention(torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
                          torch.from_numpy(vp).to(tdt), torch.from_numpy(lens),
                          torch.from_numpy(pidx)).to(torch.float32).numpy()
    scale = float(np.abs(want).max())
    tol = 1e-2 + 1e-2 * scale if dt == "f32" else 4e-2 * scale
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("case", list(K33_CASES))
def test_k33_plain_on_bf16_rounded_pages_is_the_stock_kernel_on_f32_pages(case):
    """The stock kernel rounds f32 pages to bf16 before its dots
    (``paged_attention_kernel.py:94-109``: ``wait_and_get_loaded`` →
    ``_maybe_dequantize`` → ``astype(bfloat16)``) and keeps q and the
    softmax weights in f32; K33 reads f32 pages at f32 (the scheduler's JAX
    reference attends over an f32 view).  So the stock kernel over f32 pages
    is the plain version over the pages rounded to bf16, within 1e-5 of the
    largest output (f32 sums in another order)."""
    B, H, KV, D, page, npg, P, lengths = K33_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    q = rng.standard_normal((B, H, D)).astype(np.float32) * 0.1
    kp = rng.standard_normal((KV, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((KV, P, page, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    pidx = rng.permutation(P)[:B * npg].reshape(B, npg).astype(np.int32)
    ppcb = 2 if npg % 2 == 0 else 1
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(stock(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(lens), jnp.asarray(pidx),
                                pages_per_compute_block=ppcb))
    rounded = [torch.from_numpy(x).to(torch.bfloat16).to(torch.float32) for x in (kp, vp)]
    got = paged_attention(torch.from_numpy(q), *rounded, torch.from_numpy(lens),
                          torch.from_numpy(pidx)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_k33_plain_masks_past_the_length_and_gives_zero_for_none():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 64, generator=g)
    kp, vp = torch.randn(2, 6, 8, 64, generator=g), torch.randn(2, 6, 8, 64, generator=g)
    table = torch.tensor([[3, 1, 0], [2, 5, 4]], dtype=torch.int32)
    out = paged_attention_plain(q, kp, vp, torch.tensor([11, 0], dtype=torch.int32), table)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    # slot 0 reads pages 3 and 1: the first 11 positions, nothing of page 0
    k = torch.cat([kp[:, 3], kp[:, 1, :3]], dim=1)          # [KV, 11, D]
    v = torch.cat([vp[:, 3], vp[:, 1, :3]], dim=1)
    s = torch.einsum("kgd,ktd->kgt", q[0].view(2, 2, 64), k)
    want = torch.einsum("kgt,ktd->kgd", torch.softmax(s, -1), v).reshape(4, 64)
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-5)
    kp2 = kp.clone()
    kp2[:, 0] += 100.0                       # an unread page changes nothing
    assert torch.equal(paged_attention_plain(q, kp2, vp, torch.tensor(
        [11, 0], dtype=torch.int32), table), out)


def test_k33_plain_reads_page_0_for_an_unassigned_entry_and_stops_at_the_table():
    """The JAX paged gather's meaning where the stock kernel has none
    (a scheduler window past a slot's grown pages): a -1 entry reads page
    0; a length past the table's reach attends what the table reaches."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 2, 64, generator=g)
    kp, vp = torch.randn(1, 4, 8, 64, generator=g), torch.randn(1, 4, 8, 64, generator=g)
    lens = torch.tensor([13], dtype=torch.int32)
    got = paged_attention_plain(q, kp, vp, lens, torch.tensor([[3, -1]], dtype=torch.int32))
    want = paged_attention_plain(q, kp, vp, lens, torch.tensor([[3, 0]], dtype=torch.int32))
    assert torch.equal(got, want)
    full = paged_attention_plain(q, kp, vp, torch.tensor([16], dtype=torch.int32),
                                 torch.tensor([[3, 2]], dtype=torch.int32))
    past = paged_attention_plain(q, kp, vp, torch.tensor([40], dtype=torch.int32),
                                 torch.tensor([[3, 2]], dtype=torch.int32))
    assert torch.equal(full, past)


@pytest.mark.parametrize("B,KV,S,sms,want", [
    (8, 5, 1024, 132, (4, 256)), (1, 5, 4096, 132, (32, 128)), (64, 5, 1024, 132, (1, 1024)),
    (2, 2, 64, 132, (1, 64)), (1, 1, 1 << 20, 132, (64, 1 << 14))])
def test_k33_plan(B, KV, S, sms, want):
    splits, R = paged_plan(B, KV, S, sms)
    assert (splits, R) == want
    assert splits * R >= S and R >= 64 and splits <= 64


def test_k33_wrapper_checks_and_counts_nothing_on_the_cpu():
    q = torch.zeros(2, 4, 64)
    pages = torch.zeros(2, 3, 8, 64)
    lens, table = torch.tensor([1, 2], dtype=torch.int32), torch.zeros(2, 2,
                                                                     dtype=torch.int32)
    registry.reset_launch_counts()
    paged_attention(q, pages, pages, lens, table)
    assert registry.launch_counts()["paged_attention"] == 0
    with pytest.raises(ValueError, match="query heads"):
        paged_attention(torch.zeros(2, 3, 64), pages, pages, lens, table)
    with pytest.raises(ValueError, match="bf16 / f32"):
        paged_attention(q, pages.to(torch.int8), pages.to(torch.int8), lens, table)
    spec, = [s for s in registry.REGISTRY if s.kernel_id == "paged_attention"]
    assert spec.source == "bitnet_tpu_torch/csrc/paged_attention.cu"
    assert "exp_r4_attn.py:63-88" in spec.replaces


# --------------------------------------------------------------------------
# the pool and its tables: the JAX ids
# --------------------------------------------------------------------------
def test_page_pool_sequences_give_the_jax_ids():
    rng = np.random.default_rng(3)
    mine, theirs = pc.PagePool(24), jpc.PagePool(24)
    held: list[list[int]] = []
    for _ in range(200):
        op = rng.integers(3)
        if op == 0 and mine.free_pages:
            n = int(rng.integers(1, mine.free_pages + 1))
            a, b = mine.alloc(n), theirs.alloc(n)
            assert a == b
            held.append(a)
        elif op == 1 and held:
            pages = held[int(rng.integers(len(held)))]
            mine.retain(pages)
            theirs.retain(pages)
            held.append(list(pages))
        elif held:
            pages = held.pop(int(rng.integers(len(held))))
            mine.release(pages)
            theirs.release(pages)
        assert mine.free_pages == theirs.free_pages
        assert [mine.refcount(p) for p in range(24)] == [theirs.refcount(p)
                                                          for p in range(24)]
    with pytest.raises(Exception, match="exhausted"):
        pc.PagePool(2).alloc(3)
    p = pc.PagePool(2)
    p.release(p.alloc(1))
    with pytest.raises(Exception, match="double free"):
        p.release([1])


def test_table_helpers_are_the_jax_ones(mini_gguf_qk256):
    cfg, _, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32, device="cpu")
    jcfg, _, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    c, pool = pc.allocate_paged_cache(cfg, 3, 12, 8, 6, "f32", device="cpu")
    jc, jpool = jpc.allocate_paged_cache(jcfg, 3, 12, 8, 6, "f32")
    assert c.k.shape == (cfg.num_layers, cfg.num_kv_heads, 13, 8, cfg.head_dim)
    assert pc.to_jax_layout(c.k).shape == jc.k.shape

    def same():
        assert np.array_equal(c.tables.numpy(), np.asarray(jc.tables))
        assert np.array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
        assert pool.free_pages == jpool.free_pages
    pc.ensure_capacity(c, pool, 0, 19)
    jc = jpc.ensure_capacity(jc, jpool, 0, 19)
    c.lengths[0] = 16
    jc = jc.__class__(k=jc.k, v=jc.v, tables=jc.tables,
                      lengths=jc.lengths.at[0].set(16), page_size=8)
    same()
    pc.fork_slot(c, pool, 0, 1, 16)
    jc = jpc.fork_slot(jc, jpool, 0, 1, 16)
    same()
    pc.ensure_capacity(c, pool, 1, 30)
    jc = jpc.ensure_capacity(jc, jpool, 1, 30)
    same()
    pc.release_slot(c, pool, 0)
    jc = jpc.release_slot(jc, jpool, 0)
    same()
    pc.assign_pages(c, 2, pool.alloc(2), 1)
    jc = jpc.assign_pages(jc, 2, jpool.alloc(2), 1)
    same()
    assert pc.pages_needed(17, 8) == jpc.pages_needed(17, 8) == 3
    with pytest.raises(Exception, match="page-boundary"):
        pc.fork_slot(c, pool, 1, 0, 12)


def test_paged_forward_is_the_jax_paged_forward(mini_gguf_qk256):
    """The gather form: a B=2 prefill into shuffled pages, then one decode
    step with one idle slot; hidden states and pools as the JAX package
    leaves them."""
    cfg, params, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32,
                                device="cpu")
    params, _ = prepare_params(params, EngineConfig(**KW), torch.device("cpu"), "xla")
    jcfg, jparams, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    c, pool = pc.allocate_paged_cache(cfg, 2, 10, 8, 3, "f32", device="cpu")
    jc, _ = jpc.allocate_paged_cache(jcfg, 2, 10, 8, 3, "f32")
    table = np.array([[7, 2, -1], [4, 9, 0]], np.int32)
    c.tables.copy_(torch.from_numpy(table))
    jc = jc.__class__(k=jc.k, v=jc.v, tables=jnp.asarray(table), lengths=jc.lengths,
                      page_size=8)
    toks = np.array([[1, 7, 20, 3, 9, 11, 4, 0, 0, 0], [3, 5, 8, 13, 2, 6, 1, 2, 9, 8]])
    pos = np.where(np.arange(10)[None] < np.array([[7], [10]]), np.arange(10)[None], 24)
    n_real = np.array([7, 10], np.int32)
    h, _ = pc.paged_forward(cfg, params, torch.from_numpy(toks), torch.from_numpy(pos),
                            c, torch.from_numpy(n_real), "xla")
    jh, jc = jpc.paged_forward(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos), jc,
                               jnp.asarray(n_real), "xla", pad_marker=24)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    step_t, step_p = np.array([[5], [9]]), np.array([[7], [24]])
    act = np.array([1, 0], np.int32)
    h, _ = pc.paged_forward(cfg, params, torch.from_numpy(step_t),
                            torch.from_numpy(step_p), c, torch.from_numpy(act), "xla")
    jh, jc = jpc.paged_forward(jcfg, jparams, jnp.asarray(step_t), jnp.asarray(step_p),
                               jc, jnp.asarray(act), "xla", pad_marker=24)
    np.testing.assert_allclose(h.numpy()[0], np.asarray(jh)[0], rtol=1e-4, atol=1e-4)
    assert np.array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
    for mine, theirs in ((c.k, jc.k), (c.v, jc.v)):
        np.testing.assert_allclose(pc.to_jax_layout(mine).numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_plan_is_the_dense_stacked_decode(mini_gguf_qk256, dt):
    """One w2a8 decode step of a pool of 3 (one slot idle) through the
    ``paged`` plan (rows into their pages, K33's plain version) against the
    dense stacked decode over the same rows: hidden states and new rows."""
    ec = EngineConfig(**{**KW, "kernel_path": "w2a8", "fuse_projections": True,
                         "kv_cache_dtype": dt, "compute_dtype": dt})
    cfg, params, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32,
                                device="cpu")
    params, _ = prepare_params(params, ec, torch.device("cpu"), "w2a8")
    L, KV, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    page, nb, S = 8, 4, 32
    dense = allocate_cache(cfg, 3, S, dt, device="cpu")
    paged, _ = pc.allocate_paged_cache(cfg, 3, 16, page, nb, dt, device="cpu")
    g = torch.Generator().manual_seed(1)
    rows = (torch.randn(2, L, 3, S, KV, D, generator=g) * 0.5).to(dense.k.dtype)
    dense.k.copy_(rows[0].view(L, 3, S, KV * D))
    dense.v.copy_(rows[1].view(L, 3, S, KV * D))
    table = torch.tensor([[5, 1, 12, 3], [0, 7, 2, 9], [-1, -1, -1, -1]],
                         dtype=torch.int32)
    paged.tables.copy_(table)
    for b in range(2):
        for j in range(nb):
            for pool, src in ((paged.k, rows[0]), (paged.v, rows[1])):
                pool[:, :, int(table[b, j])] = src[:, b, j * page:(j + 1) * page
                                                   ].permute(0, 2, 1, 3)
    lengths = torch.tensor([13, 27, 0], dtype=torch.int32)
    paged.lengths.copy_(lengths)
    toks = torch.tensor([[5], [9], [0]])
    act = torch.tensor([1, 1, 0], dtype=torch.int32)
    with torch.inference_mode():
        h_p, _ = pc.paged_forward(cfg, params, toks, torch.tensor([[13], [27], [32]]),
                                  paged, act, "w2a8")
        h_d, _, _ = forward(cfg, params, toks, torch.tensor([[13], [27], [32]]),
                            dense.k, dense.v, torch.tensor([13, 27, 0]), 1, "w2a8")
    tol = dict(rtol=1e-4, atol=1e-4) if dt == "f32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(h_p[:2], h_d[:2], **tol)
    assert torch.equal(paged.lengths, lengths + act)
    for b, p in ((0, 13), (1, 27)):
        pg, off = int(table[b, p // page]), p % page
        new_k = dense.k[:, b, p].view(L, KV, D).to(torch.float32)
        got_k = paged.k[:, :, pg, off].to(torch.float32)
        # layer 0's rows come before any attention: the same bits; later
        # layers' rows carry the attention's rounding (bf16: 5e-2 of the max)
        assert torch.equal(got_k[0], new_k[0])
        rel = 1e-4 if dt == "f32" else 5e-2
        assert float((got_k - new_k).abs().max()) <= rel * float(new_k.abs().max())
    assert registry.launch_counts()["paged_attention"] == 0


# --------------------------------------------------------------------------
# the paged scheduler
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model(mini_gguf_qk256):
    cfg, params, _ = load_model(mini_gguf_qk256.path, param_dtype=torch.float32,
                                device="cpu")
    return cfg, params, load_tokenizer(mini_gguf_qk256.path)


@pytest.fixture(scope="module")
def jmodel(mini_gguf_qk256):
    cfg, params, _ = jload_model(mini_gguf_qk256.path, param_dtype=jnp.float32)
    return cfg, params, jload_tokenizer(mini_gguf_qk256.path)


def make_paged(model, **kw):
    cfg, params, tok = model
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 8)
    ec = EngineConfig(**{**KW, **kw.pop("ecfg", {})})
    return ContinuousBatchingScheduler(cfg, params, tok, ec, paged=True, device="cpu",
                                       **kw)


def drain(req):
    toks = []
    while True:
        tok, _, done, reason = req.out.get(timeout=0)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks, reason


def collect(req, timeout=120):
    toks = []
    while True:
        tok, _, done, reason = req.out.get(timeout=timeout)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks, reason


SHARED = [1, 5, 9, 13, 17, 21, 25, 29, 2]      # 9 tokens, one page of 8


@pytest.mark.parametrize("chunked", [None, 8], ids=["whole", "chunked8"])
@pytest.mark.parametrize("k", [1, 4])
def test_paged_greedy_tokens_are_the_jax_schedulers(model, jmodel, k, chunked):
    """Staggered submits stepped in lockstep on both paged schedulers,
    with a shared-prefix fork and a window crossing page boundaries."""
    def run(sched, G):
        script = {0: [SHARED + [3]], 2: [SHARED + [7, 4, 4]],
                  5: [[(7 * i + 3) % 250 for i in range(19)]]}
        reqs = []
        for step in range(300):
            for p in script.get(step, ()):
                reqs.append(sched.submit(p, G(max_new_tokens=11, greedy=True)))
            sched._step()
            if step > 5 and not any(s.occupied for s in sched.slots) \
                    and sched.pending.empty():
                break
        return ([(t, r.value) for t, r in map(drain, reqs)], sched.pool.free_pages,
                sched.stats.get("prefix_forked_pages", 0))
    kw = dict(start_loop=False, decode_steps_per_dispatch=k, chunked_prefill=chunked,
              num_pages=14)
    got = run(make_paged(model, **kw), GenerationConfig)
    want = run(JScheduler(jmodel[0], jmodel[1], jmodel[2], JEngineConfig(**KW),
                          paged=True, page_size=8, num_slots=2, **kw), JGen)
    assert got == want
    assert got[1] == 14 and got[2] >= 1


@pytest.mark.parametrize("gen", [
    dict(max_new_tokens=7, temperature=0.8, top_k=5, seed=42),
    dict(max_new_tokens=7, mirostat=2, seed=5),
    dict(max_new_tokens=7, greedy=True, repetition_penalty=3.0, logprobs=1)],
    ids=["top-k", "mirostat", "rep-logprobs"])
def test_paged_sampled_tokens_are_the_engines(model, mini_gguf_qk256, gen):
    eng = InferenceEngine.from_gguf(mini_gguf_qk256.path, EngineConfig(**KW),
                                    device="cpu")
    s = make_paged(model, decode_steps_per_dispatch=3)
    try:
        toks, _ = collect(s.submit([1, 7, 20, 3], GenerationConfig(**gen)))
    finally:
        s.shutdown()
    assert toks == eng.generate([1, 7, 20, 3], GenerationConfig(**gen)).token_ids


def test_prefix_fork_matches_a_fresh_run_and_frees_every_page(model):
    s = make_paged(model, num_pages=12)
    try:
        gen = GenerationConfig(max_new_tokens=24, greedy=True)
        r1 = s.submit(SHARED + [3], gen)
        r1.out.get(timeout=120)
        r2 = s.submit(SHARED + [7], GenerationConfig(max_new_tokens=4, greedy=True))
        t2, _ = collect(r2)
        collect(r1)
        assert s.stats.get("prefix_forked_pages", 0) >= 1
        assert s.pool.free_pages == 12
    finally:
        s.shutdown()
    fresh = make_paged(model, num_pages=12)
    try:
        t_ref, _ = collect(fresh.submit(SHARED + [7], GenerationConfig(
            max_new_tokens=4, greedy=True)))
    finally:
        fresh.shutdown()
    assert t2 == t_ref


def test_pool_smaller_than_b_times_s_serves_every_request(model):
    """2 slots × S=64 would need 16 pages; 8 serve 6 short requests."""
    s = make_paged(model, num_pages=8)
    try:
        gen = GenerationConfig(max_new_tokens=4, greedy=True)
        reqs = [s.submit([1, i + 2, 9], gen) for i in range(6)]
        for r in reqs:
            toks, reason = collect(r)
            assert len(toks) >= 1 and reason is not None
        assert s.pool.free_pages == 8
    finally:
        s.shutdown()


@pytest.mark.parametrize("k", [1, 4])
def test_a_dry_pool_evicts_context_full_as_jax_does(model, jmodel, k):
    """One slot, two pages (16 tokens): the generation that outgrows them
    ends CONTEXT_FULL after the JAX scheduler's tokens."""
    def run(sched, G):
        r = sched.submit([1, 5, 9], G(max_new_tokens=60, greedy=True))
        for _ in range(80):
            sched._step()
        t, reason = drain(r)
        return t, reason.value, sched.pool.free_pages, sched.stats.get("evictions")
    kw = dict(num_slots=1, num_pages=2, start_loop=False, decode_steps_per_dispatch=k)
    got = run(make_paged(model, **kw), GenerationConfig)
    want = run(JScheduler(jmodel[0], jmodel[1], jmodel[2], JEngineConfig(**KW),
                          paged=True, page_size=8, **kw), JGen)
    assert got == want
    assert got[1] == StopReason.CONTEXT_FULL.value and 1 <= len(got[0]) < 60


def test_a_blocked_admission_waits_for_pages(model):
    s = make_paged(model, num_pages=3)
    try:
        g = GenerationConfig(max_new_tokens=10, greedy=True)
        r1 = s.submit([1, 5, 9, 2, 6, 8, 3, 7], g)
        r2 = s.submit([2, 4, 6, 8, 1, 3, 5, 7], g)
        t1, _ = collect(r1)
        t2, _ = collect(r2)
        assert len(t1) >= 1 and len(t2) >= 1 and s.pool.free_pages == 3
    finally:
        s.shutdown()


def test_quantized_pages_are_refused(model):
    with pytest.raises(Exception, match="quantized"):
        make_paged(model, ecfg={"kv_cache_dtype": "int8"})


def test_paged_scheduler_runs_the_paged_plan_on_w2a8(model):
    """Fused w2a8 weights take the ``paged`` plan (K33's plain version on
    the CPU, no count) with the dense scheduler's greedy tokens."""
    ec = {"kernel_path": "w2a8", "fuse_projections": True}
    prompts = [SHARED + [3], [3, 5, 8]]
    out = {}
    for paged in (False, True):
        cfg, params, tok = model
        s = ContinuousBatchingScheduler(
            cfg, params, tok, EngineConfig(**{**KW, **ec}), num_slots=3, paged=paged,
            page_size=8, device="cpu", decode_steps_per_dispatch=4)
        try:
            assert s.plan() == ("paged" if paged else "batched_v2")
            out[paged] = [collect(s.submit(p, GenerationConfig(max_new_tokens=10,
                                                               greedy=True)))[0]
                          for p in prompts]
        finally:
            s.shutdown()
    assert out[True] == out[False]


def test_exp_r4_attn_paged_variant_runs_its_plain_leg():
    from bitnet_tpu_torch.experiments import exp_r4_attn as ex

    step, make_carry, fn, floor = ex.make_variant("paged", L=2, B=2, S=256, device="cpu")
    assert fn is paged_attention
    c = make_carry(1)
    out = step(c, 0)
    assert out.shape == c.shape == (2, ex.H, ex.D)
    assert bool(torch.isfinite(out.float()).all())
    assert floor == pytest.approx(2 * 2 * 256 * ex.KV * ex.D * 2 / 3.35e12)
