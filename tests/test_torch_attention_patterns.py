"""The port's pattern masks (``ops/attention_patterns.py``), the
attention's ``kv_positions`` / ``window`` / ``extra_mask`` arguments
(``ops/attention.py``), the op catalog (``ops/nn_extras.py``) and the host
int8 activation quantizer (``quant/int8.py``) against the JAX package's.

Masks are equal element for element; attention outputs and the float ops
agree within 1e-5 of their largest magnitude (f32; 1e-4 for the
convolution, whose sums run in another order); integer results are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnet_tpu.ops import attention_patterns as jap
from bitnet_tpu.ops import nn_extras as jnn
from bitnet_tpu.ops.attention import attention as jattention
from bitnet_tpu.quant import int8 as jint8
from bitnet_tpu_torch.ops import attention_patterns as ap
from bitnet_tpu_torch.ops import nn_extras as nn
from bitnet_tpu_torch.ops.attention import attention
from bitnet_tpu_torch.quant import int8

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


PATTERNS = [dict(kind="DENSE"), dict(kind="CAUSAL"), dict(kind="SLIDING_WINDOW", window=5),
            dict(kind="DILATED", window=4, rate=2), dict(kind="DILATED", window=6, rate=1),
            dict(kind="GLOBAL_LOCAL", window=3, num_global=2),
            dict(kind="BLOCK_SPARSE", block_size=4, stride=2),
            dict(kind="BLOCK_SPARSE", block_size=8, stride=1)]


def _keys(seed):
    """A ring's key positions with holes (-1), and queries around them."""
    rng = np.random.default_rng(seed)
    kp = rng.permutation(24)[:16].astype(np.int32).reshape(2, 8)
    kp[0, 3] = kp[1, 0] = -1
    qp = rng.integers(0, 28, (2, 5)).astype(np.int32)
    return qp, kp


@pytest.mark.parametrize("spec", PATTERNS, ids=[
    f"{p['kind'].lower()}-{i}" for i, p in enumerate(PATTERNS)])
def test_pattern_masks_are_jax(spec):
    qp, kp = _keys(len(spec))
    kw = {k: v for k, v in spec.items() if k != "kind"}
    got = ap.pattern_mask(ap.AttentionPattern(kind=ap.PatternKind[spec["kind"]], **kw),
                          torch.from_numpy(qp), torch.from_numpy(kp))
    want = jap.pattern_mask(jap.AttentionPattern(kind=jap.PatternKind[spec["kind"]], **kw),
                            jnp.asarray(qp), jnp.asarray(kp))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for S in (7, 100):
        assert ap.effective_kv_footprint(
            ap.AttentionPattern(kind=ap.PatternKind[spec["kind"]], **kw), S) == \
            jap.effective_kv_footprint(
                jap.AttentionPattern(kind=jap.PatternKind[spec["kind"]], **kw), S)


@pytest.mark.parametrize("case", ["slots", "ring", "ring_window", "pattern", "window"])
def test_attention_masks_are_jax(case):
    """Slot validity by length, by stored position, the sliding window and
    a pattern mask ANDed in: outputs within 1e-5 (f32)."""
    rng = np.random.default_rng(3)
    B, T, H, KV, D, S = 2, 5, 4, 2, 16, 8
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    qp, kp = _keys(1)
    qp = np.maximum(qp, kp.max(1, keepdims=True) - 2)     # every query sees a key
    lens = np.array([6, 8], np.int32)
    kw, jkw = {}, {}
    if case in ("ring", "ring_window"):
        kw["kv_positions"], jkw["kv_positions"] = torch.from_numpy(kp), jnp.asarray(kp)
    if case in ("ring_window", "window"):
        kw["window"] = jkw["window"] = 12
    if case == "pattern":
        slot = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        kw["extra_mask"] = ap.pattern_mask(
            ap.AttentionPattern(kind=ap.PatternKind.GLOBAL_LOCAL, window=6, num_global=2),
            torch.from_numpy(qp), torch.from_numpy(slot.copy()))
        jkw["extra_mask"] = jap.pattern_mask(
            jap.AttentionPattern(kind=jap.PatternKind.GLOBAL_LOCAL, window=6,
                                 num_global=2), jnp.asarray(qp), jnp.asarray(slot))
    if case in ("slots", "pattern", "window"):
        qp = np.maximum(qp, 3)
    t = [torch.from_numpy(a) for a in (q, k, v, qp, lens)]
    j = [jnp.asarray(a) for a in (q, k, v, qp, lens)]
    _close(attention(*t, **kw), jattention(*j, **jkw))


def test_nn_extras_are_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for stride in (1, 2):
        for pad in ("SAME", "VALID"):
            _close(nn.conv2d(tx, tw, stride, pad), jnn.conv2d(jx, jw, stride, pad), 1e-4)
    _close(nn.max_pool2d(tx), jnn.max_pool2d(jx))
    _close(nn.avg_pool2d(tx, 3, 2), jnn.avg_pool2d(jx, 3, 2))
    g, b = rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    _close(nn.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b)),
           jnn.layer_norm(jx, jnp.asarray(g), jnp.asarray(b)))
    lg = rng.standard_normal((6, 11)).astype(np.float32)
    tg = rng.integers(0, 11, 6)
    _close(nn.cross_entropy(torch.from_numpy(lg), torch.from_numpy(tg)),
           jnn.cross_entropy(jnp.asarray(lg), jnp.asarray(tg)))
    _close(nn.mse(tx, tx * 0.5), jnn.mse(jx, jx * 0.5))
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([3, 0, 9, 3])
    np.testing.assert_array_equal(nn.embedding_lookup(torch.from_numpy(table),
                                                      torch.from_numpy(ids)).numpy(),
                                  np.asarray(jnn.embedding_lookup(jnp.asarray(table),
                                                                  jnp.asarray(ids))))
    np.testing.assert_array_equal(nn.gather_rows(torch.from_numpy(table),
                                                 torch.from_numpy(ids)).numpy(),
                                  np.asarray(jnn.gather_rows(jnp.asarray(table),
                                                             jnp.asarray(ids))))
    upd = rng.standard_normal((2, 4)).astype(np.float32)
    idx = np.array([1, 7])
    np.testing.assert_array_equal(
        nn.scatter_rows(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(upd)).numpy(),
        np.asarray(jnn.scatter_rows(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(upd))))
    for axes in (None, (2, 0, 1, 3)):
        np.testing.assert_array_equal(nn.transpose(tx, axes).numpy(),
                                      np.asarray(jnn.transpose(jx, axes)))
    for axis in (None, 1, -1):
        _close(nn.reduce_sum(tx, axis), jnn.reduce_sum(jx, axis))
        _close(nn.reduce_max(tx, axis), jnn.reduce_max(jx, axis))
        _close(nn.reduce_mean(tx, axis), jnn.reduce_mean(jx, axis))
    _close(nn.cumsum(tx, 2), jnn.cumsum(jx, 2))
    assert jax.default_backend() == "cpu"


def test_host_int8_quantizer_is_jax():
    x = (np.random.default_rng(8).standard_normal((4, 3, 32)) * 5).astype(np.float32)
    x[2, 1] = 0.0
    q, s = int8.quantize_activations_int8(x)
    jq, js = jint8.quantize_activations_int8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert q.dtype == np.int8 and s.shape == (4, 3, 1)
