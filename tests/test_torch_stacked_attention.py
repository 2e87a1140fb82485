"""K25–K27's plain versions against the Pallas kernels they replace, run in
interpret mode on the CPU: the 5-D stacked-cache pair
(``decode_attention_stacked`` / ``_inplace``) on the JAX package's own
test inputs (``tests/test_decode_attention.py``'s ``_mk``: B=1, H=4, KV=2,
D=64, S=32, L=3, f32) and on bf16 caches past one 1024-row chunk, and the
per-b v2 kernel (``decode_attention_perb_v2``) at one and two 512-row
chunks, on bf16 and f32 caches.

Tolerances: over an f32 cache nothing rounds, and the scores and sums
are the same f32 products taken in another order: 1e-5, the JAX test's own.
Over a bf16 cache the output is held to 2e-3 of its max magnitude, as in
``test_torch_attention_plans.py``: a softmax weight whose f32 value moves by
an ulp can round to the neighbouring bf16 before the PV product.  K26's
written rows are the new rows cast to the cache dtype, bit for bit, and
every other byte of both stacks is unchanged.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnet_tpu.ops import decode_attention as jv1
from bitnet_tpu.ops import decode_attention_v2 as jv2
from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da
from bitnet_tpu_torch.ops import registry

torch.set_num_threads(1)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _close(got: torch.Tensor, want, kv: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if kv == "f32":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())


def _mk(B=1, H=4, KV=2, D=64, S=32, L=3, seed=0, kv="f32", pos=None):
    """The JAX test's inputs (f32), the caches in ``kv``."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((B, H, D)), jnp.float32)
    kn = jnp.asarray(rng.standard_normal((B, KV, D)), jnp.float32)
    vn = jnp.asarray(rng.standard_normal((B, KV, D)), jnp.float32)
    kc = jnp.asarray(rng.standard_normal((L, B, S, KV, D)), JDT[kv])
    vc = jnp.asarray(rng.standard_normal((L, B, S, KV, D)), JDT[kv])
    pos = jnp.asarray([7] * B if pos is None else pos, jnp.int32)
    return q, kn, vn, kc, vc, pos


# the JAX test's shapes (f32, and its caches in bf16), then two 1024-row
# chunks with a full and a half-full slot
CASES = [({}, "f32", (0, 2)), ({}, "bf16", (1,)),
         ({"B": 2, "S": 2048, "L": 2, "pos": [2047, 1100]}, "bf16", (1,))]


@pytest.mark.parametrize("kw,kv,layers", CASES)
def test_k25_plain_matches_pallas(kw, kv, layers):
    q, kn, vn, kc, vc, pos = _mk(kv=kv, **kw)
    for l in layers:
        want = jv1.decode_attention_stacked(jnp.int32(l), q, kn, vn, kc, vc, pos,
                                            interpret=True)
        got = dk.decode_attention_stacked(l, *(to_torch(a) for a in
                                               (q, kn, vn, kc, vc, pos)))
        assert got.dtype == torch.float32 and got.shape == tuple(q.shape)
        _close(got, want, kv)


@pytest.mark.parametrize("kw,kv,layers", CASES)
@pytest.mark.parametrize("where", ["pos", "before", "past"])
def test_k26_plain_matches_pallas(kw, kv, layers, where):
    """Attention over the PRE-write cache and the rows written at
    ``write_pos``: = pos, < pos (the written row is one attention reads:
    it must see the old row), and = S (dropped, nothing written)."""
    q, kn, vn, kc, vc, pos = _mk(kv=kv, **kw)
    S = kc.shape[2]
    wpos = {"pos": pos, "before": pos - 5,
            "past": jnp.full_like(pos, S)}[where]
    for l in layers:
        kc_np, vc_np = np.asarray(kc), np.asarray(vc)   # the JAX call donates them
        tk, tv = to_torch(kc_np), to_torch(vc_np)
        want, jk, jvv = jv1.decode_attention_stacked_inplace(
            jnp.int32(l), q, kn, vn, jnp.asarray(kc_np), jnp.asarray(vc_np), pos,
            wpos, interpret=True)
        got, gk, gv = dk.decode_attention_stacked_inplace(
            l, *(to_torch(a) for a in (q, kn, vn)), tk, tv, to_torch(pos),
            to_torch(wpos))
        assert gk is tk and gv is tv                    # written in place
        _close(got, want, kv)
        np.testing.assert_array_equal(bits(gk), bits(to_torch(jk.reshape(kc.shape))))
        np.testing.assert_array_equal(bits(gv), bits(to_torch(jvv.reshape(vc.shape))))
        # the written rows are the new rows cast; every other byte unchanged
        ref_k, ref_v = to_torch(kc_np), to_torch(vc_np)
        for b, w in enumerate(np.asarray(wpos).tolist()):
            if 0 <= w < S:
                ref_k[l, b, w] = to_torch(kn)[b].to(ref_k.dtype)
                ref_v[l, b, w] = to_torch(vn)[b].to(ref_v.dtype)
        assert torch.equal(bits_t(gk), bits_t(ref_k))
        assert torch.equal(bits_t(gv), bits_t(ref_v))


def bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("B,S,kv", [(1, 512, "bf16"), (3, 1024, "bf16"),
                                    (1, 1024, "f32"), (3, 512, "f32")])
def test_k27_plain_matches_pallas(B, S, kv):
    """K27 at one and two 512-row chunks; slot 0 full, slot 1 empty, slot
    2 inside the first chunk (the TPU kernel skips its later chunks)."""
    rng = np.random.default_rng(B * S)
    H, KV, D = 4, 2, 64
    q, kn, vn = (jnp.asarray(rng.standard_normal(s), jnp.float32)
                 for s in ((B, H, D), (B, KV, D), (B, KV, D)))
    kc, vc = (jnp.asarray(rng.standard_normal((B, S, KV, D)) * 0.5, JDT[kv])
              for _ in range(2))
    pos = jnp.asarray([S - 1, 0, 300][:B], jnp.int32)
    want = jv2.decode_attention_perb_v2(q, kn, vn, kc, vc, pos, interpret=True)
    got = da.decode_attention_perb_v2(*(to_torch(a) for a in (q, kn, vn, kc, vc, pos)))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    _close(got, want, kv)


def test_chunks_follow_the_jax_wrappers():
    """K25 walks min(1024, S) rows a chunk (the JAX wrapper's inline rule),
    K27 min(512, S), each halved until it divides S."""
    for S in (32, 96, 512, 1280, 2048, 4096, 6144):
        c25, c27 = min(1024, S), min(512, S)
        while S % c25:
            c25 //= 2
        while S % c27:
            c27 //= 2
        assert dk.v1_chunk(S) == c25
        assert dk.v1_chunk(S, da.PERB_V2_CHUNK) == c27


def test_wrappers_check_shapes_and_count_nothing_on_cpu():
    q, kn, vn, kc, vc, pos = (to_torch(a) for a in _mk())
    registry.reset_launch_counts()
    dk.decode_attention_stacked(1, q, kn, vn, kc, vc, pos)
    dk.decode_attention_stacked_inplace(1, q, kn, vn, kc, vc, pos)
    da.decode_attention_perb_v2(q, kn, vn, kc[0], vc[0], pos)
    assert all(n == 0 for n in registry.launch_counts().values())
    with pytest.raises(ValueError):                    # a flat stack
        dk.decode_attention_stacked(0, q, kn, vn, kc.flatten(3), vc.flatten(3), pos)
    with pytest.raises(ValueError):                    # layer out of range
        dk.decode_attention_stacked_inplace(3, q, kn, vn, kc, vc, pos)
    with pytest.raises(ValueError):                    # a stack, not one layer
        da.decode_attention_perb_v2(q, kn, vn, kc, vc, pos)
    with pytest.raises(ValueError):                    # neither CPU nor a card
        dk.decode_attention_stacked(0, q.to("meta"), kn, vn, kc, vc, pos)
