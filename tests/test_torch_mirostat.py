"""The port's Mirostat (``engine.sampling.MirostatState``, v1 and v2)
against the JAX package's.

JAX and torch random streams differ, so both packages draw from the same
uniforms: ``jax.random.categorical`` adds ``-log(-log(u))`` with ``u =
uniform(key, (V,), minval=tiny, maxval=1)``, and the port's
``sample_with_uniforms`` takes that ``u``.  One logits row, 20 steps of
keys split from seed 0: the tokens must be equal and ``mu`` equal within
1e-5 relative (both update it in Python floats from an f32 surprise; the
log-softmax may differ in its last ulp).  The engine's Mirostat path is
checked for its seed, its min-phase ban of EOS and its ``mu`` arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnet_tpu.engine.sampling import MirostatState as JMirostat
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine import MirostatState
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.engine.sampling import TINY

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

V = 1000


def _row(seed, scale):
    return (np.random.default_rng(seed).standard_normal(V) * scale).astype(np.float32)


@pytest.mark.parametrize("version,tau,scale", [(2, 5.0, 3.0), (2, 3.0, 1.5),
                                               (1, 5.0, 3.0), (1, 3.0, 1.5)])
def test_mirostat_matches_jax_with_the_same_uniforms(version, tau, scale):
    row = _row(version * 10 + int(tau), scale)
    j = JMirostat(tau=tau, eta=0.1, mu=2 * tau, version=version)
    t = MirostatState.from_config(GenerationConfig(mirostat=version, mirostat_tau=tau,
                                                   mirostat_eta=0.1))
    assert (t.tau, t.eta, t.mu, t.version) == (j.tau, j.eta, j.mu, j.version)
    key = jax.random.PRNGKey(0)
    toks = []
    for _ in range(20):
        key, sub = jax.random.split(key)
        u = np.array(jax.random.uniform(sub, (V,), jnp.float32, minval=TINY,
                                        maxval=1.0))
        want = j.sample(jnp.asarray(row), sub)
        got = t.sample_with_uniforms(torch.from_numpy(row), torch.from_numpy(u))
        assert got == want
        assert t.mu == pytest.approx(j.mu, rel=1e-5)
        toks.append(got)
    assert len(set(toks)) > 1               # the draws are not all the argmax


@pytest.mark.parametrize("version", [1, 2])
def test_truncation_keeps_what_jax_keeps(version):
    """The truncated log-probs of one step at several ``mu``: the same
    tokens kept, the same values (f32, 1e-6 relative)."""
    row = _row(3, 2.0)
    for mu in (1.0, 4.0, 9.0, 17.0, 40.0):
        t = MirostatState(tau=5.0, eta=0.1, mu=mu, version=version)
        logp = torch.log_softmax(torch.from_numpy(row), dim=-1)
        got = t.truncate(logp).numpy()
        jlogp = jax.nn.log_softmax(jnp.asarray(row))
        if version == 2:
            want = np.asarray(jnp.where(-jlogp / jnp.log(2.0) > mu, -1e30, jlogp))
        else:
            top = jax.lax.top_k(jlogp, 100)[0]
            idx = jnp.arange(1, 100, dtype=jnp.float32)
            s_hat = jnp.clip(jnp.mean((top[:-1] - top[1:]) / jnp.log1p(1.0 / idx)),
                             1.01, 10.0)
            eps = s_hat - 1.0
            k = jnp.power((eps * jnp.power(2.0, mu)) / (1 - jnp.power(V, -eps)),
                          1.0 / s_hat)
            kth = jax.lax.top_k(jlogp, V)[0][jnp.clip(k.astype(jnp.int32), 1, V) - 1]
            want = np.asarray(jnp.where(jlogp < kth, -1e30, jlogp))
        np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
        keep = want > -1e29
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def engine(mini_gguf_qk256):
    return InferenceEngine.from_gguf(
        mini_gguf_qk256.path, EngineConfig(max_seq_len=128, compute_dtype="f32",
                                           kv_cache_dtype="f32", kernel_path="xla"),
        device="cpu")


@pytest.mark.parametrize("version", [1, 2])
def test_engine_mirostat_repeats_and_tracks_mu(engine, monkeypatch, version):
    """A seeded Mirostat request repeats; each step's ``mu`` is the last
    one less ``eta * (surprise - tau)``, the surprise recomputed from the
    logits row the step sampled from."""
    gc = GenerationConfig(max_new_tokens=12, mirostat=version, mirostat_tau=4.0,
                          seed=3)
    a = engine.generate([1, 7, 20, 3], gc).token_ids
    seen = []
    real = MirostatState.sample_with_uniforms

    def spy(self, row, u):
        mu0 = self.mu
        tok = real(self, row, u)
        lp = torch.log_softmax(row.float(), -1)[tok]
        seen.append((mu0, self.mu, float(-lp / np.log(2.0)), self.tau, self.eta))
        return tok

    monkeypatch.setattr(MirostatState, "sample_with_uniforms", spy)
    b = engine.generate([1, 7, 20, 3], gc).token_ids
    assert a == b and len(seen) >= len(b) > 0
    for mu0, mu1, s, tau, eta in seen:
        assert mu1 == pytest.approx(mu0 - eta * (s - tau), rel=1e-5)


def test_engine_mirostat_bans_eos_in_the_min_phase(engine, monkeypatch):
    """Logits where EOS dominates: Mirostat stops at once; under
    min_new_tokens EOS is banned from its row and that many tokens come
    first."""
    eos = engine.tokenizer.eos_token_id
    lg = torch.from_numpy(_row(5, 1.0)[:engine.cfg.vocab_size].copy())[None]
    lg[0, eos] = 60.0
    monkeypatch.setattr(engine, "prefill", lambda ids: lg.clone())
    monkeypatch.setattr(engine, "decode_step", lambda tok, pos: lg.clone())
    gc = GenerationConfig(max_new_tokens=8, mirostat=2, seed=1)
    assert engine.generate([1, 7, 20, 3], gc).token_ids == []
    r = engine.generate([1, 7, 20, 3], gc.replace(min_new_tokens=3))
    assert len(r.token_ids) == 3 and eos not in r.token_ids


@pytest.mark.parametrize("version", [1, 2])
def test_engine_mirostat_on_the_f32_mini_repeats(mini_gguf_f32, version):
    """The F32 mini GGUF (dense linears): a seeded Mirostat request at f32
    repeats, and its tokens stay inside the vocab."""
    eng = InferenceEngine.from_gguf(
        mini_gguf_f32.path, EngineConfig(max_seq_len=128, compute_dtype="f32",
                                         kv_cache_dtype="f32", kernel_path="xla"),
        device="cpu")
    gc = GenerationConfig(max_new_tokens=12, mirostat=version, mirostat_tau=4.0, seed=3)
    a = eng.generate([1, 7, 20, 3], gc).token_ids
    assert a == eng.generate([1, 7, 20, 3], gc).token_ids
    assert 0 < len(a) and max(a) < eng.cfg.vocab_size
