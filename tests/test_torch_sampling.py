"""The port's sampler (bitnet_tpu_torch.engine.sampling) against the JAX
package's, transform by transform, on the same logits and history.

The transforms compute in f32 in both packages; softmax, log-softmax and
cumulative sums may differ in their last ulps, so masked results are
compared exactly (masks come from comparisons far from their thresholds
on these random logits) and values to 1e-6 relative.  JAX and torch
random streams differ, so the categorical draw is checked by feeding both
packages the same uniforms: ``jax.random.categorical`` adds
``-log(-log(u))`` with ``u = uniform(key, minval=tiny, maxval=1)``, and
the port's gumbel-max over that ``u`` must pick the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.engine import sampling as js
from bitnet_tpu_torch.config import GenerationConfig
from bitnet_tpu_torch.engine import sampling as ts

B, V, W = 3, 97, 12


def _logits_history(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    hist = rng.integers(0, V, (B, W)).astype(np.int32)
    hist[0, :5] = -1                      # padding
    return logits, hist


def _both(fn_t, fn_j, *args, hist=False, seed=0):
    logits, h = _logits_history(seed)
    a = (torch.from_numpy(logits),) + ((torch.from_numpy(h),) if hist else ())
    b = (jnp.asarray(logits),) + ((jnp.asarray(h),) if hist else ())
    return fn_t(*a, *args).numpy(), np.asarray(fn_j(*b, *args))


@pytest.mark.parametrize("name,args,hist", [
    ("apply_temperature", (0.7,), False),
    ("apply_top_k", (5,), False),
    ("apply_top_k", (0,), False),
    ("apply_top_p", (0.8,), False),
    ("apply_min_p", (0.05,), False),
    ("apply_typical_p", (0.7,), False),
    ("apply_repetition_penalty", (1.3,), True),
    ("apply_presence_frequency", (0.4, 0.6), True),
    ("apply_logit_bias", (((3, 2.5), (7, -100.0), (500, 1.0)),), False),
])
def test_transform_matches_jax(name, args, hist):
    got, want = _both(getattr(ts, name), getattr(js, name), *args, hist=hist,
                      seed=len(name))
    masked_t, masked_j = got <= -1e29, want <= -1e29
    np.testing.assert_array_equal(masked_t, masked_j)
    np.testing.assert_allclose(got[~masked_t], want[~masked_j], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [
    {"greedy": True},
    {"temperature": 0.0},
    {"temperature": 0.8, "top_k": 10, "top_p": 0.9},
    {"temperature": 1.2, "min_p": 0.02, "repetition_penalty": 1.2},
    {"temperature": 1.0, "typical_p": 0.8, "frequency_penalty": 0.3,
     "presence_penalty": 0.2, "logit_bias": ((4, 3.0),)},
])
def test_chain_matches_jax_with_the_same_uniforms(kw):
    logits, hist = _logits_history(7)
    jchain, tchain = js.SamplerChain(JGen(**kw)), ts.SamplerChain(GenerationConfig(**kw))
    np.testing.assert_allclose(
        tchain.transform(torch.from_numpy(logits), torch.from_numpy(hist)).numpy(),
        np.asarray(jchain.transform(jnp.asarray(logits), jnp.asarray(hist))),
        rtol=1e-6, atol=0)
    for s in range(5):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jchain.sample(jnp.asarray(logits), jnp.asarray(hist), key))
        u = np.array(jax.random.uniform(key, (B, V), jnp.float32,
                                          minval=jnp.finfo(jnp.float32).tiny,
                                          maxval=1.0))
        got = tchain.sample_with_uniforms(torch.from_numpy(logits),
                                          torch.from_numpy(hist),
                                          torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(got, want)


def test_seeded_generator_repeats_and_logprobs_match():
    logits, hist = _logits_history(11)
    chain = ts.SamplerChain(GenerationConfig(temperature=1.0, seed=3))
    draws = [chain.sample(torch.from_numpy(logits), torch.from_numpy(hist),
                          torch.Generator().manual_seed(3)).tolist()
             for _ in range(2)]
    assert draws[0] == draws[1]
    lp_t, top_t = ts.logprob_entry(logits[0], 5, 3)
    lp_j, top_j = js.logprob_entry(logits[0], 5, 3)
    assert lp_t == pytest.approx(lp_j, rel=1e-6)
    assert [t for t, _ in top_t] == [t for t, _ in top_j]
