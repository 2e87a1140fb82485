"""Logit transforms and sampling (plain PyTorch on the logits' device).

Counterpart of ``bitnet_tpu/engine/sampling.py:32-234``: every transform
is a ``[B, V] -> [B, V]`` function with the JAX package's semantics, and
:class:`SamplerChain` composes them in its order.  The categorical draw is
gumbel-max over uniforms the caller supplies (:func:`categorical`), as
``jax.random.categorical`` computes it (``argmax(logits − log(−log u))``
with ``u`` in ``[tiny, 1)``), so a test can feed both packages the same
uniforms; the engine draws them from a ``torch.Generator`` seeded by
``GenerationConfig.seed``.  :class:`MirostatState` (v1 and v2,
``:241-284``) truncates one row on its device, draws with the same
gumbel-max and updates ``mu`` on the host, one sync a step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GenerationConfig

NEG_INF = -1e30
TINY = float(torch.finfo(torch.float32).tiny)


# --------------------------------------------------------------------------
# Pure transforms ([B, V] logits -> [B, V] logits)
# --------------------------------------------------------------------------
def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(float(temperature), 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits; ``k <= 0`` disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: the smallest set whose cumulative probability ≥ p
    (always at least the argmax token)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens with prob < min_p * max_prob."""
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < min_p * pmax, NEG_INF, logits)


def apply_typical_p(logits: torch.Tensor, typical_p: float) -> torch.Tensor:
    """Keep the tokens whose surprisal is closest to the entropy, up to
    cumulative mass ``typical_p``."""
    if typical_p >= 1.0:
        return logits
    log_probs = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(log_probs)
    entropy = -(probs * log_probs).sum(dim=-1, keepdim=True)
    dev = torch.abs(-log_probs - entropy)
    order = torch.argsort(dev, dim=-1, stable=True)    # most typical first
    probs_sorted = torch.gather(probs, -1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < typical_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, NEG_INF)


def _history_counts(logits: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """[B, V] counts of each token in the [B, W] history (-1 = padding)."""
    B, V = logits.shape
    hist = torch.where(history < 0, V, history).to(torch.int64)
    counts = torch.zeros((B, V + 1), dtype=logits.dtype, device=logits.device)
    counts.scatter_add_(1, hist, torch.ones_like(hist, dtype=logits.dtype))
    return counts[:, :V]


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Divide positive / multiply negative logits of recent tokens."""
    if penalty == 1.0:
        return logits
    seen = _history_counts(logits, history) > 0
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_presence_frequency(logits: torch.Tensor, history: torch.Tensor,
                             frequency_penalty: float,
                             presence_penalty: float) -> torch.Tensor:
    """``logits -= frequency_penalty * count + presence_penalty * (count > 0)``
    over the recent-history window."""
    if frequency_penalty == 0.0 and presence_penalty == 0.0:
        return logits
    counts = _history_counts(logits, history)
    return (logits - frequency_penalty * counts
            - presence_penalty * (counts > 0).to(logits.dtype))


def logit_bias_vectors(bias: tuple[tuple[int, float], ...], V: int, device
                       ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The bias as dense ``[V]`` f32 additions and a ``[V]`` bool ban mask
    (a value <= -100), on ``device``; None when no id is below V.  Built
    from host lists, so a CUDA graph capture must find them built
    (:meth:`SamplerChain.prepare`)."""
    pairs = [(t, v) for t, v in bias if t < V]
    if not pairs:
        return None
    ids = torch.tensor([t for t, _ in pairs], dtype=torch.int64, device=device)
    vals = torch.tensor([v for _, v in pairs], dtype=torch.float32, device=device)
    vec = torch.zeros((V,), dtype=torch.float32, device=device)
    vec.index_add_(0, ids, vals)
    ban = torch.zeros((V,), dtype=torch.bool, device=device)
    ban[ids] = vals <= -100.0
    return vec, ban


def apply_logit_bias(logits: torch.Tensor,
                     bias: tuple[tuple[int, float], ...],
                     vectors: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """Add per-token biases; a value <= -100 bans the token (OpenAI
    ``logit_bias``).  ``vectors``: :func:`logit_bias_vectors` of ``bias``
    already on the logits' device (else built here)."""
    if vectors is None:
        vectors = logit_bias_vectors(bias, logits.shape[-1], logits.device)
    if vectors is None:
        return logits
    vec, ban = vectors
    return torch.where(ban, NEG_INF, logits + vec)


def argmax(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] → [B] int32; the first maximal index, as ``jnp.argmax``."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def categorical(logits: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw from ``logits`` [B, V] given uniforms [B, V] in
    ``[tiny, 1)``: ``argmax(logits − log(−log u))``, the computation of
    ``jax.random.categorical``."""
    return argmax(logits - torch.log(-torch.log(uniforms)))


def draw_uniforms(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniforms in ``[tiny, 1)`` from ``generator`` (on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u.clamp_(min=TINY)


def logprob_entry(row, tok_id: int, n: int) -> tuple[float, list]:
    """Log-softmax logprob of ``tok_id`` plus the top-``n`` alternatives
    ``[(token_id, logprob)]`` (highest first) from a raw logits row, on the
    host (the model's distribution, before penalties and masks)."""
    row = np.asarray(row, np.float32).reshape(-1)
    m = float(row.max())
    lp = row - (m + np.log(np.exp(row - m).sum()))
    top = []
    if n > 0:
        k = min(n, lp.size)
        idx = np.argpartition(-lp, k - 1)[:k]
        idx = idx[np.argsort(-lp[idx])]
        top = [(int(i), float(lp[i])) for i in idx]
    return float(lp[tok_id]), top


# --------------------------------------------------------------------------
# Sampler chain
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SamplerChain:
    """The JAX package's chain order: logit bias → repetition penalty →
    presence/frequency → (unless greedy) temperature → top-k → top-p →
    min-p → typical-p → categorical, or argmax when greedy."""

    config: GenerationConfig
    # logit_bias_vectors by (V, device): built once a chain, so a step
    # makes no host-to-device copy (none may run inside a CUDA graph)
    _bias: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def prepare(self, V: int, device) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The chain's logit-bias vectors over V logits on ``device``."""
        key = (V, str(torch.device(device)))
        if key not in self._bias:
            self._bias[key] = logit_bias_vectors(self.config.logit_bias, V, device)
        return self._bias[key]

    def transform(self, logits: torch.Tensor, history: torch.Tensor
                  ) -> torch.Tensor:
        c = self.config
        logits = logits.to(torch.float32)
        logits = apply_logit_bias(logits, c.logit_bias,
                                  self.prepare(logits.shape[-1], logits.device))
        logits = apply_repetition_penalty(logits, history, c.repetition_penalty)
        logits = apply_presence_frequency(
            logits, history, c.frequency_penalty, c.presence_penalty)
        if c.is_greedy:
            return logits
        logits = apply_temperature(logits, c.temperature)
        logits = apply_top_k(logits, c.top_k)
        logits = apply_top_p(logits, c.top_p)
        logits = apply_min_p(logits, c.min_p)
        logits = apply_typical_p(logits, c.typical_p)
        return logits

    def sample_with_uniforms(self, logits: torch.Tensor, history: torch.Tensor,
                             uniforms: torch.Tensor | None) -> torch.Tensor:
        """Token ids [B]; ``uniforms`` [B, V] feed the categorical draw
        (unused, and may be None, when greedy)."""
        t = self.transform(logits, history)
        if self.config.is_greedy:
            return argmax(t)
        return categorical(t, uniforms)

    def sample(self, logits: torch.Tensor, history: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """Token ids [B], the uniforms drawn from ``generator``."""
        u = (None if self.config.is_greedy
             else draw_uniforms(logits.shape, generator, logits.device))
        return self.sample_with_uniforms(logits, history, u)


# --------------------------------------------------------------------------
# Mirostat (v1/v2): per-sequence state on the host, the row on its device
# --------------------------------------------------------------------------
@dataclasses.dataclass
class MirostatState:
    """Adaptive-entropy sampling state: the truncation ``mu`` moves toward
    the target surprise ``tau`` after every sampled token.  Each step
    keeps the JAX package's f32 arithmetic: v2 drops the tokens whose
    surprise (bits) exceeds ``mu``; v1 fits a Zipf exponent ``s_hat`` to
    the top 100 log-probs (clipped to [1.01, 10]), derives ``k`` from
    ``mu`` (clipped to [1, V]) and keeps the k largest."""

    tau: float = 5.0
    eta: float = 0.1
    mu: float = 10.0          # 2 * tau by convention
    version: int = 2

    @classmethod
    def from_config(cls, cfg: GenerationConfig) -> "MirostatState":
        return cls(tau=cfg.mirostat_tau, eta=cfg.mirostat_eta,
                   mu=2.0 * cfg.mirostat_tau, version=cfg.mirostat)

    def truncate(self, logp: torch.Tensor) -> torch.Tensor:
        """The log-probs [V] (f32) with the truncated tokens at NEG_INF."""
        f32 = dict(dtype=torch.float32, device=logp.device)
        ln2 = torch.log(torch.tensor(2.0, **f32))
        mu = torch.tensor(self.mu, **f32)
        if self.version == 2:
            return torch.where(-logp / ln2 > mu, NEG_INF, logp)
        V = logp.shape[-1]
        top = torch.topk(logp, min(100, V)).values
        idx = torch.arange(1, top.shape[-1], **f32)
        b = (top[:-1] - top[1:]) / torch.log1p(1.0 / idx)
        s_hat = torch.clamp(torch.mean(b), 1.01, 10.0)
        eps = s_hat - 1.0
        n = torch.tensor(float(V), **f32)
        k = torch.pow(eps * torch.pow(torch.tensor(2.0, **f32), mu)
                      / (1 - torch.pow(n, -eps)), 1.0 / s_hat)
        # jnp's float -> int32 cast saturates (NaN -> 0) before the clip
        k = torch.nan_to_num(k, nan=0.0).clamp(1.0, float(V)).to(torch.int64)
        kth = torch.sort(logp, descending=True).values[k - 1]
        return torch.where(logp < kth, NEG_INF, logp)

    def sample_with_uniforms(self, logits_row: torch.Tensor,
                             uniforms: torch.Tensor) -> int:
        """One token from one row of logits [V] and uniforms [V] in
        ``[tiny, 1)``; updates ``mu`` on the host."""
        logp = torch.log_softmax(logits_row.to(torch.float32), dim=-1)
        masked = self.truncate(logp)
        tok = int(categorical(masked[None], uniforms.reshape(1, -1))[0])
        surprise = float(-logp[tok] / torch.log(torch.tensor(
            2.0, dtype=torch.float32, device=logp.device)))
        self.mu -= self.eta * (surprise - self.tau)
        return tok

    def sample(self, logits_row: torch.Tensor,
               generator: torch.Generator) -> int:
        """:meth:`sample_with_uniforms` over uniforms from ``generator``."""
        return self.sample_with_uniforms(
            logits_row, draw_uniforms(logits_row.shape, generator,
                                      logits_row.device))


# --------------------------------------------------------------------------
# the pooled sampler: one call for a pool of slots, parameters per slot
# --------------------------------------------------------------------------
def _div(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``x / d`` as the chain divides by a Python scalar: on the card
    PyTorch multiplies by the f32 reciprocal, on the CPU it divides."""
    return x * (1.0 / d) if x.is_cuda else x / d


def pooled_sample(raw: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor, min_ps: torch.Tensor, typ_ps: torch.Tensor,
                  rep_pens: torch.Tensor, freq_pens: torch.Tensor,
                  pres_pens: torch.Tensor, bias_rows: torch.Tensor | None,
                  history: torch.Tensor, uniforms: torch.Tensor | None,
                  use_typical: bool = False) -> torch.Tensor:
    """Token ids [B] int32 for a pool: row b is what :class:`SamplerChain`
    gives row b's config (logit bias → repetition penalty → frequency /
    presence → temperature → top-k → top-p → min-p → [typical-p] →
    categorical, or argmax where ``temps[b] <= 0``) with row b's uniforms
    (the scheduler's ``pooled_sample``, ``bitnet_tpu/serve/scheduler.py:
    386-462``).  Every parameter is a [B] tensor; ``bias_rows`` [B, V]
    (None: no bias anywhere; a value <= -100 bans) and ``use_typical`` are
    static.  A parameter at its neutral value leaves its row as the chain's
    skipped step leaves it (penalty 1, p >= 1, min-p 0); one descending
    sort serves top-k and top-p.  ``uniforms`` None: every row greedy."""
    B, V = raw.shape
    lg = raw.to(torch.float32)
    if bias_rows is not None:
        lg = torch.where(bias_rows <= -100.0, NEG_INF, lg + bias_rows)
    counts = _history_counts(lg, history)
    seen = counts > 0
    rp = rep_pens[:, None]
    lg = torch.where(seen, torch.where(lg > 0, _div(lg, rp), lg * rp), lg)
    lg = (lg - freq_pens[:, None] * counts
          - pres_pens[:, None] * seen.to(lg.dtype))
    greedy_tok = argmax(lg)
    if uniforms is None:
        return greedy_tok
    lt = _div(lg, torch.clamp(temps, min=1e-6)[:, None])
    srt = torch.sort(lt, dim=-1, descending=True).values
    k_eff = torch.where((top_ks <= 0) | (top_ks >= V), V, top_ks.clamp(1, V))
    kth = torch.gather(srt, 1, (k_eff - 1).to(torch.int64)[:, None])
    masked_sorted = torch.where(srt < kth, NEG_INF, srt)
    lt = torch.where(lt < kth, NEG_INF, lt)
    probs = torch.softmax(masked_sorted, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_ps[:, None]) | (top_ps >= 1.0)[:, None]
    thr = torch.where(keep, masked_sorted, torch.inf).amin(dim=-1, keepdim=True)
    lt = torch.where(lt < thr, NEG_INF, lt)
    sp = torch.softmax(lt, dim=-1)
    lt = torch.where(sp < min_ps[:, None] * sp.amax(dim=-1, keepdim=True),
                     NEG_INF, lt)
    if use_typical:
        logp = torch.log_softmax(lt, dim=-1)
        p_t = torch.exp(logp)
        ent = -(p_t * logp).sum(dim=-1, keepdim=True)
        order = torch.argsort(torch.abs(-logp - ent), dim=-1, stable=True)
        p_sorted = torch.gather(p_t, -1, order)
        cum_t = torch.cumsum(p_sorted, dim=-1)
        keep_s = ((cum_t - p_sorted) < typ_ps[:, None]) | (typ_ps >= 1.0)[:, None]
        keep_t = torch.zeros_like(keep_s).scatter(-1, order, keep_s)
        lt = torch.where(keep_t, lt, NEG_INF)
    sampled = categorical(lt, uniforms)
    return torch.where(temps <= 0.0, greedy_tok, sampled)
