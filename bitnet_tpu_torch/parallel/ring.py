"""Ring attention: sequence-parallel exact attention with the K/V shards
rotating over the ranks (the counterpart of
``bitnet_tpu/parallel/ring.py:26-127``).

Each rank holds one shard of keys and values; n − 1 ring shifts
(``comm.Group.ring_shift``, the JAX ``ppermute``) bring it every other
shard, and an online-softmax accumulator folds in one shard a step, so a
rank never holds the whole key space.  Plain torch, as the JAX version is
plain JAX.
"""

from __future__ import annotations

import torch

from .mesh import Mesh
from .sequence import SEQ_AXIS, _prefill

NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor, kv_positions: torch.Tensor,
                         group) -> torch.Tensor:
    """Exact causal GQA attention of the local queries q [B, Tl, H, D]
    (positions [B, Tl]) over every rank's keys, the local shard k, v
    [B, Tl, KV, D] (positions [B, Tl]) rotating around ``group``.  Scores
    and the accumulator in f32; returns [B, Tl, H, D] in q's dtype."""
    n = group.size
    B, Tl, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / (D ** 0.5)
    qf = q.to(k.dtype).reshape(B, Tl, KV, G, D).to(torch.float32)
    m = torch.full((B, KV, G, Tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Tl, D), dtype=torch.float32, device=q.device)
    kt, vt, kp = k.contiguous(), v.contiguous(), kv_positions.contiguous()
    for step in range(n):
        s = torch.einsum("btkgd,bckd->bkgtc", qf, kt.to(torch.float32)) * scale
        mask = kp[:, None, :] <= q_positions[:, :, None]          # [B, Tl, c]
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgtc,bckd->bkgtd", p.to(vt.dtype).to(torch.float32), vt.to(torch.float32))
        m = m_new
        if step < n - 1:             # the next rank's shard
            kt, vt, kp = group.ring_shift(kt), group.ring_shift(vt), group.ring_shift(kp)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, Tl, H, D).to(q.dtype)


def ring_parallel_prefill(cfg, params, tokens: torch.Tensor, mesh: Mesh,
                          kernel_path: str = "xla"):
    """Sequence-sharded prefill with ring attention (the alternative to
    ``sequence.sequence_parallel_prefill``'s all-gathered K/V): ``tokens``
    [B, T] every rank's, T divisible by the ``seq`` axis.  Returns this
    rank's (logits [B, T/n, V], k [L, B, T/n, KV, D], v)."""
    g = mesh.axis(SEQ_AXIS)
    return _prefill(cfg, params, tokens, g, kernel_path,
                    lambda q, k, v, pos: ring_attention_local(q, k, v, pos, pos, g))
