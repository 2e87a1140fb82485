"""Causal GQA attention over a KV buffer — plain PyTorch (XLA einsums in
``bitnet_tpu/ops/attention.py``).

A key slot ``s`` is attendable iff ``s < kv_valid_len`` and
``s <= q_position``.  Q is cast to the cache dtype for the score product
(f32 accumulation), probabilities to V's dtype for the PV product, as the
JAX package does.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor,              # [B, Tq, H, D]
              k: torch.Tensor,              # [B, S, KV, D]
              v: torch.Tensor,              # [B, S, KV, D]
              q_positions: torch.Tensor,    # [B, Tq]
              kv_valid_len: torch.Tensor,   # [B]
              ) -> torch.Tensor:
    B, Tq, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (D ** 0.5)
    qc = q.to(k.dtype).reshape(B, Tq, KV, G, D).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)                      # [B, KV, D, S]
    scores = torch.matmul(qc.float(), kt[:, :, None].float()) * scale
    slot = torch.arange(S, device=q.device, dtype=torch.int32)
    valid = slot[None, None, :] < kv_valid_len[:, None, None]
    causal = slot[None, None, :] <= q_positions[:, :, None]
    mask = (valid & causal)[:, None, None]          # [B, 1, 1, Tq, S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    vt = v.permute(0, 2, 1, 3)[:, :, None]          # [B, KV, 1, S, D]
    out = torch.matmul(p.to(v.dtype).float(), vt.float())   # [B,KV,G,Tq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype)
