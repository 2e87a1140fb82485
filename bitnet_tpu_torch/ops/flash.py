"""Memory-bounded causal GQA attention for long prefill (online softmax over
KV chunks) — plain PyTorch counterpart of ``bitnet_tpu/ops/flash.py``.

Same result as :func:`ops.attention.attention` up to the order of the
float additions, in O(Tq · chunk) score memory.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor,             # [B, Tq, H, D]
                    k: torch.Tensor,             # [B, S, KV, D]
                    v: torch.Tensor,             # [B, S, KV, D]
                    q_positions: torch.Tensor,   # [B, Tq]
                    kv_valid_len: torch.Tensor,  # [B]
                    chunk: int = 512) -> torch.Tensor:
    B, Tq, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (D ** 0.5)
    qf = q.to(k.dtype).reshape(B, Tq, KV, G, D).permute(0, 2, 3, 1, 4).float()
    m = torch.full((B, KV, G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    d = torch.zeros((B, KV, G, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Tq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        kt = k[:, c0:c1].permute(0, 2, 3, 1)[:, :, None].float()   # [B,KV,1,D,c]
        s = torch.matmul(qf, kt) * scale                         # [B,KV,G,Tq,c]
        slot = torch.arange(c0, c1, device=q.device, dtype=torch.int32)
        mask = ((slot[None, None, :] <= q_positions[:, :, None])
                & (slot[None, None, :] < kv_valid_len[:, None, None]))
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        d = d * alpha + p.sum(dim=-1)
        vt = v[:, c0:c1].permute(0, 2, 1, 3)[:, :, None].float()  # [B,KV,1,c,D]
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vt)
        m = m_new
    out = acc / torch.clamp(d, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype)
