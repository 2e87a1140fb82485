"""RMSNorm (plain PyTorch; XLA in the JAX package, ``bitnet_tpu/ops/rmsnorm.py``).

``y = x * rsqrt(mean(x^2) + eps) * w``, reduced in float32, result in
``x.dtype``.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)
