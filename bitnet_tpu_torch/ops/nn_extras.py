"""General NN op set (plain PyTorch).

Counterpart of ``bitnet_tpu/ops/nn_extras.py``: thin functions with the
reference op catalog's semantics (embedding, transpose, scatter / gather,
layer norm, conv2d in NHWC / HWIO, pooling, losses, reductions), so the
surface is explicit and testable.  None is on a model path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# -- embedding / transpose / scatter-gather ----------------------------------
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.to(torch.int64)]


def transpose(x: torch.Tensor, axes: tuple[int, ...] | None = None) -> torch.Tensor:
    return x.permute(*(axes if axes is not None else reversed(range(x.ndim))))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.to(torch.int64)]


def scatter_rows(x: torch.Tensor, idx: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[idx.to(torch.int64)] = updates.to(x.dtype)
    return out


# -- layer norm ---------------------------------------------------------------
def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


# -- conv / pooling (NHWC activations, HWIO kernels) --------------------------
def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x: [N, H, W, C_in]; w: [KH, KW, C_in, C_out].  ``SAME`` pads as XLA
    does (the extra row / column at the end)."""
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if padding == "SAME":
        pads = []
        for size, k in ((xn.shape[3], wn.shape[3]), (xn.shape[2], wn.shape[2])):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        xn = F.pad(xn, pads)
    elif padding != "VALID":
        raise ValueError(f"bad padding {padding!r}")
    return F.conv2d(xn, wn, stride=stride).permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


# -- losses / reductions -------------------------------------------------------
def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logits [N, V], targets [N] int."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, targets[:, None].to(torch.int64)).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.to(torch.float32) - b.to(torch.float32)) ** 2).mean()


def reduce_sum(x, axis=None):
    return x.sum() if axis is None else x.sum(dim=axis)


def reduce_max(x, axis=None):
    return x.max() if axis is None else x.amax(dim=axis)


def reduce_mean(x, axis=None):
    return x.mean() if axis is None else x.mean(dim=axis)


def cumsum(x, axis=-1):
    return torch.cumsum(x, dim=axis)
