"""Sequence parallelism: the prompt's token axis over ranks (the
counterpart of ``bitnet_tpu/parallel/sequence.py:36-107``).

Each rank runs the whole layer stack on its T/n tokens; in every layer the
K/V rows and their positions are all-gathered over the ``seq`` axis, so
causal attention by absolute position sees the whole prefix.  The layer is
the engine's own parameterization (``models/bitnet.block_qkv`` /
``block_finish``: fused q|k|v and the 2B-4T sub-norms included).  The JAX
function returns the sequence-sharded global arrays of one controller;
here each rank returns its chunk.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..errors import ConfigError
from .mesh import Mesh, make_axes, world

SEQ_AXIS = "seq"


def make_seq_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A one-axis ``seq`` mesh over the ranks (the card unless the caller
    asks for the CPU)."""
    _, n = world()
    n_devices = n if n_devices is None else n_devices
    return make_axes([(SEQ_AXIS, n_devices)], device)


def _chunk(cfg: ModelConfig, params, tokens: torch.Tensor, g):
    """This rank's tokens [B, T/n], their positions, and the RoPE rows."""
    B, T = tokens.shape
    if T % g.size != 0:
        raise ConfigError(f"seq len {T} not divisible by {g.size} devices")
    Tl = T // g.size
    tok = tokens[:, g.index * Tl:(g.index + 1) * Tl]
    pos = torch.arange(g.index * Tl, (g.index + 1) * Tl, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, Tl).contiguous()
    from ..models.bitnet import rope_rows

    return tok, pos, *rope_rows(params, pos)


def _prefill(cfg: ModelConfig, params, tokens: torch.Tensor, g, kernel_path: str,
             attend):
    """The layer loop both modes share; ``attend(q, k, v, pos)`` is the
    attention of the rank's queries over the whole key space."""
    from ..models.bitnet import block_finish, block_qkv, embed_tokens
    from ..models.bitnet import logits as model_logits
    from ..ops.rmsnorm import rms_norm

    tok, pos, sin, cos = _chunk(cfg, params, tokens, g)
    x = embed_tokens(params, tok).to(torch.float32)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        q, k, v = block_qkv(cfg, params.blocks, x, sin, cos, kernel_path, l)
        x = block_finish(cfg, params.blocks, x, attend(q, k, v, pos), kernel_path, l)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params.final_norm, cfg.rms_norm_eps)
    return model_logits(cfg, params, x, kernel_path), torch.stack(ks), torch.stack(vs)


def sequence_parallel_prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
                              mesh: Mesh, kernel_path: str = "xla"):
    """Sequence-sharded prefill: ``tokens`` [B, T] (every rank's, T
    divisible by the ``seq`` axis).  Returns this rank's (logits [B, T/n,
    V], k [L, B, T/n, KV, D], v)."""
    from ..ops.attention import attention

    g = mesh.axis(SEQ_AXIS)
    B, T = tokens.shape

    def attend(q, k, v, pos):
        # the whole key space: [B, T, KV, D] and its positions
        return attention(q, g.all_gather(k.contiguous(), dim=1),
                         g.all_gather(v.contiguous(), dim=1), pos,
                         torch.full((B,), T, dtype=torch.int32, device=q.device),
                         kv_positions=g.all_gather(pos, dim=1))
    return _prefill(cfg, params, tokens, g, kernel_path, attend)
