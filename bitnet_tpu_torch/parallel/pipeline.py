"""Pipeline parallelism: layer stages over ranks, GPipe microbatching (the
counterpart of ``bitnet_tpu/parallel/pipeline.py:44-260``).

:func:`plan_stages` assigns layers to stages (``uniform``,
``weight_balanced``, ``cost``).  :func:`shard_pipeline_params` keeps a
stage's layers of the stacked blocks (the rest replicated), and
:func:`pipeline_forward` runs the GPipe schedule: M microbatches over S
stages in M + S − 1 ticks; at tick t stage s works on microbatch t − s when
there is one, its activations go to stage s + 1 by the ring shift
(``comm.Group.ring_shift``, the JAX ``ppermute``), and a stage writes its
layers' KV rows only on the ticks it was active.  The JAX package runs the
schedule in one ``shard_map`` on one controller; here every rank runs it on
its own stage.  The last stage's hidden states are broadcast over the
stages, so every rank returns the logits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..errors import ConfigError
from .mesh import Mesh, make_axes, world

STAGE_AXIS = "stage"


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Layer ranges per stage: stage i owns layers [bounds[i], bounds[i+1])."""

    num_stages: int
    bounds: tuple[int, ...]

    @property
    def layers_per_stage(self) -> list[int]:
        return [self.bounds[i + 1] - self.bounds[i]
                for i in range(self.num_stages)]


def plan_stages(cfg: ModelConfig, num_stages: int, strategy: str = "uniform",
                layer_costs: list[float] | None = None) -> StagePlan:
    """Assign layers to stages (``:59-102``): ``uniform`` equal counts (the
    first L mod S stages one more); ``weight_balanced`` uniform unless
    ``layer_costs`` is given (BitNet blocks are identical); ``cost``
    balances ``layer_costs``, closing a stage once its share is reached."""
    L = cfg.num_layers
    if num_stages < 1 or num_stages > L:
        raise ConfigError(f"num_stages {num_stages} not in [1, {L}]")
    if strategy not in ("uniform", "weight_balanced", "cost"):
        raise ConfigError(f"unknown stage strategy {strategy!r}")
    if strategy == "uniform" or layer_costs is None:
        base, rem = divmod(L, num_stages)
        sizes = [base + (1 if i < rem else 0) for i in range(num_stages)]
    else:
        if len(layer_costs) != L:
            raise ConfigError("layer_costs length != num_layers")
        target = sum(layer_costs) / num_stages
        sizes, acc, count = [], 0.0, 0
        for c in layer_costs:
            acc += c
            count += 1
            if acc >= target and len(sizes) < num_stages - 1:
                sizes.append(count)
                acc, count = 0.0, 0
        sizes.append(count)
        while len(sizes) < num_stages:
            sizes.append(0)
    bounds = [0]
    for sz in sizes:
        bounds.append(bounds[-1] + sz)
    if 0 in sizes:
        raise ConfigError(
            f"stage plan has an empty stage: {sizes} (reduce num_stages)")
    return StagePlan(num_stages=num_stages, bounds=tuple(bounds))


def make_pipeline_mesh(num_stages: int | None = None, device="cuda") -> Mesh:
    """A one-axis ``stage`` mesh over the ranks (every rank a stage; the
    card unless the caller asks for the CPU)."""
    _, n = world()
    num_stages = n if num_stages is None else num_stages
    if num_stages != n:
        raise ConfigError(f"{num_stages} stages need {num_stages} ranks, have {n}")
    return make_axes([(STAGE_AXIS, num_stages)], device)


def _layers(t, lo: int, hi: int):
    if t is None:
        return None
    if hasattr(t, "packed") or hasattr(t, "weight"):       # a stacked linear
        return dataclasses.replace(t, **{
            f: _layers(getattr(t, f), lo, hi) for f in ("packed", "scales",
                                                       "col_scales", "weight")
            if getattr(t, f) is not None and getattr(t, f).ndim >= 1})
    return t[lo:hi].contiguous()


def shard_pipeline_params(mesh: Mesh, cfg: ModelConfig, params,
                          plan: StagePlan | None = None):
    """This stage's layers of the stacked blocks (``plan``, uniform by
    default: the JAX ``P(stage)`` on the leading axis); embedding, norms,
    RoPE tables and the head replicated."""
    g = mesh.axis(STAGE_AXIS)
    plan = plan or plan_stages(cfg, g.size)
    if plan.num_stages != g.size:
        raise ConfigError(f"plan of {plan.num_stages} stages on {g.size} ranks")
    lo, hi = plan.bounds[g.index], plan.bounds[g.index + 1]
    b = params.blocks
    blocks = dataclasses.replace(b, **{
        f.name: _layers(getattr(b, f.name), lo, hi) for f in dataclasses.fields(b)})
    return dataclasses.replace(params, blocks=blocks)


def pipeline_forward(cfg: ModelConfig, params, tokens: torch.Tensor,
                     q_positions: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_valid_len: torch.Tensor, mesh: Mesh,
                     num_microbatches: int, kernel_path: str = "xla"):
    """Pipelined forward (``:163-260``): returns (logits [B, T, V], k_cache,
    v_cache).  ``params`` are this stage's (:func:`shard_pipeline_params`),
    ``k_cache`` / ``v_cache`` its layers' flat cache [L_s, B, S, KV*D]
    (bf16 or f32), written in place; ``tokens`` / ``q_positions`` [B, T]
    and ``kv_valid_len`` [B] are every stage's.  ``B`` must be divisible by
    ``num_microbatches``."""
    from ..models.bitnet import embed_tokens, logits as model_logits, rope_rows, run_layers
    from ..ops.rmsnorm import rms_norm

    g = mesh.axis(STAGE_AXIS)
    B, T = tokens.shape
    M = num_microbatches
    if B % M != 0:
        raise ConfigError(f"batch {B} not divisible by microbatches {M}")
    mb = B // M
    n_st, stage = g.size, g.index
    H = cfg.hidden_size
    x_all = embed_tokens(params, tokens).to(torch.float32)
    dev = x_all.device
    x_buf = torch.zeros((mb, T, H), dtype=torch.float32, device=dev)
    out = torch.zeros((M, mb, T, H), dtype=torch.float32, device=dev)
    for t in range(M + n_st - 1):
        m = t - stage                  # the microbatch this stage works on
        y = torch.zeros_like(x_buf)
        if 0 <= m < M:
            rows = slice(m * mb, (m + 1) * mb)
            x_cur = x_all[rows] if stage == 0 else x_buf
            y = run_layers(cfg, params, x_cur, q_positions[rows], k_cache[:, rows],
                           v_cache[:, rows], kv_valid_len[rows],
                           *rope_rows(params, q_positions[rows]), kernel_path)
            if stage == n_st - 1:
                out[m] = y
        # to the next stage (the ring's last → 0 hand-off is ignored)
        x_buf = g.ring_shift(y.contiguous())
    hidden = g.broadcast(out, src=n_st - 1).reshape(B, T, H)
    hidden = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    return model_logits(cfg, params, hidden, kernel_path), k_cache, v_cache
