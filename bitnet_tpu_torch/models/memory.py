"""Device-memory estimate of a model and engine, checked before a load.

Own copy of ``bitnet_tpu/models/memory.py`` (the reference's production
loader gates, ``crates/bitnet-models/src/production_loader.rs:27-140``):
estimate parameter + KV-cache + activation bytes before allocating and
compare them with the card's memory, so a load that cannot fit warns (or
fails) up front instead of dying mid-load in an out-of-memory error.  The
estimate is the JAX package's, byte for byte; the limit is the card's
``total_memory`` where the JAX package reads the TPU's ``bytes_limit``, and
on the CPU (a backend with no limit) the check is skipped.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import EngineConfig, ModelConfig
from ..device_probe import resolve_device
from ..errors import ModelError

_KV_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    param_bytes: int
    kv_cache_bytes: int
    activation_bytes: int
    total_bytes: int

    def as_dict(self) -> dict:
        return {
            "param_bytes": self.param_bytes,
            "kv_cache_bytes": self.kv_cache_bytes,
            "activation_bytes": self.activation_bytes,
            "total_bytes": self.total_bytes,
            "total_gib": round(self.total_bytes / 2**30, 3),
        }


def estimate_memory(cfg: ModelConfig, engine_cfg: EngineConfig | None = None,
                    packed_ternary: bool = True) -> MemoryEstimate:
    """Conservative estimate for one card."""
    e = engine_cfg or EngineConfig()
    H, F, L, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.vocab_size)
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    # matrices per layer: q, k, v, o, gate, up, down
    per_layer = (H * nh * D) + 2 * (H * nkv * D) + (nh * D * H) \
        + 2 * (H * F) + (F * H)
    matrix_elems = L * per_layer
    if packed_ternary:
        matrix_bytes = matrix_elems // 4          # 2-bit packed
    else:
        matrix_bytes = matrix_elems * 2           # bf16 dequant fallback
    embed_bytes = V * H * 2                        # bf16 embeddings
    norm_bytes = (2 * L + 1) * H * 4
    param_bytes = matrix_bytes + embed_bytes + norm_bytes

    S, B = e.max_seq_len, e.max_batch_size
    kv_dtype = e.resolve_kv_cache_dtype()
    kvb = _KV_BYTES[kv_dtype]
    kv_cache_bytes = 2 * L * B * S * nkv * D * kvb
    if kv_dtype in ("int8", "fp8"):
        kv_cache_bytes += 2 * L * B * S * nkv * 4   # f32 scales

    # activations: a few [B, S, max(H, F)] f32 buffers during prefill
    activation_bytes = 6 * B * e.prefill_chunk * max(H, F, V // 4) * 4

    return MemoryEstimate(
        param_bytes=param_bytes,
        kv_cache_bytes=kv_cache_bytes,
        activation_bytes=activation_bytes,
        total_bytes=param_bytes + kv_cache_bytes + activation_bytes,
    )


def device_memory_bytes(device) -> int | None:
    """The card's memory in bytes, or None for the CPU (no limit)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev.index or 0).total_memory


def validate_memory(cfg: ModelConfig, engine_cfg: EngineConfig | None = None,
                    hbm_bytes: int | None = None, strict: bool = False,
                    device="cuda") -> MemoryEstimate:
    """Gate a load against the memory of ``device`` (the card by default,
    as the JAX package checks against the accelerator), or against
    ``hbm_bytes`` when given, which needs no device.  Without CUDA it
    raises unless the caller passes ``device="cpu"`` (no limit, no check).
    strict=False warns, strict=True raises."""
    est = estimate_memory(cfg, engine_cfg)
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(resolve_device(device))
    if hbm_bytes is None:
        return est
    if est.total_bytes > hbm_bytes:
        msg = (f"model needs ~{est.total_bytes / 2**30:.2f} GiB of device "
               f"memory but the device reports {hbm_bytes / 2**30:.2f} GiB "
               f"(params {est.param_bytes / 2**30:.2f} + "
               f"KV {est.kv_cache_bytes / 2**30:.2f} GiB); "
               "shrink max_seq_len/max_batch_size")
        if strict:
            raise ModelError(msg)
        from ..obs.warn_once import warn_once

        warn_once(msg)
    return est
