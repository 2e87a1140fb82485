"""Typed configuration for bitnet_tpu_torch.

The counterpart of ``bitnet_tpu/config.py``, holding only the fields the
ported slice reads.  Values the JAX package accepts but the port does
not run yet raise ``NotImplementedError`` naming the ROADMAP queue item
that ports them, so no configuration silently lands on a path that does
not exist here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

from .errors import ConfigError


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to bitnet_tpu_torch yet "
        f"(ROADMAP.md queue 1 {item})")


@dataclass(frozen=True)
class ModelConfig:
    """Transformer hyperparameters (mirror of bitnet_tpu.config.ModelConfig)."""

    vocab_size: int = 32000
    hidden_size: int = 2560
    intermediate_size: int = 6912
    num_layers: int = 30
    num_heads: int = 20
    num_kv_heads: int = 5
    head_dim: int = 128
    max_seq_len: int = 4096
    rope_base: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    architecture: str = "bitnet-b1.58"
    hidden_act: str = "silu"
    use_sub_norm: bool = False

    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ConfigError(
                f"num_heads ({self.num_heads}) must be divisible by "
                f"num_kv_heads ({self.num_kv_heads})")
        if self.head_dim <= 0 or self.hidden_size <= 0:
            raise ConfigError("head_dim and hidden_size must be positive")

    @property
    def gqa_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def validate(self) -> None:
        if self.vocab_size <= 0:
            raise ConfigError("vocab_size must be positive")
        if self.num_layers <= 0:
            raise ConfigError("num_layers must be positive")
        if self.max_seq_len <= 0:
            raise ConfigError("max_seq_len must be positive")

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GenerationConfig:
    """Decoding parameters.  The slice decodes greedily only (the full
    SamplerChain is ROADMAP queue 1 #5), so greedy is the default and the
    only accepted value."""

    max_new_tokens: int = 128
    greedy: bool = True
    stop_token_ids: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.max_new_tokens <= 0:
            raise ConfigError("max_new_tokens must be positive")
        if not self.greedy:
            raise _not_ported("sampling other than greedy", "#5")


@dataclass(frozen=True)
class EngineConfig:
    """Runtime engine knobs (mirror of bitnet_tpu.config.EngineConfig).

    ``kernel_path='auto'`` means ``w2a8`` here on every device: the W2A8
    kernels are the only matmul route the port has (their plain PyTorch
    versions run for CPU tensors).  ``fuse_projections`` defaults to True
    because only the fused stacked path is ported."""

    max_seq_len: int = 2048
    max_batch_size: int = 1
    kv_cache_dtype: str = "bf16"     # 'auto' | 'bf16' (int8/fp8/f32: #8)
    kernel_path: str = "auto"        # 'auto' | 'w2a8' (pallas/xla: #7)
    compute_dtype: str = "bf16"      # 'bf16' | 'f32'
    logits_dtype: str = "auto"       # 'auto' | 'bf16' | 'int8' tied head
    fuse_projections: bool = True    # False = unfused generic path (#7)
    weight_quant: str = "none"       # 'tl1' / 'tl2' (#10)
    sliding_window: int = 0          # windowed ring cache (#7)

    def resolve_kv_cache_dtype(self) -> str:
        """'auto' follows the JAX package's rule (int8 for pools or long
        contexts, bf16 otherwise)."""
        if self.kv_cache_dtype != "auto":
            return self.kv_cache_dtype
        if self.max_batch_size > 2:
            return "int8"
        return "int8" if self.max_seq_len >= 4096 else "bf16"

    @property
    def resolved_kernel_path(self) -> str:
        return "w2a8" if self.kernel_path == "auto" else self.kernel_path

    def __post_init__(self) -> None:
        if self.kv_cache_dtype not in ("auto", "bf16", "f32", "int8", "fp8"):
            raise ConfigError(f"bad kv_cache_dtype {self.kv_cache_dtype!r}")
        if self.kernel_path not in ("auto", "w2a8", "pallas", "xla"):
            raise ConfigError(f"bad kernel_path {self.kernel_path!r}")
        if self.compute_dtype not in ("bf16", "f32"):
            raise ConfigError(f"bad compute_dtype {self.compute_dtype!r}")
        if self.logits_dtype not in ("auto", "bf16", "int8"):
            raise ConfigError(f"bad logits_dtype {self.logits_dtype!r}")
        if self.weight_quant not in ("none", "tl1", "tl2"):
            raise ConfigError(f"bad weight_quant {self.weight_quant!r}")
        if self.sliding_window < 0:
            raise ConfigError("sliding_window must be >= 0")
        if self.max_batch_size < 1 or self.max_seq_len < 1:
            raise ConfigError("max_batch_size and max_seq_len must be >= 1")
        # valid in the JAX package, not ported yet
        if self.resolved_kernel_path != "w2a8":
            raise _not_ported(f"kernel_path={self.kernel_path!r}", "#7")
        if not self.fuse_projections:
            raise _not_ported("the unfused per-layer path", "#7")
        if self.sliding_window > 0:
            raise _not_ported("the windowed ring cache", "#7")
        if self.weight_quant != "none":
            raise _not_ported(f"weight_quant={self.weight_quant!r}", "#10")
        kv = self.resolve_kv_cache_dtype()
        if kv != "bf16":
            raise _not_ported(f"a {kv} KV cache", "#8")
        # the decode-attention plan is the one shared predicate the model
        # dispatches on too (models/bitnet.decode_attn_plan)
        from .models.bitnet import PORTED_PLANS, decode_attn_plan

        plan = decode_attn_plan(self.max_batch_size, kv)
        if plan not in PORTED_PLANS:
            raise _not_ported(
                f"decode pools of B={self.max_batch_size} (plan {plan})",
                "#9")

    def replace(self, **kw: Any) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
