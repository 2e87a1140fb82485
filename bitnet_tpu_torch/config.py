"""Typed configuration for bitnet_tpu_torch.

The counterpart of ``bitnet_tpu/config.py``, holding the fields the
ported slices read, with the JAX package's defaults.  Values the JAX
package accepts but the port does not run yet raise
``NotImplementedError`` naming the ROADMAP queue item that ports them,
so no configuration silently lands on a path that does not exist here.
"""

from __future__ import annotations

import dataclasses
import operator
from dataclasses import dataclass, field
from typing import Any

from .errors import ConfigError


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to bitnet_tpu_torch yet "
        f"(ROADMAP.md queue 1 {item})")


@dataclass(frozen=True)
class StrictMode:
    """Honest-compute guard flags (mirror of bitnet_tpu.config.StrictMode,
    without its environment overrides)."""

    enabled: bool = False
    allow_mock: bool = True       # mock tokenizer allowed?
    # the XLA dequant fallback allowed? (the port's engine reads no flag
    # of strict mode but ``deterministic``)
    allow_fallback: bool = True
    deterministic: bool = False   # seed 0 when the request names none


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
    """Sampling / decoding parameters (mirror of
    bitnet_tpu.config.GenerationConfig, same defaults and checks)."""

    max_new_tokens: int = 128
    # suppress EOS / stop triggers (and ban the EOS logit) until this
    # many tokens are emitted (vLLM min_tokens)
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_k: int = 0                 # 0 = disabled
    top_p: float = 1.0             # 1.0 = disabled
    min_p: float = 0.0             # 0.0 = disabled
    typical_p: float = 1.0         # 1.0 = disabled
    repetition_penalty: float = 1.0
    repetition_window: int = 64
    frequency_penalty: float = 0.0  # OpenAI-style: -= count * penalty
    presence_penalty: float = 0.0   # OpenAI-style: -= (count > 0) * penalty
    logit_bias: tuple[tuple[int, float], ...] = ()  # (token_id, bias) pairs
    mirostat: int = 0              # 0 = off, 1 / 2 = Mirostat v1 / v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    seed: int | None = None
    greedy: bool = False
    stop_sequences: tuple[str, ...] = ()
    stop_token_ids: tuple[int, ...] = ()
    add_bos: bool = True
    grammar: str | None = None     # GBNF source (constrained decoding)
    # None = off; N >= 0 = the sampled token's log-probability plus the
    # top-N alternatives per step, from the raw model distribution
    logprobs: int | None = None

    def __post_init__(self) -> None:
        if self.max_new_tokens <= 0:
            raise ConfigError("max_new_tokens must be positive")
        if not isinstance(self.min_new_tokens, int) \
                or isinstance(self.min_new_tokens, bool) \
                or not (0 <= self.min_new_tokens <= self.max_new_tokens):
            raise ConfigError(
                "min_new_tokens must be an int in [0, max_new_tokens]")
        if self.temperature < 0.0:
            raise ConfigError("temperature must be >= 0")
        if not (0.0 <= self.top_p <= 1.0):
            raise ConfigError("top_p must be in [0, 1]")
        if self.top_k < 0:
            raise ConfigError("top_k must be >= 0")
        if self.repetition_penalty <= 0.0:
            raise ConfigError("repetition_penalty must be > 0")
        if self.mirostat not in (0, 1, 2):
            raise ConfigError("mirostat must be 0, 1 or 2")
        for p, name in ((self.frequency_penalty, "frequency_penalty"),
                        (self.presence_penalty, "presence_penalty")):
            if not (-2.0 <= p <= 2.0):
                raise ConfigError(f"{name} must be in [-2, 2]")
        if not isinstance(self.logit_bias, tuple):
            # accept dict / list at the call site, store hashably
            object.__setattr__(
                self, "logit_bias",
                tuple(sorted(dict(self.logit_bias).items())))
        for tok, _b in self.logit_bias:
            if not isinstance(tok, int) or tok < 0:
                raise ConfigError("logit_bias keys must be token ids >= 0")
        if self.grammar is not None and not isinstance(self.grammar, str):
            raise ConfigError("grammar must be GBNF source text")
        if self.grammar == "":
            object.__setattr__(self, "grammar", None)
        if self.logprobs is not None and not (
                isinstance(self.logprobs, int) and 0 <= self.logprobs <= 32):
            raise ConfigError("logprobs must be None or an int in [0, 32]")
        if self.seed is not None:
            try:
                object.__setattr__(self, "seed", operator.index(self.seed))
            except TypeError:
                raise ConfigError("seed must be an integer") from None
        for s in self.stop_sequences:
            if not isinstance(s, str):
                raise ConfigError("stop_sequences must be strings")

    @property
    def is_greedy(self) -> bool:
        return self.greedy or self.temperature == 0.0

    def replace(self, **kw: Any) -> "GenerationConfig":
        return dataclasses.replace(self, **kw)


def resolve_kernel_path(kernel_path: str, device) -> str:
    """``'auto'`` → ``w2a8`` on the card and ``xla`` (dequantize, then a
    plain matmul) elsewhere: the JAX package's ``_resolve_kernel_path``
    (``engine/engine.py:197-205``) with the card in the TPU's place."""
    if kernel_path != "auto":
        return kernel_path
    return "w2a8" if getattr(device, "type", device) == "cuda" else "xla"


@dataclass(frozen=True)
class EngineConfig:
    """Runtime engine knobs (mirror of bitnet_tpu.config.EngineConfig,
    same defaults).  The engine resolves ``kernel_path='auto'`` against
    its device (:func:`resolve_kernel_path`)."""

    max_seq_len: int = 2048
    max_batch_size: int = 1
    kv_cache_dtype: str = "bf16"     # 'auto' | 'bf16' | 'f32' | 'int8' | 'fp8'
    kernel_path: str = "auto"        # 'auto' | 'w2a8' | 'pallas' | 'xla'
    compute_dtype: str = "bf16"      # 'bf16' | 'f32'
    logits_dtype: str = "auto"       # 'auto' | 'bf16' | 'int8' tied head
    # the JAX package's prefill bucketing granularity and XLA buffer
    # donation: the port buckets by powers of two and updates the cache in
    # place, so neither changes what runs on the card
    prefill_chunk: int = 512
    donate_cache: bool = True
    prefix_cache_tokens: int = 0     # prompt-prefix KV cache (0 = off)
    fuse_projections: bool = False   # True = the fused stacked path
    weight_quant: str = "none"       # 'tl1' / 'tl2': re-quantize to TL at init
    # decode tokens per host round trip in generate_stream (engine/loop.py:
    # one CUDA graph of K steps on the card; tokens equal K=1's).
    # 0 = auto: 8 on the card, 1 on the CPU
    decode_steps_per_dispatch: int = 0
    # at pos >= max_seq_len: 'shift' keeps the last half of the context and
    # re-prefills, 'stop' ends generation with StopReason.CONTEXT_FULL
    context_overflow: str = "shift"
    # > 0: the windowed ring cache of this many rows (engine/windowed_cache.py)
    sliding_window: int = 0
    strict: StrictMode = field(default_factory=StrictMode)

    def resolve_kv_cache_dtype(self) -> str:
        """'auto' follows the JAX package's rule (bf16 under a sliding
        window, int8 for pools or long contexts, bf16 otherwise)."""
        if self.kv_cache_dtype != "auto":
            return self.kv_cache_dtype
        if self.sliding_window > 0:
            return "bf16"
        if self.max_batch_size > 2:
            return "int8"
        return "int8" if self.max_seq_len >= 4096 else "bf16"

    def __post_init__(self) -> None:
        if self.kv_cache_dtype not in ("auto", "bf16", "f32", "int8", "fp8"):
            raise ConfigError(f"bad kv_cache_dtype {self.kv_cache_dtype!r}")
        if self.context_overflow not in ("shift", "stop"):
            raise ConfigError(f"bad context_overflow {self.context_overflow!r}")
        if self.kernel_path not in ("auto", "w2a8", "pallas", "xla"):
            raise ConfigError(f"bad kernel_path {self.kernel_path!r}")
        if self.compute_dtype not in ("bf16", "f32"):
            raise ConfigError(f"bad compute_dtype {self.compute_dtype!r}")
        if self.logits_dtype not in ("auto", "bf16", "int8"):
            raise ConfigError(f"bad logits_dtype {self.logits_dtype!r}")
        if self.weight_quant not in ("none", "tl1", "tl2"):
            raise ConfigError(f"bad weight_quant {self.weight_quant!r}")
        if self.decode_steps_per_dispatch < 0:
            raise ConfigError("decode_steps_per_dispatch must be >= 0")
        if self.sliding_window < 0:
            raise ConfigError("sliding_window must be >= 0")
        if self.sliding_window > 0:
            # bitnet_tpu/config.py:307-325
            if self.sliding_window < 16:
                raise ConfigError("sliding_window must be >= 16 tokens")
            if self.sliding_window > self.max_seq_len:
                raise ConfigError(
                    "sliding_window exceeds max_seq_len (a window wider "
                    "than the stream bound is just a dense cache)")
            if self.prefix_cache_tokens > 0:
                raise ConfigError(
                    "prefix_cache_tokens requires the dense cache "
                    "(prefix snapshots are position-indexed slices)")
            if self.kv_cache_dtype in ("int8", "fp8"):
                raise ConfigError(
                    "sliding_window supports bf16/f32 KV only (the ring "
                    "rides the generic attention path)")
        if self.max_batch_size < 1 or self.max_seq_len < 1:
            raise ConfigError("max_batch_size and max_seq_len must be >= 1")

    def replace(self, **kw: Any) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
