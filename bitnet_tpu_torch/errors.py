"""Error taxonomy for bitnet_tpu_torch (a copy of bitnet_tpu/errors.py: the
port imports nothing of the JAX package).

Mirrors the capability of the reference error taxonomy
(``crates/bitnet-common/src/error.rs``) with a Python-idiomatic exception
hierarchy instead of a Result enum.
"""

from __future__ import annotations


class BitNetError(Exception):
    """Base class for every error raised by bitnet_tpu_torch."""


class ConfigError(BitNetError):
    """Invalid model / engine / generation configuration."""


class ModelError(BitNetError):
    """Model loading or format errors (GGUF / SafeTensors)."""


class FormatError(ModelError):
    """A file failed structural validation (bad magic, truncated, ...)."""


class QuantizationError(BitNetError):
    """Quantization codec errors (unknown flavor, size mismatch, ...)."""


class KernelError(BitNetError):
    """Compute-kernel dispatch or execution errors."""


class TokenizerError(BitNetError):
    """Tokenizer loading / encoding errors."""


class InferenceError(BitNetError):
    """Engine-level runtime errors."""


class SecurityError(BitNetError):
    """Resource-limit violations while parsing untrusted files.

    The reference enforces memory/size limits when parsing GGUF
    (``crates/bitnet-models/src/security.rs``); we raise this error for the
    same conditions.
    """


class StrictModeViolation(BitNetError):
    """An operation that strict mode forbids was attempted.

    Equivalent to the reference's strict-mode guard
    (``crates/bitnet-common/src/strict_mode.rs:87-158``) which bans mock
    kernels / mock tokenizers in production runs.
    """
