"""Architecture registry: the supported model families and their sanity
envelopes, checked by the loader before it commits to a load.

Own copy of ``bitnet_tpu/models/arch_registry.py`` (the reference's
``crates/bitnet-common/src/arch_registry.rs``): the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses

from ..errors import ModelError


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str                     # GGUF general.architecture value
    family: str                   # tensor-naming family
    description: str
    hidden_act: str = "silu"
    norm: str = "rmsnorm"
    supports_ternary: bool = True
    uses_sub_norm: bool = False   # BitNet 2B-4T attention sub-norm
    # sanity envelopes (production_loader-style gates)
    max_layers: int = 200
    max_hidden: int = 32768
    max_vocab: int = 512_000


REGISTRY: dict[str, ArchSpec] = {
    "bitnet-b1.58": ArchSpec(
        name="bitnet-b1.58", family="llama",
        description="BitNet b1.58 ternary LLM (I2_S/QK256 GGUF)",
        uses_sub_norm=True),
    "bitnet": ArchSpec(
        name="bitnet", family="llama",
        description="BitNet (alias used by some converters)",
        uses_sub_norm=True),
    "bitnet-25": ArchSpec(
        name="bitnet-25", family="llama",
        description="BitNet v2/2025 converter alias",
        uses_sub_norm=True),
    "llama": ArchSpec(
        name="llama", family="llama",
        description="Generic llama-family GGUF (dense or quantized)",
        supports_ternary=False),
}


def list_architectures() -> list[ArchSpec]:
    return list(REGISTRY.values())


def resolve_arch(name: str | None) -> ArchSpec:
    """Spec for a GGUF ``general.architecture`` value.  Unknown names fall
    back to the generic llama spec with a warning rather than refusing to
    load (tolerant mapping, strict validation)."""
    if name is None:
        return REGISTRY["llama"]
    key = name.lower()
    if key in REGISTRY:
        return REGISTRY[key]
    if "bitnet" in key:
        return dataclasses.replace(REGISTRY["bitnet"], name=name)
    from ..obs.warn_once import warn_once

    warn_once(f"unknown architecture {name!r}; treating as llama-family")
    return dataclasses.replace(REGISTRY["llama"], name=name)


def validate_config_for_arch(cfg, spec: ArchSpec) -> None:
    """Envelope checks (reference production_loader.rs:27-140)."""
    if cfg.num_layers > spec.max_layers:
        raise ModelError(
            f"{spec.name}: {cfg.num_layers} layers exceeds envelope "
            f"{spec.max_layers}")
    if cfg.hidden_size > spec.max_hidden:
        raise ModelError(
            f"{spec.name}: hidden {cfg.hidden_size} exceeds envelope "
            f"{spec.max_hidden}")
    if cfg.vocab_size > spec.max_vocab:
        raise ModelError(
            f"{spec.name}: vocab {cfg.vocab_size} exceeds envelope "
            f"{spec.max_vocab}")
