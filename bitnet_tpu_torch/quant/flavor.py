"""I2_S flavor detection (own copy of bitnet_tpu/quant/flavor.py).

Reimplements the decision table of ``detect_i2s_flavor``
(``crates/bitnet-models/src/formats/gguf/types.rs:868-925``):

1. expected bytes per flavor:
   - blocks32  = ceil(nelems/32);  split_need  = blocks32 * 8
   -                               inline_need = blocks32 * 10
   - blocks256 = ceil(nelems/256); qk256_need  = blocks256 * 64
2. exact matches first, preferring larger blocks (qk256 > inline > split32)
3. then tolerance matches (strict: ±8 B; tolerant: ~0.1% of expected),
   preferring split32-with-sibling > inline > qk256
"""

from __future__ import annotations

import enum

from ..errors import QuantizationError


class I2SFlavor(enum.Enum):
    BITNET32_F16 = "bitnet32_f16"          # 10 B / 32-elem (inline f16 scale)
    SPLIT32_WITH_SIBLING = "split32"       # 8 B / 32-elem + sibling scales
    GGML_QK256_NO_SCALE = "qk256"          # 64 B / 256-elem, no scales


def _tolerance_bytes(expected: int, strict: bool) -> int:
    if strict:
        return 8
    # size-proportional ~0.1%, min 64 B — mirrors qk256_tolerance_bytes
    return max(64, expected // 1000)


def detect_i2s_flavor(
    nelems: int,
    available_bytes: int,
    has_scale_sibling: bool = False,
    strict: bool = False,
    name: str = "<tensor>",
    cols: int | None = None,
) -> I2SFlavor:
    """``cols`` (ne[0], the innermost dim) matters for QK256: each ROW is
    padded independently to whole 256-blocks (i2s_qk256.rs:53-67), so a
    [64, 64] tensor needs 64 rows × 64 B, not ceil(4096/256) × 64 B."""
    blocks32 = -(-nelems // 32)
    split_need = blocks32 * 8
    inline_need = blocks32 * 10
    if cols and cols > 0:
        rows = nelems // cols
        qk256_need = rows * (-(-cols // 256)) * 64
    else:
        qk256_need = -(-nelems // 256) * 64

    diff_split = abs(available_bytes - split_need)
    diff_inline = abs(available_bytes - inline_need)
    diff_qk256 = abs(available_bytes - qk256_need)

    # priority 1: exact matches, larger blocks first
    if diff_qk256 == 0:
        return I2SFlavor.GGML_QK256_NO_SCALE
    if diff_inline == 0:
        return I2SFlavor.BITNET32_F16
    if diff_split == 0 and has_scale_sibling:
        return I2SFlavor.SPLIT32_WITH_SIBLING
    if diff_split == 0:
        # data-only without sibling scales: usable but suspicious — the
        # reference warns and proceeds as split (scales default to 1.0)
        return I2SFlavor.SPLIT32_WITH_SIBLING

    # priority 2: tolerance matches
    tol = _tolerance_bytes(min(split_need, qk256_need), strict)
    if diff_split <= tol and has_scale_sibling:
        return I2SFlavor.SPLIT32_WITH_SIBLING
    if diff_inline <= tol:
        return I2SFlavor.BITNET32_F16
    if diff_qk256 <= tol:
        return I2SFlavor.GGML_QK256_NO_SCALE
    if diff_split <= tol:
        return I2SFlavor.SPLIT32_WITH_SIBLING

    raise QuantizationError(
        f"I2_S flavor detection failed for {name}: nelems={nelems}, "
        f"available={available_bytes} B; candidates: split32={split_need}, "
        f"inline={inline_need}, qk256={qk256_need} (tolerance={tol})"
    )
