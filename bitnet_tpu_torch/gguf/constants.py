"""GGUF format constants (own copy of bitnet_tpu/gguf/constants.py).

Format reference: the GGUF v3 spec as implemented by the reference parser
(``crates/bitnet-gguf/src/lib.rs:163-207`` and
``crates/bitnet-models/src/formats/gguf/types.rs``).
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION_V2 = 2
GGUF_VERSION_V3 = 3
SUPPORTED_VERSIONS = (GGUF_VERSION_V2, GGUF_VERSION_V3)

DEFAULT_ALIGNMENT = 32
ALIGNMENT_KEY = "general.alignment"


class GGUFValueType(enum.IntEnum):
    """Metadata value types (gguf spec)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor data types.

    Numeric values follow ggml; the subset and the two BitNet-specific entries
    match the reference (``formats/gguf/types.rs:641-729``): IQ2_S is ggml
    type 24 (82 B / 256-elem block) and I2_S is bitnet.cpp type 36.
    """

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    F64 = 4
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_S = 24
    I8 = 26
    I16 = 27
    I32 = 28
    I64 = 29
    BF16 = 30
    I2_S = 36


# (block_size_elems, bytes_per_block); non-quantized types use block 1.
# I2_S is listed with the BitNet32 "data-only" 8-byte block like the reference
# (``types.rs:729``: element_size()==8, block_size()==32) — actual layout is
# flavor-detected at load time (see quant/flavor.py).
GGML_TYPE_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.BF16: (1, 2),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q8_1: (32, 36),
    GGMLType.Q2_K: (256, 82),
    GGMLType.Q3_K: (256, 110),
    GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176),
    GGMLType.Q6_K: (256, 210),
    GGMLType.Q8_K: (256, 256),
    GGMLType.IQ2_S: (256, 82),
    GGMLType.I2_S: (32, 8),
}

def type_nbytes(ggml_type: GGMLType, nelems: int) -> int:
    """Size in bytes of ``nelems`` elements of ``ggml_type`` (row-granular)."""
    block, per_block = GGML_TYPE_SIZES[ggml_type]
    nblocks = -(-nelems // block)
    return nblocks * per_block

