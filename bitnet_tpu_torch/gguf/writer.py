"""GGUF v3 writer.

Own copy of ``bitnet_tpu/gguf/writer.py``: the port imports nothing of the
JAX package.

Capability parity with the reference writer
(``crates/bitnet-models/src/gguf_writer.rs`` and
``crates/bitnet-st2gguf/src/writer.rs:81-152``): metadata KV pairs, aligned
tensor data section, quantized payload passthrough.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

from ..errors import FormatError
from .constants import (
    DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION_V3,
    GGMLType,
    GGUFValueType,
    type_nbytes,
)

_SCALAR_PACK: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_GGML: dict[np.dtype, GGMLType] = {
    np.dtype("float32"): GGMLType.F32,
    np.dtype("float16"): GGMLType.F16,
    np.dtype("float64"): GGMLType.F64,
    np.dtype("int8"): GGMLType.I8,
    np.dtype("int16"): GGMLType.I16,
    np.dtype("int32"): GGMLType.I32,
    np.dtype("int64"): GGMLType.I64,
}


def _infer_value_type(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, (int, np.integer)):
        v = int(value)
        if v < 0:
            return GGUFValueType.INT64 if abs(v) > 2**31 else GGUFValueType.INT32
        return GGUFValueType.UINT64 if v >= 2**32 else GGUFValueType.UINT32
    if isinstance(value, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise FormatError(f"cannot infer GGUF value type for {type(value)}")


class GGUFWriter:
    """Accumulates metadata + tensors, then writes a valid GGUF v3 file."""

    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    # -- metadata ----------------------------------------------------------
    def add_metadata(self, key: str, value: Any,
                     vtype: GGUFValueType | None = None) -> None:
        if vtype is None:
            vtype = _infer_value_type(value)
        self._kv.append((key, vtype, value))

    # -- tensors -----------------------------------------------------------
    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: GGMLType | None = None) -> None:
        """Add an unquantized tensor.

        ``array`` is row-major; GGUF stores dims innermost-first so the shape
        written to the file is ``reversed(array.shape)``.
        """
        array = np.ascontiguousarray(array)
        if ggml_type is None:
            ggml_type = _NP_TO_GGML.get(array.dtype)
            if ggml_type is None:
                raise FormatError(f"no GGML type for numpy dtype {array.dtype}")
        shape = tuple(reversed(array.shape))
        self._tensors.append((name, shape, ggml_type, array.tobytes()))

    def add_quantized_tensor(self, name: str, shape_logical: tuple[int, ...],
                             ggml_type: GGMLType, payload: bytes) -> None:
        """Add a pre-quantized payload.

        ``shape_logical`` is the row-major logical shape; the payload must be
        exactly the packed bytes of that tensor in ``ggml_type``'s layout.
        """
        nelems = int(np.prod(shape_logical)) if shape_logical else 1
        expected = type_nbytes(ggml_type, nelems)
        # BitNet I2_S flavors legitimately differ from the nominal 8 B/32-elem
        # accounting (BitNet32F16 = 10 B, QK256 = 64 B/256) — allow them.
        if ggml_type != GGMLType.I2_S and len(payload) != expected:
            raise FormatError(
                f"tensor {name}: payload {len(payload)} B != expected {expected} B"
            )
        shape = tuple(reversed(shape_logical))
        self._tensors.append((name, shape, ggml_type, payload))

    # -- serialization -----------------------------------------------------
    def _write_string(self, f: BinaryIO, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, vtype: GGUFValueType, value: Any) -> None:
        if vtype == GGUFValueType.BOOL:
            f.write(struct.pack("<B", 1 if value else 0))
        elif vtype == GGUFValueType.STRING:
            self._write_string(f, value)
        elif vtype == GGUFValueType.ARRAY:
            seq = list(value)
            if seq and isinstance(seq[0], str):
                et = GGUFValueType.STRING
            elif seq and isinstance(seq[0], bool):
                et = GGUFValueType.BOOL
            elif seq and isinstance(seq[0], (float, np.floating)):
                et = GGUFValueType.FLOAT32
            else:
                et = GGUFValueType.INT32
            if isinstance(value, np.ndarray):
                if np.issubdtype(value.dtype, np.floating):
                    et = GGUFValueType.FLOAT32
                elif value.dtype == np.int64:
                    et = GGUFValueType.INT64
                else:
                    et = GGUFValueType.INT32
            f.write(struct.pack("<I", int(et)))
            f.write(struct.pack("<Q", len(seq)))
            for item in seq:
                self._write_value(f, et, item)
        else:
            fmt = _SCALAR_PACK[vtype]
            f.write(struct.pack(fmt, value))

    def write(self, path: str) -> None:
        align = self.alignment
        with open(path, "wb") as f:
            f.write(struct.pack("<I", GGUF_MAGIC))
            f.write(struct.pack("<I", GGUF_VERSION_V3))
            f.write(struct.pack("<Q", len(self._tensors)))
            f.write(struct.pack("<Q", len(self._kv)))

            for key, vtype, value in self._kv:
                self._write_string(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, vtype, value)

            # tensor infos with running aligned offsets
            offset = 0
            offsets: list[int] = []
            for name, shape, ttype, payload in self._tensors:
                self._write_string(f, name)
                f.write(struct.pack("<I", len(shape)))
                for d in shape:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<I", int(ttype)))
                f.write(struct.pack("<Q", offset))
                offsets.append(offset)
                offset = _align_up(offset + len(payload), align)

            # pad header to alignment, then write payloads at their offsets
            header_end = f.tell()
            data_start = _align_up(header_end, align)
            f.write(b"\x00" * (data_start - header_end))
            for (name, shape, ttype, payload), off in zip(self._tensors, offsets):
                pos = f.tell() - data_start
                if pos < off:
                    f.write(b"\x00" * (off - pos))
                f.write(payload)


def _align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a
