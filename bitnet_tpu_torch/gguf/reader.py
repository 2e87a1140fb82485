"""Memory-mapped GGUF reader (own copy of bitnet_tpu/gguf/reader.py, numpy only).

Structural parity with the reference parser:
- header / magic / version checks: ``crates/bitnet-gguf/src/lib.rs:163-207``
- mmap tensor loading: ``crates/bitnet-models/src/loader.rs`` (``MmapFile``)
- security limits on untrusted metadata:
  ``crates/bitnet-models/src/security.rs``

The reader never copies tensor payloads: ``tensor_data`` returns a zero-copy
``numpy`` view into the mmap, which the model loader then repacks into
the kernels' word layout.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Iterator

import numpy as np

from ..errors import FormatError, SecurityError
from .constants import (
    ALIGNMENT_KEY,
    DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    SUPPORTED_VERSIONS,
    GGMLType,
    GGUFValueType,
    type_nbytes,
)

# Security limits (same spirit as bitnet-models/src/security.rs)
MAX_STRING_LEN = 64 * 1024 * 1024
MAX_ARRAY_LEN = 256 * 1024 * 1024
MAX_TENSORS = 65536
MAX_KV_PAIRS = 65536
MAX_DIMS = 4

_SCALAR_FMT: dict[GGUFValueType, str] = {
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

_NUMPY_DTYPES: dict[GGMLType, np.dtype] = {
    GGMLType.F32: np.dtype("<f4"),
    GGMLType.F16: np.dtype("<f2"),
    GGMLType.F64: np.dtype("<f8"),
    GGMLType.I8: np.dtype("<i1"),
    GGMLType.I16: np.dtype("<i2"),
    GGMLType.I32: np.dtype("<i4"),
    GGMLType.I64: np.dtype("<i8"),
    # bf16 surfaced as raw uint16 words; converted by the loader
    GGMLType.BF16: np.dtype("<u2"),
}


@dataclass(frozen=True)
class TensorInfo:
    """Descriptor of one tensor in the file.

    ``shape`` is in GGUF order: ``shape[0]`` is the fastest-varying
    (innermost / column) dimension, exactly as stored in the file.  Use
    ``logical_shape`` for the row-major numpy view (reversed).
    """

    name: str
    shape: tuple[int, ...]
    ggml_type: GGMLType
    offset: int            # relative to the start of the data section
    nbytes: int            # actual payload size (to next tensor / EOF)

    @property
    def nelems(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def logical_shape(self) -> tuple[int, ...]:
        return tuple(reversed(self.shape))


class GGUFReader:
    """Parses a GGUF file; exposes metadata dict + zero-copy tensor views."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file: BinaryIO = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:  # empty file
            self._file.close()
            raise FormatError(f"{self.path}: cannot mmap: {e}") from None
        self._pos = 0
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self.version: int = 0
        self.alignment: int = DEFAULT_ALIGNMENT
        self.data_start: int = 0
        try:
            self._parse()
        except (struct.error, IndexError) as e:
            self.close()
            raise FormatError(f"{self.path}: truncated GGUF: {e}") from None
        except Exception:
            self.close()
            raise

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            try:
                self._mm.close()
            except BufferError:
                # zero-copy tensor views are still alive; the mapping is
                # released when the last view is garbage-collected.
                pass
            self._mm = None  # type: ignore[assignment]
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None  # type: ignore[assignment]

    # -- low-level readers -------------------------------------------------
    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos : self._pos + n]
        if len(b) != n:
            raise FormatError(f"{self.path}: unexpected EOF at {self._pos}")
        self._pos += n
        return b

    def _read_fmt(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._read(size))[0]

    def _read_string(self) -> str:
        n = self._read_fmt("<Q")
        if n > MAX_STRING_LEN:
            raise SecurityError(f"{self.path}: string length {n} exceeds limit")
        return self._read(n).decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.BOOL:
            return self._read_fmt("<B") != 0
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self._read_fmt("<I"))
            n = self._read_fmt("<Q")
            if n > MAX_ARRAY_LEN:
                raise SecurityError(f"{self.path}: array length {n} exceeds limit")
            if elem_type in _SCALAR_FMT and elem_type not in (
                GGUFValueType.STRING,
                GGUFValueType.ARRAY,
            ):
                fmt = _SCALAR_FMT[elem_type]
                size = struct.calcsize(fmt)
                raw = self._read(size * n)
                arr = np.frombuffer(raw, dtype=np.dtype(fmt[1:]).newbyteorder("<"))
                return arr.copy()
            return [self._read_value(elem_type) for _ in range(n)]
        fmt = _SCALAR_FMT.get(vtype)
        if fmt is None:
            raise FormatError(f"{self.path}: unknown GGUF value type {vtype}")
        return self._read_fmt(fmt)

    # -- structure ---------------------------------------------------------
    def _parse(self) -> None:
        magic = self._read_fmt("<I")
        if magic != GGUF_MAGIC:
            raise FormatError(
                f"{self.path}: bad magic 0x{magic:08x} (expected GGUF)"
            )
        self.version = self._read_fmt("<I")
        if self.version not in SUPPORTED_VERSIONS:
            raise FormatError(
                f"{self.path}: unsupported GGUF version {self.version}"
            )
        n_tensors = self._read_fmt("<Q")
        n_kv = self._read_fmt("<Q")
        if n_tensors > MAX_TENSORS:
            raise SecurityError(f"{self.path}: tensor count {n_tensors} exceeds limit")
        if n_kv > MAX_KV_PAIRS:
            raise SecurityError(f"{self.path}: KV count {n_kv} exceeds limit")

        for _ in range(n_kv):
            key = self._read_string()
            vtype = GGUFValueType(self._read_fmt("<I"))
            self.metadata[key] = self._read_value(vtype)

        align = self.metadata.get(ALIGNMENT_KEY, DEFAULT_ALIGNMENT)
        if isinstance(align, (int, np.integer)) and align > 0:
            self.alignment = int(align)

        raw_infos: list[tuple[str, tuple[int, ...], GGMLType, int]] = []
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read_fmt("<I")
            if n_dims > MAX_DIMS:
                raise SecurityError(f"{self.path}: tensor {name}: {n_dims} dims")
            shape = tuple(self._read_fmt("<Q") for _ in range(n_dims))
            ttype_raw = self._read_fmt("<I")
            try:
                ttype = GGMLType(ttype_raw)
            except ValueError:
                raise FormatError(
                    f"{self.path}: tensor {name}: unknown ggml type {ttype_raw}"
                ) from None
            offset = self._read_fmt("<Q")
            raw_infos.append((name, shape, ttype, offset))

        # data section starts aligned after the header
        self.data_start = _align_up(self._pos, self.alignment)
        file_size = len(self._mm)

        # compute actual per-tensor byte extents: GGUF doesn't store sizes, so
        # the extent runs to the next tensor's offset (sorted) or EOF.  The
        # reference does the same to feed detect_i2s_flavor with "available
        # bytes" (``formats/gguf/types.rs:868-925``).
        by_offset = sorted(raw_infos, key=lambda t: t[3])
        for i, (name, shape, ttype, offset) in enumerate(by_offset):
            start = self.data_start + offset
            if i + 1 < len(by_offset):
                end = self.data_start + by_offset[i + 1][3]
            else:
                end = file_size
            if start > file_size or end > file_size or end < start:
                raise FormatError(f"{self.path}: tensor {name}: bad extent")
            self.tensors[name] = TensorInfo(
                name=name, shape=shape, ggml_type=ttype,
                offset=offset, nbytes=end - start,
            )

    # -- tensor access -----------------------------------------------------
    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw payload bytes of a tensor as a zero-copy uint8 view."""
        info = self.tensors[name]
        start = self.data_start + info.offset
        buf = np.frombuffer(self._mm, dtype=np.uint8,
                            count=info.nbytes, offset=start)
        return buf

    def tensor_data(self, name: str) -> np.ndarray:
        """Tensor payload as a typed numpy array.

        Unquantized types are returned reshaped to ``logical_shape``
        (row-major, i.e. GGUF dims reversed); quantized types are returned as
        flat uint8 for the quant codecs to interpret.
        """
        info = self.tensors[name]
        raw = self.tensor_bytes(name)
        dtype = _NUMPY_DTYPES.get(info.ggml_type)
        if dtype is None:
            # quantized: hand raw bytes (trimmed to the nominal size) to codecs
            nominal = type_nbytes(info.ggml_type, info.nelems)
            return raw[: min(len(raw), max(nominal, len(raw)))]
        view = raw[: info.nelems * dtype.itemsize].view(dtype)
        return view.reshape(info.logical_shape)

    def __iter__(self) -> Iterator[TensorInfo]:
        """The tensors' infos in file order."""
        return iter(self.tensors.values())

    # -- convenience -------------------------------------------------------
    @property
    def architecture(self) -> str | None:
        return self.metadata.get("general.architecture")

    def arch_key(self, suffix: str, default: Any = None) -> Any:
        """Look up ``<arch>.<suffix>`` in metadata."""
        arch = self.architecture
        if arch is None:
            return default
        return self.metadata.get(f"{arch}.{suffix}", default)


def _align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a

