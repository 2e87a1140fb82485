"""SafeTensors files, read and written with numpy and the standard library.

The format: an 8-byte little-endian header length N, N bytes of JSON (each
tensor's ``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the
data that follows, and an optional ``__metadata__`` map of strings), then
the raw little-endian tensor bytes.  The port reads SafeTensors checkpoints
with this module (``tools/st2gguf.py``, ``tools/st_tools.py``) where the
JAX package imports ``safetensors.numpy``, which the card's machine does
not have.  Its dtypes are the ones ``safetensors.numpy`` reads, and BF16,
which numpy has no dtype for, comes back widened to f32 (exact): the JAX
loader's route (``load_model`` → ``_resolve_checkpoint``) reads BF16
through the ``ml_dtypes`` bfloat16 that JAX registers with numpy, and its
converter widens it to f32.  The fp8 types are refused with a ModelError
that names the dtype.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from ..errors import ModelError

DTYPES = {"BOOL": np.bool_, "U8": np.uint8, "I8": np.int8, "U16": np.uint16,
          "I16": np.int16, "F16": np.float16, "U32": np.uint32, "I32": np.int32,
          "F32": np.float32, "U64": np.uint64, "I64": np.int64, "F64": np.float64}
NAMES = {np.dtype(v): k for k, v in DTYPES.items()}
# header lengths past this are a corrupt or hostile file
MAX_HEADER = 256 * 2**20


def read_header(path: str) -> tuple[dict, int]:
    """(the header's JSON with ``__metadata__`` left in, the data's offset)."""
    if not os.path.isfile(path):
        raise ModelError(f"no such file: {path}")
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ModelError(f"{path}: too short for a safetensors header")
        n = struct.unpack("<Q", head)[0]
        if n <= 0 or n > MAX_HEADER:
            raise ModelError(f"implausible safetensors header length {n}")
        try:
            header = json.loads(f.read(n))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ModelError(f"corrupt safetensors header: {e}") from None
    if not isinstance(header, dict):
        raise ModelError(f"{path}: the header is not a JSON object")
    return header, 8 + n


def load_file(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (read-only
    views of one memory map of the file, in the file's order; a BF16
    tensor widened to an f32 copy)."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    size = os.path.getsize(path)
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=start,
                      shape=(size - start,)).view(np.ndarray)
            if size > start else np.zeros(0, np.uint8))
    out: dict[str, np.ndarray] = {}
    for name, spec in header.items():
        code = spec.get("dtype")
        widen = code == "BF16"
        dt = np.uint16 if widen else DTYPES.get(code)
        if dt is None:
            raise ModelError(
                f"{path}: tensor {name!r} has dtype {spec.get('dtype')}, which "
                "numpy cannot hold (safetensors.numpy refuses it too); convert "
                "the checkpoint to BF16, F16 or F32")
        b, e = spec["data_offsets"]
        shape = tuple(int(d) for d in spec["shape"])
        count = int(np.prod(shape)) if shape else 1
        if not 0 <= b <= e <= data.size or e - b != count * np.dtype(dt).itemsize:
            raise ModelError(f"{path}: tensor {name!r} data_offsets {b, e} do "
                             f"not hold {shape} of {spec['dtype']}")
        a = data[b:e].view(dt).reshape(shape)
        out[name] = (a.astype(np.uint32) << np.uint32(16)).view(np.float32) if widen else a
    return out


def save_file(tensors: dict[str, np.ndarray], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (name → numpy array) as a ``.safetensors`` file, in
    name order, the header padded with spaces to a multiple of 8 bytes."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays = []
    off = 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        if not a.flags.c_contiguous:          # (ascontiguousarray makes 0-d 1-d)
            a = a.copy(order="C")
        code = NAMES.get(a.dtype)
        if code is None:
            raise ModelError(f"tensor {name!r}: no safetensors dtype for {a.dtype}")
        header[name] = {"dtype": code, "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        arrays.append(a)
        off += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in arrays:
            f.write(memoryview(a.reshape(-1).view(np.uint8)))
