"""SafeTensors inspection / shard-merge utilities.

Counterpart of ``bitnet_tpu/tools/st_tools.py`` on the port's own
SafeTensors reader and writer (``tools/safetensors_io.py``):
- :func:`inspect_safetensors` — per-tensor name/shape/dtype/bytes summary
  plus aggregate stats (the ``st-inspect`` binary);
- :func:`merge_safetensors` — merge HF multi-shard checkpoints
  (``model-0000X-of-0000Y.safetensors`` + index json) into one file
  (the ``st-merge`` binary).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..errors import ModelError


def inspect_safetensors(path: str) -> dict:
    """Header-only inspection (no tensor payloads are loaded)."""
    if not os.path.exists(path):
        raise ModelError(f"no such file: {path}")
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        if header_len <= 0 or header_len > 256 * 2**20:
            raise ModelError(f"implausible safetensors header length "
                             f"{header_len}")
        try:
            header = json.loads(f.read(header_len))
        except json.JSONDecodeError as e:
            raise ModelError(f"corrupt safetensors header: {e}") from None
    meta = header.pop("__metadata__", {})
    tensors = []
    total_bytes = 0
    by_dtype: dict[str, int] = {}
    for name, spec in sorted(header.items()):
        start, end = spec["data_offsets"]
        nbytes = end - start
        total_bytes += nbytes
        by_dtype[spec["dtype"]] = by_dtype.get(spec["dtype"], 0) + 1
        tensors.append({
            "name": name,
            "dtype": spec["dtype"],
            "shape": spec["shape"],
            "nbytes": nbytes,
        })
    return {
        "path": path,
        "metadata": meta,
        "num_tensors": len(tensors),
        "total_bytes": total_bytes,
        "by_dtype": by_dtype,
        "tensors": tensors,
    }


def _shards_from_index(index_path: str) -> list[str]:
    with open(index_path) as f:
        index = json.load(f)
    wm = index.get("weight_map", {})
    base = os.path.dirname(os.path.abspath(index_path))
    return [os.path.join(base, s) for s in sorted(set(wm.values()))]


def merge_safetensors(inputs: list[str] | str, out_path: str) -> dict:
    """Merge shards into one .safetensors file.

    ``inputs``: list of shard paths, OR an
    ``model.safetensors.index.json`` path, OR a directory containing one.
    Duplicate tensor names across shards are an error.  A BF16 tensor is
    written as F32 (``safetensors_io.load_file`` widens it, exactly).
    """
    from .safetensors_io import load_file, save_file

    if isinstance(inputs, str):
        if os.path.isdir(inputs):
            idx = os.path.join(inputs, "model.safetensors.index.json")
            if not os.path.exists(idx):
                raise ModelError(f"no index json in {inputs}")
            inputs = _shards_from_index(idx)
        elif inputs.endswith(".json"):
            inputs = _shards_from_index(inputs)
        else:
            inputs = [inputs]
    if not inputs:
        raise ModelError("no input shards")

    merged: dict[str, np.ndarray] = {}
    for shard in inputs:
        data = load_file(shard)
        for name, arr in data.items():
            if name in merged:
                raise ModelError(
                    f"duplicate tensor {name!r} (in {shard})")
            merged[name] = arr
    save_file(merged, out_path)
    return {
        "out_path": out_path,
        "num_shards": len(inputs),
        "num_tensors": len(merged),
        "total_bytes": int(sum(a.nbytes for a in merged.values())),
    }
