"""Decode-state checkpoint / resume.

Counterpart of ``bitnet_tpu/engine/checkpoint.py``, in the same files: a
checkpoint is a host snapshot of (tokens, slot 0's KV rows, an optional
RNG key) written as ``<path>.npz`` plus a ``<path>.json`` manifest with
the schema version and a sha256 over the stored arrays.  The array names,
the schema and the digest are the JAX package's, so a checkpoint that one
package writes loads in the other.  numpy has no bf16 or fp8: those arrays
are stored as same-width integer views (``uint16`` / ``uint8``) named in
the manifest's ``packed_dtypes``, and viewed back with torch.  Restoring
copies the rows into a fresh engine's slot 0; resuming decodes the last
token again for its logits and continues at the exact token boundary,
re-seeded from ``GenerationConfig.seed`` (the stored key is not read, as
in the JAX package).

Incremental diffs are the KV rows ``[prev_len, new_len)`` and the new
tokens (``save_diff`` / ``apply_diff``): the cache is append-only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..errors import InferenceError
from .cache import reset_cache
from .prefix_cache import PrefixSnapshot, as_tensor, canonical_rows

SCHEMA_VERSION = "1.0.0"


@dataclasses.dataclass
class DecodeState:
    """Everything needed to resume a generation mid-stream.  The rows are
    numpy arrays, or CPU tensors for bf16 / fp8."""

    prompt_ids: list[int]
    generated_ids: list[int]
    rng_key: np.ndarray | None          # stored when given; resume re-seeds
    kv_len: int
    k: np.ndarray | torch.Tensor        # [L, kv_len, KV, D] (slot 0)
    v: np.ndarray | torch.Tensor
    k_scale: np.ndarray | None = None   # [L, kv_len, KV] (int8 / fp8)
    v_scale: np.ndarray | None = None

    @property
    def all_ids(self) -> list[int]:
        return self.prompt_ids + self.generated_ids


def capture(engine, prompt_ids: list[int], generated_ids: list[int],
            rng_key=None) -> DecodeState:
    """Snapshot the engine's slot-0 decode state to host memory.  A
    windowed engine's ring holds only the trailing window and is refused
    (``bitnet_tpu/engine/checkpoint.py:55-60``)."""
    if getattr(engine, "windowed", False):
        from ..errors import InferenceError

        raise InferenceError(
            "checkpoint capture requires the dense cache (a ring buffer "
            "holds only the trailing window of KV rows)")
    kv_len = int(engine.cache.lengths[0])
    k, v, ks, vs = canonical_rows(engine.cache, kv_len,
                                  kv_heads=engine.cfg.num_kv_heads)
    return DecodeState(
        prompt_ids=list(prompt_ids), generated_ids=list(generated_ids),
        rng_key=None if rng_key is None else np.asarray(rng_key),
        kv_len=kv_len, k=k, v=v, k_scale=ks, v_scale=vs)


# the JAX package's names of the dtypes numpy lacks, and their views
_PACKED = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
           torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
           torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_UNPACK = {name: dt for dt, (name, _, _) in _PACKED.items()}


def _pack_arrays(arrays: dict) -> tuple[dict, dict]:
    """numpy arrays as they are; bf16 / fp8 tensors as integer views (the
    same bytes, so the digest is the JAX package's)."""
    packed, dtypes = {}, {}
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):
            if a.dtype in _PACKED:
                dn, tview, nview = _PACKED[a.dtype]
                a = a.contiguous().view(tview).numpy().view(nview)
                dtypes[name] = dn
            else:
                a = a.numpy()
        packed[name] = a
    return packed, dtypes


def _unpack_arrays(arrays: dict, dtypes: dict) -> dict:
    for name, dn in dtypes.items():
        if name in arrays:
            if dn not in _UNPACK:
                raise InferenceError(f"checkpoint array {name}: unknown "
                                     f"packed dtype {dn!r}")
            arrays[name] = torch.from_numpy(
                np.ascontiguousarray(arrays[name])).view(_UNPACK[dn])
    return arrays


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return _PACKED[a.dtype][0] if a.dtype in _PACKED else str(a.numpy().dtype)
    return str(a.dtype)


def _digest(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = arrays[name]
        if a is None:
            continue
        h.update(name.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _write(path: str, arrays: dict, manifest: dict) -> dict:
    arrays, packed_dtypes = _pack_arrays(arrays)
    np.savez(path + ".npz", **arrays)
    manifest = {**manifest, "sha256": _digest(arrays)}
    manifest["packed_dtypes"] = packed_dtypes
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def save(state: DecodeState, path: str) -> dict:
    """Write ``<path>.npz`` + ``<path>.json`` manifest; returns manifest."""
    arrays = {
        "prompt_ids": np.asarray(state.prompt_ids, np.int32),
        "generated_ids": np.asarray(state.generated_ids, np.int32),
        "k": state.k,
        "v": state.v,
    }
    if state.rng_key is not None:
        arrays["rng_key"] = state.rng_key
    if state.k_scale is not None:
        arrays["k_scale"] = state.k_scale
        arrays["v_scale"] = state.v_scale
    return _write(path, arrays, {
        "schema_version": SCHEMA_VERSION,
        "created_unix": time.time(),
        "kv_len": state.kv_len,
        "prompt_tokens": len(state.prompt_ids),
        "generated_tokens": len(state.generated_ids),
        "kv_shape": list(state.k.shape),
        "kv_dtype": _dtype_name(state.k),
    })


def _read(path: str) -> tuple[dict, dict]:
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    manifest = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
    return arrays, manifest


def load(path: str, verify: bool = True) -> DecodeState:
    """Read a checkpoint; integrity-check against the manifest."""
    if not os.path.exists(path + ".npz"):
        raise InferenceError(f"checkpoint not found: {path}.npz")
    arrays, manifest = _read(path)
    if manifest and verify:
        if manifest.get("schema_version") != SCHEMA_VERSION:
            raise InferenceError(
                f"checkpoint schema {manifest.get('schema_version')} != "
                f"{SCHEMA_VERSION}")
        if _digest(arrays) != manifest.get("sha256"):
            raise InferenceError("checkpoint integrity failure: sha256 mismatch")
    arrays = _unpack_arrays(arrays, manifest.get("packed_dtypes", {}))
    return DecodeState(
        prompt_ids=[int(t) for t in arrays["prompt_ids"]],
        generated_ids=[int(t) for t in arrays["generated_ids"]],
        rng_key=arrays.get("rng_key"),
        kv_len=int(arrays["k"].shape[1]),
        k=arrays["k"], v=arrays["v"],
        k_scale=arrays.get("k_scale"), v_scale=arrays.get("v_scale"))


def restore(engine, state: DecodeState) -> None:
    """Load ``state`` into the engine's slot 0 (rows + lengths)."""
    S = engine.engine_cfg.max_seq_len
    if state.kv_len > S:
        raise InferenceError(
            f"checkpoint kv_len {state.kv_len} > engine max_seq_len {S}")
    exp = (engine.cfg.num_layers, engine.cfg.num_kv_heads, engine.cfg.head_dim)
    got = (state.k.shape[0], state.k.shape[2], state.k.shape[3])
    if exp != got:
        raise InferenceError(f"checkpoint shape {got} does not match model {exp}")
    reset_cache(engine.cache)
    with torch.inference_mode():
        engine._restore_prefix(PrefixSnapshot(
            length=state.kv_len, k=state.k, v=state.v,
            k_scale=state.k_scale, v_scale=state.v_scale), state.kv_len)


def resume_generation(engine, state: DecodeState, gen_cfg=None):
    """Continue generating from a checkpoint; returns a GenerationResult
    of the newly generated tokens only."""
    restore(engine, state)
    return engine.generate_from_state(
        state.all_ids, already_generated=len(state.generated_ids),
        gen_cfg=gen_cfg)


# -- incremental diffs -------------------------------------------------------
def _cat(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.cat([as_tensor(a), as_tensor(b)], dim=1)
    return np.concatenate([a, b], axis=1)


def save_diff(prev: DecodeState, cur: DecodeState, path: str) -> dict:
    """Write only the KV rows and tokens added since ``prev``."""
    if cur.kv_len < prev.kv_len:
        raise InferenceError("diff target is older than the base")
    if cur.prompt_ids != prev.prompt_ids:
        raise InferenceError("diff across different prompts")
    arrays = {
        "base_len": np.asarray([prev.kv_len], np.int32),
        "new_ids": np.asarray(cur.generated_ids[len(prev.generated_ids):], np.int32),
        "k": cur.k[:, prev.kv_len:],
        "v": cur.v[:, prev.kv_len:],
    }
    if cur.k_scale is not None:
        arrays["k_scale"] = cur.k_scale[:, prev.kv_len:]
        arrays["v_scale"] = cur.v_scale[:, prev.kv_len:]
    return _write(path, arrays, {
        "schema_version": SCHEMA_VERSION, "diff": True, "base_len": prev.kv_len,
        "rows": int(cur.k.shape[1] - prev.kv_len)})


def apply_diff(base: DecodeState, path: str) -> DecodeState:
    arrays, manifest = _read(path)
    arrays = _unpack_arrays(arrays, manifest.get("packed_dtypes", {}))
    base_len = int(arrays["base_len"][0])
    if base_len != base.kv_len:
        raise InferenceError(
            f"diff base_len {base_len} != state kv_len {base.kv_len}")
    k, v = _cat(base.k, arrays["k"]), _cat(base.v, arrays["v"])
    ks = vs = None
    if base.k_scale is not None and "k_scale" in arrays:
        ks = _cat(base.k_scale, arrays["k_scale"])
        vs = _cat(base.v_scale, arrays["v_scale"])
    return DecodeState(
        prompt_ids=base.prompt_ids,
        generated_ids=base.generated_ids + [int(t) for t in arrays["new_ids"]],
        rng_key=base.rng_key, kv_len=k.shape[1], k=k, v=v, k_scale=ks, v_scale=vs)
