"""Model-weight validation rules and fingerprinting, on the host.

The port's copy of ``bitnet_tpu/models/validation.py:1-173`` (numpy, no
device work), reading the port's own ``GGUFReader``:
- ``detect_rules`` / ``check_layernorm`` / ``validate_model_lns``: an
  arch-aware LayerNorm RMS envelope, and what to do with a weight outside
  it (``CorrectionAction``: accept, warn, rescale, reject);
- ``fingerprint_model`` / ``checkpoint_metadata`` /
  ``write_checkpoint_metadata``: sha256 over the metadata, the tensor
  infos and the first and last tensors' head and tail bytes, and a
  checkpoint file's metadata record.

The CLI's ``fingerprint`` and ``ln-check`` call it (``cli.py``), as the
JAX CLI's do (``bitnet_tpu/cli.py:838-856``).  Converters that quantize
LayerNorm weights leave RMS values far from 1.0 and wreck accuracy
silently: the envelope catches them.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
import time

import numpy as np

from ..errors import ModelError


class CorrectionAction(enum.Enum):
    ACCEPT = "accept"
    WARN = "warn"
    RESCALE = "rescale"       # divide by its own RMS (unit-RMS correction)
    REJECT = "reject"


@dataclasses.dataclass(frozen=True)
class LNRules:
    """RMS envelope for LayerNorm weights (bitnet-validation lib.rs:11-20)."""

    rms_min: float = 0.1
    rms_max: float = 10.0
    warn_min: float = 0.5
    warn_max: float = 2.0
    policy: str = "warn"       # 'strict' → reject, 'warn', 'rescale'


def detect_rules(architecture: str) -> LNRules:
    """Arch-aware envelope (detect_rules parity)."""
    if "bitnet" in (architecture or "").lower():
        # BitNet LN weights hover near 1.0; wide drift means a converter bug
        return LNRules()
    return LNRules(rms_min=0.01, rms_max=100.0, warn_min=0.1, warn_max=10.0)


def check_layernorm(
    name: str,
    weight: np.ndarray,
    rules: LNRules,
) -> tuple[CorrectionAction, float, np.ndarray]:
    """Validate one LN weight; returns (action, rms, possibly-corrected w)."""
    w = np.asarray(weight, np.float32)
    rms = float(np.sqrt(np.mean(w * w))) if w.size else 0.0
    if not np.isfinite(w).all():
        raise ModelError(f"{name}: non-finite LayerNorm weight")
    if rms < rules.rms_min or rms > rules.rms_max:
        if rules.policy == "strict":
            raise ModelError(
                f"{name}: LayerNorm RMS {rms:.4f} outside envelope "
                f"[{rules.rms_min}, {rules.rms_max}] — quantized or corrupt "
                "LN weights (converter must keep LN in F16/F32)")
        if rules.policy == "rescale" and rms > 0:
            return CorrectionAction.RESCALE, rms, w / rms
        return CorrectionAction.REJECT, rms, w
    if rms < rules.warn_min or rms > rules.warn_max:
        return CorrectionAction.WARN, rms, w
    return CorrectionAction.ACCEPT, rms, w


def validate_model_lns(reader, rules: LNRules | None = None) -> dict:
    """Scan every *norm* tensor in an open GGUFReader; returns a report."""
    from ..gguf.constants import GGMLType

    if rules is None:
        rules = detect_rules(reader.architecture or "")
    report = {"checked": 0, "warnings": [], "rejected": [], "rms": {}}
    for info in reader:
        if "norm" not in info.name:
            continue
        data = np.asarray(reader.tensor_data(info.name), np.float32) \
            if info.ggml_type in (GGMLType.F32, GGMLType.F16) else None
        if data is None:
            report["rejected"].append(
                {"name": info.name,
                 "error": f"LayerNorm stored quantized ({info.ggml_type.name})"})
            continue
        action, rms, _ = check_layernorm(info.name, data, rules)
        report["checked"] += 1
        report["rms"][info.name] = round(rms, 5)
        if action == CorrectionAction.WARN:
            report["warnings"].append({"name": info.name, "rms": rms})
        elif action == CorrectionAction.REJECT:
            report["rejected"].append({"name": info.name, "rms": rms})
    return report


# ---------------------------------------------------------------------------
# Fingerprinting / checkpoint metadata
# ---------------------------------------------------------------------------
def fingerprint_model(path: str, sample_bytes: int = 65536) -> dict:
    """Stable fingerprint of a GGUF checkpoint (fingerprint.rs parity):
    sha256 over (metadata, tensor infos, head+tail payload samples) —
    full-file hashing of multi-GB checkpoints is deliberately avoided."""
    from ..gguf.reader import GGUFReader

    h = hashlib.sha256()
    with GGUFReader(path) as r:
        for k in sorted(r.metadata):
            v = r.metadata[k]
            if isinstance(v, (list, np.ndarray)):
                v = f"<{len(v)} items>"
            h.update(f"{k}={v}\n".encode())
        for info in r:
            h.update(f"{info.name}:{info.ggml_type.name}:"
                     f"{tuple(info.shape)}:{info.nbytes}\n".encode())
        names = sorted(r.tensors)
        for name in (names[0], names[-1]):
            raw = r.tensor_bytes(name)
            h.update(bytes(raw[:sample_bytes]))
            h.update(bytes(raw[-sample_bytes:]))
    size = os.path.getsize(path)
    return {
        "path": os.path.abspath(path),
        "size_bytes": size,
        "fingerprint": h.hexdigest(),
        "algorithm": "sha256-metadata+samples",
    }


def checkpoint_metadata(path: str) -> dict:
    """Checkpoint-file metadata record (models/checkpoint.rs:102-235):
    format detection + fingerprint + basic stats."""
    fmt = "unknown"
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"GGUF":
        fmt = "gguf"
    elif path.endswith(".safetensors"):
        fmt = "safetensors"
    meta = {
        "path": os.path.abspath(path),
        "format": fmt,
        "size_bytes": os.path.getsize(path),
        "mtime": os.path.getmtime(path),
        "created_unix": time.time(),
    }
    if fmt == "gguf":
        meta.update(fingerprint_model(path))
        from ..gguf.reader import GGUFReader

        with GGUFReader(path) as r:
            meta["architecture"] = r.architecture
            meta["num_tensors"] = len(r.tensors)
    return meta


def write_checkpoint_metadata(path: str, out_path: str | None = None) -> str:
    out_path = out_path or path + ".meta.json"
    with open(out_path, "w") as f:
        json.dump(checkpoint_metadata(path), f, indent=2)
    return out_path
