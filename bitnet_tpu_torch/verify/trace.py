"""Activation tracing for cross-validation debugging.

Counterpart of ``bitnet_tpu/verify/trace.py`` (``bitnet-trace``
``src/lib.rs:50-212``): per-tensor trace records (name, shape, RMS,
first-N values), JSON dump, RMS-tolerance comparison between two trace
sets (the ``trace-diff`` workflow).  ``InferenceEngine.eval_ids(ids,
trace=sink)`` records the embedding rows, each layer's output and the
final-normed hidden state of the real positions; a tensor on the card is
copied to the host once per record, so tracing is for debugging runs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

FIRST_N = 8


def _host_f32(arr) -> np.ndarray:
    """A numpy array, or a torch tensor on any device in any dtype, as a
    host float32 array."""
    if hasattr(arr, "detach"):
        import torch

        return arr.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(arr, dtype=np.float32)


@dataclass
class TraceRecord:
    name: str
    shape: tuple[int, ...]
    rms: float
    first: list[float]

    @classmethod
    def of(cls, name: str, arr) -> "TraceRecord":
        a = _host_f32(arr)
        rms = float(np.sqrt(np.mean(a * a))) if a.size else 0.0
        return cls(name=name, shape=tuple(a.shape), rms=rms,
                   first=[float(x) for x in a.reshape(-1)[:FIRST_N]])

    def to_dict(self) -> dict:
        return {"name": self.name, "shape": list(self.shape),
                "rms": self.rms, "first": self.first}


@dataclass
class TraceSink:
    records: list[TraceRecord] = field(default_factory=list)
    enabled: bool = True

    def record(self, name: str, arr) -> None:
        if self.enabled:
            self.records.append(TraceRecord.of(name, arr))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([r.to_dict() for r in self.records], f, indent=2)

    @classmethod
    def load(cls, path: str) -> "TraceSink":
        with open(path) as f:
            data = json.load(f)
        return cls(records=[
            TraceRecord(name=d["name"], shape=tuple(d["shape"]),
                        rms=d["rms"], first=d["first"])
            for d in data
        ])


def compare_records(
    ours: list[TraceRecord],
    theirs: list[TraceRecord],
    rms_rtol: float = 0.02,
) -> list[dict]:
    """RMS-tolerance diff (``bitnet-trace/src/lib.rs:197``); returns
    mismatches with the first divergent tensor first."""
    by_name = {r.name: r for r in theirs}
    diffs = []
    for r in ours:
        o = by_name.get(r.name)
        if o is None:
            diffs.append({"name": r.name, "error": "missing in other trace"})
            continue
        if r.shape != o.shape:
            diffs.append({"name": r.name, "error":
                          f"shape {r.shape} vs {o.shape}"})
            continue
        denom = max(abs(o.rms), 1e-9)
        rel = abs(r.rms - o.rms) / denom
        if rel > rms_rtol:
            diffs.append({"name": r.name, "error":
                          f"rms {r.rms:.6g} vs {o.rms:.6g} (rel {rel:.3g})"})
    return diffs
