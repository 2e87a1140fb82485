"""Inference profiler: phase timers + chrome://tracing export + device traces.

Counterpart of ``bitnet_tpu/obs/profiler.py``:

- **Host phases** (``Profiler.phase``, a copy): prefill / decode-step /
  sampling / detokenize spans, exported as a chrome://tracing JSON (load in
  ``chrome://tracing`` or Perfetto).
- **Device time** from ``torch.profiler`` (``device_trace``), where the JAX
  module owns a ``jax.profiler`` session: CPU and CUDA activity, written as
  a Chrome trace into the log directory.
- **Memory** from the card's caching allocator and ``cudaMemGetInfo``
  (``device_memory_stats``), where the JAX module reads
  ``jax.local_devices()[0].memory_stats()``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Profiler:
    """Thread-safe phase profiler with chrome-trace export."""

    def __init__(self):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.enabled = True

    @contextlib.contextmanager
    def phase(self, name: str, **args):
        """Time a host-side phase: ``with prof.phase("prefill"): ...``"""
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self._events.append({
                    "name": name,
                    "ph": "X",                      # complete event
                    "ts": (start - self._t0) * 1e6,  # µs
                    "dur": (end - start) * 1e6,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() % 100000,
                    "args": args,
                })

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident() % 100000,
                "s": "t", "args": args,
            })

    # -- reporting ------------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate totals per phase name (count, total_ms, mean_ms)."""
        agg: dict[str, list[float]] = {}
        with self._lock:
            for e in self._events:
                if e["ph"] == "X":
                    agg.setdefault(e["name"], []).append(e["dur"] / 1e3)
        return {
            name: {
                "count": len(ds),
                "total_ms": round(sum(ds), 3),
                "mean_ms": round(sum(ds) / len(ds), 3),
                "max_ms": round(max(ds), 3),
            }
            for name, ds in sorted(agg.items())
        }

    def export_chrome_trace(self, path: str) -> None:
        """chrome://tracing / Perfetto-compatible JSON (profiler.rs parity)."""
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._t0 = time.perf_counter()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` session over CPU and CUDA activity; on exit the
    Chrome trace is written to ``<logdir>/trace.json`` (Perfetto opens
    it).  Yields the log directory."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """Best-effort memory stats of the card (``device``, default the
    current one): bytes held by the caching allocator now and at peak, and
    the card's total; the CPU reports none."""
    import torch

    if not torch.cuda.is_available():
        return {"available": False, "platform": "cpu"}
    dev = torch.device("cuda", torch.cuda.current_device() if device is None
                       else torch.device(device).index or 0)
    stats = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "available": True,
        "platform": "gpu",
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": total,
        "bytes_free": free,
    }
