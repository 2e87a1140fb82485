"""Failure detection & recovery: error classification, retry with
backoff, graceful degradation, and model failover routing.

Counterpart of ``bitnet_tpu/serve/recovery.py``, a copy over the port's
``errors`` (a model's loop is alive by ``scheduler.alive``).

Parity with the reference's recovery stack
(``bitnet-gpu-hal/src/error_recovery.rs:14-459`` — ``ErrorClassifier``,
``RetryPolicy`` backoff strategies, ``GracefulDegradation`` levels;
``bitnet-server/src/execution_router.rs:29-151`` health-gated failover).
On a one-card host there are no alternate *devices*, so failover routes
across loaded *models* (the multi-model manager) and degradation sheds
load by capping generation length under queue pressure.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import time

from ..errors import (
    BitNetError,
    ConfigError,
    FormatError,
    InferenceError,
    ModelError,
    SecurityError,
    TokenizerError,
)


class ErrorClass(enum.Enum):
    TRANSIENT = "transient"      # retry may succeed (timeouts, contention)
    RESOURCE = "resource"        # memory/slots exhausted — retry later
    PERMANENT = "permanent"      # bad input/model — retrying is useless


def classify_error(exc: BaseException) -> ErrorClass:
    """``ErrorClassifier`` (error_recovery.rs:14+)."""
    if isinstance(exc, (TimeoutError, ConnectionError, BrokenPipeError)):
        return ErrorClass.TRANSIENT
    if isinstance(exc, MemoryError):
        return ErrorClass.RESOURCE
    if isinstance(exc, (ConfigError, FormatError, SecurityError,
                        TokenizerError, ModelError)):
        return ErrorClass.PERMANENT
    if isinstance(exc, InferenceError):
        msg = str(exc).lower()
        if any(k in msg for k in ("exhausted", "timed out", "timeout",
                                  "no free slot", "queue")):
            return ErrorClass.RESOURCE
        return ErrorClass.PERMANENT
    if isinstance(exc, BitNetError):
        return ErrorClass.PERMANENT
    # unknown runtime faults (device resets, RPC hiccups) → transient
    return ErrorClass.TRANSIENT


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter (error_recovery.rs RetryPolicy)."""

    max_retries: int = 2
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay_s * (self.multiplier ** attempt),
                self.max_delay_s)
        return d * (1.0 + random.uniform(-self.jitter, self.jitter))

    def should_retry(self, exc: BaseException, attempt: int) -> bool:
        if attempt >= self.max_retries:
            return False
        return classify_error(exc) in (ErrorClass.TRANSIENT,
                                       ErrorClass.RESOURCE)

    def run(self, fn, *args, **kwargs):
        """Call ``fn`` with retries; re-raises the final failure."""
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self.should_retry(e, attempt):
                    raise
                time.sleep(self.delay(attempt))
                attempt += 1


class DegradationLevel(enum.Enum):
    NORMAL = 0
    REDUCED = 1       # cap generation length
    MINIMAL = 2       # short answers only, shed queued load fast


@dataclasses.dataclass
class GracefulDegradation:
    """Queue-pressure-driven load shedding (error_recovery.rs
    GracefulDegradation levels).

    Level is derived from the scheduler queue depth relative to the slot
    count; ``cap_tokens`` bounds ``max_new_tokens`` per level.
    """

    reduced_at: float = 4.0      # queue depth ≥ 4× slots
    minimal_at: float = 16.0
    reduced_cap: int = 256
    minimal_cap: int = 64

    def level(self, queue_depth: int, num_slots: int) -> DegradationLevel:
        slots = max(1, num_slots)
        ratio = queue_depth / slots
        if ratio >= self.minimal_at:
            return DegradationLevel.MINIMAL
        if ratio >= self.reduced_at:
            return DegradationLevel.REDUCED
        return DegradationLevel.NORMAL

    def cap_tokens(self, level: DegradationLevel, requested: int) -> int:
        if level == DegradationLevel.MINIMAL:
            return min(requested, self.minimal_cap)
        if level == DegradationLevel.REDUCED:
            return min(requested, self.reduced_cap)
        return requested


class FailoverRouter:
    """Health-gated model routing (execution_router.rs:29-151).

    Routes a request to the healthiest loaded model: the requested model
    when its scheduler thread is alive and its queue isn't saturated,
    else the configured fallback chain in order.  Single-device hosts
    fail over across MODELS; multi-host failover rides the mesh.
    """

    def __init__(self, manager, fallback: list[str] | None = None,
                 saturation: float = 32.0):
        self.manager = manager
        self.fallback = fallback or []
        self.saturation = saturation
        self.routed_fallback = 0

    def _healthy(self, sched) -> bool:
        if not sched.alive:
            return False
        depth = sched.stats.get("queue_depth", 0)
        return depth < self.saturation * max(1, sched.B)

    def route(self, model_name: str | None = None):
        """Returns (scheduler, model_name) — raises when nothing healthy."""
        names = []
        if model_name:
            names.append(model_name)
        else:
            if self.manager.default_name:
                names.append(self.manager.default_name)
        names += [n for n in self.fallback if n not in names]
        last_exc: BaseException | None = None
        for i, name in enumerate(names):
            try:
                sched = self.manager.get(name)
            except BitNetError as e:
                last_exc = e
                continue
            if self._healthy(sched):
                if i > 0:
                    self.routed_fallback += 1
                return sched, name
            last_exc = InferenceError(f"model {name!r} unhealthy/saturated")
        raise last_exc or InferenceError("no healthy model to route to")
