"""OTLP/HTTP metrics exporter (OpenTelemetry wire format, JSON encoding).

Counterpart of ``bitnet_tpu/obs/otlp.py``, a copy: the same payload, the
same scope name and resource attributes, so a collector sees one service.

Parity with the reference's OTLP pipeline
(``bitnet-server/src/monitoring/{otlp,opentelemetry}.rs``) without an SDK
dependency: gauges/counters are encoded as OTLP ``ExportMetricsServiceRequest``
JSON (the ``application/json`` encoding every OpenTelemetry collector
accepts on ``/v1/metrics``) and POSTed on a background interval.

Zero-egress safe: nothing is exported unless an endpoint is configured
(``OTEL_EXPORTER_OTLP_ENDPOINT`` or explicit argument); failures are
counted, never raised into the serving path.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from typing import Callable

DEFAULT_INTERVAL_S = 15.0


def _now_ns() -> int:
    return time.time_ns()


def encode_metrics(metrics: dict[str, float],
                   resource_attrs: dict[str, str] | None = None,
                   start_ns: int | None = None) -> dict:
    """{name: value} → OTLP ExportMetricsServiceRequest (JSON form).

    Counters (monotonic names ending in ``_total``) become sums; the rest
    become gauges.
    """
    t = _now_ns()
    start = start_ns if start_ns is not None else t
    attrs = [{"key": k, "value": {"stringValue": str(v)}}
             for k, v in (resource_attrs or {}).items()]
    out_metrics = []
    for name, value in sorted(metrics.items()):
        dp = {"timeUnixNano": str(t), "asDouble": float(value)}
        if name.endswith("_total"):
            dp["startTimeUnixNano"] = str(start)
            body = {"sum": {"dataPoints": [dp],
                            "aggregationTemporality":
                                2,  # AGGREGATION_TEMPORALITY_CUMULATIVE
                            "isMonotonic": True}}
        else:
            body = {"gauge": {"dataPoints": [dp]}}
        out_metrics.append({"name": f"bitnet.{name}", **body})
    return {
        "resourceMetrics": [{
            "resource": {"attributes": attrs},
            "scopeMetrics": [{
                "scope": {"name": "bitnet_tpu"},
                "metrics": out_metrics,
            }],
        }],
    }


class OTLPExporter:
    """Background OTLP/HTTP pusher for a metrics-callback."""

    def __init__(
        self,
        collect: Callable[[], dict[str, float]],
        endpoint: str | None = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        resource_attrs: dict[str, str] | None = None,
        timeout_s: float = 5.0,
    ):
        self.collect = collect
        ep = endpoint or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
        self.endpoint = (ep.rstrip("/") + "/v1/metrics") if ep else None
        self.interval_s = interval_s
        self.resource_attrs = resource_attrs or {
            "service.name": "bitnet-tpu"}
        self.timeout_s = timeout_s
        self._start_ns = _now_ns()
        self.exported = 0
        self.failed = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def enabled(self) -> bool:
        return self.endpoint is not None

    def export_once(self) -> bool:
        """One synchronous push; returns success (False when disabled)."""
        if not self.enabled:
            return False
        try:
            payload = encode_metrics(self.collect(), self.resource_attrs,
                                     self._start_ns)
            req = urllib.request.Request(
                self.endpoint,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                ok = 200 <= r.status < 300
        except Exception:
            ok = False
        if ok:
            self.exported += 1
        else:
            self.failed += 1
        return ok

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.export_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + 1)
            self._thread = None
