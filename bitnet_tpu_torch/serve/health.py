"""Device + scheduler health monitoring.

Counterpart of ``bitnet_tpu/serve/health.py``: the device through the
port's ``device_probe`` (and, on the card, its memory, read on the
device loop's thread between pool steps), each model's loop, the canary
through ``submit``, the 30 s refresh thread.

Rebuild of the reference's execution-router health layer
(``bitnet-server/src/execution_router.rs:29-151`` per-device health,
``src/lib.rs:318-325`` 30 s background refresh, ``/v1/devices`` route,
``src/canary.rs``): on one card per process
"routing" collapses to (a) is the chip reachable, (b) is each model's
decode thread alive and making progress, (c) canary inference on demand.
"""

from __future__ import annotations

import threading
import time


class HealthMonitor:
    def __init__(self, manager, refresh_s: float = 30.0):
        self.manager = manager
        self.refresh_s = refresh_s
        self._last: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.refresh()

    # ------------------------------------------------------------ checks
    def device_status(self) -> dict:
        """Probe the accelerator (execution_router device health)."""
        try:
            from ..device_probe import probe_device

            p = probe_device()
            status = {
                "platform": p.platform,
                "device_kind": p.device_kind,
                "num_devices": p.num_devices,
                "healthy": True,
            }
            if p.platform == "gpu":
                from ..obs.profiler import device_memory_stats
                from .scheduler import run_on_device

                status["memory"] = run_on_device("cuda", device_memory_stats)
            return status
        except Exception as e:  # chip unreachable
            return {"healthy": False, "error": str(e)}

    def scheduler_status(self) -> list[dict]:
        out = []
        for info in self.manager.list():
            sched = self.manager.get(info["name"])
            thread_alive = sched.alive
            out.append({
                "model": info["name"],
                "thread_alive": thread_alive,
                "active_slots": sched.stats.get("active_slots", 0),
                "queue_depth": sched.stats.get("queue_depth", 0),
                "decode_steps": sched.stats.get("decode_steps", 0),
                "healthy": thread_alive,
            })
        return out

    def refresh(self) -> dict:
        self._last = {
            "checked_at": time.time(),
            "device": self.device_status(),
            "schedulers": self.scheduler_status(),
        }
        self._last["healthy"] = (
            self._last["device"].get("healthy", False)
            and all(s["healthy"] for s in self._last["schedulers"]))
        return self._last

    @property
    def snapshot(self) -> dict:
        return dict(self._last)

    # ------------------------------------------------------------ canary
    def canary(self, max_new_tokens: int = 2, timeout: float = 120.0) -> dict:
        """End-to-end canary inference on the default model
        (bitnet-server/src/canary.rs)."""
        from ..config import GenerationConfig

        try:
            sched = self.manager.get()
        except Exception as e:
            return {"ok": False, "error": f"no model: {e}"}
        t0 = time.time()
        try:
            ids = sched.tokenizer.encode("canary", add_bos=True)
            req = sched.submit(ids, GenerationConfig(
                max_new_tokens=max_new_tokens, greedy=True))
            toks = []
            deadline = time.time() + timeout
            while time.time() < deadline:
                tok, _text, done, _r = req.out.get(
                    timeout=max(0.1, deadline - time.time()))
                if tok is not None:
                    toks.append(tok)
                if done:
                    break
            ok = len(toks) >= 1
            return {"ok": ok, "tokens": len(toks),
                    "latency_s": round(time.time() - t0, 3)}
        except Exception as e:
            return {"ok": False, "error": str(e),
                    "latency_s": round(time.time() - t0, 3)}

    # ------------------------------------------------------------ background
    def start(self) -> None:
        """30 s refresh loop (reference lib.rs:318-325)."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.refresh_s):
                try:
                    self.refresh()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
