"""Multi-model manager for the server.

Parity with the reference's model manager/registry
(``bitnet-server/src/{model_manager,model_registry}.rs`` and the
``/v1/models`` load/list/get/unload routes, ``src/lib.rs:265-282``): named
models load on demand, each owning its continuous-batching scheduler; one
is the default for requests that don't name a model.

Counterpart of ``bitnet_tpu/serve/model_manager.py``, on the manager's
device (the card unless the caller asks for ``"cpu"``).  Every loaded
model holds device memory (weights + its scheduler's KV slots): the
manager checks the memory estimate before loading.  A load reads the GGUF
on the calling thread, and its device work (the weights' copy, the memory
check, the scheduler's preparation) runs on the device loop's thread
between pool steps, so a second model loads while the first serves; both
loops then run on that thread.
"""

from __future__ import annotations

import threading
import time

from ..config import EngineConfig
from ..device_probe import resolve_device
from ..errors import ConfigError, InferenceError, ModelError


def _detect_template(path: str):
    """Chat-template detection from GGUF metadata (embedded jinja
    ``tokenizer.chat_template`` → name heuristics), same as the CLI chat
    path — the server must not hardcode ChatML (VERDICT weak #9).

    Returns ``(family_type, jinja_str|None, special_tokens)`` — when the
    GGUF embeds a jinja template the server EXECUTES it (sandboxed,
    templates/jinja.py) and the family type is the fallback."""
    from .. import templates
    from ..templates.jinja import special_token_strings

    if not path:
        return templates.TemplateType.CHATML, None, {}
    try:
        from ..gguf.reader import GGUFReader

        with GGUFReader(path) as r:
            md = r.metadata
            jinja = md.get("tokenizer.chat_template")
            if not isinstance(jinja, str) or not jinja.strip():
                jinja = None
            toks = special_token_strings(md) if jinja else {}
            return templates.detect(md), jinja, toks
    except Exception:
        return templates.TemplateType.CHATML, None, {}


class ModelEntry:
    def __init__(self, name: str, path: str, scheduler):
        self.name = name
        self.path = path
        self.scheduler = scheduler
        self.loaded_at = time.time()
        (self.template, self.chat_template_jinja,
         self.special_tokens) = _detect_template(path)

    def info(self) -> dict:
        cfg = self.scheduler.cfg
        return {
            "name": self.name,
            "path": self.path,
            "architecture": cfg.architecture,
            "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size,
            "max_seq_len": self.scheduler.engine_cfg.max_seq_len,
            "loaded_at": self.loaded_at,
            "chat_template": self.template.value,
            "embedded_chat_template": self.chat_template_jinja is not None,
        }


class ModelManager:
    def __init__(self, engine_cfg: EngineConfig | None = None,
                 num_slots: int = 4, max_models: int = 2, mesh=None,
                 device="cuda"):
        if mesh is not None:
            from ..config import not_ported

            raise not_ported("multi-host / mesh scheduling (mesh)", "#13")
        self.engine_cfg = engine_cfg or EngineConfig()
        self.num_slots = num_slots
        self.max_models = max_models
        self.mesh = None
        self.device = resolve_device(device)
        self._models: dict[str, ModelEntry] = {}
        self._default: str | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ load/unload
    def load(self, name: str, path: str,
             make_default: bool = False) -> dict:
        import torch

        from ..models.loader import load_model
        from ..models.memory import validate_memory
        from ..tokenizer import load_tokenizer
        from .scheduler import ContinuousBatchingScheduler, run_on_device

        with self._lock:
            if name in self._models:
                raise InferenceError(f"model {name!r} already loaded")
            if len(self._models) >= self.max_models:
                raise InferenceError(
                    f"max_models={self.max_models} reached; unload one first")
        ecfg = self.engine_cfg
        dtype = torch.float32 if ecfg.compute_dtype == "f32" else torch.bfloat16
        # the file is read here; the weights reach the device on its thread
        cfg, params, _report = load_model(path, param_dtype=dtype, device="cpu")
        if ecfg.max_seq_len > cfg.max_seq_len:
            ecfg = ecfg.replace(max_seq_len=cfg.max_seq_len)
        tokenizer = load_tokenizer(path)
        dev = self.device

        def place():
            validate_memory(cfg, strict=False, device=dev)
            validate_memory(cfg, ecfg, strict=False, device=dev)
            return params.to(dev)
        sched = ContinuousBatchingScheduler(cfg, run_on_device(dev, place), tokenizer,
                                            ecfg, num_slots=self.num_slots, device=dev)
        entry = ModelEntry(name, path, sched)
        with self._lock:
            self._models[name] = entry
            if make_default or self._default is None:
                self._default = name
        return entry.info()

    def unload(self, name: str) -> None:
        with self._lock:
            entry = self._models.pop(name, None)
            if entry is None:
                raise ModelError(f"model {name!r} not loaded")
            if self._default == name:
                self._default = next(iter(self._models), None)
        entry.scheduler.shutdown()

    def adopt(self, name: str, scheduler, path: str = "",
              make_default: bool = True) -> None:
        """Register an externally built scheduler (serve() startup path); it
        must run on the manager's device."""
        if scheduler.device.type != self.device.type:
            raise ConfigError(f"scheduler on {scheduler.device}, manager on "
                              f"{self.device}: pass the manager's device")
        with self._lock:
            self._models[name] = ModelEntry(name, path, scheduler)
            if make_default or self._default is None:
                self._default = name

    # ------------------------------------------------------------ lookup
    def get(self, name: str | None = None):
        with self._lock:
            key = name or self._default
            if key is None or key not in self._models:
                raise ModelError(f"model {name or '<default>'} not loaded")
            return self._models[key].scheduler

    def info(self, name: str) -> dict:
        with self._lock:
            if name not in self._models:
                raise ModelError(f"model {name!r} not loaded")
            return self._models[name].info()

    def list(self) -> list[dict]:
        with self._lock:
            return [e.info() for e in self._models.values()]

    def template_for(self, scheduler):
        """Detected chat template of the entry owning ``scheduler``
        (ChatML fallback for adopted schedulers with no path)."""
        from .. import templates

        with self._lock:
            for e in self._models.values():
                if e.scheduler is scheduler:
                    return e.template
        return templates.TemplateType.CHATML

    def entry_for(self, scheduler):
        """ModelEntry owning ``scheduler`` (None for adopted ones)."""
        with self._lock:
            for e in self._models.values():
                if e.scheduler is scheduler:
                    return e
        return None

    @property
    def default_name(self) -> str | None:
        return self._default

    def shutdown(self) -> None:
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
            self._default = None
        for e in entries:
            e.scheduler.shutdown()


class RateLimiter:
    """Token-bucket per client IP + manual blocklist
    (bitnet-server/src/security.rs parity)."""

    def __init__(self, rate_per_s: float = 10.0, burst: int = 20):
        self.rate = rate_per_s
        self.burst = burst
        self._buckets: dict[str, tuple[float, float]] = {}
        self._blocked: set[str] = set()
        self._lock = threading.Lock()

    def block(self, ip: str) -> None:
        with self._lock:
            self._blocked.add(ip)

    def unblock(self, ip: str) -> None:
        with self._lock:
            self._blocked.discard(ip)

    def is_blocked(self, ip: str) -> bool:
        with self._lock:
            return ip in self._blocked

    def allow(self, ip: str) -> bool:
        now = time.monotonic()
        with self._lock:
            if ip in self._blocked:
                return False
            tokens, last = self._buckets.get(ip, (float(self.burst), now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens < 1.0:
                self._buckets[ip] = (tokens, now)
                return False
            self._buckets[ip] = (tokens - 1.0, now)
            return True

    def cleanup(self, max_age_s: float = 600.0) -> int:
        """Drop idle buckets (server background task parity)."""
        now = time.monotonic()
        with self._lock:
            stale = [ip for ip, (_, last) in self._buckets.items()
                     if now - last > max_age_s]
            for ip in stale:
                del self._buckets[ip]
            return len(stale)
