"""Honest-compute inference receipts.

Counterpart of ``bitnet_tpu/verify/receipts.py``, with the same schema
(v1.0.0, ``bitnet-receipts`` ``src/lib.rs:184-233``) and the same
validation gates (``:408-530``): schema check, compute-path check,
kernel-ID sanity, mock-keyword detection (``bitnet-honest-compute``,
``src/lib.rs:9-17``).  The evidence that real kernels ran is the engine's
``kernel_recorder``: the path it took and, for each hand-written kernel
whose wrapper launched it, ``kernel_<registry id>_x<launches>``
(``ops/registry.py``).  ``backend`` is the engine's device type (``cuda``
or ``cpu``); ``environment`` names the card and its power limit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import subprocess
import time
from dataclasses import dataclass, field

SCHEMA_VERSION = "1.0.0"
REAL_COMPUTE_PATH = "real"
MOCK_COMPUTE_PATH = "mock"
MOCK_KEYWORDS = ("mock", "fake", "stub", "dummy", "simulated")
MAX_KERNEL_ID_LEN = 128
MAX_KERNEL_COUNT = 4096


@dataclass
class InferenceReceipt:
    schema_version: str = SCHEMA_VERSION
    compute_path: str = REAL_COMPUTE_PATH
    backend: str = "cuda"
    kernels: list[str] = field(default_factory=list)
    deterministic: bool = False
    environment: dict = field(default_factory=dict)
    model_info: dict = field(default_factory=dict)
    performance: dict = field(default_factory=dict)
    parity: dict | None = None
    # the generation request + output for deterministic replay
    request: dict | None = None
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "InferenceReceipt":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def fingerprint(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()


def _is_mock_kernel(kernel_id: str) -> bool:
    """Case-insensitive mock detection (receipts lib.rs:255-285)."""
    kl = kernel_id.lower()
    return any(kw in kl for kw in MOCK_KEYWORDS)


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, or why it could not be read."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {e}"
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        return f"unavailable: nvidia-smi rc={r.returncode}"
    return lines[0]


def _environment(device) -> dict:
    import torch

    env = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device),
    }
    if device.type == "cuda":
        env["device_name"] = torch.cuda.get_device_name(device)
        env["nvidia_smi"] = nvidia_smi_line()
    return env


def generate_receipt(engine, metrics: dict | None = None,
                     parity: dict | None = None,
                     request: dict | None = None) -> InferenceReceipt:
    """Build a receipt from an engine's kernel recorder
    (``bitnet-inference/src/kernel_recorder.rs`` equivalent)."""
    kernels = list(engine.kernel_recorder)
    tokenizer_mock = getattr(engine.tokenizer, "is_mock", False)
    if tokenizer_mock:
        kernels.append("tokenizer_mock")
    compute_path = (
        MOCK_COMPUTE_PATH
        if tokenizer_mock or any(_is_mock_kernel(k) for k in kernels)
        else REAL_COMPUTE_PATH
    )
    return InferenceReceipt(
        compute_path=compute_path,
        backend=engine.device.type,
        kernels=kernels,
        deterministic=engine.engine_cfg.strict.deterministic,
        environment=_environment(engine.device),
        model_info={
            "architecture": engine.cfg.architecture,
            "num_layers": engine.cfg.num_layers,
            "hidden_size": engine.cfg.hidden_size,
            "vocab_size": engine.cfg.vocab_size,
            "kinds": getattr(getattr(engine, "load_report", None), "kinds", {}),
        },
        performance=metrics or {},
        parity=parity,
        request=request if request is not None
        else getattr(engine, "_last_request", None),
    )


# --------------------------------------------------------------------------
# Validation gates (lib.rs:408-530)
# --------------------------------------------------------------------------
def validate_receipt(r: InferenceReceipt, strict: bool = True) -> list[str]:
    """Returns a list of violations (empty = valid)."""
    errs: list[str] = []
    if r.schema_version != SCHEMA_VERSION:
        errs.append(f"schema_version {r.schema_version!r} != {SCHEMA_VERSION}")
    if r.compute_path not in (REAL_COMPUTE_PATH, MOCK_COMPUTE_PATH):
        errs.append(f"invalid compute_path {r.compute_path!r}")
    if strict and r.compute_path != REAL_COMPUTE_PATH:
        errs.append("strict: compute_path must be 'real'")
    if len(r.kernels) > MAX_KERNEL_COUNT:
        errs.append(f"too many kernel ids ({len(r.kernels)})")
    for k in r.kernels:
        if not k or len(k) > MAX_KERNEL_ID_LEN:
            errs.append(f"bad kernel id {k!r}")
        if strict and _is_mock_kernel(k):
            errs.append(f"mock kernel recorded: {k!r}")
    if not r.kernels:
        errs.append("no kernels recorded")
    if r.parity is not None and strict:
        if not r.parity.get("passed", False):
            errs.append("parity gate failed")
    return errs
