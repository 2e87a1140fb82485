"""Device probing and device resolution.

Counterpart of ``bitnet_tpu/device_probe.py:70``, where the JAX package
sets ``supports_pallas = platform == "tpu"``.  Here the kernels are
compiled for ``sm_90a`` only, so they are usable exactly when the device
is a CUDA card of compute capability 9.0 (H100 / H200).
"""

from __future__ import annotations

import dataclasses

import torch

from .errors import ConfigError, KernelError


@dataclasses.dataclass(frozen=True)
class DeviceProbe:
    platform: str                   # 'gpu' | 'cpu'
    device_kind: str                # torch.cuda.get_device_name, or 'cpu'
    num_devices: int
    sm: tuple[int, int] | None      # compute capability, None on CPU
    supports_kernels: bool          # the sm_90a CUDA kernels can run


def probe_device(index: int = 0) -> DeviceProbe:
    if not torch.cuda.is_available():
        return DeviceProbe("cpu", "cpu", 0, None, False)
    sm = torch.cuda.get_device_capability(index)
    return DeviceProbe(
        platform="gpu",
        device_kind=torch.cuda.get_device_name(index),
        num_devices=torch.cuda.device_count(),
        sm=sm,
        supports_kernels=sm == (9, 0),
    )


def require_sm90(index: int = 0) -> DeviceProbe:
    """Fail unless device ``index`` is an sm_90 card (the kernels' target)."""
    p = probe_device(index)
    if not p.supports_kernels:
        raise KernelError(
            f"bitnet_tpu_torch kernels need an sm_90 (Hopper) card; found "
            f"{p.device_kind} (sm {p.sm})")
    return p


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; a caller
    that wants the CPU (the plain PyTorch versions of the kernels) must
    say so — a missing card is an error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        require_sm90(dev.index or 0)
    elif dev.type != "cpu":
        raise ConfigError(f"unsupported device {dev}")
    return dev
