"""Kernel registry: the port's hand-written kernels, what each replaces,
and their launch counters.

Counterpart of ``bitnet_tpu/ops/registry.py:28-64``.  Each kernel's
wrapper carries a plain integer ``launches`` that it bumps where it
launches its CUDA kernel and nowhere else; a run that zeroes the counters
before the main path and reads them after shows which kernels the path
really went through.  The plain PyTorch versions that run for CPU tensors
are not kernels and count nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .decode_attention_v2 import decode_attention_qkv, scatter_kv_rows
from .ternary_matmul import ternary_matmul_w2a8, ternary_matmul_w2a8_normed


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    kernel_id: str
    route: str                 # 'cuda' | 'triton'
    source: str                # path in the repo
    replaces: str              # file:line of the Pallas kernel's pallas_call
    wrapper: Callable


REGISTRY: tuple[KernelSpec, ...] = (
    KernelSpec("ternary_matmul_w2a8_normed", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul.cu",
               "bitnet_tpu/ops/ternary_matmul.py:375",
               ternary_matmul_w2a8_normed),
    KernelSpec("decode_attention_qkv", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:922",
               decode_attention_qkv),
    KernelSpec("scatter_kv_rows", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:1113",
               scatter_kv_rows),
    KernelSpec("ternary_matmul_w2a8", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul.cu",
               "bitnet_tpu/ops/ternary_matmul.py:464",
               ternary_matmul_w2a8),
)


def launch_counts() -> dict[str, int]:
    return {k.kernel_id: k.wrapper.launches for k in REGISTRY}


def reset_launch_counts() -> None:
    for k in REGISTRY:
        k.wrapper.launches = 0
