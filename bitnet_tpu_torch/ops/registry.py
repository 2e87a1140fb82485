"""Kernel registry: the port's hand-written kernels, what each replaces,
and their launch counters.

Counterpart of ``bitnet_tpu/ops/registry.py:28-64``.  Each kernel's
wrapper carries a plain integer ``launches`` that it bumps where it
launches its CUDA kernel and nowhere else; a run that zeroes the counters
before the main path and reads them after shows which kernels the path
really went through.  The plain PyTorch versions that run for CPU tensors
are not kernels and count nothing.  A CUDA graph replay runs no Python: the
graph's owner records the counts its capture added (:func:`launch_counts`
before and after), takes them back (the capture launched nothing) and adds
them on every replay (:func:`add_launch_counts`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .decode_attention import (decode_attention, decode_attention_batched_v1,
                               decode_attention_qkv_batched,
                               decode_attention_qkv_quant_batched,
                               decode_attention_qkv_quant_v1,
                               decode_attention_qkv_v1, decode_attention_quant,
                               decode_attention_quant_batched_v1,
                               decode_attention_stacked,
                               decode_attention_stacked_inplace)
from .decode_attention_v2 import (decode_attention_batched,
                                  decode_attention_batched_v2,
                                  decode_attention_perb_v2,
                                  decode_attention_qkv,
                                  decode_attention_qkv_batched_v2,
                                  decode_attention_qkv_quant,
                                  decode_attention_qkv_quant_batched_v2,
                                  decode_attention_quant_batched,
                                  decode_attention_quant_batched_v2,
                                  scatter_kv_rows)
from .ffn_fused import ffn_w2a8_fused
from .paged_attention import paged_attention
from .ternary_matmul import (ternary_matmul_bf16, ternary_matmul_blockscale_bf16,
                             ternary_matmul_tl_bf16_normed,
                             ternary_matmul_tl_w2a8_normed, ternary_matmul_w2a8,
                             ternary_matmul_w2a8_normed)
from .w2a8_probes import (bitcast_i32_to_i8, bytes_to_bf16, int8_dot,
                          unpack_words, w2a8_matmul)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    kernel_id: str
    route: str                 # 'cuda' | 'triton'
    source: str                # path in the repo
    replaces: str              # file:line of each pallas_call it replaces
    wrapper: Callable


REGISTRY: tuple[KernelSpec, ...] = (
    KernelSpec("ternary_matmul_w2a8_normed", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul.cu",
               "bitnet_tpu/ops/ternary_matmul.py:375 and :1073",
               ternary_matmul_w2a8_normed),
    KernelSpec("decode_attention_qkv", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:922",
               decode_attention_qkv),
    KernelSpec("scatter_kv_rows", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:1113 (bf16, int8 and "
               "fp8 rows)",
               scatter_kv_rows),
    KernelSpec("ternary_matmul_w2a8", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul.cu",
               "bitnet_tpu/ops/ternary_matmul.py:464 and :1177 (w2a8 body)",
               ternary_matmul_w2a8),
    KernelSpec("decode_attention", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention.py:960",
               decode_attention),
    KernelSpec("ternary_matmul_bf16", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul_tl.cu",
               "bitnet_tpu/ops/ternary_matmul.py:1177 (bf16 qk256 body)",
               ternary_matmul_bf16),              # decode form (M <= MB) and GEMM
    KernelSpec("decode_attention_qkv_quant", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:1021",
               decode_attention_qkv_quant),
    KernelSpec("decode_attention_batched", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:735",
               decode_attention_batched),
    KernelSpec("decode_attention_quant_batched", "cuda",
               "bitnet_tpu_torch/csrc/decode_attention.cu",
               "bitnet_tpu/ops/decode_attention_v2.py:820",
               decode_attention_quant_batched),
    KernelSpec("ternary_matmul_blockscale_bf16", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul_tl.cu",
               "bitnet_tpu/ops/ternary_matmul.py:1177 (bitnet32/TL body) "
               "and :555",
               ternary_matmul_blockscale_bf16),   # decode form (M <= MB) and GEMM
    KernelSpec("ternary_matmul_tl_w2a8_normed", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul.cu",
               "bitnet_tpu/ops/ternary_matmul.py:960",
               ternary_matmul_tl_w2a8_normed),
    KernelSpec("ternary_matmul_tl_bf16_normed", "cuda",
               "bitnet_tpu_torch/csrc/ternary_matmul_tl.cu",
               "bitnet_tpu/ops/ternary_matmul.py:733",
               ternary_matmul_tl_bf16_normed),
    # slice 5: every other decode-attention site, on the split-S kernel
    *(KernelSpec(wrapper.__name__, "cuda",
                 "bitnet_tpu_torch/csrc/decode_attention.cu",
                 f"bitnet_tpu/ops/{site}", wrapper)
      for wrapper, site in (
          (decode_attention_qkv_v1, "decode_attention.py:488"),
          (decode_attention_qkv_quant_v1, "decode_attention.py:859"),
          (decode_attention_quant, "decode_attention.py:655"),
          (decode_attention_batched_v1, "decode_attention.py:1114"),
          (decode_attention_quant_batched_v1, "decode_attention.py:1262"),
          (decode_attention_qkv_batched, "decode_attention.py:1421"),
          (decode_attention_qkv_quant_batched, "decode_attention.py:1609"),
          (decode_attention_qkv_batched_v2, "decode_attention_v2.py:487"),
          (decode_attention_qkv_quant_batched_v2, "decode_attention_v2.py:582"),
          (decode_attention_batched_v2, "decode_attention_v2.py:1193"),
          (decode_attention_quant_batched_v2, "decode_attention_v2.py:1291"))),
    # slice 6: the fused W2A8 FFN (the JAX KernelSpec ffn_w2a8_fused_pallas,
    # bitnet_tpu/ops/registry.py:46)
    KernelSpec("ffn_w2a8_fused", "cuda", "bitnet_tpu_torch/csrc/ffn_fused.cu",
               "bitnet_tpu/ops/ffn_fused.py:148", ffn_w2a8_fused),
    # slice 7: the two stacked-cache kernels and the per-b v2 kernel (K25-K27)
    # on the split-S kernel, and the W2A8 experiment's probes and prototype
    # (K28-K32), reached through the port's two experiment entry points
    *(KernelSpec(wrapper.__name__, "cuda",
                 "bitnet_tpu_torch/csrc/decode_attention.cu",
                 f"bitnet_tpu/ops/{site}", wrapper)
      for wrapper, site in (
          (decode_attention_stacked, "decode_attention.py:204"),
          (decode_attention_stacked_inplace, "decode_attention.py:334"),
          (decode_attention_perb_v2, "decode_attention_v2.py:278"))),
    *(KernelSpec(wrapper.__name__, "cuda", "bitnet_tpu_torch/csrc/exp_w2a8.cu",
                 f"experiments/exp_w2a8.py:{site}", wrapper)
      for wrapper, site in ((bitcast_i32_to_i8, "55"), (int8_dot, "75 and :84"),
                            (bytes_to_bf16, "99"), (unpack_words, "146"))),
    # K32 runs K4's two kernels, the GEMM in its per-tensor-scale mode
    KernelSpec("w2a8_matmul", "cuda", "bitnet_tpu_torch/csrc/ternary_matmul.cu",
               "experiments/exp_w2a8.py:201", w2a8_matmul),
    # slice 21: K33, JAX's stock Pallas paged attention (its pallas_call is in
    # the JAX library), called by the paged variant of exp_r4_attn and serving
    # the paged scheduler's decode step
    KernelSpec("paged_attention", "cuda", "bitnet_tpu_torch/csrc/paged_attention.cu",
               "jax.experimental.pallas.ops.tpu.paged_attention, called at "
               "experiments/exp_r4_attn.py:63-88", paged_attention),
)


def launch_counts() -> dict[str, int]:
    return {k.kernel_id: k.wrapper.launches for k in REGISTRY}


def reset_launch_counts() -> None:
    for k in REGISTRY:
        k.wrapper.launches = 0


def add_launch_counts(delta: dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``delta[kernel_id]`` to each kernel's counter (a
    negative ``times`` takes counts back)."""
    wrappers = {k.kernel_id: k.wrapper for k in REGISTRY}
    for kid, n in delta.items():
        wrappers[kid].launches += times * n
