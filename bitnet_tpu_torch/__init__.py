"""bitnet_tpu_torch: the PyTorch / CUDA (H100, sm_90a) port of bitnet_tpu.

The JAX package ``bitnet_tpu`` stays the reference; this package mirrors
its module names and imports nothing of it.  Slice 1 runs the main path:
GGUF load → fused stacked prefill → B≤2 greedy decode over a flat bf16
KV cache with an int8 tied head, through four hand-written CUDA kernels
(``csrc/``): the decode and prefill W2A8 ternary matmuls, the rope-fused
decode attention, and the KV row scatter.

Entry points default to ``device="cuda"`` and raise when CUDA is absent
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper runs its plain PyTorch version (that is what the tests compare
against the JAX package).
"""
