"""Tensor ops: plain PyTorch ops and the wrappers of the CUDA kernels."""
