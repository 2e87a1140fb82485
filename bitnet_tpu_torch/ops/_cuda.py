"""Build and load the CUDA kernels in ``csrc/`` (nvcc → shared library →
ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` process for ``sm_90a`` into ``csrc/build/<name>-<hash>.so`` (the
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source never loads a stale library).  Nothing is built or imported when this module is imported: a
library is built at its first use, or up front by :func:`build` (which
starts one ``nvcc`` per source, all at once).  Pointers and the stream
are passed as ``c_void_p`` so ctypes never narrows them to 32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..errors import KernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("ternary_matmul", "ternary_matmul_tl", "decode_attention", "ffn_fused",
           "exp_w2a8", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures of the entry points, per source
SIGNATURES: dict[str, dict[str, tuple]] = {
    "ternary_matmul": {
        "bn_w2a8_normed": (P, I, I, I, I, P, F, P, I, P, P, P, I, P, P, P, I,
                           P, I, I, I, I, P),
        "bn_w2a8_gemm": (P, I, I, I, P, I, P, P, I, P, P, P, P, I, I, I, P),
        "bn_w2a8_matmul": (P, I, I, P, I, F, P, P, P, P, I, I, I, P),
        "bn_tl_w2a8_normed": (P, I, I, I, I, P, F, P, I, P, P, P, I, P, P, P, I, I,
                              I, P),
    },
    "ternary_matmul_tl": {
        "bn_blockscale_gemm": (P, I, I, I, I, P, I, P, P, I, P, P, P, I, I, I, I, P),
        "bn_blockscale_decode": (P, I, I, I, P, I, P, P, I, I, I, P),
        "bn_colscale_decode": (P, I, I, I, P, I, P, P, I, I, P),
        "bn_colscale_gemm": (P, I, I, I, I, P, I, P, P, I, P, P, I, I, I, P),
        "bn_tl_bf16_normed": (P, I, I, I, I, P, F, P, I, P, P, P, I, P, I, I, I, I,
                              P),
    },
    "ffn_fused": {
        "bn_ffn_w2a8": (P, I, I, I, I, P, I, P, P, I, P, P, I, I, I, I, I, P, P,
                        P, P, P, P, P, I, P),
    },
    "exp_w2a8": {
        "bn_probe_bytes": (P, P, I, I, P),
        "bn_probe_bf16": (P, P, I, I, P),
        "bn_probe_unpack": (P, P, I, I, P),
        "bn_probe_dot": (P, P, P, I, I, I, I, P),
    },
    "paged_attention": {
        "bn_paged_attention": (P, P, P, P, P, I, I, I, I, I, I, I, I, LL, LL, LL, I,
                               I, I, P, P, P, P),
    },
    "decode_attention": {
        "bn_decode_attention_qkv": (P, P, P, P, P, P, I, I, I, I, I, I, F, P,
                                    P, P, P, P, P, I, I, P),
        "bn_decode_attention_qkv_quant": (P, P, P, P, P, P, P, P, I, I, I, I,
                                          I, I, F, P, P, P, P, P, P, P, P, I,
                                          I, P),
        "bn_scatter_kv_rows": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, P),
        "bn_decode_attention": (P, P, P, P, P, P, P, I, I, I, I, I, I, F, P,
                                P, P, P, I, I, P),
        "bn_decode_attention_quant": (P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                      F, P, P, P, P, I, I, P),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build (nvcc -Xptxas -v)
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                          "are built on the machine that has the card")
    return found


def _so_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together.  Returns wall seconds per source
    (0.0 for one already built).  One process builds at a time: the ranks
    of a mesh on one host (``parallel/``) share ``csrc/build``, so a rank
    waits on the build lock and then finds the libraries another built."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build(names)


def _build(names) -> dict[str, float]:
    procs, t0, secs = {}, time.perf_counter(), {}
    for name in names:
        so = _so_path(name)
        if so.exists():
            secs[name] = 0.0
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _so_path(name)
        if not so.exists():
            build((name,))
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"bn_{name}_error")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = getattr(lib, f"bn_{name}_error")(rc).decode()
        raise KernelError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a cuda device with an
    index), as the raw handle the C entry points take."""
    return torch._C._cuda_getCurrentRawStream(device.index)
