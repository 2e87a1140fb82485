"""What the kernel timelines (``attn_timeline``, ``k1_timeline``) share:
``%globaltimer`` stamps put beside fixed source lines of a copy of a kernel
source, a reader that copies the stamp arrays to the host, and that copy
built into ``csrc/build/<dir>/`` (git-ignored) and loaded in place of the
committed library.  The committed kernels carry no stamp.  Each tool keeps
only its anchors, its stamp macros and its cases.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

from ..ops import _cuda

# the device clock, in ns; the stamp macros of a tool call it
NOW = """
__device__ __forceinline__ unsigned long long bn_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""


def reader(fn: str, symbols: tuple[str, ...]) -> str:
    """C source of ``extern "C" int fn(void** host, int clear)``: copies each
    ``__device__`` array of ``symbols`` into ``host[i]``, then, if ``clear``,
    zeroes them all; returns the CUDA error code."""
    body = "".join(f"""
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host[{i}], {s}, sizeof({s}));
  if (e == cudaSuccess && clear) e = cudaGetSymbolAddress(&p, {s});
  if (e == cudaSuccess && clear) e = cudaMemset(p, 0, sizeof({s}));""" for i, s in enumerate(symbols))
    return f"""
extern "C" int {fn}(void** host, int clear) {{
  cudaError_t e = cudaSuccess;
  void* p = nullptr;{body}
  if (e == cudaSuccess && clear) e = cudaDeviceSynchronize();
  return (int)e;
}}
"""


def instrument(src: str, anchors, macros: str, read: str, tool: str) -> str:
    """``src`` with each ``(anchor, stamp, before)`` stamp put before or after
    its anchor, ``NOW`` and ``macros`` after the ``bn`` namespace's import,
    and ``read`` (a :func:`reader`) at the end; raises if an anchor is not
    in the source exactly once."""
    for anchor, stamp, before in anchors:
        if src.count(anchor) != 1:
            raise ValueError(f"{tool}: anchor not found once: {anchor!r}")
        src = src.replace(anchor, stamp + anchor if before else anchor + stamp)
    head = "using namespace bn;\n"
    return src.replace(head, head + NOW + macros, 1) + read


def build(source: str, subdir: str, instrumented, read_fn: str) -> ctypes.CDLL:
    """Copy ``csrc/`` into ``csrc/build/<subdir>/``, rewrite ``<source>.cu``
    there by ``instrumented(text)``, build it with the repo's flags and load
    it with the entry points' ctypes signatures and the reader ``read_fn``;
    install it as the library the wrappers launch."""
    out = _cuda.BUILD_DIR / subdir
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, out, ignore=shutil.ignore_patterns("build"))
    cu = out / f"{source}.cu"
    cu.write_text(instrumented(cu.read_text()))
    so = out / f"{source}_{subdir}.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _cuda.SIGNATURES[source].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"bn_{source}_error")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    rd = getattr(lib, read_fn)
    rd.argtypes, rd.restype = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int], ctypes.c_int
    _cuda._libs[source] = lib
    return lib


def read(lib: ctypes.CDLL, source: str, read_fn: str, arrays, clear: bool) -> None:
    """Copy the stamp arrays into ``arrays`` (ctypes arrays, in the reader's
    order), zeroing them on the card after if ``clear``."""
    host = (ctypes.c_void_p * len(arrays))(*(ctypes.addressof(a) for a in arrays))
    _cuda.check(lib, source, getattr(lib, read_fn)(host, int(clear)), read_fn)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
