"""Build and load the port's CUDA kernels.

All sources under ``vqattack_tpu_torch/csrc/`` are compiled by ONE ``nvcc``
call into one shared library with a plain C interface, which is loaded with
``ctypes``.  Nothing here includes PyTorch's headers, so the build takes
seconds and needs neither ``ninja`` nor a JIT compile at first launch.

The library lands in ``build/kernels/<hash of the sources>/`` at the root of
the checkout (git ignores ``build/``) and is reused while the sources are
unchanged.  Nothing is built when the module is imported: the first kernel
launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("pgd_update.cu", "fused_ln.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types; every entry point returns cudaGetLastError()
SIGNATURES = {
    "vq_pgd_linf_update": (_P, _P, _P, _P, _LL, _F, _F, _F, _F, _P),
    "vq_residual_layernorm_fwd": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "vq_residual_layernorm_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _F, _P),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _PKG.parent / "build" / "kernels" / source_hash() / "libvqattack_kernels.so"


def build() -> Path:
    """Compile the sources if this version is not built yet; returns the
    library's path.  Prints the build time."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    print(f"[kernels] nvcc built {out} in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry point's
    ``argtypes``/``restype`` set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
