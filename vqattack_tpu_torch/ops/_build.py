"""Build and load the port's CUDA kernels.

The sources under ``vqattack_tpu_torch/csrc/`` are compiled by one ``nvcc``
process each, all started together, and linked by one more into one shared
library with a plain C interface, which is loaded with ``ctypes``.  Nothing
here includes PyTorch's headers, so the build takes seconds and needs
neither ``ninja`` nor a JIT compile at first launch.

The library lands in ``build/kernels/<hash of the sources>/`` at the root of
the checkout (git ignores ``build/``) and is reused while the sources are
unchanged.  Nothing is built when the module is imported: the first kernel
launch calls :func:`load`.  Pipelined buckets launch from worker threads, so
:func:`build` and :func:`load` run under one lock: concurrent first calls
build and load the library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("pgd_update.cu", "fused_ln.cu", "flash_attention.cu", "flash_attention_tf32.cu",
           "flash_attention_bf16.cu")
HEADERS = ("flash_attention.cuh",)  # included by the sources: part of the version's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel, printed
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types; every entry point returns cudaGetLastError()
SIGNATURES = {
    "vq_pgd_linf_update": (_P, _P, _P, _P, _LL, _F, _F, _F, _F, _P),
    "vq_residual_layernorm_fwd": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # dtype, vec; s, gs, gh, gamma, dx, part, dgdb; rows, D, rows a warp,
    # warps a block; eps; stream
    "vq_residual_layernorm_bwd": (_I, _I) + (_P,) * 7 + (_I,) * 4 + (_F, _P),
    # q, k, v, bias, key bias, out, lse; B, H, Sq, Sk, the rows' width (the
    # head dim); q/k/v (b, s, h), bias (b, h, q, k) and key bias (b) element
    # strides; scale; stream
    "vq_flash_attention_fwd": (_P,) * 7 + (_I,) * 5 + (_LL,) * 14 + (_F, _P),
    # q, k, v, bias, key bias, o, lse, dout, dq, dk, dv, delta, dbias (the
    # bias's gradient, or null); then as the forward
    "vq_flash_attention_bwd": (_P,) * 13 + (_I,) * 5 + (_LL,) * 14 + (_F, _P),
    # head dim, key bias (0 or 1), blocks a cluster -> the dbias instance's
    # cudaOccupancyMaxActiveClusters (or minus a CUDA error)
    "vq_flash_attention_dbias_clusters": (_I, _I, _I),
    # the bfloat16 instances (flash_attention_bf16.cu): the same arguments
    # but dbias, q/k/v, o, dout, dq, dk, dv bfloat16, the rest as above
    # (o and dout in rows of H * D rounded up to 8 elements)
    "vq_flash_attention_bf16_fwd": (_P,) * 7 + (_I,) * 5 + (_LL,) * 14 + (_F, _P),
    "vq_flash_attention_bf16_bwd": (_P,) * 12 + (_I,) * 5 + (_LL,) * 14 + (_F, _P),
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _PKG.parent / "build" / "kernels" / source_hash() / "libvqattack_kernels.so"


_BUILD_LOCK = threading.RLock()
_LIB = None
# ptxas's report (registers, shared memory, spills) of each source compiled
# by this process, by source name
PTXAS_REPORTS: dict = {}


def build() -> Path:
    """Compile the sources if this version is not built yet; returns the
    library's path.  Prints the build time."""
    with _BUILD_LOCK:
        out = library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        # unique per process and thread: another checkout's process may
        # build the same version into the same directory
        stem = f".{out.name}.{os.getpid()}.{threading.get_ident()}"
        nvcc = find_nvcc()
        objs = [out.with_name(f"{stem}.{name}.o") for name in SOURCES]
        t0 = time.perf_counter()
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objs)
        ]
        tmp = out.with_name(f"{stem}.tmp")
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        try:
            for name, cmd, proc in zip(SOURCES, compiles, procs):
                stdout, stderr = proc.communicate()
                _check_run(cmd, proc, stdout, stderr)
                PTXAS_REPORTS[name] = stderr
                print(stderr, end="", file=sys.stderr, flush=True)  # ptxas's report
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            _check_run(link, proc, *proc.communicate())
            os.replace(tmp, out)
        finally:
            for proc in procs:  # a failed compile leaves the others nothing to do
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
        print(f"[kernels] nvcc built {out} in {time.perf_counter() - t0:.2f} s",
              file=sys.stderr, flush=True)
        return out


def _check_run(cmd, proc, stdout: str, stderr: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry point's
    ``argtypes``/``restype`` set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, *counts: str) -> None:
    """Add one to each of ``wrapper``'s counts named in ``counts`` (by
    default ``launches``): a wrapper that launches one of several kernel
    instances counts each instance apart (``bf16_launches``, and a
    flash-attention launch with a key bias also ``key_bias_launches``);
    buckets pipelined over threads launch concurrently, so the count is
    taken under a lock."""
    with _LAUNCH_LOCK:
        for name in counts or ("launches",):
            setattr(wrapper, name, getattr(wrapper, name) + 1)


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
