#!/usr/bin/env python3
"""K2's backward (``csrc/fused_ln.cu``) in four builds, timed in turns on
one card: the source as it is; with ``__ldg`` loads in place of the
evict-first ``__ldcs``; with no row loaded ahead of the one being reduced;
and with two rows ahead where they fit in the register budget.

    python3 scripts/k2_bwd_variants.py

Each variant is the checkout's source with one line changed, compiled by
``nvcc`` alone into ``build/variants/`` and loaded in place of the kernel
library, so the wrapper (``ops/fused_ln.py``) and its partition are the
same for all.  At [7208, 768] and [14416, 768] on a float32 and a bf16
stream it checks each variant's dx against the plain version and prints
its device time (``chip_smoke.time_ms``: L2 emptied, the stream held),
without and with parameter gradients, in the order committed, ldg,
no_ahead, two_ahead, committed: the two readings of the committed source
show the spread.  Needs one CUDA device.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vqattack_tpu_torch.ops import _build, fused_ln  # noqa: E402

SOURCE = os.path.join(ROOT, "vqattack_tpu_torch", "csrc", "fused_ln.cu")
OUT = os.path.join(ROOT, "build", "variants")
PREFETCH = "constexpr int kMaxPrefetchWords = 72;"
AHEAD = "constexpr int kAhead = kWords <= kMaxPrefetchWords ? 1 : 0;"
TWO_AHEAD = ("constexpr int kAhead = 2 * kWords <= kMaxPrefetchWords ? 2 "
             ": (kWords <= kMaxPrefetchWords ? 1 : 0);")


def variants() -> dict:
    src = open(SOURCE).read()
    for line in ("__ldcs(", PREFETCH, AHEAD):
        if line not in src:
            raise RuntimeError(f"{SOURCE} has no {line!r}: the variants no longer apply")
    return {
        "committed": src,
        "ldg": src.replace("__ldcs(", "__ldg("),
        "no_ahead": src.replace(PREFETCH, "constexpr int kMaxPrefetchWords = 0;"),
        "two_ahead": src.replace(AHEAD, TWO_AHEAD),
    }


def build(sources: dict) -> dict:
    """One ``nvcc`` a variant, all started together; each library loaded
    with K2's entry points typed as ``_build`` types them."""
    os.makedirs(OUT, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *flags, "-shared", "-o", os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err[-2000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        for fn in ("vq_residual_layernorm_fwd", "vq_residual_layernorm_bwd"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    libs = build(variants())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (7208, 14416):
            x, delta, gamma, beta, gs, gh = cs._ln_case(gen, rows, dtype)
            s, _ = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
            cases[(str(dtype)[6:], rows)] = (s, gs, gh, gamma)
    for name in ("committed", "ldg", "no_ahead", "two_ahead", "committed"):
        _build._LIB = libs[name]  # the wrapper launches this variant's kernel
        for (dt, rows), (s, gs, gh, gamma) in cases.items():
            dx = fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6, param_grads=False)[0]
            ref = fused_ln.residual_layernorm_bwd_reference(s, gs, gh, gamma, 1e-6, False)[0]
            cs._close(f"{name} {dt} {rows}", dx, ref, s.dtype)
            ms = cs.time_ms(lambda: fused_ln.residual_layernorm_bwd(
                s, gs, gh, gamma, 1e-6, param_grads=False))
            pg = cs.time_ms(lambda: fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6))
            print(f"variant {name} {dt} [{rows}, 768]: {ms * 1e3:.2f} us, param_grads "
                  f"{pg * 1e3:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
