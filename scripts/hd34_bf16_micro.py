#!/usr/bin/env python3
"""Micro-kernels behind K3-bf16 at head dim 34 (``scripts/hd34_bf16_micro.cu``).

    python3 scripts/hd34_bf16_micro.py

Builds the micro-kernels into ``build/micro/`` and runs each case in a
process of its own (a trapped kernel spoils its process's context):

- ``box_<H>_<row>_<h>``: the folded map's bf16 box, 64 x 64 in the 128-byte
  swizzle, from column ``34 h - (2 h mod 8)`` of a ``[2, 70, row]`` tensor
  with H heads of 34 a row: equal to the tensor's columns there, zeros past
  column ``H * 34`` and past the rows;
- ``mn_<N>``: ``wgmma.m64nNk16`` bf16 with its B operand, 16 rows of 64
  columns in the 128-byte swizzle, read MN-major: within float32 rounding
  of the float64 product of the same bf16 values, at N = 40, 48 and 64.

Prints one line a case, ``ok`` or what differs.  Needs one CUDA device and
``nvcc``; exits 1 if any case fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(HERE), "build", "micro")
LIB = os.path.join(OUT, "libhd34_bf16_micro.so")
CASES = (["box_16_544_%d" % h for h in range(16)]
         + ["box_3_104_2", "box_2_72_1", "box_16_1632_15"] + ["mn_40", "mn_48", "mn_64"])


def _lib():
    lib = ctypes.CDLL(LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.micro_box.argtypes = (p, p, i, i, i, i, i)
    lib.micro_mn.argtypes = (p, p, p, i)
    return lib


def case(name: str) -> bool:
    lib = _lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kind, *args = name.split("_")
    if kind == "box":
        heads, row, h = map(int, args)
        b, s = 2, 70
        x = torch.randn(b, s, row, generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.full((64, 64), float("nan"), device="cuda").to(torch.bfloat16)
        rc = lib.micro_box(x.data_ptr(), out.data_ptr(), b, s, heads, row, h)
        torch.cuda.synchronize()
        start = 34 * h - (2 * h) % 8
        want = torch.zeros(64, 64, device="cuda").to(torch.bfloat16)
        cols = x[0, :64, start:min(start + 64, 34 * heads)]
        want[:cols.shape[0], :cols.shape[1]] = cols
        ok = rc == 0 and torch.equal(out, want)
        print(name, "ok" if ok else f"rc {rc}, equal {torch.equal(out, want)}", flush=True)
        return ok
    n = int(args[0])
    a = torch.randn(64, 16, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn(16, 64, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.full((64, n), float("nan"), device="cuda")
    rc = lib.micro_mn(a.data_ptr(), x.data_ptr(), out.data_ptr(), n)
    torch.cuda.synchronize()
    ref = (a.double() @ x.double())[:, :n]
    err = float((out.double() - ref).abs().max())
    ok = rc == 0 and err <= 1e-5 * float(ref.abs().max())
    print(name, "ok" if ok else f"rc {rc}, max error {err}", flush=True)
    return ok


def main() -> int:
    if len(sys.argv) > 1:
        return 0 if case(sys.argv[1]) else 1
    os.makedirs(OUT, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-o", LIB,
                        os.path.join(HERE, "hd34_bf16_micro.cu")], capture_output=True, text=True)
    if r.returncode:
        print("nvcc failed:", r.stderr[-3000:], flush=True)
        return 1
    failed = 0
    for name in CASES:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), name],
                           capture_output=True, text=True, timeout=120)
        print((r.stdout + r.stderr).strip()[-600:] or f"{name}: exit {r.returncode}", flush=True)
        failed += r.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
