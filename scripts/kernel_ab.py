#!/usr/bin/env python3
"""Device times of K3's bf16 and float32 instances and K2's forward, for
an A/B of two checkouts on one card.

    python3 scripts/kernel_ab.py

Runs, from the checkout it lives in, ``chip_smoke.py``'s K3-bf16 phase
(``check_flash_attention_bf16``: every check, then the times at [8, 901,
12, 64] without terms), its K3-float32 timing at the same shape
(``time_flash_attention``) and its K2 forward timing (``_time_fwd``) at
[7208, 768] on a float32 and a bf16 stream, and prints one line: ``AB``
and a JSON object of each kernel row's time in us, with the card's name
and power limit.  Kernel times move a few percent between calls, so two
versions are compared in one call, each in its own process from its own
checkout, in turns: parent, change, change, parent.  A parent checkout
that lacks this script gets a copy of it in its ``scripts/``.  Needs one
CUDA device; builds the checkout's kernels at first use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vqattack_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    times = {row["name"]: row["ms"] * 1e3 for row in cs.check_flash_attention_bf16(gen)}
    no_errs = dict.fromkeys(("o", "dq", "dk", "dv"), 0.0)
    times.update({row["name"]: row["ms"] * 1e3
                  for row in cs.time_flash_attention(gen, no_errs, cs.TIMED_BATCH)})
    for dtype in (torch.float32, torch.bfloat16):
        x, delta, gamma, beta, _, _ = cs._ln_case(gen, cs.TIMED_BATCH * 901, dtype)
        row = cs._time_fwd(x, delta, gamma, beta, cs.TIMED_BATCH * 901, 0.0)
        times[row["name"]] = row["ms"] * 1e3
    print("AB", json.dumps({"checkout": ROOT, "card": card, "us": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
