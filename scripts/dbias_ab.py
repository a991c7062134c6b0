#!/usr/bin/env python3
"""Device times and peak allocation of K3's float32 backward with dbias,
for an A/B of two checkouts on one card.

    python3 scripts/dbias_ab.py

Times, from the checkout it lives in, the backward with the bias's gradient
for a ``[1, H, S, S]`` table at the shapes of PERF.md §6's dbias rows:
VLMo-base's training batch [8, 941, 12, 64] and [16, 941, 12, 64] (two
clusters of the sum over B), its pretraining shapes [8, 237, 12, 64] and
[8, 196, 12, 64], each with a padded-text key bias, and head dim 34 at
[8, 197, 16, 34] (the table alone), [24, 237, 16, 34] and [8, 196, 16, 34].
For each shape: ``ms`` (the backward with dbias), ``no_dbias_ms`` (without),
``dbias_extra_ms`` (their difference), ``sum_ms`` (where the checkout sums
dS over B outside the kernel, as the parent of the in-kernel sum does:
``sum_to_size`` of a [B, H, S, S] buffer; null where the kernel sums),
``scratch_bytes`` (that buffer, or the in-kernel sum's partial planes past
batch 8) and ``peak_bytes`` (the peak allocation of one backward over what
was allocated before it).  Inputs are drawn here from seed 0, so the two
checkouts time the same tensors; the timer is the checkout's
``chip_smoke.time_ms`` (CUDA events, L2 emptied, the stream held busy).
Prints one line: ``AB`` and a JSON object, with the card's name and power
limit.  Compare two versions in one call, each in its own process from its
own checkout, in turns: parent, change, change, parent (a parent that lacks
this script gets a copy of it in its ``scripts/``).  Needs one CUDA device;
builds the checkout's kernels at first use.
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
from vqattack_tpu_torch.ops import _build, attention  # noqa: E402

# (name, B, S, heads, head dim, key bias)
SHAPES = [("vlmo_b8", 8, 941, 12, 64, True), ("vlmo_b16", 16, 941, 12, 64, True),
          ("joint237", 8, 237, 12, 64, True), ("text196", 8, 196, 12, 64, True),
          ("hd34_8x197", 8, 197, 16, 34, False), ("hd34_24x237", 24, 237, 16, 34, True),
          ("hd34_8x196", 8, 196, 16, 34, True)]
LONG_SLEEP = 20_000_000


def _case(gen, b, s, h, dh, key_bias):
    """q, k, v as views of [B, S, H * Dh] projections, the table and the
    padded text's key bias (-1e9 on keys 28..39 of every row) or none."""
    q, k, v = (torch.randn(b, s, h * dh, generator=gen, device="cuda").view(b, s, h, dh)
               for _ in range(3))
    table = torch.randn(1, h, s, s, generator=gen, device="cuda") * 0.5
    kb = None
    if key_bias:
        kb = torch.zeros(b, s, device="cuda")
        kb[:, 28:40] = -1e9
    return q, k, v, table, kb


def _peak(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def time_shape(gen, b, s, h, dh, key_bias) -> dict:
    q, k, v, table, kb = _case(gen, b, s, h, dh, key_bias)
    scale = dh ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, kb)
    do = torch.randn(o.shape, generator=gen, device="cuda")

    def with_dbias():
        return attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)

    row = {"shape": [b, s, h, dh], "key_bias": key_bias,
           "ms": cs.time_ms(with_dbias, 20, LONG_SLEEP),
           "no_dbias_ms": cs.time_ms(lambda: attention.flash_attention_bwd(
               q, k, v, table, scale, o, lse, do, kb), 20),
           "peak_bytes": _peak(with_dbias)}
    row["dbias_extra_ms"] = row["ms"] - row["no_dbias_ms"]
    if hasattr(attention, "dbias_plan"):  # the kernel sums over B
        plan = attention.dbias_plan((b, h, s, s), tuple(table.shape))
        row.update(sum_ms=None, cluster=plan.cluster, groups=plan.groups,
                   scratch_bytes=0 if plan.scratch_shape is None
                   else 4 * plan.scratch_shape[0] * h * s * s)
    else:  # dS into a [B, H, S, S] buffer, summed by torch
        buffer = torch.randn(b, h, s, s, generator=gen, device="cuda")
        row.update(sum_ms=cs.time_ms(lambda: buffer.sum_to_size(table.shape), 20),
                   scratch_bytes=buffer.numel() * 4)
        del buffer
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("dbias_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {name: time_shape(gen, *shape) for name, *shape in SHAPES}
    print("AB", json.dumps({"checkout": ROOT, "card": card, "dbias": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
