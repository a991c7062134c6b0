#!/usr/bin/env python3
"""Device times of K3's float32 and bf16 instances and K2's forward, for an
A/B of two checkouts on one card.

    python3 scripts/kernel_ab.py

Times, from the checkout it lives in, K3 forward and backward in each dtype
at PERF.md §6's shapes: without terms at the ALBEF chunk of 8 ([8, 901, 12,
64]), with both terms (a [1, 12, 941, 941] table and a padded-text key
bias) at VLMo's batch 16 ([16, 941, 12, 64]), at head dim 34 with the
key bias alone ([16, 941, 16, 34], each entry point timed as the main path
calls it, with whatever copy it makes: a parent's bf16 pad copy) and at
ViLT-B/32's joint length with the key bias alone ([16, 185, 12, 64]); the
float32 kernels also without terms at the training paths' [8, 257], [8,
577] and [16, 577] (12 heads of 64), and at head dim 34 at vlmo_pretrain
base+'s ITM shape with the key bias ([24, 237, 16, 34]) and at [8, 197,
16, 34] without terms; the bf16 ones at [16, 941, 16, 34] without terms
too; and K2's forward at [7208, 768] on a float32 and a bf16 stream.  Inputs are drawn
here from seed 0, so the two checkouts time the same tensors; the timer is
the checkout's ``chip_smoke.time_ms`` (CUDA events, L2 emptied, the stream
held busy).  Prints one line: ``AB`` and a JSON object of each kernel's
time in us, with the card's name and power limit.  Kernel times move a few
percent between calls, so two versions are compared in one call, each in
its own process from its own checkout, in turns: parent, change, change,
parent.  A parent checkout that lacks this version of the script gets a
copy of it in its ``scripts/``.  Needs one CUDA device; builds the
checkout's kernels at first use.
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
from vqattack_tpu_torch.ops import _build, attention, fused_ln  # noqa: E402


def _k3_case(gen, b, s, h, dh, terms):
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda") for _ in range(3))
    table = key_bias = None
    if terms in ("both", "key_bias"):
        key_bias = torch.zeros(b, s, device="cuda")
        key_bias[:, 28:40] = -1e9  # the padded text of VLMo's 40 text tokens
    if terms == "both":
        table = torch.randn(1, h, s, s, generator=gen, device="cuda") * 0.5
    return q, k, v, table, key_bias


def _time_k3(gen, name, b, s, h, dh, terms, times,
             dtypes=((torch.float32, ""), (torch.bfloat16, "_bf16"))):
    q, k, v, table, kb = _k3_case(gen, b, s, h, dh, terms)
    scale = dh ** -0.5
    for dtype, tag in dtypes:
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        o, lse = attention.flash_attention_fwd(qd, kd, vd, table, scale, kb)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
        times[f"k3{tag}_{name}_fwd"] = 1e3 * cs.time_ms(
            lambda: attention.flash_attention_fwd(qd, kd, vd, table, scale, kb), 20)
        times[f"k3{tag}_{name}_bwd"] = 1e3 * cs.time_ms(
            lambda: attention.flash_attention_bwd(qd, kd, vd, table, scale, o, lse, do, kb), 20)


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
    gen.manual_seed(0)
    times = {}
    _time_k3(gen, "no_terms_b8", 8, 901, 12, 64, None, times)
    _time_k3(gen, "both_terms_b16", 16, 941, 12, 64, "both", times)
    _time_k3(gen, "hd34_key_bias_b16", 16, 941, 16, 34, "key_bias", times)
    _time_k3(gen, "vilt_key_bias_b16", 16, 185, 12, 64, "key_bias", times)
    # the float32 rows of the training paths: albef_pretrain at 256 px, the
    # fine-tuning tasks at 384 px (nlvr2's pairs at 16)
    for b, s in ((8, 257), (8, 577), (16, 577)):
        _time_k3(gen, f"no_terms_b{b}_s{s}", b, s, 12, 64, None, times, ((torch.float32, ""),))
    # head dim 34 (VLMo-base+) at the pretraining shapes, float32
    _time_k3(gen, "hd34_key_bias_b24_s237", 24, 237, 16, 34, "key_bias", times,
             ((torch.float32, ""),))
    _time_k3(gen, "hd34_no_terms_b8_s197", 8, 197, 16, 34, None, times, ((torch.float32, ""),))
    # bf16 at head dim 34 without the key bias: what the term costs
    _time_k3(gen, "hd34_no_terms_b16", 16, 941, 16, 34, None, times, ((torch.bfloat16, "_bf16"),))
    rows = 8 * 901
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        x, delta = (torch.randn(rows, 768, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
        gamma, beta = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
        times[f"k2{tag}_fwd"] = 1e3 * cs.time_ms(
            lambda: fused_ln.residual_layernorm_fwd(x, delta, gamma, beta))
    print("AB", json.dumps({"checkout": ROOT, "card": card, "us": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
