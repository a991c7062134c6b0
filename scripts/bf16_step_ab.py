#!/usr/bin/env python3
"""One bf16 (or float32) gradient step at batch 16 of each surrogate, for an
A/B of two checkouts on one card.

    python3 scripts/bf16_step_ab.py [--dtype {bfloat16,float32}]
                                    [--surrogates albef,vlmo,base_plus]

Runs, from the checkout it lives in, ``chip_smoke.py``'s batch-16 step
(feature loss, forward + backward + K1, ``--dtype bfloat16`` by default,
the float32 trunk with ``--dtype float32``, ``--attn flash`` against
``--attn xla`` in turns) for each surrogate named (ALBEF and VLMo by
default; ``base_plus``: VLMo-base+, head dim 34), on the
same random full-width weights from seed 0; then profiles three more
flash steps of each (``torch.profiler``, CUDA activity): the device time
of all kernels a step, that of the flash-attention kernels, that of K2's
forward and backward kernels (``residual_ln_fwd_kernel``,
``residual_ln_bwd_kernel``), and the step's wall time under the profiler,
whose difference from the device time is the card's idle share.  Prints
one JSON line with these, each step's median and peak device memory
(GiB) under both backends, and the card's name and power limit.  Step times
include the host's enqueueing and vary from call to call, so two versions
are compared in one call, each in its own process from its own checkout,
in turns: parent, change, change, parent.  A parent checkout that lacks
this script gets a copy of it in its ``scripts/``: it imports the
checkout's own ``chip_smoke.py`` and ``vqattack_tpu_torch``.  Needs one
CUDA device; builds the checkout's kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: E402


def device_times(step, steps: int = 3) -> dict:
    """``step`` under ``--attn flash``, once to warm up, then ``steps`` times
    under the profiler: per step, the summed device time of every kernel, of
    the flash-attention kernels and of K2's forward and backward kernels
    (ms), and the wall time (ms)."""
    with cs.attention.attention_impl("flash"):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    total = flash = k2_fwd = k2_bwd = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        us = e.cuda_time if us is None else us
        total += us
        # K3's kernels: flash_*_kernel (bf16; the float32 dbias and D pass)
        # and vqflash::wgmma_*_kernel (the Hopper float32 ones)
        flash += us if "flash_" in e.name or "vqflash::" in e.name else 0.0
        k2_fwd += us if "residual_ln_fwd_kernel" in e.name else 0.0
        k2_bwd += us if "residual_ln_bwd_kernel" in e.name else 0.0
    return {"device_ms": total / steps / 1e3, "flash_ms": flash / steps / 1e3,
            "k2_fwd_ms": k2_fwd / steps / 1e3, "k2_bwd_ms": k2_bwd / steps / 1e3,
            "wall_ms": wall / steps * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="the surrogate trunk's compute dtype (default: bfloat16)")
    ap.add_argument("--surrogates", default="albef,vlmo",
                    help="comma-separated, of albef, vlmo, base_plus (default: albef,vlmo)")
    args = ap.parse_args()
    dtype, names = args.dtype, args.surrogates.split(",")
    if not set(names) <= {"albef", "vlmo", "base_plus"}:
        ap.error(f"--surrogates {args.surrogates}: albef, vlmo or base_plus")
    if not torch.cuda.is_available():
        print("bf16_step_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="vqattack_step_ab_")
    try:
        paths = cs.write_assets(tmp)
        common = [
            "--vocab", paths["vocab"], "--answer-list", paths["answers"],
            "--right-part", paths["right"], "--surrogate-ans", paths["sur"],
            "--target-ans", paths["tgt"], "--paraphrases", paths["para"],
            "--all-correct", paths["allc"], "--output", os.path.join(tmp, "out"),
            "--seed", str(cs.SEED), "--device", "cuda", "--dtype", dtype,
        ]
        v_common = [a for a in common if a not in ("--answer-list", paths["answers"])]
        v_common += ["--pipeline", "vlmo", "--id2answer", paths["id2answer"]]
        tokenizer = WordPieceTokenizer.from_file(paths["vocab"])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED)
        steps = {}
        step_ab = cs.step_ab

        def keep_step(step, square, what):  # chip_smoke's A/B, keeping its step
            steps[what] = step
            return step_ab(step, square, what)

        cs.step_ab = keep_step
        argv = {"albef": common, "vlmo": v_common,
                "base_plus": v_common + ["--named-config", cs.BASE_PLUS]}
        abs_, devs = {}, {}
        for name in names:
            _, cfg, pipe = cs.build_pipelines(argv[name], tokenizer)
            one_step = cs.one_step_ab if name == "albef" else cs.vlmo_one_step_ab
            abs_[name] = one_step(pipe, cfg, tokenizer, gen)
            devs[name] = device_times(steps.pop(next(iter(steps))))
            del pipe
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tag = "bf16" if dtype == "bfloat16" else "f32"
    print(json.dumps({"checkout": ROOT, "card": card, "dtype": dtype, **{
        f"{name}_{tag}_{impl}_{k}": ab[impl][key] / scale
        for name, ab in abs_.items() for impl in ("flash", "xla")
        for k, key, scale in (("median_s", "median_s", 1), ("peak_gib", "peak_bytes", 2 ** 30))},
        **{f"{name}_{tag}_flash_{k}": v for name, dev in devs.items()
           for k, v in dev.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
