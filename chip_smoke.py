#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line on entry and its seconds on exit):

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels, one ``nvcc`` call (``vqattack_tpu_torch/ops/_build.py``),
   and ptxas's registers and spills of each of K3-bf16's kernels and of
   each instance of K2's backward;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes both paths give it (batch 1, the batched chunks of 4 and 8, the
   victim's 16), with the stated tolerances: K1 (PGD update), K2 (residual +
   LayerNorm, forward and backward; the backward also at 1 and 7 rows, at
   widths 1024, 544 and 100 and on a misaligned view, with and without gs
   and parameter gradients) and K3 (flash attention on the tensor
   cores in three TF32 passes, forward and backward, ragged and bias cases;
   and its bf16 instance, one bf16 pass a product);
   times and bounds at the batched chunk of 8, and K3's also at 16, beside
   ``scaled_dot_product_attention``; K2's backward also timed at 901 and
   14416 rows and with parameter gradients, printed beside the table;
4. model: the full-width surrogate with the fused kernels against the same
   weights through plain LayerNorms, and with the flash kernel against the
   product + softmax attention: forward features and d/dpixels;
5. per-sample path: the per-sample ALBEF attack at full width (ViT-B/16 at
   480 px, 12-layer fusion BERT, 40 PGD iterations) on two synthetic
   samples, one on the alternating (MAR) path and one feature-only, each
   with the text attack, the victim's ``rank_answer`` and the artifacts;
6. batched path: the lockstep sweep as ``run.py --batch-size 8 --attn flash
   --pipeline-depth 2`` runs it, on 11 samples (a MAR bucket of 8 and a
   feature bucket of 3 padded to 4), the victim scored in one batched call,
   with the phase timing and the aggregate sample-iterations/s;
7. one PGD gradient step at batch 16 with ``--attn flash`` and with
   ``--attn xla``: time and peak device memory of each;
8. VLMo (``--pipeline vlmo``, ``vlmo_attack_config``: 480 px, 12 MoME
   blocks of width 768, 941 joint tokens, 40 iterations): K3 with both
   additive terms (a relative-position table from
   ``precompute_joint_biases`` and the padded-text key bias) against its
   plain versions at batch 1, 8 and 16, a -inf first key tile, the autograd
   Function, and its times beside SDPA with the summed mask;
9. the full-width VLMo surrogate: one feature-loss gradient step with
   ``--attn flash`` against ``--attn xla``;
10. the per-sample VLMo path (2 samples, MAR and feature-only, ``--attn
    xla``) with the classifier victim and the artifacts;
11. the batched VLMo path (``--batch-size 8 --attn flash --pipeline-depth
    2``, 11 samples in both ``old_alg`` buckets);
12. one VLMo gradient step at batch 16, flash against xla: time, peak
    memory, and no saved [16, 12, 941, 941] tensor on the flash side;
13. the checkpoint path: full-width synthetic checkpoints in the
    reference's names from seed 0 (``checkpoint/synthetic.py``: an ALBEF
    pretrain ``{'model': sd}`` at 224 px with momentum copies and queues, an
    ALBEF VQA file at 384 px, a ``bert-base-uncased`` directory with
    ``gamma``/``beta`` LayerNorms and no decoder weight, a VLMo surrogate at
    224 px behind ``module.`` prefixes, a VLMo VQA victim at 480 px with an
    NLVR2 head), then ``run.main`` for each surrogate with
    ``--surrogate-ckpt --victim-ckpt --bert-mlm --batch-size 8 --attn flash
    --pipeline-depth 2`` (ALBEF also ``--calibrate-gate``) over the batched
    samples, whose images are served by name (no PIL on the card's
    machine); every loaded parameter is held against the file's tensor by
    the reference's names, the resized ``pos_embed`` and relative table
    against the port's resize on the CPU; then the files are deleted.

The training slice (``vqattack_tpu_torch/train/``) adds: K3's bias
gradient (the dQ kernel's dbias instance, which sums dS over the batch in
thread-block clusters) against its plain version at VLMo's training
shapes (batch 1 and 8 at 941 tokens with the table and the padded-text key
bias), at batch 3, 9, 16 and 24 (one cluster of 3 blocks, two of 8 with
the second padded, two, three) at both head dims, a [B, H, S, S] bias, 130
tokens, 200 queries over 77 keys, a -inf first key tile and the autograd
Function with a table that needs a gradient, each shape's cluster size,
clusters, ``cudaOccupancyMaxActiveClusters`` and scratch bytes printed,
repeated bit for bit, one backward's peak allocation at batch 8 held under
a [B, H, S, S] buffer, and timed at batch 8 beside the backward without
it, its plain version and ``scaled_dot_product_attention`` with a mask
that requires grad (its backend named); a row masked whole by a finite
-1e9, K3 float32 and bf16
against their plain versions (the bf16 instance's exponent order, step 0
of the slice); ``train.cli.main --task vlmo_vqa --preset
task_finetune_vqa_base_image480`` at batch 8 from a synthetic VLMo VQA
file (``--init-ckpt``) under flash and under xla, the first batch's table
gradient flash against xla, K3's launches a step (dbias counted apart),
seconds a step and peak memory, and a ``--ckpt-dir`` resume that restarts
at the saved step with the saved parameters; and ``--task albef_vqa`` at
full width under flash (ViT-B/16 at 480 px with K2 at its norm sites, the
backward with parameter sums), with K2's backward timed with and without
its sums.

VLMo-base+ (``--named-config task_finetune_vqa_base_plus_image480``: 24
MoME blocks of width 544 over 16 heads, head dim 34, absolute position
embeddings, no relative-position table, no layer scale, 941 joint tokens)
runs after the VLMo phases: K3 at head dim 34 in float32 and bf16,
forward and backward, against its plain versions at [B, 941, 16, 34] for
B = 1, 8 and 16 (strided views of [B, 941, 544] projections, the
padded-text key bias), ragged lengths, a -inf first key tile and the
autograd Function, timed at B = 16 beside the bf16 copies into 40-wide rows
and ``scaled_dot_product_attention`` (its backend named); the full-width
model, flash against xla; the per-sample path (2 samples, ``--attn
flash``); the batched path (11 samples, ``--batch-size 8 --attn flash
--pipeline-depth 2``) in float32 and ``--dtype bfloat16``; the batch-16
flash/xla step in both dtypes.

The transfer slice adds: in the masked-row phases, the kernels' masked row
against autograd of the explicit float32 softmax (the forward saves the
row maximum and the log of its sum apart wherever a term is given); after
the VLMo-base+ phases, ViLT-B/32 (``vilt_base_config``: one shared FFN a
block, 145 image tokens at 384 px + 40 text tokens): K3 at [B, 185, 12, 64]
with the padded-text key bias alone, B = 4 and 16, both dtypes, forward
and backward against the plain versions and timed at 16 beside
``scaled_dot_product_attention`` (the ``_vilt`` rows), then the batched
ViLT attack at ``--batch-size 16 --attn flash`` (19 samples: buckets of 16
and 3 padded to 4) in float32 and bf16; after the checkpoint path,
``transfer_eval`` over the batched ALBEF phase's artifacts against four
victims from full-width synthetic files at 480 px: ALBEF-VQA, BLIP-VQA
(``blip_vqa_config``) and VLMo-VQA through the CLI's ``--victim-ckpt``,
ViLT through ``checkpoint/io.py::load_vilt``; each run's launches against
its victim forwards, its answers against the same pipeline's under
``--attn xla``; then ``Predictor.answer`` with the ALBEF and the ViLT
victim; a ``transfer`` JSON line (seconds and flip rate a victim, the ViLT
cells, the masked row's errors).

The analysis slice adds, after the ALBEF batch-16 A/B, ``pgd_multi_restart``
over the surrogate (the feature loss, B 2, R 4, 10 steps a restart), the
pick recomputed by running each restart alone from the same key and
evaluating its final iterate again; ``albef_question_gradcam`` at layer 8
under flash and xla, against grad x attention taken directly from the
probabilities, with the last LayerNorm's affine map drawn from the seed
(random weights leave it the identity, which makes the summed [CLS] score
constant); ``grounding_accuracy`` over a synthetic RefCOCO layout, its
resize against float64 numpy; and, after the VLMo batch-16 A/B, the seven
attacks of ``attacks/extra.py`` against the VLMo-VQA victim on one question
(B 2; PGD and MIM 10 steps, SPSA 4 steps of 32 draws in chunks of 8, CW-L2
20 steps x 3 search steps), each result in the box (and the ball), CW-L2's
its start or a success with its L2, the victim's logits at each under
flash against xla, and K3 with both terms against its plain versions at
the attacks' shapes (B 2 and SPSA's stacked [32, 941]).  Each of the three prints a JSON line with its seconds
and launches, which must equal the schedule's.

The pretraining slice adds, after the VQA training phases: K2 and K3
against their plain versions at the shapes pretraining gives them, timed
beside their bounds and ``scaled_dot_product_attention`` (ALBEF at 256 px:
K3 without terms at [8, 257, 12, 64], the ``_albef257`` rows, and K2 at
[8 x 257, 768]; VLMo-base+ at head dim 34: the image tower [8, 197]
without terms, ITM's joint trunk [24, 237], the ``_itm237`` rows, MLM's
[8, 237] and the text tower [8, 196] with the padded-text key bias; K3's
bias gradient at those head-dim-34 shapes on synthetic tables, which runs
on no path: base+ has no relative table, and at VLMo-base's joint [8, 237]
and text [8, 196] tables, the ``_joint237`` and ``_text196`` rows); then
``train.cli.main`` at batch 8 for 4 steps: ``--task albef_pretrain
--image-size 256`` (ALBEF's public Pretrain.yaml resolution) under flash,
``--task vlmo_pretrain --preset task_mlm_itm_itc_base_plus`` under flash
and xla, ``--task vlmo_textmlm --preset task_textmlm_base_plus`` under
flash, and the VLMo-base presets of both (``task_mlm_itm_itc_base``: MLM
alone; ``task_textmlm_base``) under flash, each run's launches by shape
against its schedule, the first step's loss terms, s/step and peak memory
printed; then the first step's table gradient, flash against xla, of the
two VLMo-base presets, with the same hard negatives in both; a
``pretraining`` JSON line.

The fine-tuning slice adds, after the pretraining phases: K2, K3 and K3's
bias gradient against their plain versions at the shapes fine-tuning gives
them, timed beside their bounds and the library calls (ALBEF's ViT at 384
px: K3 without terms at [8, 577, 12, 64] and nlvr2's [16, 577, 12, 64], the
``_albef577`` and ``_nlvr577`` rows, K2 at [8 x 577, 768] and [16 x 577,
768] with its parameter sums; VLMo-base at 384 px: dbias with the table
and the padded-text key bias at vlmo_irtr's [24, 617] (clusters of 8, the
plane pass over 3) and vlmo_nlvr2's [8, 617], the ``_irtr617`` and
``_nlvr617`` rows); then ``train.cli.main`` at batch 8 for 4 steps under
flash: ``--task retrieval``, ``ve`` and ``nlvr2 --image-size 384`` (ALBEF,
NLVR's 18 layers on the pairs' 16 images) on synthetic annotations in each
task's dialect (captions on shared images, VE sentences with string labels,
NLVR pairs labelled "True"/"False"), ``--task vlmo_irtr --preset
task_finetune_irtr_f30k_base_image384`` and ``--task vlmo_nlvr2 --preset
task_finetune_nlvr2_base_image384 --init-ckpt`` (a full-width synthetic
2-row VLMo-base file, the 3-row table's row 2 required to be row 1), each
run's launches by shape against its schedule, s/step, peak memory and the
first step's metrics printed; retrieval's first-step loss and the gradient
of the ViT's first query weight, flash against xla (``RETRIEVAL_GRAD_TOL``,
12 times K3's 2e-5); the two VLMo tasks' table gradient, flash against
xla; a ``finetuning`` JSON line.

The bf16 trunk (``--dtype bfloat16``) adds, after the float32 phases of each
surrogate: K2 on a bf16 stream (phase 3, beside float32) and K3's bf16
instance against its plain versions and the float32 computation (ALBEF's
shapes without terms in phase 3, VLMo's with both terms after phase 12),
timed beside ``scaled_dot_product_attention`` in bf16; a full-width drift
check, one MAR and one feature-only sample in float32 and in bf16 from the
same rand-init, held to the JAX package's trajectory budget; one per-sample
bf16 sample, the batched bf16 path (11 samples, ``--batch-size 8 --attn
flash --pipeline-depth 2``) through the engine and again through
``run.main``, whose launch counts, bf16 and float32 instances apart, must
equal the schedules'; and the batch-16 flash/xla step in bf16.

Before phases 5, 6, 10, 11, each run of 13, each bf16 path and each base+
path the kernels' launch counts are reset, and after each they must equal
what the samples' schedules imply (K3's head-dim-34 launches counted
apart).  Prints the kernel table as one JSON line, the checkpoint loads'
seconds beside the card's name and power limit, the card's name and power
limit, then, as the last line, ``{"ok": true, "device": {...}}``.  Exits
non-zero, without those lines, when there is no CUDA device or any check
fails.  Needs torch, numpy and scipy (the relative table's resize).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vqattack_tpu_torch import run as port_run  # noqa: E402
from vqattack_tpu_torch.attacks import batched, extra  # noqa: E402
from vqattack_tpu_torch.attacks.orchestrator import save_artifacts  # noqa: E402
from vqattack_tpu_torch.attacks.mar_labels import build_mar_labels  # noqa: E402
from vqattack_tpu_torch.attacks.norms import get_or_guess_labels  # noqa: E402
from vqattack_tpu_torch.attacks.pgd import (  # noqa: E402
    pgd_alternating, pgd_feature, pgd_multi_restart)
from vqattack_tpu_torch.data.side_tables import SideTables  # noqa: E402
from vqattack_tpu_torch.eval import grounding  # noqa: E402
from vqattack_tpu_torch.models.albef import AlbefPretrain  # noqa: E402
from vqattack_tpu_torch.models.layers import mask_to_key_bias  # noqa: E402
from vqattack_tpu_torch.ops import _build, attention, fused_ln, pgd_update  # noqa: E402
from vqattack_tpu_torch.rng import TorchKey  # noqa: E402
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: E402
from vqattack_tpu_torch.utils.gradcam import albef_question_gradcam  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 on the tensor cores
BF16 = torch.bfloat16
SEED = 0
D = 768


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"[phase] {self.name} ...", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.seconds = time.perf_counter() - self.t0
            print(f"[phase] {self.name} done in {self.seconds:.2f} s", flush=True)
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int = 50, sleep_cycles: int = 1_000_000) -> float:
    """Mean device time of ``fn`` in ms by CUDA events.  Before every call
    the 50 MB L2 is emptied of the inputs by reading a 64 MB buffer (a read
    leaves clean lines, so the timed call pays no write-back), and the
    stream is held busy for ~0.5 ms, so that the host has enqueued all of
    ``fn``'s launches before the start event runs: the interval is device
    time, not the wrapper's Python.  Callers whose ``fn`` enqueues for
    longer than ~0.5 ms pass a longer ``sleep_cycles``."""
    flush = torch.ones(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.sum()
        torch.cuda._sleep(sleep_cycles)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(n_bytes: float, n_flops: float, flops_per_s: float = FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_core_bound_ms(n_bytes: float, product_flops: float):
    """The bound of a float32 product on the tensor cores in three TF32
    passes (K3): 3x its operations at the dense TF32 rate, or its bytes."""
    return bound_ms(n_bytes, 3 * product_flops, TF32_FLOPS)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


# The batched path runs its chunks at batch 8 and 4 and scores the victim at
# 16; the kernel table's times are taken at its chunk of 8.
TIMED_BATCH = 8


def check_pgd_update(gen) -> dict:
    """K1 bit-exact against its plain version at the per-sample path's
    batch 1 and the batched path's 4 and 8; timed at batch 8."""
    for batch in (1, 4, TIMED_BATCH):
        shape = (batch, 3, 480, 480)
        ori = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        adv = (ori + (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 0.25).clamp(-1, 1)
        grad = torch.randn(shape, generator=gen, device="cuda")
        grad[torch.rand(shape, generator=gen, device="cuda") < 0.01] = 0.0  # sign(0) = 0
        args = (adv, grad, ori, 0.125, 0.01, -1.0, 1.0)
        out = pgd_update.pgd_linf_update(*args)
        ref = pgd_update.pgd_linf_update_reference(*args)
        torch.cuda.synchronize()
        # tolerance: none, the kernel repeats the plain chain's IEEE operations
        require(torch.equal(out, ref), f"pgd_linf_update differs from its plain version "
                                       f"at {list(shape)}")
        print(f"  pgd_linf_update {list(shape)} f32: bit-exact", flush=True)
    n = adv.numel()
    b, by = bound_ms(16 * n, 10 * n)
    row = {
        "name": "pgd_linf_update", "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/pgd_update.cu",
        "replaces": "vqattack_tpu/ops/pgd_update.py:59",
        "shape": list(shape),
        "max_abs_err": float((out - ref).abs().max()),
        "ms": time_ms(lambda: pgd_update.pgd_linf_update(*args)),
        "plain_ms": time_ms(lambda: pgd_update.pgd_linf_update_reference(*args)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }
    print(f"  pgd_linf_update {list(shape)} f32: {row['ms'] * 1e3:.1f} us "
          f"(plain {row['plain_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    return row


def _ln_case(gen, rows, dtype):
    x = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
    delta = (torch.randn(rows, D, generator=gen, device="cuda") * 0.3).to(dtype)
    gamma = torch.randn(D, generator=gen, device="cuda") * 0.1 + 1.0
    beta = torch.randn(D, generator=gen, device="cuda") * 0.1
    gs = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
    gh = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
    return x, delta, gamma, beta, gs, gh


def _close(name, got, ref, dtype):
    """float32: within 1e-5 relative and absolute (the statistics' summation
    order and rsqrtf's 2-ulp error); bfloat16: within one bf16 ulp of the plain
    result, as tests/test_fused_ln.py bounds it (rtol 2^-7 is one ulp at the
    bottom of a binade; atol 2^-9 for values near zero, where neighbouring
    float32 results round to bf16 values that are more ulps apart)."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-5 + 1e-5 * ref.float().abs()).all())
    else:
        ok = bool((err <= 2 ** -9 + 2 ** -7 * ref.float().abs()).all())
    require(ok, f"{name}: max abs err {float(err.max())} outside tolerance")
    return float(err.max())


# K2's row counts: one 901-token image (the per-sample path), the batched
# chunks of 4 and 8 and the victim's padded 16, and 1000 (not a multiple of
# the forward's row tile)
LN_ROWS = (901, 1000, 4 * 901, TIMED_BATCH * 901, 16 * 901)
# K2's backward at the other rows, widths and layouts its wrapper takes:
# (rows, D, storage offset in elements).  One row and 7 (fewer rows than
# SMs); the widest row (1024) and 544 in 16-byte vectors; 100, which on a
# bf16 stream is no whole number of 16-byte vectors, and a contiguous view
# 2 elements past a 16-byte boundary: both take the scalar instance.
K2_BWD_CASES = ((1, D, 0), (7, D, 0), (7, 1024, 0), (901, 1024, 0), (901, 544, 0),
                (901, 100, 0), (901, D, 2))


def _bwd_case(gen, rows, d, dtype, offset=0):
    """s = x + delta of the plain forward, gs, gh of ``rows`` x ``d`` in the
    stream dtype, each a contiguous view ``offset`` elements into its
    storage; gamma float32."""
    def view(t):
        out = torch.empty(rows * d + offset, dtype=dtype, device="cuda")[offset:].view(rows, d)
        return out.copy_(t)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    delta = (torch.randn(rows, d, generator=gen, device="cuda") * 0.3).to(dtype)
    gamma = torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0
    beta = torch.randn(d, generator=gen, device="cuda") * 0.1
    s, _ = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
    gs = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    gh = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    return view(s), view(gs), view(gh), gamma


def _check_bwd(s, gs, gh, gamma, param_grads, what):
    """K2's backward, called three times, against its plain version: dx
    within ``_close``'s bounds; dgamma/dbeta (sums over rows taken in
    another order than torch.sum) within 1e-5 of the sum of the terms'
    magnitudes; dx, dgamma and dbeta the same bit for bit on every call.
    Returns dx's largest error."""
    runs = [fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6, param_grads=param_grads)
            for _ in range(3)]
    dx_r, dg_r, db_r = fused_ln.residual_layernorm_bwd_reference(
        s, gs, gh, gamma, 1e-6, param_grads=param_grads)
    torch.cuda.synchronize()
    dx, dg, db = runs[0]
    dx_err = _close(f"dx {what}", dx, dx_r, s.dtype)
    require(all(torch.equal(r[0], dx) for r in runs), f"dx not deterministic at {what}")
    if param_grads:
        require(all(torch.equal(r[1], dg) and torch.equal(r[2], db) for r in runs),
                f"dgamma/dbeta not deterministic at {what}")
        sf = s.float()
        xhat = (sf - sf.mean(-1, keepdim=True)) * torch.rsqrt(
            sf.var(-1, unbiased=False, keepdim=True) + 1e-6)
        mag_g = (gh.float() * xhat).abs().sum(0)
        mag_b = gh.float().abs().sum(0)
        require(bool(((dg - dg_r).abs() <= 1e-5 * mag_g + 1e-6).all()),
                f"dgamma outside tolerance at {what}")
        require(bool(((db - db_r).abs() <= 1e-5 * mag_b + 1e-6).all()),
                f"dbeta outside tolerance at {what}")
    else:
        require(dg is None and db is None, f"parameter gradients without param_grads at {what}")
    return dx_err


def check_fused_ln(gen):
    """K2 on a float32 and on a bf16 stream against its plain versions;
    the rows of both timed at the batched chunk of 8 (float32 forward and
    backward, then bf16)."""
    timed = []
    for rows in LN_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            x, delta, gamma, beta, gs, gh = _ln_case(gen, rows, dtype)
            s, h = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)
            s_r, h_r = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
            torch.cuda.synchronize()
            require(torch.equal(s, s_r), f"residual sum differs at rows={rows} {dtype}")
            h_err = _close(f"h rows={rows} {dtype}", h, h_r, dtype)

            what = f"rows={rows} {dtype}"
            dx_err = _check_bwd(s, gs, gh, gamma, True, what)
            dx_err = max(dx_err, _check_bwd(s, gs, gh, gamma, False, what))
            print(f"  residual_layernorm rows={rows} {str(dtype)[6:]}: s bit-exact, "
                  f"h err {h_err:.3g}, dx err {dx_err:.3g}, dgamma/dbeta within bounds, "
                  f"deterministic", flush=True)
            if rows == TIMED_BATCH * 901:
                timed.append(_time_fwd(x, delta, gamma, beta, rows, max(h_err, 0.0)))
                timed.append(_time_bwd(x, delta, gamma, beta, s, gs, gh, rows, dx_err))
    for rows, d, offset in K2_BWD_CASES:
        for dtype in (torch.float32, BF16):
            s, gs, gh, gamma = _bwd_case(gen, rows, d, dtype, offset)
            instance = "16-byte" if fused_ln.bwd_vectorised(d, s, gs, gh) else "scalar"
            err = max(_check_bwd(s, g_s, gh, gamma, param_grads,
                                 f"rows={rows} D={d} offset={offset} {dtype}")
                      for g_s in (gs, None) for param_grads in (True, False))
            print(f"  residual_layernorm_bwd rows={rows} D={d} offset={offset} "
                  f"{str(dtype)[6:]} ({instance} instance): dx err {err:.3g} with and without "
                  f"gs and parameter gradients, deterministic", flush=True)
    for rows in (901, TIMED_BATCH * 901):
        for dtype in (torch.float32, BF16):
            for param_grads in (True, False):
                _check_autograd(gen, rows, dtype, param_grads)
    for rows in (901, 16 * 901):
        for dtype in (torch.float32, BF16):
            _time_bwd_shape(gen, rows, dtype)
    return timed


def _ln_name(direction, dtype):
    return f"residual_layernorm{'_bf16' if dtype == BF16 else ''}_{direction}"


def _time_fwd(x, delta, gamma, beta, rows, err):
    """Times of K2's forward; the library call is ``layer_norm(x + delta)``
    in the stream's dtype (on a bf16 stream with gamma and beta cast to
    bf16, outside the timing: one PyTorch call does not take float32
    parameters beside a bf16 input on every build)."""
    n, size = rows * D, x.element_size()
    b, by = bound_ms(4 * n * size + 2 * D * 4, 8 * n)  # read x, delta; write s, h
    g_lib, b_lib = gamma.to(x.dtype), beta.to(x.dtype)
    row = {
        "name": _ln_name("fwd", x.dtype), "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/fused_ln.cu",
        "replaces": "vqattack_tpu/ops/fused_ln.py:135",
        "shape": [rows, D],
        "max_abs_err": err,
        "ms": time_ms(lambda: fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)),
        "plain_ms": time_ms(
            lambda: fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.layer_norm(x + delta, (D,), g_lib, b_lib, 1e-6)),
    }
    print(f"  {row['name']} [{rows}, {D}] {str(x.dtype)[6:]}: {row['ms'] * 1e3:.1f} us (plain "
          f"{row['plain_ms'] * 1e3:.1f} us, layer_norm(x + delta) "
          f"{row['library_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    return row


def _time_bwd(x, delta, gamma, beta, s, gs, gh, rows, err):
    # the main path's backward: frozen parameters, so no dgamma/dbeta; the
    # library's: autograd through s = x + delta, h = layer_norm(s), the same
    # dx = gs + LayerNorm's backward of gh (its host enqueue can outlast the
    # default hold of the stream, so the hold is longer)
    n, size = rows * D, x.element_size()
    b, by = bound_ms(4 * n * size + D * 4, 12 * n)  # read s, gs, gh; write dx
    x_leaf = x.detach().clone().requires_grad_(True)
    s_l = x_leaf + delta
    h_l = torch.nn.functional.layer_norm(s_l, (D,), gamma.to(x.dtype), beta.to(x.dtype), 1e-6)
    row = {
        "name": _ln_name("bwd", x.dtype), "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/fused_ln.cu",
        "replaces": "vqattack_tpu/ops/fused_ln.py:159",
        "shape": [rows, D],
        "max_abs_err": err,
        "ms": time_ms(lambda: fused_ln.residual_layernorm_bwd(
            s, gs, gh, gamma, 1e-6, param_grads=False)),
        "plain_ms": time_ms(lambda: fused_ln.residual_layernorm_bwd_reference(
            s, gs, gh, gamma, 1e-6, param_grads=False)),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            (s_l, h_l), x_leaf, (gs, gh), retain_graph=True), sleep_cycles=20_000_000),
    }
    print(f"  {row['name']} [{rows}, {D}] {str(x.dtype)[6:]}: {row['ms'] * 1e3:.1f} us (plain "
          f"{row['plain_ms'] * 1e3:.1f} us, autograd of layer_norm(x + delta) "
          f"{row['library_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    _print_bwd_param_grads(s, gs, gh, gamma, rows)
    return row


def _print_bwd_param_grads(s, gs, gh, gamma, rows):
    """K2's backward with dgamma/dbeta, as a LayerNorm that trains calls it."""
    ms = time_ms(lambda: fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6))
    print(f"  {_ln_name('bwd', s.dtype)} [{rows}, {D}] {str(s.dtype)[6:]}, param_grads=True: "
          f"{ms * 1e3:.1f} us", flush=True)


def _time_bwd_shape(gen, rows, dtype):
    """K2's backward at a shape beside the table's (one image's 901 rows,
    the batch-16 step's 14416), printed, not in the kernel line: without
    and with parameter gradients, beside autograd of layer_norm(x + delta)
    and the byte bound."""
    x, delta, gamma, beta, gs, gh = _ln_case(gen, rows, dtype)
    s, _ = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)
    b, _ = bound_ms(4 * rows * D * x.element_size() + D * 4, 12 * rows * D)
    ms = time_ms(lambda: fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6, param_grads=False))
    x_leaf = x.detach().clone().requires_grad_(True)
    s_l = x_leaf + delta
    h_l = torch.nn.functional.layer_norm(s_l, (D,), gamma.to(dtype), beta.to(dtype), 1e-6)
    lib = time_ms(lambda: torch.autograd.grad((s_l, h_l), x_leaf, (gs, gh), retain_graph=True),
                  sleep_cycles=20_000_000)
    print(f"  {_ln_name('bwd', dtype)} [{rows}, {D}] {str(dtype)[6:]}: {ms * 1e3:.1f} us "
          f"(autograd of layer_norm(x + delta) {lib * 1e3:.1f} us, bound {b * 1e3:.2f} us)",
          flush=True)
    _print_bwd_param_grads(s, gs, gh, gamma, rows)


def _check_autograd(gen, rows, dtype, param_grads):
    """The autograd Function against autograd through the plain version, on
    a float32 or a bf16 stream (gamma and beta float32), with and without
    parameter gradients (the attack's frozen LayerNorms take none).
    Tolerance: float32 reassociation, 1e-4 of the largest magnitude (at
    least 1); on a bf16 stream dx and ddelta within two bf16 ulps (2^-6) of
    the largest magnitude: autograd through the plain version rounds the
    LayerNorm's gradient to bf16 before it adds the gradient of s, the
    kernel adds in float32 and rounds once."""
    x, delta, gamma, beta, _, _ = _ln_case(gen, rows, dtype)
    w_s = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
    w_h = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
    names = ("dx", "ddelta") + (("dgamma", "dbeta") if param_grads else ())
    grads = []
    for fn in (fused_ln.residual_layernorm, fused_ln.residual_layernorm_reference):
        xs = [t.clone().requires_grad_(True) for t in (x, delta)]
        ps = [t.clone().requires_grad_(param_grads) for t in (gamma, beta)]
        s, h = fn(*xs, *ps, 1e-6)
        loss = (s.float() * w_s.float()).sum() + (h.float() * w_h.float()).sum()
        grads.append(torch.autograd.grad(loss, xs + (ps if param_grads else [])))
    for name, a, b in zip(names, *grads):
        require(a.dtype == b.dtype, f"autograd {name}: {a.dtype} against {b.dtype}")
        err = float((a.float() - b.float()).abs().max())
        rel = 2 ** -6 if dtype == BF16 and name in ("dx", "ddelta") else 1e-4
        require(err <= rel * max(1.0, float(b.float().abs().max())),
                f"autograd {name} {dtype}: max abs err {err}")
    print(f"  residual_layernorm autograd Function matches autograd of the plain version "
          f"at rows={rows} {str(dtype)[6:]}, parameter gradients {param_grads}", flush=True)


HEADS, HEAD_DIM = 12, 64
SCALE = HEAD_DIM ** -0.5


def _qkv(gen, b, s, h=HEADS):
    """q, k, v as [B, S, H, 64] views of one [B, S, 3, H, 64] buffer:
    strided, like the projections the model hands over."""
    qkv = torch.randn(b, s, 3, h, HEAD_DIM, generator=gen, device="cuda")
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attn_err(what, got, ref):
    """Tolerance: 2e-5 of the reference's largest magnitude (at least 1).
    Both sides sum in float32, over up to 901 keys or queries, in another
    order (the kernel's tensor-core passes against cuBLAS's), and the
    kernel's products carry the 3xTF32 split's error (about 2^-22 of each
    term)."""
    err = float((got - ref).abs().max())
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    require(err <= tol, f"{what}: max abs err {err} > {tol}")
    return err


def _check_attention_case(gen, b, s, bias_kind):
    q, k, v = _qkv(gen, b, s)
    bias = None
    if bias_kind == "table":  # the VLMo form: one [1, H, S, S] table
        bias = torch.randn(1, HEADS, s, s, generator=gen, device="cuda") * 0.5
    elif bias_kind == "key_mask":  # [B, 1, 1, S], about a third masked
        keep = torch.rand(b, s, generator=gen, device="cuda") > 0.33
        keep[:, 0] = True
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    elif bias_kind == "left_pad":  # [B, 1, 1, S], the first 70 keys at -inf:
        # every row's first key tile is masked whole
        keep = torch.arange(s, device="cuda") >= 70
        bias = torch.where(keep, 0.0, -torch.inf).expand(b, s)[:, None, None, :]
    o, lse = attention.flash_attention_fwd(q, k, v, bias, SCALE)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, bias, SCALE, return_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, bias, SCALE, o, lse, do)
    again = attention.flash_attention_bwd(q, k, v, bias, SCALE, o, lse, do)
    refs = attention.flash_attention_bwd_reference(q, k, v, bias, SCALE, o, lse, do)
    torch.cuda.synchronize()
    errs = {"o": _attn_err("o", o, o_r), "lse": _attn_err("lse", lse, lse_r)}
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        require(torch.equal(g, g2), f"flash backward {name} differs between two runs")
        errs[name] = _attn_err(name, g, r)
    print(f"  flash_attention [{b}, {s}, {HEADS}, 64] bias={bias_kind}: "
          + ", ".join(f"{k} err {v:.3g}" for k, v in errs.items())
          + ", backward deterministic", flush=True)
    return errs


def check_flash_attention(gen):
    """K3 against its plain versions: the batched chunk's shape, ragged
    lengths, both bias forms and a -inf key mask; then the times at the
    batched chunk of 8 (the kernel table's rows) and at batch 16."""
    errs = _check_attention_case(gen, 8, 901, "none")
    for s in (1, 63, 130, 901):
        _check_attention_case(gen, 2, s, "none")
    _check_attention_case(gen, 2, 130, "table")
    _check_attention_case(gen, 2, 901, "table")
    _check_attention_case(gen, 2, 901, "key_mask")
    _check_attention_case(gen, 2, 901, "left_pad")
    # the autograd Function against autograd through the plain version
    q, k, v = _qkv(gen, 2, 901)
    w = torch.randn(2, 901, HEADS, HEAD_DIM, generator=gen, device="cuda")
    grads = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad((fn(*xs, None, SCALE) * w).sum(), xs))
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        _attn_err(f"autograd {name}", a, r)
    print("  flash_attention autograd Function matches autograd of the plain version",
          flush=True)
    return time_flash_attention(gen, errs, TIMED_BATCH), time_flash_attention(gen, errs, 16)


def time_flash_attention(gen, errs, b, s=901, suffix=""):
    """Device times at ``[b, s, 12, 64]``, float32, no bias: the kernels,
    the plain versions and ``scaled_dot_product_attention`` (forward;
    backward through autograd).  The forward is also held against its plain
    version at this shape.  The bound is the tensor cores' in three TF32
    passes (``tensor_core_bound_ms``) over the operations the function needs
    (4 and 10 x B*H*S^2*Dh); ``executed_tflops`` counts what the kernels
    execute (the dQ pass recomputes S and dO V^T: 14x in the backward), to
    hold against the 67 TFLOP/s of float32 outside the tensor cores.  The
    rows are named ``flash_attention_{fwd,bwd}`` with ``suffix``."""
    q, k, v = _qkv(gen, b, s)
    o, lse = attention.flash_attention_fwd(q, k, v, None, SCALE)
    _attn_err(f"o at batch {b}", o, attention.flash_attention_reference(q, k, v, None, SCALE))
    do = torch.randn(o.shape, generator=gen, device="cuda")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=SCALE)
    do_t = do.transpose(1, 2)
    unit = b * HEADS * s * s * HEAD_DIM
    row = b * s * HEADS * HEAD_DIM * 4  # bytes of one [B, S, H, 64] float32 tensor
    lse_bytes = 2 * b * HEADS * s * 4  # m and log l
    long_sleep = 20_000_000  # the plain versions enqueue for several ms
    fwd_b, fwd_by = tensor_core_bound_ms(4 * row + lse_bytes, 4 * unit)
    bwd_b, bwd_by = tensor_core_bound_ms(8 * row + lse_bytes, 10 * unit)
    fwd = {
        "name": "flash_attention_fwd" + suffix, "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vqattack_tpu/ops/attention.py:134",
        "shape": [b, s, HEADS, HEAD_DIM],
        "max_abs_err": errs["o"],
        "ms": time_ms(lambda: attention.flash_attention_fwd(q, k, v, None, SCALE), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_reference(q, k, v, None, SCALE),
                            20, long_sleep),
        "bound_ms": fwd_b, "bound_by": fwd_by,
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=SCALE), 20),
    }
    bwd = {
        "name": "flash_attention_bwd" + suffix, "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vqattack_tpu/ops/attention.py:134",
        "shape": [b, s, HEADS, HEAD_DIM],
        "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
        "ms": time_ms(lambda: attention.flash_attention_bwd(q, k, v, None, SCALE, o, lse, do), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_bwd_reference(
            q, k, v, None, SCALE, o, lse, do), 20, long_sleep),
        "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True), 20),
    }
    for r, executed in ((fwd, 4 * unit), (bwd, 14 * unit)):
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["executed_tflops"] = executed / r["ms"] / 1e9
        require(r["bound_share"] <= 1.0, f"{r['name']}: {r['ms']} ms is under its bound "
                                         f"{r['bound_ms']} ms: the timing or the bound is wrong")
        print(f"  {r['name']} {r['shape']} f32: {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f} ms, scaled_dot_product_attention {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms by {r['bound_by']}: {100 * r['bound_share']:.1f}%; "
              f"executed {r['executed_tflops']:.1f} TFLOP/s)", flush=True)
    return fwd, bwd


# K3's bf16 instance (csrc/flash_attention_bf16.cu): ALBEF's bf16 trunk hands
# it [B, 901, 12, 64] without terms, VLMo's [B, 941, 12, 64] with both


def _bf16_attn_err(what, got, plain, truth):
    """Tolerance of K3-bf16: the kernel and its plain version are both held
    against ``truth``, the float32 computation from the same bf16 inputs;
    the kernel's error may be at most twice the plain version's plus one
    bf16 ulp (2^-7) of the largest value (at least 1).  The plain version
    rounds P and dS to bf16 where the library kernel does, so its error is
    the bf16 arithmetic's own; the kernel rounds at the same places, P
    against a running maximum tile by tile, and sums in another order: an
    error of the same size, and an output may round to the other side by
    one ulp.  Returns the kernel's error."""
    got, plain, truth = got.float(), plain.float(), truth.float()
    err = float((got - truth).abs().max())
    err_plain = float((plain - truth).abs().max())
    tol = 2 * err_plain + 2 ** -7 * max(1.0, float(truth.abs().max()))
    require(err <= tol, f"{what}: max abs err {err} > {tol} (plain version's {err_plain})")
    return err


def _check_bf16_attention(q, k, v, table, key_bias, what, scale=SCALE):
    """K3-bf16 forward and backward against its plain versions and the
    float32 truth (:func:`_bf16_attn_err`), the log-sum-exp within the
    float32 tolerance (float32 sums of exact bf16 products); the backward
    repeats bit for bit.  ``q, k, v`` bf16, the terms float32 or None."""
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(2),
                     device="cuda").to(BF16)
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, key_bias)
    o_p, lse_p = attention.flash_attention_reference(q, k, v, table, scale, return_lse=True,
                                                     key_bias=key_bias)
    qf, kf, vf = q.float(), k.float(), v.float()
    o_t, lse_t = attention.flash_attention_reference(qf, kf, vf, table, scale, return_lse=True,
                                                     key_bias=key_bias)
    grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
    again = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
    plain = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, key_bias)
    truth = attention.flash_attention_bwd_reference(qf, kf, vf, table, scale, o_t, lse_t,
                                                    do.float(), key_bias)
    torch.cuda.synchronize()
    require(o.dtype == BF16 and all(g.dtype == BF16 for g in grads), "K3-bf16 output dtypes")
    require(o.shape == q.shape and all(g.shape == t.shape for g, t in zip(grads, (q, k, v))),
            f"{what}: K3-bf16 output shapes")
    errs = {"o": _bf16_attn_err(f"{what} o", o, o_p, o_t), "lse": _attn_err("lse", lse, lse_p)}
    for name, g, g2, p, t in zip(("dq", "dk", "dv"), grads, again, plain, truth):
        require(torch.equal(g, g2), f"{what}: bf16 backward {name} differs between two runs")
        errs[name] = _bf16_attn_err(f"{what} {name}", g, p, t)
    print(f"  flash_attention bf16 {list(q.shape)} {what}: "
          + ", ".join(f"{k} err {v:.3g}" for k, v in errs.items())
          + ", backward deterministic", flush=True)
    return errs


def check_flash_attention_bf16(gen):
    """K3-bf16 without terms at the shapes ALBEF's bf16 trunk gives it
    (batch 1, the batched chunk of 8, the victim's 16 at 901 tokens; the
    float32 victim itself takes K3-float32), ragged lengths, and the
    autograd Function; then its times at the chunk of 8."""
    errs = None
    for b in (1, TIMED_BATCH, 16):
        q, k, v = (t.to(BF16) for t in _qkv(gen, b, 901))
        e = _check_bf16_attention(q, k, v, None, None, "no terms")
        errs = e if b == TIMED_BATCH else errs
    for s in (1, 37, 130):
        q, k, v = (t.to(BF16) for t in _qkv(gen, 2, s))
        _check_bf16_attention(q, k, v, None, None, "ragged")
    q, k, v = (t.to(BF16) for t in _qkv(gen, 2, 901))
    w = torch.randn(q.shape, generator=gen, device="cuda")
    outs = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*xs, None, SCALE)
        outs.append((out.detach(), *torch.autograd.grad((out.float() * w).sum(), xs)))
    # autograd through the plain forward differentiates its bf16 rounding of
    # P as the identity: two bf16 ulps (2^-6) of each tensor's largest value
    for name, a, r in zip(("o", "dq", "dk", "dv"), *outs):
        err = float((a.float() - r.float()).abs().max())
        require(err <= 2 ** -6 * float(r.float().abs().max()), f"bf16 autograd {name}: {err}")
    print("  flash_attention bf16 autograd Function matches autograd of the plain version",
          flush=True)
    q, k, v = (t.to(BF16) for t in _qkv(gen, TIMED_BATCH, 901))
    return time_flash_attention_bf16(q, k, v, None, None, errs)


def time_flash_attention_bf16(q, k, v, table, key_bias, errs):
    """Device times of K3-bf16 (without terms, or with the table and the key
    bias: the ``_key_bias`` rows), its plain versions and
    ``scaled_dot_product_attention`` on the same bf16 inputs (with the two
    terms summed into one bf16 mask).  The bound: the larger of 4 and 10 x
    B*H*S^2*Dh at the dense bf16 rate, one pass, and the bytes of bf16 q, k,
    v, o (and dO, dq, dk, dv) with the float32 log-sum-exp and terms.  Timed
    in the order kernel, plain, SDPA, kernel (``ms_again``): the two kernel
    times show the spread inside one call."""
    b, s = q.shape[:2]
    o, lse = attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda").to(BF16)
    dense = None if table is None else (table + key_bias[:, None, None, :]).to(BF16)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_out = sdpa(qt, kt, vt, attn_mask=dense, scale=SCALE)
    do_t = do.transpose(1, 2)
    unit = b * HEADS * s * s * HEAD_DIM
    row = b * s * HEADS * HEAD_DIM * 2  # bytes of one [B, S, H, 64] bf16 tensor
    lse_bytes = 2 * b * HEADS * s * 4  # m and log l
    terms = 0 if table is None else (table.numel() + key_bias.numel()) * 4
    long_sleep = 20_000_000
    fwd_b, fwd_by = bound_ms(4 * row + lse_bytes + terms, 4 * unit, BF16_FLOPS)
    bwd_b, bwd_by = bound_ms(8 * row + lse_bytes + terms, 10 * unit, BF16_FLOPS)
    suffix = "" if table is None else "_key_bias"
    common = {"route": "cuda", "source": "vqattack_tpu_torch/csrc/flash_attention_bf16.cu",
              "replaces": "vqattack_tpu/ops/attention.py:134", "shape": [b, s, HEADS, HEAD_DIM],
              "dtype": "bfloat16"}
    fwd = dict(common, **{
        "name": "flash_attention_bf16_fwd" + suffix,
        "max_abs_err": errs["o"],
        "ms": time_ms(lambda: attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_reference(
            q, k, v, table, SCALE, key_bias=key_bias), 20, long_sleep),
        "bound_ms": fwd_b, "bound_by": fwd_by,
        "library_ms": time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense, scale=SCALE), 20),
        # the kernel again after the library call: the spread inside one call
        "ms_again": time_ms(lambda: attention.flash_attention_fwd(q, k, v, table, SCALE,
                                                                  key_bias), 20),
    })
    bwd = dict(common, **{
        "name": "flash_attention_bf16_bwd" + suffix,
        "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
        "ms": time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, table, SCALE, o, lse, do, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_bwd_reference(
            q, k, v, table, SCALE, o, lse, do, key_bias), 20, long_sleep),
        "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True), 20),
        "ms_again": time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, table, SCALE, o, lse, do, key_bias), 20),
    })
    for r, executed in ((fwd, 4 * unit), (bwd, 14 * unit)):
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["executed_tflops"] = executed / r["ms"] / 1e9
        require(r["bound_share"] <= 1.0, f"{r['name']}: {r['ms']} ms is under its bound "
                                         f"{r['bound_ms']} ms: the timing or the bound is wrong")
        print(f"  {r['name']} {r['shape']} bf16: {r['ms']:.4f} ms, {r['ms_again']:.4f} ms after "
              f"the library call (plain "
              f"{r['plain_ms']:.3f} ms, scaled_dot_product_attention bf16 "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
              f"{100 * r['bound_share']:.1f}%; executed {r['executed_tflops']:.1f} TFLOP/s)",
              flush=True)
    del dense, sdpa_out
    return fwd, bwd


# ---------------------------------------------------------------------------
# phase 4: model with kernels against plain LayerNorms
# ---------------------------------------------------------------------------


def check_model(cfg, surrogate, gen):
    """gen_feats and d(feature loss)/d(pixels) of the surrogate (fused_ln,
    kernels) against the same weights with plain LayerNorms, on the card.
    Tolerance: 1e-4 of each tensor's largest magnitude (float32 reassociation
    over 12 blocks)."""
    plain_cfg = dataclasses.replace(cfg.albef, vit=dataclasses.replace(cfg.albef.vit, fused_ln=False))
    with torch.device("cuda"):
        plain = AlbefPretrain(plain_cfg)
    plain.load_state_dict(surrogate.state_dict())
    plain.eval().requires_grad_(False)
    px = torch.rand((1, 3, 480, 480), generator=gen, device="cuda") * 2 - 1
    ids = torch.randint(1000, 2000, (1, 25), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    outs = []
    for model in (surrogate, plain):
        p = px.clone().requires_grad_(True)
        img_f, txt_f, logits = model.gen_feats(p, ids, mask)
        (g,) = torch.autograd.grad(img_f.square().mean() + txt_f.square().mean(), p)
        outs.append((img_f.detach(), txt_f.detach(), logits.detach(), g))
    for name, a, b in zip(("img_feats", "txt_feats", "mlm_logits", "d/dpixels"), *outs):
        require(a.shape == b.shape and bool(torch.isfinite(a).all()), f"{name} not finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        require(err <= 1e-4 * scale, f"{name}: max abs err {err} vs scale {scale}")
        print(f"  {name} {list(a.shape)}: max abs err {err:.3g} (scale {scale:.3g})", flush=True)
    del plain


def check_model_flash(surrogate, gen):
    """gen_feats and d(feature loss)/d(pixels) of the full-width surrogate
    under ``attention_impl("flash")`` (every ViT attention through K3)
    against the same weights on the product + softmax path.  Tolerance: 1e-4
    of each tensor's largest magnitude (float32 reassociation over 12
    blocks)."""
    px = torch.rand((2, 3, 480, 480), generator=gen, device="cuda") * 2 - 1
    ids = torch.randint(1000, 2000, (2, 25), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    outs = []
    for impl in ("flash", "xla"):
        before = attention.flash_attention_fwd.launches
        with attention.attention_impl(impl):
            p = px.clone().requires_grad_(True)
            img_f, txt_f, _ = surrogate.gen_feats(p, ids, mask)
            (g,) = torch.autograd.grad(img_f.square().mean() + txt_f.square().mean(), p)
        launched = attention.flash_attention_fwd.launches - before
        require(launched == (surrogate.cfg.vit.depth if impl == "flash" else 0),
                f"{impl}: {launched} flash forward launches")
        outs.append((img_f.detach(), txt_f.detach(), g))
    for name, a, b in zip(("img_feats", "txt_feats", "d/dpixels"), *outs):
        require(bool(torch.isfinite(a).all()), f"{name} not finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        require(err <= 1e-4 * scale, f"flash {name}: max abs err {err} vs scale {scale}")
        print(f"  flash vs product+softmax {name} {list(a.shape)}: max abs err {err:.3g} "
              f"(scale {scale:.3g})", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

WORDS = [
    "what", "color", "is", "the", "a", "dog", "cat", "man", "woman", "person",
    "red", "blue", "green", "yellow", "white", "black", "frisbee", "ball",
    "hat", "shirt", "wearing", "holding", "playing", "running", "sitting",
    "standing", "table", "grass", "street", "room", "many", "how", "two",
    "three", "there", "this", "that", "on", "in", "of", "and", "are", "it",
]
SAMPLES = [
    # qid, question, answer, paraphrase (None: feature-only path)
    (1001, "what color is the dog", "red", "the dog is red"),
    (1002, "what is the man holding", "frisbee", None),
]
# the batched path's traffic: every question has two substitutable words
# (3 blocks); 8 MAR samples fill bucket (0, 3) at batch 8, 3 feature-only
# samples form bucket (1, 3), padded to 4.  Bucket order is qid order.
BATCH_SAMPLES = [
    (2001, "what color is the dog", "red", "the dog is red"),
    (2002, "what color is the cat", "black", "the cat is black"),
    (2003, "what is the man holding", "frisbee", "the man is holding a frisbee"),
    (2004, "what is the woman wearing", "hat", "the woman is wearing a hat"),
    (2005, "what color is the shirt", "blue", "the shirt is blue"),
    (2006, "what color is the ball", "yellow", "the ball is yellow"),
    (2007, "what is the person holding", "ball", "the person is holding a ball"),
    (2008, "what color is the grass", "green", "the grass is green"),
    (3001, "what color is the hat", "white", None),
    (3002, "what is the woman holding", "frisbee", None),
    (3003, "what color is the table", "white", None),
]
BATCH_SIZE, PIPELINE_DEPTH = 8, 2


def write_assets(tmp: str) -> dict:
    """A 30,522-token vocab with bert-base-uncased's special ids ([PAD]=0,
    [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103), 3,129 answers (as the
    ALBEF answer list and VLMo's id2answer) and the side tables of every
    sample list, all in ``tmp``."""
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    toks += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + ["##" + w for w in WORDS]
    while len(toks) < 30522:
        toks.append(f"tok{len(toks)}")
    toks[30520:30522] = ["?", "."]  # VLMo's raw questions; no other id moves
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("vocab", "vocab.txt"), ("answers", "answers.json"), ("right", "right.txt"),
        ("sur", "sur.json"), ("tgt", "tgt.json"), ("para", "para.json"),
        ("allc", "allc.json"), ("id2answer", "id2answer.json"))}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(toks[:30522]) + "\n")
    answers = ["red", "blue", "green", "frisbee", "ball", "dog", "cat", "hat", "two", "yes"]
    answers += [f"tok{i}" for i in range(1000, 1000 + 3129 - len(answers))]
    everything = SAMPLES + BATCH_SAMPLES + VLMO_SAMPLES + VLMO_BATCH_SAMPLES + VILT_BATCH_SAMPLES
    tables = {
        "answers": answers,
        "id2answer": {str(i): a for i, a in enumerate(answers)},
        "sur": {str(q): a for q, _, a, _ in everything},
        "tgt": {str(q): a for q, _, a, _ in everything},
        "para": {str(q): [a, p] for q, _, a, p in everything if p is not None},
        "allc": {str(q): [a] for q, _, a, _ in everything},
    }
    for k, obj in tables.items():
        with open(paths[k], "w") as f:
            json.dump(obj, f)
    with open(paths["right"], "w") as f:
        f.write("\n".join(str(q) for q, *_ in everything) + "\n")
    return paths


# each kernel's row name -> (wrapper, its count): K2 and K3 count their
# float32 and bf16 instances apart (the ``_bf16`` rows), and K3 its launches
# with a key bias, VLMo's two-term form, apart again; the training-only
# instances last
KERNELS = {"pgd_linf_update": (pgd_update.pgd_linf_update, "launches")}
for _b, _prefix in (("", ""), ("_bf16", "bf16_")):
    for _d in ("fwd", "bwd"):
        KERNELS[f"residual_layernorm{_b}_{_d}"] = (
            getattr(fused_ln, f"residual_layernorm_{_d}"), _prefix + "launches")
    for _d in ("fwd", "bwd"):
        KERNELS[f"flash_attention{_b}_{_d}"] = (
            getattr(attention, f"flash_attention_{_d}"), _prefix + "launches")
    for _d in ("fwd", "bwd"):
        KERNELS[f"flash_attention{_b}_{_d}_key_bias"] = (
            getattr(attention, f"flash_attention_{_d}"), _prefix + "key_bias_launches")
    for _d in ("fwd", "bwd"):  # VLMo-base+'s head dim 34
        KERNELS[f"flash_attention{_b}_{_d}_hd34"] = (
            getattr(attention, f"flash_attention_{_d}"), _prefix + "hd34_launches")
# training only: K3's backward with the bias gradient (VLMo's table) and
# K2's backward with its parameter sums (LayerNorms that train)
KERNELS["flash_attention_bwd_dbias"] = (attention.flash_attention_bwd, "dbias_launches")
KERNELS["residual_layernorm_bwd_param_grads"] = (fused_ln.residual_layernorm_bwd,
                                                 "param_grads_launches")
TRAINING_ONLY = ("flash_attention_bwd_dbias", "residual_layernorm_bwd_param_grads")


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def implied_launches(cfg, vit_fwd: int, vit_bwd: int, k1: int, flash: bool,
                     dtype: str = "float32") -> dict:
    """Launches that ``vit_fwd`` ViT forwards, ``vit_bwd`` ViT backwards and
    ``k1`` L-inf updates imply: each forward runs 2 x depth fused
    residual+LayerNorm sites (K2) and, with ``--attn flash``, depth
    attentions (K3, no key bias); each backward as many backward kernels;
    all of them the instances of the trunk's ``dtype``."""
    depth = cfg.albef.vit.depth
    attn = depth if flash else 0
    b = "_bf16" if dtype == "bfloat16" else ""
    out = dict.fromkeys(KERNELS, 0)
    out.update({
        "pgd_linf_update": k1,
        f"residual_layernorm{b}_fwd": 2 * depth * vit_fwd,
        f"residual_layernorm{b}_bwd": 2 * depth * vit_bwd,
        f"flash_attention{b}_fwd": attn * vit_fwd,
        f"flash_attention{b}_bwd": attn * vit_bwd,
    })
    return out


def vlmo_implied_launches(cfg, fwd: int, bwd: int, k1: int, flash: bool,
                          dtype: str = "float32") -> dict:
    """Launches that ``fwd`` joint VLMo forwards, ``bwd`` backwards and
    ``k1`` L-inf updates imply: with ``--attn flash`` each forward runs
    depth attentions over 941 tokens, each with the text mask (K3 with a
    key bias, the instance of ``dtype``; VLMo-base adds its
    relative-position table, base+ has none and runs head dim 34), each
    backward as many; VLMo's LayerNorms are plain (no K2)."""
    attn = cfg.vlmo.depth if flash else 0
    b = "_bf16" if dtype == "bfloat16" else ""
    out = dict.fromkeys(KERNELS, 0)
    out.update({
        "pgd_linf_update": k1,
        f"flash_attention{b}_fwd": attn * fwd,
        f"flash_attention{b}_bwd": attn * bwd,
        f"flash_attention{b}_fwd_key_bias": attn * fwd,
        f"flash_attention{b}_bwd_key_bias": attn * bwd,
    })
    if cfg.vlmo.hidden_size // cfg.vlmo.num_heads == 34:
        out.update({f"flash_attention{b}_fwd_hd34": attn * fwd,
                    f"flash_attention{b}_bwd_hd34": attn * bwd})
    return out


def add_launches(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] += v


def schedule_passes(res, extra_grads: int = 0):
    """(ViT forwards, ViT backwards, K1 updates) of one attacked chunk,
    victim excluded.  K1 ends every PGD step (on the alternating path only
    the MLM half-step) and every VL step; every gradient step and VL step is
    one forward and one backward, the clean targets one forward.  A mixed
    second loss adds one forward and one backward per call
    (``extra_grads``)."""
    n_feat = len(res.feat_losses)
    n_mlm = 0 if res.mlm_losses is None else len(res.mlm_losses)
    grads = n_feat + n_mlm + res.vl_steps + extra_grads
    k1 = (n_feat if res.old_alg == 1 else n_mlm) + res.vl_steps
    return 1 + grads, grads, k1


def check_result(res, px, atk, size):
    losses = [res.feat_losses] + ([res.mlm_losses] if res.mlm_losses is not None else [])
    require(all(np.isfinite(l).all() and l.size > 0 for l in losses), "non-finite loss")
    require(res.adv_image.shape == (1, 3, size, size), "adversarial image shape")
    require(float(np.abs(res.adv_image - px).max()) <= atk.eps + 1e-6, "outside the eps ball")
    require(float(res.adv_image.min()) >= -1 and float(res.adv_image.max()) <= 1,
            "pixels outside [-1, 1]")


def load_answers(paths, tokenizer, answer_max_len, device):
    with open(paths["answers"]) as f:
        answer_list = json.load(f)
    a_ids, a_mask = tokenizer.encode_batch([a + "[SEP]" for a in answer_list],
                                           max_length=answer_max_len)
    return (answer_list, torch.as_tensor(a_ids, dtype=torch.long, device=device),
            torch.as_tensor(a_mask, dtype=torch.long, device=device))


def sample_pixels(i: int, size: int) -> np.ndarray:
    return np.random.default_rng(SEED + i).uniform(-1, 1, (1, 3, size, size)).astype(np.float32)


def run_main_path(pipe, cfg, tokenizer, paths, answer_max_len, samples=SAMPLES):
    """Attack every sample of ``samples`` one at a time and check the victim
    on the result; returns ``(results, launches, expected launches)`` with
    the launch counts reset just before and read just after.  The surrogate
    runs the kernels of ``cfg.compute_dtype``, the victim float32 ones."""
    side = SideTables.load([paths["right"]], [paths["sur"]], [paths["tgt"]],
                           [paths["para"]], [paths["allc"]])
    answer_list, answer_ids, answer_mask = load_answers(paths, tokenizer, answer_max_len,
                                                        pipe.device)
    atk = cfg.attack
    size = cfg.albef.vit.image_size
    flash = attention.get_impl() == "flash"
    results, expected = [], dict.fromkeys(KERNELS, 0)
    reset_counts()
    for i, (qid, question, _, _) in enumerate(samples):
        info = side.attack_inputs(qid)
        px = sample_pixels(i, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.attack_sample(px, question, str(qid), info["paraphrase"],
                                 info["target_answer"], info["all_correct_answers"])
        topk_ids, topk_probs = pipe.evaluate_victim(res.adv_image, res.adv_text,
                                                    answer_ids, answer_mask)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_result(res, px, atk, size)
        require(topk_ids.shape == (1, min(cfg.k_test, len(answer_list)))
                and np.isfinite(topk_probs).all(), "victim rank_answer output")
        fwd, bwd, k1 = schedule_passes(res)
        add_launches(expected, implied_launches(cfg, fwd, bwd, k1, flash, cfg.compute_dtype))
        add_launches(expected, implied_launches(cfg, 1, 0, 0, flash))  # the victim
        results.append(res)
        n_grads = len(res.feat_losses) + (0 if res.mlm_losses is None else len(res.mlm_losses))
        print(f"  sample {qid}: old_alg={res.old_alg} blocks={res.num_blocks} "
              f"vl_steps={res.vl_steps} grad steps={n_grads} adv_text={res.adv_text!r} "
              f"victim top1={answer_list[int(topk_ids[0, 0])]!r} {dt:.2f} s/sample",
              flush=True)
    return results, counts(), expected


def run_batched_path(engine, cfg, paths, args, sample_list, pixel_base, size, victim,
                     implied, victim_dtype="float32", chunks=(8, 4)):
    """The lockstep sweep over ``sample_list`` as ``run.py`` flushes a
    buffer (``engine.run``, then ``victim(results) -> top-1 answers`` in
    chunks of 16), with the phase timer on (the engine prints its
    breakdown); returns ``(results, launches, expected launches, seconds)``
    with the launch counts reset just before and read just after.
    ``implied(cfg, fwd, bwd, k1, flash, dtype)`` gives the launches a
    schedule implies: the surrogate's in ``cfg.compute_dtype``, the
    victim's in ``victim_dtype``; the engine must cut ``chunks``."""
    side = SideTables.load([paths["right"]], [paths["sur"]], [paths["tgt"]],
                           [paths["para"]], [paths["allc"]])
    samples = []
    for i, (qid, question, _, _) in enumerate(sample_list):
        info = side.attack_inputs(qid)
        samples.append({"qid": str(qid), "pixels": sample_pixels(pixel_base + i, size),
                        "question": question, "paraphrase": info["paraphrase"],
                        "target_answer": info["target_answer"],
                        "all_correct_answers": info["all_correct_answers"]})
    engine._timer = batched.PhaseTimer(True, engine.p.device)
    mixed, mixed_calls = engine._mixed_loss, []
    engine._mixed_loss = lambda *a: mixed_calls.append(1) or mixed(*a)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(samples, batch_size=args.batch_size,
                         rng=TorchKey(cfg.seed, engine.p.device),
                         pipeline_depth=args.pipeline_depth)
    torch.cuda.synchronize()
    attack_s = time.perf_counter() - t0
    n_victim = 0
    top1 = []
    for start in range(0, len(results), 16):
        top1 += victim(results[start : start + 16])
        n_victim += 1
    torch.cuda.synchronize()
    launched = counts()
    wall = time.perf_counter() - t0

    require([r.qid for r in results] == [str(q) for q, *_ in sample_list],
            "results not in qid order")
    require(engine.last_chunk_sizes == list(chunks), f"chunks {engine.last_chunk_sizes}")
    expected = implied(cfg, n_victim, 0, 0, True, victim_dtype)
    for old_alg, extra in ((0, len(mixed_calls)), (1, 0)):
        # one chunk per bucket: its real rows share one schedule
        res = next(r for r in results if r.old_alg == old_alg)
        add_launches(expected, implied(cfg, *schedule_passes(res, extra), True,
                                       cfg.compute_dtype))
    for smp, r in zip(samples, results):
        check_result(r, smp["pixels"], cfg.attack, size)
    n_iters = sum(len(r.feat_losses) + (0 if r.mlm_losses is None else len(r.mlm_losses))
                  for r in results)
    for r, t in zip(results, top1):
        print(f"  sample {r.qid}: old_alg={r.old_alg} blocks={r.num_blocks} "
              f"vl_steps={r.vl_steps} adv_text={r.adv_text!r} victim top1={t!r}", flush=True)
    print(f"  batched: {len(results)} samples, chunks {engine.last_chunk_sizes}, occupancy "
          f"{engine.last_occupancy:.3f}, mixed-loss calls {len(mixed_calls)}, attack "
          f"{attack_s:.2f} s, with the victim {wall:.2f} s: "
          f"{cfg.attack.num_iters * len(results) / attack_s:.2f} aggregate sample-iterations/s "
          f"({n_iters} PGD gradient steps counted)", flush=True)
    return results, launched, expected, attack_s


def run_albef_batched_path(pipe, cfg, tokenizer, paths, args):
    """BATCH_SAMPLES through ``BatchedAlbefAttack``, the victim's batched
    ``rank_answer``."""
    answer_list, answer_ids, answer_mask = load_answers(paths, tokenizer, args.answer_max_len,
                                                        pipe.device)

    def victim(chunk):
        topk_ids, topk_probs = pipe.evaluate_victim_batch(
            [r.adv_image for r in chunk], [r.adv_text for r in chunk], answer_ids, answer_mask)
        require(topk_ids.shape == (len(chunk), min(cfg.k_test, len(answer_list)))
                and np.isfinite(topk_probs).all(), "batched victim output")
        return [answer_list[int(row[0])] for row in topk_ids]

    return run_batched_path(batched.BatchedAlbefAttack(pipe), cfg, paths, args, BATCH_SAMPLES,
                            100, cfg.albef.vit.image_size, victim, implied_launches)


def step_ab(step, square, what):
    """``step()`` with ``--attn flash`` and ``--attn xla``, after one
    warm-up each, in the turns flash, xla, xla, flash twice over: the
    median, the mean and every step's seconds, and the peak device memory
    of each.  The warm-up steps also count the tensors of shape ``square`` that
    autograd saves: the flash step must hold none (the xla step holds its
    attention probabilities).  A step's wall time includes the host's
    enqueueing, which varies from call to call."""
    out = {"flash": [], "xla": []}
    peak, squares = {}, {}
    for impl in ("flash", "xla") + ("flash", "xla", "xla", "flash") * 2:
        warm = impl not in peak
        saved = []

        def pack(t):
            if tuple(t.shape) == square:
                saved.append(1)
            return t

        hooks = (torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t) if warm
                 else contextlib.nullcontext())
        with attention.attention_impl(impl), hooks:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if warm:
            peak[impl] = torch.cuda.max_memory_allocated()
            squares[impl] = len(saved)
        else:
            out[impl].append(dt)
        torch.cuda.empty_cache()
    require(squares["flash"] == 0, f"the flash step saved {squares['flash']} {list(square)} "
                                   f"tensors")
    require(squares["xla"] > 0, f"the xla step saved no {list(square)} tensors: the check "
                                f"cannot see them")
    ab = {impl: {"s_per_step": sum(v) / len(v), "median_s": float(np.median(v)),
                 "steps_s": v, "peak_bytes": peak[impl], "saved_bhss_tensors": squares[impl]}
          for impl, v in out.items()}
    for impl, r in ab.items():
        print(f"  {what}, --attn {impl}: median {r['median_s']:.4f} s, "
              f"mean {r['s_per_step']:.4f} s (min {min(r['steps_s']):.4f}, max "
              f"{max(r['steps_s']):.4f}), peak memory {r['peak_bytes'] / 2 ** 30:.2f} GiB, "
              f"{r['saved_bhss_tensors']} saved {list(square)} tensors", flush=True)
    return ab


def one_step_ab(pipe, cfg, tokenizer, gen):
    """One PGD gradient step (feature loss, forward + backward + K1) at batch
    16, flash against xla (:func:`step_ab`)."""
    b, size, dev = 16, cfg.albef.vit.image_size, pipe.device
    ori = torch.rand((b, 3, size, size), generator=gen, device=dev) * 2 - 1
    ids, mask = tokenizer.encode_batch(["what color is the dog"] * b, cfg.attack.max_text_len)
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.long, device=dev)
    aux = {"text_ids": ids, "text_mask": mask, "ori_ids": ids, "ori_mask": mask,
           "txt_token_mask": mask.float(), "special_ids": pipe._special}
    aux.update(pipe._targets_fn(ori, TorchKey(1, dev), aux))
    atk = cfg.attack

    def step():
        pgd_feature(pipe._feature_loss, ori, ori, TorchKey(2, dev), aux,
                    eps=atk.eps, eps_iter=atk.step_size, nb_iter=1)

    seq = cfg.albef.vit.seq_len
    return step_ab(step, (b, cfg.albef.vit.num_heads, seq, seq), "one gradient step at batch 16")


# ---------------------------------------------------------------------------
# the VLMo phases (--pipeline vlmo): 941 joint tokens, the relative-position
# table and the padded-text mask as K3's two additive terms
# ---------------------------------------------------------------------------

VLMO_SAMPLES = [
    # VLMo questions keep their '?': the pipeline strips it to substitute
    (4001, "what color is the dog?", "red", "the dog is red"),
    (4002, "what is the man holding?", "frisbee", None),
]
VLMO_BATCH_SAMPLES = [(q + 3000, question + "?", a, p) for q, question, a, p in BATCH_SAMPLES]


def _vlmo_qkv_terms(pipe, tokenizer, gen, b, layer=0):
    """q, k, v at [b, 941, 12, 64], layer ``layer``'s [1, 12, 941, 941]
    table from ``precompute_joint_biases`` and the key bias of ``b`` real
    questions padded to 40 tokens (their padded text keys at -1e9, inside
    the sequence), as the joint trunk hands them to K3."""
    seq = pipe.max_text_len + pipe.model.cfg.image_seq_len
    q, k, v = _qkv(gen, b, seq)
    return q, k, v, pipe._rel_biases[layer][None], _text_key_bias(pipe, tokenizer, b, seq)


def _check_two_term_case(q, k, v, table, key_bias, what, scale=SCALE):
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, key_bias)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, table, scale, return_lse=True,
                                                     key_bias=key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
    again = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, key_bias)
    torch.cuda.synchronize()
    require(o.shape == q.shape and all(g.shape == t.shape for g, t in zip(grads, (q, k, v))),
            f"{what}: K3 output shapes")
    errs = {"o": _attn_err("o", o, o_r), "lse": _attn_err("lse", lse, lse_r)}
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        require(torch.equal(g, g2), f"two-term flash backward {name} differs between two runs")
        errs[name] = _attn_err(name, g, r)
    terms = {(False, False): "no terms", (False, True): "key bias", (True, False): "table",
             (True, True): "table + key bias"}[table is not None, key_bias is not None]
    print(f"  flash_attention {list(q.shape)} {terms} ({what}): "
          + ", ".join(f"{k} err {v:.3g}" for k, v in errs.items())
          + ", backward deterministic", flush=True)
    return errs


def check_flash_attention_key_bias(pipe, tokenizer, gen):
    """K3 with both additive terms against its plain versions at the shapes
    the VLMo path gives it: batch 1 (per-sample), 8 (the batched chunk) and
    16 (the victim), 941 tokens, a real table and padded text keys; a -inf
    key bias over every row's first key tile; the autograd Function.  Then
    the times at [16, 941, 12, 64]."""
    errs = {}
    for b in (1, TIMED_BATCH, 16):
        errs[b] = _check_two_term_case(*_vlmo_qkv_terms(pipe, tokenizer, gen, b),
                                       "padded text keys")
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, 2, layer=5)
    _check_two_term_case(q, k, v, table, key_bias.index_fill(1, torch.arange(70, device="cuda"),
                                                             -torch.inf),
                         "the first key tile at -inf")
    w = torch.randn(q.shape, generator=gen, device="cuda")
    grads = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(
            (fn(*xs, table, SCALE, key_bias=key_bias) * w).sum(), xs))
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        _attn_err(f"two-term autograd {name}", a, r)
    print("  flash_attention autograd Function with a key bias matches autograd of the plain "
          "version", flush=True)
    return time_flash_attention_key_bias(pipe, tokenizer, gen, errs[16])


def time_flash_attention_key_bias(pipe, tokenizer, gen, errs):
    """Device times at [16, 941, 12, 64] with the table and the key bias:
    the kernels, the plain versions and ``scaled_dot_product_attention`` with
    the two terms summed into one [16, 12, 941, 941] float mask (forward;
    backward through autograd).  The bound counts each input once, the
    table's 42.5 MB included; ``table_per_bh_bytes`` is the table read once
    per (batch, head), which the kernel does unless L2 keeps it.  The same
    kernels without the key bias and without either term are timed beside
    them (``table_only_ms``, ``no_terms_ms``)."""
    b = 16
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, b)
    s = q.shape[1]
    o, lse = attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    dense = table + key_bias[:, None, None, :]  # the sum K3 never forms
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=dense,
                                                                scale=SCALE)
    do_t = do.transpose(1, 2)
    unit = b * HEADS * s * s * HEAD_DIM
    row = b * s * HEADS * HEAD_DIM * 4
    terms = table.numel() * 4 + key_bias.numel() * 4
    lse_bytes = 2 * b * HEADS * s * 4  # m and log l
    long_sleep = 20_000_000
    fwd_b, fwd_by = tensor_core_bound_ms(4 * row + lse_bytes + terms, 4 * unit)
    bwd_b, bwd_by = tensor_core_bound_ms(8 * row + lse_bytes + terms, 10 * unit)
    common = {"route": "cuda", "source": "vqattack_tpu_torch/csrc/flash_attention.cu",
              "replaces": "vqattack_tpu/ops/attention.py:134", "shape": [b, s, HEADS, HEAD_DIM],
              "table_bytes": table.numel() * 4, "table_per_bh_bytes": b * table.numel() * 4}
    fwd = dict(common, **{
        "name": "flash_attention_fwd_key_bias",
        "max_abs_err": errs["o"],
        "ms": time_ms(lambda: attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_reference(
            q, k, v, table, SCALE, key_bias=key_bias), 20, long_sleep),
        "bound_ms": fwd_b, "bound_by": fwd_by,
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=dense, scale=SCALE), 20),
    })
    bwd = dict(common, **{
        "name": "flash_attention_bwd_key_bias",
        "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
        "ms": time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, table, SCALE, o, lse, do, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_bwd_reference(
            q, k, v, table, SCALE, o, lse, do, key_bias), 20, long_sleep),
        "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True), 20),
    })
    # the same kernels at the same shape without the key bias and without
    # either term: what each term costs
    o0, lse0 = attention.flash_attention_fwd(q, k, v, None, SCALE)
    o1, lse1 = attention.flash_attention_fwd(q, k, v, table, SCALE)
    fwd["table_only_ms"] = time_ms(lambda: attention.flash_attention_fwd(q, k, v, table, SCALE), 20)
    fwd["no_terms_ms"] = time_ms(lambda: attention.flash_attention_fwd(q, k, v, None, SCALE), 20)
    bwd["table_only_ms"] = time_ms(lambda: attention.flash_attention_bwd(
        q, k, v, table, SCALE, o1, lse1, do), 20)
    bwd["no_terms_ms"] = time_ms(lambda: attention.flash_attention_bwd(
        q, k, v, None, SCALE, o0, lse0, do), 20)
    for r, executed in ((fwd, 4 * unit), (bwd, 14 * unit)):
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["executed_tflops"] = executed / r["ms"] / 1e9
        require(r["bound_share"] <= 1.0, f"{r['name']}: {r['ms']} ms is under its bound "
                                         f"{r['bound_ms']} ms: the timing or the bound is wrong")
        print(f"  {r['name']} {r['shape']} f32: {r['ms']:.3f} ms (table only "
              f"{r['table_only_ms']:.3f} ms, no terms {r['no_terms_ms']:.3f} ms; plain "
              f"{r['plain_ms']:.3f} ms, scaled_dot_product_attention with the summed mask "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by {r['bound_by']}: "
              f"{100 * r['bound_share']:.1f}%; executed {r['executed_tflops']:.1f} TFLOP/s; "
              f"table {r['table_bytes'] / 1e6:.1f} MB, {r['table_per_bh_bytes'] / 1e6:.1f} MB "
              f"read per (b, h))", flush=True)
    del dense, sdpa_out
    return fwd, bwd


def check_flash_attention_bf16_key_bias(pipe, tokenizer, gen):
    """K3-bf16 with both terms at the shapes VLMo's bf16 trunk gives it
    (batch 1, 8 and 16 at 941 tokens; the table is ``pipe``'s, rounded to
    bf16 and held in float32 as the bf16 model makes it) and with a -inf
    first key tile; then its times at the victim batch of 16."""
    errs = {}
    for b in (1, TIMED_BATCH, 16):
        q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, b)
        errs[b] = _check_bf16_attention(*(t.to(BF16) for t in (q, k, v)), table, key_bias,
                                        "table + key bias (padded text keys)")
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, 2, layer=5)
    _check_bf16_attention(*(t.to(BF16) for t in (q, k, v)), table,
                          key_bias.index_fill(1, torch.arange(70, device="cuda"), -torch.inf),
                          "table + the first key tile at -inf")
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, 16)
    return time_flash_attention_bf16(*(t.to(BF16) for t in (q, k, v)), table, key_bias, errs[16])


def check_vlmo_model_flash(pipe, tokenizer, gen):
    """One feature-loss gradient step of the full-width VLMo surrogate at
    batch 2: its features and d/dpixels under ``attention_impl("flash")``
    (every joint attention through K3: with both terms for VLMo-base, with
    the key bias at head dim 34 for base+) against the product + softmax
    path.  Tolerance: 1e-4 of each tensor's largest magnitude (float32
    reassociation over 12 or 24 blocks)."""
    size, dev = pipe.model.cfg.image_size, pipe.device
    px = torch.rand((2, 3, size, size), generator=gen, device=dev) * 2 - 1
    ids, mask = tokenizer.encode_batch(["what color is the dog?", "what is the man holding?"],
                                       pipe.max_text_len)
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.long, device=dev)
    aux = {"text_ids": ids, "text_mask": mask, "rel_biases": pipe._rel_biases,
           "ori_ids": ids, "ori_mask": mask}
    aux.update(pipe._targets_fn(torch.rand_like(px) * 2 - 1, None, aux))
    outs = []
    for impl in ("flash", "xla"):
        before = counts()
        with attention.attention_impl(impl):
            p = px.clone().requires_grad_(True)
            _, layer_cls, tokens, _ = pipe.model.attack_feats(p, ids, mask, pipe._rel_biases)
            loss, _ = pipe._feature_loss(p, None, aux)
            (g,) = torch.autograd.grad(loss, p)
        after = counts()
        depth = pipe.model.cfg.depth if impl == "flash" else 0
        names = ("flash_attention_fwd_key_bias", "flash_attention_bwd_key_bias")
        if pipe.model.cfg.hidden_size // pipe.model.cfg.num_heads == 34:
            names += ("flash_attention_fwd_hd34", "flash_attention_bwd_hd34")
        for name in names:
            want = 2 * depth if name.startswith("flash_attention_fwd") else depth
            require(after[name] - before[name] == want,
                    f"{impl}: {after[name] - before[name]} {name} launches, expected {want}")
        outs.append((layer_cls.detach(), tokens.detach(), g))
    for name, a, b in zip(("layer_cls", "token_feats", "d/dpixels"), *outs):
        require(bool(torch.isfinite(a).all()), f"VLMo {name} not finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        require(err <= 1e-4 * scale, f"VLMo flash {name}: max abs err {err} vs scale {scale}")
        print(f"  VLMo flash vs product+softmax {name} {list(a.shape)}: max abs err {err:.3g} "
              f"(scale {scale:.3g})", flush=True)


def run_vlmo_main_path(pipe, cfg, paths, samples=VLMO_SAMPLES):
    """The per-sample VLMo attack over ``samples`` and the victim's
    classifier on each result; returns ``(results, launches, expected
    launches)`` with the counts reset just before and read just after.  The
    victim runs in the surrogate's dtype."""
    side = SideTables.load([paths["right"]], [paths["sur"]], [paths["tgt"]],
                           [paths["para"]], [paths["allc"]])
    size = cfg.vlmo.image_size
    flash = attention.get_impl() == "flash"
    results, expected = [], dict.fromkeys(KERNELS, 0)
    reset_counts()
    for i, (qid, question, _, _) in enumerate(samples):
        info = side.attack_inputs(qid)
        px = sample_pixels(200 + i, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.attack_sample(px, question, str(qid), info["paraphrase"],
                                 info["target_answer"], info["all_correct_answers"])
        pred, answer = pipe.evaluate_victim(res.adv_image, res.adv_text)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_result(res, px, cfg.attack, size)
        require(0 <= pred < cfg.vlmo.vqa_label_size and answer == pipe.id2answer[pred],
                "VLMo victim output")
        fwd, bwd, k1 = schedule_passes(res)
        add_launches(expected, vlmo_implied_launches(cfg, fwd + 1, bwd, k1, flash,  # + victim
                                                     cfg.compute_dtype))
        results.append(res)
        print(f"  sample {qid}: old_alg={res.old_alg} blocks={res.num_blocks} "
              f"vl_steps={res.vl_steps} adv_text={res.adv_text!r} victim {answer!r} "
              f"{dt:.2f} s/sample", flush=True)
    return results, counts(), expected


def run_vlmo_batched_path(pipe, cfg, paths, args):
    """VLMO_BATCH_SAMPLES through ``BatchedVlmoAttack`` as ``run.py
    --pipeline vlmo`` runs it, the victim's classifier through
    ``evaluate_victim_batch``; every question keeps its '?'."""

    def victim(chunk):
        out = pipe.evaluate_victim_batch([r.adv_image for r in chunk],
                                         [r.adv_text for r in chunk])
        require(len(out) == len(chunk) and all(a == pipe.id2answer[p] for p, a in out),
                "batched VLMo victim output")
        return [a for _, a in out]

    res = run_batched_path(batched.BatchedVlmoAttack(pipe), cfg, paths, args,
                           VLMO_BATCH_SAMPLES, 300, cfg.vlmo.image_size, victim,
                           vlmo_implied_launches, victim_dtype=cfg.compute_dtype)
    for r in res[0]:
        require(r.adv_text.endswith("?"), f"{r.qid}: the VLMo question lost its '?'")
    return res


def vlmo_one_step_ab(pipe, cfg, tokenizer, gen):
    """One VLMo feature-loss PGD step at batch 16, flash against xla
    (:func:`step_ab`): the flash step holds no [16, 12, 941, 941] tensor."""
    b, size, dev = 16, cfg.vlmo.image_size, pipe.device
    ori = torch.rand((b, 3, size, size), generator=gen, device=dev) * 2 - 1
    ids, mask = tokenizer.encode_batch(["what color is the dog?"] * b, pipe.max_text_len)
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.long, device=dev)
    aux = {"text_ids": ids, "text_mask": mask, "rel_biases": pipe._rel_biases,
           "ori_ids": ids, "ori_mask": mask}
    aux.update(pipe._targets_fn(ori, None, aux))
    atk = cfg.attack

    def step():
        pgd_feature(pipe._feature_loss, ori, ori, TorchKey(2, dev), aux,
                    eps=atk.eps, eps_iter=atk.step_size, nb_iter=1)

    seq = pipe.max_text_len + cfg.vlmo.image_seq_len
    return step_ab(step, (b, cfg.vlmo.num_heads, seq, seq),
                   "one VLMo gradient step at batch 16")


# ---------------------------------------------------------------------------
# the VLMo-base+ phases (--named-config task_finetune_vqa_base_plus_image480):
# 24 MoME blocks of width 544 over 16 heads, head dim 34, absolute position
# embeddings and no relative-position table, so K3 takes the padded-text key
# bias alone
# ---------------------------------------------------------------------------

BASE_PLUS = "task_finetune_vqa_base_plus_image480"
PLUS_HEADS, PLUS_HEAD_DIM = 16, 34
PLUS_SCALE = PLUS_HEAD_DIM ** -0.5


def _text_key_bias(pipe, tokenizer, b, seq):
    """The ``[b, seq]`` key bias of ``b`` real questions padded to the text
    length (their padded text keys at -1e9, inside the joint sequence)."""
    questions = [q for _, q, _, _ in VLMO_BATCH_SAMPLES]
    _, mask = tokenizer.encode_batch([questions[i % len(questions)] for i in range(b)],
                                     pipe.max_text_len)
    co = torch.cat([torch.as_tensor(mask, device="cuda"),
                    torch.ones(b, seq - pipe.max_text_len, dtype=torch.int32, device="cuda")], 1)
    return mask_to_key_bias(co)


def _plus_qkv(gen, b, sq, sk=None, dtype=torch.float32):
    """q, k, v at [b, S, 16, 34] as views of three [b, S, 544] projections,
    as the base+ trunk hands them to K3: a head starts 136 bytes (68 in
    bf16) after the last."""
    sk = sq if sk is None else sk
    width = PLUS_HEADS * PLUS_HEAD_DIM
    return [torch.randn(b, s, width, generator=gen, device="cuda").to(dtype).view(
        b, s, PLUS_HEADS, PLUS_HEAD_DIM) for s in (sq, sk, sk)]


def check_flash_attention_hd34(pipe, tokenizer, gen):
    """K3 at head dim 34, float32 and bf16, forward and backward, against
    the plain versions at the float32 (2e-5) and bf16 (:func:`_bf16_attn_err`)
    tolerances: at [B, 941, 16, 34] for B = 1, 8 (the batched chunk) and 16
    (the victim), strided views of [B, 941, 544] projections with the
    padded-text key bias of real questions; ragged lengths (1, 63, 130 and
    200 queries over 77 keys); a -inf first key tile; the autograd Function.
    Then each dtype's times at [16, 941, 16, 34]
    (:func:`time_flash_attention_hd34`)."""
    seq = pipe.max_text_len + pipe.model.cfg.image_seq_len
    rows, errs = [], {}
    for dtype in (torch.float32, BF16):
        name = "bf16" if dtype == BF16 else "f32"

        def check(q, k, v, kb, what):
            if dtype == BF16:
                return _check_bf16_attention(q, k, v, None, kb, what, PLUS_SCALE)
            return _check_two_term_case(q, k, v, None, kb, what, PLUS_SCALE)

        for b in (1, TIMED_BATCH, 16):
            errs[name, b] = check(*_plus_qkv(gen, b, seq, dtype=dtype),
                                  _text_key_bias(pipe, tokenizer, b, seq), "padded text keys")
        for sq, sk in ((1, 1), (63, 63), (130, 130), (200, 77)):
            # five keys of row 1 masked, as padded text is: never a row's every key
            kb = torch.zeros(2, sk, device="cuda")
            kb[1, sk // 3 : sk // 3 + 5] = -1e9 if sk > 8 else 0.0
            check(*_plus_qkv(gen, 2, sq, sk, dtype), kb, f"ragged, {sq} queries over {sk} keys")
        kb = _text_key_bias(pipe, tokenizer, 2, seq).index_fill(
            1, torch.arange(70, device="cuda"), -torch.inf)
        check(*_plus_qkv(gen, 2, seq, dtype=dtype), kb, "the first key tile at -inf")
        q, k, v = _plus_qkv(gen, 2, seq, dtype=dtype)
        kb = _text_key_bias(pipe, tokenizer, 2, seq)
        w = torch.randn(q.shape, generator=gen, device="cuda")
        outs = []
        for fn in (attention.flash_attention, attention.flash_attention_reference):
            xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*xs, None, PLUS_SCALE, key_bias=kb)
            outs.append((out.detach(), *torch.autograd.grad((out.float() * w).sum(), xs)))
        for what, a, r in zip(("o", "dq", "dk", "dv"), *outs):
            require(a.shape == r.shape, f"head dim 34 autograd {what} shape")
            if dtype == BF16:  # as check_flash_attention_bf16 holds it
                err = float((a.float() - r.float()).abs().max())
                require(err <= 2 ** -6 * float(r.float().abs().max()),
                        f"head dim 34 bf16 autograd {what}: {err}")
            else:
                _attn_err(f"head dim 34 autograd {what}", a, r)
        print(f"  flash_attention {name} head dim 34 autograd Function matches autograd of the "
              f"plain version", flush=True)
        rows += time_flash_attention_hd34(*_plus_qkv(gen, 16, seq, dtype=dtype),
                                          _text_key_bias(pipe, tokenizer, 16, seq),
                                          errs[name, 16])
    return rows


def sdpa_backend(fn) -> str:
    """The backend whose kernels one call of ``fn`` runs, by the names the
    profiler records on the card: flash, efficient (memory-efficient),
    cudnn or math (plain products)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for backend, marks in (("flash", ("flash",)), ("cudnn", ("cudnn",)),
                           ("efficient", ("fmha", "efficient", "mem_eff"))):
        if any(m in names for m in marks):
            return backend
    return "math" if names else "not measured (no device events)"


def time_flash_attention_hd34(q, k, v, key_bias, errs, suffix=""):
    """Device times at [16, 941, 16, 34] with the padded-text key bias, in
    q's dtype: the kernels alone (``ms``; bf16 on the padded 40-wide
    copies), the copies the main path adds (``copy_ms``: bf16 q, k, v into
    40-wide rows before the forward, dO before the backward; float32 reads
    the projections in place), the plain versions, and
    ``scaled_dot_product_attention`` on the same inputs with the key bias as
    a [16, 1, 1, 941] mask (forward; backward through autograd), whose
    backend is named.  The bound counts what the function needs: 4 and 10
    x B*H*S^2*Dh at Dh = 34 (float32: three TF32 passes), each input and
    output once; ``executed_tflops`` counts what the kernels execute (40
    columns in float32, 64 in bf16; 14 in the backward).  The rows' names
    end in ``_hd34`` and ``suffix``."""
    b, s, h, dh = q.shape
    dtype = q.dtype
    width = attention.kernel_width(dtype, dh)
    dims = (b, h, s, s)
    o, lse = attention.flash_attention_fwd(q, k, v, None, PLUS_SCALE, key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(4),
                     device="cuda").to(dtype)
    qp, kp, vp, op, dop = (attention.pad_heads(t, width) for t in (q, k, v, o, do))
    executed_dh = 64 if dtype == BF16 else 40  # the columns the kernels' products run over
    mask = key_bias[:, None, None, :].to(dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_out = sdpa(qt, kt, vt, attn_mask=mask, scale=PLUS_SCALE)
    do_t = do.transpose(1, 2)
    unit = b * h * s * s * dh
    row = b * s * h * dh * q.element_size()
    small = 2 * b * h * s * 4 + key_bias.numel() * 4  # m and log l, key bias
    if dtype == BF16:
        fwd_b, fwd_by = bound_ms(4 * row + small, 4 * unit, BF16_FLOPS)
        bwd_b, bwd_by = bound_ms(8 * row + small, 10 * unit, BF16_FLOPS)
        copies = (lambda: [attention.pad_heads(t, width) for t in (q, k, v)],
                  lambda: attention.pad_heads(do, width))
    else:
        fwd_b, fwd_by = tensor_core_bound_ms(4 * row + small, 4 * unit)
        bwd_b, bwd_by = tensor_core_bound_ms(8 * row + small, 10 * unit)
        copies = (None, None)
    long_sleep = 20_000_000
    tag = "_bf16" if dtype == BF16 else ""
    source = "flash_attention_bf16.cu" if dtype == BF16 else "flash_attention.cu"
    common = {"route": "cuda", "source": f"vqattack_tpu_torch/csrc/{source}",
              "replaces": "vqattack_tpu/ops/attention.py:134", "shape": [b, s, h, dh],
              "dtype": "bfloat16" if dtype == BF16 else "float32", "kernel_width": width}
    fwd = dict(common, **{
        "name": f"flash_attention{tag}_fwd_hd34{suffix}",
        "max_abs_err": errs["o"],
        "ms": time_ms(lambda: attention._launch_fwd(qp, kp, vp, None, PLUS_SCALE, key_bias,
                                                    dims, dh), 20),
        "copy_ms": 0.0 if copies[0] is None else time_ms(copies[0], 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_reference(
            q, k, v, None, PLUS_SCALE, key_bias=key_bias), 20, long_sleep),
        "bound_ms": fwd_b, "bound_by": fwd_by,
        "library_ms": time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=PLUS_SCALE), 20),
        "library_backend": sdpa_backend(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                     scale=PLUS_SCALE)),
    })
    bwd = dict(common, **{
        "name": f"flash_attention{tag}_bwd_hd34{suffix}",
        "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
        "ms": time_ms(lambda: attention._launch_bwd(qp, kp, vp, None, PLUS_SCALE, op, lse, dop,
                                                    key_bias, dims, dh), 20),
        "copy_ms": 0.0 if copies[1] is None else time_ms(copies[1], 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_bwd_reference(
            q, k, v, None, PLUS_SCALE, o, lse, do, key_bias), 20, long_sleep),
        "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True), 20),
        "library_backend": sdpa_backend(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True)),
    })
    for r, executed in ((fwd, 4), (bwd, 14)):
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["executed_tflops"] = executed * b * h * s * s * executed_dh / r["ms"] / 1e9
        require(r["bound_share"] <= 1.0, f"{r['name']}: {r['ms']} ms is under its bound "
                                         f"{r['bound_ms']} ms: the timing or the bound is wrong")
        print(f"  {r['name']} {r['shape']} {r['dtype']}: {r['ms']:.4f} ms, copies "
              f"{r['copy_ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
              f"scaled_dot_product_attention ({r['library_backend']}) {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
              f"{100 * r['bound_share']:.1f}%; executed {r['executed_tflops']:.1f} TFLOP/s)",
              flush=True)
    del sdpa_out
    return [fwd, bwd]


def check_plus_launches(launched, expected, dtype, what):
    """The base+ path's counts: the schedules', and exactly K1 and K3 with a
    key bias at head dim 34 in the trunk's dtype (the victim runs in it too)."""
    b = "_bf16" if dtype == "bfloat16" else ""
    positive = {"pgd_linf_update"} | {f"flash_attention{b}_{d}{suffix}" for d in ("fwd", "bwd")
                                      for suffix in ("", "_key_bias", "_hd34")}
    check_launches(launched, expected, positive, what)


# ---------------------------------------------------------------------------
# the bf16 trunk: float32 against bf16 at full width
# ---------------------------------------------------------------------------


def _drift_run(pipe, cfg, question, paraphrase, answer, vlmo):
    """One sample's first PGD block without the text attack, as the
    pipeline's first block runs it: clean targets from the pipeline's own
    surrogate, the feature loss (feature-only sample) or the feature and MAR
    losses in turn (MAR sample), the rand-init drawn from ``TorchKey(SEED)``:
    the same noise for every dtype.  Returns ``(adv, [loss trajectories])``."""
    atk, dev = cfg.attack, pipe.device
    px = torch.as_tensor(sample_pixels(900, cfg.vlmo.image_size if vlmo else
                                       cfg.albef.vit.image_size), device=dev)
    ids, mask = pipe.encode(question)
    aux = {"text_ids": ids, "text_mask": mask, "ori_ids": ids, "ori_mask": mask}
    if vlmo:
        aux["rel_biases"] = pipe._rel_biases
    else:
        aux.update({"txt_token_mask": mask.float(), "special_ids": pipe._special})
    aux.update(pipe._targets_fn(px, TorchKey(SEED + 1, dev), aux))
    kw = dict(eps=atk.eps, eps_iter=atk.step_size, clip_min=atk.clip_min,
              clip_max=atk.clip_max, rand_init=True)
    if paraphrase is None:
        adv, fl = pgd_feature(pipe._feature_loss, px, px, TorchKey(SEED, dev), aux,
                              nb_iter=atk.num_iters, **kw)
        return px, adv, [fl]
    suffix = "." if vlmo else ""
    mar = build_mar_labels(paraphrase, answer, [answer], pipe.tokenizer, ids.shape[1],
                           atk.max_answers, sentence_suffix=suffix)
    require(mar.old_alg == 0, "the MAR sample must take the alternating path")
    m_ids, m_mask = pipe.tokenizer.encode(" ".join(mar.paraphrase_words) + suffix, ids.shape[1])
    aux.update({"mlm_ids": pipe._ids(m_ids[None]), "mlm_mask": pipe._ids(m_mask[None]),
                "mlm_labels": pipe._ids(mar.labels[None])})
    adv, fl, ml = pgd_alternating(pipe._feature_loss, pipe._mlm_loss, px, px,
                                  TorchKey(SEED, dev), aux, nb_iter=atk.num_iters // 2, **kw)
    return px, adv, [fl, ml]


def drift_check(pipes, cfgs, samples, vlmo, what):
    """The JAX package's trajectory budget for its bf16 trunk
    (``tests/test_remat.py``), at full width: for one MAR and one
    feature-only sample, every loss trajectory of the bf16 surrogate ends
    within 10% of the float32 one's final value, deviates from it by under
    20% on average, and the adversarial images differ by under eps/2 on
    average; both stay inside the ball."""
    out = []
    for qid, question, answer, paraphrase in samples:
        runs = [_drift_run(p, c, question, paraphrase, answer, vlmo) for p, c in zip(pipes, cfgs)]
        (px, a32, l32), (_, a16, l16) = runs
        eps = cfgs[0].attack.eps
        row = {"qid": qid, "path": "feature" if paraphrase is None else "MAR"}
        for name, t32, t16 in zip(("feature", "mlm"), l32, l16):
            t32, t16 = t32[:, 0].cpu().numpy(), t16[:, 0].cpu().numpy()
            rel_final = abs(t16[-1] - t32[-1]) / abs(t32[-1])
            rel_traj = float(np.mean(np.abs(t16 - t32) / np.maximum(np.abs(t32), 1e-6)))
            require(rel_final < 0.10 and rel_traj < 0.20,
                    f"{what} {qid} {name} loss drift: final {rel_final:.4f}, mean {rel_traj:.4f}")
            row[name] = {"final_f32": float(t32[-1]), "final_bf16": float(t16[-1]),
                         "rel_final": float(rel_final), "rel_traj": rel_traj}
        d = float((a16 - a32).abs().mean())
        require(d < 0.5 * eps, f"{what} {qid}: mean pixel difference {d}")
        for adv in (a32, a16):
            require(float((adv - px).abs().max()) <= eps + 1e-6, f"{what} {qid}: outside the ball")
        row["mean_pixel_diff"] = d
        print(f"  {what} drift {qid} ({row['path']}): " + ", ".join(
            f"{n} final {row[n]['final_f32']:.4f} -> {row[n]['final_bf16']:.4f} "
            f"({100 * row[n]['rel_final']:.2f}%), mean deviation {100 * row[n]['rel_traj']:.2f}%"
            for n in ("feature", "mlm") if n in row) + f"; mean pixel difference {d:.5f}",
            flush=True)
        out.append(row)
    return out


def build_pipelines(argv, tokenizer):
    """``run.py``'s pipeline for ``argv``: its parsed args, config and
    pipeline (random full-width weights from ``--seed``)."""
    args = port_run.build_argparser().parse_args(argv)
    cfg = port_run.resolve_config(args)
    return args, cfg, port_run._build_pipeline(args, cfg, tokenizer)


def check_launches(launched, expected, positive, what):
    """Every count equals the schedules', and exactly the kernels in
    ``positive`` were launched."""
    for k, n in launched.items():
        require(n == expected[k], f"{what} {k}: {n} launches, the schedules imply {expected[k]}")
        require((n > 0) == (k in positive), f"{what} {k}: {n} launches")


# ---------------------------------------------------------------------------
# the training slice: K3's bias gradient (dbias) and VQA fine-tuning
# (vqattack_tpu_torch/train/cli.py: vlmo_vqa, albef_vqa)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
TRAIN_BATCH = 8
# dbias against its plain version: 2e-5 of the largest |dbias|, the card
# tests' bound for K3 (float32 sums over 941 keys in another order, the
# 3xTF32 split's error in the kernel's dS)
DBIAS_TOL = 2e-5
# the table gradient of one vlmo_vqa step, flash against xla: each entry
# within 1e-4 of its mass, the sum of the |dS| that the gather adds into it
# over the 12 layers (the model checks' 1e-4, taken of the terms of a sum
# that cancels: an entry adds up to 8 x 941 scores of each layer, and its
# value is far smaller than its terms), or 1e-6 of the largest entry
TABLE_GRAD_TOL = 1e-4


def _dbias_err(what, got, ref):
    err = float((got - ref).abs().max())
    tol = DBIAS_TOL * float(ref.abs().max())
    require(err <= tol, f"{what} dbias: max abs err {err} > {tol}")
    return err


def dbias_plan_info(b, h, sq, sk, dh, bias_shape, key_bias) -> dict:
    """The dbias instance's sum over B at this shape: blocks a cluster (C),
    clusters a tile (G), cudaOccupancyMaxActiveClusters of that instance
    and cluster size, and the bytes of the partial sums' scratch (0 where
    the cluster writes the gradient itself)."""
    plan = attention.dbias_plan((b, h, sq, sk), tuple(bias_shape))
    scratch = 0 if plan.scratch_shape is None else 4 * math.prod(plan.scratch_shape)
    return {"cluster": plan.cluster, "groups": plan.groups, "scratch_bytes": scratch,
            "max_active_clusters": attention.dbias_max_clusters(dh, key_bias is not None,
                                                                plan.cluster)}


def _check_dbias_case(q, k, v, bias, key_bias, what, scale=SCALE):
    """K3's backward with dbias against the plain backward's dbias (summed
    over B in the kernel's order); dbias and dq/dk/dv repeat bit for bit;
    whether dq/dk/dv are the bits of the backward without dbias is printed,
    and the sum's plan (:func:`dbias_plan_info`)."""
    o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias, dbias=True)
    again = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias, dbias=True)
    without = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do, key_bias,
                                                   dbias=True)
    torch.cuda.synchronize()
    require(grads[3].shape == bias.shape, f"{what}: dbias {tuple(grads[3].shape)}")
    for name, g, g2 in zip(("dq", "dk", "dv", "dbias"), grads, again):
        require(torch.equal(g, g2), f"{what}: {name} differs between two runs")
    errs = {n: _attn_err(f"{what} {n}", g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}
    errs["dbias"] = _dbias_err(what, grads[3], refs[3])
    same = all(torch.equal(a, b) for a, b in zip(grads, without))
    kb = "" if key_bias is None else " + key bias"
    b, sq, h, dh = q.shape
    info = dbias_plan_info(b, h, sq, k.shape[1], dh, bias.shape, key_bias)
    print(f"  flash_attention_bwd dbias q {list(q.shape)} k {list(k.shape)} bias "
          f"{list(bias.shape)}{kb} ({what}): "
          + ", ".join(f"{n} err {e:.3g}" for n, e in errs.items())
          + f" (|dbias| max {float(refs[3].abs().max()):.3g}); repeats bit for bit; dq/dk/dv "
          + ("the bits of" if same else "within tolerance of, not the bits of,")
          + f" the backward without dbias; C {info['cluster']}, G {info['groups']}, "
          f"max active clusters {info['max_active_clusters']}, scratch "
          f"{info['scratch_bytes']} B", flush=True)
    return errs


def check_flash_attention_dbias(pipe, tokenizer, gen):
    """K3's dbias instance at the shapes VLMo's training gives it (batch 1
    and 8, 941 tokens, the [1, 12, 941, 941] table of ``pipe`` and the
    padded-text key bias) and at batch 3, 9, 16 and 24 (one cluster of 3
    blocks; two of 8, the second padded; two; three), at head dim 34 on
    synthetic tables at the same batches, a [B, H, S, S] bias, ragged and
    cross lengths, a -inf first key tile, and the autograd Function with a
    table that needs a gradient; the peak allocation of one backward at
    batch 8 (no [B, H, S, S] buffer); then its times at batch 8."""
    errs = {}
    for b in (1, TRAIN_BATCH, 3, 9, 16, 24):
        errs[b] = _check_dbias_case(*_vlmo_qkv_terms(pipe, tokenizer, gen, b), "VLMo table")
    for b, seq, text in ((3, 197, False), (9, 237, True), (16, 196, True), (24, 237, True)):
        q, k, v = _plus_qkv(gen, b, seq)
        table = torch.randn(1, PLUS_HEADS, seq, seq, generator=gen, device="cuda") * 0.5
        kb = _text_key_bias(pipe, tokenizer, b, seq) if text else None
        _check_dbias_case(q, k, v, table, kb, "head dim 34, a synthetic table", PLUS_SCALE)
    q, k, v = _plus_qkv(gen, 9, 130)
    _check_dbias_case(q, k, v, torch.randn(9, PLUS_HEADS, 130, 130, generator=gen, device="cuda"),
                      None, "head dim 34, a [B, H, S, S] bias")
    q, k, v = _plus_qkv(gen, 9, 200, 77)
    _check_dbias_case(q, k, v, torch.randn(1, PLUS_HEADS, 200, 77, generator=gen, device="cuda"),
                      None, "head dim 34, 200 queries, 77 keys")
    dbias_peak(*_vlmo_qkv_terms(pipe, tokenizer, gen, TRAIN_BATCH))
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, 2, layer=5)
    dense = torch.randn(2, HEADS, q.shape[1], q.shape[1], generator=gen, device="cuda") * 0.5
    _check_dbias_case(q, k, v, dense, key_bias, "a [B, H, S, S] bias")
    _check_dbias_case(q, k, v, table, key_bias.index_fill(
        1, torch.arange(70, device="cuda"), -torch.inf), "the first key tile at -inf")
    q9, k9, v9, _, kb9 = _vlmo_qkv_terms(pipe, tokenizer, gen, 9, layer=5)
    _check_dbias_case(q9, k9, v9, table, kb9.index_fill(
        1, torch.arange(70, device="cuda"), -torch.inf), "the first key tile at -inf, batch 9")
    q2, k2, v2 = _qkv(gen, 2, 130)
    _check_dbias_case(q2, k2, v2, table[:, :, :130, :130].contiguous(), None, "130 tokens")
    qc, kc = _qkv(gen, 2, 200)[0], _qkv(gen, 2, 77)
    _check_dbias_case(qc, kc[1], kc[2], torch.randn(2, HEADS, 200, 77, generator=gen,
                                                    device="cuda"), None, "200 queries, 77 keys")
    w = torch.randn(q.shape, generator=gen, device="cuda")
    grads = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v, table)]
        before = attention.flash_attention_bwd.dbias_launches
        out = fn(*xs[:3], xs[3], SCALE, key_bias=key_bias)
        grads.append(torch.autograd.grad((out * w).sum(), xs))
        if fn is attention.flash_attention:
            require(attention.flash_attention_bwd.dbias_launches == before + 1,
                    "the autograd Function with a table that needs a gradient: one dbias launch")
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        _attn_err(f"dbias autograd {name}", a, r)
    _dbias_err("dbias autograd", grads[0][3], grads[1][3])
    print("  flash_attention autograd Function with a table that needs a gradient matches "
          "autograd of the plain version (one dbias launch)", flush=True)
    return time_flash_attention_dbias(pipe, tokenizer, gen, errs[TRAIN_BATCH])


def peak_bytes(fn) -> int:
    """The peak allocation of ``fn()`` over what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def dbias_peak(q, k, v, table, key_bias):
    """The peak allocation of one backward with dbias: dq, dk, dv, D and the
    gradient's one plane, and no [B, H, Sq, Sk] buffer."""
    o, lse = attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    peak = peak_bytes(lambda: attention.flash_attention_bwd(q, k, v, table, SCALE, o, lse, do,
                                                            key_bias, dbias=True))
    b, s, h, dh = q.shape
    plane, planes = h * s * s * 4, b * h * s * s * 4
    require(peak <= 3 * b * s * h * dh * 4 + b * h * s * 4 + plane + 16 * 2 ** 20 and peak < planes,
            f"one backward with dbias at {[b, s, h, dh]} allocated {peak} B at its peak")
    print(f"  flash_attention_bwd dbias {[b, s, h, dh]}: peak allocation {peak / 2 ** 20:.1f} MiB "
          f"(dq, dk, dv, D and one {plane / 2 ** 20:.1f} MiB plane; a [B, H, S, S] buffer would "
          f"be {planes / 2 ** 20:.1f} MiB)", flush=True)
    return peak


def time_flash_attention_dbias(pipe, tokenizer, gen, errs):
    """Device times at [8, 941, 12, 64], VLMo's training batch, with the
    table and the key bias (:func:`time_dbias`)."""
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, TRAIN_BATCH)
    return time_dbias(q, k, v, table, key_bias, SCALE, errs, "flash_attention_bwd_dbias", gen)


def time_dbias(q, k, v, table, key_bias, scale, errs, name, gen):
    """Device times of K3's backward with dbias on ``q, k, v [B, S, H, Dh]``
    (float32), a ``[1, H, S, S]`` table and ``key_bias`` (or None): the
    backward with dbias (``ms``: the D pass, dK/dV and the dQ kernel's
    dbias instance, which sums over B), the same backward without dbias
    (``no_dbias_ms``), the plain backward with dbias, and
    ``scaled_dot_product_attention`` with the summed mask built from a
    table that requires grad (backward through autograd, the sum over B
    included; its backend named).  Bound of the call: the products'
    operations (10 B H S^2 Dh, three TF32 passes) or its bytes, each input
    (q, k, v, o, dO, m and log l, the two terms) read once and each output
    (dq, dk, dv, the table's gradient) written once; the dbias part's own
    bound (``dbias_bound_ms``): the table's gradient written.  Also the
    sum's plan (:func:`dbias_plan_info`) and the peak allocation of one
    backward over what was allocated before it."""
    b, s, h, dh = q.shape
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, key_bias)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    unit = b * h * s * s * dh
    row = b * s * h * dh * 4
    terms = table.numel() * 4 + (0 if key_bias is None else key_bias.numel() * 4)
    bnd, by = tensor_core_bound_ms(8 * row + lse.numel() * 4 + terms + table.numel() * 4,
                                   10 * unit)
    ds_bound, _ = bound_ms(table.numel() * 4, 0)
    tbl = table.detach().clone().requires_grad_(True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))

    def mask():
        return tbl if key_bias is None else tbl + key_bias[:, None, None, :]

    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask(),
                                                                scale=scale)
    do_t = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt, tbl), do_t, retain_graph=True)

    def library_fresh():  # forward and backward, for the backend's kernel names
        out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask(),
                                                               scale=scale)
        return torch.autograd.grad(out, (qt, kt, vt, tbl), do_t)

    long_sleep = 20_000_000
    row_ = {
        "name": name, "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vqattack_tpu/ops/attention.py:134", "shape": [b, s, h, dh],
        "bias_shape": list(table.shape), "key_bias": key_bias is not None,
        "max_abs_err": errs["dbias"],
        "ms": time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, table, scale, o, lse, do, key_bias, dbias=True), 20, long_sleep),
        "no_dbias_ms": time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, table, scale, o, lse, do, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_bwd_reference(
            q, k, v, table, scale, o, lse, do, key_bias, dbias=True), 10, long_sleep),
        "bound_ms": bnd, "bound_by": by, "dbias_bound_ms": ds_bound,
        "library_ms": time_ms(library, 20, long_sleep),
        "library_backend": sdpa_backend(library_fresh),
        **dbias_plan_info(b, h, s, s, dh, table.shape, key_bias),
    }
    row_["peak_bytes"] = peak_bytes(lambda: attention.flash_attention_bwd(
        q, k, v, table, scale, o, lse, do, key_bias, dbias=True))
    row_["dbias_extra_ms"] = row_["ms"] - row_["no_dbias_ms"]
    row_["bound_share"] = bnd / row_["ms"]
    require(row_["bound_share"] <= 1.0, f"{name}: {row_['ms']} ms is under its bound {bnd} ms")
    kb = "" if key_bias is None else " + key bias"
    print(f"  {name} {[b, s, h, dh]} table {list(table.shape)}{kb} f32: {row_['ms']:.3f} ms "
          f"(without dbias {row_['no_dbias_ms']:.3f} ms: dbias adds "
          f"{row_['dbias_extra_ms']:.3f} ms against its bound {ds_bound:.4f} ms by bytes; "
          f"plain {row_['plain_ms']:.3f} ms; scaled_dot_product_attention with a mask that "
          f"requires grad, backward {row_['library_ms']:.3f} ms ({row_['library_backend']}); "
          f"bound {bnd:.3f} ms by {by}: {100 * row_['bound_share']:.1f}%; C {row_['cluster']}, "
          f"G {row_['groups']}, max active clusters {row_['max_active_clusters']}, scratch "
          f"{row_['scratch_bytes']} B; peak allocation {row_['peak_bytes'] / 2 ** 20:.1f} MiB)",
          flush=True)
    del sdpa_out
    return row_


def check_masked_rows(pipe, tokenizer, gen, dtype):
    """Step 0's repair: row 1 of the batch has every key masked by a finite
    -1e9 (its key bias), beside the table, at VLMo's 941 tokens; the
    kernels of ``dtype`` against their plain versions, forward and
    backward."""
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, 2)
    key_bias[1] = -1e9
    what = "row 1 masked whole by -1e9"
    if dtype == BF16:
        return _check_bf16_attention(*(t.to(BF16) for t in (q, k, v)), table, key_bias, what)
    return _check_two_term_case(q, k, v, table, key_bias, what)


def write_train_ann(tmp, name, n, size, pixel_base):
    """``n`` training questions over the batched samples' questions, each on
    an image of its own served by name (``pixels``), with answers and
    their weights (ALBEF) and soft targets over the 3,129 labels (VLMo)."""
    ann, pixels = [], {}
    for i in range(n):
        _, question, answer, _ = VLMO_BATCH_SAMPLES[i % len(VLMO_BATCH_SAMPLES)]
        image = f"train_{name}_{i}.jpg"
        ann.append({"image": image, "question": question, "question_id": 9000 + i,
                    "answer": [answer] * 7 + ["blue"] * 3,
                    "answer_labels": [(37 * i) % 3129, (11 * i + 5) % 3129],
                    "answer_scores": [1.0, 0.3]})
        pixels[image] = sample_pixels(pixel_base + i, size)
    path = os.path.join(tmp, f"ann_train_{name}.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path, pixels


@contextlib.contextmanager
def served_pixels(pixels):
    """The dataset's images served by name (the card's machine has no PIL)."""
    from vqattack_tpu_torch.data.vqa import VQADataset

    load_pixels = VQADataset._load_pixels
    VQADataset._load_pixels = lambda self, name: pixels[name]
    try:
        yield
    finally:
        VQADataset._load_pixels = load_pixels


@contextlib.contextmanager
def recorded_train_states():
    """The parameters of the last state saved and of the state restored by
    ``train.cli.main`` (``checkpoint/io.py``), by name, on the card."""
    from vqattack_tpu_torch.checkpoint import io as ckpt_io
    from vqattack_tpu_torch.train.optim import named_params

    rec = {}
    save, restore = ckpt_io.save_train_state, ckpt_io.restore_latest_train_state

    def params(state):
        return state.step, {n: p.detach().clone() for n, p in named_params(state.model).items()}

    def save_spy(state, ckpt_dir, step, keep=3):
        rec["saved"] = params(state)
        return save(state, ckpt_dir, step, keep)

    def restore_spy(ckpt_dir, like):
        out = restore(ckpt_dir, like)
        if out is not None:
            rec["restored"] = params(out)
        return out

    ckpt_io.save_train_state, ckpt_io.restore_latest_train_state = save_spy, restore_spy
    try:
        yield rec
    finally:
        ckpt_io.save_train_state, ckpt_io.restore_latest_train_state = save, restore


def run_train(argv, pixels):
    """``train.cli.main(argv)`` with the counts set to 0 just before and
    read just after: ``(summary, launches, seconds, peak GiB)``; the peak
    counts every allocation live at that point of the smoke run."""
    from vqattack_tpu_torch.train import cli as train_cli

    with served_pixels(pixels):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary = train_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = summary["losses"]
    require(len(losses) == summary["step"] - summary["start_step"] and losses
            and all(np.isfinite(losses + summary["grad_norms"])),
            f"train {argv[1]}: losses {losses}, grad norms {summary['grad_norms']}")
    return summary, launched, seconds, peak


def step_seconds(summary):
    """Seconds of each step after the first: the host clock between the
    metrics of consecutive steps read back (``--log-every 1``)."""
    t = summary["log_times"][: len(summary["losses"])]
    return [b - a for a, b in zip(t, t[1:])]


def train_implied_launches(task, depth, steps, flash):
    """K3 and K2 launches ``steps`` training steps of a trunk of ``depth``
    blocks imply.  vlmo_vqa and vlmo_irtr: with flash, depth joint
    attentions a forward and a backward (vlmo_irtr's over the B x 3
    pairs), each with the key bias, every backward with dbias (the table
    needs a gradient); vlmo_nlvr2: two joint passes, one an image of the
    pair, so twice as many.  albef_vqa, albef_pretrain, retrieval, ve and
    nlvr2: the ViT's 2 x depth fused norm sites a forward and a backward,
    every backward with parameter gradients, and with flash its depth
    attentions (nlvr2's ViT takes the pairs' 2B images in one pass; the
    text, fusion and answer attentions are under 128 queries, the product +
    softmax path)."""
    out = dict.fromkeys(KERNELS, 0)
    if task in ("vlmo_vqa", "vlmo_irtr", "vlmo_nlvr2"):
        n = (2 if task == "vlmo_nlvr2" else 1) * depth * steps if flash else 0
        for k in ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd_key_bias",
                  "flash_attention_bwd_key_bias", "flash_attention_bwd_dbias"):
            out[k] = n
        return out
    for k in ("residual_layernorm_fwd", "residual_layernorm_bwd",
              "residual_layernorm_bwd_param_grads"):
        out[k] = 2 * depth * steps
    if flash:
        out["flash_attention_fwd"] = out["flash_attention_bwd"] = depth * steps
    return out


class ReplayKey:
    """A key (``rng.py``) whose ``categorical`` and ``randint`` draws are
    recorded on the first pass and handed back in the same order after
    :meth:`replay`: two passes over the same batch sample the same hard
    negatives (and IRTR's caption offsets), whatever an ulp of difference
    in a similarity does to a draw."""

    def __init__(self, key):
        self.key, self.draws, self.replaying = key, [], None

    def split(self, n: int = 2):
        return [self] * n

    def _draw(self, fn):
        if self.replaying is not None:
            return self.replaying.pop(0)
        self.draws.append(fn())
        return self.draws[-1]

    def categorical(self, logits):
        return self._draw(lambda: self.key.categorical(logits))

    def randint(self, shape, lo, hi):
        return self._draw(lambda: self.key.randint(shape, lo, hi))

    def replay(self):
        self.replaying = list(self.draws)


# the table gradient of vlmo_irtr's first step, flash against xla: each
# entry within 1e-4 of the largest entry (the model checks' tolerance).
# Its loss starts at ln 3 (random weights score the three captions alike),
# and the gradient reaching the [CLS] rows is a difference of near-equal
# terms: xla's own float32 gradient is 7.56 times TABLE_GRAD_TOL of an
# entry's mass away from the same step in float64
# (scripts/table_grad_f64.py; PERF.md §6), so the kernel is held to
# TABLE_GRAD_TOL attention by attention, against each attention's float64
# gradient on the inputs the flash pass gave it (``per_call``).
TABLE_GRAD_OF_LARGEST_TOL = 1e-4


def _gathered(model, kinds, grads, h):
    """Each attention's [1, H, S, S] bias gradient added into the table's
    entries (the gather's transpose), float64."""
    table = model.relative_position_bias_table
    out = torch.zeros(table.shape, dtype=torch.float64, device=table.device)
    for (layer, kind), g in zip(kinds, grads):
        idx = getattr(model, f"_rel_index_{kind}").flatten()
        out[:, layer * h:(layer + 1) * h].index_add_(
            0, idx, g[0].double().permute(1, 2, 0).reshape(-1, h))
    return out


def _mass_ratio(a, b, mass):
    """The largest |a - b| over its entry's tolerance: TABLE_GRAD_TOL of its
    mass, or 1e-6 of b's largest entry."""
    return float(((a - b).abs() / (TABLE_GRAD_TOL * mass + 1e-6 * float(b.abs().max()))).max())


def vlmo_table_gradient(argv, tokenizer, pixels, expected_dbias=None, inspect=None,
                        per_call=False):
    """The relative-position table's gradient of the first step's loss (the
    CLI's task, model from ``--seed`` and ``--init-ckpt``, its first batch),
    under flash (K3 with dbias) and under xla, with the same hard
    negatives and offsets (:class:`ReplayKey`), each attention's gathered
    [1, H, S, S] bias gradient beside it: every entry of the two within
    :data:`TABLE_GRAD_TOL` of its mass (xla's |bias gradients| gathered
    into the entry).  ``expected_dbias``: the dbias launches of one flash
    pass (default: one a block).  ``inspect(model)`` runs on the model as
    the CLI built it.  ``per_call``: the end-to-end gradients within
    :data:`TABLE_GRAD_OF_LARGEST_TOL` of the largest entry instead, and
    each attention of the flash pass held on its own inputs (q, k, v, the
    terms and the gradient that reached its output): the kernel's dbias
    against the same attention's in float64, gathered into the table,
    every entry within :data:`TABLE_GRAD_TOL` of its mass (the float64
    |dS| gathered), autograd of the float32 product + softmax path printed
    beside it.  Returns ``{"err", "max", "err_of_tol"}`` (and
    ``"per_call_err_of_tol"``, ``"per_call_plain_err_of_tol"``)."""
    from vqattack_tpu_torch.train import cli as train_cli

    parser = train_cli.build_argparser()
    args = parser.parse_args(argv)
    preset = train_cli.apply_preset(parser, args)
    cfg = train_cli.resolve_config(args, preset, torch.device("cuda"))
    model, loss_fn, collate = train_cli.build_task(args, cfg, tokenizer, torch.device("cuda"),
                                                   preset)
    if inspect is not None:
        inspect(model)
    with served_pixels(pixels):
        dataset = train_cli.build_dataset(args, cfg.vlmo.image_size)
        batch = collate(next(train_cli._batches(dataset, args.batch_size, args.seed)))
    biases, kinds, rel_bias = [], [], model._rel_bias

    def recorded(layer, kind):  # each attention's gathered table, kept for its gradient
        biases.append(rel_bias(layer, kind))
        kinds.append((layer, kind))
        return biases[-1]

    model._rel_bias = recorded
    calls, flash_attention = [], attention.flash_attention

    def recording(q, k, v, bias, scale, key_bias=None):  # the flash pass's inputs
        out = flash_attention(q, k, v, bias, scale, key_bias)
        call = {"args": [t.detach() for t in (q, k, v, bias)] + [scale, key_bias]}
        calls.append(call)
        out.register_hook(lambda g: call.__setitem__("do", g.detach()))
        return out

    table = model.relative_position_bias_table
    grads, layer_grads, h = {}, None, cfg.vlmo.num_heads
    key = ReplayKey(TorchKey(SEED, torch.device("cuda")))
    expected = cfg.vlmo.depth if expected_dbias is None else expected_dbias
    for impl in ("flash", "xla"):
        biases.clear()
        kinds.clear()
        before = attention.flash_attention_bwd.dbias_launches
        if per_call and impl == "flash":
            attention.flash_attention = recording
        try:
            with attention.attention_impl(impl):
                loss, _ = loss_fn(model, batch, key)
                grads[impl], *layer_grads = torch.autograd.grad(loss, [table] + biases)
        finally:
            attention.flash_attention = flash_attention
        key.replay()
        require((attention.flash_attention_bwd.dbias_launches - before)
                == (expected if impl == "flash" else 0), f"dbias launches under {impl}")
    mass = _gathered(model, kinds, [g.abs() for g in layer_grads], h)  # xla's, the last
    diff = (grads["flash"] - grads["xla"]).abs()
    largest, err = float(grads["xla"].abs().max()), float(diff.max())
    of_tol = _mass_ratio(grads["flash"].double(), grads["xla"].double(), mass)
    out = {"err": err, "max": largest, "err_of_tol": of_tol}
    if per_call:
        require(largest > 0 and err <= TABLE_GRAD_OF_LARGEST_TOL * largest,
                f"the table gradient, flash against xla: max abs err {err}, largest {largest}")
        kernel, plain, exact, exact_mass = [], [], [], []
        for call in calls:
            q, k, v, bias, scale, kb = call["args"]
            do = call["do"]
            o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, kb)
            kernel.append(attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, kb,
                                                        dbias=True)[3])
            leaf = bias.clone().requires_grad_(True)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            s = torch.matmul(qt * scale, kt.transpose(-1, -2)) + leaf + kb[:, None, None, :]
            plain.append(torch.autograd.grad(torch.matmul(torch.softmax(s, -1), vt), [leaf],
                                             do.transpose(1, 2))[0])
            qd, kd, vd, dod = (t.double().transpose(1, 2) for t in (q, k, v, do))
            p = torch.softmax(torch.matmul(qd * scale, kd.transpose(-1, -2)) + bias.double()
                              + kb.double()[:, None, None, :], -1)
            dp = torch.matmul(dod, vd.transpose(-1, -2))
            ds = p * (dp - (p * dp).sum(-1, keepdim=True))
            exact.append(ds.sum(0, keepdim=True))
            exact_mass.append(ds.abs().sum(0, keepdim=True))
            del s, qd, kd, vd, dod, p, dp, ds
        require(len(calls) == len(kinds) == expected, f"{len(calls)} recorded attentions")
        truth = _gathered(model, kinds, exact, h)
        truth_mass = _gathered(model, kinds, exact_mass, h)
        per = _mass_ratio(_gathered(model, kinds, kernel, h), truth, truth_mass)
        per_plain = _mass_ratio(_gathered(model, kinds, plain, h), truth, truth_mass)
        require(per <= 1.0, f"the table gradient attention by attention, K3's dbias against "
                            f"float64: {per} of an entry's tolerance")
        out.update(per_call_err_of_tol=per, per_call_plain_err_of_tol=per_plain)
        print(f"  {args.task} table gradient {list(table.shape)}, flash (K3 with dbias, "
              f"{expected} launches) against xla: max abs err {err:.3g} of {largest:.3g} "
              f"({err / largest:.2g}; tolerance {TABLE_GRAD_OF_LARGEST_TOL:g}), {of_tol:.3g} of "
              f"an entry's {TABLE_GRAD_TOL:g} of its mass; attention by attention on the flash "
              f"pass's inputs, against float64: K3's dbias {per:.2g} of an entry's tolerance, "
              f"the float32 product + softmax path {per_plain:.2g}", flush=True)
        del calls, kernel, plain, exact, exact_mass
    else:
        require(largest > 0 and of_tol <= 1.0,
                f"the table gradient, flash against xla: max abs err {err}, largest {largest}, "
                f"{of_tol} of an entry's tolerance")
        print(f"  {args.task} table gradient {list(table.shape)}, flash (K3 with dbias, "
              f"{expected} launches) against xla: max abs err {err:.3g} of {largest:.3g} "
              f"({err / largest:.2g}); the largest error {of_tol:.2g} of its entry's tolerance "
              f"({TABLE_GRAD_TOL:g} of its mass, or 1e-6 of the largest entry)", flush=True)
    del model, grads, layer_grads, biases
    torch.cuda.empty_cache()
    return out


def train_vlmo(tmp, vocab, tokenizer, smi):
    """``train.cli.main --task vlmo_vqa --preset task_finetune_vqa_base_image480``
    at batch 8 from a synthetic VLMo VQA file (``--init-ckpt``): under flash
    (with ``--ckpt-dir``) and under xla, the table gradient's check, and a
    resume that must restart at the saved step with the saved parameters."""
    from vqattack_tpu_torch.checkpoint import synthetic
    from vqattack_tpu_torch.named_configs import vlmo_config_from_named, vlmo_named_config

    vcfg = vlmo_config_from_named(vlmo_named_config("task_finetune_vqa_base_image480"))
    require(vcfg.image_size == 480 and vcfg.depth == 12 and vcfg.hidden_size == 768
            and vcfg.max_text_len + vcfg.image_seq_len == 941, "not VLMo-base at 480 px")
    init = os.path.join(tmp, "vlmo_vqa_init.pt")
    torch.save({"state_dict": synthetic.vlmo_state_dict(
        vcfg, SEED + 5, heads=synthetic.VLMO_VQA_HEADS + ("nlvr2_classifier",))}, init)
    ann, pixels = write_train_ann(tmp, "vlmo", 2 * TRAIN_BATCH * (TRAIN_STEPS + 1),
                                  vcfg.image_size, 1000)
    ckpt = os.path.join(tmp, "ckpt_vlmo")
    argv = ["--task", "vlmo_vqa", "--preset", "task_finetune_vqa_base_image480",
            "--vocab", vocab, "--ann", ann, "--image-root", tmp, "--batch-size",
            str(TRAIN_BATCH), "--log-every", "1", "--device", "cuda", "--seed", str(SEED),
            "--init-ckpt", init]
    grad = vlmo_table_gradient(argv + ["--steps", str(TRAIN_STEPS)], tokenizer, pixels)
    out = {"table_grad_err": grad["err"], "table_grad_max": grad["max"],
           "table_grad_err_of_tol": grad["err_of_tol"], "card": smi}
    launched = {}
    for impl in ("flash", "xla"):
        # one save, after the last step's metrics: the steps' times hold no save
        extra = ["--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN_STEPS)] if impl == "flash" else []
        with attention.attention_impl(impl), recorded_train_states() as rec:
            summary, launched[impl], seconds, peak = run_train(
                argv + ["--steps", str(TRAIN_STEPS)] + extra, pixels)
        expected = train_implied_launches("vlmo_vqa", vcfg.depth, TRAIN_STEPS, impl == "flash")
        check_launches(launched[impl], expected, {k for k, n in expected.items() if n},
                       f"vlmo_vqa --attn {impl}")
        steps = step_seconds(summary)
        out[impl] = {"s_per_step": float(np.median(steps)), "step_s": steps, "wall_s": seconds,
                     "peak_gib": peak, "losses": summary["losses"]}
        print(f"  vlmo_vqa --attn {impl}: {TRAIN_STEPS} steps in {seconds:.2f} s, "
              f"{out[impl]['s_per_step']:.4f} s a step after the first, peak {peak:.2f} GiB, "
              f"losses {[round(x, 4) for x in summary['losses']]} ({smi})", flush=True)
        if impl == "flash":
            saved = rec["saved"]
    with attention.attention_impl("flash"), recorded_train_states() as rec:
        summary, _, _, _ = run_train(argv + ["--steps", str(TRAIN_STEPS + 1), "--ckpt-dir",
                                             ckpt, "--ckpt-every", str(TRAIN_STEPS)], pixels)
    step, params = rec["restored"]
    require(summary["start_step"] == step == saved[0] == TRAIN_STEPS
            and summary["step"] == TRAIN_STEPS + 1, f"resume: started at {summary['start_step']}"
            f", restored step {step}, saved step {saved[0]}")
    require(params.keys() == saved[1].keys()
            and all(torch.equal(params[n], saved[1][n]) for n in params),
            "resume: the restored parameters are not the saved ones")
    print(f"  vlmo_vqa --ckpt-dir: resumed at step {step} with the {len(params)} saved "
          f"parameters bit for bit, then step {summary['step']}", flush=True)
    shutil.rmtree(ckpt)
    os.remove(init)
    out["resume"] = {"step": step, "tensors": len(params)}
    return out, launched["flash"]


def train_albef(tmp, vocab, gen, smi):
    """``train.cli.main --task albef_vqa`` at full width (the ALBEF attack
    config: ViT-B/16 at 480 px with the fused norm sites, BERT-base, the
    6-layer answer decoder; 4 answer slots of 8 tokens) at batch 8 under
    flash; and K2's backward at the ViT's [8 x 901, 768] with and without
    its parameter sums."""
    from vqattack_tpu_torch import config as cfg_mod

    cfg = cfg_mod.albef_attack_config()
    require(cfg.albef.vit.image_size == 480 and cfg.albef.vit.depth == 12
            and cfg.albef.bert.num_layers == 12 and cfg.albef.decoder_layers == 6,
            "not the full-width ALBEF config")
    ann, pixels = write_train_ann(tmp, "albef", 2 * TRAIN_BATCH * TRAIN_STEPS,
                                  cfg.albef.vit.image_size, 1100)
    argv = ["--task", "albef_vqa", "--vocab", vocab, "--ann", ann, "--image-root", tmp,
            "--batch-size", str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS), "--log-every", "1",
            "--max-answers", "4", "--device", "cuda", "--seed", str(SEED)]
    with attention.attention_impl("flash"):
        summary, launched, seconds, peak = run_train(argv, pixels)
    expected = train_implied_launches("albef_vqa", cfg.albef.vit.depth, TRAIN_STEPS, True)
    check_launches(launched, expected, {k for k, n in expected.items() if n},
                   "albef_vqa --attn flash")
    steps = step_seconds(summary)
    rows = TRAIN_BATCH * 901
    x, delta, gamma, beta, gs, gh = _ln_case(gen, rows, torch.float32)
    s, _ = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)
    with_sums = time_ms(lambda: fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6))
    without = time_ms(lambda: fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6,
                                                             param_grads=False))
    per_step = 2 * cfg.albef.vit.depth
    out = {"s_per_step": float(np.median(steps)), "step_s": steps, "wall_s": seconds,
           "peak_gib": peak, "losses": summary["losses"],
           "k2_bwd_param_grads_ms": with_sums, "k2_bwd_no_param_grads_ms": without,
           "k2_bwd_launches_per_step": per_step, "card": smi}
    print(f"  albef_vqa --attn flash: {TRAIN_STEPS} steps in {seconds:.2f} s, "
          f"{out['s_per_step']:.4f} s a step after the first, peak {peak:.2f} GiB, losses "
          f"{[round(x, 4) for x in summary['losses']]}; K2's backward at [{rows}, {D}] f32 "
          f"{with_sums * 1e3:.1f} us with its parameter sums, {without * 1e3:.1f} us without: "
          f"{per_step} a step, {per_step * (with_sums - without):.4f} ms of sums a step ({smi})",
          flush=True)
    return out, launched


# ---------------------------------------------------------------------------
# the pretraining slice: albef_pretrain, vlmo_pretrain, vlmo_textmlm
# (vqattack_tpu_torch/train/cli.py, train/objectives.py)
# ---------------------------------------------------------------------------

# ALBEF's public configs/Pretrain.yaml trains at 256 px: 257 tokens, two
# full 128-row tiles and one row
ALBEF_PRETRAIN_SIZE = 256
PRETRAIN_PLUS = "task_mlm_itm_itc_base_plus"
TEXTMLM_PLUS = "task_textmlm_base_plus"
# VLMo-base+ has no relative-position table (absolute positions): the
# bias gradient runs on the VLMo-base presets of the two tasks
PRETRAIN_BASE = "task_mlm_itm_itc_base"
TEXTMLM_BASE = "task_textmlm_base"


@contextlib.contextmanager
def recorded_step_metrics():
    """The metrics of every step ``train.cli.main`` takes (the loss's
    terms), read after the run."""
    from vqattack_tpu_torch.train import trainer

    make, rec = trainer.make_train_step, []

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch, key=None):
            state, metrics = step(state, batch, key)
            rec.append(metrics)
            return state, metrics

        return run

    trainer.make_train_step = recording
    try:
        yield rec
    finally:
        trainer.make_train_step = make


@contextlib.contextmanager
def recorded_k3_launches():
    """K3's launches by ``(direction, B, S, head dim, table, key bias,
    dbias)``, as the path hands them to the kernels."""
    from collections import Counter

    seen, fwd, bwd = Counter(), attention._launch_fwd, attention._launch_bwd

    def rec_fwd(q, k, v, bias, scale, key_bias, dims, head_dim):
        seen["fwd", q.shape[0], q.shape[1], head_dim, bias is not None, key_bias is not None,
             False] += 1
        return fwd(q, k, v, bias, scale, key_bias, dims, head_dim)

    def rec_bwd(q, k, v, bias, scale, o, lse, do, key_bias, dims, head_dim, dbias=False):
        seen["bwd", q.shape[0], q.shape[1], head_dim, bias is not None, key_bias is not None,
             dbias] += 1
        return bwd(q, k, v, bias, scale, o, lse, do, key_bias, dims, head_dim, dbias)

    attention._launch_fwd, attention._launch_bwd = rec_fwd, rec_bwd
    try:
        yield seen
    finally:
        attention._launch_fwd, attention._launch_bwd = fwd, bwd


def pretrain_attentions(task, vc, weights, b):
    """The attentions of one VLMo pretraining step that take K3 (at least
    128 queries): ``{(B, S, head dim, table, key bias): calls}``.
    ``vlmo_textmlm``: the text tower.  ``vlmo_pretrain``: the image tower
    and the text tower with their VL-expert branches (ITC, ITM's
    similarities), the joint trunk on 3B pairs (ITM) and on B (MLM), each
    where its weight is not 0."""
    dh, table = vc.hidden_size // vc.num_heads, vc.need_relative_position_embed
    text, image, joint = vc.max_text_len, vc.image_seq_len, vc.max_text_len + vc.image_seq_len
    calls = []
    if task == "vlmo_textmlm":
        calls.append((b, text, True, vc.depth))
    else:
        w = {"mlm": 1.0, "itc": 1.0, "itm": 1.0, **(weights or {})}
        if w["itc"] > 0 or w["itm"] > 0:
            towers = vc.depth + vc.depth - vc.vlffn_start_layer
            calls += [(b, text, True, towers), (b, image, False, towers)]
        if w["itm"] > 0:
            calls.append((3 * b, joint, True, vc.depth))
        if w["mlm"] > 0:
            calls.append((b, joint, True, vc.depth))
    out = {}
    for batch, seq, key_bias, n in calls:
        if seq >= 128:
            k = (batch, seq, dh, table, key_bias)
            out[k] = out.get(k, 0) + n
    return out


def pretrain_implied_launches(attentions, steps, flash):
    """The counts :func:`pretrain_attentions`' calls imply over ``steps``
    steps: a forward and a backward each, every backward with dbias where
    the attention takes the table (its gradient is asked for)."""
    out = dict.fromkeys(KERNELS, 0)
    if not flash:
        return out
    for (_, _, dh, table, key_bias), n in attentions.items():
        for d in ("fwd", "bwd"):
            out[f"flash_attention_{d}"] += n * steps
            if key_bias:
                out[f"flash_attention_{d}_key_bias"] += n * steps
            if dh == 34:
                out[f"flash_attention_{d}_hd34"] += n * steps
        if table:
            out["flash_attention_bwd_dbias"] += n * steps
    return out


def _check_shapes(seen, attentions, steps, what):
    """The recorded launches by shape against :func:`pretrain_attentions`'."""
    want = {}
    for (b, s, dh, table, kb), n in attentions.items():
        want["fwd", b, s, dh, table, kb, False] = n * steps
        want["bwd", b, s, dh, table, kb, table] = n * steps
    require(dict(seen) == want, f"{what}: K3 launches by shape {dict(seen)}, the schedule "
                                f"implies {want}")


def _pretrain_key_bias(tokenizer, b, text_len, seq):
    """The ``[b, seq]`` key bias of ``b`` real captions padded to
    ``text_len`` tokens inside a sequence of ``seq``."""
    questions = [q for _, q, _, _ in VLMO_BATCH_SAMPLES]
    _, mask = tokenizer.encode_batch([questions[i % len(questions)] for i in range(b)], text_len)
    co = torch.cat([torch.as_tensor(mask, device="cuda"),
                    torch.ones(b, seq - text_len, dtype=torch.int32, device="cuda")], 1)
    return mask_to_key_bias(co)


def check_pretrain_kernels(gen, tokenizer):
    """K2 and K3 against their plain versions at the shapes the pretraining
    path gives them, and timed there: ALBEF at 256 px (K3 without terms at
    [8, 257, 12, 64], K2 at [8 x 257, 768] with parameter sums); VLMo-base+
    (head dim 34: the image tower [8, 197] without terms, ITM's joint
    [24, 237] and MLM's [8, 237] and the text tower [8, 196] with the
    padded-text key bias); K3's dbias at head dim 34 on synthetic tables
    (base+ has none: the table alone at [8, 197], table and key bias at
    [24, 237] and [8, 196]) and at VLMo-base's pretraining shapes (joint
    [8, 237] and text [8, 196], head dim 64, table and key bias), and at
    257 tokens.  Returns ``(kernel rows, dbias rows at head dim 34)``."""
    b = TRAIN_BATCH
    rows257 = time_flash_attention(gen, _check_attention_case(gen, b, 257, "none"), b, 257,
                                   "_albef257")
    q, k, v = _qkv(gen, 2, 257)
    _check_dbias_case(q, k, v, torch.randn(1, HEADS, 257, 257, generator=gen, device="cuda"),
                      None, "257 tokens")
    rows = 8 * 257
    x, delta, gamma, beta, gs, gh = _ln_case(gen, rows, torch.float32)
    s_, h_ = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)
    s_r, h_r = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
    torch.cuda.synchronize()
    require(torch.equal(s_, s_r), f"residual sum differs at rows={rows}")
    h_err = _close(f"h rows={rows}", h_, h_r, torch.float32)
    dx_err = max(_check_bwd(s_, gs, gh, gamma, pg, f"rows={rows}") for pg in (True, False))
    print(f"  residual_layernorm rows={rows} float32 (ALBEF's ViT at 256 px, batch 8): s "
          f"bit-exact, h err {h_err:.3g}, dx err {dx_err:.3g}, dgamma/dbeta within bounds",
          flush=True)

    plus_rows, hd34_dbias = [], []
    for bb, seq, text_len, what in ((b, 197, None, "image tower, no terms"),
                                    (3 * b, 237, 40, "ITM's joint trunk"),
                                    (b, 237, 40, "MLM's joint trunk"),
                                    (b, 196, 196, "the text tower")):
        kb = None if text_len is None else _pretrain_key_bias(tokenizer, bb, text_len, seq)
        q, k, v = _plus_qkv(gen, bb, seq)
        errs = _check_two_term_case(q, k, v, None, kb, what, PLUS_SCALE)
        if (bb, seq) == (3 * b, 237):
            plus_rows = time_flash_attention_hd34(q, k, v, kb, errs, "_itm237")
        table = torch.randn(1, PLUS_HEADS, seq, seq, generator=gen, device="cuda") * 0.5
        errs = _check_dbias_case(q, k, v, table, kb, f"head dim 34, {what}", PLUS_SCALE)
        hd34_dbias.append(time_dbias(q, k, v, table, kb, PLUS_SCALE, errs,
                                     f"flash_attention_bwd_dbias_hd34_{bb}x{seq}", gen))
    base_rows = []
    for seq, text_len, what in ((237, 40, "joint237"), (196, 196, "text196")):
        q, k, v = _qkv(gen, b, seq)
        kb = _pretrain_key_bias(tokenizer, b, text_len, seq)
        table = torch.randn(1, HEADS, seq, seq, generator=gen, device="cuda") * 0.5
        errs = _check_dbias_case(q, k, v, table, kb, f"VLMo-base {what}")
        base_rows.append(time_dbias(q, k, v, table, kb, SCALE, errs,
                                    f"flash_attention_bwd_dbias_{what}", gen))
    return list(rows257) + plus_rows + base_rows, hd34_dbias


def train_pretrain(tmp, vocab, tokenizer, smi):
    """``train.cli.main`` on the three pretraining tasks at full width,
    batch 8, ``TRAIN_STEPS`` steps: ``albef_pretrain --image-size 256`` and
    ``vlmo_pretrain --preset task_mlm_itm_itc_base_plus`` under flash (the
    latter also under xla), ``vlmo_textmlm --preset task_textmlm_base_plus``
    under flash, and the VLMo-base presets of the two VLMo tasks (the table
    and its gradient) under flash; each run's launches against its
    schedule, by shape.  Then the first step's table gradient, flash
    against xla, of the VLMo-base presets.  Returns ``(summary, the K3
    launches by shape of each run)``."""
    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.named_configs import vlmo_config_from_named, vlmo_named_config
    from vqattack_tpu_torch.train.cli import pretrain_loss_weights

    out, seen_all = {"card": smi}, {}
    common = ["--vocab", vocab, "--image-root", tmp, "--batch-size", str(TRAIN_BATCH),
              "--steps", str(TRAIN_STEPS), "--log-every", "1", "--device", "cuda",
              "--seed", str(SEED)]

    def run(name, argv, pixels, impl, expected, positive, attentions=None):
        with attention.attention_impl(impl), recorded_step_metrics() as rec, \
                recorded_k3_launches() as seen:
            summary, launched, seconds, peak = run_train(argv + common, pixels)
        check_launches(launched, expected, positive, f"{name} --attn {impl}")
        if attentions is not None:
            _check_shapes(seen, attentions, TRAIN_STEPS, name)
        steps = step_seconds(summary)
        terms = [{k: float(v) for k, v in m.items() if "loss" in k and v.numel() == 1}
                 for m in rec]
        out[f"{name}_{impl}"] = {"s_per_step": float(np.median(steps)), "step_s": steps,
                                 "wall_s": seconds, "peak_gib": peak,
                                 "losses": summary["losses"],
                                 "grad_norms": summary["grad_norms"], "terms": terms}
        print(f"  {name} --attn {impl}: {TRAIN_STEPS} steps in {seconds:.2f} s, "
              f"{out[f'{name}_{impl}']['s_per_step']:.4f} s a step after the first, peak "
              f"{peak:.2f} GiB, losses {[round(x, 4) for x in summary['losses']]}, first step's "
              f"terms {({k: round(x, 4) for k, x in terms[0].items()})} ({smi})", flush=True)
        seen_all[f"{name}_{impl}"] = dict(seen)
        return launched

    # ALBEF: ViT-B/16 at 256 px, BERT-base fused from layer 6, embed_dim 256
    cfg = cfg_mod.albef_attack_config()
    require(cfg.albef.vit.depth == 12 and cfg.albef.vit.hidden_size == D
            and cfg.albef.bert.num_layers == 12 and cfg.albef.bert.fusion_layer == 6
            and cfg.albef.embed_dim == 256, "not the full-width ALBEF config")
    ann, pixels = write_train_ann(tmp, "albef_pretrain", 2 * TRAIN_BATCH * TRAIN_STEPS,
                                     ALBEF_PRETRAIN_SIZE, 1400)
    expected = train_implied_launches("albef_pretrain", cfg.albef.vit.depth, TRAIN_STEPS, True)
    launched = {"albef_pretrain": run(
        "albef_pretrain", ["--task", "albef_pretrain", "--ann", ann, "--image-size",
                           str(ALBEF_PRETRAIN_SIZE)], pixels, "flash", expected,
        {k for k, n in expected.items() if n})}
    require(seen_all["albef_pretrain_flash"] == {
        ("fwd", 8, 257, 64, False, False, False): 12 * TRAIN_STEPS,
        ("bwd", 8, 257, 64, False, False, False): 12 * TRAIN_STEPS},
        f"albef_pretrain K3 shapes {seen_all['albef_pretrain_flash']}")

    for task, preset, impls in (("vlmo_pretrain", PRETRAIN_PLUS, ("flash", "xla")),
                                ("vlmo_textmlm", TEXTMLM_PLUS, ("flash",)),
                                ("vlmo_pretrain", PRETRAIN_BASE, ("flash",)),
                                ("vlmo_textmlm", TEXTMLM_BASE, ("flash",))):
        named = vlmo_named_config(preset)
        vc = vlmo_config_from_named(named)
        plus = preset.endswith("base_plus")
        require(vc.image_size == 224 and vc.patch_size == 16
                and (vc.depth, vc.hidden_size, vc.num_heads) == ((24, 544, 16) if plus
                                                                 else (12, 768, 12))
                and vc.need_relative_position_embed != plus
                and vc.max_text_len == (196 if task == "vlmo_textmlm" else 40),
                f"not the full-width {preset}")
        weights = pretrain_loss_weights(named) if task == "vlmo_pretrain" else None
        attentions = pretrain_attentions(task, vc, weights, TRAIN_BATCH)
        ann, pixels = write_train_ann(tmp, preset, 2 * TRAIN_BATCH * TRAIN_STEPS,
                                         vc.image_size, 1500)
        argv = ["--task", task, "--preset", preset, "--ann", ann]
        for impl in impls:
            expected = pretrain_implied_launches(attentions, TRAIN_STEPS, impl == "flash")
            launched[f"{preset}_{impl}"] = run(preset, argv, pixels, impl, expected,
                                               {k for k, n in expected.items() if n},
                                               attentions if impl == "flash" else None)
        if not plus:  # the table's gradient, flash against xla
            out[f"{preset}_table_grad"] = vlmo_table_gradient(
                argv + common, tokenizer, pixels,
                pretrain_implied_launches(attentions, 1, True)["flash_attention_bwd_dbias"])
    return out, launched, seen_all


# ---------------------------------------------------------------------------
# the fine-tuning slice: retrieval, ve, nlvr2, vlmo_irtr, vlmo_nlvr2
# (vqattack_tpu_torch/train/cli.py, models/albef_tasks.py)
# ---------------------------------------------------------------------------

# the reference's image_res for ALBEF's Retrieval, VE and NLVR configs: 577
# ViT tokens; VLMo's *_image384 presets: 577 image tokens + 40 text ones
FINETUNE_SIZE = 384
IRTR_PRESET = "task_finetune_irtr_f30k_base_image384"
NLVR2_PRESET = "task_finetune_nlvr2_base_image384"
VE_LABELS = ("entailment", "neutral", "contradiction")
# retrieval's first-step loss and the gradient of the ViT's first query
# weight, flash against xla: K3's card tolerance (2e-5 of the largest
# magnitude, _attn_err) once for each of the ViT's 12 attentions, which
# the loss's forward and the first block's gradient cross
RETRIEVAL_GRAD_TOL = 12 * 2e-5


def write_finetune_ann(tmp, task, n, size, pixel_base):
    """``n`` annotations of ``task``'s dialect over the batched samples'
    questions, the images served by name (``pixels``): captions on images
    that two items share (``retrieval``, ``vlmo_irtr``: same-image items are
    ITA positives), VE sentences with string labels on names without
    ``.jpg``, NLVR pairs labelled "True"/"False"."""
    ann, pixels = [], {}

    def image(j, ext=".jpg"):
        name = f"ft_{task}_{j}{ext}"
        if name not in pixels:
            pixels[name] = sample_pixels(pixel_base + j, size)
        return name

    for i in range(n):
        question = VLMO_BATCH_SAMPLES[i % len(VLMO_BATCH_SAMPLES)][1]
        if task in ("retrieval", "vlmo_irtr"):
            ann.append({"image": image(i // 2), "caption": [question]})
        elif task == "ve":
            ann.append({"image": image(i, ""), "sentence": question, "label": VE_LABELS[i % 3]})
        else:
            ann.append({"images": [image(i), image(i + 1)], "sentence": question,
                        "label": ("True", "False")[i % 2]})
    path = os.path.join(tmp, f"ann_{task}.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path, pixels


def finetune_attentions(task, depth, b, seq):
    """The attentions of one fine-tuning step that take K3 (at least 128
    queries): ``{(B, S, head dim, table, key bias): calls}``.  ALBEF: the
    ViT's blocks, on the pairs' 2B images for nlvr2; vlmo_irtr: the joint
    trunk on B x 3 pairs; vlmo_nlvr2: the joint trunk twice on B."""
    if task in ("retrieval", "ve", "nlvr2"):
        return {((2 if task == "nlvr2" else 1) * b, seq, HEAD_DIM, False, False): depth}
    if task == "vlmo_irtr":
        return {(3 * b, seq, HEAD_DIM, True, True): depth}
    return {(b, seq, HEAD_DIM, True, True): 2 * depth}


def _vlmo_table_617(gen, tokenizer, b):
    """q, k, v at [b, 617, 12, 64], layer 0's [1, 12, 617, 617] bias
    gathered from a VLMo-base table at 384 px (``build_relative_position_index``
    over the 24 x 24 window and 40 text tokens, the table drawn normal(0,
    0.5) as ``init_vlmo_weights`` draws it) and the key bias of ``b`` real
    captions padded to 40 tokens."""
    from vqattack_tpu_torch.models.vlmo import build_relative_position_index

    window, text = FINETUNE_SIZE // 16, 40
    seq = text + window ** 2 + 1
    idx = build_relative_position_index((window, window), text)
    table = torch.randn(idx["all_num_relative_distance"], HEADS, generator=gen,
                        device="cuda") * 0.5  # layer 0's columns
    joint = torch.as_tensor(idx["joint"], dtype=torch.long, device="cuda")
    bias = table[joint].permute(2, 0, 1)[None].contiguous()
    q, k, v = _qkv(gen, b, seq)
    return q, k, v, bias, _pretrain_key_bias(tokenizer, b, text, seq)


def time_k2_training(gen, rows, suffix):
    """K2 at ``[rows, 768]`` as a trained LayerNorm calls it: the forward and
    the backward with its parameter sums against their plain versions,
    then timed beside their bounds and ``layer_norm(x + delta)`` (the
    backward through autograd, to x, gamma and beta).  Rows named
    ``residual_layernorm_{fwd,bwd_param_grads}`` with ``suffix``."""
    x, delta, gamma, beta, gs, gh = _ln_case(gen, rows, torch.float32)
    s_, h_ = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)
    s_r, h_r = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
    torch.cuda.synchronize()
    require(torch.equal(s_, s_r), f"residual sum differs at rows={rows}")
    h_err = _close(f"h rows={rows}", h_, h_r, torch.float32)
    dx_err = _check_bwd(s_, gs, gh, gamma, True, f"rows={rows}")
    fwd = _time_fwd(x, delta, gamma, beta, rows, h_err)
    fwd["name"] += suffix
    n = rows * D
    # read s, gs, gh and gamma; write dx, dgamma and dbeta
    bnd, by = bound_ms(4 * n * 4 + 3 * D * 4, 16 * n)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta)]
    s_l = leaves[0] + delta
    h_l = torch.nn.functional.layer_norm(s_l, (D,), leaves[1], leaves[2], 1e-6)
    bwd = {
        "name": "residual_layernorm_bwd_param_grads" + suffix, "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/fused_ln.cu",
        "replaces": "vqattack_tpu/ops/fused_ln.py:159", "shape": [rows, D],
        "max_abs_err": dx_err,
        "ms": time_ms(lambda: fused_ln.residual_layernorm_bwd(s_, gs, gh, gamma, 1e-6)),
        "plain_ms": time_ms(lambda: fused_ln.residual_layernorm_bwd_reference(
            s_, gs, gh, gamma, 1e-6)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            (s_l, h_l), leaves, (gs, gh), retain_graph=True), sleep_cycles=20_000_000),
    }
    print(f"  {bwd['name']} [{rows}, {D}] f32: {bwd['ms'] * 1e3:.1f} us (plain "
          f"{bwd['plain_ms'] * 1e3:.1f} us, autograd of layer_norm(x + delta) to x, gamma and "
          f"beta {bwd['library_ms'] * 1e3:.1f} us, bound {bnd * 1e3:.2f} us)", flush=True)
    return [fwd, bwd]


def check_finetune_kernels(gen, tokenizer):
    """K2, K3 and K3's dbias against their plain versions at the shapes the
    fine-tuning path gives them, and timed there: ALBEF's ViT at 384 px, K3
    without terms at [8, 577, 12, 64] (retrieval, ve: the ``_albef577``
    rows) and [16, 577, 12, 64] (nlvr2's pairs: ``_nlvr577``), K2 at
    [8 x 577, 768] and [16 x 577, 768] with parameter sums; VLMo-base at
    384 px, dbias with the table and the padded-text key bias at [24, 617]
    (vlmo_irtr's B x 3 pairs: C 8, G 3, the plane pass) and [8, 617]
    (vlmo_nlvr2: ``_irtr617``, ``_nlvr617``)."""
    seq = (FINETUNE_SIZE // 16) ** 2 + 1
    rows = []
    for b, suffix in ((TRAIN_BATCH, "_albef577"), (2 * TRAIN_BATCH, "_nlvr577")):
        rows += time_flash_attention(gen, _check_attention_case(gen, b, seq, "none"), b, seq,
                                     suffix)
    for b, suffix in ((TRAIN_BATCH, "_albef577"), (2 * TRAIN_BATCH, "_nlvr577")):
        rows += time_k2_training(gen, b * seq, suffix)
    for b, suffix in ((3 * TRAIN_BATCH, "_irtr617"), (TRAIN_BATCH, "_nlvr617")):
        q, k, v, table, kb = _vlmo_table_617(gen, tokenizer, b)
        errs = _check_dbias_case(q, k, v, table, kb, f"VLMo-base at 384 px, batch {b}")
        rows.append(time_dbias(q, k, v, table, kb, SCALE, errs,
                               f"flash_attention_bwd_dbias{suffix}", gen))
    return rows


def retrieval_first_step(argv, tokenizer, pixels):
    """``retrieval``'s first-step loss (the CLI's model from ``--seed``, its
    first batch) and the gradient of the ViT's first query weight, under
    flash (K3 at the ViT's 12 attentions) and under xla, the same hard
    negatives (:class:`ReplayKey`); K2 runs in both.  Both within
    :data:`RETRIEVAL_GRAD_TOL` of the largest magnitude (the loss's: at
    least 1)."""
    from vqattack_tpu_torch.train import cli as train_cli

    parser = train_cli.build_argparser()
    args = parser.parse_args(argv)
    cfg = train_cli.resolve_config(args, None, torch.device("cuda"))
    model, loss_fn, collate = train_cli.build_task(args, cfg, tokenizer, torch.device("cuda"))
    with served_pixels(pixels):
        dataset = train_cli.build_dataset(args, cfg.albef.vit.image_size)
        batch = collate(next(train_cli._batches(dataset, args.batch_size, args.seed)))
    weight = model.visual_encoder.blocks[0].attn.query.weight
    key = ReplayKey(TorchKey(SEED, torch.device("cuda")))
    out = {}
    for impl in ("flash", "xla"):
        before = attention.flash_attention_bwd.launches
        with attention.attention_impl(impl):
            loss, _ = loss_fn(model, batch, key)
            (grad,) = torch.autograd.grad(loss, [weight])
        key.replay()
        require(attention.flash_attention_bwd.launches - before
                == (cfg.albef.vit.depth if impl == "flash" else 0), f"retrieval K3 under {impl}")
        out[impl] = (loss.item(), grad)
    (lf, gf), (lx, gx) = out["flash"], out["xla"]
    loss_err, grad_err, scale = abs(lf - lx), float((gf - gx).abs().max()), float(gx.abs().max())
    require(math.isfinite(lf) and scale > 0
            and loss_err <= RETRIEVAL_GRAD_TOL * max(1.0, abs(lx))
            and grad_err <= RETRIEVAL_GRAD_TOL * scale,
            f"retrieval's first step, flash against xla: loss {lf} against {lx}, the query "
            f"gradient's max abs err {grad_err} of {scale}")
    print(f"  retrieval first step, flash against xla (the same negatives): loss {lf:.6f} "
          f"against {lx:.6f} (err {loss_err:.3g}); the ViT's first query gradient "
          f"{list(gx.shape)}: max abs err {grad_err:.3g} of {scale:.3g} ({grad_err / scale:.2g}; "
          f"tolerance {RETRIEVAL_GRAD_TOL:g})", flush=True)
    del model, out, gf, gx
    torch.cuda.empty_cache()
    return {"loss_flash": lf, "loss_xla": lx, "loss_err": loss_err, "grad_err": grad_err,
            "grad_max": scale}


def train_finetune(tmp, vocab, tokenizer, smi):
    """``train.cli.main`` on the five fine-tuning tasks at full width, batch
    8, ``TRAIN_STEPS`` steps, under flash: ``retrieval``, ``ve`` and
    ``nlvr2`` on ALBEF (ViT-B/16 at ``--image-size 384``, BERT-base fused
    from layer 6, NLVR's 18 layers), ``vlmo_irtr --preset
    task_finetune_irtr_f30k_base_image384`` and ``vlmo_nlvr2 --preset
    task_finetune_nlvr2_base_image384`` (VLMo-base, the relative table),
    the latter from a full-width synthetic 2-row VLMo-base file
    (``--init-ckpt``: its table widened to 3 rows, row 2 a copy of row 1);
    each run's launches against its schedule, by shape.  Also retrieval's
    first step flash against xla and the two VLMo tasks' table gradient,
    flash against xla.  Returns ``(summary, launches, K3 launches by
    shape)`` of each run."""
    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.checkpoint import synthetic
    from vqattack_tpu_torch.named_configs import vlmo_config_from_named, vlmo_named_config

    out, launched, seen_all = {"card": smi}, {}, {}
    common = ["--vocab", vocab, "--image-root", tmp, "--batch-size", str(TRAIN_BATCH),
              "--steps", str(TRAIN_STEPS), "--log-every", "1", "--device", "cuda",
              "--seed", str(SEED)]
    n_items = 2 * TRAIN_BATCH * TRAIN_STEPS

    def run(task, argv, pixels, depth, seq):
        attentions = finetune_attentions(task, depth, TRAIN_BATCH, seq)
        expected = train_implied_launches(task, depth, TRAIN_STEPS, True)
        with attention.attention_impl("flash"), recorded_step_metrics() as rec, \
                recorded_k3_launches() as seen:
            summary, launched[task], seconds, peak = run_train(argv + common, pixels)
        check_launches(launched[task], expected, {k for k, n in expected.items() if n},
                       f"{task} --attn flash")
        _check_shapes(seen, attentions, TRAIN_STEPS, task)
        seen_all[task] = dict(seen)
        steps = step_seconds(summary)
        terms = [{k: float(v) for k, v in m.items() if v.numel() == 1} for m in rec]
        out[task] = {"s_per_step": float(np.median(steps)), "step_s": steps, "wall_s": seconds,
                     "peak_gib": peak, "losses": summary["losses"],
                     "grad_norms": summary["grad_norms"], "first_step": terms[0]}
        print(f"  {task} --attn flash: {TRAIN_STEPS} steps in {seconds:.2f} s, "
              f"{out[task]['s_per_step']:.4f} s a step (median of steps 2-{TRAIN_STEPS}), peak "
              f"{peak:.2f} GiB, losses {[round(x, 4) for x in summary['losses']]}, grad norms "
              f"{[round(x, 3) for x in summary['grad_norms']]}, first step "
              f"{({k: round(x, 4) for k, x in terms[0].items()})} ({smi})", flush=True)

    # ALBEF: ViT-B/16 at 384 px (577 tokens), BERT-base fused from layer 6
    cfg = cfg_mod.albef_attack_config()
    require(cfg.albef.vit.depth == 12 and cfg.albef.vit.hidden_size == D
            and cfg.albef.vit.patch_size == 16 and cfg.albef.bert.num_layers == 12
            and cfg.albef.bert.fusion_layer == 6 and cfg.albef.embed_dim == 256,
            "not the full-width ALBEF config")
    seq = (FINETUNE_SIZE // 16) ** 2 + 1
    for task in ("retrieval", "ve", "nlvr2"):
        ann, pixels = write_finetune_ann(tmp, task, n_items, FINETUNE_SIZE, 1600)
        argv = ["--task", task, "--ann", ann, "--image-size", str(FINETUNE_SIZE)]
        if task == "retrieval":
            out["retrieval_first_step"] = retrieval_first_step(argv + common, tokenizer, pixels)
        run(task, argv, pixels, cfg.albef.vit.depth, seq)
        del pixels

    for task, preset in (("vlmo_irtr", IRTR_PRESET), ("vlmo_nlvr2", NLVR2_PRESET)):
        vc = vlmo_config_from_named(vlmo_named_config(preset))
        require(vc.image_size == FINETUNE_SIZE and vc.patch_size == 16 and vc.depth == 12
                and vc.hidden_size == D and vc.num_heads == HEADS
                and vc.need_relative_position_embed and vc.max_text_len == 40
                and vc.type_vocab_size == 2, f"not the full-width VLMo-base {preset}")
        seq = vc.max_text_len + vc.image_seq_len
        ann, pixels = write_finetune_ann(tmp, task, n_items, vc.image_size, 1700)
        argv = ["--task", task, "--preset", preset, "--ann", ann]
        inspect = None
        if task == "vlmo_nlvr2":
            # a pre-trained VLMo-base file of 2 token types (the checkpoint
            # phase's writer), grafted by the CLI into the 3-row NLVR2 model
            sd = synthetic.vlmo_state_dict(vc, SEED + 7)
            rows2 = sd["token_type_embeddings.weight"].float()
            init = os.path.join(tmp, "vlmo_nlvr2_init.pt")
            torch.save({"state_dict": sd}, init)
            del sd
            argv += ["--init-ckpt", init]

            def inspect(model):
                w = model.token_type_embeddings.weight.detach().cpu()
                require(w.shape[0] == 3 and torch.equal(w[:2], rows2) and torch.equal(w[2], w[1]),
                        "vlmo_nlvr2 --init-ckpt: the 3-row table is not the file's 2 rows with "
                        "row 1 copied into row 2")
                print(f"  vlmo_nlvr2 --init-ckpt from a 2-row VLMo-base file: the modality "
                      f"table {list(w.shape)}, rows 0-1 the file's, row 2 a copy of row 1",
                      flush=True)
                out["nlvr2_table_widened"] = True

        run(task, argv, pixels, vc.depth, seq)
        # vlmo_irtr: the end-to-end gradient to the largest entry, and the
        # kernel attention by attention (TABLE_GRAD_OF_LARGEST_TOL)
        out[f"{task}_table_grad"] = vlmo_table_gradient(
            argv + common, tokenizer, pixels, (2 if task == "vlmo_nlvr2" else 1) * vc.depth,
            inspect, per_call=task == "vlmo_irtr")
        if task == "vlmo_nlvr2":
            require(out.get("nlvr2_table_widened"), "vlmo_nlvr2's table was not inspected")
            os.remove(init)
        del pixels
    return out, launched, seen_all


# ---------------------------------------------------------------------------
# phase 13: the checkpoint path, run.main with the reference's .pth files
# ---------------------------------------------------------------------------


def _qkv_rows(name: str, prefix: str):
    """``blocks.N.attn.{query,key,value}.*`` -> (the fused ``qkv`` tensor's
    name, which third of its rows); None for any other name."""
    m = re.fullmatch(r"blocks\.(\d+)\.attn\.(query|key|value)\.(weight|bias)", name)
    if m is None:
        return None
    return f"{prefix}blocks.{m[1]}.attn.qkv.{m[3]}", ("query", "key", "value").index(m[2])


def _bert_source(name: str, prefix: str, head: str, ln=("weight", "bias")) -> str:
    """The HF name (encoder under ``prefix``, MLM head under ``head``) of a
    ``FusionBert`` parameter; ``ln`` spells the LayerNorms' two tensors."""
    for pattern, repl in ((r"layer\.(\d+)\.(crossattention|attention)_(self|output)\.(.*)",
                           r"encoder.layer.\1.\2.\3.\4"),
                          (r"layer\.(\d+)\.intermediate_dense\.(.*)", r"encoder.layer.\1.intermediate.dense.\2"),
                          (r"layer\.(\d+)\.output_(dense|LayerNorm)\.(.*)", r"encoder.layer.\1.output.\2.\3")):
        if re.fullmatch(pattern, name):
            name = prefix + re.sub(pattern, repl, name)
            break
    else:
        if name.startswith("embeddings."):
            name = prefix + name
        elif name == "mlm_head.decoder.bias":
            name = f"{head}predictions.bias"
        elif name.startswith("mlm_head."):
            name = head + "predictions." + name[len("mlm_head."):].replace("transform_", "transform.")
    if "LayerNorm." in name:
        name = name.replace("LayerNorm.weight", f"LayerNorm.{ln[0]}").replace(
            "LayerNorm.bias", f"LayerNorm.{ln[1]}")
    return name


def albef_source(kind: str):
    """``name -> (reference name, third of a fused qkv or None)`` for the
    ALBEF surrogate (``"pretrain"``) or victim (``"vqa"``): the names the
    reference's ``model_pretrain.py`` / ``model_vqa.py`` save, written out
    here apart from ``checkpoint/convert.py``."""
    def source(name):
        top, rest = name.split(".", 1) if "." in name else (name, "")
        if top == "visual_encoder":
            qkv = _qkv_rows(rest, "visual_encoder.")
            return qkv or (name, None)
        if top == "text_encoder":
            enc = "text_encoder.bert." if kind == "pretrain" else "text_encoder."
            return _bert_source(rest, enc, "text_encoder.cls."), None
        if top == "text_decoder":
            return _bert_source(rest, "text_decoder.bert.", "text_decoder.cls."), None
        return name, None  # vision_proj, text_proj, itm_head, temp
    return source


def mlm_source(name: str):
    """The original ``bert-base-uncased`` file's names: ``gamma``/``beta``
    LayerNorms and the decoder tied to the word embeddings."""
    if name == "mlm_head.decoder.weight":
        return "bert.embeddings.word_embeddings.weight", None
    return _bert_source(name, "bert.", "cls.", ("gamma", "beta")), None


def vlmo_source(name: str):
    """The names ``vlmo_module.py`` saves: the trunk under ``transformer.``
    with the fused qkv and the separate q/v biases, ``.fc`` heads, the
    classifier's ``Sequential`` indices, the 0-d logit scales."""
    qkv = _qkv_rows(name, "transformer.")
    if qkv is not None and qkv[0].endswith("weight"):
        return qkv
    if qkv is not None:
        return f"transformer.{name.rsplit('.', 2)[0]}.{'q' if qkv[1] == 0 else 'v'}_bias", None
    top = name.split(".")[0]
    if top in ("blocks", "cls_token", "patch_embed", "norm", "pos_embed"):
        return "transformer." + name, None
    if top == "mlm_score":
        if name == "mlm_score.decoder.bias":
            return "mlm_score.bias", None
        return name.replace("transform_", "transform."), None
    if top in ("itm_score", "itc_text_proj", "itc_image_proj", "itc_vl_text_proj",
               "itc_vl_image_proj"):
        return name.replace(f"{top}.", f"{top}.fc."), None
    if top in ("logit_scale", "logit_vl_scale"):
        return top, None
    if top == "vqa_classifier":
        for port, ref in (("fc1", "0"), ("norm", "1"), ("fc2", "3")):
            name = name.replace(f".{port}.", f".{ref}.")
        return name, None
    return name, None  # text_embeddings, token_type_embeddings, pooler, the table


def check_loaded(module, sd, source, resized, absent=()) -> int:
    """Every parameter of ``module`` equals the file's tensor it came from
    (``source(name)``), or for a resized one the port's resize run on the
    CPU (``resized``); only the heads in ``absent`` may have no source.
    Returns the number of tensors checked."""
    n = 0
    for name, p in module.named_parameters():
        key, third = source(name)
        if name in resized:
            key, want = "resize", resized[name]
        elif key in sd:
            want = sd[key]
            if third is not None:
                rows = want.shape[0] // 3
                want = want[third * rows : (third + 1) * rows]
        else:
            require(name.split(".")[0] in absent, f"{name}: the file has no {key}")
            continue
        got = p.detach().cpu()
        require(got.shape == want.shape and torch.equal(got, want),
                f"{name} is not the file's {key}")
        n += 1
    return n


@contextlib.contextmanager
def record_main():
    """What ``run.main`` builds and runs, recorded through the module
    attributes it reads at call time: the pipeline (its victim calls
    counted), the lockstep engine with its results and mixed-loss calls, and
    each checkpoint load's seconds.  ``run.py`` itself is not changed."""
    rec = {"loads": [], "results": [], "mixed": [], "victim_calls": 0}
    build, load = port_run._build_pipeline, port_run._load_checkpoint
    engines = {n: getattr(batched, n) for n in ("BatchedAlbefAttack", "BatchedVlmoAttack")}

    def build_recorded(*a):
        pipe = rec["pipe"] = build(*a)
        evaluate = pipe.evaluate_victim_batch

        def counted(*b, **kw):
            rec["victim_calls"] += 1
            return evaluate(*b, **kw)

        pipe.evaluate_victim_batch = counted
        return pipe

    def load_timed(what, loader, path, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load(what, loader, path, *a, **kw)
        torch.cuda.synchronize()
        size = (os.path.getsize(path) if os.path.isfile(path) else
                sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)))
        rec["loads"].append({"what": what, "file": os.path.basename(path), "bytes": size,
                             "s": round(time.perf_counter() - t0, 3)})
        return out

    def recording(cls):
        class Recording(cls):
            def __init__(self, pipeline):
                super().__init__(pipeline)
                rec["engine"] = self
                mixed = self._mixed_loss
                self._mixed_loss = lambda *a: rec["mixed"].append(1) or mixed(*a)

            def run(self, *a, **kw):
                out = super().run(*a, **kw)
                rec["results"].extend(out)
                return out

        return Recording

    port_run._build_pipeline, port_run._load_checkpoint = build_recorded, load_timed
    for name, cls in engines.items():
        setattr(batched, name, recording(cls))
    try:
        yield rec
    finally:
        port_run._build_pipeline, port_run._load_checkpoint = build, load
        for name, cls in engines.items():
            setattr(batched, name, cls)


def run_main_recorded(argv, sample_list, pixel_base, size, implied, victim_dtype="float32"):
    """``run.main(argv)`` over ``sample_list`` (its images served by name:
    the card's machine has no PIL to decode JPEGs), the launch counts reset
    just before and read just after; returns ``(summary, record, launches,
    expected launches, seconds)``.  The schedules imply the launches as in
    the batched phases: one chunk per bucket in the surrogate's dtype, plus
    the victim's calls in ``victim_dtype``."""
    pixels = {f"{qid}.jpg": sample_pixels(pixel_base + i, size)
              for i, (qid, *_) in enumerate(sample_list)}
    with served_pixels(pixels), record_main() as rec:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = port_run.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
    results, cfg, engine = rec["results"], rec["pipe"].cfg, rec["engine"]
    require(summary["samples"] == len(sample_list) == len(results), "samples attacked")
    require(engine.last_chunk_sizes == [8, 4], f"chunks {engine.last_chunk_sizes}")
    require(sorted({r.old_alg for r in results}) == [0, 1], "both PGD paths must run")
    for r, (qid, *_) in zip(results, sample_list):
        require(r.qid == str(qid), "results not in qid order")
        check_result(r, pixels[f"{qid}.jpg"], cfg.attack, size)
    expected = implied(cfg, rec["victim_calls"], 0, 0, True, victim_dtype)
    for old_alg, extra in ((0, len(rec["mixed"])), (1, 0)):
        res = next(r for r in results if r.old_alg == old_alg)
        add_launches(expected, implied(cfg, *schedule_passes(res, extra), True,
                                       cfg.compute_dtype))
    return summary, rec, launched, expected, seconds


def run_main_bf16(base, flags, sample_list, pixel_base, size, implied, victim_dtype, name,
                  tmp):
    """``run.main`` as a user runs the bf16 sweep (``base`` + ``flags``) over
    ``sample_list``, its annotations written to ``tmp``: the results inside
    the ball, the launch counts against the schedules (the surrogate's bf16
    instances, the victim's in ``victim_dtype``).  Returns ``(launches,
    expected launches, seconds)``."""
    ann = os.path.join(tmp, f"ann_{name}_bf16.json")
    write_ann(ann, sample_list)
    argv = base + flags + ["--image-root", tmp, "--ann", ann,
                           "--output", os.path.join(tmp, f"out_{name}_bf16")]
    summary, rec, launched, expected, seconds = run_main_recorded(
        argv, sample_list, pixel_base, size, implied, victim_dtype)
    require(rec["pipe"].cfg.compute_dtype == "bfloat16", "run.main did not take --dtype")
    print(f"  {name} bf16 through run.main: {summary['samples']} samples in {seconds:.2f} s",
          flush=True)
    del rec
    torch.cuda.empty_cache()
    return launched, expected, seconds


def write_ann(path: str, sample_list) -> None:
    with open(path, "w") as f:
        json.dump([{"image": f"{qid}.jpg", "question": q, "question_id": qid,
                    "answer": [a] * 10} for qid, q, a, _ in sample_list], f)


def checkpoint_path(common, v_common, tmp):
    """Full-width synthetic checkpoints in the reference's names, from seed
    0 (``checkpoint/synthetic.py``), written to ``tmp``; ``run.main`` with
    them for each surrogate at ``--batch-size 8 --attn flash
    --pipeline-depth 2``; every loaded parameter against the tensor it came
    from; the launch counts against the schedules.  Returns ``(launches,
    load records, seconds)`` of the two runs."""
    from vqattack_tpu_torch.checkpoint import synthetic
    from vqattack_tpu_torch.checkpoint.convert import resize_vlmo_rel_pos_table
    from vqattack_tpu_torch.checkpoint.interpolate import interpolate_pos_embed

    ckpt = os.path.join(tmp, "checkpoints")
    os.makedirs(ckpt)
    print(f"  {shutil.disk_usage(tmp).free / 2 ** 30:.1f} GiB free where the files go", flush=True)
    flags = ["--batch-size", str(BATCH_SIZE), "--attn", "flash",
             "--pipeline-depth", str(PIPELINE_DEPTH), "--image-root", tmp]
    cfg = port_run.resolve_config(port_run.build_argparser().parse_args(common))
    t0 = time.perf_counter()
    sur = synthetic.albef_pretrain_state_dict(cfg.albef, SEED, src_image_size=224)
    vqa = synthetic.albef_vqa_state_dict(cfg.albef, SEED + 1, src_image_size=384)
    mlm = synthetic.hf_bert_mlm_state_dict(cfg.albef.bert, SEED + 2)
    torch.save({"model": sur, "config": {"image_res": 224}, "epoch": 30},
               os.path.join(ckpt, "ALBEF.pth"))
    torch.save({"model": vqa, "config": {"image_res": 384}}, os.path.join(ckpt, "vqa.pth"))
    synthetic.save_hf_bert_dir(os.path.join(ckpt, "bert-base-uncased"), cfg.albef.bert, mlm)
    write_ann(os.path.join(tmp, "ann_albef.json"), BATCH_SAMPLES)
    print(f"  wrote the ALBEF checkpoints in {time.perf_counter() - t0:.2f} s", flush=True)
    require(tuple(sur["visual_encoder.pos_embed"].shape)[:2] == (1, 197), "a 224 px pos_embed")

    argv = common + flags + [
        "--ann", os.path.join(tmp, "ann_albef.json"), "--output", os.path.join(tmp, "out_ckpt"),
        "--surrogate-ckpt", os.path.join(ckpt, "ALBEF.pth"),
        "--victim-ckpt", os.path.join(ckpt, "vqa.pth"),
        "--bert-mlm", os.path.join(ckpt, "bert-base-uncased"), "--calibrate-gate"]
    summary, rec, a_launched, a_expected, a_s = run_main_recorded(
        argv, BATCH_SAMPLES, 500, cfg.albef.vit.image_size, implied_launches)
    require("attack_accuracy_note" not in summary, "a note on a run with --victim-ckpt")
    pipe = rec["pipe"]
    n = check_loaded(pipe.surrogate, sur, albef_source("pretrain"), {
        "visual_encoder.pos_embed": torch.from_numpy(interpolate_pos_embed(
            sur["visual_encoder.pos_embed"].numpy(), cfg.albef.vit.num_patches))})
    n += check_loaded(pipe.victim, vqa, albef_source("vqa"), {
        "visual_encoder.pos_embed": torch.from_numpy(interpolate_pos_embed(
            vqa["visual_encoder.pos_embed"].numpy(), cfg.albef.vit.num_patches))})
    n += check_loaded(pipe.mlm_model, mlm, mlm_source, {})
    a_loads = rec["loads"]
    print(f"  ALBEF: {n} loaded tensors equal their sources; {summary['samples']} samples in "
          f"{a_s:.2f} s of run.main, loads {a_loads}", flush=True)
    del pipe, rec, sur, vqa
    torch.cuda.empty_cache()
    for f in ("ALBEF.pth", "vqa.pth"):
        os.remove(os.path.join(ckpt, f))

    v_cfg = port_run.resolve_config(port_run.build_argparser().parse_args(v_common))
    t0 = time.perf_counter()
    v_sur = synthetic.vlmo_state_dict(v_cfg.vlmo, SEED + 3, src_image_size=224)
    v_vic = synthetic.vlmo_state_dict(v_cfg.vlmo, SEED + 4,
                                      heads=synthetic.VLMO_VQA_HEADS + ("nlvr2_classifier",))
    torch.save({"module": {f"module.{k}": v for k, v in v_sur.items()}},
               os.path.join(ckpt, "vlmo_base_patch16_224.pt"))
    torch.save({"state_dict": v_vic}, os.path.join(ckpt, "vlmo_base_patch16_480_vqa.pt"))
    write_ann(os.path.join(tmp, "ann_vlmo.json"), VLMO_BATCH_SAMPLES)
    print(f"  wrote the VLMo checkpoints in {time.perf_counter() - t0:.2f} s", flush=True)
    argv = v_common + flags + [
        "--ann", os.path.join(tmp, "ann_vlmo.json"), "--output", os.path.join(tmp, "out_vckpt"),
        "--surrogate-ckpt", os.path.join(ckpt, "vlmo_base_patch16_224.pt"),
        "--victim-ckpt", os.path.join(ckpt, "vlmo_base_patch16_480_vqa.pt"),
        "--bert-mlm", os.path.join(ckpt, "bert-base-uncased")]
    summary, rec, v_launched, v_expected, v_s = run_main_recorded(
        argv, VLMO_BATCH_SAMPLES, 600, v_cfg.vlmo.image_size, vlmo_implied_launches)
    require("attack_accuracy_note" not in summary, "a note on a run with --victim-ckpt")
    pipe = rec["pipe"]
    require(pipe.victim is not pipe.model, "the VLMo victim is not a module of its own")
    table = "relative_position_bias_table"
    n = check_loaded(pipe.model, v_sur, vlmo_source, {table: torch.from_numpy(
        resize_vlmo_rel_pos_table(v_sur[table].numpy(), 224 // 16, v_cfg.vlmo.image_size // 16))},
        absent=("vqa_classifier",))
    n += check_loaded(pipe.victim, v_vic, vlmo_source, {}, absent=(
        "mlm_score", "itm_score", "itc_text_proj", "itc_image_proj", "itc_vl_text_proj",
        "itc_vl_image_proj", "logit_scale", "logit_vl_scale"))
    n += check_loaded(pipe.mlm_model, mlm, mlm_source, {})
    v_loads = rec["loads"]
    print(f"  VLMo: {n} loaded tensors equal their sources; {summary['samples']} samples in "
          f"{v_s:.2f} s of run.main, loads {v_loads}", flush=True)
    del pipe, rec
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)
    launches = {"albef": (a_launched, a_expected), "vlmo": (v_launched, v_expected)}
    return launches, a_loads + v_loads, {"albef_s": a_s, "vlmo_s": v_s}


# ---------------------------------------------------------------------------
# ViLT-B/32 (config.vilt_base_config: one shared FFN a block, 145 image
# tokens at 384 px + 40 text tokens) and the black-box transfer evaluation
# (transfer_eval.py, predict.py) against four victims
# ---------------------------------------------------------------------------

# the batched ViLT attack at batch 16: the 8 MAR questions twice (one
# (old_alg, k) bucket of 16) and the 3 feature-only ones (a bucket of 3,
# padded to 4); VLMo's raw '?' kept
VILT_BATCH = 16
VILT_BATCH_SAMPLES = ([(q + 12000, question + "?", a, p) for q, question, a, p in BATCH_SAMPLES[:8]]
                      + [(q + 14000, question + "?", a, p) for q, question, a, p in BATCH_SAMPLES[:8]]
                      + [(q + 12000, question + "?", a, p) for q, question, a, p in BATCH_SAMPLES[8:]])
VILT_TOKENS = 185


def write_run_config(tmp, name, **parts):
    """A RunConfig json in ``tmp``: the VLMo attack preset with ``parts``
    (``albef=``, ``vlmo=``) replaced; returns its path."""
    from vqattack_tpu_torch import config as cfg_mod

    path = os.path.join(tmp, f"{name}.json")
    cfg_mod.save_config(dataclasses.replace(cfg_mod.vlmo_attack_config(), **parts), path)
    return path


def vilt_config_path(tmp, image_size=384):
    from vqattack_tpu_torch import config as cfg_mod

    vilt = dataclasses.replace(cfg_mod.vilt_base_config(image_size), remat=True)
    return write_run_config(tmp, f"vilt{image_size}", vlmo=vilt)


def time_flash_attention_vilt(q, k, v, key_bias, errs, dtype):
    """Device times at ViLT's [16, 185, 12, 64] with the padded-text key
    bias alone (a ragged second key tile of 57): the kernel of ``dtype``,
    its plain versions and ``scaled_dot_product_attention`` with the key
    bias as a [16, 1, 1, 185] mask (forward; backward through autograd).
    The bound: the larger of q, k, v, o (and dO, dq, dk, dv) with the saved
    m and log l and the key bias, over the card's memory rate, and 4 (10)
    x B*H*S^2*Dh over the tensor cores (float32 in three TF32 passes)."""
    b, s = q.shape[:2]
    q, k, v = (t.to(dtype) for t in (q, k, v))
    o, lse = attention.flash_attention_fwd(q, k, v, None, SCALE, key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda").to(dtype)
    mask = key_bias[:, None, None, :].to(dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                scale=SCALE)
    do_t = do.transpose(1, 2)
    unit = b * HEADS * s * s * HEAD_DIM
    row = b * s * HEADS * HEAD_DIM * q.element_size()
    small = 2 * b * HEADS * s * 4 + key_bias.numel() * 4  # m and log l, the key bias
    if dtype == BF16:
        fwd_b, fwd_by = bound_ms(4 * row + small, 4 * unit, BF16_FLOPS)
        bwd_b, bwd_by = bound_ms(8 * row + small, 10 * unit, BF16_FLOPS)
    else:
        fwd_b, fwd_by = tensor_core_bound_ms(4 * row + small, 4 * unit)
        bwd_b, bwd_by = tensor_core_bound_ms(8 * row + small, 10 * unit)
    tag = "_bf16" if dtype == BF16 else ""
    long_sleep = 20_000_000
    common = {"route": "cuda", "replaces": "vqattack_tpu/ops/attention.py:134",
              "source": f"vqattack_tpu_torch/csrc/flash_attention{tag}.cu",
              "shape": [b, s, HEADS, HEAD_DIM], "dtype": str(dtype).split(".")[-1]}
    fwd = dict(common, **{
        "name": f"flash_attention{tag}_fwd_vilt", "max_abs_err": errs["o"],
        "ms": time_ms(lambda: attention.flash_attention_fwd(q, k, v, None, SCALE, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_reference(
            q, k, v, None, SCALE, key_bias=key_bias), 20, long_sleep),
        "bound_ms": fwd_b, "bound_by": fwd_by,
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=SCALE), 20),
    })
    bwd = dict(common, **{
        "name": f"flash_attention{tag}_bwd_vilt",
        "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
        "ms": time_ms(lambda: attention.flash_attention_bwd(
            q, k, v, None, SCALE, o, lse, do, key_bias), 20),
        "plain_ms": time_ms(lambda: attention.flash_attention_bwd_reference(
            q, k, v, None, SCALE, o, lse, do, key_bias), 20, long_sleep),
        "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True), 20),
    })
    for r in (fwd, bwd):
        r["bound_share"] = r["bound_ms"] / r["ms"]
        require(r["bound_share"] <= 1.0, f"{r['name']}: {r['ms']} ms is under its bound "
                                         f"{r['bound_ms']} ms: the timing or the bound is wrong")
        print(f"  {r['name']} {r['shape']} {r['dtype']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention with the key mask "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
              f"{100 * r['bound_share']:.1f}%)", flush=True)
    del sdpa_out
    return fwd, bwd


def check_flash_attention_vilt(pipe, tokenizer, gen):
    """K3 at the shapes the ViLT path gives it, both dtypes, forward and
    backward against the plain versions: [B, 185, 12, 64] with the padded
    text keys of B real questions as the key bias alone, B = 4 (the bucket
    of 3 padded to 4) and 16 (the batched chunk and the victim's batch);
    then the times at 16."""
    rows, errs = [], {}
    for b in (4, VILT_BATCH):
        q, k, v = _qkv(gen, b, VILT_TOKENS)
        kb = _text_key_bias(pipe, tokenizer, b, VILT_TOKENS)
        errs[torch.float32] = _check_two_term_case(q, k, v, None, kb, f"ViLT, batch {b}")
        errs[BF16] = _check_bf16_attention(*(t.to(BF16) for t in (q, k, v)), None, kb,
                                           f"ViLT key bias, batch {b}")
    for dtype in (torch.float32, BF16):
        rows += time_flash_attention_vilt(q, k, v, kb, errs[dtype], dtype)
    return rows


def run_vilt_batched_path(pipe, cfg, paths, args):
    """VILT_BATCH_SAMPLES through ``BatchedVlmoAttack`` over the ViLT
    surrogate at ``--batch-size 16``, its classifier as the victim."""

    def victim(chunk):
        out = pipe.evaluate_victim_batch([r.adv_image for r in chunk],
                                         [r.adv_text for r in chunk])
        require(len(out) == len(chunk) and all(a == pipe.id2answer[p] for p, a in out),
                "ViLT victim output")
        return [a for _, a in out]

    res = run_batched_path(batched.BatchedVlmoAttack(pipe), cfg, paths, args,
                           VILT_BATCH_SAMPLES, 700, cfg.vlmo.image_size, victim,
                           vlmo_implied_launches, victim_dtype=cfg.compute_dtype,
                           chunks=[VILT_BATCH, 4])
    require(sorted({r.old_alg for r in res[0]}) == [0, 1], "both ViLT PGD paths must run")
    return res


@contextlib.contextmanager
def recorded_predictions():
    """Every (prediction, clean answer) that ``transfer_eval``'s
    ``AttackAccuracy`` sees, in order."""
    from vqattack_tpu_torch.eval import metrics

    seen, update = [], metrics.AttackAccuracy.update

    def recording(self, answer, clean):
        seen.append(answer)
        return update(self, answer, clean)

    metrics.AttackAccuracy.update = recording
    try:
        yield seen
    finally:
        metrics.AttackAccuracy.update = update


@contextlib.contextmanager
def recorded_victim_outputs():
    """What the victims compute, in call order, as float32: VLMo's and
    ViLT's ``vqa_logits`` ([P, 3129]), and for ALBEF-VQA and BLIP-VQA the
    first pass of ``rank_answer``, every listed answer's first-token
    probability ([P, A]; the second pass re-ranks the top ``k`` of it)."""
    from vqattack_tpu_torch.models import albef, vlmo

    seen = []
    rank, logits_of = albef.AlbefVQA.rank_answer, vlmo.VLMo.vqa_logits

    def ranking(self, states, mask, answer_ids, answer_mask, k, pad_token_id=0):
        first = self._decode_logits(answer_ids[:1, :1].expand(states.shape[0], 1), None,
                                    states, mask)
        seen.append(torch.softmax(first[:, 0].float(), -1)[:, answer_ids[:, 1]])
        return rank(self, states, mask, answer_ids, answer_mask, k, pad_token_id)

    def classifying(self, *a, **kw):
        out = logits_of(self, *a, **kw)
        seen.append(out.float())
        return out

    albef.AlbefVQA.rank_answer, vlmo.VLMo.vqa_logits = ranking, classifying
    try:
        yield seen
    finally:
        albef.AlbefVQA.rank_answer, vlmo.VLMo.vqa_logits = rank, logits_of


def _victim_outputs_err(flash, xla, n, what):
    """A victim's outputs under ``--attn flash`` against ``--attn xla`` on
    the same pairs: within 1e-4 of the largest xla value (float32
    reassociation over 12 blocks, as :func:`check_model_flash`), and the
    ``n`` real pairs' rows apart by more than that tolerance, so that a
    kernel error cannot hide behind outputs that do not depend on the
    input.  Returns ``(err, largest, spread)``."""
    require(len(flash) == len(xla) and len(flash) > 0
            and all(a.shape == b.shape for a, b in zip(flash, xla)),
            f"{what}: outputs {[tuple(a.shape) for a in flash]} under flash, "
            f"{[tuple(b.shape) for b in xla]} under xla")
    require(all(bool(torch.isfinite(a).all()) for a in flash), f"{what}: outputs not finite")
    err = max(float((a - b).abs().max()) for a, b in zip(flash, xla))
    largest = max(float(b.abs().max()) for b in xla)
    spread = max(float((b[:n] - b[:1]).abs().max()) for b in xla)
    tol = 1e-4 * largest
    require(err <= tol, f"{what}: flash against xla max abs err {err} > {tol} (1e-4 of {largest})")
    require(spread > tol, f"{what}: the pairs' outputs differ by {spread}, not more than {tol}")
    return err, largest, spread


def k3_key_bias_shapes(seen, table=False):
    """The ``(B, S)`` of every K3 forward in ``seen``
    (:func:`recorded_k3_launches`) that takes a key bias, and a table too
    where ``table``, else none."""
    return {(b, s) for (d, b, s, _, t, kb, _) in seen if d == "fwd" and kb and t == table}


def _transfer_victims(tmp, cfg_albef, cfg_vlmo):
    """The four victims' synthetic full-width files in ``tmp`` (the
    reference's names and envelopes) and their configs: ALBEF-VQA (a 384 px
    file, its grid resized to 480), BLIP-VQA at 480 (``fusion_layer=0``, a
    12-layer decoder; ``k_test`` the ALBEF victim's), VLMo-VQA at 480 and
    ViLT-B/32 (a 384 px file, loaded at 480 through ``convert_vilt``, its
    ``pos_embed`` resized from 145 to 226 positions)."""
    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.checkpoint import synthetic

    blip = cfg_mod.blip_vqa_config(480)
    vilt = cfg_mod.vilt_base_config()
    files = {
        "albef_vqa": ({"model": synthetic.albef_vqa_state_dict(cfg_albef, SEED + 5, 384)},
                      "albef", None),
        "blip_vqa": ({"model": synthetic.albef_vqa_state_dict(blip, SEED + 6, 480)}, "albef",
                     write_run_config(tmp, "blip480", albef=blip)),
        "vlmo_vqa": ({"state_dict": synthetic.vlmo_state_dict(
            cfg_vlmo, SEED + 7, heads=synthetic.VLMO_VQA_HEADS)}, "vlmo", None),
        "vilt": ({"state_dict": synthetic.vilt_state_dict(vilt, SEED + 8)}, "vlmo",
                 vilt_config_path(tmp, 480)),
    }
    out = {}
    for name, (ckpt, pipeline, config) in files.items():
        path = os.path.join(tmp, f"{name}.pth")
        torch.save(ckpt, path)
        out[name] = (path, pipeline, config)
    return out


def transfer_path(tmp, paths, artifacts, tokenizer, cfg_albef, cfg_vlmo):
    """``transfer_eval`` over ``artifacts`` (the ALBEF batched phase's, 480
    px) against the four victims of :func:`_transfer_victims`, ``--attn
    flash`` on the card: ALBEF-VQA, BLIP-VQA and VLMo-VQA through the CLI
    with ``--victim-ckpt``, ViLT through ``checkpoint/io.py::load_vilt``
    (no CLI flag loads a ViLT file) and the same replay.  Each run's counts
    are reset just before and read just after and must equal what its
    victim forwards imply; the same pipeline's replay under ``--attn xla``
    must give the same answers and outputs within 1e-4 of their largest
    value (:func:`_victim_outputs_err`).  K3 is held against its plain
    versions at the ViLT victim's own shapes (key bias alone, 266 tokens
    at 480 px).  Then ``Predictor.answer`` on the first pair with the
    ALBEF and the ViLT victim.  Returns the ``transfer`` record."""
    from vqattack_tpu_torch import transfer_eval
    from vqattack_tpu_torch.checkpoint import io as ckpt_io
    from vqattack_tpu_torch.predict import Predictor

    t0 = time.perf_counter()
    victims = _transfer_victims(tmp, cfg_albef, cfg_vlmo)
    write_s = time.perf_counter() - t0
    files = transfer_eval.artifact_files(artifacts)
    n_chunks = -(-len(files) // transfer_eval.CHUNK)
    record = {"artifacts": "the ALBEF batched path's (480 px)", "samples": len(files),
              "write_s": round(write_s, 2), "victims": {}}
    first = files[0]
    first_px = np.ascontiguousarray(np.load(first).transpose(0, 3, 1, 2))
    with open(os.path.join(artifacts, "adv_txt_dict.json")) as f:
        first_text = json.load(f)[os.path.splitext(os.path.basename(first))[0]]
    for name, (path, pipeline, config) in victims.items():
        argv = ["--pipeline", pipeline, "--artifacts", artifacts, "--vocab", paths["vocab"],
                "--surrogate-ans", paths["sur"], "--device", "cuda", "--attn", "flash"]
        argv += (["--answer-list", paths["answers"]] if pipeline == "albef"
                 else ["--id2answer", paths["id2answer"]])
        argv += ["--config", config] if config else []
        args = transfer_eval.build_argparser().parse_args(
            argv + ([] if name == "vilt" else ["--victim-ckpt", path]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_main() as rec, recorded_predictions() as preds, \
                recorded_victim_outputs() as outs, recorded_k3_launches() as seen:
            if name != "vilt":
                reset_counts()
                out = transfer_eval.main(argv + ["--victim-ckpt", path])
                pipe = rec["pipe"]
            else:
                run_args = transfer_eval.pipeline_args(args)
                cfg = port_run.resolve_config(run_args)
                with attention.attention_impl("flash"):
                    pipe = port_run._build_pipeline(run_args, cfg, tokenizer)
                    ckpt_io.load_vilt(path, cfg.vlmo, into=pipe.victim)
                    reset_counts()
                    out = transfer_eval.replay(
                        pipe, files, *transfer_eval.read_tables(args),
                        *transfer_eval.answer_table(args, tokenizer, pipe.device))
            torch.cuda.synchronize()
            launched = counts()
        seconds = time.perf_counter() - t1
        cfg = port_run.resolve_config(transfer_eval.pipeline_args(args))
        if pipeline == "albef":
            require(cfg.albef.vit.fused_ln, f"{name}: the victim's ViT without K2")
            expected = implied_launches(cfg, n_chunks, 0, 0, True)
            positive = {"residual_layernorm_fwd", "flash_attention_fwd"}
        else:
            expected = vlmo_implied_launches(cfg, n_chunks, 0, 0, True)
            positive = {"flash_attention_fwd", "flash_attention_fwd_key_bias"}
        check_launches(launched, expected, positive, f"transfer to {name}")
        require(out["samples"] == len(files) and len(preds) == len(files)
                and 0.0 <= out["attack_accuracy"] <= 1.0, f"transfer to {name}: {out}")
        answers = transfer_eval.answer_table(args, tokenizer, pipe.device)
        with recorded_predictions() as plain, recorded_victim_outputs() as plain_outs, \
                attention.attention_impl("xla"):
            transfer_eval.replay(pipe, files, *transfer_eval.read_tables(args), *answers)
        require(plain == preds, f"transfer to {name}: --attn xla answers {plain}, flash {preds}")
        err, largest, spread = _victim_outputs_err(
            outs, plain_outs, min(len(files), transfer_eval.CHUNK), f"transfer to {name}")
        k3 = {}
        if name == "vilt":
            shapes = k3_key_bias_shapes(seen)
            require(bool(shapes), "the ViLT victim launched no key-bias K3 forward")
            gen = torch.Generator("cuda").manual_seed(14)
            for b, seq in sorted(shapes):
                k3[f"{b}x{seq}"] = _check_two_term_case(
                    *_qkv(gen, b, seq), None, _text_key_bias(pipe, tokenizer, b, seq),
                    f"the ViLT victim at 480 px, batch {b}")
        if name in ("albef_vqa", "vilt"):
            with attention.attention_impl("flash"):
                ranked = Predictor(pipe, *answers).answer(first_px, first_text, topk=5)
            probs = [p_ for _, p_ in ranked]
            require(len(ranked) == 5 and ranked[0][0] == preds[0]
                    and all(a >= b_ for a, b_ in zip(probs, probs[1:])) and 0 < probs[0] <= 1,
                    f"Predictor.answer with the {name} victim: {ranked}")
            print(f"  Predictor.answer ({name}) on {os.path.basename(first)} "
                  f"{first_text!r}: {ranked}", flush=True)
        record["victims"][name] = {"attack_accuracy": out["attack_accuracy"],
                                   "distinct_answers": len(set(preds)),
                                   "flash_xla_err": err, "largest": largest, "spread": spread,
                                   "seconds": round(seconds, 2), "launches": {
                                       k: n for k, n in launched.items() if n}}
        if k3:
            record["victims"][name]["k3_errs"] = k3
        print(f"  transfer to {name}: {out['samples']} pairs, flip rate "
              f"{out['attack_accuracy']:.3f}, {len(set(preds))} distinct answers, "
              f"{seconds:.2f} s (build, load, replay), "
              f"launches {record['victims'][name]['launches']}; --attn xla gives the same "
              f"answers and outputs within {err:.3g} (largest {largest:.3g}, pairs apart by "
              f"{spread:.3g})", flush=True)
        del pipe, rec
        torch.cuda.empty_cache()
        os.remove(path)
    return record


def check_masked_row_truth(pipe, tokenizer, gen, dtype):
    """The masked row of :func:`check_masked_rows` against autograd of the
    explicit float32 softmax (the JAX einsum path's arithmetic, which
    shares no statistics with the kernels): the row's output and dq, dk,
    dv within 2e-5 (float32) or two bf16 ulps (bf16) of the largest true
    value (at least 1).  With L = m + log l saved as one float32, the
    kernels' gradients there were Sk times these."""
    q, k, v, table, key_bias = _vlmo_qkv_terms(pipe, tokenizer, gen, 2)
    key_bias[1] = -1e9
    q, k, v = (t.to(dtype) for t in (q, k, v))
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(4),
                     device="cuda").to(dtype)
    o, lse = attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias)
    grads = attention.flash_attention_bwd(q, k, v, table, SCALE, o, lse, do, key_bias)
    xs = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", xs[0] * SCALE, xs[1]) + table
    s = s + key_bias[:, None, None, :]
    o_t = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), xs[2])
    truth = (o_t.detach(), *torch.autograd.grad(o_t, xs, do.float()))
    rel = 2e-5 if dtype == torch.float32 else 2 ** -6
    errs = {}
    for name, g, t in zip(("o", "dq", "dk", "dv"), (o, *grads), truth):
        errs[name] = float((g[1].float() - t[1]).abs().max())
        require(errs[name] <= rel * max(1.0, float(t.abs().max())),
                f"masked row {name} against the softmax's autograd: {errs[name]}")
    print(f"  masked row against autograd of the float32 softmax ({dtype}): "
          + ", ".join(f"{k_} err {v_:.3g}" for k_, v_ in errs.items()), flush=True)
    return errs


# ---------------------------------------------------------------------------
# the analysis slice: multi-restart PGD, Grad-CAM and grounding, the attack
# zoo (attacks/extra.py) against the VLMo-VQA victim
# ---------------------------------------------------------------------------

RESTART_B, RESTARTS, RESTART_ITERS = 2, 4, 10
RESTART_QUESTIONS = ["what color is the dog", "what is the man holding"]
GRADCAM_LAYER = 8
# the grounding layout: image sizes (h, w) of the reference's range
GROUNDING_IMAGES = [(333, 500), (480, 640), (640, 427)]
ZOO_B, ZOO_ITERS, SPSA_ITERS, SPSA_SAMPLES = 2, 10, 4, 32
CW_ITERS, CW_STEPS = 20, 3


def restarts_phase(pipe, cfg, tokenizer):
    """``pgd_multi_restart`` over the ALBEF surrogate: the feature loss,
    B = 2, R = 4, 10 steps a restart.  The restarts are run again one by
    one from the same seed (the same draws in the same order) and their
    final iterates evaluated again: the pick must be each sample's argmax,
    its trajectory the one returned.  Returns (the phase's numbers,
    launches, the schedule's launches)."""
    atk, dev = cfg.attack, pipe.device
    size = cfg.albef.vit.image_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    ori = torch.rand((RESTART_B, 3, size, size), generator=gen, device=dev) * 2 - 1
    ids, mask = tokenizer.encode_batch(RESTART_QUESTIONS, atk.max_text_len)
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.long, device=dev)
    aux = {"text_ids": ids, "text_mask": mask, "ori_ids": ids, "ori_mask": mask,
           "txt_token_mask": mask.float(), "special_ids": pipe._special}
    aux.update(pipe._targets_fn(ori, TorchKey(SEED + 22, dev), aux))
    kw = dict(eps=atk.eps, eps_iter=atk.step_size, nb_iter=RESTART_ITERS)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adv, best = pgd_multi_restart(pipe._feature_loss, ori, ori, TorchKey(SEED + 23, dev), aux,
                                  n_restarts=RESTARTS, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    expected = implied_launches(cfg, RESTARTS * (RESTART_ITERS + 1), RESTARTS * RESTART_ITERS,
                                RESTARTS * RESTART_ITERS, True)
    require(tuple(best.shape) == (RESTART_ITERS, RESTART_B) and bool(torch.isfinite(best).all()),
            "multi-restart losses")
    require(float((adv - ori).abs().max()) <= atk.eps + 1e-6, "a restart left the eps ball")
    require(float(adv.min()) >= -1 and float(adv.max()) <= 1, "a restart left the box")
    # the pick, recomputed: each restart alone from the same key stream
    key = TorchKey(SEED + 23, dev)
    keys = key.split(RESTARTS + 1)
    runs = [pgd_feature(pipe._feature_loss, ori, ori, k, aux, rand_init=True, **kw)
            for k in keys[:-1]]
    with torch.no_grad():
        final = torch.stack([pipe._feature_loss(a, k, aux)[1]
                             for (a, _), k in zip(runs, keys[-1].split(RESTARTS))])
    pick = torch.argmax(final, dim=0)
    top2 = torch.topk(final, 2, dim=0).values
    for i, r in enumerate(pick.tolist()):
        require(torch.allclose(runs[r][1][:, i], best[:, i], rtol=1e-5, atol=0),
                f"sample {i}: the returned trajectory is not restart {r}'s, the argmax of the "
                f"re-evaluated losses {final[:, i].tolist()}")
        require(torch.allclose(runs[r][0][i], adv[i], rtol=0, atol=1e-6),
                f"sample {i}: the returned image is not restart {r}'s")
    out = {"seconds": round(seconds, 3), "batch": RESTART_B, "restarts": RESTARTS,
           "iterations": RESTART_ITERS, "pick": pick.tolist(),
           "final_losses": final.t().tolist(),
           "margin_to_second": (top2[0] - top2[1]).tolist()}
    print(f"  multi-restart: {seconds:.3f} s, picks {out['pick']}, re-evaluated losses "
          f"{out['final_losses']}", flush=True)
    return out, launched, expected


class _ExplicitCrossAttention(torch.nn.Module):
    """A cross-attention layer's product + softmax written out, its
    probabilities kept with their gradient (Grad-CAM's grad x attention,
    computed directly)."""

    def __init__(self, mha):
        super().__init__()
        self.mha, self.probs = mha, None

    def forward(self, x, kv=None, bias=None, key_bias=None, attn_scale=None):
        m = self.mha
        b, sq, _ = x.shape
        h, dh = m.num_heads, m.head_dim
        q = m.query(x).view(b, sq, h, dh).transpose(1, 2)
        k = m.key(kv).view(b, -1, h, dh).transpose(1, 2)
        v = m.value(kv).view(b, -1, h, dh).transpose(1, 2)
        s = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
        if bias is not None:
            s = s + bias
        self.probs = torch.softmax(s, dim=-1).detach().requires_grad_(True)
        return torch.matmul(self.probs, v).transpose(1, 2).reshape(b, sq, h * dh)


def gradcam_direct(model, px, ids, mask, layer):
    """relu(d score / d attention x attention) at ``layer``'s
    cross-attention, from the probabilities themselves: the mean over the
    heads at the [CLS] query, the image [CLS] key dropped."""
    blk = model.text_encoder.layer[layer]
    explicit = _ExplicitCrossAttention(blk.crossattention_self)
    blk.crossattention_self = explicit
    try:
        with torch.no_grad():
            image_embeds, _ = model.visual_encoder(px)
            embeds = model.text_encoder.embed(ids)
        image_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long, device=px.device)
        with torch.enable_grad():
            last, _ = model.text_encoder.encode(embeds, mask, image_embeds, image_mask,
                                                mode="multi_modal")
            torch.sum(last[:, 0]).backward()
    finally:
        blk.crossattention_self = explicit.mha
    p = explicit.probs
    cam = torch.mean(torch.clamp(p.grad * p, min=0.0), dim=1)[:, 0, 1:]
    return cam.detach()


def write_refer(tmp, grid):
    """A RefCOCO layout under ``tmp/refcoco+`` (``refs(unc).json``,
    ``instances.json``): one ref an image, fractional detection boxes."""
    rng = np.random.default_rng(SEED + 31)
    images, anns, refs, dets = [], [], [], {}
    for i, (h, w) in enumerate(GROUNDING_IMAGES):
        images.append({"id": i, "height": h, "width": w})
        box = [float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
               float(rng.uniform(w / 6, w / 2)), float(rng.uniform(h / 6, h / 2))]
        anns.append({"id": 10 + i, "image_id": i, "bbox": box, "category_id": 1})
        refs.append({"ref_id": 20 + i, "ann_id": 10 + i, "image_id": i,
                     "split": ("val", "testA", "testB")[i]})
        dets[str(i)] = [[c + 0.37 for c in box]] + [
            [float(rng.uniform(0, w / 2)) + 0.5, float(rng.uniform(0, h / 2)) + 0.25,
             float(rng.uniform(20, w / 2)) + 0.75, float(rng.uniform(20, h / 2)) + 0.5, 0.9]
            for _ in range(3)]
    root = os.path.join(tmp, "refcoco+")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "refs(unc).json"), "w") as f:
        json.dump(refs, f)
    with open(os.path.join(root, "instances.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "dog"}]}, f)
    return dets


@contextlib.contextmanager
def drawn_last_layernorm(model, seed):
    """The text encoder's last LayerNorm with its affine map drawn from
    ``seed`` (gamma 1 + N(0, 0.1), beta N(0, 0.1)) for the block, restored
    after.  Random weights from ``init_weights`` leave every LayerNorm at
    gamma 1, beta 0, and with those the sum of its outputs is 0 whatever
    its input: Grad-CAM's score, the summed [CLS] state, would be constant
    and its gradient 0."""
    ln = model.text_encoder.layer[-1].output_LayerNorm
    saved = (ln.weight.detach().clone(), ln.bias.detach().clone())
    g = torch.Generator(device=ln.weight.device).manual_seed(seed)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(ln.weight.shape, generator=g,
                                              device=ln.weight.device))
        ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device=ln.bias.device))
    try:
        yield
    finally:
        with torch.no_grad():
            ln.weight.copy_(saved[0])
            ln.bias.copy_(saved[1])


def gradcam_phase(pipe, cfg, tokenizer, tmp):
    """``albef_question_gradcam`` on the ALBEF surrogate at layer 8 (a [1,
    30, 30] CAM) under ``--attn flash`` and ``--attn xla`` and against
    grad x attention taken directly, then ``grounding_accuracy`` over a
    synthetic RefCOCO layout from the normalised CAM, its resize held
    against a float64 numpy evaluation of the same weights.  The last
    LayerNorm's affine map is drawn for the phase
    (:func:`drawn_last_layernorm`).  Returns (the phase's numbers,
    launches, the schedule's launches)."""
    with drawn_last_layernorm(pipe.surrogate, SEED + 33):
        return _gradcam_phase(pipe, cfg, tokenizer, tmp)


def _gradcam_phase(pipe, cfg, tokenizer, tmp):
    dev, size = pipe.device, cfg.albef.vit.image_size
    model = pipe.surrogate
    grid = size // cfg.albef.vit.patch_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    px = torch.rand((1, 3, size, size), generator=gen, device=dev) * 2 - 1
    ids, mask = tokenizer.encode("what color is the dog", cfg.attack.max_text_len)
    ids = torch.as_tensor(ids[None], dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask[None], dtype=torch.long, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with attention.attention_impl("flash"):
        cam = albef_question_gradcam(model, px, ids, mask, layer=GRADCAM_LAYER)
    seconds = time.perf_counter() - t0
    launched = counts()
    # the ViT's forward alone: the probe's gradient needs no image-tower graph
    expected = implied_launches(cfg, 1, 0, 0, True)
    with attention.attention_impl("xla"):
        cam_xla = albef_question_gradcam(model, px, ids, mask, layer=GRADCAM_LAYER)
        direct = gradcam_direct(model, px, ids, mask, GRADCAM_LAYER).reshape(1, grid, grid)
    top = float(np.abs(cam_xla).max())
    require(cam.shape == (1, grid, grid) and np.isfinite(cam).all(), "the CAM's shape")
    require(cam.min() >= 0 and top > 0, "the CAM is negative or all zero")
    err_flash = float(np.abs(cam - cam_xla).max())
    err_direct = float(np.abs(cam_xla - direct.cpu().numpy()).max())
    require(err_flash <= 1e-4 * top, f"the CAM under flash: {err_flash} from xla's (max {top})")
    require(err_direct <= 1e-5 * top, f"the CAM against grad x attention taken directly: "
                                      f"{err_direct} (max {top})")

    dets = write_refer(tmp, grid)
    refer = grounding.Refer(tmp)
    heat = torch.as_tensor(cam[0] / cam.max(), device=dev)
    resize_err = 0.0
    for h, w in GROUNDING_IMAGES:
        got = grounding._upsample_bicubic(heat, h, w).cpu().numpy().astype(np.float64)
        m64 = heat.cpu().numpy().astype(np.float64)
        want = grounding.bicubic_weights(grid, h) @ m64 @ grounding.bicubic_weights(grid, w).T
        resize_err = max(resize_err, float(np.abs(got - want).max()))
    require(resize_err <= 1e-5, f"the grounding resize against float64 numpy: {resize_err}")
    t1 = time.perf_counter()
    acc = grounding.grounding_accuracy(
        [{"ref_id": rid, "pred": heat} for rid in refer.getRefIds()], dets, refer,
        mask_size=grid)
    g_seconds = time.perf_counter() - t1
    require(set(acc) == {"val_d", "testA_d", "testB_d"}, f"grounding splits {acc}")
    out = {"gradcam_seconds": round(seconds, 3), "grounding_seconds": round(g_seconds, 3),
           "cam_max": top, "flash_vs_xla": err_flash, "direct_vs_probe": err_direct,
           "resize_vs_float64": resize_err, "accuracy": acc}
    print(f"  Grad-CAM at layer {GRADCAM_LAYER}: {seconds:.3f} s, max {top:.4g}, flash-xla "
          f"{err_flash:.3g}, direct {err_direct:.3g}; resize {resize_err:.3g}; grounding "
          f"{acc} in {g_seconds:.3f} s", flush=True)
    return out, launched, expected


def zoo_phase(pipe, cfg, tokenizer):
    """The seven attacks of ``attacks/extra.py`` against the VLMo-VQA victim
    (941 joint tokens, 3,129 answers) on a fixed question, B = 2, ``--attn
    flash``: PGD and MIM 10 steps, SPSA 4 steps of 32 draws in chunks of 8,
    CW-L2 20 steps x 3 search steps.  Each result is checked (finite, the
    box, the ball; CW-L2 its start or a success with its L2), and the
    victim's logits at it under flash against xla.  K3 with both terms is
    held against its plain versions at each (B, S) the attacks launched it
    at: B 2 and SPSA's stacked 32.  Returns (the phase's numbers,
    launches, the schedule's launches)."""
    dev, size, atk = pipe.device, cfg.vlmo.image_size, cfg.attack
    victim, rel = pipe.victim, pipe._victim_rel_biases
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    x = torch.rand((ZOO_B, 3, size, size), generator=gen, device=dev) * 2 - 1
    ids, mask = tokenizer.encode("what color is the dog?", pipe.max_text_len)
    ids = torch.as_tensor(ids[None], dtype=torch.long, device=dev)
    mask = torch.as_tensor(mask[None], dtype=torch.long, device=dev)

    def logits_fn(px):
        n = px.shape[0]
        return victim.vqa_logits(px, ids.expand(n, -1), mask.expand(n, -1), rel)

    with torch.no_grad(), attention.attention_impl("flash"):
        y = get_or_guess_labels(logits_fn, x)
    eps, step = atk.eps, atk.step_size
    key = TorchKey(SEED + 42, dev)
    runs = {
        "fgm": lambda: extra.fgm_classifier(logits_fn, x, y, eps=eps),
        "pgd": lambda: extra.pgd_classifier(logits_fn, x, y, key, eps=eps, eps_iter=step,
                                            nb_iter=ZOO_ITERS),
        "mim": lambda: extra.momentum_iterative_method(logits_fn, x, y, eps=eps,
                                                       eps_iter=step, nb_iter=ZOO_ITERS),
        "spsa": lambda: extra.spsa(logits_fn, x, y, key, eps=eps, nb_iter=SPSA_ITERS,
                                   spsa_samples=SPSA_SAMPLES, lr=step),
        "semantic": lambda: extra.semantic(x),
        "noise": lambda: extra.noise(x, key, eps=eps),
        "cw_l2": lambda: extra.cw_l2_search(logits_fn, x, y, cfg.vlmo.vqa_label_size,
                                            max_iterations=CW_ITERS,
                                            binary_search_steps=CW_STEPS, lr=0.01),
    }
    reset_counts()
    advs, seconds, peak_gib = {}, {}, {}
    with attention.attention_impl("flash"), recorded_k3_launches() as seen:
        for name, run in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            advs[name] = run()
            torch.cuda.synchronize()
            seconds[name] = round(time.perf_counter() - t0, 3)
            peak_gib[name] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    launched = counts()
    # K3 with both terms at every (B, S) the attacks gave it, SPSA's stacked
    # draws (2 * SPSA_CHUNK * B rows) included, against its plain versions
    seq = rel[0].shape[-1]  # the joint sequence, 941 tokens
    spsa_rows = 2 * extra.SPSA_CHUNK * ZOO_B
    shapes = k3_key_bias_shapes(seen, table=True)
    require(shapes == {(ZOO_B, seq), (spsa_rows, seq)}, f"the zoo's two-term K3 shapes {shapes}")
    k3 = {f"{b}x{s}": _check_two_term_case(
        *_qkv(gen, b, s), rel[0][None], _text_key_bias(pipe, tokenizer, b, s),
        f"the zoo's VLMo-VQA victim, batch {b}") for b, s in sorted(shapes)}
    chunks = -(-SPSA_SAMPLES // extra.SPSA_CHUNK)
    fwd = 1 + 2 * ZOO_ITERS + SPSA_ITERS * chunks + CW_STEPS * (CW_ITERS + 1)
    bwd = 1 + 2 * ZOO_ITERS + CW_STEPS * CW_ITERS
    expected = vlmo_implied_launches(cfg, fwd, bwd, 0, True)
    best, best_l2, margins = advs.pop("cw_l2")
    advs["cw_l2"] = best
    for name, adv in advs.items():
        require(tuple(adv.shape) == tuple(x.shape) and bool(torch.isfinite(adv).all()),
                f"{name}: shape or non-finite values")
        require(float(adv.min()) >= -1 and float(adv.max()) <= 1, f"{name}: outside the box")
        if name not in ("semantic", "cw_l2"):
            require(float((adv - x).abs().max()) <= eps + 1e-6, f"{name}: outside the ball")
    cw = []
    for i in range(ZOO_B):
        l2 = float(best_l2[i])
        if np.isfinite(l2):
            got = float(((best[i] - x[i]) ** 2).sum())
            require(abs(got - l2) <= 1e-4 * max(l2, 1e-6), f"CW-L2 sample {i}: recorded L2 "
                                                            f"{l2}, its image's {got}")
            require(bool((margins[:, i] <= 0).any()), f"CW-L2 sample {i}: an L2 and no success")
        else:
            require(torch.equal(best[i], x[i].clamp(-1, 1)), f"CW-L2 sample {i}: no success "
                                                             f"and not its start")
        cw.append({"l2": l2 if np.isfinite(l2) else None,
                   "margins": margins[:, i].tolist()})
    errs, largest, flips = {}, {}, {}
    with torch.no_grad():
        for name, adv in advs.items():
            with attention.attention_impl("flash"):
                lf = logits_fn(adv)
            with attention.attention_impl("xla"):
                lx = logits_fn(adv)
            errs[name] = float((lf - lx).abs().max())
            largest[name] = float(lx.abs().max())
            require(errs[name] <= 1e-4 * largest[name], f"{name}: victim logits flash against "
                                                        f"xla {errs[name]} (max {largest[name]})")
            flips[name] = int((lf.argmax(-1) != y).sum())
    out = {"seconds": seconds, "logits_flash_vs_xla": errs, "logits_largest": largest, "cw_l2": cw,
           "answers_changed": flips, "k3_errs": k3, "peak_gib": peak_gib}
    print(f"  zoo: {seconds}; peak GiB {peak_gib}; answers changed of {ZOO_B}: {flips}",
          flush=True)
    return out, launched, expected


def ptxas_summary(report):
    """One line a kernel of ptxas's report of a source (``-Xptxas -v``):
    registers at launch, spill stores and loads, and whether ptxas
    serialized its wgmma instructions (its warning's code, C7515 or C7511)."""
    if report is None:
        return ["  ptxas: no report (the library was built before this process)"]
    found, name, spills, serialized = [], None, "", {}

    def short(mangled):
        # the kernel's name and its template arguments: bools and ints as
        # numbers, float and __nv_bfloat16 as f32 and bf16
        m = re.search(r"(?<=\d)([A-Za-z][A-Za-z_]*?_kernel)(?:I((?:f|13__nv_bfloat16|L[ib]\d+E)+)E)?",
                      mangled)
        if m is None:
            return mangled
        args = [{"f": "f32", "13__nv_bfloat16": "bf16"}.get(a) or a[2:-1]
                for a in re.findall(r"f|13__nv_bfloat16|L[ib]\d+E", m.group(2) or "")]
        return m.group(1) + (f"<{','.join(args)}>" if args else "")

    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = short(m.group(1))
        m = re.search(r"(C751\d).*in the function '([^']+)'", line)
        if m:
            serialized[short(m.group(2))] = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.append((name, f"{m.group(1)} registers at launch, {spills}"))
            name = None
    return [f"  ptxas {k}: {v}" + (f", wgmma serialized ({serialized[k]})" if k in serialized
                                    else "")
            for k, v in found]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs one", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
        print(smi, flush=True)  # name, power limit: as nvidia-smi prints them

    with Phase("build") as ph:
        _build.load()
    print(f"build: {ph.seconds:.2f} s -> {_build.library_path()}", flush=True)
    for line in ptxas_summary(_build.PTXAS_REPORTS.get("flash_attention_bf16.cu")):
        print(line, flush=True)
    # K2's backward: <stream dtype, values a chunk, chunks a lane, parameter sums>
    for line in ptxas_summary(_build.PTXAS_REPORTS.get("fused_ln.cu")):
        if "residual_ln_bwd_kernel" in line or "no report" in line:
            print(line, flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with Phase("kernels against their plain versions"):
        flash_rows, flash_b16 = check_flash_attention(gen)
        rows = [check_pgd_update(gen), *check_fused_ln(gen), *flash_rows]
        bf16_rows = check_flash_attention_bf16(gen)

    tmp = tempfile.mkdtemp(prefix="vqattack_chip_smoke_")
    paths = write_assets(tmp)
    out_dir = os.path.join(tmp, "out")
    common = [
        "--vocab", paths["vocab"], "--answer-list", paths["answers"],
        "--right-part", paths["right"], "--surrogate-ans", paths["sur"],
        "--target-ans", paths["tgt"], "--paraphrases", paths["para"],
        "--all-correct", paths["allc"], "--output", out_dir,
        "--seed", str(SEED), "--device", "cuda",
    ]
    args = port_run.build_argparser().parse_args(common)
    batch_args = port_run.build_argparser().parse_args(common + [
        "--batch-size", str(BATCH_SIZE), "--attn", "flash",
        "--pipeline-depth", str(PIPELINE_DEPTH)])
    cfg = port_run.resolve_config(args)
    require(cfg.albef.vit.fused_ln and cfg.albef.vit.image_size == 480
            and cfg.albef.vit.depth == 12 and cfg.albef.bert.num_layers == 12
            and cfg.albef.vit.hidden_size == HEADS * HEAD_DIM
            and cfg.attack.num_iters == 40, "not the full-width ALBEF attack config")
    tokenizer = WordPieceTokenizer.from_file(paths["vocab"])
    with Phase("pipeline (random full-width weights)"):
        pipe = port_run._build_pipeline(args, cfg, tokenizer)
    with Phase("model: kernels against plain LayerNorms and attention"):
        check_model(cfg, pipe.surrogate, gen)
        check_model_flash(pipe.surrogate, gen)

    with Phase("per-sample path: ALBEF attack, 2 samples, --attn xla"):
        results, launched, expected = run_main_path(pipe, cfg, tokenizer, paths,
                                                    args.answer_max_len)
    require(sorted(r.old_alg for r in results) == [0, 1], "both PGD paths must run")
    for k, n in launched.items():
        require(n == expected[k], f"per-sample {k}: {n} launches, the schedules imply "
                                  f"{expected[k]}")
        require(n > 0 or k.startswith("flash") or "_bf16" in k or k in TRAINING_ONLY,
                f"{k} was not launched on the per-sample path")
    save_artifacts(results, out_dir)
    for r in results:
        for ext in (".pt", ".npy"):
            require(os.path.exists(os.path.join(out_dir, r.qid + ext)), f"artifact {r.qid}{ext}")
    require(os.path.exists(os.path.join(out_dir, "adv_txt_dict.json")), "adversarial-text json")

    with Phase(f"batched path: {len(BATCH_SAMPLES)} samples, --batch-size {BATCH_SIZE} "
               f"--attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl(batch_args.attn):
            b_results, b_launched, b_expected, _ = run_albef_batched_path(
                pipe, cfg, tokenizer, paths, batch_args)
    require(sorted({r.old_alg for r in b_results}) == [0, 1], "both PGD paths must run")
    for k, n in b_launched.items():
        require(n > 0 or k.endswith(("key_bias", "hd34")) or "_bf16" in k
                or k in TRAINING_ONLY,
                f"{k} was not launched on the batched path")
        require(n == b_expected[k], f"batched {k}: {n} launches, the schedules imply "
                                    f"{b_expected[k]}")

    batched_out = os.path.join(tmp, "out_batched")  # the transfer phase replays these
    save_artifacts(b_results, batched_out)

    with Phase("one gradient step at batch 16: --attn flash against --attn xla"):
        ab = one_step_ab(pipe, cfg, tokenizer, gen)

    # ------------------------- the analysis slice: restarts, Grad-CAM, zoo
    vit32 = {"residual_layernorm_fwd", "residual_layernorm_bwd", "flash_attention_fwd",
             "flash_attention_bwd"}
    with Phase(f"multi-restart PGD: ALBEF, B {RESTART_B}, R {RESTARTS}, {RESTART_ITERS} steps, "
               f"--attn flash") as ph:
        with attention.attention_impl("flash"):
            restarts, r_launched, r_expected = restarts_phase(pipe, cfg, tokenizer)
    check_launches(r_launched, r_expected, vit32 | {"pgd_linf_update"}, "multi-restart")
    restarts["phase_s"] = round(ph.seconds, 2)
    print(json.dumps({"multi_restart": restarts, "launches": r_launched, "card": smi}),
          flush=True)
    with Phase(f"Grad-CAM at layer {GRADCAM_LAYER} (--attn flash and xla) and grounding: "
               f"ALBEF") as ph:
        gradcam, g_launched, g_expected = gradcam_phase(pipe, cfg, tokenizer, tmp)
    check_launches(g_launched, g_expected, {"residual_layernorm_fwd", "flash_attention_fwd"},
                   "Grad-CAM")
    gradcam["phase_s"] = round(ph.seconds, 2)
    print(json.dumps({"gradcam_grounding": gradcam, "launches": g_launched, "card": smi}),
          flush=True)

    # ----------------------------------------------- ALBEF, --dtype bfloat16
    bf16_flags = ["--dtype", "bfloat16"]
    batch_flags = ["--batch-size", str(BATCH_SIZE), "--attn", "flash",
                   "--pipeline-depth", str(PIPELINE_DEPTH)]
    with Phase("ALBEF bf16 pipeline (the same random full-width weights)"):
        _, cfg16, pipe16 = build_pipelines(common + bf16_flags, tokenizer)
    require(cfg16.compute_dtype == "bfloat16" and cfg16.albef.vit.fused_ln, "the bf16 config")
    with Phase("ALBEF drift at full width: float32 against bf16, a MAR and a feature sample"):
        drift = drift_check((pipe, pipe16), (cfg, cfg16), SAMPLES, False, "ALBEF")
    del pipe
    torch.cuda.empty_cache()
    # the bf16 surrogate's K2 and K3 instances; the float32 victim's forward ones
    albef16 = {"pgd_linf_update", "residual_layernorm_bf16_fwd", "residual_layernorm_bf16_bwd",
               "flash_attention_bf16_fwd", "flash_attention_bf16_bwd", "residual_layernorm_fwd",
               "flash_attention_fwd"}
    with Phase("ALBEF bf16 per-sample path: 1 sample, --dtype bfloat16 --attn flash"):
        with attention.attention_impl("flash"):
            _, s16_launched, s16_expected = run_main_path(
                pipe16, cfg16, tokenizer, paths, args.answer_max_len, SAMPLES[:1])
    check_launches(s16_launched, s16_expected, albef16, "ALBEF bf16 per-sample")
    with Phase(f"ALBEF bf16 batched path: {len(BATCH_SAMPLES)} samples, --dtype bfloat16 "
               f"--batch-size {BATCH_SIZE} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl("flash"):
            _, b16_launched, b16_expected, _ = run_albef_batched_path(
                pipe16, cfg16, tokenizer, paths,
                port_run.build_argparser().parse_args(common + bf16_flags + batch_flags))
    check_launches(b16_launched, b16_expected, albef16, "ALBEF bf16 batched")
    with Phase(f"ALBEF bf16 through run.main: {len(BATCH_SAMPLES)} samples, --dtype bfloat16 "
               f"--batch-size {BATCH_SIZE} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        m16_launched, m16_expected, _ = run_main_bf16(
            common, bf16_flags + batch_flags, BATCH_SAMPLES, 700, cfg16.albef.vit.image_size,
            implied_launches, "float32", "albef", tmp)
    check_launches(m16_launched, m16_expected, albef16, "ALBEF bf16 run.main")
    with Phase("one bf16 gradient step at batch 16: --attn flash against --attn xla"):
        ab16 = one_step_ab(pipe16, cfg16, tokenizer, gen)
    del pipe16
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- VLMo
    v_common = [a for a in common if a not in ("--answer-list", paths["answers"])]
    v_common += ["--pipeline", "vlmo", "--id2answer", paths["id2answer"]]
    v_args = port_run.build_argparser().parse_args(v_common)
    v_batch_args = port_run.build_argparser().parse_args(v_common + [
        "--batch-size", str(BATCH_SIZE), "--attn", "flash",
        "--pipeline-depth", str(PIPELINE_DEPTH)])
    v_cfg = port_run.resolve_config(v_args)
    vc = v_cfg.vlmo
    require(vc.image_size == 480 and vc.patch_size == 16 and vc.depth == 12
            and vc.hidden_size == HEADS * HEAD_DIM and vc.num_heads == HEADS
            and vc.vlffn_start_layer == 10 and vc.layer_scale_init == 0.1
            and vc.max_text_len + vc.image_seq_len == 941 and vc.vqa_label_size == 3129
            and v_cfg.attack.num_iters == 40 and v_cfg.attack.eps == 0.125
            and v_cfg.attack.step_size == 0.01, "not the full-width VLMo attack config")
    with Phase("VLMo pipeline (random full-width weights)"):
        v_pipe = port_run._build_pipeline(v_args, v_cfg, tokenizer)
    require(tuple(v_pipe._rel_biases.shape) == (12, HEADS, 941, 941),
            "the precomputed relative-position biases")
    with Phase("K3 with a key bias against its plain versions (VLMo shapes)"):
        kb_rows = check_flash_attention_key_bias(v_pipe, tokenizer, gen)
    with Phase("K3's bias gradient (dbias) against its plain version (VLMo training shapes)"):
        dbias_row = check_flash_attention_dbias(v_pipe, tokenizer, gen)
    with Phase("K3 on a row masked whole by a finite -1e9 against its plain versions and "
               "autograd of the softmax"):
        check_masked_rows(v_pipe, tokenizer, gen, torch.float32)
        masked32_truth = check_masked_row_truth(v_pipe, tokenizer, gen, torch.float32)
    with Phase("VLMo model: flash (two-term K3) against product + softmax"):
        check_vlmo_model_flash(v_pipe, tokenizer, gen)

    with Phase("VLMo per-sample path: 2 samples, --attn xla"):
        v_results, v_launched, v_expected = run_vlmo_main_path(v_pipe, v_cfg, paths)
    require(sorted(r.old_alg for r in v_results) == [0, 1], "both VLMo PGD paths must run")
    require(all(r.vl_steps > 0 for r in v_results), "no VLMo VL step ran")
    for k, n in v_launched.items():
        require(n == v_expected[k], f"VLMo per-sample {k}: {n} launches, the schedules imply "
                                    f"{v_expected[k]}")
    require(v_launched["pgd_linf_update"] > 0, "K1 was not launched on the VLMo per-sample path")
    v_out = os.path.join(tmp, "out_vlmo")
    save_artifacts(v_results, v_out)
    for r in v_results:
        for ext in (".pt", ".npy"):
            require(os.path.exists(os.path.join(v_out, r.qid + ext)), f"artifact {r.qid}{ext}")
    require(os.path.exists(os.path.join(v_out, "adv_txt_dict.json")), "VLMo adversarial text")

    with Phase(f"VLMo batched path: {len(VLMO_BATCH_SAMPLES)} samples, --pipeline vlmo "
               f"--batch-size {BATCH_SIZE} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl(v_batch_args.attn):
            vb_results, vb_launched, vb_expected, _ = run_vlmo_batched_path(
                v_pipe, v_cfg, paths, v_batch_args)
    require(sorted({r.old_alg for r in vb_results}) == [0, 1], "both VLMo PGD paths must run")
    for k, n in vb_launched.items():
        require(n == vb_expected[k], f"VLMo batched {k}: {n} launches, the schedules imply "
                                     f"{vb_expected[k]}")
        require((n == 0) == (k.startswith("residual_layernorm") or "_bf16" in k
                             or k.endswith("hd34") or k in TRAINING_ONLY),
                f"VLMo batched {k}: {n} launches (K2, bf16 and head-dim-34 instances none, "
                f"every other kernel some)")

    with Phase("one VLMo gradient step at batch 16: --attn flash against --attn xla"):
        v_ab = vlmo_one_step_ab(v_pipe, v_cfg, tokenizer, gen)
    with Phase(f"attack zoo: seven attacks against the VLMo-VQA victim, B {ZOO_B}, "
               f"--attn flash") as ph:
        zoo, z_launched, z_expected = zoo_phase(v_pipe, v_cfg, tokenizer)
    check_launches(z_launched, z_expected, {"flash_attention_fwd", "flash_attention_bwd",
                                            "flash_attention_fwd_key_bias",
                                            "flash_attention_bwd_key_bias"}, "zoo")
    zoo["phase_s"] = round(ph.seconds, 2)
    print(json.dumps({"zoo": zoo, "launches": z_launched, "card": smi}), flush=True)

    # ------------------------------------------------ VLMo, --dtype bfloat16
    with Phase("VLMo bf16 pipeline (the same random full-width weights)"):
        _, v_cfg16, v_pipe16 = build_pipelines(v_common + bf16_flags, tokenizer)
    require(v_cfg16.compute_dtype == "bfloat16" and v_pipe16._rel_biases.dtype == torch.float32,
            "the VLMo bf16 config and its float32 bias terms")
    with Phase("K3-bf16 with both terms against its plain versions (VLMo shapes)"):
        kb16_rows = check_flash_attention_bf16_key_bias(v_pipe16, tokenizer, gen)
    with Phase("K3-bf16 on a row masked whole by a finite -1e9 against its plain versions and "
               "autograd of the softmax"):
        masked16 = check_masked_rows(v_pipe16, tokenizer, gen, BF16)
        masked16_truth = check_masked_row_truth(v_pipe16, tokenizer, gen, BF16)
    with Phase("VLMo drift at full width: float32 against bf16, a MAR and a feature sample"):
        v_drift = drift_check((v_pipe, v_pipe16), (v_cfg, v_cfg16), VLMO_SAMPLES, True, "VLMo")
    del v_pipe
    torch.cuda.empty_cache()
    # the victim is a bf16 module too: every K3 launch is the bf16 two-term one
    vlmo16 = {"pgd_linf_update", "flash_attention_bf16_fwd", "flash_attention_bf16_bwd",
              "flash_attention_bf16_fwd_key_bias", "flash_attention_bf16_bwd_key_bias"}
    with Phase("VLMo bf16 per-sample path: 1 sample, --dtype bfloat16 --attn flash"):
        with attention.attention_impl("flash"):
            _, vs16_launched, vs16_expected = run_vlmo_main_path(v_pipe16, v_cfg16, paths,
                                                                 VLMO_SAMPLES[:1])
    check_launches(vs16_launched, vs16_expected, vlmo16, "VLMo bf16 per-sample")
    with Phase(f"VLMo bf16 batched path: {len(VLMO_BATCH_SAMPLES)} samples, --dtype bfloat16 "
               f"--batch-size {BATCH_SIZE} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl("flash"):
            _, vb16_launched, vb16_expected, _ = run_vlmo_batched_path(
                v_pipe16, v_cfg16, paths,
                port_run.build_argparser().parse_args(v_common + bf16_flags + batch_flags))
    check_launches(vb16_launched, vb16_expected, vlmo16, "VLMo bf16 batched")
    with Phase(f"VLMo bf16 through run.main: {len(VLMO_BATCH_SAMPLES)} samples, --dtype "
               f"bfloat16 --batch-size {BATCH_SIZE} --attn flash --pipeline-depth "
               f"{PIPELINE_DEPTH}"):
        vm16_launched, vm16_expected, _ = run_main_bf16(
            v_common, bf16_flags + batch_flags, VLMO_BATCH_SAMPLES, 800, v_cfg16.vlmo.image_size,
            vlmo_implied_launches, "bfloat16", "vlmo", tmp)
    check_launches(vm16_launched, vm16_expected, vlmo16, "VLMo bf16 run.main")
    with Phase("one VLMo bf16 gradient step at batch 16: --attn flash against --attn xla"):
        v_ab16 = vlmo_one_step_ab(v_pipe16, v_cfg16, tokenizer, gen)
    del v_pipe16
    torch.cuda.empty_cache()

    # --------------------------------- VLMo-base+, head dim 34, --attn flash
    plus = ["--named-config", BASE_PLUS]
    with Phase("VLMo-base+ pipeline (random full-width weights)"):
        _, p_cfg, p_pipe = build_pipelines(v_common + plus, tokenizer)
    pc = p_cfg.vlmo
    require(pc.image_size == 480 and pc.depth == 24 and pc.num_heads == PLUS_HEADS
            and pc.hidden_size == PLUS_HEADS * PLUS_HEAD_DIM and pc.vlffn_start_layer == 21
            and pc.use_abs_pos_emb and not pc.need_relative_position_embed
            and pc.layer_scale_init is None and pc.max_text_len + pc.image_seq_len == 941
            and p_cfg.attack == v_cfg.attack and p_pipe._rel_biases is None,
            "not the full-width VLMo-base+ attack config")
    with Phase("K3 at head dim 34 against its plain versions (VLMo-base+ shapes)"):
        hd34_rows = check_flash_attention_hd34(p_pipe, tokenizer, gen)
    with Phase("VLMo-base+ model: flash (K3 at head dim 34) against product + softmax"):
        check_vlmo_model_flash(p_pipe, tokenizer, gen)
    with Phase("VLMo-base+ per-sample path: 2 samples, --attn flash"):
        with attention.attention_impl("flash"):
            p_results, p_launched, p_expected = run_vlmo_main_path(p_pipe, p_cfg, paths)
    require(sorted(r.old_alg for r in p_results) == [0, 1], "both base+ PGD paths must run")
    check_plus_launches(p_launched, p_expected, "float32", "VLMo-base+ per-sample")
    with Phase(f"VLMo-base+ batched path: {len(VLMO_BATCH_SAMPLES)} samples, --batch-size "
               f"{BATCH_SIZE} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl("flash"):
            _, pb_launched, pb_expected, _ = run_vlmo_batched_path(
                p_pipe, p_cfg, paths,
                port_run.build_argparser().parse_args(v_common + plus + batch_flags))
    check_plus_launches(pb_launched, pb_expected, "float32", "VLMo-base+ batched")
    with Phase("one VLMo-base+ gradient step at batch 16: --attn flash against --attn xla"):
        p_ab = vlmo_one_step_ab(p_pipe, p_cfg, tokenizer, gen)
    del p_pipe
    torch.cuda.empty_cache()
    with Phase("VLMo-base+ bf16 pipeline (the same random full-width weights)"):
        _, p_cfg16, p_pipe16 = build_pipelines(v_common + plus + bf16_flags, tokenizer)
    require(p_cfg16.compute_dtype == "bfloat16", "the VLMo-base+ bf16 config")
    with Phase(f"VLMo-base+ bf16 batched path: {len(VLMO_BATCH_SAMPLES)} samples, --dtype "
               f"bfloat16 --batch-size {BATCH_SIZE} --attn flash --pipeline-depth "
               f"{PIPELINE_DEPTH}"):
        with attention.attention_impl("flash"):
            _, pb16_launched, pb16_expected, _ = run_vlmo_batched_path(
                p_pipe16, p_cfg16, paths,
                port_run.build_argparser().parse_args(v_common + plus + bf16_flags + batch_flags))
    check_plus_launches(pb16_launched, pb16_expected, "bfloat16", "VLMo-base+ bf16 batched")
    with Phase("one VLMo-base+ bf16 gradient step at batch 16: --attn flash against --attn xla"):
        p_ab16 = vlmo_one_step_ab(p_pipe16, p_cfg16, tokenizer, gen)
    del p_pipe16
    torch.cuda.empty_cache()

    # ------------------------------------------ ViLT-B/32, --attn flash
    vilt_common = v_common + ["--config", vilt_config_path(tmp)]
    vilt_flags = ["--batch-size", str(VILT_BATCH), "--attn", "flash",
                  "--pipeline-depth", str(PIPELINE_DEPTH)]
    with Phase("ViLT-B/32 pipeline (random full-width weights)"):
        _, t_cfg, t_pipe = build_pipelines(vilt_common, tokenizer)
    tc = t_cfg.vlmo
    require(not tc.moe and tc.image_size == 384 and tc.patch_size == 32 and tc.depth == 12
            and tc.hidden_size == HEADS * HEAD_DIM and tc.num_heads == HEADS
            and tc.image_seq_len + tc.max_text_len == VILT_TOKENS and tc.use_abs_pos_emb
            and t_pipe._rel_biases is None and t_cfg.attack == v_cfg.attack
            and not hasattr(t_pipe.model.blocks[0], "mlp_text"), "not the full-width ViLT config")
    with Phase(f"K3 at ViLT's [B, {VILT_TOKENS}, 12, 64] with the key bias against its plain "
               f"versions, both dtypes"):
        vilt_rows = check_flash_attention_vilt(t_pipe, tokenizer, gen)
    with Phase(f"ViLT batched path: {len(VILT_BATCH_SAMPLES)} samples, --batch-size "
               f"{VILT_BATCH} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl("flash"):
            _, tb_launched, tb_expected, tb_s = run_vilt_batched_path(
                t_pipe, t_cfg, paths, port_run.build_argparser().parse_args(
                    vilt_common + vilt_flags))
    vilt32 = {"pgd_linf_update", "flash_attention_fwd", "flash_attention_bwd",
              "flash_attention_fwd_key_bias", "flash_attention_bwd_key_bias"}
    check_launches(tb_launched, tb_expected, vilt32, "ViLT batched")
    del t_pipe
    torch.cuda.empty_cache()
    with Phase("ViLT bf16 pipeline (the same random full-width weights)"):
        _, t_cfg16, t_pipe16 = build_pipelines(vilt_common + bf16_flags, tokenizer)
    require(t_cfg16.compute_dtype == "bfloat16", "the ViLT bf16 config")
    with Phase(f"ViLT bf16 batched path: {len(VILT_BATCH_SAMPLES)} samples, --dtype bfloat16 "
               f"--batch-size {VILT_BATCH} --attn flash --pipeline-depth {PIPELINE_DEPTH}"):
        with attention.attention_impl("flash"):
            _, tb16_launched, tb16_expected, tb16_s = run_vilt_batched_path(
                t_pipe16, t_cfg16, paths, port_run.build_argparser().parse_args(
                    vilt_common + bf16_flags + vilt_flags))
    check_launches(tb16_launched, tb16_expected, vlmo16, "ViLT bf16 batched")
    del t_pipe16
    torch.cuda.empty_cache()

    # ------------------------------------------ training: VQA fine-tuning
    with Phase(f"vlmo_vqa training at full width: batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, "
               f"--attn flash then xla, then a resume"):
        t_vlmo, t_vlmo_launched = train_vlmo(tmp, paths["vocab"], tokenizer, smi)
    with Phase(f"albef_vqa training at full width: batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, "
               f"--attn flash"):
        t_albef, t_albef_launched = train_albef(tmp, paths["vocab"], gen, smi)

    # ------------------------------------------ pretraining: ALBEF and VLMo
    with Phase("K2 and K3 against their plain versions at the pretraining shapes (ALBEF at "
               "256 px, VLMo-base+ at head dim 34, dbias at head dim 34 and 64), timed"):
        pre_rows, hd34_dbias_rows = check_pretrain_kernels(gen, tokenizer)
    with Phase(f"pretraining at full width: albef_pretrain (256 px), vlmo_pretrain and "
               f"vlmo_textmlm (base+ and base), batch {TRAIN_BATCH}, {TRAIN_STEPS} steps"):
        t_pre, pre_launched, pre_seen = train_pretrain(tmp, paths["vocab"], tokenizer, smi)

    # ------------------------------- downstream fine-tuning: ALBEF and VLMo
    with Phase("K2, K3 and dbias against their plain versions at the fine-tuning shapes "
               "(ALBEF at 384 px: [8 and 16, 577]; VLMo-base at 384 px: dbias at [24 and 8, "
               "617]), timed"):
        ft_rows = check_finetune_kernels(gen, tokenizer)
    with Phase(f"downstream fine-tuning at full width: retrieval, ve, nlvr2 (ALBEF at "
               f"{FINETUNE_SIZE} px), vlmo_irtr and vlmo_nlvr2 (VLMo-base at {FINETUNE_SIZE} px), "
               f"batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, --attn flash") as ph:
        t_ft, ft_launched, ft_seen = train_finetune(tmp, paths["vocab"], tokenizer, smi)
    t_ft["phase_s"] = round(ph.seconds, 2)

    # ------------------------------------------------ the checkpoint path
    with Phase(f"checkpoint path: run.main with .pth files, --batch-size {BATCH_SIZE} "
               f"--attn flash --pipeline-depth {PIPELINE_DEPTH}") as ph:
        c_launches, c_loads, c_seconds = checkpoint_path(common, v_common, tmp)
    c_seconds["phase_s"] = round(ph.seconds, 2)
    for which, (launched_c, expected_c) in c_launches.items():
        for k, n in launched_c.items():
            require(n == expected_c[k], f"{which} with checkpoints {k}: {n} launches, the "
                                        f"schedules imply {expected_c[k]}")
            none = "_bf16" in k or k.endswith("hd34") or k in TRAINING_ONLY or (
                k.endswith("key_bias") if which == "albef" else k.startswith("residual"))
            require((n == 0) == none, f"{which} with checkpoints {k}: {n} launches")

    # ------------------------------------------ black-box transfer
    with Phase("transfer_eval: the ALBEF batched artifacts against ALBEF-VQA, BLIP-VQA, "
               "VLMo-VQA and ViLT, --attn flash; Predictor.answer"):
        transfer = transfer_path(tmp, paths, batched_out, tokenizer, cfg.albef, v_cfg.vlmo)
    shutil.rmtree(tmp, ignore_errors=True)

    # each row's launches: ALBEF's batched runs (K1, K2, K3 without terms;
    # the bf16 rows from the --dtype bfloat16 run), VLMo's for the key-bias
    # rows, VLMo-base+'s for the head-dim-34 rows
    rows += list(bf16_rows) + list(kb_rows) + list(kb16_rows) + hd34_rows
    for row in rows:
        bf16 = "_bf16" in row["name"]
        if row["name"].endswith("hd34"):
            runs = (pb_launched, pb16_launched)
        elif row["name"].endswith("key_bias"):
            runs = (vb_launched, vb16_launched)
        else:
            runs = (b_launched, b16_launched)
        row["launches"] = runs[bf16][row["name"]]
    # the bias gradient's launches: the vlmo_vqa training run's under flash
    dbias_row["launches"] = t_vlmo_launched["flash_attention_bwd_dbias"]
    rows.append(dbias_row)
    # ViLT's rows: its batched runs' key-bias launches of each dtype
    for row in vilt_rows:
        counted = tb16_launched if "_bf16" in row["name"] else tb_launched
        row["launches"] = counted[row["name"].replace("_vilt", "_key_bias")]
    rows += vilt_rows
    # the pretraining rows: each shape's launches in the run that gives it
    by_shape = {
        "flash_attention_fwd_albef257": pre_launched["albef_pretrain"]["flash_attention_fwd"],
        "flash_attention_bwd_albef257": pre_launched["albef_pretrain"]["flash_attention_bwd"],
        "flash_attention_fwd_hd34_itm237": pre_seen[f"{PRETRAIN_PLUS}_flash"].get(
            ("fwd", 3 * TRAIN_BATCH, 237, 34, False, True, False), 0),
        "flash_attention_bwd_hd34_itm237": pre_seen[f"{PRETRAIN_PLUS}_flash"].get(
            ("bwd", 3 * TRAIN_BATCH, 237, 34, False, True, False), 0),
        "flash_attention_bwd_dbias_joint237": pre_seen[f"{PRETRAIN_BASE}_flash"].get(
            ("bwd", TRAIN_BATCH, 237, 64, True, True, True), 0),
        "flash_attention_bwd_dbias_text196": pre_seen[f"{TEXTMLM_BASE}_flash"].get(
            ("bwd", TRAIN_BATCH, 196, 64, True, True, True), 0),
    }
    for row in pre_rows:
        row["launches"] = by_shape[row["name"]]
        require(row["launches"] > 0, f"{row['name']}: no launch on the pretraining path")
    rows += pre_rows
    # K3's dbias at head dim 34 runs on no path (VLMo-base+ has no table)
    for row in hd34_dbias_rows:
        row["launches"] = 0
    # the fine-tuning rows: each shape's launches in the runs that give it
    ft_seq, vc_seq = (FINETUNE_SIZE // 16) ** 2 + 1, (FINETUNE_SIZE // 16) ** 2 + 41
    k3_runs = {"_albef577": (("retrieval", "ve"), TRAIN_BATCH),
               "_nlvr577": (("nlvr2",), 2 * TRAIN_BATCH)}
    for row in ft_rows:
        name = row["name"]
        suffix = name[name.rindex("_"):]
        if name.startswith("flash_attention_bwd_dbias"):
            task, b = {"_irtr617": ("vlmo_irtr", 3 * TRAIN_BATCH),
                       "_nlvr617": ("vlmo_nlvr2", TRAIN_BATCH)}[suffix]
            row["launches"] = ft_seen[task].get(("bwd", b, vc_seq, 64, True, True, True), 0)
        elif name.startswith("flash_attention"):
            tasks, b = k3_runs[suffix]
            key = ("fwd" if "_fwd" in name else "bwd", b, ft_seq, 64, False, False, False)
            row["launches"] = sum(ft_seen[t].get(key, 0) for t in tasks)
        else:  # K2: one ViT shape a run
            counted = name[: -len(suffix)]
            row["launches"] = sum(ft_launched[t][counted] for t in k3_runs[suffix][0])
        require(row["launches"] > 0, f"{name}: no launch on the fine-tuning path")
    rows += ft_rows
    print(json.dumps({"finetuning": t_ft, "finetuning_launches": ft_launched,
                      "k3_launches_by_shape": {
        run: {"/".join(map(str, k)): n for k, n in seen.items()} for run, seen in ft_seen.items()},
        "card": smi}), flush=True)
    print(json.dumps({"pretraining": t_pre, "pretraining_launches": pre_launched,
                      "k3_launches_by_shape": {
        run: {"/".join(map(str, k)): n for k, n in seen.items()} for run, seen in pre_seen.items()},
        "dbias_hd34_not_on_a_path": hd34_dbias_rows, "card": smi}), flush=True)
    print(f"wall: {time.perf_counter() - t_start:.1f} s since start", flush=True)
    print(json.dumps({"kernel_launches": {
        "per_sample": launched, "batched": b_launched,
        "bf16_per_sample": s16_launched, "bf16_batched": b16_launched,
        "bf16_run_main": m16_launched, "vlmo_bf16_run_main": vm16_launched,
        "vlmo_per_sample": v_launched, "vlmo_batched": vb_launched,
        "vlmo_bf16_per_sample": vs16_launched, "vlmo_bf16_batched": vb16_launched,
        "vlmo_base_plus_per_sample": p_launched, "vlmo_base_plus_batched": pb_launched,
        "vlmo_base_plus_bf16_batched": pb16_launched,
        "vilt_batched": tb_launched, "vilt_bf16_batched": tb16_launched,
        "albef_checkpoints": c_launches["albef"][0],
        "vlmo_checkpoints": c_launches["vlmo"][0]}}), flush=True)
    print(json.dumps({"checkpoint_loads": c_loads, "checkpoint_phase": c_seconds,
                      "card": smi}), flush=True)
    print(json.dumps({"bf16_drift": {"albef": drift, "vlmo": v_drift}, "card": smi}), flush=True)
    print(json.dumps({"attn_ab_batch16": ab, "vlmo_attn_ab_batch16": v_ab,
                      "bf16_attn_ab_batch16": ab16, "vlmo_bf16_attn_ab_batch16": v_ab16,
                      "vlmo_base_plus_attn_ab_batch16": p_ab,
                      "vlmo_base_plus_bf16_attn_ab_batch16": p_ab16, "card": smi}), flush=True)
    print(json.dumps({"flash_attention_batch16": flash_b16}), flush=True)
    print(json.dumps({"training": {"vlmo_vqa": t_vlmo, "albef_vqa": t_albef},
                      "training_launches": {"vlmo_vqa_flash": t_vlmo_launched,
                                            "albef_vqa_flash": t_albef_launched},
                      "bf16_masked_row": masked16, "card": smi}), flush=True)
    print(json.dumps({"transfer": transfer, "vilt_batched": {
        "float32_s": round(tb_s, 2), "bfloat16_s": round(tb16_s, 2),
        "samples": len(VILT_BATCH_SAMPLES), "iterations": t_cfg.attack.num_iters,
        "float32_sample_iters_per_s": t_cfg.attack.num_iters * len(VILT_BATCH_SAMPLES) / tb_s,
        "bfloat16_sample_iters_per_s": t_cfg.attack.num_iters * len(VILT_BATCH_SAMPLES) / tb16_s},
        "masked_row_truth": {"float32": masked32_truth, "bfloat16": masked16_truth},
        "card": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
