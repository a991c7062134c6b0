#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line on entry and its seconds on exit):

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels, one ``nvcc`` call (``vqattack_tpu_torch/ops/_build.py``);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes both paths give it (batch 1, the batched chunks of 4 and 8, the
   victim's 16), with the stated tolerances: K1 (PGD update), K2 (residual +
   LayerNorm, forward and backward) and K3 (flash attention on the tensor
   cores in three TF32 passes, forward and backward, ragged and bias cases);
   times and bounds at the batched chunk of 8, and K3's also at 16, beside
   ``scaled_dot_product_attention``;
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

Before phases 5, 6, 10, 11 and each run of 13 the kernels' launch counts
are reset, and after each they must equal what the samples' schedules
imply.  Prints the kernel table as one JSON line, the checkpoint loads'
seconds beside the card's name and power limit, the card's name and power
limit, then, as the last line, ``{"ok": true, "device": {...}}``.  Exits
non-zero, without those lines, when there is no CUDA device or any check
fails.  Needs torch, numpy and scipy (the relative table's resize).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
from vqattack_tpu_torch.attacks import batched  # noqa: E402
from vqattack_tpu_torch.attacks.orchestrator import save_artifacts  # noqa: E402
from vqattack_tpu_torch.attacks.pgd import pgd_feature  # noqa: E402
from vqattack_tpu_torch.data.side_tables import SideTables  # noqa: E402
from vqattack_tpu_torch.models.albef import AlbefPretrain  # noqa: E402
from vqattack_tpu_torch.models.layers import mask_to_key_bias  # noqa: E402
from vqattack_tpu_torch.ops import _build, attention, fused_ln, pgd_update  # noqa: E402
from vqattack_tpu_torch.rng import TorchKey  # noqa: E402
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
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
# the kernel's row tile)
LN_ROWS = (901, 1000, 4 * 901, TIMED_BATCH * 901, 16 * 901)


def check_fused_ln(gen):
    fwd_row = bwd_row = None
    for rows in LN_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            x, delta, gamma, beta, gs, gh = _ln_case(gen, rows, dtype)
            s, h = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)
            s_r, h_r = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
            torch.cuda.synchronize()
            require(torch.equal(s, s_r), f"residual sum differs at rows={rows} {dtype}")
            h_err = _close(f"h rows={rows} {dtype}", h, h_r, dtype)

            dx, dg, db = fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6)
            dx2, dg2, db2 = fused_ln.residual_layernorm_bwd(s, gs, gh, gamma, 1e-6)
            dx_r, dg_r, db_r = fused_ln.residual_layernorm_bwd_reference(s, gs, gh, gamma, 1e-6)
            torch.cuda.synchronize()
            dx_err = _close(f"dx rows={rows} {dtype}", dx, dx_r, dtype)
            require(torch.equal(dg, dg2) and torch.equal(db, db2) and torch.equal(dx, dx2),
                    f"backward not deterministic at rows={rows} {dtype}")
            # dgamma/dbeta: sums over rows taken in another order than
            # torch.sum; bound 1e-5 x the sum of the terms' magnitudes
            sf = s.float()
            xhat = (sf - sf.mean(-1, keepdim=True)) * torch.rsqrt(
                sf.var(-1, unbiased=False, keepdim=True) + 1e-6)
            mag_g = (gh.float() * xhat).abs().sum(0)
            mag_b = gh.float().abs().sum(0)
            require(bool(((dg - dg_r).abs() <= 1e-5 * mag_g + 1e-6).all()),
                    f"dgamma outside tolerance at rows={rows} {dtype}")
            require(bool(((db - db_r).abs() <= 1e-5 * mag_b + 1e-6).all()),
                    f"dbeta outside tolerance at rows={rows} {dtype}")
            print(f"  residual_layernorm rows={rows} {str(dtype)[6:]}: s bit-exact, "
                  f"h err {h_err:.3g}, dx err {dx_err:.3g}, "
                  f"dgamma err {float((dg - dg_r).abs().max()):.3g}, deterministic", flush=True)
            if rows == TIMED_BATCH * 901 and dtype == torch.float32:
                fwd_row = _time_fwd(x, delta, gamma, beta, rows, max(h_err, 0.0))
                bwd_row = _time_bwd(x, delta, gamma, beta, s, gs, gh, rows, dx_err)
    for rows in (901, TIMED_BATCH * 901):
        _check_autograd(gen, rows)
    return fwd_row, bwd_row


def _time_fwd(x, delta, gamma, beta, rows, err):
    n = rows * D
    b, by = bound_ms(4 * n * 4 + 2 * D * 4, 8 * n)  # read x, delta; write s, h
    row = {
        "name": "residual_layernorm_fwd", "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/fused_ln.cu",
        "replaces": "vqattack_tpu/ops/fused_ln.py:135",
        "shape": [rows, D],
        "max_abs_err": err,
        "ms": time_ms(lambda: fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)),
        "plain_ms": time_ms(
            lambda: fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.layer_norm(x + delta, (D,), gamma, beta, 1e-6)),
    }
    print(f"  residual_layernorm_fwd [{rows}, {D}] f32: {row['ms'] * 1e3:.1f} us (plain "
          f"{row['plain_ms'] * 1e3:.1f} us, layer_norm(x + delta) "
          f"{row['library_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    return row


def _time_bwd(x, delta, gamma, beta, s, gs, gh, rows, err):
    # the main path's backward: frozen parameters, so no dgamma/dbeta; the
    # library's: autograd through s = x + delta, h = layer_norm(s), the same
    # dx = gs + LayerNorm's backward of gh (its host enqueue can outlast the
    # default hold of the stream, so the hold is longer)
    n = rows * D
    b, by = bound_ms(4 * n * 4 + D * 4, 12 * n)  # read s, gs, gh; write dx
    x_leaf = x.detach().clone().requires_grad_(True)
    s_l = x_leaf + delta
    h_l = torch.nn.functional.layer_norm(s_l, (D,), gamma, beta, 1e-6)
    row = {
        "name": "residual_layernorm_bwd", "route": "cuda",
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
    print(f"  residual_layernorm_bwd [{rows}, {D}] f32: {row['ms'] * 1e3:.1f} us (plain "
          f"{row['plain_ms'] * 1e3:.1f} us, autograd of layer_norm(x + delta) "
          f"{row['library_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    return row


def _check_autograd(gen, rows):
    """The autograd Function against autograd through the plain version."""
    x, delta, gamma, beta, _, _ = _ln_case(gen, rows, torch.float32)
    w_s = torch.randn(rows, D, generator=gen, device="cuda")
    w_h = torch.randn(rows, D, generator=gen, device="cuda")
    grads = []
    for fn in (fused_ln.residual_layernorm, fused_ln.residual_layernorm_reference):
        xs = [t.clone().requires_grad_(True) for t in (x, delta, gamma, beta)]
        s, h = fn(*xs, 1e-6)
        grads.append(torch.autograd.grad((s * w_s).sum() + (h * w_h).sum(), xs))
    for name, a, b in zip(("dx", "ddelta", "dgamma", "dbeta"), *grads):
        # float32 reassociation: 1e-4 of the largest magnitude (at least 1)
        err = float((a - b).abs().max())
        require(err <= 1e-4 * max(1.0, float(b.abs().max())),
                f"autograd {name}: max abs err {err}")
    print(f"  residual_layernorm autograd Function matches autograd of the plain version "
          f"at rows={rows}", flush=True)


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


def time_flash_attention(gen, errs, b):
    """Device times at ``[b, 901, 12, 64]``, float32, no bias: the kernels,
    the plain versions and ``scaled_dot_product_attention`` (forward;
    backward through autograd).  The forward is also held against its plain
    version at this shape.  The bound is the tensor cores' in three TF32
    passes (``tensor_core_bound_ms``) over the operations the function needs
    (4 and 10 x B*H*S^2*Dh); ``executed_tflops`` counts what the kernels
    execute (the dQ pass recomputes S and dO V^T: 14x in the backward), to
    hold against the 67 TFLOP/s of float32 outside the tensor cores."""
    s = 901
    q, k, v = _qkv(gen, b, s)
    o, lse = attention.flash_attention_fwd(q, k, v, None, SCALE)
    _attn_err(f"o at batch {b}", o, attention.flash_attention_reference(q, k, v, None, SCALE))
    do = torch.randn(o.shape, generator=gen, device="cuda")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=SCALE)
    do_t = do.transpose(1, 2)
    unit = b * HEADS * s * s * HEAD_DIM
    row = b * s * HEADS * HEAD_DIM * 4  # bytes of one [B, S, H, 64] float32 tensor
    lse_bytes = b * HEADS * s * 4
    long_sleep = 20_000_000  # the plain versions enqueue for several ms
    fwd_b, fwd_by = tensor_core_bound_ms(4 * row + lse_bytes, 4 * unit)
    bwd_b, bwd_by = tensor_core_bound_ms(8 * row + lse_bytes, 10 * unit)
    fwd = {
        "name": "flash_attention_fwd", "route": "cuda",
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
        "name": "flash_attention_bwd", "route": "cuda",
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
    everything = SAMPLES + BATCH_SAMPLES + VLMO_SAMPLES + VLMO_BATCH_SAMPLES
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


# each kernel's row name -> (wrapper, its count); the two key-bias rows
# count K3's launches with a key bias, VLMo's two-term form
KERNELS = {
    "pgd_linf_update": (pgd_update.pgd_linf_update, "launches"),
    "residual_layernorm_fwd": (fused_ln.residual_layernorm_fwd, "launches"),
    "residual_layernorm_bwd": (fused_ln.residual_layernorm_bwd, "launches"),
    "flash_attention_fwd": (attention.flash_attention_fwd, "launches"),
    "flash_attention_bwd": (attention.flash_attention_bwd, "launches"),
    "flash_attention_fwd_key_bias": (attention.flash_attention_fwd, "key_bias_launches"),
    "flash_attention_bwd_key_bias": (attention.flash_attention_bwd, "key_bias_launches"),
}


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def implied_launches(cfg, vit_fwd: int, vit_bwd: int, k1: int, flash: bool) -> dict:
    """Launches that ``vit_fwd`` ViT forwards, ``vit_bwd`` ViT backwards and
    ``k1`` L-inf updates imply: each forward runs 2 x depth fused
    residual+LayerNorm sites (K2) and, with ``--attn flash``, depth
    attentions (K3, no key bias); each backward as many backward kernels."""
    depth = cfg.albef.vit.depth
    attn = depth if flash else 0
    return {
        "pgd_linf_update": k1,
        "residual_layernorm_fwd": 2 * depth * vit_fwd,
        "residual_layernorm_bwd": 2 * depth * vit_bwd,
        "flash_attention_fwd": attn * vit_fwd,
        "flash_attention_bwd": attn * vit_bwd,
        "flash_attention_fwd_key_bias": 0,
        "flash_attention_bwd_key_bias": 0,
    }


def vlmo_implied_launches(cfg, fwd: int, bwd: int, k1: int, flash: bool) -> dict:
    """Launches that ``fwd`` joint VLMo forwards, ``bwd`` backwards and
    ``k1`` L-inf updates imply: with ``--attn flash`` each forward runs
    depth attentions over 941 tokens, each with the relative-position table
    and the text mask (K3 with a key bias), each backward as many; VLMo's
    LayerNorms are plain (no K2)."""
    attn = cfg.vlmo.depth if flash else 0
    return {
        "pgd_linf_update": k1,
        "residual_layernorm_fwd": 0,
        "residual_layernorm_bwd": 0,
        "flash_attention_fwd": attn * fwd,
        "flash_attention_bwd": attn * bwd,
        "flash_attention_fwd_key_bias": attn * fwd,
        "flash_attention_bwd_key_bias": attn * bwd,
    }


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


def run_main_path(pipe, cfg, tokenizer, paths, answer_max_len):
    """Attack every sample of SAMPLES one at a time and check the victim on
    the result; returns ``(results, launches, expected launches)`` with the
    launch counts reset just before and read just after."""
    side = SideTables.load([paths["right"]], [paths["sur"]], [paths["tgt"]],
                           [paths["para"]], [paths["allc"]])
    answer_list, answer_ids, answer_mask = load_answers(paths, tokenizer, answer_max_len,
                                                        pipe.device)
    atk = cfg.attack
    size = cfg.albef.vit.image_size
    flash = attention.get_impl() == "flash"
    results, expected = [], {k: 0 for k in KERNELS}
    reset_counts()
    for i, (qid, question, _, _) in enumerate(SAMPLES):
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
        for k, v in implied_launches(cfg, fwd + 1, bwd, k1, flash).items():  # + victim
            expected[k] += v
        results.append(res)
        n_grads = len(res.feat_losses) + (0 if res.mlm_losses is None else len(res.mlm_losses))
        print(f"  sample {qid}: old_alg={res.old_alg} blocks={res.num_blocks} "
              f"vl_steps={res.vl_steps} grad steps={n_grads} adv_text={res.adv_text!r} "
              f"victim top1={answer_list[int(topk_ids[0, 0])]!r} {dt:.2f} s/sample",
              flush=True)
    return results, counts(), expected


def run_batched_path(engine, cfg, paths, args, sample_list, pixel_base, size, victim,
                     implied):
    """The lockstep sweep over ``sample_list`` as ``run.py`` flushes a
    buffer (``engine.run``, then ``victim(results) -> top-1 answers`` in
    chunks of 16), with the phase timer on (the engine prints its
    breakdown); returns ``(results, launches, expected launches, seconds)``
    with the launch counts reset just before and read just after.
    ``implied(cfg, fwd, bwd, k1, flash)`` gives the launches a schedule
    implies."""
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
    require(engine.last_chunk_sizes == [8, 4], f"chunks {engine.last_chunk_sizes}")
    expected = implied(cfg, n_victim, 0, 0, True)
    for old_alg, extra in ((0, len(mixed_calls)), (1, 0)):
        # one chunk per bucket: its real rows share one schedule
        res = next(r for r in results if r.old_alg == old_alg)
        for k, v in implied(cfg, *schedule_passes(res, extra), True).items():
            expected[k] += v
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
    questions = [q for _, q, _, _ in VLMO_BATCH_SAMPLES]
    _, mask = tokenizer.encode_batch([questions[i % len(questions)] for i in range(b)],
                                     pipe.max_text_len)
    co = torch.cat([torch.as_tensor(mask, device="cuda"),
                    torch.ones(b, seq - pipe.max_text_len, dtype=torch.int32, device="cuda")], 1)
    key_bias = mask_to_key_bias(co)
    return q, k, v, pipe._rel_biases[layer][None], key_bias


def _check_two_term_case(q, k, v, table, key_bias, what):
    o, lse = attention.flash_attention_fwd(q, k, v, table, SCALE, key_bias)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, table, SCALE, return_lse=True,
                                                     key_bias=key_bias)
    do = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, table, SCALE, o, lse, do, key_bias)
    again = attention.flash_attention_bwd(q, k, v, table, SCALE, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, table, SCALE, o, lse, do, key_bias)
    torch.cuda.synchronize()
    errs = {"o": _attn_err("o", o, o_r), "lse": _attn_err("lse", lse, lse_r)}
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        require(torch.equal(g, g2), f"two-term flash backward {name} differs between two runs")
        errs[name] = _attn_err(name, g, r)
    print(f"  flash_attention {list(q.shape)} table + key bias ({what}): "
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
    lse_bytes = b * HEADS * s * 4
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


def check_vlmo_model_flash(pipe, tokenizer, gen):
    """One feature-loss gradient step of the full-width VLMo surrogate at
    batch 2: its features and d/dpixels under ``attention_impl("flash")``
    (all 12 joint attentions through K3 with both terms) against the
    product + softmax path.  Tolerance: 1e-4 of each tensor's largest
    magnitude (float32 reassociation over 12 blocks)."""
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
        for name in ("flash_attention_fwd_key_bias", "flash_attention_bwd_key_bias"):
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


def run_vlmo_main_path(pipe, cfg, paths):
    """The per-sample VLMo attack over VLMO_SAMPLES and the victim's
    classifier on each result; returns ``(results, launches, expected
    launches)`` with the counts reset just before and read just after."""
    side = SideTables.load([paths["right"]], [paths["sur"]], [paths["tgt"]],
                           [paths["para"]], [paths["allc"]])
    size = cfg.vlmo.image_size
    flash = attention.get_impl() == "flash"
    results, expected = [], {k: 0 for k in KERNELS}
    reset_counts()
    for i, (qid, question, _, _) in enumerate(VLMO_SAMPLES):
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
        for k, v in vlmo_implied_launches(cfg, fwd + 1, bwd, k1, flash).items():  # + victim
            expected[k] += v
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
                           vlmo_implied_launches)
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


def run_main_with_checkpoints(argv, sample_list, pixel_base, size, implied):
    """``run.main(argv)`` over ``sample_list`` (its images served by name:
    the card's machine has no PIL to decode JPEGs), the launch counts reset
    just before and read just after; returns ``(summary, record, launches,
    expected launches, seconds)``.  The schedules imply the launches as in
    the batched phases: one chunk per bucket, plus the victim's calls."""
    from vqattack_tpu_torch.data.vqa import VQADataset

    pixels = {f"{qid}.jpg": sample_pixels(pixel_base + i, size)
              for i, (qid, *_) in enumerate(sample_list)}
    load_pixels = VQADataset._load_pixels
    VQADataset._load_pixels = lambda self, name: pixels[name]
    try:
        with record_main() as rec:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = port_run.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = counts()
    finally:
        VQADataset._load_pixels = load_pixels
    results, cfg, engine = rec["results"], rec["pipe"].cfg, rec["engine"]
    require(summary["samples"] == len(sample_list) == len(results), "samples attacked")
    require(engine.last_chunk_sizes == [8, 4], f"chunks {engine.last_chunk_sizes}")
    require(sorted({r.old_alg for r in results}) == [0, 1], "both PGD paths must run")
    for r, (qid, *_) in zip(results, sample_list):
        require(r.qid == str(qid), "results not in qid order")
        check_result(r, pixels[f"{qid}.jpg"], cfg.attack, size)
    expected = implied(cfg, rec["victim_calls"], 0, 0, True)
    for old_alg, extra in ((0, len(rec["mixed"])), (1, 0)):
        res = next(r for r in results if r.old_alg == old_alg)
        for k, v in implied(cfg, *schedule_passes(res, extra), True).items():
            expected[k] += v
    return summary, rec, launched, expected, seconds


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
    summary, rec, a_launched, a_expected, a_s = run_main_with_checkpoints(
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
    summary, rec, v_launched, v_expected, v_s = run_main_with_checkpoints(
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

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with Phase("kernels against their plain versions"):
        flash_rows, flash_b16 = check_flash_attention(gen)
        rows = [check_pgd_update(gen), *check_fused_ln(gen), *flash_rows]

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
        require(n > 0 or k.startswith("flash"), f"{k} was not launched on the per-sample path")
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
        require(n > 0 or k.endswith("key_bias"), f"{k} was not launched on the batched path")
        require(n == b_expected[k], f"batched {k}: {n} launches, the schedules imply "
                                    f"{b_expected[k]}")

    with Phase("one gradient step at batch 16: --attn flash against --attn xla"):
        ab = one_step_ab(pipe, cfg, tokenizer, gen)
    del pipe
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
        require((n == 0) == k.startswith("residual_layernorm"),
                f"VLMo batched {k}: {n} launches (K2 none, every other kernel some)")

    with Phase("one VLMo gradient step at batch 16: --attn flash against --attn xla"):
        v_ab = vlmo_one_step_ab(v_pipe, v_cfg, tokenizer, gen)
    del v_pipe
    torch.cuda.empty_cache()

    # ------------------------------------------------ the checkpoint path
    with Phase(f"checkpoint path: run.main with .pth files, --batch-size {BATCH_SIZE} "
               f"--attn flash --pipeline-depth {PIPELINE_DEPTH}") as ph:
        c_launches, c_loads, c_seconds = checkpoint_path(common, v_common, tmp)
    c_seconds["phase_s"] = round(ph.seconds, 2)
    for which, (launched_c, expected_c) in c_launches.items():
        for k, n in launched_c.items():
            require(n == expected_c[k], f"{which} with checkpoints {k}: {n} launches, the "
                                        f"schedules imply {expected_c[k]}")
            none = k.endswith("key_bias") if which == "albef" else k.startswith("residual")
            require((n == 0) == none, f"{which} with checkpoints {k}: {n} launches")
    shutil.rmtree(tmp, ignore_errors=True)

    for row in rows:
        row["launches"] = b_launched[row["name"]]
    for row in kb_rows:
        row["launches"] = vb_launched[row["name"]]
    rows += list(kb_rows)
    print(f"wall: {time.perf_counter() - t_start:.1f} s since start", flush=True)
    print(json.dumps({"kernel_launches": {
        "per_sample": launched, "batched": b_launched,
        "vlmo_per_sample": v_launched, "vlmo_batched": vb_launched,
        "albef_checkpoints": c_launches["albef"][0],
        "vlmo_checkpoints": c_launches["vlmo"][0]}}), flush=True)
    print(json.dumps({"checkpoint_loads": c_loads, "checkpoint_phase": c_seconds,
                      "card": smi}), flush=True)
    print(json.dumps({"attn_ab_batch16": ab, "vlmo_attn_ab_batch16": v_ab}), flush=True)
    print(json.dumps({"flash_attention_batch16": flash_b16}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
