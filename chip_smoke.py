#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line on entry and its seconds on exit):

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels, one ``nvcc`` call (``vqattack_tpu_torch/ops/_build.py``);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with times, bounds and the stated tolerances;
4. model: the full-width surrogate with the fused kernels against the same
   weights through plain LayerNorms, forward features and d/dpixels;
5. main path: the per-sample ALBEF attack at full width (ViT-B/16 at 480 px,
   12-layer fusion BERT, 40 PGD iterations) on two synthetic samples, one
   on the alternating (MAR) path and one feature-only, each with the text
   attack, the victim's ``rank_answer`` and the artifacts, written to a
   temporary directory.  The kernels' launch counts are reset just before
   and read just after, and must equal what the samples' schedules imply.

Prints the kernel table as one JSON line, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero, without those lines,
when there is no CUDA device or any check fails.  Needs torch and numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vqattack_tpu_torch import run as port_run  # noqa: E402
from vqattack_tpu_torch.attacks.orchestrator import save_artifacts  # noqa: E402
from vqattack_tpu_torch.data.side_tables import SideTables  # noqa: E402
from vqattack_tpu_torch.models.albef import AlbefPretrain  # noqa: E402
from vqattack_tpu_torch.ops import _build, fused_ln, pgd_update  # noqa: E402
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
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


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms by CUDA events.  Before every call
    the 50 MB L2 is emptied of the inputs by reading a 64 MB buffer (a read
    leaves clean lines, so the timed call pays no write-back), and the
    stream is held busy for ~0.5 ms, so that the host has enqueued all of
    ``fn``'s launches before the start event runs: the interval is device
    time, not the wrapper's Python."""
    flush = torch.ones(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.sum()
        torch.cuda._sleep(1_000_000)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_pgd_update(gen) -> dict:
    shape = (1, 3, 480, 480)
    ori = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    adv = (ori + (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 0.25).clamp(-1, 1)
    grad = torch.randn(shape, generator=gen, device="cuda")
    grad[torch.rand(shape, generator=gen, device="cuda") < 0.01] = 0.0  # sign(0) = 0
    args = (adv, grad, ori, 0.125, 0.01, -1.0, 1.0)
    out = pgd_update.pgd_linf_update(*args)
    ref = pgd_update.pgd_linf_update_reference(*args)
    torch.cuda.synchronize()
    # tolerance: none, the kernel repeats the plain chain's IEEE operations
    require(torch.equal(out, ref), "pgd_linf_update differs from its plain version")
    n = adv.numel()
    b, by = bound_ms(16 * n, 10 * n)
    row = {
        "name": "pgd_linf_update", "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/pgd_update.cu",
        "replaces": "vqattack_tpu/ops/pgd_update.py:59",
        "max_abs_err": float((out - ref).abs().max()),
        "ms": time_ms(lambda: pgd_update.pgd_linf_update(*args)),
        "plain_ms": time_ms(lambda: pgd_update.pgd_linf_update_reference(*args)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }
    print(f"  pgd_linf_update {list(shape)} f32: bit-exact, {row['ms'] * 1e3:.1f} us "
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


def check_fused_ln(gen):
    fwd_row = bwd_row = None
    for rows in (901, 1000):
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
            if rows == 901 and dtype == torch.float32:
                fwd_row = _time_fwd(x, delta, gamma, beta, rows, max(h_err, 0.0))
                bwd_row = _time_bwd(s, gs, gh, gamma, rows, dx_err)
    _check_autograd(gen)
    return fwd_row, bwd_row


def _time_fwd(x, delta, gamma, beta, rows, err):
    n = rows * D
    b, by = bound_ms(4 * n * 4 + 2 * D * 4, 8 * n)  # read x, delta; write s, h
    row = {
        "name": "residual_layernorm_fwd", "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/fused_ln.cu",
        "replaces": "vqattack_tpu/ops/fused_ln.py:135",
        "max_abs_err": err,
        "ms": time_ms(lambda: fused_ln.residual_layernorm_fwd(x, delta, gamma, beta, 1e-6)),
        "plain_ms": time_ms(
            lambda: fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.layer_norm(x + delta, (D,), gamma, beta, 1e-6)),
    }
    print(f"  residual_layernorm_fwd [901, 768] f32: {row['ms'] * 1e3:.1f} us (plain "
          f"{row['plain_ms'] * 1e3:.1f} us, layer_norm(x + delta) "
          f"{row['library_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    return row


def _time_bwd(s, gs, gh, gamma, rows, err):
    # the main path's backward: frozen parameters, so no dgamma/dbeta
    n = rows * D
    b, by = bound_ms(4 * n * 4 + D * 4, 12 * n)  # read s, gs, gh; write dx
    row = {
        "name": "residual_layernorm_bwd", "route": "cuda",
        "source": "vqattack_tpu_torch/csrc/fused_ln.cu",
        "replaces": "vqattack_tpu/ops/fused_ln.py:159",
        "max_abs_err": err,
        "ms": time_ms(lambda: fused_ln.residual_layernorm_bwd(
            s, gs, gh, gamma, 1e-6, param_grads=False)),
        "plain_ms": time_ms(lambda: fused_ln.residual_layernorm_bwd_reference(
            s, gs, gh, gamma, 1e-6, param_grads=False)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }
    print(f"  residual_layernorm_bwd [901, 768] f32: {row['ms'] * 1e3:.1f} us (plain "
          f"{row['plain_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us)", flush=True)
    return row


def _check_autograd(gen):
    """The autograd Function against autograd through the plain version."""
    x, delta, gamma, beta, _, _ = _ln_case(gen, 901, torch.float32)
    w_s = torch.randn(901, D, generator=gen, device="cuda")
    w_h = torch.randn(901, D, generator=gen, device="cuda")
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
    print("  residual_layernorm autograd Function matches autograd of the plain version",
          flush=True)


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


def write_assets(tmp: str) -> dict:
    """A 30,522-token vocab with bert-base-uncased's special ids ([PAD]=0,
    [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103), 3,129 answers and the
    side tables, all in ``tmp``."""
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    toks += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + ["##" + w for w in WORDS]
    while len(toks) < 30522:
        toks.append(f"tok{len(toks)}")
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("vocab", "vocab.txt"), ("answers", "answers.json"), ("right", "right.txt"),
        ("sur", "sur.json"), ("tgt", "tgt.json"), ("para", "para.json"),
        ("allc", "allc.json"))}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(toks[:30522]) + "\n")
    answers = ["red", "blue", "green", "frisbee", "ball", "dog", "cat", "hat", "two", "yes"]
    answers += [f"tok{i}" for i in range(1000, 1000 + 3129 - len(answers))]
    tables = {
        "answers": answers,
        "sur": {str(q): a for q, _, a, _ in SAMPLES},
        "tgt": {str(q): a for q, _, a, _ in SAMPLES},
        "para": {str(q): [a, p] for q, _, a, p in SAMPLES if p is not None},
        "allc": {str(q): [a] for q, _, a, _ in SAMPLES},
    }
    for k, obj in tables.items():
        with open(paths[k], "w") as f:
            json.dump(obj, f)
    with open(paths["right"], "w") as f:
        f.write("\n".join(str(q) for q, *_ in SAMPLES) + "\n")
    return paths


def expected_launches(res, fused_sites: int) -> dict:
    """Kernel launches one sample's schedule implies: K1 ends every PGD
    step (on the alternating path only the MLM half-step) and every VL
    step; each ViT forward runs ``fused_sites`` K2 forwards (clean targets,
    every gradient step, every VL step, the victim) and each backward as
    many K2 backwards (every gradient step and VL step)."""
    n_feat = len(res.feat_losses)
    n_mlm = 0 if res.mlm_losses is None else len(res.mlm_losses)
    grads = n_feat + n_mlm
    k1_steps = n_feat if res.old_alg == 1 else n_mlm
    return {
        "pgd_linf_update": k1_steps + res.vl_steps,
        "residual_layernorm_fwd": fused_sites * (1 + grads + res.vl_steps + 1),
        "residual_layernorm_bwd": fused_sites * (grads + res.vl_steps),
    }


def counts() -> dict:
    return {
        "pgd_linf_update": pgd_update.pgd_linf_update.launches,
        "residual_layernorm_fwd": fused_ln.residual_layernorm_fwd.launches,
        "residual_layernorm_bwd": fused_ln.residual_layernorm_bwd.launches,
    }


def reset_counts() -> None:
    pgd_update.pgd_linf_update.launches = 0
    fused_ln.residual_layernorm_fwd.launches = 0
    fused_ln.residual_layernorm_bwd.launches = 0


def run_main_path(pipe, cfg, tokenizer, paths, answer_max_len):
    """Attack every sample of SAMPLES through the pipeline and check the
    victim on the result; returns ``(results, launches, expected launches)``
    with the launch counts reset just before and read just after."""
    device = pipe.device
    side = SideTables.load([paths["right"]], [paths["sur"]], [paths["tgt"]],
                           [paths["para"]], [paths["allc"]])
    with open(paths["answers"]) as f:
        answer_list = json.load(f)
    a_ids, a_mask = tokenizer.encode_batch([a + "[SEP]" for a in answer_list],
                                           max_length=answer_max_len)
    answer_ids = torch.as_tensor(a_ids, dtype=torch.long, device=device)
    answer_mask = torch.as_tensor(a_mask, dtype=torch.long, device=device)
    fused_sites = 2 * cfg.albef.vit.depth
    atk = cfg.attack
    size = cfg.albef.vit.image_size
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    results, expected = [], {k: 0 for k in counts()}
    reset_counts()
    for i, (qid, question, _, _) in enumerate(SAMPLES):
        info = side.attack_inputs(qid)
        px = np.random.default_rng(SEED + i).uniform(-1, 1, (1, 3, size, size)).astype(np.float32)
        sync()
        t0 = time.perf_counter()
        res = pipe.attack_sample(px, question, str(qid), info["paraphrase"],
                                 info["target_answer"], info["all_correct_answers"])
        topk_ids, topk_probs = pipe.evaluate_victim(res.adv_image, res.adv_text,
                                                    answer_ids, answer_mask)
        sync()
        dt = time.perf_counter() - t0
        losses = [res.feat_losses] + ([res.mlm_losses] if res.mlm_losses is not None else [])
        require(all(np.isfinite(l).all() and l.size > 0 for l in losses), "non-finite loss")
        require(res.adv_image.shape == (1, 3, size, size), "adversarial image shape")
        require(float(np.abs(res.adv_image - px).max()) <= atk.eps + 1e-6, "outside the eps ball")
        require(float(res.adv_image.min()) >= -1 and float(res.adv_image.max()) <= 1,
                "pixels outside [-1, 1]")
        require(topk_ids.shape == (1, min(cfg.k_test, len(answer_list)))
                and np.isfinite(topk_probs).all(), "victim rank_answer output")
        for k, v in expected_launches(res, fused_sites).items():
            expected[k] += v
        results.append(res)
        n_grads = len(res.feat_losses) + (0 if res.mlm_losses is None else len(res.mlm_losses))
        print(f"  sample {qid}: old_alg={res.old_alg} blocks={res.num_blocks} "
              f"vl_steps={res.vl_steps} grad steps={n_grads} adv_text={res.adv_text!r} "
              f"victim top1={answer_list[int(topk_ids[0, 0])]!r} {dt:.2f} s/sample",
              flush=True)
    return results, counts(), expected


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
        rows = [check_pgd_update(gen), *check_fused_ln(gen)]

    tmp = tempfile.mkdtemp(prefix="vqattack_chip_smoke_")
    paths = write_assets(tmp)
    out_dir = os.path.join(tmp, "out")
    args = port_run.build_argparser().parse_args([
        "--vocab", paths["vocab"], "--answer-list", paths["answers"],
        "--right-part", paths["right"], "--surrogate-ans", paths["sur"],
        "--target-ans", paths["tgt"], "--paraphrases", paths["para"],
        "--all-correct", paths["allc"], "--output", out_dir,
        "--seed", str(SEED), "--device", "cuda",
    ])
    cfg = port_run.resolve_config(args)
    require(cfg.albef.vit.fused_ln and cfg.albef.vit.image_size == 480
            and cfg.albef.vit.depth == 12 and cfg.albef.bert.num_layers == 12
            and cfg.attack.num_iters == 40, "not the full-width ALBEF attack config")
    tokenizer = WordPieceTokenizer.from_file(paths["vocab"])
    with Phase("pipeline (random full-width weights)"):
        pipe = port_run._build_pipeline(args, cfg, tokenizer)
    with Phase("model: kernels against plain LayerNorms"):
        check_model(cfg, pipe.surrogate, gen)

    with Phase("main path: per-sample ALBEF attack, 2 samples"):
        results, launched, expected = run_main_path(pipe, cfg, tokenizer, paths,
                                                    args.answer_max_len)
    require(sorted(r.old_alg for r in results) == [0, 1], "both PGD paths must run")
    for k, n in launched.items():
        require(n > 0, f"{k} was not launched on the main path")
        require(n == expected[k], f"{k}: {n} launches, the schedules imply {expected[k]}")
    save_artifacts(results, out_dir)
    for r in results:
        for ext in (".pt", ".npy"):
            require(os.path.exists(os.path.join(out_dir, r.qid + ext)), f"artifact {r.qid}{ext}")
    require(os.path.exists(os.path.join(out_dir, "adv_txt_dict.json")), "adversarial-text json")
    shutil.rmtree(tmp)

    for row in rows:
        row["launches"] = launched[row["name"]]
    print(f"wall: {time.perf_counter() - t_start:.1f} s since start", flush=True)
    print(json.dumps({"kernel_launches": launched}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
