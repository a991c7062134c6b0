"""The port's VQA fine-tuning slice against the JAX package's training stack:
schedules and the ``adamw``/``adam``/``sgd`` updates against optax on the
same gradients, the weight-decay mask, the losses, one ``make_train_step``
of each task (``albef_vqa``, ``vlmo_vqa``) from ``load_jax_params``-matched
parameters, the train transform from one ``random.Random`` seed, the
meters, the CLI end to end on the CPU and the save/resume round trip.

Tolerances: schedules rtol 1e-6 (optax computes in float32, the port in
float64); optimizer updates on identical gradients rtol 1e-5 and atol 3e-5
of the largest step (lr times the head multiplier: optax's float32
``1 - b2**t`` loses up to ~3e-5 to cancellation at small t, where the
port's is float64);
losses rtol 1e-5; gradients rtol 1e-3, atol 1e-5 of each tensor's largest
value or 1e-6 of the model's largest gradient, whichever is larger (some
gradients are zero but for rounding noise, as that of a key projection's
bias), and the global norm rtol 1e-4 (float32 products and reductions in
other orders); parameters after one AdamW step rtol 1e-5 and atol 1e-4 lr
where the JAX gradient exceeds 1e-6 (100 eps: the normalised update
``g / (|g| + eps)`` is then stable), else 2 lr (noise may flip its sign);
the transform exactly (the same PIL calls).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (leaf, nchw, port_layout, shallow_albef, tiny_configs,
                             tiny_models, tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu.data import transforms as jtransforms
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.text.tokenizer import SPECIAL_TOKENS
from vqattack_tpu.train import objectives as jobj
from vqattack_tpu.train import optim as joptim
from vqattack_tpu.train import trainer as jtrainer
from vqattack_tpu.utils import meters as jmeters
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.checkpoint import io as ckpt_io
from vqattack_tpu_torch.checkpoint import synthetic
from vqattack_tpu_torch.checkpoint.convert import flax_leaves, graft_jax_params
from vqattack_tpu_torch.checkpoint.io import (
    find_train_steps,
    restore_latest_train_state,
    save_train_state,
)
from vqattack_tpu_torch.data import transforms
from vqattack_tpu_torch.models.albef import AlbefVQA
from vqattack_tpu_torch.models.vlmo import VLMo
from vqattack_tpu_torch.train import cli, objectives, optim, trainer
from vqattack_tpu_torch.utils import meters

T = torch.from_numpy
VOCAB = 64


# ---------------------------------------------------------------------------
# schedules, optimizers, masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("cosine", {}), ("cosine", {"warmup_steps": 3, "min_lr": 1e-4}),
    ("linear", {"warmup_steps": 2, "warmup_lr": 1e-4}), ("polynomial", {"power": 2.0}),
    ("step", {"decay_steps": 3, "decay_rate": 0.5, "min_lr": 2e-4}), ("constant", {}),
])
def test_schedules_match_optax(kind, kw):
    want = joptim.create_schedule(kind, 1e-3, total_steps=10, **kw)
    got = optim.create_schedule(kind, 1e-3, total_steps=10, **kw)
    for count in range(14):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=count)


@pytest.fixture(scope="module")
def vlmo():
    jc, tc = tiny_vlmo_configs(VOCAB, depth=2)
    return (jc, tc) + tiny_vlmo(jc, tc, seed=0)


@pytest.mark.parametrize("opt,kw", [
    ("adamw", {}), ("adam", {}), ("sgd", {}),
    ("adamw", {"head_lr_mult": 10.0, "grad_clip": 1.0}),
])
def test_optimizers_match_optax_on_identical_gradients(vlmo, opt, kw):
    """Three updates from the same parameters and the same gradients (random,
    one draw a leaf and step, scaled so that clipping triggers) through
    optax and through the port: the parameters after each step."""
    jc, tc, j_model, params, model = vlmo
    model = copy.deepcopy(model)  # the step updates in place
    sched = joptim.create_schedule("cosine", 1e-2, total_steps=5, warmup_steps=1)
    tx = joptim.create_optimizer(params, opt, sched, weight_decay=0.1, **kw)
    state = tx.init(params)
    p_j = params
    t_tx = optim.create_optimizer(model, opt, optim.create_schedule(
        "cosine", 1e-2, total_steps=5, warmup_steps=1), weight_decay=0.1, **kw)
    t_params = optim.named_params(model)
    t_state = t_tx.init(t_params)
    rng = np.random.default_rng(1)

    @jax.jit  # one program; eager, optax dispatches every leaf's update on its own
    def j_step(grads, state, p):
        updates, state = tx.update(grads, state, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), state

    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: np.asarray(rng.normal(size=np.shape(x)) * 0.1, np.float32), p_j)
        p_j, state = j_step(grads, state, p_j)
        t_grads = {n: T(np.array(g, order="C")) for n, g in port_layout(model, grads).items()}
        t_state = t_tx.step(t_params, t_grads, t_state)
        want = port_layout(model, p_j)
        for name, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5,
                                       atol=3e-5 * 1e-2 * kw.get("head_lr_mult", 1.0),
                                       err_msg=f"step {step}: {name}")
    assert t_state["count"] == 3


def test_decay_mask_matches_jax(vlmo):
    """The same leaves decay in both packages, for VLMo and the ALBEF VQA
    model (the flax paths decide)."""
    jc, tc, _, params, model = vlmo
    ajc, atc = tiny_configs(VOCAB)
    _, (_, p_vic, _), (_, t_vic, _) = tiny_models(ajc, atc, victim=True, mlm=False)
    for m, p in ((model, params), (t_vic, p_vic)):
        want = joptim.decay_mask(p)
        got = optim.decay_mask(m)
        assert len(got) == len(list(m.parameters()))
        for name, path, _, _ in flax_leaves(m):
            assert got[name] == bool(leaf(want, path)), name
        assert any(got.values()) and not all(got.values())


def test_unported_optimizers_and_hessian_steps_are_refused(vlmo):
    model = vlmo[-1]
    for opt in ("lamb", "lion", "adafactor", "rmsprop", "lookahead_adamw", "nadam",
                "adahessian"):
        with pytest.raises(ValueError, match="not ported yet"):
            optim.create_optimizer(model, opt)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.create_optimizer(model, "nope")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        trainer.make_train_step(lambda *a: None, None, needs_hessian=True)


# ---------------------------------------------------------------------------
# losses and the train step
# ---------------------------------------------------------------------------


def test_classification_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    labels[0, :2] = -100
    np.testing.assert_allclose(
        float(objectives.masked_lm_loss(T(logits), T(labels))),
        float(jobj.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-5)
    cls, y = logits[:, 0, :3], labels[:, 1] % 3
    np.testing.assert_allclose(float(objectives.nlvr2_loss(T(cls), T(y))),
                               float(jobj.nlvr2_loss(jnp.asarray(cls), jnp.asarray(y))),
                               rtol=1e-5)
    targets = (rng.uniform(size=(3, 11)) * (rng.uniform(size=(3, 11)) > 0.7)).astype(np.float32)
    np.testing.assert_allclose(
        float(objectives.vqa_bce_loss(T(logits[:, 0]), T(targets))),
        float(jobj.vqa_bce_loss(jnp.asarray(logits[:, 0]), jnp.asarray(targets))), rtol=1e-5)


def _albef_task(rng):
    jc, tc = (shallow_albef(c) for c in tiny_configs(VOCAB))
    (_, j_vic, _), (_, params, _), (_, model, _) = tiny_models(jc, tc, victim=True, mlm=False)
    size = jc.albef.vit.image_size
    b, a, l = 2, 3, 6
    ids = rng.integers(5, VOCAB, (b, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    ans = rng.integers(5, VOCAB, (b, a, l)).astype(np.int32)
    ans[..., 0] = 2  # [CLS]
    ans_mask = np.ones_like(ans)
    ans_mask[0, 2, 3:] = 0
    ans[0, 2, 3:] = 0
    weights = np.array([[0.5, 0.3, 0.2], [1.0, 0.0, 0.0]], np.float32)
    batch = {"pixels": rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
             "text_ids": ids, "text_mask": mask, "answer_ids": ans, "answer_mask": ans_mask,
             "answer_weights": weights}

    def jloss(p, batch, key):
        return jobj.albef_vqa_train_loss(j_vic, p, batch)

    def tloss(m, batch, gen):
        return objectives.albef_vqa_train_loss(m, batch)

    return params, model, batch, jloss, tloss


def _vlmo_task(rng):
    jc, tc = tiny_vlmo_configs(VOCAB, depth=2)
    j_model, params, model = tiny_vlmo(jc, tc, seed=0)
    size, n = jc.vlmo.image_size, jc.vlmo.vqa_label_size
    ids = rng.integers(5, VOCAB, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    targets = np.zeros((2, n), np.float32)
    targets[0, 3], targets[1, [1, 7]] = 1.0, (0.6, 0.3)
    batch = {"pixels": rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32),
             "text_ids": ids, "text_mask": mask, "targets": targets}

    def jloss(p, batch, key):
        logits = j_model.apply(p, batch["pixels"], batch["text_ids"], batch["text_mask"],
                               method=JVLMo.vqa_logits)
        loss = jobj.vqa_bce_loss(logits, batch["targets"])
        return loss, {"loss": loss}

    def tloss(m, batch, gen):
        loss = objectives.vqa_bce_loss(
            m.vqa_logits(batch["pixels"], batch["text_ids"], batch["text_mask"]),
            batch["targets"])
        return loss, {"loss": loss}

    return params, model, batch, jloss, tloss


@pytest.mark.parametrize("task", ["albef_vqa", "vlmo_vqa"])
def test_train_step_matches_jax(task):
    """One AdamW step of each task from the same parameters on the same
    batch: the loss, every gradient, ``grad_norm`` and every parameter
    after the step."""
    rng = np.random.default_rng(4)
    params, model, batch, jloss, tloss = (_albef_task if task == "albef_vqa"
                                          else _vlmo_task)(rng)
    lr = 1e-3
    tx = joptim.create_optimizer(params, "adamw", lr, weight_decay=0.02)
    j_step = jtrainer.make_train_step(jloss, tx, donate=False)
    # the gradients and the step in one compiled program (an eager jax.grad
    # dispatches, and compiles, every primitive on its own)
    j_grads, (j_state, j_metrics) = jax.jit(lambda p: (
        jax.grad(lambda q: jloss(q, batch, None)[0])(p),
        j_step(jtrainer.create_train_state(p, tx), batch, jax.random.key(0))))(params)

    t_batch = {k: T(nchw(v) if k == "pixels" else v) for k, v in batch.items()}
    for k in ("text_ids", "text_mask", "answer_ids", "answer_mask"):
        if k in t_batch:
            t_batch[k] = t_batch[k].long()
    t_params = optim.named_params(model)
    loss, _ = tloss(model, t_batch, None)
    grads = torch.autograd.grad(loss, list(t_params.values()), allow_unused=True)
    want_g = port_layout(model, j_grads)
    largest = max(float(np.abs(g).max()) for g in want_g.values())
    for (name, p), g in zip(t_params.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        atol = max(1e-5 * float(np.abs(want_g[name]).max()), 1e-6 * largest)
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-3, atol=atol, err_msg=name)

    t_tx = optim.create_optimizer(model, "adamw", lr, weight_decay=0.02)
    state = trainer.create_train_state(model, t_tx)
    state, metrics = trainer.make_train_step(tloss, t_tx)(state, t_batch, None)
    assert state.step == 1 and state.opt_state["count"] == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    want = port_layout(model, j_state.params)
    for name, p in t_params.items():
        atol = np.where(np.abs(want_g[name]) > 1e-6, 1e-4 * lr, 2 * lr)
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[name]),
                                     atol + 1e-5 * np.abs(want[name]) + 1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# data, meters
# ---------------------------------------------------------------------------


def test_train_transform_matches_jax_from_one_seed():
    """Eight draws each from the same ``random.Random`` seed on two images:
    the same crops, flips and RandAugment ops, so the same pixels (the JAX
    transform's HWC transposed)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 255, (40, 52, 3), np.uint8)),
              Image.fromarray(rng.integers(0, 255, (64, 48, 3), np.uint8)).convert("L")]
    want = jtransforms.train_transform(32, random.Random(5))
    got = transforms.train_transform(32, random.Random(5))
    for _ in range(4):
        for img in images:
            out = got(img)
            assert out.shape == (3, 32, 32) and out.dtype == np.float32
            np.testing.assert_array_equal(out, want(img).transpose(2, 0, 1))
    assert len(transforms.RA_OPS) == len(jtransforms._RA_OP_TABLE)
    img = images[0]
    for name in transforms.RA_OPS:  # every op at a signed magnitude
        np.testing.assert_array_equal(np.asarray(transforms._op(name, img, -0.7)),
                                      np.asarray(jtransforms._RA_OP_TABLE[name](img, -0.7)),
                                      err_msg=name)


def test_meters_print_as_the_jax_ones():
    lines = ([], [])
    loggers = (jmeters.MetricLogger(log_fn=lines[0].append),
               meters.MetricLogger(log_fn=lines[1].append))
    for i in range(30):
        for lg in loggers:
            lg.update(loss=1.0 / (i + 1), lr=1e-3)
    assert str(loggers[0]) == str(loggers[1])
    assert loggers[1].loss.median == loggers[0].loss.median
    assert loggers[1].loss.global_avg == loggers[0].loss.global_avg


# ---------------------------------------------------------------------------
# the CLI, save and resume
# ---------------------------------------------------------------------------


def _cli_assets(tmp_path):
    """A vocabulary, four 40 px JPEGs and train annotations with answers and
    VLMo soft targets, and a tiny RunConfig json (as tests/test_train_cli.py
    builds them for the JAX CLI)."""
    from PIL import Image

    words = ["what", "color", "is", "the", "dog", "red", "blue"]
    toks = list(SPECIAL_TOKENS) + words
    for c in "abcdefghijklmnopqrstuvwxyz":
        toks += [c, f"##{c}"]
    (tmp_path / "vocab.txt").write_text("\n".join(toks) + "\n")
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    ann = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(img_dir / f"{i}.jpg")
        ann.append({"image": f"{i}.jpg", "question": "what color is the dog",
                    "question_id": i, "answer": ["red", "red", "blue"],
                    "answer_labels": [i % 4], "answer_scores": [1.0]})
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    base = tcfg.tiny_test_config()
    cfg = dataclasses.replace(
        base, albef=dataclasses.replace(base.albef, bert=dataclasses.replace(
            base.albef.bert, vocab_size=len(toks))),
        vlmo=dataclasses.replace(base.vlmo, vocab_size=len(toks)))
    tcfg.save_config(cfg, str(tmp_path / "cfg.json"))
    return ["--config", str(tmp_path / "cfg.json"), "--vocab", str(tmp_path / "vocab.txt"),
            "--ann", str(tmp_path / "ann.json"), "--image-root", str(img_dir),
            "--batch-size", "2", "--lr", "1e-4", "--device", "cpu"]


@pytest.mark.parametrize("task", ["albef_vqa", "vlmo_vqa"])
def test_cli_trains_saves_and_resumes_on_the_cpu(tmp_path, task):
    """``train.cli.main`` for both tasks on PIL images: 3 steps with a
    checkpoint every 2 (and the final one), then a resume that continues
    from step 3 to 4; every logged loss finite."""
    argv = ["--task", task, *_cli_assets(tmp_path), "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--log-every", "1"]
    first = cli.main(argv + ["--steps", "3"])
    assert first["start_step"] == 0 and first["step"] == 3 and len(first["losses"]) == 3
    assert sorted(find_train_steps(str(tmp_path / "ck"))) == [2, 3]
    second = cli.main(argv + ["--steps", "4"])
    assert second["start_step"] == 3 and second["step"] == 4 and len(second["losses"]) == 1
    assert all(np.isfinite(first["losses"] + second["losses"] + second["grad_norms"]))
    assert sorted(find_train_steps(str(tmp_path / "ck"))) == [2, 3, 4]


@pytest.mark.parametrize("task", ["albef_vqa", "vlmo_vqa"])
def test_init_ckpt_grafts_the_files_trunk(tmp_path, task, capsys):
    """``--init-ckpt``: a synthetic file in the reference's names (an ALBEF
    pre-trained model; a VLMo VQA model with an NLVR2 head), read by the
    port's loaders; every parameter with a leaf in the converted tree takes
    the file's value and the others (the task's heads) keep theirs
    (``graft_jax_params``, the JAX CLI's merge), and the CLI trains from
    it."""
    assets = _cli_assets(tmp_path)
    cfg = tcfg.load_config(str(tmp_path / "cfg.json"))
    path = str(tmp_path / "init.pt")
    if task == "albef_vqa":
        torch.save({"model": synthetic.albef_pretrain_state_dict(
            cfg.albef, 1, src_image_size=cfg.albef.vit.image_size)}, path)
        tree, model = ckpt_io.load_albef_pretrain(path, cfg.albef), AlbefVQA(cfg.albef)
    else:
        torch.save({"state_dict": synthetic.vlmo_state_dict(
            cfg.vlmo, 1, heads=synthetic.VLMO_VQA_HEADS + ("nlvr2_classifier",))}, path)
        tree, model = ckpt_io.load_vlmo(path, cfg.vlmo), VLMo(cfg.vlmo)
    before = {n: p.detach().clone() for n, p in optim.named_params(model).items()}
    n = graft_jax_params(model, tree)
    grafted = 0
    for name, leaf_path, transform, p in flax_leaves(model):
        node = tree.get("params", tree)
        for key in leaf_path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is None:
            assert torch.equal(p, before[name]), name
        else:
            np.testing.assert_array_equal(p.detach().numpy(), transform(np.asarray(node)))
            grafted += 1
    assert n == grafted and 0 < n < len(before)
    summary = cli.main(["--task", task, *assets, "--steps", "1", "--log-every", "1",
                        "--init-ckpt", path])
    assert f"{n} tensors grafted" in capsys.readouterr().out
    assert np.isfinite(summary["losses"]).all()


def test_preset_fills_defaults_but_flags_win():
    """``apply_preset`` against the JAX CLI's on the same flags."""
    from vqattack_tpu.train import cli as jcli

    for extra in ([], ["--lr", "3e-4", "--image-size", "384"]):
        argv = ["--task", "vlmo_vqa", "--vocab", "v", "--preset",
                "task_finetune_vqa_base_image480", *extra]
        jp, tp = jcli.build_argparser(), cli.build_argparser()
        ja, ta = jp.parse_args(argv), tp.parse_args(argv)
        assert cli.apply_preset(tp, ta) == jcli.apply_preset(jp, ja)
        for k in ("lr", "weight_decay", "mlm_prob", "image_size", "warmup_steps"):
            assert getattr(ta, k) == getattr(ja, k), k


def test_save_and_resume_restores_the_state_exactly(tmp_path, vlmo):
    """A state saved after two steps and restored into a fresh model has the
    same step, parameters and optimizer state, and its next step gives the
    same parameters as the original's, bit for bit; ``keep`` prunes."""
    _, tc, _, _, model = vlmo
    rng = np.random.default_rng(6)
    _, _, batch, _, tloss = _vlmo_task(rng)
    t_batch = {k: T(nchw(v) if k == "pixels" else v) for k, v in batch.items()}
    for k in ("text_ids", "text_mask"):
        t_batch[k] = t_batch[k].long()
    model = copy.deepcopy(model)
    tx = optim.create_optimizer(model, "adamw", 1e-3)
    step = trainer.make_train_step(tloss, tx)
    state = trainer.create_train_state(model, tx)
    for _ in range(2):
        state, _ = step(state, t_batch)
        save_train_state(state, str(tmp_path), state.step, keep=1)
    assert find_train_steps(str(tmp_path)) == [2]
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    restored = restore_latest_train_state(str(tmp_path), trainer.create_train_state(fresh, tx))
    assert restored.step == 2 and restored.opt_state["count"] == 2
    for (n, a), b in zip(optim.named_params(model).items(), optim.named_params(fresh).values()):
        assert torch.equal(a, b), n
        assert torch.equal(state.opt_state["mu"][n], restored.opt_state["mu"][n]), n
        assert torch.equal(state.opt_state["nu"][n], restored.opt_state["nu"][n]), n
    state, _ = step(state, t_batch)
    restored, _ = step(restored, t_batch)
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    assert restore_latest_train_state(str(tmp_path / "none"), state) is None
