"""Training CLI: VQA fine-tuning of the two victims.

Port of ``vqattack_tpu/train/cli.py`` for its two VQA tasks::

    python -m vqattack_tpu_torch.train.cli --task vlmo_vqa \\
        --preset task_finetune_vqa_base_image480 --vocab vocab.txt \\
        --ann train.json --image-root images/ --steps 1000 --batch-size 8 \\
        [--ckpt-dir ckpts] [--init-ckpt vlmo.pt] [--device cpu]

- ``albef_vqa``: ALBEF ViT-B/16 + BERT + answer decoder, the weighted
  answer NLL (``train/objectives.py::albef_vqa_train_loss``); on the card
  the ViT takes the fused residual + LayerNorm kernel (``vit.fused_ln``),
  as the attack CLI does;
- ``vlmo_vqa``: VLMo with its VQA head, BCE over the 3,129 labels.

The loop: batches drawn in a seeded random order, collated on the host and
moved to the device, one step (``train/trainer.py``), the metrics read one
log step late so that the device is not waited for between steps, a
checkpoint every ``--ckpt-every`` steps and at the end (``--ckpt-dir``),
resumed from the newest one.  Like the JAX CLI it has no ``--attn``:
attention follows the process-wide backend, so ``with
attention_impl("flash"): main([...])`` trains through the flash kernels
(with VLMo's relative-position table, their bias gradient).  Entry points
run on ``cuda`` unless ``--device cpu`` is given.  The JAX CLI's other
tasks (ALBEF pretraining, retrieval, VE, NLVR2, the VLMo pretraining,
retrieval and NLVR2 tasks) and its arrow pretraining data are not ported
yet and exit with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vqattack_tpu_torch.train.trainer import LossFn

TASKS = ["albef_pretrain", "albef_vqa", "retrieval", "ve", "nlvr2", "vlmo_vqa", "vlmo_irtr",
         "vlmo_textmlm", "vlmo_pretrain", "vlmo_nlvr2"]
PORTED_TASKS = ("albef_vqa", "vlmo_vqa")
ANSWER_LEN = 8  # tokens an answer slot of albef_vqa holds


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VQA fine-tuning on an NVIDIA GPU")
    p.add_argument("--task", required=True, choices=TASKS,
                   help=f"ported: {', '.join(PORTED_TASKS)}")
    p.add_argument("--preset", nargs="*", default=[],
                   help="sacred named-config presets composed left-to-right "
                        "(vqattack_tpu_torch.named_configs, e.g. "
                        "task_finetune_vqa_base_image480); supplies VLMo geometry + "
                        "lr/weight-decay/warmup/mlm-prob/image-size defaults, explicit "
                        "flags win")
    p.add_argument("--config", default=None)
    p.add_argument("--vocab", required=True)
    p.add_argument("--ann", nargs="+", default=[])
    p.add_argument("--image-root", default="")
    p.add_argument("--arrow-root", default=None,
                   help="pretraining arrow directory (not ported yet)")
    p.add_argument("--arrow-datasets", nargs="+", default=None,
                   help="corpora to concat from --arrow-root (not ported yet)")
    p.add_argument("--answer-list", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--weight-decay", type=float, default=0.02)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--schedule", default="cosine")
    p.add_argument("--opt", default="adamw")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--init-ckpt", default=None, help="torch ckpt to start from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-answers", type=int, default=4)
    p.add_argument("--mlm-prob", type=float, default=0.15)
    p.add_argument("--image-size", type=int, default=None,
                   help="override config image size (e.g. 224 for pretrain)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model trains (default: the GPU)")
    return p


def _batches(dataset, batch_size: int, seed: int) -> Iterator[list]:
    """Drop-last batches of ``dataset`` items, a fresh seeded order each
    epoch, forever."""
    if len(dataset) < batch_size:
        # the drop-last epoch loop below would yield nothing and spin forever
        raise ValueError(f"dataset has {len(dataset)} items < batch size {batch_size}; "
                         "lower --batch-size")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(dataset))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield [dataset[int(j)] for j in order[i: i + batch_size]]


def apply_preset(parser: argparse.ArgumentParser, args) -> Optional[dict]:
    """Resolve ``--preset`` named configs and fill in hyperparameter
    defaults (explicit flags win); returns the resolved named-config dict
    (None without --preset)."""
    if not args.preset:
        return None
    from vqattack_tpu_torch.named_configs import train_settings_from_named, vlmo_named_config

    preset = vlmo_named_config(*args.preset)
    s = train_settings_from_named(preset)

    def _default(name, val):
        if getattr(args, name) == parser.get_default(name):
            setattr(args, name, val)

    _default("lr", s["learning_rate"])
    _default("weight_decay", s["weight_decay"])
    _default("mlm_prob", s["mlm_prob"])
    _default("image_size", int(preset["image_size"]))
    warm = s["warmup_steps"]
    if isinstance(warm, float) and warm < 1:  # sacred fraction-of-steps
        warm = int(warm * (s["max_steps"] or args.steps))
    _default("warmup_steps", int(warm))
    if args.arrow_root:
        _default("arrow_datasets", list(s["datasets"]))
    return preset


def resolve_config(args, preset: Optional[dict], device: torch.device):
    """The run config: ``--config`` (default the ALBEF attack config), the
    preset's VLMo geometry, ``--image-size`` on both models, and on the card
    the fused residual + LayerNorm ViT for ALBEF."""
    from vqattack_tpu_torch import config as cfg_mod

    cfg = cfg_mod.load_config(args.config) if args.config else cfg_mod.albef_attack_config()
    if preset is not None:
        from vqattack_tpu_torch.named_configs import vlmo_config_from_named

        cfg = dataclasses.replace(cfg, vlmo=vlmo_config_from_named(preset))
    if args.image_size:
        vit = dataclasses.replace(cfg.albef.vit, image_size=args.image_size)
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit),
                                  vlmo=dataclasses.replace(cfg.vlmo, image_size=args.image_size))
    if device.type == "cuda" and args.task == "albef_vqa":
        vit = dataclasses.replace(cfg.albef.vit, fused_ln=True)
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit))
    return cfg


Collate = Callable[[list], Dict[str, torch.Tensor]]


def build_task(args, cfg, tokenizer, device: torch.device) -> Tuple[nn.Module, LossFn, Collate]:
    """``(model, loss_fn, collate)`` of ``args.task`` on ``device``: the
    model random from ``--seed`` (then grafted from ``--init-ckpt``), the
    loss of a collated batch, and the collate of dataset items into a batch
    on ``device``."""
    from vqattack_tpu_torch.checkpoint import io as ckpt_io
    from vqattack_tpu_torch.checkpoint.convert import graft_jax_params
    from vqattack_tpu_torch.train import objectives as obj

    def pixels(items):
        return torch.from_numpy(np.concatenate([i["pixels"] for i in items])).to(device)

    def text(items, max_len):
        ids, mask = tokenizer.encode_batch([i.get("question", "") for i in items], max_len)
        return torch.from_numpy(ids).long().to(device), torch.from_numpy(mask).long().to(device)

    if args.task == "albef_vqa":
        from vqattack_tpu_torch.models.albef import AlbefVQA, init_weights

        with torch.device(device):
            model = init_weights(AlbefVQA(cfg.albef), seed=args.seed).to(device)
        if args.init_ckpt:
            tree = ckpt_io.load_albef_pretrain(args.init_ckpt, cfg.albef)
            print(f"--init-ckpt {args.init_ckpt}: {graft_jax_params(model, tree)} tensors "
                  f"grafted", flush=True)

        def loss_fn(m, batch, generator):
            del generator
            return obj.albef_vqa_train_loss(m, batch)

        def collate(items):
            a = args.max_answers
            ans_ids = np.zeros((len(items), a, ANSWER_LEN), np.int64)
            ans_mask = np.zeros((len(items), a, ANSWER_LEN), np.int64)
            weights = np.zeros((len(items), a), np.float32)
            for b, item in enumerate(items):
                for j, (ans, w) in enumerate(zip(item.get("answers", []),
                                                 item.get("weights", []))):
                    if j >= a:
                        break
                    ans_ids[b, j], ans_mask[b, j] = tokenizer.encode(ans, ANSWER_LEN)
                    weights[b, j] = w
            ids, mask = text(items, cfg.attack.max_text_len)
            return {"pixels": pixels(items), "text_ids": ids, "text_mask": mask,
                    "answer_ids": torch.from_numpy(ans_ids).to(device),
                    "answer_mask": torch.from_numpy(ans_mask).to(device),
                    "answer_weights": torch.from_numpy(weights).to(device)}

        return model, loss_fn, collate

    from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

    with torch.device(device):
        # .to: the relative-position indices are buffers made from numpy
        model = init_vlmo_weights(VLMo(cfg.vlmo), seed=args.seed).to(device)
    if args.init_ckpt:
        tree = ckpt_io.load_vlmo(args.init_ckpt, cfg.vlmo)
        print(f"--init-ckpt {args.init_ckpt}: {graft_jax_params(model, tree)} tensors grafted",
              flush=True)

    def loss_fn(m, batch, generator):
        del generator
        logits = m.vqa_logits(batch["pixels"], batch["text_ids"], batch["text_mask"])
        loss = obj.vqa_bce_loss(logits, batch["targets"])
        return loss, {"loss": loss}

    def collate(items):
        targets = np.zeros((len(items), cfg.vlmo.vqa_label_size), np.float32)
        for b, item in enumerate(items):
            for label, score in zip(item.get("answer_labels", []), item.get("answer_scores", [])):
                targets[b, int(label)] = float(score)
        ids, mask = text(items, cfg.vlmo.max_text_len)
        return {"pixels": pixels(items), "text_ids": ids, "text_mask": mask,
                "targets": torch.from_numpy(targets).to(device)}

    return model, loss_fn, collate


def main(argv=None) -> dict:
    """Train; returns ``{"task", "start_step", "step", "losses", "grad_norms",
    "log_times"}``: the steps' losses and gradient norms as logged, and the
    host clock after each log step's metrics were read (the device's work up
    to that step done)."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.task not in PORTED_TASKS:
        raise SystemExit(f"--task {args.task} is not ported yet; the port trains "
                         f"{', '.join(PORTED_TASKS)}")
    if args.arrow_root:
        raise SystemExit("--arrow-root: the pretraining arrow data is not ported yet")
    if not (args.ann and args.image_root):
        raise SystemExit("--ann and --image-root are required")
    preset = apply_preset(parser, args)

    from vqattack_tpu_torch.checkpoint.io import restore_latest_train_state, save_train_state
    from vqattack_tpu_torch.data.transforms import train_transform
    from vqattack_tpu_torch.data.vqa import VQADataset
    from vqattack_tpu_torch.device import resolve_device
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer
    from vqattack_tpu_torch.train.optim import create_optimizer, create_schedule
    from vqattack_tpu_torch.train.trainer import create_train_state, make_train_step
    from vqattack_tpu_torch.utils.meters import MetricLogger

    device = resolve_device(args.device)
    cfg = resolve_config(args, preset, device)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    size = cfg.albef.vit.image_size if args.task == "albef_vqa" else cfg.vlmo.image_size
    dataset = VQADataset(args.ann, args.image_root, train_transform(size),
                         answer_list=args.answer_list, split="train")
    model, loss_fn, collate = build_task(args, cfg, tokenizer, device)

    sched = create_schedule(args.schedule, args.lr, total_steps=args.steps,
                            warmup_steps=args.warmup_steps)
    tx = create_optimizer(model, args.opt, sched, weight_decay=args.weight_decay)
    state = create_train_state(model, tx)
    resumed_at = None
    if args.ckpt_dir:
        restored = restore_latest_train_state(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            resumed_at = state.step
            print(f"resumed at step {resumed_at}", flush=True)
    step_fn = make_train_step(loss_fn, tx, needs_hessian=(args.opt == "adahessian"))

    logger = MetricLogger()
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed + 1)
    data = _batches(dataset, args.batch_size, args.seed)
    start = state.step
    pending = []  # (step, metrics) whose values are still on the device
    last_saved = None
    summary = {"task": args.task, "start_step": start, "losses": [], "grad_norms": [],
               "log_times": []}

    def drain():
        # read the metrics one log step late: float() waits for the device,
        # and waiting after every step would stop the next batch's host-side
        # collate from overlapping the device's work
        for s_, m_ in pending:
            loss, norm = float(m_["loss"]), float(m_["grad_norm"])
            logger.update(loss=loss, grad_norm=norm, lr=float(sched(s_)))
            summary["losses"].append(loss)
            summary["grad_norms"].append(norm)
        pending.clear()
        summary["log_times"].append(time.perf_counter())

    for step in range(start, args.steps):
        batch = collate(next(data))
        state, metrics = step_fn(state, batch, generator)
        pending.append((step, metrics))
        if step % args.log_every == 0:
            drain()
            print(f"step {step}: {logger}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_train_state(state, args.ckpt_dir, step + 1)
            last_saved = step + 1
    drain()
    # the final save, unless this step is on disk already (the last periodic
    # save, or a resume of a run that had finished)
    if args.ckpt_dir and state.step not in (last_saved, resumed_at):
        save_train_state(state, args.ckpt_dir, state.step)
    print(f"done at step {state.step}; final {logger}", flush=True)
    summary["step"] = state.step
    return summary


if __name__ == "__main__":
    main()
