"""Training CLI: vision-language pretraining and downstream fine-tuning.

Port of ``vqattack_tpu/train/cli.py`` for its ten tasks::

    python -m vqattack_tpu_torch.train.cli --task vlmo_pretrain \\
        --preset task_mlm_itm_itc_base_plus --vocab vocab.txt \\
        (--ann train.json --image-root images/ | --arrow-root arrows/) \\
        --steps 1000 --batch-size 8 [--ckpt-dir ckpts] [--init-ckpt vlmo.pt] \\
        [--device cpu]

- ``albef_pretrain``: ALBEF ViT-B/16 + fusion BERT, ITA + hard-negative
  ITM + MLM (``train/objectives.py::albef_pretrain_loss``) on token-level
  masked captions;
- ``albef_vqa``: ALBEF + answer decoder, the weighted answer NLL
  (``albef_vqa_train_loss``);
- ``retrieval``: ALBEF's retrieval model, identity-aware ITA (same-image
  items are positives, ``img_idx``) + hard-negative ITM
  (``retrieval_train_loss``);
- ``ve`` and ``nlvr2``: ALBEF's 3-way entailment and 2-way NLVR2 heads
  (``models/albef_tasks.py``; NLVR's 18 layers cross-attend to the pair's
  two images in turn), cross-entropy on the labels modulo the classes; an
  item without a pair gives its image twice;
- ``vlmo_pretrain``: VLMo's MLM + ITC + ITM (``vlmo_pretrain_loss``), the
  weights of the preset's ``loss_names`` and its whole-word masking;
- ``vlmo_textmlm``: the text-only tower's MLM, whole-word masked;
- ``vlmo_vqa``: VLMo with its VQA head, BCE over the 3,129 labels;
- ``vlmo_irtr``: each image against its caption and 2 other captions of
  the batch by the ITM logit (``vlmo_irtr_train_loss``);
- ``vlmo_nlvr2``: VLMo with NLVR2's head over the statement encoded with
  each image (``VLMo.nlvr2_logits``; 3 token types, the file's 2-row table
  widened at ``--init-ckpt``).

On the card ALBEF's ViT takes the fused residual + LayerNorm kernel
(``vit.fused_ln``), as the attack CLI does.  The text is the item's
``question`` (an annotation's question, sentence or caption, or an arrow
table's caption).  ``--arrow-root`` reads the corpora of
``data/pretrain_datasets.py`` (pyarrow and PIL; the defaults: wikibk for
``vlmo_textmlm``, nlvr2 for the NLVR2 tasks, else coco, f30k, gcc, sbu
and vg; corpora missing from the directory are skipped) in place of
``--ann``.  ``--init-ckpt`` grafts an ALBEF pre-trained file (at the
12-layer geometry: NLVR's layers 12-17 keep their values) or a VLMo file
into the task's model; the task's heads the file lacks keep theirs.

The loop: batches drawn in a seeded random order, collated on the host and
moved to the device, one step (``train/trainer.py``) with a key split off
the run's key each step, the metrics read one log step late so that the
device is not waited for between steps, a checkpoint every
``--ckpt-every`` steps and at the end (``--ckpt-dir``), resumed from the
newest one.  Like the JAX CLI it has no ``--attn``: attention follows the
process-wide backend, so ``with attention_impl("flash"): main([...])``
trains through the flash kernels (with VLMo's relative-position table,
their bias gradient).  Entry points run on ``cuda`` unless ``--device cpu``
is given.
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
PORTED_TASKS = TASKS  # every task of the JAX CLI
ALBEF_TASKS = ("albef_pretrain", "albef_vqa", "retrieval", "ve", "nlvr2")
ANSWER_LEN = 8  # tokens an answer slot of albef_vqa holds


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Pretraining and fine-tuning on an NVIDIA GPU")
    p.add_argument("--task", required=True, choices=TASKS)
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
                   help="pretraining arrow directory (data/pretrain_writers.py outputs or "
                        "the reference's make_arrow outputs), in place of --ann")
    p.add_argument("--arrow-datasets", nargs="+", default=None,
                   help="corpora to concat from --arrow-root: coco f30k gcc sbu vg wikibk "
                        "nlvr2 (default picked per task)")
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


def pretrain_loss_weights(preset: dict) -> dict:
    """A preset's ``loss_names`` -> ``vlmo_pretrain_loss`` weights.  Zero
    weights are kept, not dropped: the loss skips a term of weight 0, where
    a dropped one would fall back to its default of 1.0.  Exits when the
    preset enables none of mlm/itc/itm."""
    weights = {k: float(v) for k, v in preset["loss_names"].items()
               if k in ("mlm", "itc", "itm")}
    if not any(weights.values()):
        raise SystemExit("preset enables none of mlm/itc/itm "
                         f"(loss_names={preset['loss_names']}); pick one of the "
                         "mlm_itm_itc presets for --task vlmo_pretrain")
    return weights


def resolve_config(args, preset: Optional[dict], device: torch.device):
    """The run config: ``--config`` (default the ALBEF attack config), the
    preset's VLMo geometry, ``--image-size`` on both models, and on the card
    the fused residual + LayerNorm ViT for the ALBEF tasks (:data:`ALBEF_TASKS`)."""
    from vqattack_tpu_torch import config as cfg_mod

    cfg = cfg_mod.load_config(args.config) if args.config else cfg_mod.albef_attack_config()
    if preset is not None:
        from vqattack_tpu_torch.named_configs import vlmo_config_from_named

        cfg = dataclasses.replace(cfg, vlmo=vlmo_config_from_named(preset))
    if args.image_size:
        vit = dataclasses.replace(cfg.albef.vit, image_size=args.image_size)
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit),
                                  vlmo=dataclasses.replace(cfg.vlmo, image_size=args.image_size))
    if device.type == "cuda" and args.task in ALBEF_TASKS:
        vit = dataclasses.replace(cfg.albef.vit, fused_ln=True)
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit))
    return cfg


Collate = Callable[[list], Dict[str, torch.Tensor]]


def build_task(args, cfg, tokenizer, device: torch.device, preset: Optional[dict] = None
               ) -> Tuple[nn.Module, LossFn, Collate]:
    """``(model, loss_fn, collate)`` of ``args.task`` on ``device``: the
    model random from ``--seed`` (then grafted from ``--init-ckpt``), the
    loss of a collated batch, and the collate of dataset items into a batch
    on ``device``.  The MLM masks draw from a numpy generator seeded with
    ``--seed``, as the JAX CLI's do."""
    from vqattack_tpu_torch.checkpoint import io as ckpt_io
    from vqattack_tpu_torch.checkpoint.convert import graft_jax_params
    from vqattack_tpu_torch.data.collators import mlm_collate
    from vqattack_tpu_torch.train import objectives as obj

    rng_np = np.random.default_rng(args.seed)

    def tensor(x):
        x = torch.from_numpy(np.asarray(x))
        return (x.long() if x.dtype in (torch.int32, torch.int64) else x).to(device)

    def pixels(items):
        return tensor(np.concatenate([i["pixels"] for i in items]))

    def text(items, max_len):
        ids, mask = tokenizer.encode_batch([i.get("question", "") for i in items], max_len)
        return tensor(ids), tensor(mask)

    def masked_text(items, max_len, whole_word):
        c = mlm_collate([i.get("question", "") for i in items], tokenizer, max_len,
                        args.mlm_prob, whole_word=whole_word, rng=rng_np)
        return {"text_ids": tensor(c["text_ids"]), "text_mask": tensor(c["text_masks"]),
                "mlm_ids": tensor(c["text_ids_mlm"]), "mlm_labels": tensor(c["text_labels_mlm"])}

    def grafted(model, load):
        if args.init_ckpt:
            n = graft_jax_params(model, load(args.init_ckpt))
            print(f"--init-ckpt {args.init_ckpt}: {n} tensors grafted", flush=True)
        return model

    if args.task in ALBEF_TASKS:
        from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA, init_weights
        from vqattack_tpu_torch.models.albef_tasks import AlbefNLVR, AlbefRetrieval, AlbefVE

        kind = {"albef_pretrain": AlbefPretrain, "albef_vqa": AlbefVQA,
                "retrieval": AlbefRetrieval, "ve": AlbefVE, "nlvr2": AlbefNLVR}[args.task]
        with torch.device(device):
            model = init_weights(kind(cfg.albef), seed=args.seed).to(device)
        # the pre-trained file at cfg.albef's 12 layers: NLVR's layers 12-17
        # keep their initial values, as in the JAX CLI
        grafted(model, lambda path: ckpt_io.load_albef_pretrain(path, cfg.albef))
        max_len = cfg.attack.max_text_len

    if args.task == "albef_pretrain":
        def loss_fn(m, batch, key):
            return obj.albef_pretrain_loss(m, batch, key)

        def collate(items):
            return {"pixels": pixels(items), **masked_text(items, max_len, False)}

        return model, loss_fn, collate

    if args.task == "albef_vqa":
        def loss_fn(m, batch, key):
            del key
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
            ids, mask = text(items, max_len)
            return {"pixels": pixels(items), "text_ids": ids, "text_mask": mask,
                    "answer_ids": tensor(ans_ids), "answer_mask": tensor(ans_mask),
                    "answer_weights": tensor(weights)}

        return model, loss_fn, collate

    if args.task == "retrieval":
        def loss_fn(m, batch, key):
            return obj.retrieval_train_loss(m, batch, key)

        def collate(items):
            # same-image items are each other's ITA positives
            # (grounding_dataset.py:17-24); the position stands for an item
            # with no image identity
            idx = np.asarray([i.get("img_idx", n) for n, i in enumerate(items)])
            ids, mask = text(items, max_len)
            return {"pixels": pixels(items), "text_ids": ids, "text_mask": mask,
                    "idx": tensor(idx)}

        return model, loss_fn, collate

    if args.task in ("ve", "nlvr2"):
        n_cls = 3 if args.task == "ve" else 2

        def loss_fn(m, batch, key):
            del key
            logits = m(batch["pixels"], batch["text_ids"], batch["text_mask"])
            loss = obj.nlvr2_loss(logits, batch["labels"])
            return loss, {"loss": loss}

        def collate(items):
            if args.task == "nlvr2" and "pixels0" in items[0]:
                # the pair stacked, image 0 first (an NLVR annotation's or
                # NLVR2Dataset's two streams)
                px = tensor(np.concatenate([i[k] for k in ("pixels0", "pixels1")
                                            for i in items]))
            else:
                px = pixels(items)
                if args.task == "nlvr2":
                    px = torch.cat([px, px])  # the second image stream
            ids, mask = text(items, max_len)
            labels = np.asarray([int(i.get("label", 0)) % n_cls for i in items])
            return {"pixels": px, "text_ids": ids, "text_mask": mask, "labels": tensor(labels)}

        return model, loss_fn, collate

    from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

    nlvr2 = args.task == "vlmo_nlvr2"
    vcfg = cfg.vlmo
    if nlvr2:  # the second image's modality row (objectives.compute_nlvr2:416-475)
        vcfg = dataclasses.replace(vcfg, type_vocab_size=max(3, vcfg.type_vocab_size))
    with torch.device(device):
        # .to: the relative-position indices are buffers made from numpy
        model = init_vlmo_weights(VLMo(vcfg, with_nlvr2_head=nlvr2), seed=args.seed).to(device)
    grafted(model, lambda path: ckpt_io.load_vlmo(path, vcfg, token_types=3 if nlvr2 else None))
    max_len = vcfg.max_text_len

    if args.task == "vlmo_pretrain":
        # multi-loss VL pretraining (the reference's mlm_itm_itc presets)
        weights = pretrain_loss_weights(preset) if preset is not None else None
        whole_word = bool(preset["whole_word_masking"]) if preset is not None else False

        def loss_fn(m, batch, key):
            return obj.vlmo_pretrain_loss(m, batch, key, weights=weights)

        def collate(items):
            return {"pixels": pixels(items), **masked_text(items, max_len, whole_word)}

        return model, loss_fn, collate

    if args.task == "vlmo_textmlm":
        # text-only MLM (the reference's textmlm presets: the text expert
        # trained, objectives.compute_textonly_mlm), unscaled
        def loss_fn(m, batch, key):
            del key
            out = m.infer_text(batch["mlm_ids"], batch["text_mask"])
            loss = obj.masked_lm_loss(out["mlm_logits"], batch["mlm_labels"])
            return loss, {"loss": loss}

        def collate(items):
            c = masked_text(items, max_len, True)
            return {k: c[k] for k in ("text_mask", "mlm_ids", "mlm_labels")}

        return model, loss_fn, collate

    if args.task == "vlmo_irtr":
        def loss_fn(m, batch, key):
            return obj.vlmo_irtr_train_loss(m, batch, key, num_negs=2)

        def collate(items):
            ids, mask = text(items, max_len)
            return {"pixels": pixels(items), "text_ids": ids, "text_mask": mask}

        return model, loss_fn, collate

    if nlvr2:
        def loss_fn(m, batch, key):
            del key
            logits = m.nlvr2_logits(batch["pixels1"], batch["pixels2"], batch["text_ids"],
                                    batch["text_mask"])
            loss = obj.nlvr2_loss(logits, batch["labels"])
            acc = torch.mean((logits.argmax(-1) == batch["labels"]).float())
            return loss, {"loss": loss, "nlvr2_acc": acc}

        def collate(items):
            if "pixels0" in items[0]:  # the pair's two streams
                p1 = tensor(np.concatenate([i["pixels0"] for i in items]))
                p2 = tensor(np.concatenate([i["pixels1"] for i in items]))
            else:
                p1 = p2 = pixels(items)
            ids, mask = text(items, max_len)
            labels = np.asarray([int(i.get("label", 0)) % 2 for i in items])
            return {"pixels1": p1, "pixels2": p2, "text_ids": ids, "text_mask": mask,
                    "labels": tensor(labels)}

        return model, loss_fn, collate

    def loss_fn(m, batch, key):
        del key
        logits = m.vqa_logits(batch["pixels"], batch["text_ids"], batch["text_mask"])
        loss = obj.vqa_bce_loss(logits, batch["targets"])
        return loss, {"loss": loss}

    def collate(items):
        targets = np.zeros((len(items), vcfg.vqa_label_size), np.float32)
        for b, item in enumerate(items):
            for label, score in zip(item.get("answer_labels", []), item.get("answer_scores", [])):
                targets[b, int(label)] = float(score)
        ids, mask = text(items, max_len)
        return {"pixels": pixels(items), "text_ids": ids, "text_mask": mask,
                "targets": tensor(targets)}

    return model, loss_fn, collate


# every other task: the caption corpora
DEFAULT_CORPORA = {"vlmo_textmlm": ["wikibk"], "nlvr2": ["nlvr2"], "vlmo_nlvr2": ["nlvr2"]}
CAPTION_CORPORA = ["coco", "f30k", "gcc", "sbu", "vg"]


def build_dataset(args, size: int):
    """The training items: ``--arrow-root``'s corpora concatenated (those
    the directory lacks skipped), else the ``--ann`` annotations."""
    from vqattack_tpu_torch.data.transforms import train_transform

    if args.arrow_root:
        from vqattack_tpu_torch.data.pretrain_datasets import ConcatDataset, make_pretrain_dataset

        names = args.arrow_datasets or DEFAULT_CORPORA.get(args.task, CAPTION_CORPORA)
        parts = []
        for name in names:
            try:
                parts.append(make_pretrain_dataset(name, args.arrow_root, train_transform(size),
                                                   split="train"))
            except FileNotFoundError:
                pass  # a corpus not written into this directory
        if not parts:
            raise SystemExit(f"no arrow corpora from {names} under {args.arrow_root}")
        return ConcatDataset(parts) if len(parts) > 1 else parts[0]
    if not (args.ann and args.image_root):
        raise SystemExit("--ann and --image-root, or --arrow-root, are required")
    from vqattack_tpu_torch.data.vqa import VQADataset

    return VQADataset(args.ann, args.image_root, train_transform(size),
                      answer_list=args.answer_list, split="train")


def main(argv=None) -> dict:
    """Train; returns ``{"task", "start_step", "step", "losses", "grad_norms",
    "log_times"}``: the steps' losses and gradient norms as logged, and the
    host clock after each log step's metrics were read (the device's work up
    to that step done)."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    preset = apply_preset(parser, args)

    from vqattack_tpu_torch.checkpoint.io import restore_latest_train_state, save_train_state
    from vqattack_tpu_torch.device import resolve_device
    from vqattack_tpu_torch.rng import TorchKey
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer
    from vqattack_tpu_torch.train.optim import create_optimizer, create_schedule
    from vqattack_tpu_torch.train.trainer import create_train_state, make_train_step
    from vqattack_tpu_torch.utils.meters import MetricLogger

    device = resolve_device(args.device)
    cfg = resolve_config(args, preset, device)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    size = cfg.albef.vit.image_size if args.task in ALBEF_TASKS else cfg.vlmo.image_size
    dataset = build_dataset(args, size)
    model, loss_fn, collate = build_task(args, cfg, tokenizer, device, preset)

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
    key = TorchKey(args.seed + 1, device)
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
        key, k = key.split()
        state, metrics = step_fn(state, batch, k)
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
