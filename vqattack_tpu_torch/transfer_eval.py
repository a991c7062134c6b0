"""Offline black-box transfer evaluation over stored adversarial artifacts.

Port of ``vqattack_tpu/transfer_eval.py``.  The reference persists each
qid's adversarial image and one text JSON, and runs the black-box transfer
(to ViLT, BLIP, ...) offline from them (SURVEY §0.3).  This CLI replays an
attack's output directory against a victim the port can load::

    python -m vqattack_tpu_torch.transfer_eval --pipeline albef \\
        --artifacts attack_out --vocab vocab.txt \\
        --victim-ckpt albef_vqa.pth --answer-list answers.json \\
        --surrogate-ans albef_ans_table.txt [--config blip.json] [--device cpu]

It reads ``<artifacts>/*.npy`` (NHWC, as ``run.py`` writes them) and
``adv_txt_dict.json``, and scores the pairs in chunks of 16 through the
victim of ``run._build_pipeline``: ``--pipeline albef`` ranks
``--answer-list`` with an ALBEF-VQA victim (BLIP-VQA with a ``--config``
whose ``albef`` is ``config.blip_vqa_config()``), ``--pipeline vlmo`` takes
the 3,129-way classifier of VLMo (or ViLT, with a ``--config`` whose
``vlmo`` is ``config.vilt_base_config()``).  The config goes through
``run.resolve_config``, so on the card the ALBEF and BLIP victims' ViT takes
the fused residual+LayerNorm kernel, and ``--attn flash`` the flash kernel.
Prints one JSON line: ``samples``, the flip rate against
``--surrogate-ans`` (``attack_accuracy``) and, with ``--gt-answers``, the
official VQA soft accuracy.  Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

CHUNK = 16  # pairs a victim call scores


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="offline transfer eval")
    p.add_argument("--pipeline", choices=["albef", "vlmo"], default="albef")
    p.add_argument("--artifacts", required=True, help="attack output dir")
    p.add_argument("--txt-json", default=None,
                   help="adv text dict (default: <artifacts>/adv_txt_dict.json)")
    p.add_argument("--config", default=None)
    p.add_argument("--vocab", required=True)
    p.add_argument("--victim-ckpt", default=None)
    p.add_argument("--answer-list", default=None)
    p.add_argument("--id2answer", default=None)
    p.add_argument("--surrogate-ans", nargs="*", default=[],
                   help="clean answers to measure flips against")
    p.add_argument("--gt-answers", default=None,
                   help="json {qid: [human answers]} for soft accuracy")
    p.add_argument("--answer-max-len", type=int, default=16)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--attn", choices=["xla", "flash"], default="xla",
                   help="attention over >= 128 queries: product + softmax or the flash kernel")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="the surrogate trunk's compute dtype (VLMo's victim runs in it)")
    return p


def pipeline_args(args) -> argparse.Namespace:
    """The ``run.py`` arguments that ``run.resolve_config`` and
    ``run._build_pipeline`` read, with the values of those ``args`` has: no
    surrogate or MLM checkpoint, random weights (where no checkpoint is
    given) from ``run.py``'s default seed."""
    from vqattack_tpu_torch.run import build_argparser as run_argparser

    run_args = run_argparser().parse_args(["--vocab", args.vocab])
    for name in ("pipeline", "config", "victim_ckpt", "id2answer", "device", "attn", "dtype"):
        if hasattr(args, name):
            setattr(run_args, name, getattr(args, name))
    return run_args


def answer_table(args, tokenizer, device) -> tuple:
    """``(answer_list, answer_ids, answer_mask)`` the ALBEF victim ranks;
    empty and None for VLMo."""
    if args.pipeline != "albef":
        return [], None, None
    if not args.answer_list:
        raise SystemExit("--answer-list is required for --pipeline albef (the ALBEF "
                         "victim ranks a fixed candidate-answer list)")
    with open(args.answer_list) as f:
        answer_list = json.load(f)
    ids, mask = tokenizer.encode_batch([a + "[SEP]" for a in answer_list],
                                       max_length=args.answer_max_len)
    return (answer_list, torch.as_tensor(ids, dtype=torch.long, device=device),
            torch.as_tensor(mask, dtype=torch.long, device=device))


def replay(pipeline, files: Sequence[str], adv_texts: Dict[str, str],
           clean_answers: Dict[str, str], gt: Dict[str, List[str]],
           answer_list: Sequence[str] = (), answer_ids=None, answer_mask=None) -> dict:
    """Score the artifacts ``files`` (NHWC ``.npy``) with ``pipeline``'s
    victim, :data:`CHUNK` pairs a call: ``{"samples", "attack_accuracy",
    "vqa_soft_accuracy"}``, each rate None without anything to measure it
    against."""
    from vqattack_tpu_torch.eval.metrics import AttackAccuracy
    from vqattack_tpu_torch.eval.vqa_eval import VQAEval

    flip, vqa = AttackAccuracy(), VQAEval()
    for start in range(0, len(files), CHUNK):
        chunk = files[start : start + CHUNK]
        qids = [os.path.splitext(os.path.basename(p))[0] for p in chunk]
        images = [np.ascontiguousarray(np.load(p).transpose(0, 3, 1, 2)) for p in chunk]
        texts = [adv_texts.get(q, "") for q in qids]
        if answer_ids is not None:
            topk_ids, _ = pipeline.evaluate_victim_batch(images, texts, answer_ids, answer_mask)
            preds = [answer_list[int(row[0])] for row in topk_ids]
        else:
            preds = [a for _, a in pipeline.evaluate_victim_batch(images, texts)]
        for qid, pred in zip(qids, preds):
            clean = clean_answers.get(qid)
            if clean is not None:
                flip.update(pred, clean)
            if qid in gt:
                vqa.update(qid, pred, gt[qid])
    return {
        "samples": len(files),
        "attack_accuracy": flip.value if flip.flips else None,
        "vqa_soft_accuracy": vqa.accuracy if vqa.accuracies else None,
    }


def artifact_files(artifacts: str, limit: Optional[int] = None) -> List[str]:
    files = sorted(glob.glob(os.path.join(artifacts, "*.npy")))
    return files[:limit] if limit else files


def read_tables(args) -> tuple:
    """``(adv_texts, clean_answers, gt)`` from the text JSON (absent: no
    text), ``--surrogate-ans`` and ``--gt-answers``."""
    txt_path = args.txt_json or os.path.join(args.artifacts, "adv_txt_dict.json")
    adv_texts: Dict[str, str] = {}
    if os.path.exists(txt_path):
        with open(txt_path) as f:
            adv_texts = json.load(f)
    clean: Dict[str, str] = {}
    for path in args.surrogate_ans:
        with open(path) as f:
            clean.update(json.load(f))
    gt: Dict[str, List[str]] = {}
    if args.gt_answers:
        with open(args.gt_answers) as f:
            gt = json.load(f)
    return adv_texts, clean, gt


def main(argv: Optional[list] = None) -> dict:
    args = build_argparser().parse_args(argv)
    from vqattack_tpu_torch.ops.attention import attention_impl
    from vqattack_tpu_torch.run import _build_pipeline, resolve_config
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

    run_args = pipeline_args(args)
    cfg = resolve_config(run_args)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    with attention_impl(args.attn):
        pipeline = _build_pipeline(run_args, cfg, tokenizer)
        answers = answer_table(args, tokenizer, pipeline.device)
        out = replay(pipeline, artifact_files(args.artifacts, args.limit), *read_tables(args),
                     *answers)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
