"""The ALBEF attack CLI of the port::

    python -m vqattack_tpu_torch.run --pipeline albef --vocab vocab.txt \\
        --ann vqa_val.json --image-root /data/val2014 --answer-list answers.json \\
        --right-part right.txt --surrogate-ans sur.json --target-ans tgt.json \\
        --paraphrases para.json --all-correct allc.json --output attack_out

Port of the per-sample ALBEF path of ``vqattack_tpu/run.py``: subset and
alignment guards -> per-sample attack -> black-box victim check every
``eval_every`` samples -> artifacts.  Runs on ``cuda`` unless ``--device cpu``.
Weights are random, drawn from ``--seed``: loading ``.pth`` checkpoints, the
batched engine, the VLMo pipeline and the USE gate are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VQAttack on PyTorch + CUDA")
    p.add_argument("--pipeline", choices=["albef"], default="albef")
    p.add_argument("--config", default=None, help="RunConfig json")
    p.add_argument("--vocab", required=True, help="WordPiece vocab.txt")
    p.add_argument("--ann", nargs="*", default=[], help="VQA annotation json(s)")
    p.add_argument("--image-root", default="")
    p.add_argument("--answer-list", default=None)
    p.add_argument("--right-part", nargs="*", default=[])
    p.add_argument("--surrogate-ans", nargs="*", default=[])
    p.add_argument("--target-ans", nargs="*", default=[])
    p.add_argument("--paraphrases", nargs="*", default=[])
    p.add_argument("--all-correct", nargs="*", default=[])
    p.add_argument("--output", default="attack_out")
    p.add_argument("--answer-max-len", type=int, default=16,
                   help="token budget of the answer-list tokenization")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true",
                   help="skip qids whose artifact already exists in --output")
    p.add_argument("--bert-threshold", type=float, default=None,
                   help="operating point of the BertMeanPoolGate in its own space")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def resolve_config(args):
    """--config if given, else the ALBEF attack preset; then --seed,
    --output, and the slice's kernel switch: the ViT's residual+LayerNorm
    sites take the fused kernel (``vit.fused_ln``) on the card."""
    from vqattack_tpu_torch import config as cfg_mod

    cfg = cfg_mod.load_config(args.config) if args.config else cfg_mod.albef_attack_config()
    cfg = dataclasses.replace(cfg, output_dir=args.output, seed=args.seed)
    if args.device == "cuda":
        vit = dataclasses.replace(cfg.albef.vit, fused_ln=True)
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit))
    if cfg.compute_dtype != "float32":
        raise SystemExit("the port runs compute_dtype float32 only so far")
    return cfg


def _build_pipeline(args, cfg, tokenizer):
    """Random-weight surrogate, victim and candidate MLM on ``args.device``,
    the BertMeanPoolGate over the surrogate's text tower, and the pipeline."""
    from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline
    from vqattack_tpu_torch.device import resolve_device
    from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA, init_weights
    from vqattack_tpu_torch.models.bert import FusionBert
    from vqattack_tpu_torch.text.similarity import make_gate

    device = resolve_device(args.device)
    mlm_cfg = dataclasses.replace(cfg.albef.bert, fusion_layer=cfg.albef.bert.num_layers)
    with torch.device(device):
        surrogate = init_weights(AlbefPretrain(cfg.albef), seed=args.seed)
        victim = init_weights(AlbefVQA(cfg.albef), seed=args.seed + 3)
        mlm = init_weights(FusionBert(mlm_cfg, with_mlm_head=True), seed=args.seed + 1)
    kw = {}
    if args.bert_threshold is not None:
        kw["bert_threshold"] = args.bert_threshold

    @torch.no_grad()
    def embed_fn(ids, mask):
        return surrogate.text_tower(ids, mask)

    gate = make_gate("bert", embed_fn=embed_fn, tokenizer=tokenizer,
                     max_length=cfg.attack.max_text_len, device=device, **kw)
    return AlbefAttackPipeline(cfg, surrogate, tokenizer, gate, victim=victim,
                               mlm_model=mlm, device=device)


def main(argv: Optional[list] = None) -> dict:
    args = build_argparser().parse_args(argv)
    from vqattack_tpu_torch.attacks.orchestrator import save_artifacts
    from vqattack_tpu_torch.data.side_tables import SideTables
    from vqattack_tpu_torch.data.transforms import test_transform
    from vqattack_tpu_torch.data.vqa import VQADataset
    from vqattack_tpu_torch.eval.metrics import AttackAccuracy
    from vqattack_tpu_torch.rng import TorchKey
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = resolve_config(args)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    side = None
    if args.right_part:
        side = SideTables.load(args.right_part, args.surrogate_ans, args.target_ans,
                               args.paraphrases, args.all_correct)
    pipeline = _build_pipeline(args, cfg, tokenizer)
    dataset = VQADataset(args.ann, args.image_root, test_transform(cfg.albef.vit.image_size),
                         answer_list=args.answer_list)
    if not dataset.answer_list:
        raise SystemExit("--answer-list is required: the ALBEF victim ranks a fixed "
                         "candidate-answer list (model_vqa.py:149)")
    ids, mask = tokenizer.encode_batch([a + "[SEP]" for a in dataset.answer_list],
                                       max_length=args.answer_max_len)
    answer_ids = torch.as_tensor(ids, dtype=torch.long, device=pipeline.device)
    answer_mask = torch.as_tensor(mask, dtype=torch.long, device=pipeline.device)

    flip = AttackAccuracy(print_every=50)
    key = TorchKey(cfg.seed, pipeline.device)
    results, pending, attack_s = [], [], []

    def eval_pending():
        for r, clean in pending:
            if clean is None:
                continue
            topk_ids, _ = pipeline.evaluate_victim(r.adv_image, r.adv_text,
                                                   answer_ids, answer_mask)
            flip.update(dataset.answer_list[int(topk_ids[0, 0])], clean)
            flip.maybe_log()
        pending.clear()

    for item in dataset:
        qid = item["qid"]
        info = side.attack_inputs(qid) if side else {
            "paraphrase": None, "target_answer": None,
            "all_correct_answers": [], "surrogate_answer": None,
        }
        if info is None:
            continue  # not in the attack subset
        # alignment guard (adv_attack.py:416-427): the stored surrogate answer
        # must be a max-weight ground-truth answer, else the sample is skipped
        if side and item.get("answers") and not side.alignment_ok(
                qid, item["answers"], item["weights"]):
            continue
        if args.resume and os.path.exists(os.path.join(args.output, f"{qid}.pt")):
            continue
        t0 = time.perf_counter()
        res = pipeline.attack_sample(
            item["pixels"], item["question"], str(qid), info["paraphrase"],
            info["target_answer"], info["all_correct_answers"], key=key,
        )
        attack_s.append(time.perf_counter() - t0)
        results.append(res)
        pending.append((res, info["surrogate_answer"]))
        if len(pending) >= cfg.eval_every:
            eval_pending()
        if args.limit and len(results) >= args.limit:
            break
    eval_pending()
    save_artifacts(results, args.output)
    summary = {
        "samples": len(results),
        "attack_accuracy": flip.value,
        "attack_accuracy_note": "random-weight victim: flips are no evidence of attack success",
        "mean_attack_s": float(np.mean(attack_s)) if attack_s else 0.0,
        "device": str(pipeline.device),
        "output": args.output,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
