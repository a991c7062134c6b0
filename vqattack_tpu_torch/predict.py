"""Inference CLI, the reference's Replicate ``predict.py`` surface: answer a
question about an image with a fine-tuned victim::

    python -m vqattack_tpu_torch.predict --pipeline albef \\
        --image img.jpg --question "what color is the dog" \\
        --vocab vocab.txt --victim-ckpt albef_vqa.pth \\
        --answer-list answer_list.json [--topk 5] [--device cpu]

Port of ``vqattack_tpu/predict.py``.  :class:`Predictor` answers from a
resident victim built by ``run._build_pipeline``: the ALBEF victim ranks
``--answer-list`` in two passes, the VLMo (or ViLT, by ``--config``)
victim takes its classifier's softmax.  The question is normalised by
``data/vqa.py::pre_question`` as the dataset path normalises it, so a served
answer and a sweep's agree.  The image is read with PIL and resized to the
victim's own image size.  Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Predictor:
    """Resident-victim VQA answering (ALBEF ``rank_answer`` or the VLMo
    classifier).  ``pixels``: ``[1, 3, H, W]`` float32 in [-1, 1]."""

    def __init__(self, pipeline, answer_list: Sequence[str] = (), answer_ids=None,
                 answer_mask=None):
        self.pipeline = pipeline
        self.answer_list = list(answer_list)
        self.answer_ids = answer_ids
        self.answer_mask = answer_mask

    def answer(self, pixels, question: str, topk: int = 5) -> List[Tuple[str, float]]:
        if self.answer_ids is not None:  # ALBEF: two-pass ranking
            topk_ids, topk_probs = self.pipeline.evaluate_victim(
                pixels, question, self.answer_ids, self.answer_mask)
            return [(self.answer_list[int(i)], float(p))
                    for i, p in zip(topk_ids[0][:topk], topk_probs[0][:topk])]
        pipe = self.pipeline  # VLMo: the classifier
        ids, mask = pipe.encode(question)
        px = torch.as_tensor(np.asarray(pixels), dtype=torch.float32, device=pipe.device)
        with torch.no_grad():
            logits = pipe.victim.vqa_logits(px, ids, mask, pipe._victim_rel_biases)
        probs = torch.softmax(logits.float(), -1)[0].cpu().numpy()
        order = np.argsort(-probs)[:topk]
        return [(pipe.id2answer.get(int(i), str(int(i))), float(probs[i])) for i in order]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VQA inference")
    p.add_argument("--pipeline", choices=["albef", "vlmo"], default="albef")
    p.add_argument("--image", required=True)
    p.add_argument("--question", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--victim-ckpt", default=None)
    p.add_argument("--answer-list", default=None)
    p.add_argument("--id2answer", default=None)
    p.add_argument("--answer-max-len", type=int, default=16)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def read_image(path: str, size: int) -> np.ndarray:
    """``[1, 3, size, size]`` float32 from an image file (PIL, imported here:
    the card's machine has none)."""
    from PIL import Image

    from vqattack_tpu_torch.data.transforms import test_transform

    with Image.open(path) as img:
        return test_transform(size)(img)[None]


def main(argv: Optional[list] = None) -> dict:
    args = build_argparser().parse_args(argv)
    from vqattack_tpu_torch.data.vqa import pre_question
    from vqattack_tpu_torch.run import _build_pipeline, resolve_config
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer
    from vqattack_tpu_torch.transfer_eval import answer_table, pipeline_args

    run_args = pipeline_args(args)
    cfg = resolve_config(run_args)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    size = cfg.vlmo.image_size if args.pipeline == "vlmo" else cfg.albef.vit.image_size
    pipeline = _build_pipeline(run_args, cfg, tokenizer)
    predictor = Predictor(pipeline, *answer_table(args, tokenizer, pipeline.device))
    question = pre_question(args.question)
    out = {"question": question,
           "answers": predictor.answer(read_image(args.image, size), question, args.topk)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
