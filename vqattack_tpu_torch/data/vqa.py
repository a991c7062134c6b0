"""VQAv2 dataset over JSON annotations + JPEGs (the ALBEF data path).

Port of the VQA part of ``vqattack_tpu/data/vqa.py`` (reference
``dataset/vqa_dataset.py``): per item ``{question, qid, pixels [1, 3, H, W],
answers, weights}``, with the question normalised by :func:`pre_question`
and answer-frequency weights, and VLMo's soft targets (``answer_labels``,
``answer_scores``) passed through where the annotation has them.  The test
split is what the attack reads; the train split (the VQA fine-tuning
tasks) appends the ``[SEP]`` eos to every answer (``vqa_dataset.py:89``).
Images are decoded with PIL, imported only when an image is read.
"""

from __future__ import annotations

import json
import os
import random
import re
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


def pre_question(question: str, max_words: int = 50) -> str:
    """Lowercase, strip the reference's punctuation set, map ``-``/``/`` to
    spaces, cap the word count (``dataset/utils.py:3-16``)."""
    q = re.sub(r"([,.'!?\"()*#:;~])", "", question.lower())
    q = q.replace("-", " ").replace("/", " ")
    q = q.rstrip(" ")
    words = q.split(" ")
    if len(words) > max_words:
        q = " ".join(words[:max_words])
    return q


class VQADataset:
    def __init__(self, ann_files: Sequence[str], image_root: str, transform: Callable,
                 answer_list: Optional[str] = None, max_ques_words: int = 30,
                 split: str = "test"):
        if split not in ("test", "train"):
            raise ValueError(f"unknown split {split!r}; use 'test' or 'train'")
        self.ann: List[dict] = []
        for f in ann_files:
            with open(f) as fh:
                self.ann.extend(json.load(fh))
        self.image_root = image_root
        self.transform = transform
        self.max_ques_words = max_ques_words
        self.split = split
        self.answer_list: List[str] = []
        if answer_list:
            with open(answer_list) as fh:
                self.answer_list = json.load(fh)

    def __len__(self) -> int:
        return len(self.ann)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        """Corrupt or missing images retry with a random resample (reference
        ``base_dataset.get_suite``, ``:149-168``)."""
        for attempt in range(8):
            try:
                return self._get_item(idx)
            except (OSError, KeyError, ValueError):
                if attempt == 7:
                    raise
                idx = random.Random(idx + attempt).randrange(len(self))
        raise RuntimeError("unreachable")

    def _load_pixels(self, name: str):
        from PIL import Image

        with Image.open(os.path.join(self.image_root, name)) as img:
            return self.transform(img)[None]  # [1, 3, H, W]

    def _get_item(self, idx: int) -> Dict[str, Any]:
        ann = self.ann[idx]
        item: Dict[str, Any] = {
            "question": pre_question(ann["question"], self.max_ques_words),
            "qid": ann.get("question_id"),
            "pixels": self._load_pixels(ann["image"]),
        }
        for key in ("answer_labels", "answer_scores"):
            if key in ann:
                item[key] = ann[key]
        # answer-frequency weights (vqa_dataset.py:44-66): each occurrence
        # adds 1/len(answers), so a question's weights sum to 1
        raw = ann.get("answer", [])
        answers: List[str] = []
        weights: List[float] = []
        for a in raw:
            if a in answers:
                weights[answers.index(a)] += 1 / len(raw)
            else:
                answers.append(a)
                weights.append(1 / len(raw))
        if self.split == "train":
            item["answers"] = [a + "[SEP]" for a in answers]
            item["weights"] = weights
        elif answers:  # test answers carry no eos (vqa_dataset.py:64-67)
            item["answers"] = answers
            item["weights"] = weights
        return item

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]
