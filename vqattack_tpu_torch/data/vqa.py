"""VQAv2 dataset over JSON annotations + JPEGs (the ALBEF data path).

Port of ``vqattack_tpu/data/vqa.py`` (reference ``dataset/vqa_dataset.py``
and the task datasets beside it): per item ``{question, qid, pixels [1, 3,
H, W], answers, weights}``, with the question normalised by
:func:`pre_question` and answer-frequency weights.  The test split is what
the attack reads; the train split (the fine-tuning tasks) appends the
``[SEP]`` eos to every answer (``vqa_dataset.py:89``).

The annotation dialects of the reference's task datasets are read too: the
text from ``question``, else ``sentence`` (VE, NLVR), ``text`` (grounding)
or ``caption`` (retrieval; the first of a list); an image name without an
extension gets ``.jpg`` (``ve_dataset.py:24``); NLVR's ``images`` pair
gives ``pixels0``, ``pixels1`` and ``pixels`` (the first); a single image
gives ``img_idx``, the image's identity index (same-image items are
retrieval's positives), kept under a lock; ``label`` (a string label mapped
by ``_STR_LABELS``), VLMo's soft targets, ``sentence`` and ``ref_id`` pass
through.  Images are decoded with PIL, imported only when an image is read.
"""

from __future__ import annotations

import json
import os
import random
import re
import threading
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
        self._img_ids: Dict[str, int] = {}
        self._img_ids_lock = threading.Lock()

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

    # the string labels of the task annotations: SNLI-VE's (ve_dataset.py:14)
    # and NLVR's 'True'/'False' (nlvr_dataset.py:35-38)
    _STR_LABELS = {"entailment": 2, "neutral": 1, "contradiction": 0, "True": 1, "False": 0}

    def _load_pixels(self, name: str):
        from PIL import Image

        path = os.path.join(self.image_root, name)
        if "." not in os.path.basename(name):
            path += ".jpg"  # ve_dataset.py:24 appends the extension
        with Image.open(path) as img:
            return self.transform(img)[None]  # [1, 3, H, W]

    def _get_item(self, idx: int) -> Dict[str, Any]:
        ann = self.ann[idx]
        text = ann.get("question")
        if text is None:
            text = ann.get("sentence", ann.get("text", ann.get("caption", "")))
        if isinstance(text, list):  # a caption file may hold several
            text = text[0] if text else ""
        item: Dict[str, Any] = {"question": pre_question(text, self.max_ques_words),
                                "qid": ann.get("question_id")}
        if "images" in ann:  # NLVR's pair (nlvr_dataset.py:25-31)
            item["pixels0"] = self._load_pixels(ann["images"][0])
            item["pixels1"] = self._load_pixels(ann["images"][1])
            item["pixels"] = item["pixels0"]
        else:
            item["pixels"] = self._load_pixels(ann["image"])
            # the image's identity index (grounding_dataset.py:17-24); the
            # read and the insert under one lock, so that two images read on
            # two threads never share an index
            img_id = str(ann["image"]).split("/")[-1]
            with self._img_ids_lock:
                item["img_idx"] = self._img_ids.setdefault(img_id, len(self._img_ids))
        for key in ("label", "answer_labels", "answer_scores", "sentence", "ref_id"):
            if key in ann:
                item[key] = ann[key]
        if isinstance(item.get("label"), str):
            item["label"] = self._STR_LABELS.get(item["label"], 0)
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

    def iter_batches(self, indices: Optional[Sequence[int]] = None, num_workers: int = 4,
                     prefetch: int = 8) -> Iterator[Dict[str, Any]]:
        """The items of ``indices`` (default: all) in order, decoded on
        ``num_workers`` threads (``data/iter_utils.py``).  What a read
        shares across threads: the identity table, under its lock (a
        threaded read may number the images in another order than a serial
        one; same image, same index holds either way), the retry's
        resampler, drawn from its own ``random.Random``, and the transform,
        whose shared generator (``train_transform``'s) then draws in the
        workers' order."""
        from vqattack_tpu_torch.data.iter_utils import threaded_iter

        yield from threaded_iter(self, indices, num_workers, prefetch)
