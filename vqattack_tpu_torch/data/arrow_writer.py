"""VQAv2 json+jpeg -> arrow table writer (the reference's ``make_arrow``
pipelines, ``vlmo/utils/write_vqa.py`` + ``glossary.py`` normalization).

Port of ``vqattack_tpu/data/arrow_writer.py``, pure pyarrow (imported inside
the writer): the same files give tables with the same schema and rows.

Schema per row: image bytes, questions (list per image), answers,
answer_labels (indices into the 3,129-answer vocabulary), answer_scores (the
official soft scores), question_id, split.
"""

from __future__ import annotations

import json
import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence


def normalize_word(word: str) -> str:
    """Glossary answer normalization (``vlmo/utils/glossary.py:167-190``) =
    the official VQA rules: punctuation rules (digit-aware period/comma
    handling), number words -> digits, article removal, contraction
    restoration — delegated to :mod:`vqattack_tpu_torch.eval.vqa_eval`, which
    implements the identical spec constants.  A simplified strip (no
    contractions, unconditional period removal) would build a DIFFERENT
    3,129-answer vocabulary ("dont know" vs "don't know", "1.5" vs "15")."""
    from vqattack_tpu_torch.eval.vqa_eval import normalize_answer

    return normalize_answer(word)


def build_answer_vocab(
    annotations: Sequence[dict], min_count: int = 9
) -> List[str]:
    """The reference label space (``write_vqa.py:91-106``): normalized
    ``multiple_choice_answer`` strings with count >= 9 over train+val, in
    FIRST-OCCURRENCE order (dict insertion order of the Counter) — NOT
    frequency order; on real VQAv2 this yields exactly the 3,129 labels
    reference-trained classifier heads index into.  Annotations lacking
    ``multiple_choice_answer`` fall back to the per-question majority
    answer."""
    majors: List[str] = []
    for ann in annotations:
        a = ann.get("multiple_choice_answer")
        if a is None:
            raw = [x.get("answer", x) if isinstance(x, dict) else x
                   for x in ann.get("answers", [])]
            if not raw:
                continue
            a = Counter(raw).most_common(1)[0][0]
        majors.append(normalize_word(a))
    counts = Counter(majors)
    return [w for w, c in counts.items() if c >= min_count]


def soft_score(count: int) -> float:
    """The reference writer's occurrence table (``write_vqa.py::get_score``):
    1 -> 0.3, 2 -> 0.6, 3 -> 0.9, >=4 -> 1.0.  (NOT min(1, n/3): a count-3
    answer scores 0.9 here; the official evaluation-side accuracy keeps its
    own min(1, n/3) in eval/vqa_eval.py.)"""
    if count <= 0:
        return 0.0
    return {1: 0.3, 2: 0.6, 3: 0.9}.get(count, 1.0)


def write_vqa_arrow(
    questions_json: str,
    annotations_json: Optional[str],
    image_root: str,
    out_path: str,
    answer_vocab: Optional[List[str]] = None,
    split: str = "val",
) -> List[str]:
    """Build the arrow table.  Returns the answer vocabulary used."""
    import pyarrow as pa

    with open(questions_json) as f:
        questions = json.load(f)["questions"]
    anns_by_qid: Dict[int, dict] = {}
    if annotations_json:
        with open(annotations_json) as f:
            for ann in json.load(f)["annotations"]:
                anns_by_qid[ann["question_id"]] = ann
    if answer_vocab is None and anns_by_qid:
        answer_vocab = build_answer_vocab(list(anns_by_qid.values()))
        if not answer_vocab:
            # tiny corpora (fixtures) never reach the >= 9 threshold
            answer_vocab = build_answer_vocab(
                list(anns_by_qid.values()), min_count=1
            )
    vocab_index = {a: i for i, a in enumerate(answer_vocab or [])}

    by_image: Dict[str, dict] = defaultdict(
        lambda: {"questions": [], "answers": [], "answer_labels": [],
                 "answer_scores": [], "question_id": []}
    )
    for q in questions:
        img_name = f"COCO_{split}2014_{q['image_id']:012d}.jpg"
        row = by_image[img_name]
        row["questions"].append(q["question"])
        row["question_id"].append(q["question_id"])
        ann = anns_by_qid.get(q["question_id"])
        if ann:
            # the reference counts RAW annotator strings and looks them up
            # in the NORMALIZED vocab (write_vqa.py:113-127) — raw forms
            # that normalize differently (e.g. "two" vs vocab "2") are
            # dropped from the labels; reproduced verbatim so repo-written
            # and reference-written tables stay interchangeable
            counts = Counter(a["answer"] for a in ann["answers"])
            labels, scores, answers = [], [], []
            for a, c in counts.items():
                if a in vocab_index:
                    labels.append(vocab_index[a])
                    scores.append(soft_score(c))
                    answers.append(a)
            row["answers"].append(answers)
            row["answer_labels"].append(labels)
            row["answer_scores"].append(scores)
        else:
            row["answers"].append([])
            row["answer_labels"].append([])
            row["answer_scores"].append([])

    rows = []
    for img_name, row in by_image.items():
        path = os.path.join(image_root, img_name)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            img_bytes = f.read()
        rows.append(
            {
                "image": img_bytes,
                "questions": row["questions"],
                "answers": row["answers"],
                "answer_labels": row["answer_labels"],
                "answer_scores": row["answer_scores"],
                "question_id": row["question_id"],
                "split": split,
            }
        )
    table = pa.Table.from_pylist(rows)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with pa.OSFile(out_path, "wb") as sink:
        with pa.RecordBatchFileWriter(sink, table.schema) as writer:
            writer.write_table(table)
    return answer_vocab or []
