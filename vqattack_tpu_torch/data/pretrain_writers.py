"""Raw-data -> arrow writers for the VLMo pretraining datasets.

Port of ``vqattack_tpu/data/pretrain_writers.py``, pure pyarrow (imported
inside the writers).  It mirrors the reference's ``vlmo/utils/write_*.py``
pipelines: the same raw layouts, arrow schemas and file names, so that the
tables either package writes, or the reference's, are interchangeable:

- :func:`write_coco_karpathy`   (``write_coco_karpathy.py``: karpathy json +
  ``train2014``/``val2014`` jpegs -> ``coco_caption_karpathy_{split}.arrow``,
  splits train/val/restval/test, schema [image, caption, image_id, split]);
- :func:`write_f30k_karpathy`   (``write_f30k_karpathy.py``: karpathy json +
  ``flickr30k-images`` -> ``f30k_caption_karpathy_{split}.arrow``);
- :func:`write_conceptual_caption` (``write_conceptual_caption.py``:
  ``{split}_annot.json`` [[path, caption], ...] + ``images_{split}/*/*`` ->
  ``conceptual_caption_{split}_{sub}.arrow`` in 100k-row shards);
- :func:`write_sbu`             (``write_sbu.py``: ``annot.json`` +
  ``images_train/*/*`` -> ``sbu_{sub}.arrow``);
- :func:`write_vg`              (``write_vg.py``: region_descriptions.json +
  ``images/VG_100K{,_2}`` -> ``vg.arrow``, schema adds region geometry);
- :func:`write_wikibk`          (``write_wikibk.py``: ``wikibk.{i}.txt``
  sentence files -> ``wikibk_train_{i}.arrow``, text-only: image = "None");
- :func:`write_nlvr2`           (``write_nlvr2.py``: jsonl annotation files +
  paired pngs -> ``nlvr2_{split}.arrow``, schema [image_0, image_1,
  questions, answers, identifier]);
- :func:`write_text_vqa`        (``write_text_vqa.py``: TextVQA 0.5.1 jsons +
  ``train_images`` jpegs -> ``text_vqa_{split}.arrow``, VQA-style schema
  with the writer's occurrence-count soft scores).

All writers are pure pyarrow (no pandas dependency) and shard/iterate
deterministically — the reference shuffles image order before writing
(``random.shuffle(paths)``), which only permutes row order; row order is not
part of the contract any dataset class relies on.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from glob import glob
from typing import Dict, List, Optional, Sequence


def _write_table(rows: List[dict], columns: Sequence[str], out_path: str) -> None:
    import pyarrow as pa

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    arrays = {c: [r[c] for r in rows] for c in columns}
    table = pa.table(arrays)
    with pa.OSFile(out_path, "wb") as sink:
        with pa.RecordBatchFileWriter(sink, table.schema) as writer:
            writer.write_table(table)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _karpathy_rows(captions_json: str, image_globs: Sequence[str]):
    """Shared karpathy-format reader (coco + f30k): returns
    [(image_bytes, captions, filename, split), ...]."""
    with open(captions_json) as f:
        images = json.load(f)["images"]
    iid2captions: Dict[str, List[str]] = defaultdict(list)
    iid2split: Dict[str, str] = {}
    for img in images:
        iid2split[img["filename"]] = img["split"]
        for s in img["sentences"]:
            iid2captions[img["filename"]].append(s["raw"])
    rows = []
    for pattern in image_globs:
        for path in sorted(glob(pattern)):
            name = os.path.basename(path)
            if name not in iid2captions:
                continue
            rows.append(
                {
                    "image": _read_bytes(path),
                    "caption": iid2captions[name],
                    "image_id": name,
                    "split": iid2split[name],
                }
            )
    return rows


def write_coco_karpathy(root: str, dataset_root: str) -> List[str]:
    """COCO karpathy splits (``write_coco_karpathy.py:22-63``)."""
    rows = _karpathy_rows(
        os.path.join(root, "karpathy", "dataset_coco.json"),
        [os.path.join(root, "train2014", "*.jpg"),
         os.path.join(root, "val2014", "*.jpg")],
    )
    out = []
    for split in ["train", "val", "restval", "test"]:
        batch = [r for r in rows if r["split"] == split]
        path = os.path.join(dataset_root, f"coco_caption_karpathy_{split}.arrow")
        _write_table(batch, ["image", "caption", "image_id", "split"], path)
        out.append(path)
    return out


def write_f30k_karpathy(root: str, dataset_root: str) -> List[str]:
    """Flickr30k karpathy splits (``write_f30k_karpathy.py``)."""
    rows = _karpathy_rows(
        os.path.join(root, "karpathy", "dataset_flickr30k.json"),
        [os.path.join(root, "flickr30k-images", "*.jpg")],
    )
    out = []
    for split in ["train", "val", "test"]:
        batch = [r for r in rows if r["split"] == split]
        path = os.path.join(dataset_root, f"f30k_caption_karpathy_{split}.arrow")
        _write_table(batch, ["image", "caption", "image_id", "split"], path)
        out.append(path)
    return out


def _annot_shard_rows(annot_json: str, image_glob: str, split: str):
    """Shared [path, caption] annot reader (CC + SBU)."""
    with open(annot_json) as f:
        captions = json.load(f)
    iid2captions = {os.path.basename(c[0]): [c[1]] for c in captions}
    rows = []
    for path in sorted(glob(image_glob)):
        name = os.path.basename(path)
        if name not in iid2captions:
            continue
        rows.append(
            {
                "image": _read_bytes(path),
                "caption": iid2captions[name],
                "image_id": name,
                "split": split,
            }
        )
    return rows


def write_conceptual_caption(
    root: str, dataset_root: str, shard_size: int = 100000
) -> List[str]:
    """Conceptual Captions in 100k shards (``write_conceptual_caption.py``)."""
    out = []
    for split in ["val", "train"]:
        rows = _annot_shard_rows(
            os.path.join(root, f"{split}_annot.json"),
            os.path.join(root, f"images_{split}", "*", "*"),
            split,
        )
        n_shards = len(rows) // shard_size + 1
        for sub in range(n_shards):
            shard = rows[sub * shard_size : (sub + 1) * shard_size]
            path = os.path.join(
                dataset_root, f"conceptual_caption_{split}_{sub}.arrow"
            )
            _write_table(shard, ["image", "caption", "image_id", "split"], path)
            out.append(path)
    return out


def write_sbu(root: str, dataset_root: str, shard_size: int = 100000) -> List[str]:
    """SBU captions in 100k shards (``write_sbu.py``)."""
    rows = _annot_shard_rows(
        os.path.join(root, "annot.json"),
        os.path.join(root, "images_train", "*", "*"),
        "train",
    )
    out = []
    for sub in range(len(rows) // shard_size + 1):
        shard = rows[sub * shard_size : (sub + 1) * shard_size]
        path = os.path.join(dataset_root, f"sbu_{sub}.arrow")
        _write_table(shard, ["image", "caption", "image_id", "split"], path)
        out.append(path)
    return out


def write_vg(root: str, dataset_root: str) -> List[str]:
    """Visual Genome region captions (``write_vg.py``): per image the region
    phrases plus their geometry columns."""
    with open(os.path.join(root, "annotations", "region_descriptions.json")) as f:
        captions = json.load(f)
    iid2regions: Dict[int, List[dict]] = defaultdict(list)
    for cap in captions:
        for c in cap["regions"]:
            iid2regions[c["image_id"]].append(c)
    paths = sorted(glob(os.path.join(root, "images", "VG_100K", "*.jpg"))) + sorted(
        glob(os.path.join(root, "images", "VG_100K_2", "*.jpg"))
    )
    rows = []
    for path in paths:
        iid = int(os.path.basename(path)[:-4])
        if iid not in iid2regions:
            continue
        regions = iid2regions[iid]
        rows.append(
            {
                "image": _read_bytes(path),
                "caption": [c["phrase"] for c in regions],
                "width": [c["width"] for c in regions],
                "height": [c["height"] for c in regions],
                "x": [c["x"] for c in regions],
                "y": [c["y"] for c in regions],
                "image_id": str(iid),
            }
        )
    path = os.path.join(dataset_root, "vg.arrow")
    _write_table(
        rows, ["image", "caption", "width", "height", "x", "y", "image_id"], path
    )
    return [path]


def write_wikibk(
    root: str, dataset_root: str, num_files: Optional[int] = None
) -> List[str]:
    """Text-only wiki/bookcorpus shards (``write_wikibk.py``): one arrow per
    ``wikibk.{i}.txt``, rows [image="None", caption=[sentence], source,
    split]."""
    out = []
    index = 0
    while True:
        file_path = os.path.join(root, f"wikibk.{index}.txt")
        if not os.path.exists(file_path) or (
            num_files is not None and index >= num_files
        ):
            break
        with open(file_path, encoding="utf-8") as f:
            sents = [line.strip() for line in f if line.strip()]
        rows = [
            {"image": "None", "caption": [s], "source": "wikibk", "split": "train"}
            for s in sents
        ]
        path = os.path.join(dataset_root, f"wikibk_train_{index}.arrow")
        _write_table(rows, ["image", "caption", "source", "split"], path)
        out.append(path)
        index += 1
    return out


def write_nlvr2(root: str, dataset_root: str) -> List[str]:
    """NLVR2 paired-image tables (``write_nlvr2.py``): jsonl annotations in
    ``nlvr2/data/{train,dev,test1}.json`` (+ ``balanced/``/``unbalanced/``
    variants when present), paired ``-img0.png``/``-img1.png`` files."""

    def read_jsonl(path):
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    data_dir = os.path.join(root, "nlvr2", "data")
    split_files = {
        "train": os.path.join(data_dir, "train.json"),
        "dev": os.path.join(data_dir, "dev.json"),
        "test1": os.path.join(data_dir, "test1.json"),
        "balanced_dev": os.path.join(data_dir, "balanced", "balanced_dev.json"),
        "balanced_test1": os.path.join(data_dir, "balanced", "balanced_test1.json"),
        "unbalanced_dev": os.path.join(data_dir, "unbalanced", "unbalanced_dev.json"),
        "unbalanced_test1": os.path.join(
            data_dir, "unbalanced", "unbalanced_test1.json"
        ),
    }
    out = []
    for split, path in split_files.items():
        data = read_jsonl(path)
        if data is None:
            continue
        groups: Dict[str, List[dict]] = defaultdict(list)
        for row in data:
            groups["-".join(row["identifier"].split("-")[:-1])].append(row)
        rows = []
        for iden, group in groups.items():
            base_split = iden.split("-")[0]
            if iden.startswith("train"):
                img_base = os.path.join(
                    root, "images", "train", str(group[0]["directory"]), iden
                )
            else:
                img_base = os.path.join(root, base_split, iden)
            rows.append(
                {
                    "image_0": _read_bytes(f"{img_base}-img0.png"),
                    "image_1": _read_bytes(f"{img_base}-img1.png"),
                    "questions": [r["sentence"] for r in group],
                    "answers": [r["label"] for r in group],
                    "identifier": iden,
                }
            )
        arrow_path = os.path.join(dataset_root, f"nlvr2_{split}.arrow")
        _write_table(
            rows, ["image_0", "image_1", "questions", "answers", "identifier"],
            arrow_path,
        )
        out.append(arrow_path)
    return out


def textvqa_occurrence_score(count: int) -> float:
    """The TextVQA writer's occurrence->soft-score table
    (``write_text_vqa.py:13-23``) — note it is NOT the official VQA
    min(1, n/3): 1 -> 0.3, 2 -> 0.6, 3 -> 0.9, >=4 -> 1.0."""
    return min(1.0, 0.3 * count) if count < 4 else 1.0


def write_text_vqa(root: str, dataset_root: str) -> List[str]:
    """TextVQA 0.5.1 -> arrow (``write_text_vqa.py:62-198``): reads
    ``TextVQA_0.5.1_{train,val}.json`` ("data" lists of {image_id,
    question_id, question, answers}); BOTH splits draw images from
    ``train_images`` (``:150-153``).  One row per annotated image, with the
    image's questions grouped into parallel lists; answers are deduped per
    question with occurrence-count soft scores, and ``answer_labels`` is
    zero-filled (the reference writer leaves vocabulary indexing to the
    consumer, ``:44``).  Emits ``text_vqa_{train,val}.arrow``."""
    per_split: Dict[str, Dict[str, dict]] = {}
    for split in ["train", "val"]:
        with open(os.path.join(root, f"TextVQA_0.5.1_{split}.json")) as f:
            questions = json.load(f)["data"]
        annot: Dict[str, dict] = defaultdict(dict)
        for q in questions:
            answer_count: Dict[str, int] = {}
            for answer in q.get("answers", []):
                answer_count[answer] = answer_count.get(answer, 0) + 1
            annot[str(q["image_id"])][q["question_id"]] = {
                "question": q["question"],
                "answers": list(answer_count.keys()),
                "scores": [
                    textvqa_occurrence_score(c) for c in answer_count.values()
                ],
            }
        per_split[split] = annot

    out = []
    for split in ["train", "val"]:
        annot = per_split[split]
        rows = []
        # both splits' jpegs live under train_images (write_text_vqa.py:150)
        for path in sorted(glob(os.path.join(root, "train_images", "*.jpg"))):
            iid = os.path.basename(path)[: -len(".jpg")]
            if iid not in annot:
                continue
            qas = list(annot[iid].items())
            rows.append(
                {
                    "image": _read_bytes(path),
                    "questions": [qa["question"] for _, qa in qas],
                    "answers": [qa["answers"] for _, qa in qas],
                    "answer_labels": [
                        [0] * len(qa["scores"]) for _, qa in qas
                    ],
                    "answer_scores": [qa["scores"] for _, qa in qas],
                    "image_id": iid,
                    "question_id": [qid for qid, _ in qas],
                    "split": split,
                }
            )
        path = os.path.join(dataset_root, f"text_vqa_{split}.arrow")
        _write_table(
            rows,
            ["image", "questions", "answers", "answer_labels",
             "answer_scores", "image_id", "question_id", "split"],
            path,
        )
        out.append(path)
    return out
