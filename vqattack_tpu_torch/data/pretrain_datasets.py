"""The VLMo pretraining datasets over arrow tables.

Port of ``vqattack_tpu/data/pretrain_datasets.py`` (reference
``vlmo/datasets/*.py``): each class binds the split -> table names of its
reference counterpart.  A caption corpus's item is ``{pixels [1, 3, H, W],
text, question}`` (``question`` is the caption, the key the training CLI's
collates read); wikibk is text only (``{text, question}``); NLVR2 gives its
two images, the sentence and a 0/1 label.  Tables come from
``data/pretrain_writers.py`` or the reference's ``make_arrow``: the schemas
are the same.  pyarrow and PIL are imported inside the functions that read
a table or decode an image.
"""

from __future__ import annotations

import io
import os
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from vqattack_tpu_torch.data.arrow import ArrowDataset, _open_table


def _resolve(dataset_root: str, names: Sequence[str]) -> List[str]:
    """names -> the ``.arrow`` paths that exist (missing shards skipped, as
    the reference's fixed name ranges meet partly written directories)."""
    paths = [os.path.join(dataset_root, f"{n}.arrow") for n in names]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        raise FileNotFoundError(f"none of {list(names)} found under {dataset_root}")
    return paths


def _concat(paths: Sequence[str]):
    import pyarrow as pa

    tables = [_open_table(p) for p in paths]
    return pa.concat_tables(tables, promote_options="default") if len(tables) > 1 else tables[0]


class CaptionArrowDataset(ArrowDataset):
    """An (image, caption) item: ``{pixels, text, question}``."""

    SPLITS: Dict[str, List[str]] = {}

    def __init__(self, dataset_root: str, transform: Callable, split: str = "train"):
        super().__init__(_resolve(dataset_root, self.table_names(split)), transform)

    def table_names(self, split: str) -> List[str]:
        return self.SPLITS[split]

    def __getitem__(self, raw_index: int) -> Dict[str, Any]:
        text = self.get_text(raw_index)
        return {"pixels": self.get_image(raw_index)[None], "text": text, "question": text}


class CocoCaptionKarpathyDataset(CaptionArrowDataset):
    """``coco_caption_karpathy_dataset.py``: train = train + restval."""

    SPLITS = {"train": ["coco_caption_karpathy_train", "coco_caption_karpathy_restval"],
              "val": ["coco_caption_karpathy_val"], "test": ["coco_caption_karpathy_test"]}


class F30KCaptionKarpathyDataset(CaptionArrowDataset):
    SPLITS = {"train": ["f30k_caption_karpathy_train"], "val": ["f30k_caption_karpathy_val"],
              "test": ["f30k_caption_karpathy_test"]}


class ConceptualCaptionDataset(CaptionArrowDataset):
    """``conceptual_caption_dataset.py``: train shards 0..29; test reads val."""

    def table_names(self, split: str) -> List[str]:
        if split == "train":
            return [f"conceptual_caption_train_{i}" for i in range(30)]
        return ["conceptual_caption_val_0"]


class SBUCaptionDataset(CaptionArrowDataset):
    """``sbu_caption_dataset.py``: shards 0..8, every split."""

    def table_names(self, split: str) -> List[str]:
        return [f"sbu_{i}" for i in range(9)]


class VisualGenomeCaptionDataset(CaptionArrowDataset):
    """``vg_caption_dataset.py``: one ``vg.arrow``, every split."""

    def table_names(self, split: str) -> List[str]:
        return ["vg"]


class WikibkDataset:
    """The text-only MLM corpus (``wikibk_dataset.py``): ``{text, question}``
    items; the image column holds the string "None"."""

    def __init__(self, dataset_root: str, transform: Callable = None, split: str = "train",
                 num_shards: int = 50):
        names = ([f"wikibk_train_{i}" for i in range(num_shards)] if split == "train"
                 else ["wikibk_val_0"])
        self.table = _concat(_resolve(dataset_root, names))
        self._texts = self.table["caption"].to_pylist()
        self.index_mapper = [(i, j) for i, caps in enumerate(self._texts)
                             for j in range(len(caps))]

    def __len__(self) -> int:
        return len(self.index_mapper)

    def __getitem__(self, raw_index: int) -> Dict[str, Any]:
        i, j = self.index_mapper[raw_index]
        return {"text": self._texts[i][j], "question": self._texts[i][j]}


class NLVR2Dataset:
    """Paired-image reasoning (``nlvr2_dataset.py``): ``{pixels0, pixels1,
    sentence, question, label}``, the label 1 where the table says "True"."""

    SPLITS = {"train": ["nlvr2_train"], "val": ["nlvr2_dev", "nlvr2_test1"],
              "test": ["nlvr2_dev", "nlvr2_test1"]}

    def __init__(self, dataset_root: str, transform: Callable, split: str = "train"):
        self.table = _concat(_resolve(dataset_root, self.SPLITS[split]))
        self.transform = transform
        self._texts = self.table["questions"].to_pylist()
        self._answers = self.table["answers"].to_pylist()
        self.index_mapper = [(i, j) for i, qs in enumerate(self._texts) for j in range(len(qs))]

    def __len__(self) -> int:
        return len(self.index_mapper)

    def _image(self, row: int, column: str) -> np.ndarray:
        from PIL import Image

        with Image.open(io.BytesIO(self.table[column][row].as_py())) as img:
            return self.transform(img)

    def __getitem__(self, raw_index: int) -> Dict[str, Any]:
        i, j = self.index_mapper[raw_index]
        return {"pixels0": self._image(i, "image_0")[None],
                "pixels1": self._image(i, "image_1")[None],
                "sentence": self._texts[i][j], "question": self._texts[i][j],
                "label": int(self._answers[i][j] == "True")}


# dataset key -> class (the reference datamodules' ``dataset_cls``)
PRETRAIN_DATASETS = {
    "coco": CocoCaptionKarpathyDataset,
    "f30k": F30KCaptionKarpathyDataset,
    "gcc": ConceptualCaptionDataset,
    "sbu": SBUCaptionDataset,
    "vg": VisualGenomeCaptionDataset,
    "wikibk": WikibkDataset,
    "nlvr2": NLVR2Dataset,
}


def make_pretrain_dataset(name: str, dataset_root: str, transform: Callable,
                          split: str = "train"):
    return PRETRAIN_DATASETS[name](dataset_root, transform, split=split)


class ConcatDataset:
    """Corpora end to end (the reference's ``MTDataModule`` ConcatDataset)."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        d = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[d][idx - int(self._offsets[d])]
