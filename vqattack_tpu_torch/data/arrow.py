"""pyarrow-backed VQAv2 tables: the VLMo data path (``--arrow``).

Port of ``vqattack_tpu/data/arrow.py`` (reference ``vlmo/datasets/
base_dataset.py`` and ``vqav2_dataset.py``): the tables are memory-mapped
``.arrow`` files of the reference's ``make_arrow`` schema, one row an image
with its JPEG bytes and a list of questions; the dataset is flattened to one
item a question (``base_dataset.py:72-82``).  An item of
:class:`VQAv2ArrowDataset` is ``{pixels [1, 3, H, W], question, qid,
answers, answer_labels, answer_scores}``, the question as the table holds it
(VLMo keeps its ``?``), each column present only when the table has it.

pyarrow and PIL are imported inside the functions that read a table or
decode an image, so the package imports without them.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


def _open_table(path: str):
    import pyarrow as pa

    with pa.memory_map(path, "r") as source:
        return pa.ipc.RecordBatchFileReader(source).read_all()


class ArrowDataset:
    """Flattened (image, caption) view over arrow tables
    (``base_dataset.py:11-117``)."""

    def __init__(self, paths: Sequence[str], transform: Callable, text_column: str = "caption"):
        import pyarrow as pa

        tables = [_open_table(p) for p in paths]
        self.table = (pa.concat_tables(tables, promote_options="default") if len(tables) > 1
                      else tables[0])
        self.transform = transform
        # one entry a caption: (row of its image, its place in the row's list)
        self._texts = self.table[text_column].to_pylist()
        self.index_mapper: List[tuple] = [
            (i, j) for i, caps in enumerate(self._texts)
            for j in range(len(caps) if isinstance(caps, list) else 1)]

    def __len__(self) -> int:
        return len(self.index_mapper)

    def get_image(self, raw_index: int):
        """The transformed image of item ``raw_index``: ``[3, H, W]``."""
        from PIL import Image

        i, _ = self.index_mapper[raw_index]
        with Image.open(io.BytesIO(self.table["image"][i].as_py())) as img:
            return self.transform(img)

    def get_text(self, raw_index: int) -> str:
        i, j = self.index_mapper[raw_index]
        caps = self._texts[i]
        return caps[j] if isinstance(caps, list) else caps

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]

    def iter_batches(self, indices: Optional[Sequence[int]] = None, num_workers: int = 4,
                     prefetch: int = 8) -> Iterator[Dict[str, Any]]:
        """The items of ``indices`` (default: all) in order, decoded on
        ``num_workers`` threads (``data/iter_utils.py``).  A read shares
        only the table and the column lists, which it does not change, and
        the transform."""
        from vqattack_tpu_torch.data.iter_utils import threaded_iter

        yield from threaded_iter(self, indices, num_workers, prefetch)


def _column(table, name: str):
    return table[name].to_pylist() if name in table.column_names else None


def _per_question(values, j: int):
    """A row's value for its ``j``-th question: rows hold one list a
    question (a list of lists), or one value for the row."""
    return values[j] if values and isinstance(values[0], list) else values


class VQAv2ArrowDataset(ArrowDataset):
    """VQAv2 over arrow (``vqav2_dataset.py``): an item carries the question,
    the answers, their labels and soft scores, and the question id."""

    def __init__(self, paths: Sequence[str], transform: Callable):
        super().__init__(paths, transform, text_column="questions")
        self._qids = _column(self.table, "question_id")
        self._answers = _column(self.table, "answers")
        self._labels = _column(self.table, "answer_labels")
        self._scores = _column(self.table, "answer_scores")

    def __getitem__(self, raw_index: int) -> Dict[str, Any]:
        i, j = self.index_mapper[raw_index]
        item: Dict[str, Any] = {
            "pixels": self.get_image(raw_index)[None],
            "question": self.get_text(raw_index),
        }
        if self._qids is not None:
            q = self._qids[i]
            item["qid"] = q[j] if isinstance(q, list) else q
        for key, values in (("answers", self._answers), ("answer_labels", self._labels),
                            ("answer_scores", self._scores)):
            if values is not None:
                item[key] = _per_question(values[i], j)
        return item
