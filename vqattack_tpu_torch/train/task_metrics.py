"""A metric and a loss mean a task, and their aggregation at an epoch's end.

Port of ``vqattack_tpu/train/task_metrics.py`` (reference
``vlmo/modules/vlmo_utils.py``: ``set_metrics:16`` gives each task its
accuracy, scalar or VQA score; ``epoch_wrapup:55`` turns them into each
task's epoch value and ``the_metric``, their sum, which picks the
checkpoint).  numpy only; ``reduce_fn`` stands where a run across hosts
sums each meter's total and count.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from vqattack_tpu_torch.eval.metrics import Scalar, VQAScore


class Accuracy(Scalar):
    """argmax accuracy, labels of -100 ignored (``my_metrics.py:5``)."""

    def update_logits(self, logits: np.ndarray, labels: np.ndarray):
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
        keep = labels != -100
        if keep.sum() == 0:
            return
        preds = logits[keep].argmax(-1)
        self.total += float((preds == labels[keep]).sum())
        self.count += int(keep.sum())


# each task's metric (epoch_wrapup:55-200): the epoch values add into
# the_metric as the reference's `the_metric += value`
_TASK_METRICS: Dict[str, Callable[[], Scalar]] = {
    "mlm": Accuracy,
    "textmlm": Accuracy,
    "itm": Accuracy,
    "itc": Scalar,
    "irtr": Scalar,
    "vqa": VQAScore,
    "nlvr2": Accuracy,
}


class TaskMetricRegistry:
    def __init__(self, tasks: List[str], reduce_fn: Optional[Callable] = None):
        """``tasks``: the active tasks (the reference's loss_names above 0);
        ``reduce_fn(total, count) -> (total, count)`` across hosts."""
        self.tasks = list(tasks)
        self.reduce_fn = reduce_fn
        self.metrics: Dict[str, Scalar] = {t: _TASK_METRICS.get(t, Scalar)() for t in tasks}
        self.losses: Dict[str, Scalar] = {t: Scalar() for t in tasks}

    def update(self, task: str, *, loss: Optional[float] = None, logits=None, labels=None,
               targets=None):
        """A batch of ``task``: its loss, and its logits with the labels
        (accuracies) or the soft targets (the VQA score); a scalar metric
        takes the logits' mean."""
        if loss is not None:
            self.losses[task].update(float(loss))
        m = self.metrics[task]
        if logits is None:
            return
        if isinstance(m, VQAScore):
            m.update_logits(np.asarray(logits), np.asarray(targets))
        elif isinstance(m, Accuracy):
            m.update_logits(np.asarray(logits), np.asarray(labels))
        else:
            m.update(float(np.asarray(logits).mean()))

    def epoch_wrapup(self) -> Dict[str, float]:
        """``{"<task>/metric", "<task>/loss", ..., "the_metric"}`` over the
        epoch, and every meter reset (``epoch_wrapup:55-200``)."""
        out: Dict[str, float] = {}
        the_metric = 0.0
        for t in self.tasks:
            m, l = self.metrics[t], self.losses[t]
            if self.reduce_fn is not None:
                m.total, m.count = self.reduce_fn(m.total, m.count)
                l.total, l.count = self.reduce_fn(l.total, l.count)
            value = m.compute()
            out[f"{t}/metric"] = value
            out[f"{t}/loss"] = l.compute()
            the_metric += value
            m.reset()
            l.reset()
        out["the_metric"] = the_metric
        return out
