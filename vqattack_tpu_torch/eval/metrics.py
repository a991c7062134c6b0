"""Task metrics and the attack's running flip rate.

Port of ``vqattack_tpu/eval/metrics.py`` (reference
``vlmo/gadgets/my_metrics.py`` and ``adv_attack.py:727-733``): ``Scalar``,
a running mean; ``VQAScore``, the soft VQA accuracy (the soft target's
score at the argmax label); ``AttackAccuracy``.  numpy only; the JAX
module's ``all_reduce_mean`` (a mean across hosts) waits for the port's
data-parallel runs.
"""

from __future__ import annotations

from typing import List

import numpy as np


class Scalar:
    """A running mean: ``update(value, n)`` adds ``n`` observations of
    ``value``."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.total += float(value) * n
        self.count += n

    def compute(self) -> float:
        return self.total / max(1, self.count)

    def reset(self):
        self.total, self.count = 0.0, 0


class VQAScore(Scalar):
    """The sum over the batch of each soft target's score at the argmax
    label (``my_metrics.py:49-69``), over the questions seen."""

    def update_logits(self, logits: np.ndarray, targets: np.ndarray):
        """``logits [B, L]``; ``targets [B, L]`` soft scores."""
        preds = np.argmax(logits, axis=-1)
        self.total += float(targets[np.arange(len(preds)), preds].sum())
        self.count += len(preds)


class AttackAccuracy:
    """Fraction of attacked samples whose victim answer differs from the
    stored clean answer, printable every ``print_every`` samples."""

    def __init__(self, print_every: int = 50):
        self.flips: List[int] = []
        self.print_every = print_every

    def update(self, answer_after_attack: str, clean_answer: str) -> None:
        self.flips.append(int(answer_after_attack != clean_answer))

    @property
    def value(self) -> float:
        return sum(self.flips) / max(1, len(self.flips))

    def maybe_log(self, log_fn=print) -> None:
        if self.flips and len(self.flips) % self.print_every == 0:
            log_fn(f"attack_accuracy {self.value:.4f} ({len(self.flips)} samples)")
