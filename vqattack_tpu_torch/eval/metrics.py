"""The attack's running flip rate (``adv_attack.py:727-733``); port of
``AttackAccuracy`` in ``vqattack_tpu/eval/metrics.py``."""

from __future__ import annotations

from typing import List


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
