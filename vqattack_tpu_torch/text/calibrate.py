"""Similarity-gate calibration: map the reference's USE-space 0.95 threshold
into another gate's score space from measured distributions.

Port of ``vqattack_tpu/text/calibrate.py``.  The reference accepts a word
substitution when USE cosine vs the original question exceeds 0.95
(``adv_attack.py:300-324``).  Another embedding space (mean-pooled BERT)
concentrates cosines differently, so the same number is a different
operating point.  :func:`gate_score_profile` measures a gate's scores on four
probe families and :func:`suggest_threshold` picks the threshold that
separates single-word substitutions from meaning-destroying edits:

- **identity**: the question itself (the ceiling, 1 up to float);
- **substitution**: one content word replaced by another question's word;
- **scrambled**: the same words shuffled (the blind spot of pooling);
- **unrelated**: a different question (the floor).

``run.py --calibrate-gate`` prints the table for the run's gate before the
attack; pass the suggested value back as ``--bert-threshold``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence

import numpy as np

from vqattack_tpu_torch.text.similarity import SimilarityGate

PROBE_KINDS = ("identity", "substitution", "scrambled", "unrelated")


@dataclasses.dataclass
class GateProfile:
    """Per-probe-family score arrays for one gate."""

    scores: Dict[str, np.ndarray]

    def quantiles(self, kind: str, qs=(0.05, 0.5, 0.95)) -> List[float]:
        return [float(np.quantile(self.scores[kind], q)) for q in qs]

    def table(self) -> str:
        lines = [f"{'probe':<14}{'p05':>8}{'p50':>8}{'p95':>8}{'n':>6}"]
        for kind in PROBE_KINDS:
            if kind not in self.scores or not len(self.scores[kind]):
                continue
            p05, p50, p95 = self.quantiles(kind)
            lines.append(
                f"{kind:<14}{p05:>8.4f}{p50:>8.4f}{p95:>8.4f}"
                f"{len(self.scores[kind]):>6d}"
            )
        return "\n".join(lines)


def _substitute_one_word(words: List[str], pool: Sequence[str], rng) -> List[str]:
    out = list(words)
    idx = [i for i, w in enumerate(out) if len(w) > 2]
    if not idx:
        idx = list(range(len(out)))
    i = rng.choice(idx)
    choices = [w for w in pool if w != out[i]]
    out[i] = rng.choice(choices) if choices else out[i]
    return out


def gate_score_profile(
    gate: SimilarityGate,
    questions: Sequence[str],
    seed: int = 0,
    max_questions: int = 64,
) -> GateProfile:
    """Score the four probe families over ``questions`` with ``gate``."""
    rng = random.Random(seed)
    qs = list(questions)[:max_questions]
    word_pool = sorted({w for q in qs for w in q.lower().split() if w})
    out: Dict[str, List[float]] = {k: [] for k in PROBE_KINDS}
    for i, q in enumerate(qs):
        words = q.lower().split()
        if len(words) < 3:
            continue
        sub = " ".join(_substitute_one_word(words, word_pool, rng))
        scr_words = list(words)
        rng.shuffle(scr_words)
        scrambled = " ".join(scr_words)
        unrelated = qs[(i + len(qs) // 2) % len(qs)]
        if unrelated == q:
            continue
        s = gate.scores(q, [q, sub, scrambled, unrelated])
        for kind, val in zip(PROBE_KINDS, s):
            out[kind].append(float(val))
    return GateProfile({k: np.asarray(v, np.float32) for k, v in out.items()})


def suggest_threshold(
    profile: GateProfile,
    accept_quantile: float = 0.5,
    reject_quantile: float = 0.95,
) -> float:
    """The midpoint between the substitution class's median and the scrambled
    class's upper tail — accepts typical substitutions, rejects reorderings.
    Clamped below the identity floor so *something* can always pass."""
    if profile.scores["substitution"].size == 0:
        raise ValueError(
            "not enough calibration data: every probe question was skipped "
            "(needs questions with >= 3 words and at least two distinct "
            "questions)"
        )
    accept = float(np.quantile(profile.scores["substitution"], accept_quantile))
    reject = float(np.quantile(profile.scores["scrambled"], reject_quantile))
    ident = float(np.min(profile.scores["identity"]))
    thr = (accept + reject) / 2.0
    return min(thr, ident - 1e-4)
