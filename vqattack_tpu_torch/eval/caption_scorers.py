"""Caption/grounding text scorers: BLEU, ROUGE-L, CIDEr.

Port of ``vqattack_tpu/eval/caption_scorers.py`` (pure Python, copied so
that the port imports nothing of the JAX package).  The reference vendors
the official COCO-caption scorers for its RefCOCO grounding evaluation
(``ALBEF_attack/refTools/``); these are compact re-derivations:

- BLEU-n with brevity penalty (corpus level);
- ROUGE-L (LCS-based F-measure, beta=1.2 as in the official scorer);
- CIDEr (TF-IDF-weighted n-gram cosine, n=1..4, sigma-free consensus form).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """Corpus BLEU with uniform n-gram weights + brevity penalty."""
    p_num = [0] * max_n
    p_den = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        c = cand.split()
        rs = [r.split() for r in refs]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(c, n)
            if not cn:
                continue
            maxref: Counter = Counter()
            for r in rs:
                for g, k in _ngrams(r, n).items():
                    maxref[g] = max(maxref[g], k)
            clipped = sum(min(k, maxref[g]) for g, k in cn.items())
            p_num[n - 1] += clipped
            p_den[n - 1] += sum(cn.values())
    if min(p_den) == 0 or min(p_num) == 0:
        return 0.0
    log_p = sum(math.log(p_num[i] / p_den[i]) for i in range(max_n)) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(1, cand_len))
    return bp * math.exp(log_p)


def _lcs(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(
    candidates: Sequence[str], references: Sequence[Sequence[str]], beta: float = 1.2
) -> float:
    """Mean ROUGE-L F-measure (official scorer's beta=1.2).

    Matches the official COCO scorer exactly
    (``refTools/evaluation/rouge/rouge.py:46-75``): the maximum LCS
    *precision* and maximum LCS *recall* are taken separately across the
    references, and the F-measure is formed from that (possibly mixed) pair
    — NOT the best per-reference F.
    """
    scores = []
    for cand, refs in zip(candidates, references):
        c = cand.split()
        prec_max = 0.0
        rec_max = 0.0
        for ref in refs:
            r = ref.split()
            l = _lcs(c, r)
            prec_max = max(prec_max, l / max(1, len(c)))
            rec_max = max(rec_max, l / max(1, len(r)))
        if prec_max > 0 and rec_max > 0:
            f = (1 + beta ** 2) * prec_max * rec_max / (rec_max + beta ** 2 * prec_max)
        else:
            f = 0.0
        scores.append(f)
    return float(sum(scores) / max(1, len(scores)))


def cider(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """CIDEr: mean over n of TF-IDF n-gram cosine vs references, x10."""
    num_docs = len(candidates)
    doc_freq = [defaultdict(int) for _ in range(max_n)]
    ref_grams = []
    for refs in references:
        per_ref = [[_ngrams(r.split(), n + 1) for n in range(max_n)] for r in refs]
        ref_grams.append(per_ref)
        seen = [set() for _ in range(max_n)]
        for grams in per_ref:
            for n in range(max_n):
                seen[n] |= set(grams[n])
        for n in range(max_n):
            for g in seen[n]:
                doc_freq[n][g] += 1

    def tfidf(counts: Counter, n: int) -> Dict[tuple, float]:
        total = sum(counts.values())
        out = {}
        for g, k in counts.items():
            df = max(1.0, float(doc_freq[n][g]))
            out[g] = (k / max(1, total)) * math.log(max(1.0, num_docs / df))
        return out

    scores = []
    for cand, per_ref in zip(candidates, ref_grams):
        c_tok = cand.split()
        sims = []
        for n in range(max_n):
            cv = tfidf(_ngrams(c_tok, n + 1), n)
            sim_n = []
            for grams in per_ref:
                rv = tfidf(grams[n], n)
                dot = sum(cv.get(g, 0.0) * rv.get(g, 0.0) for g in cv)
                norm = math.sqrt(sum(v * v for v in cv.values())) * math.sqrt(
                    sum(v * v for v in rv.values())
                )
                sim_n.append(dot / norm if norm > 0 else 0.0)
            sims.append(sum(sim_n) / max(1, len(sim_n)))
        scores.append(10.0 * sum(sims) / max_n)
    return float(sum(scores) / max(1, len(scores)))
