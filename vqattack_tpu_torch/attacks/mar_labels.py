"""Masked-answer (MAR) label construction.

Reproduces ``adv_attack.py:433-558`` / ``vlmo_module.py:1748-1889``: given the
target model's clean answer and a ChatGPT declarative paraphrase of the
(question, answer) pair, mask the answer word(s) inside the paraphrase and
build MLM labels that supervise *only* the masked positions — maximizing the
CE against them pushes the surrogate away from recovering the answer.
Multiple acceptable answers (same word count + same per-word sub-token
lengths) stack along an answer axis.

Static-shape formulation: labels are padded to ``[A_max, S]`` with all
``-100`` variants (which contribute zero loss —
:func:`vqattack_tpu_torch.attacks.losses.per_sample_mlm_loss`).
A copy of ``vqattack_tpu/attacks/mar_labels.py`` (pure numpy).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from vqattack_tpu_torch.text.filter_words import filter_answer_words
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

IGNORE = -100


@dataclasses.dataclass
class MarLabels:
    """Everything the MAR loss + answer-recovery probe need."""

    old_alg: int                      # 1 = answer not in paraphrase (feature-only)
    mlm_ids: Optional[np.ndarray]     # [S] masked-paraphrase ids
    mlm_mask: Optional[np.ndarray]    # [S]
    labels: Optional[np.ndarray]      # [A, S]; -100 outside answer positions
    paraphrase_words: List[str]       # masked word list (for substitution sync)
    mask_positions: List[int]         # word indices masked in the paraphrase
    sub_word_lengths: List[int]       # sub-token span length per masked word
    true_len: int                     # unpadded token count of the paraphrase


def _encode_fixed(tok: WordPieceTokenizer, text: str, max_len: int):
    ids, mask = tok.encode(text, max_length=max_len)
    return ids, mask, int(mask.sum())


def build_mar_labels(
    paraphrase: str,
    target_answer: str,
    all_correct_answers: Sequence[str],
    tokenizer: WordPieceTokenizer,
    max_len: int = 25,
    max_answers: int = 8,
) -> MarLabels:
    """Build the masked paraphrase + stacked labels.

    ``old_alg == 1`` (no answer word found in the paraphrase) means the
    attack falls back to the feature-only loss (``adv_attack.py:467-468``).
    """
    pa_text = paraphrase.strip(".").lower()
    pa_words, _, pa_keys = tokenizer.word_spans(pa_text)
    gt_ids, _, gt_len = _encode_fixed(
        tokenizer, " ".join(pa_words), max_len
    )

    ans_words, _, _ = tokenizer.word_spans(target_answer.lower())
    ans_words = filter_answer_words(ans_words)

    mask_positions: List[int] = []
    sub_lengths: List[int] = []
    matched_words: List[str] = []
    for w in ans_words:
        if w in pa_words:
            # .index() = FIRST occurrence, also for duplicated answer words
            # ("side by side" -> 'side' maps to the same position twice and
            # the masking loop below rewrites it twice) — exactly the
            # reference's behavior (adv_attack.py:456-465), kept for parity
            p = pa_words.index(w)
            mask_positions.append(p)
            sub_lengths.append(pa_keys[p][1] - pa_keys[p][0])
            matched_words.append(w)

    if not mask_positions:
        return MarLabels(1, None, None, None, pa_words, [], [], gt_len)

    # mask the matched words (descending positions so indices stay valid when
    # a word expands into several [MASK] sub-tokens — adv_attack.py:470-477)
    list_words = list(pa_words)
    labels0 = np.full(max_len, IGNORE, np.int64)
    order = sorted(range(len(mask_positions)), key=lambda i: mask_positions[i], reverse=True)
    for i in order:
        mp, sl = mask_positions[i], sub_lengths[i]
        list_words = list_words[:mp] + ["[MASK]"] * sl + list_words[mp + 1:]
        s, e = pa_keys[mp]
        # spans past the max_len truncation clamp to empty/partial writes —
        # numpy slicing no-ops exactly like the reference's torch slice
        # assignment on its truncated encoding (adv_attack.py:477-483);
        # a fully-truncated answer leaves all-IGNORE labels with old_alg=0,
        # as in the reference (its CE then sees only ignored targets)
        labels0[s + 1 : e + 1] = gt_ids[s + 1 : e + 1]  # +1 = [CLS] offset

    mlm_ids, mlm_mask, _ = _encode_fixed(
        tokenizer, " ".join(list_words), max_len
    )

    variants = [labels0]
    for cand in all_correct_answers:
        if len(variants) >= max_answers:
            break
        if cand == target_answer:
            continue
        cand_words, _, cand_keys = tokenizer.word_spans(cand.lower())
        cand_words = filter_answer_words(cand_words)
        if len(cand_words) != len(matched_words):
            continue
        # every candidate word must occupy the same number of sub-tokens as
        # the word it replaces, or the label positions would shift.
        # NOTE cand_keys is indexed with the POST-filter word index i — for
        # candidates with leading filler words this reads the wrong word's
        # span.  That is the reference's own indexing
        # (adv_attack.py:514-517: cand_ans_keys[i] with i over
        # cand_attack_ans_words), reproduced verbatim for parity
        if any(
            (cand_keys[i][1] - cand_keys[i][0]) != sub_lengths[i]
            for i in range(len(cand_words))
        ):
            continue
        cand_pa = list(pa_words)
        # the reference sorts the position list DESCENDING before zipping it
        # with the candidate words in original order (adv_attack.py:525-535:
        # cand_mask_pos_list.sort(reverse=True) precedes the
        # zip(cand_mask_pos_list, cand_attack_ans_words) rewrite), so a
        # multi-word candidate answer is spliced in reversed — "blue cat"
        # lands as "... cat blue".  Reproduced verbatim for label parity.
        for pos, w in zip(sorted(mask_positions, reverse=True), cand_words):
            cand_pa[pos] = w
        cand_ids, _, _ = _encode_fixed(
            tokenizer, " ".join(cand_pa), max_len
        )
        cand_labels = np.full(max_len, IGNORE, np.int64)
        for i in order:
            mp = mask_positions[i]
            s, e = pa_keys[mp]
            cand_labels[s + 1 : e + 1] = cand_ids[s + 1 : e + 1]
        variants.append(cand_labels)

    labels = np.stack(variants)  # [A, S]
    if labels.shape[0] < max_answers:
        pad = np.full((max_answers - labels.shape[0], max_len), IGNORE, np.int64)
        labels = np.concatenate([labels, pad])
    return MarLabels(
        0, mlm_ids, mlm_mask, labels, list_words, mask_positions, sub_lengths, gt_len
    )
