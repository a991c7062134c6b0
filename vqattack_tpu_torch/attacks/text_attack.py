"""Cross-modal iterative word-substitution attack (the text side).

Reproduces the reference machinery (``adv_attack.py:161-333`` and the VLMo
duplicate ``vlmo_module.py:1531-1722``):

- **block schedule**: the PGD budget splits into ``k+1`` blocks for ``k``
  substitutable words (:func:`compute_iter_schedule`, ``adv_attack.py:232-239``);
- **candidate generation**: BERT-MLM top-5 per single-sub-token position,
  raw-logit score threshold 0.3, original/sub-word/stop-word filtering
  (:func:`generate_candidates`, ``adv_attack.py:215-264``);
- **BPE candidates**: multi-sub-token spans expand into token combinations
  ranked by MLM pseudo-perplexity (:func:`bpe_substitutes`,
  ``adv_attack.py:161-189``) — API parity; the schedule only targets
  single-token spans so this path is cold, as in the reference;
- **selection**: rank (position, candidate) pairs by cosine between the
  candidate's embedding direction and the harvested text-embedding gradient
  (``dir_sim``, ``adv_attack.py:325-333``), then greedily accept under a
  ratcheting sentence-similarity gate (> 0.95, ``adv_attack.py:300-324``).

Port of ``vqattack_tpu/attacks/text_attack.py`` (host-side numpy, as
there): all candidate sentences are embedded in one batched device call, and
the MLM's top-k runs on the device (``torch.topk``) so only ``[B, S, K]``
values come back to the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer


@dataclasses.dataclass
class WordCandidates:
    """Per-sample substitution state."""

    words: List[str]                       # question words (lowercased)
    spans: List[Tuple[int, int]]           # word -> sub-token [start, end)
    candidate_lists: List[Optional[List[str]]]  # per word; None = not attackable
    iter_list: List[int]                   # PGD iterations per block

    @property
    def attack_word_indices(self) -> List[int]:
        return [i for i, c in enumerate(self.candidate_lists) if c]

    @property
    def attack_positions(self) -> List[int]:
        """Sub-token positions (+1 for [CLS]) of the attackable words —
        the reference's ``attack_vector`` (``adv_attack.py:577-580``)."""
        return [self.spans[i][0] + 1 for i in self.attack_word_indices]


def compute_iter_schedule(num_sub_words: int, total_iters: int = 40) -> List[int]:
    """Split ``total_iters`` into ``k+1`` blocks (``adv_attack.py:232-239``):
    equal blocks rounded to even sizes, remainder folded into the last."""
    if num_sub_words == 0:
        return []
    count = num_sub_words + 1
    per = total_iters // count
    if per % 2 == 0:
        iters = [per] * count
    else:
        iters = [per - 1] * count
    iters[-1] += total_iters - sum(iters)
    return iters


def bpe_substitutes(
    substitutes: np.ndarray,
    tokenizer: WordPieceTokenizer,
    mlm_logits_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    max_len: int = 12,
    max_width: int = 4,
    max_candidates: int = 24,
) -> List[str]:
    """Multi-sub-token candidate expansion ranked by MLM pseudo-perplexity
    (``adv_attack.py:161-189``): cross-product of the top predictions per
    position (capped), each combination scored by mean CE of the MLM
    predicting its own tokens, lowest perplexity first."""
    substitutes = substitutes[:max_len, :max_width]
    combos: List[List[int]] = [[]]
    for row in substitutes:
        combos = [c + [int(t)] for c in combos for t in row]
        if len(combos) > 4 * max_candidates:
            combos = combos[: 4 * max_candidates]
    combos = combos[:max_candidates]
    if not combos or not combos[0]:
        return []
    ids = np.asarray(combos, np.int32)  # [N, L]
    logits = mlm_logits_fn(ids, np.ones_like(ids))  # [N, L, V]
    logits = logits - logits.max(-1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp, ids[..., None], axis=-1)[..., 0]
    ppl = np.exp(nll.mean(-1))
    order = np.argsort(ppl)
    out = []
    for i in order:
        toks = tokenizer.convert_ids_to_tokens(ids[i])
        out.append(tokenizer.convert_tokens_to_string(toks))
    return out


def generate_candidates(
    question: str,
    tokenizer: WordPieceTokenizer,
    mlm_topk_fn: Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]],
    filter_words: frozenset,
    total_iters: int = 40,
    top_k: int = 5,
    score_threshold: float = 0.3,
    max_length: int = 64,
) -> WordCandidates:
    """BERT-MLM substitution candidates per attackable word
    (``cal_text_attack_list``, ``adv_attack.py:215-264``).

    ``mlm_topk_fn(ids [B, S], mask [B, S]) -> (scores [B, S, K], ids [B, S, K])``:
    the BERT-MLM forward with its top-k taken on the device.  The reference
    runs the exact-length ``[CLS]+sub_words+[SEP]`` sequence unpadded
    (``adv_attack.py:241-243``); here the sequence is padded with the
    attention mask zero on padding, which is numerically identical at the
    real positions.
    """
    return generate_candidates_batch(
        [question], tokenizer, mlm_topk_fn, filter_words,
        total_iters=total_iters, top_k=top_k,
        score_threshold=score_threshold, max_length=max_length,
    )[0]


def generate_candidates_batch(
    questions: Sequence[str],
    tokenizer: WordPieceTokenizer,
    mlm_topk_fn: Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]],
    filter_words: frozenset,
    total_iters: int = 40,
    top_k: int = 5,
    score_threshold: float = 0.3,
    max_length: int = 64,
    max_mlm_batch: int = 64,
) -> List[WordCandidates]:
    """:func:`generate_candidates` for many questions at once: all questions'
    MLM forwards batch into ``ceil(N / max_mlm_batch)`` device calls.
    Per-question results are those of :func:`generate_candidates`.  The top-k
    runs on the device, so only ``B*S*K`` values transfer instead of the
    full ``[B,S,vocab]`` logits; ``K`` must be >= ``top_k``."""
    preps: List[Tuple[List[str], List[str], List[Tuple[int, int]], List[int], List[int]]] = []
    rows: List[Tuple[np.ndarray, np.ndarray]] = []
    row_of: Dict[int, int] = {}
    for qi, question in enumerate(questions):
        words, sub_words, spans = tokenizer.word_spans(question)
        substitutable = [
            i
            for i, (w, (s, e)) in enumerate(zip(words, spans))
            # the span must lie inside the MLM window ([CLS] + max_length-2
            # sub-tokens): the reference's cap is its 510-token slice
            # (adv_attack.py:241); beyond it there are no logits to read
            if e - s == 1 and w not in filter_words and e <= max_length - 2
        ]
        iter_list = compute_iter_schedule(len(substitutable), total_iters)
        preps.append((words, sub_words, spans, substitutable, iter_list))
        if not substitutable:
            continue
        ids = np.asarray(
            [tokenizer.cls_token_id]
            + tokenizer.convert_tokens_to_ids(sub_words[: max_length - 2])
            + [tokenizer.sep_token_id],
            np.int32,
        )
        n = len(ids)
        ids_padded = np.full((max_length,), tokenizer.pad_token_id, np.int32)
        ids_padded[:n] = ids
        mask_padded = np.zeros((max_length,), np.int32)
        mask_padded[:n] = 1
        row_of[qi] = len(rows)
        rows.append((ids_padded, mask_padded))

    # one MLM device call per chunk of rows
    row_top: List[Tuple[np.ndarray, np.ndarray]] = []  # ([S,K] scores, ids)
    for start in range(0, len(rows), max_mlm_batch):
        chunk = rows[start : start + max_mlm_batch]
        ids_np = np.stack([r[0] for r in chunk])
        mask_np = np.stack([r[1] for r in chunk])
        scores, idx = mlm_topk_fn(ids_np, mask_np)
        scores, idx = np.asarray(scores), np.asarray(idx)
        row_top.extend((scores[i], idx[i]) for i in range(len(chunk)))

    out: List[WordCandidates] = []
    for qi, (words, sub_words, spans, substitutable, iter_list) in enumerate(preps):
        candidate_lists: List[Optional[List[str]]] = [None] * len(words)
        if not substitutable:
            out.append(WordCandidates(words, spans, candidate_lists, []))
            continue
        # top-k raw-logit scores per sub-token position (skipping [CLS], so
        # row i aligns with sub_words[i] — adv_attack.py:244-246)
        top_scores, top_idx = row_top[row_of[qi]]  # [S, K] each
        top_idx = top_idx[1:, :top_k]
        top_scores = top_scores[1:, :top_k]

        for wi in substitutable:
            s, _ = spans[wi]
            cands: List[str] = []
            for tok_id, score in zip(top_idx[s], top_scores[s]):
                if score_threshold != 0 and score < score_threshold:
                    break
                cands.append(tokenizer.convert_ids_to_tokens([int(tok_id)])[0])
            kept = []
            for c in cands:
                if c == words[wi] or "##" in c or c in filter_words:
                    continue
                kept.append(c)
            if kept:
                candidate_lists[wi] = kept
        # schedule was derived from all substitutable words (pre-filter), like
        # the reference, where iter_list comes from substitute_list not the
        # survivors
        out.append(WordCandidates(words, spans, candidate_lists, iter_list))
    return out


@dataclasses.dataclass
class SubstitutionRequest:
    """One sample's inputs to substitution selection (see
    :func:`select_substitutions_multi`)."""

    adv_text: str
    ori_text: str
    text_grad: np.ndarray          # [P, D] gradient rows at attack positions
    cands: WordCandidates
    ori_emb: np.ndarray            # [S, D] original-question embedding
    sim_threshold: float = 0.95


def select_substitutions(
    adv_text: str,
    ori_text: str,
    text_grad: np.ndarray,
    cands: WordCandidates,
    ori_emb: np.ndarray,
    embed_texts_fn: Callable[[Sequence[str]], np.ndarray],
    gate_scores_fn: Callable[[str, Sequence[str]], np.ndarray],
    sim_threshold: float = 0.95,
    max_length: int = 25,
    question_suffix: str = "",
) -> Tuple[str, List[Tuple[str, str]]]:
    """Rank + greedily accept substitutions (``update_adv_text``,
    ``adv_attack.py:265-324``) for ONE sample.

    - ``text_grad [P, D]``: embedding gradient at the attack positions
      (from :func:`vqattack_tpu_torch.attacks.pgd.pgd_vl_step`);
    - ``ori_emb [S, D]``: embedding of the *original* question;
    - ``embed_texts_fn(texts) -> [N, S, D]``: batched BERT embedding lookup;
    - ``gate_scores_fn(ref, texts) -> [N]``: sentence-similarity gate;
    - ``question_suffix``: the VLMo dialect (``vlmo_module.py:1644-1704``)
      strips the trailing ``?`` off the question before word-splitting and
      re-appends it to every candidate, gate and returned sentence.  Pass
      ``"?"`` for the VLMo pipeline, ``""`` (default) for ALBEF.

    Returns ``(new_adv_text, [(original_word, new_word), ...])``.

    Thin wrapper over :func:`select_substitutions_multi` with a single
    request (total gate calls = 1 + #acceptances).
    """
    req = SubstitutionRequest(
        adv_text, ori_text, text_grad, cands, ori_emb, sim_threshold
    )
    return select_substitutions_multi(
        [req],
        embed_texts_fn,
        lambda refs, texts: gate_scores_fn(refs[0], texts),
        max_length=max_length,
        question_suffix=question_suffix,
    )[0]


def select_substitutions_multi(
    requests: Sequence[SubstitutionRequest],
    embed_texts_fn: Callable[[Sequence[str]], np.ndarray],
    gate_pairs_fn: Callable[[Sequence[str], Sequence[str]], np.ndarray],
    max_length: int = 25,
    question_suffix: str = "",
    timer=None,
) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """Substitution selection for a whole lockstep bucket at once.

    Per-sample semantics are exactly :func:`select_substitutions` (each
    sample's greedy walk sees only its own trials, threshold ratchet and
    occupied-word set), but the device round-trips batch across samples:

    - ONE ``embed_texts_fn`` call embeds every sample's candidate sentences
      (the reference runs one tiny forward per candidate,
      ``adv_attack.py:278-298``);
    - the similarity gate runs in *rounds*: between acceptances a sample's
      pending trials all score against its fixed current sentence, so round
      ``g`` scores every sample's generation-``g`` trials in ONE
      ``gate_pairs_fn(refs, texts)`` call (the reference pays one gate
      round-trip per candidate, ``adv_attack.py:315-318``).  Total gate
      calls per bucket =
      ``1 + max_over_samples(#acceptances)`` instead of
      ``sum(#candidates)``.

    ``question_suffix``: the VLMo dialect strips a trailing ``?`` off the
    question before word-splitting and re-appends it to every candidate, gate
    and returned sentence; ALBEF passes ``""``.  ``timer``: an optional
    ``PhaseTimer`` that splits the wall into ``sub_build``, ``sub_embed``,
    ``sub_rank``, ``sub_walk`` and ``sub_gate``.

    Returns one ``(new_adv_text, ops)`` per request, in order.
    """
    def _p(name: str):
        return timer.phase(name) if timer is not None else contextlib.nullcontext()

    def _finish(words: Sequence[str]) -> str:
        return " ".join(words) + question_suffix

    results: List[Optional[Tuple[str, List[Tuple[str, str]]]]] = [None] * len(requests)
    walks: List[dict] = []
    all_sentences: List[str] = []

    with _p("sub_build"):
        for ri, req in enumerate(requests):
            adv_text = req.adv_text
            if question_suffix:
                adv_text = adv_text.strip(question_suffix)
            adv_words = [w for w in adv_text.replace("\n", "").lower().split(" ") if w]
            ori_words = list(adv_words)

            # build every candidate sentence (word wi replaced by candidate c)
            entries: List[Tuple[int, int, int, int]] = []  # (wi, ci, grad_row, pos)
            sentences: List[str] = []
            max_pos = min(max_length, req.ori_emb.shape[0]) - 1  # pre-[SEP] slot
            drift = False
            for p, (wi, pos) in enumerate(
                zip(req.cands.attack_word_indices, req.cands.attack_positions)
            ):
                if wi >= len(adv_words):
                    # tokenization drift (reference 'onebug' guard,
                    # adv_attack.py:280-283)
                    drift = True
                    break
                if pos >= max_pos:
                    # word lies past the surrogate's text truncation: its
                    # embedding row does not exist (the vl-step gather clamps on
                    # device), so it can't be scored — skip it, keeping grad-row
                    # alignment via p
                    continue
                for ci, cand in enumerate(req.cands.candidate_lists[wi]):
                    trial = list(adv_words)
                    trial[wi] = cand
                    sentences.append(_finish(trial))
                    entries.append((wi, ci, p, pos))
            if drift:
                results[ri] = (_finish(ori_words), [])
                continue
            if not sentences:
                results[ri] = (_finish(adv_words), [])
                continue
            walks.append(
                {
                    "ri": ri,
                    "req": req,
                    "ori_words": ori_words,
                    "entries": entries,
                    "slice": (len(all_sentences), len(sentences)),
                    "current": list(adv_words),
                    "occupied": set(),
                    "ops": [],
                    "threshold": req.sim_threshold,
                    "k": 0,
                    "scores": {},
                }
            )
            all_sentences.extend(sentences)

    if walks:
        # one batched embedding call scores every sample's candidates
        with _p("sub_embed"):
            embs_all = np.asarray(embed_texts_fn(all_sentences))  # [N, S, D]
    with _p("sub_rank"):
        for w in walks:
            start, count = w["slice"]
            embs = embs_all[start : start + count]
            req, entries = w["req"], w["entries"]
            dir_sims = np.empty(len(entries), np.float32)
            for n, (wi, ci, p, pos) in enumerate(entries):
                d = embs[n, pos] - req.ori_emb[pos]
                g = req.text_grad[p]
                denom = max(np.linalg.norm(d) * np.linalg.norm(g), 1e-6)
                dir_sims[n] = float(np.dot(d, g) / denom)
            w["order"] = [int(n) for n in np.argsort(-dir_sims)]

    # greedy rounds: round g gates every walk's generation-g trials at once
    pending = walks
    while pending:
        refs: List[str] = []
        texts: List[str] = []
        owners: List[Tuple[dict, int]] = []
        with _p("sub_walk"):
            for w in pending:
                w["scores"] = {}
                for n in w["order"][w["k"] :]:
                    wi, ci, _, _ = w["entries"][n]
                    if wi in w["occupied"]:
                        continue
                    trial = list(w["current"])
                    trial[wi] = w["req"].cands.candidate_lists[wi][ci]
                    refs.append(w["req"].ori_text)
                    texts.append(_finish(trial))
                    owners.append((w, n))
        if not texts:
            break
        with _p("sub_gate"):
            sims = np.asarray(gate_pairs_fn(refs, texts), np.float32)
        for (w, n), s in zip(owners, sims):
            w["scores"][n] = float(s)

        nxt = []
        for w in pending:
            accepted = False
            while w["k"] < len(w["order"]):
                n = w["order"][w["k"]]
                wi, ci, _, _ = w["entries"][n]
                if wi in w["occupied"]:
                    w["k"] += 1
                    continue
                if w["scores"][n] > w["threshold"]:
                    w["threshold"] = w["scores"][n]  # ratchet (adv_attack.py:319-320)
                    w["occupied"].add(wi)
                    cand = w["req"].cands.candidate_lists[wi][ci]
                    w["current"][wi] = cand
                    w["ops"].append((w["ori_words"][wi], cand))
                    w["k"] += 1
                    accepted = True
                    break  # current changed: remaining trials need re-scoring
                w["k"] += 1
            if accepted:
                nxt.append(w)
        pending = nxt

    for w in walks:
        results[w["ri"]] = (_finish(w["current"]), w["ops"])
    return results  # type: ignore[return-value]


def apply_substitutions_to_paraphrase(
    paraphrase_words: List[str], ops: Sequence[Tuple[str, str]]
) -> List[str]:
    """Propagate accepted question substitutions into the masked paraphrase
    word list (``update_mlm_text``, ``adv_attack.py:334-353``)."""
    out = list(paraphrase_words)
    for ori_word, new_word in ops:
        for i, w in enumerate(out):
            if w == ori_word:
                out[i] = new_word
    return out
