"""MLM batch collators: token-level and whole-word masking.

Port of ``vqattack_tpu/data/collators.py`` (VLMo's datamodules pick
between HF's ``DataCollatorForLanguageModeling`` and
``DataCollatorForWholeWordMask``, ``base_datamodule.py:57-65``).  Host-side
numpy: the same ``np.random.default_rng(seed)`` gives the same arrays, bit
for bit, in both packages.  Whole-word mode masks every ``##`` piece
together with its head word.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IGNORE = -100


def _word_groups(tokens: List[str]) -> List[List[int]]:
    groups: List[List[int]] = []
    for i, t in enumerate(tokens):
        if t.startswith("##") and groups:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


def mlm_collate(
    texts: Sequence[str],
    tokenizer,
    max_length: int = 40,
    mlm_probability: float = 0.15,
    whole_word: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Tokenize and BERT-mask a batch of texts.

    Returns ``text_ids`` (clean), ``text_masks``, ``text_ids_mlm`` (masked),
    ``text_labels_mlm`` (-100 off the mask) and ``text_labels`` (all -100,
    the clean stream's placeholder, as the reference's collate emits).  A
    unit (a token, or a word with its pieces) is chosen with probability
    ``mlm_probability``; a chosen unit becomes [MASK] (80%), a random token
    (10%) or stays (10%)."""
    rng = rng or np.random.default_rng()
    ids, masks = tokenizer.encode_batch(texts, max_length)
    mlm_ids = ids.copy()
    labels = np.full_like(ids, IGNORE)

    for b, text in enumerate(texts):
        tokens = tokenizer.tokenize(text)[: max_length - 2]
        # positions 1..len(tokens) of the padded row ([CLS] at 0)
        if whole_word:
            units = [[p + 1 for p in g] for g in _word_groups(tokens)]
        else:
            units = [[i + 1] for i in range(len(tokens))]
        for unit in units:
            if rng.random() >= mlm_probability:
                continue
            r = rng.random()
            for pos in unit:
                labels[b, pos] = ids[b, pos]
                if r < 0.8:
                    mlm_ids[b, pos] = tokenizer.mask_token_id
                elif r < 0.9:
                    mlm_ids[b, pos] = rng.integers(0, tokenizer.vocab_size)
    return {
        "text_ids": ids,
        "text_masks": masks,
        "text_ids_mlm": mlm_ids,
        "text_labels_mlm": labels,
        "text_labels": np.full_like(ids, IGNORE),
    }
