"""Sentence-similarity gates for the word-substitution attack.

Port of ``vqattack_tpu/text/similarity.py`` without the TF-hub USE gate
(not ported yet).  Every gate implements ``scores(reference, candidates) ->
[N]`` cosine similarities; :meth:`SimilarityGate.operating_point` maps the reference's USE-space
threshold (0.95, ``adv_attack.py:303``) into the gate's own space.

- :class:`BertMeanPoolGate`: mean-pooled states of the surrogate's BERT text
  tower, cosine in that space, on the attack's device;
- :class:`NullGate`: accepts everything (ablation).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

USE_SPACE_DEFAULT = 0.95
# mean-pooled-BERT-space equivalent of the USE-space default (docs/GATES.md)
BERT_SPACE_DEFAULT = 0.985


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pad_to_bucket(texts: Sequence[str]) -> Tuple[List[str], int]:
    """Pad a text batch to the next power-of-two size with empty strings, so
    the batches the gate encodes have the JAX package's shapes; callers
    slice the first ``n`` rows."""
    n = len(texts)
    return list(texts) + [""] * (next_pow2(n) - n), n


class SimilarityGate:
    def scores(self, reference: str, candidates: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def operating_point(self, use_space_threshold: float) -> float:
        return use_space_threshold


class NullGate(SimilarityGate):
    def scores(self, reference, candidates):
        return np.ones(len(candidates), dtype=np.float32)

    def operating_point(self, use_space_threshold: float) -> float:
        return 0.0


class BertMeanPoolGate(SimilarityGate):
    """Mean-pooled BERT text-tower states, cosine similarity.

    ``embed_fn(ids, mask) -> [B, S, D]`` takes int64 tensors on ``device``
    (the surrogate's ``text_tower``)."""

    def __init__(self, embed_fn, tokenizer, max_length: int = 25,
                 threshold: float = BERT_SPACE_DEFAULT, device="cpu"):
        self._embed_fn = embed_fn
        self._tokenizer = tokenizer
        self._max_length = max_length
        self._threshold = threshold
        self._device = torch.device(device)

    def operating_point(self, use_space_threshold: float) -> float:
        scale = (1.0 - self._threshold) / (1.0 - USE_SPACE_DEFAULT)
        return 1.0 - (1.0 - use_space_threshold) * scale

    @torch.no_grad()
    def _pool(self, texts: Sequence[str]) -> np.ndarray:
        padded, n = pad_to_bucket(texts)
        ids, mask = self._tokenizer.encode_batch(padded, self._max_length)
        hidden = self._embed_fn(
            torch.as_tensor(ids, dtype=torch.long, device=self._device),
            torch.as_tensor(mask, dtype=torch.long, device=self._device),
        )
        hidden = hidden[:n].float().cpu().numpy()
        m = mask[:n, :, None].astype(np.float32)
        pooled = (hidden * m).sum(1) / np.maximum(m.sum(1), 1.0)
        return pooled / np.maximum(np.linalg.norm(pooled, axis=1, keepdims=True), 1e-9)

    def scores(self, reference, candidates):
        embs = self._pool([reference, *candidates])
        return embs[1:] @ embs[0]


def make_gate(kind: str = "bert", *, embed_fn=None, tokenizer=None, max_length: int = 25,
              bert_threshold: float = BERT_SPACE_DEFAULT, device="cpu") -> SimilarityGate:
    """``"bert"`` (:class:`BertMeanPoolGate`) or ``"none"`` (:class:`NullGate`)."""
    if kind == "bert":
        if embed_fn is None or tokenizer is None:
            raise ValueError("the bert gate needs embed_fn and tokenizer")
        return BertMeanPoolGate(embed_fn, tokenizer, max_length,
                                threshold=bert_threshold, device=device)
    if kind == "none":
        return NullGate()
    raise ValueError(f"unknown similarity gate: {kind!r} (the USE gate is not ported yet)")
