"""Image-text retrieval recall.

Port of ``vqattack_tpu/eval/retrieval_eval.py`` (reference
``vlmo/modules/objectives.py:477-799``, ``compute_irtr_recall`` and
``compute_irtr_recall_with_rerank``): rank every caption-image pair by
contrastive similarity and report R@1/5/10 both ways; the re-rank variant
rescores each text's top-k shortlist with the fusion ITM head.  Features
and the scorer's outputs may be tensors on the card: they are moved to the
host, and the similarity product and the recall arithmetic run in numpy, as
in the JAX module.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _similarity(image_feats, text_feats) -> np.ndarray:
    """``[Nt, Ni]`` text-image similarities, taken in numpy on the host."""
    return _host(text_feats) @ _host(image_feats).T


def recall_at_k(scores: np.ndarray, gt_image_per_text: np.ndarray, ks=(1, 5, 10)
                ) -> Dict[str, float]:
    """``scores[t, i]``: text t against image i; ``gt_image_per_text`` maps
    each text row to its positive image column."""
    scores, gt = _host(scores), _host(gt_image_per_text)
    order = np.argsort(-scores, axis=1)
    return {f"r@{k}": float((order[:, :k] == gt[:, None]).any(axis=1).mean()) for k in ks}


def irtr_recall(image_feats, text_feats, text_to_image, ks=(1, 5, 10)) -> Dict[str, float]:
    """Contrastive recall both ways, from normalised ``[Ni, D]`` image and
    ``[Nt, D]`` text features and each text's image index."""
    text_to_image = _host(text_to_image)
    t2i = _similarity(image_feats, text_feats)
    res = {f"t2i_{k}": v for k, v in recall_at_k(t2i, text_to_image, ks).items()}
    # image -> text: an image's positives are all the texts that map to it
    i2t = t2i.T
    order = np.argsort(-i2t, axis=1)
    for k in ks:
        hits = []
        for i in range(i2t.shape[0]):
            positives = np.where(text_to_image == i)[0]
            if positives.size == 0:
                continue
            hits.append(np.isin(order[i, :k], positives).any())
        res[f"i2t_r@{k}"] = float(np.mean(hits)) if hits else 0.0
    return res


def irtr_recall_with_rerank(image_feats, text_feats, text_to_image,
                            itm_score_fn: Callable, k_test: int = 32,
                            ks=(1, 5, 10)) -> Dict[str, float]:
    """Contrastive shortlist, then the ITM re-rank (``objectives.py:612-799``).

    ``itm_score_fn(text_indices [M], image_indices [M]) -> match logits
    [M]`` is the caller's batched fusion scorer (numpy indices in, an array
    or a tensor out)."""
    t2i = _similarity(image_feats, text_feats)
    shortlist = np.argsort(-t2i, axis=1)[:, :k_test]
    rescored = np.full_like(t2i, -np.inf)
    for t in range(t2i.shape[0]):
        cols = shortlist[t]
        rescored[t, cols] = _host(itm_score_fn(np.full(len(cols), t), cols))
    return {f"rerank_t2i_{k}": v
            for k, v in recall_at_k(rescored, _host(text_to_image), ks).items()}


def irtr_loss_np(sim_pos, sim_negs) -> float:
    """In-batch IRTR CE (``objectives.py:301-373``): the positive against
    the sampled negatives' ITM scores, softmax over 1 + n_neg."""
    logits = np.concatenate([_host(sim_pos)[:, None], _host(sim_negs)], axis=1)
    logits = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return float(-np.log(np.maximum(p[:, 0], 1e-12)).mean())
