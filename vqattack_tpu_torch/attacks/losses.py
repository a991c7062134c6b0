"""The VQAttack loss surface.

Port of ``vqattack_tpu/attacks/losses.py``:

- latent-feature loss (``ls==1``): summed negative cosine similarity between
  adversarial and clean per-layer states, over layers and tokens of both
  modalities (``fast_gradient_method.py:120-127``);
- masked-answer (MAR) loss (``ls==0``): cross-entropy of the surrogate's MLM
  logits against the answer-masked paraphrase; stacked answer variants
  ``[B, A, S]`` add (``fast_gradient_method.py:128-142``).

Feature stacks are ``[B, L, S, D]``; reductions are per sample.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100
_COS_EPS = 1e-6


def cosine_sim(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch ``nn.CosineSimilarity(eps=1e-6)`` semantics as the JAX package
    writes them: each vector's norm is floored at eps before the division."""
    na = torch.clamp(torch.linalg.vector_norm(a, dim=dim), min=_COS_EPS)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=dim), min=_COS_EPS)
    return torch.sum(a * b, dim=dim) / (na * nb)


def _neg_cos_sum(adv: torch.Tensor, tgt: torch.Tensor,
                 token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample ``-sum(cos)`` over layers and tokens -> ``[B]``."""
    c = cosine_sim(adv, tgt)  # [B, L, S]
    if token_mask is not None:
        c = c * token_mask[:, None, :]
    return -torch.sum(c, dim=(1, 2))


def per_sample_feature_loss(adv_txt, adv_img, tgt_txt, tgt_img,
                            txt_token_mask=None, img_token_mask=None) -> torch.Tensor:
    """Text + image negative cosine sums, ``[B]``."""
    return (_neg_cos_sum(adv_txt, tgt_txt, txt_token_mask)
            + _neg_cos_sum(adv_img, tgt_img, img_token_mask))


def feature_loss(adv_txt, adv_img, tgt_txt, tgt_img, txt_token_mask=None,
                 img_token_mask=None) -> torch.Tensor:
    """The whole batch's feature loss: :func:`per_sample_feature_loss`
    summed over the batch, a scalar."""
    return torch.sum(per_sample_feature_loss(adv_txt, adv_img, tgt_txt, tgt_img,
                                             txt_token_mask, img_token_mask))


def _ce_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with ignore_index -100 per label row.  ``logits [B, S, V]``,
    ``labels [B, S]`` or ``[B, A, S]`` -> ``[B]`` or ``[B, A]``; a row with no
    valid label contributes 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.dim() == 3:
        logp = logp[:, None].expand(-1, labels.shape[1], -1, -1)
    valid = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels), labels)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = valid.sum(-1)
    return (nll * valid).sum(-1) / torch.clamp(count, min=1.0)


def per_sample_mlm_loss(mlm_logits: torch.Tensor, mlm_labels: torch.Tensor) -> torch.Tensor:
    """Masked-answer CE per sample: ``[B, S]`` labels, or ``[B, A, S]``
    stacked variants whose CE terms add (padded all -100 variants add 0)."""
    ce = _ce_per_sample(mlm_logits, mlm_labels)
    return ce if mlm_labels.dim() == 2 else ce.sum(-1)


def mlm_loss(mlm_logits: torch.Tensor, mlm_labels: torch.Tensor) -> torch.Tensor:
    """The whole batch's masked-answer CE: :func:`per_sample_mlm_loss`
    summed over the batch (and the answer variants of ``[B, A, S]``
    labels), a scalar."""
    return torch.sum(per_sample_mlm_loss(mlm_logits, mlm_labels))
