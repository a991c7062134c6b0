"""Fine-tuning objectives.

Port of the classification and VQA losses of
``vqattack_tpu/train/objectives.py``: ``masked_lm_loss`` (HF convention),
``vqa_bce_loss`` (VLMo's ``compute_vqa``), ``nlvr2_loss`` and
``albef_vqa_train_loss`` (ALBEF's ``model_vqa.py`` training loss).  The
pretraining, retrieval and ITM objectives are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over labeled (!= -100) positions (HF convention)."""
    valid = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels), labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def vqa_bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits times the label count: the reference's
    ``compute_vqa`` (``objectives.py:375-414``)."""
    logits = logits.float()
    per = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    return per.mean() * logits.shape[-1]


def nlvr2_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


def albef_vqa_train_loss(victim, batch: Dict[str, torch.Tensor], pad_token_id: int = 0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ALBEF VQA fine-tuning loss (``model_vqa.py:49-119``): each question's
    answer slots decoded against its (question, image) states, the
    sequences' NLL weighted by the answer weights and summed, over the
    image batch size.  ``answer_ids``/``answer_mask`` are ``[B, A, L]``,
    ``answer_weights`` ``[B, A]`` (zero-padded slots weigh nothing)."""
    states = victim.encode_question(batch["pixels"], batch["text_ids"], batch["text_mask"])
    b, a, l = batch["answer_ids"].shape
    nll = victim.answer_nll(batch["answer_ids"].reshape(b * a, l),
                            batch["answer_mask"].reshape(b * a, l),
                            states.repeat_interleave(a, dim=0),
                            batch["text_mask"].repeat_interleave(a, dim=0), pad_token_id)
    seq_nll = nll.sum(-1).reshape(b, a)
    loss = torch.sum(batch["answer_weights"] * seq_nll) / b
    return loss, {"loss": loss}
