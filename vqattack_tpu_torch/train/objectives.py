"""Pretraining and fine-tuning objectives.

Port of ``vqattack_tpu/train/objectives.py``:

- fine-tuning: ``masked_lm_loss`` (HF convention), ``vqa_bce_loss``
  (VLMo's ``compute_vqa``), ``nlvr2_loss`` and ``albef_vqa_train_loss``
  (ALBEF's ``model_vqa.py`` training loss);
- ALBEF pretraining (``models/model_pretrain.py:144-270``): the image-text
  contrastive loss with its ``[D, Q]`` feature queues
  (``contrastive_loss``, ``update_feature_queue``), its momentum-distilled
  form (``soft_contrastive_loss``, ``soft_masked_lm_loss``, the EMA teacher
  of ``momentum_update``), image-text matching on similarity-weighted hard
  negatives (``sample_hard_negatives``, ``itm_loss``) and the whole step's
  loss, ``albef_pretrain_loss``;
- VLMo pretraining (``vlmo/modules/objectives.py``): ``vlmo_pretrain_loss``,
  MLM over the joint trunk, the two-branch ITC and hard-negative ITM;
- retrieval fine-tuning: ALBEF's identity-aware ITA
  (``indexed_contrastive_loss``) with hard-negative ITM
  (``retrieval_train_loss``, ``Grounding.py:32-72``), and VLMo's IRTR
  (``vlmo_irtr_train_loss``, ``objectives.py:301-373``).

The hard negatives are drawn from a key (``rng.py``) with JAX's splits, so
that the tests can feed both packages the same draws.  The JAX functions'
``axis_name`` (negatives gathered across a data axis) is not ported: the
port has no data axis yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqattack_tpu_torch.train.optim import named_params

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


# ---------------------------------------------------------------------------
# contrastive and matching losses, queues, the EMA teacher
# ---------------------------------------------------------------------------


def _normed(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _diagonal_ce(logits: torch.Tensor) -> torch.Tensor:
    """Mean CE of row ``i`` against column ``i``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.diagonal(logp[:, : logits.shape[0]]))


def contrastive_loss(image_feat, text_feat, temp, queue_image=None, queue_text=None
                     ) -> torch.Tensor:
    """ITA/ITC: symmetric InfoNCE.  With queues (``[D, Q]`` memory banks,
    ``model_pretrain.py:178-184``) the negatives extend past the batch."""
    img, txt = _normed(image_feat), _normed(text_feat)
    txt_all = txt if queue_text is None else torch.cat([txt, queue_text.T], 0)
    img_all = img if queue_image is None else torch.cat([img, queue_image.T], 0)
    return (_diagonal_ce(img @ txt_all.T / temp) + _diagonal_ce(txt @ img_all.T / temp)) / 2


def sample_hard_negatives(key, sim_i2t: torch.Tensor, sim_t2i: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Similarity-weighted negative indices (``model_pretrain.py:197-220``):
    for each text a negative image drawn with probability softmax(sim), its
    own pair excluded, and for each image a negative text.  Returns
    ``(neg_image_idx, neg_text_idx)``."""
    eye = torch.eye(sim_i2t.shape[0], dtype=torch.bool, device=sim_i2t.device)
    r1, r2 = key.split()
    neg_text_idx = r1.categorical(sim_i2t.masked_fill(eye, -torch.inf))
    neg_image_idx = r2.categorical(sim_t2i.masked_fill(eye, -torch.inf))
    return neg_image_idx, neg_text_idx


def itm_loss(pos_logits: torch.Tensor, neg_logits: torch.Tensor) -> torch.Tensor:
    """Binary match CE: positives labeled 1, negatives 0."""
    logp = torch.log_softmax(torch.cat([pos_logits, neg_logits]).float(), dim=-1)
    return -torch.cat([logp[: pos_logits.shape[0], 1], logp[pos_logits.shape[0]:, 0]]).mean()


@torch.no_grad()
def update_feature_queue(queue: torch.Tensor, ptr: int, feats: torch.Tensor
                         ) -> Tuple[torch.Tensor, int]:
    """Ring-buffer enqueue (``_dequeue_and_enqueue``,
    ``model_pretrain.py:290-306``): ``feats [B, D]`` written into columns
    ``ptr .. ptr + B`` of a copy of ``queue [D, Q]``; returns the new queue
    and pointer.  ``Q`` must be a multiple of ``B``, as the reference
    asserts, so that the pointer wraps exactly at the end."""
    b, q = feats.shape[0], queue.shape[1]
    if q % b != 0:
        raise ValueError(f"queue size {q} must be a multiple of batch size {b}")
    ptr = int(ptr)
    queue = queue.clone()
    queue[:, ptr: ptr + b] = feats.T.to(queue.dtype)
    return queue, (ptr + b) % q


@torch.no_grad()
def momentum_update(model: nn.Module, teacher: nn.Module, m: float = 0.995) -> nn.Module:
    """The EMA teacher's update (``model_pretrain.py:282-287``), in place:
    each of ``teacher``'s parameters becomes ``m`` of itself plus ``1 - m``
    of ``model``'s of the same name."""
    params = named_params(model)
    for name, tp in named_params(teacher).items():
        tp.copy_(tp * m + params[name] * (1.0 - m))
    return teacher


def soft_contrastive_loss(image_feat, text_feat, temp, t_image_feat, t_text_feat, alpha,
                          queue_image=None, queue_text=None) -> torch.Tensor:
    """ITA with momentum distillation (``model_pretrain.py:158-184``): the
    targets blend the one-hot diagonal with the EMA teacher's softmax
    similarities at weight ``alpha``."""
    img, txt = _normed(image_feat), _normed(text_feat)
    t_img, t_txt = _normed(t_image_feat), _normed(t_text_feat)
    txt_all = t_txt if queue_text is None else torch.cat([t_txt, queue_text.T], 0)
    img_all = t_img if queue_image is None else torch.cat([t_img, queue_image.T], 0)
    sim_i2t = img @ txt_all.T / temp
    sim_t2i = txt @ img_all.T / temp
    with torch.no_grad():
        t_i2t = torch.softmax(t_img @ txt_all.T / temp, -1)
        t_t2i = torch.softmax(t_txt @ img_all.T / temp, -1)
    onehot = torch.eye(img.shape[0], sim_i2t.shape[1], dtype=sim_i2t.dtype,
                       device=sim_i2t.device)
    tgt_i2t = alpha * t_i2t + (1 - alpha) * onehot
    tgt_t2i = alpha * t_t2i + (1 - alpha) * onehot
    loss_i2t = -torch.mean(torch.sum(torch.log_softmax(sim_i2t, -1) * tgt_i2t, -1))
    loss_t2i = -torch.mean(torch.sum(torch.log_softmax(sim_t2i, -1) * tgt_t2i, -1))
    return (loss_i2t + loss_t2i) / 2


def soft_masked_lm_loss(logits, labels, teacher_logits, alpha: float) -> torch.Tensor:
    """MLM with soft-label distillation (``xbert.py:1445-1453``): the
    hard-label CE blended with the CE against the teacher's distribution on
    the masked positions."""
    hard = masked_lm_loss(logits, labels)
    valid = (labels != IGNORE_INDEX).float()
    logp = torch.log_softmax(logits.float(), -1)
    soft_tgt = torch.softmax(teacher_logits.detach().float(), -1)
    soft = -torch.sum(torch.sum(soft_tgt * logp, -1) * valid) / torch.clamp(valid.sum(), min=1.0)
    return (1 - alpha) * hard + alpha * soft


# ---------------------------------------------------------------------------
# ALBEF pretraining: ITA + ITM + MLM
# ---------------------------------------------------------------------------


def _albef_towers(model, batch):
    """(image embeds, image feature, text hidden states, text feature) of
    the unimodal towers.  The text tower's MLM head is not run: its logits
    are unused here."""
    image_embeds, _ = model.visual_encoder(batch["pixels"])
    enc = model.text_encoder
    text_last, _ = enc.encode(enc.embed(batch["text_ids"]), batch["text_mask"], mode="text")
    return (image_embeds, model.vision_proj(image_embeds[:, 0]), text_last,
            model.text_proj(text_last[:, 0]))


def albef_pretrain_loss(
    model,
    batch: Dict[str, torch.Tensor],
    key,
    queue_state: Optional[Dict[str, torch.Tensor]] = None,
    teacher: Optional[nn.Module] = None,
    alpha: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One ALBEF pretraining loss (``model_pretrain.py:144-270``) of an
    :class:`~vqattack_tpu_torch.models.albef.AlbefPretrain`.

    ``batch``: ``pixels [B, 3, H, W]``, ``text_ids``/``text_mask [B, S]``,
    ``mlm_ids``/``mlm_labels``.  ``queue_state`` (``image_queue``,
    ``text_queue``: ``[D, Q]``) adds the queued negatives to ITA;
    ``teacher`` (the EMA copy, updated by the caller with
    :func:`momentum_update`) with ``alpha > 0`` turns on momentum
    distillation: soft ITA targets and soft MLM labels.  ``key`` draws the
    hard negatives: split in two, the first half split again by
    :func:`sample_hard_negatives`.  Returns ``(total, metrics)``; the
    metrics hold the three terms and the normalised features (without
    gradient) for the caller's queue update."""
    image_embeds, image_feat, text_last, text_feat = _albef_towers(model, batch)
    image_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long, device=image_embeds.device)
    temp = torch.clamp(model.temp, 0.001, 0.5)
    qi = queue_state.get("image_queue") if queue_state else None
    qt = queue_state.get("text_queue") if queue_state else None
    distill = teacher is not None and alpha > 0
    if distill:
        with torch.no_grad():
            t_image_embeds, t_image_feat, _, t_text_feat = _albef_towers(teacher, batch)
        loss_ita = soft_contrastive_loss(image_feat, text_feat, temp, t_image_feat, t_text_feat,
                                         alpha, qi, qt)
    else:
        loss_ita = contrastive_loss(image_feat, text_feat, temp, qi, qt)

    # ITM on in-batch hard negatives
    imgn, txtn = _normed(image_feat), _normed(text_feat)
    sim = imgn @ txtn.T / temp
    r_neg, _ = key.split()
    with torch.no_grad():
        neg_img_idx, neg_txt_idx = sample_hard_negatives(r_neg, sim, sim.T)
    enc = model.text_encoder

    def fusion_cls(text_states, tmask, img_embeds):
        imask = torch.ones(img_embeds.shape[:2], dtype=torch.long, device=img_embeds.device)
        return enc.encode(text_states, tmask, img_embeds, imask, mode="fusion")[0][:, 0]

    tmask = batch["text_mask"]
    pos_cls = fusion_cls(text_last, tmask, image_embeds)
    neg_cls_1 = fusion_cls(text_last, tmask, image_embeds[neg_img_idx])
    neg_cls_2 = fusion_cls(text_last[neg_txt_idx], tmask[neg_txt_idx], image_embeds)
    loss_itm = itm_loss(model.itm_head(pos_cls),
                        model.itm_head(torch.cat([neg_cls_1, neg_cls_2], 0)))

    # MLM over the fused encoder
    _, _, mlm_logits = enc(batch["mlm_ids"], attention_mask=tmask, encoder_states=image_embeds,
                           encoder_mask=image_mask, mode="multi_modal")
    if distill:
        # the teacher's image embeds of the ITA branch: a second teacher ViT
        # forward would be the step's largest redundant cost
        with torch.no_grad():
            _, _, t_mlm_logits = teacher.text_encoder(
                batch["mlm_ids"], attention_mask=tmask, encoder_states=t_image_embeds,
                encoder_mask=image_mask, mode="multi_modal")
        loss_mlm = soft_masked_lm_loss(mlm_logits, batch["mlm_labels"], t_mlm_logits, alpha)
    else:
        loss_mlm = masked_lm_loss(mlm_logits, batch["mlm_labels"])

    total = loss_ita + loss_itm + loss_mlm
    return total, {"loss": total, "loss_ita": loss_ita, "loss_itm": loss_itm,
                   "loss_mlm": loss_mlm, "image_feat": imgn.detach(), "text_feat": txtn.detach()}


# ---------------------------------------------------------------------------
# retrieval fine-tuning: ALBEF's ITA + ITM, VLMo's IRTR
# ---------------------------------------------------------------------------


def indexed_contrastive_loss(image_feat, text_feat, temp, idx) -> torch.Tensor:
    """ITA with identity-aware positives (``Grounding.py:55``,
    ``model_retrieval.py``): the items that share an image index ``idx`` are
    each other's positives, the target spread evenly over them.  The
    features are normalised row by row, as the reference's
    ``F.normalize(dim=-1)``."""
    img, txt = _normed(image_feat), _normed(text_feat)
    pos = (idx[:, None] == idx[None, :]).float()
    tgt = pos / torch.clamp(pos.sum(-1, keepdim=True), min=1.0)
    loss_i2t = -torch.mean(torch.sum(torch.log_softmax(img @ txt.T / temp, -1) * tgt, -1))
    loss_t2i = -torch.mean(torch.sum(torch.log_softmax(txt @ img.T / temp, -1) * tgt, -1))
    return (loss_i2t + loss_t2i) / 2


def retrieval_train_loss(model, batch: Dict[str, torch.Tensor], key
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Retrieval fine-tuning of an
    :class:`~vqattack_tpu_torch.models.albef_tasks.AlbefRetrieval`:
    identity-aware ITA over ``batch["idx"]`` (the position where absent)
    plus ITM on hard negatives drawn from the similarities by ``key``
    (:func:`sample_hard_negatives`).  ``batch``: ``pixels [B, 3, H, W]``,
    ``text_ids``/``text_mask [B, S]``, optionally ``idx [B]``."""
    img_feat, image_embeds = model.image_features(batch["pixels"])
    txt_feat, text_embeds = model.text_features(batch["text_ids"], batch["text_mask"])
    temp = torch.clamp(model.temp, 0.001, 0.5)
    idx = batch.get("idx")
    if idx is None:
        idx = torch.arange(img_feat.shape[0], device=img_feat.device)
    loss_ita = indexed_contrastive_loss(img_feat, txt_feat, temp, idx)

    sim = img_feat @ txt_feat.T / temp
    with torch.no_grad():
        neg_img_idx, neg_txt_idx = sample_hard_negatives(key, sim, sim.T)
    mask = batch["text_mask"]
    pos = model.itm_score(text_embeds, mask, image_embeds)
    neg1 = model.itm_score(text_embeds, mask, image_embeds[neg_img_idx])
    neg2 = model.itm_score(text_embeds[neg_txt_idx], mask[neg_txt_idx], image_embeds)
    loss_itm = itm_loss(pos, torch.cat([neg1, neg2], 0))
    total = loss_ita + loss_itm
    return total, {"loss": total, "loss_ita": loss_ita, "loss_itm": loss_itm}


def vlmo_irtr_train_loss(model, batch: Dict[str, torch.Tensor], key, num_negs: int = 3
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """VLMo's IRTR fine-tuning (``objectives.py:301-373``): each image scores
    its own caption and ``num_negs`` other captions of the batch (offsets
    drawn by ``key.randint`` in ``[1, B)``) by the ITM match logit, one joint
    forward over the ``B x (1 + num_negs)`` pairs; CE with the own caption
    at index 0.  ``batch``: ``pixels [B, 3, H, W]``, ``text_ids``/
    ``text_mask [B, T]``."""
    pixels = batch["pixels"]
    b = pixels.shape[0]
    if b < 2:
        # the offsets' range [1, 1) is empty: every negative would be the
        # image's own caption
        raise ValueError("irtr loss needs batch >= 2 to sample negatives")
    offs = key.randint((b, num_negs), 1, b).to(pixels.device)
    rows = torch.arange(b, device=pixels.device)[:, None]
    idx = torch.cat([rows, (rows + offs) % b], dim=1).reshape(-1)  # [B * (1 + n)]
    xn, _, _ = model._joint_trunk(batch["text_ids"][idx], batch["text_mask"][idx],
                                  pixels.repeat_interleave(1 + num_negs, dim=0))
    logits = model.itm_score(model.pooler(xn))[:, 1].reshape(b, 1 + num_negs)
    loss = -torch.mean(torch.log_softmax(logits.float(), dim=-1)[:, 0])
    acc = torch.mean((logits.argmax(-1) == 0).float())
    return loss, {"loss": loss, "irtr_acc": acc}


# ---------------------------------------------------------------------------
# VLMo pretraining: MLM + ITC + ITM
# ---------------------------------------------------------------------------


def vlmo_pretrain_loss(
    model,
    batch: Dict[str, torch.Tensor],
    key,
    weights: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """VLMo's pretraining loss: MLM over the joint trunk
    (``objectives.py::compute_mlm:18-45``), the contrastive ITC with learnt
    logit scales and its VL-expert branch (``compute_itc:180-299``), and
    ITM on hard negatives drawn from the ITC similarities
    (``compute_itm_hardneg:76-178``).

    ``batch``: ``pixels [B, 3, H, W]``, ``text_ids``/``text_mask [B, T]``,
    ``mlm_ids``, ``mlm_labels [B, T]`` (-100 ignored).  ``weights`` (a
    preset's ``loss_names`` over mlm/itc/itm, 1.0 each by default): a term
    of weight 0 is skipped.  ``key`` draws the hard negatives: split in two,
    texts from the first half, images from the second."""
    w = {"mlm": 1.0, "itc": 1.0, "itm": 1.0}
    if weights:
        w.update({k: float(v) for k, v in weights.items() if k in w})
    pixels = batch["pixels"]
    metrics: Dict[str, Any] = {}
    total = torch.zeros((), dtype=torch.float32, device=pixels.device)
    n = pixels.shape[0]

    def normed(x):
        return _normed(x.float())

    sim_i2t = sim_t2i = None
    if w["itc"] > 0 or w["itm"] > 0:
        ti = model.infer_text(batch["text_ids"], batch["text_mask"], vlffn=True)
        ii = model.infer_image(pixels, vlffn=True)
        img, txt = normed(ii["cls_feats"]), normed(ti["cls_feats"])
        scale = torch.exp(model.logit_scale())
        sim_i2t = scale * (img @ txt.T)
        sim_t2i = scale * (txt @ img.T)
        itc = (_diagonal_ce(sim_i2t) + _diagonal_ce(sim_t2i)) / 2
        if "cls_vlffn_feats" in ti:
            vimg, vtxt = normed(ii["cls_vlffn_feats"]), normed(ti["cls_vlffn_feats"])
            vscale = torch.exp(model.logit_vl_scale())
            itc_vl = (_diagonal_ce(vscale * (vimg @ vtxt.T))
                      + _diagonal_ce(vscale * (vtxt @ vimg.T))) / 2
            itc = (itc + itc_vl) * 0.5  # ref objectives.py:263
            metrics["itc_vl_loss"] = itc_vl
        metrics["itc_loss"] = itc
        if w["itc"] > 0:
            total = total + w["itc"] * itc

    if w["itm"] > 0:
        if n < 2:
            raise ValueError("itm hard negatives need batch >= 2")
        # similarity-weighted hard negatives, the own pair (the diagonal the
        # reference fills, ref :126-142) excluded
        with torch.no_grad():
            neg_img_idx, neg_txt_idx = sample_hard_negatives(key, sim_i2t, sim_t2i)
        ids, mask = batch["text_ids"], batch["text_mask"]
        # [pos, negative image with its own text, own image with a negative
        # text] in one joint forward
        px3 = torch.cat([pixels, pixels[neg_img_idx], pixels])
        ids3 = torch.cat([ids, ids, ids[neg_txt_idx]])
        mask3 = torch.cat([mask, mask, mask[neg_txt_idx]])
        xn, _, _ = model._joint_trunk(ids3, mask3, px3)
        itm_logits = model.itm_score(model.pooler(xn))
        itm_labels = torch.cat([torch.ones(n, dtype=torch.long, device=pixels.device),
                                torch.zeros(2 * n, dtype=torch.long, device=pixels.device)])
        logp = torch.log_softmax(itm_logits.float(), -1)
        itm = -torch.mean(torch.gather(logp, 1, itm_labels[:, None]))
        metrics["itm_loss"] = itm
        metrics["itm_acc"] = torch.mean((itm_logits.argmax(-1) == itm_labels).float())
        total = total + w["itm"] * itm

    if w["mlm"] > 0:
        out = model.infer(batch["mlm_ids"], batch["text_mask"], pixels)
        # the reference's joint-trunk compute_mlm scales the CE by 0.25
        # (objectives.py:31); the text-only vlmo_textmlm stays unscaled
        mlm = 0.25 * masked_lm_loss(model.mlm_score(out["text_feats"]), batch["mlm_labels"])
        metrics["mlm_loss"] = mlm
        total = total + w["mlm"] * mlm

    metrics["loss"] = total
    return total, metrics
