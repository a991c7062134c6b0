"""ALBEF attack-loss builders: bind the surrogate to the PGD loop.

Port of ``vqattack_tpu/attacks/albef.py``.  Each builder returns
``loss_fn(adv_px, key, aux) -> (scalar, per_sample [B])``; ``aux`` holds the
per-sample state:

- ``text_ids``/``text_mask``: [B, S] current (adversarial) question;
- ``tgt_txt``/``tgt_img``: clean per-layer feature stacks [B, L, S, D];
- ``txt_token_mask``: [B, S] min-length cosine mask (``fgm:121-126``);
- ``mlm_ids``/``mlm_mask``/``mlm_labels``: the answer-masked paraphrase and
  its MAR labels ``[B, S]`` or ``[B, A, S]``;
- ``special_ids``: (mask, pad, cls) token ids.
"""

from __future__ import annotations

from vqattack_tpu_torch.attacks.losses import per_sample_feature_loss, per_sample_mlm_loss
from vqattack_tpu_torch.models.albef import AlbefPretrain, mlm_random_mask


def _masked_ids(key, ids, model: AlbefPretrain, special):
    mask_id, pad_id, cls_id = special
    out, _ = mlm_random_mask(
        key, ids, vocab_size=model.cfg.bert.vocab_size, mask_token_id=mask_id,
        pad_token_id=pad_id, cls_token_id=cls_id,
        mlm_probability=model.cfg.mlm_probability,
    )
    return out


def make_feature_loss(model: AlbefPretrain):
    """ls==1 latent-feature loss (``pgd_attack`` + ``fgm:120-127``)."""

    def loss_fn(adv_px, key, aux):
        ids = _masked_ids(key, aux["text_ids"], model, aux["special_ids"])
        img_f, txt_f, _ = model.gen_feats(adv_px, ids, aux["text_mask"])
        ps = per_sample_feature_loss(txt_f, img_f, aux["tgt_txt"], aux["tgt_img"],
                                     txt_token_mask=aux.get("txt_token_mask"))
        return ps.sum(), ps

    return loss_fn


def make_mlm_loss(model: AlbefPretrain):
    """ls==0 masked-answer-recovery loss (``pgd_mlm_attack`` + ``fgm:128-142``)."""

    def loss_fn(adv_px, key, aux):
        ids = _masked_ids(key, aux["mlm_ids"], model, aux["special_ids"])
        logits = model.get_mlm_logits(adv_px, ids, aux["mlm_mask"])
        ps = per_sample_mlm_loss(logits, aux["mlm_labels"])
        return ps.sum(), ps

    return loss_fn


def make_vl_loss(model: AlbefPretrain):
    """Joint image + text-embedding feature loss (``pgd_attack_vl`` +
    ``fgm_vl:96-116``); ``key`` is unused, the from-embeds path masks no ids."""

    def loss_fn(adv_px, text_embeds, key, aux):
        del key
        img_f, txt_f = model.gen_feats_from_embeds(adv_px, text_embeds, aux["text_mask"])
        ps = per_sample_feature_loss(txt_f, img_f, aux["tgt_txt"], aux["tgt_img"],
                                     txt_token_mask=aux.get("txt_token_mask"))
        return ps.sum(), ps

    return loss_fn
