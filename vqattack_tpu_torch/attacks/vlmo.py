"""VLMo attack-loss builders.

Port of ``vqattack_tpu/attacks/vlmo.py``.  The VLMo feature loss (VLMo's
cleverhans copy, ``fast_gradient_method.py:100-116``) combines, per layer, a
cosine of the cls states with the token-feature cosines over the valid text
tokens and every image token::

    loss = sum_layers( -cos(layer_cls, tgt_layer_cls)
                       + sum_tokens( -cos(token_feats, tgt_token_feats) ) )

Both sides stay ``[B, L+1, S, D]`` (the adversarial side a per-layer tuple
with ``VLMo(fused_feats=True)``), masked by the product of the two validity
masks.  The MAR loss is the CE of ``mlm_score`` over the text half
against the answer-masked labels (:func:`~vqattack_tpu_torch.attacks.losses.
per_sample_mlm_loss`).

Each builder returns ``loss_fn(adv_px, key, aux) -> (scalar, per_sample
[B])`` (the VL loss also takes the text embeddings).  ``aux``: ``text_ids``,
``text_mask``, ``mlm_ids``, ``mlm_mask``, ``mlm_labels``, ``tgt_layer_cls
[B, L+1, D]``, ``tgt_tokens [B, L+1, S, D]``, ``tgt_token_mask [B, S]`` and
``rel_biases`` (``VLMo.precompute_joint_biases``).  VLMo's attack forward
draws nothing: ``key`` is unused.
"""

from __future__ import annotations

import torch

from vqattack_tpu_torch.attacks.losses import cosine_sim, layer_of, per_sample_mlm_loss
from vqattack_tpu_torch.models.vlmo import VLMo


def vlmo_per_sample_feature_loss(layer_cls, tokens, tgt_layer_cls, tgt_tokens,
                                 token_mask) -> torch.Tensor:
    """``[B]``: minus the cls cosines summed over layers, minus the masked
    token cosines summed over layers and tokens.  ``tokens`` is stacked or a
    tuple of per-layer ``[B, S, D]`` (``VLMo(fused_feats=True)``), whose
    cosines are reduced layer by layer without the stack; ``tgt_tokens`` is
    stacked or a tuple."""
    ps = -torch.sum(cosine_sim(layer_cls, tgt_layer_cls), dim=1)
    if isinstance(tokens, (tuple, list)):
        for layer, f in enumerate(tokens):
            ps = ps - torch.sum(cosine_sim(f, layer_of(tgt_tokens, layer)) * token_mask, dim=1)
        return ps
    cos_tok = cosine_sim(tokens, tgt_tokens) * token_mask[:, None, :]
    return ps - torch.sum(cos_tok, dim=(1, 2))


def _feature_ps(outputs, aux):
    _, layer_cls, tokens, token_mask = outputs
    mask = token_mask.float() * aux["tgt_token_mask"]
    return vlmo_per_sample_feature_loss(layer_cls, tokens, aux["tgt_layer_cls"],
                                        aux["tgt_tokens"], mask)


def make_feature_loss(model: VLMo):
    """ls==1 loss over the MoME trunk (``pgd_attack`` closure)."""

    def loss_fn(adv_px, key, aux):
        del key
        ps = _feature_ps(model.attack_feats(adv_px, aux["text_ids"], aux["text_mask"],
                                            aux.get("rel_biases")), aux)
        return ps.sum(), ps

    return loss_fn


def make_mlm_loss(model: VLMo):
    """ls==0 MAR loss (``pgd_mlm_attack`` closure + the fgm ls==0 branch)."""

    def loss_fn(adv_px, key, aux):
        del key
        logits, _, _, _ = model.attack_mlm(adv_px, aux["mlm_ids"], aux["mlm_mask"],
                                           aux.get("rel_biases"))
        ps = per_sample_mlm_loss(logits, aux["mlm_labels"])
        return ps.sum(), ps

    return loss_fn


def make_vl_loss(model: VLMo):
    """The joint image + text-embedding loss (``pgd_attack_vl`` closure)."""

    def loss_fn(adv_px, text_embeds, key, aux):
        del key
        ps = _feature_ps(model.attack_feats_from_embeds(adv_px, text_embeds, aux["text_mask"],
                                                        aux.get("rel_biases")), aux)
        return ps.sum(), ps

    return loss_fn
