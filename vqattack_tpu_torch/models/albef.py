"""ALBEF surrogate (pre-trained) and victim (VQA fine-tuned) models.

Port of ``vqattack_tpu/models/albef.py``:

- :class:`AlbefPretrain` (``model_pretrain.py:20-141``): ViT-B/16 + fusion
  BERT with the MLM head; ``gen_feats``, ``gen_feats_from_embeds``,
  ``get_mlm_logits``, ``embed_text``.  The random 15% MLM masking the
  reference applies inside those calls is the caller's
  :func:`mlm_random_mask`, drawn from an explicit key (``rng.py``);
- :class:`AlbefVQA` (``model_vqa.py:11-211``): 12-layer fusion encoder +
  6-layer causal answer decoder, with the two-pass ``rank_answer``.

:func:`init_weights` draws random weights from a seed, with the JAX
package's initialisers' scales, on the module's device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from vqattack_tpu_torch.config import ALBEFConfig
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.layers import ResidualLayerNorm
from vqattack_tpu_torch.models.vit import VisionTransformer

IGNORE_INDEX = -100


def mlm_random_mask(
    key,
    input_ids: torch.Tensor,
    vocab_size: int,
    mask_token_id: int,
    pad_token_id: int = 0,
    cls_token_id: int = 101,
    mlm_probability: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT-style random masking (``model_pretrain.py:309-332``): select 15%
    of non-pad, non-CLS positions; of those 80% -> [MASK], 10% -> a random
    token, 10% unchanged.  Returns ``(masked_ids, labels)``, labels -100 off
    the selection.  ``key`` draws as in the JAX function (split in four)."""
    r_sel, r_rep, r_rand, r_words = key.split(4)
    shape = tuple(input_ids.shape)
    selectable = (input_ids != pad_token_id) & (input_ids != cls_token_id)
    masked = (r_sel.uniform(shape) < mlm_probability) & selectable
    labels = torch.where(masked, input_ids, torch.full_like(input_ids, IGNORE_INDEX))
    replaced = (r_rep.uniform(shape) < 0.8) & masked
    randomized = (r_rand.uniform(shape) < 0.5) & masked & ~replaced
    random_words = r_words.randint(shape, 0, vocab_size).to(input_ids.dtype)
    out = torch.where(replaced, torch.full_like(input_ids, mask_token_id), input_ids)
    out = torch.where(randomized, random_words, out)
    return out, labels


class AlbefPretrain(nn.Module):
    """The pre-trained ALBEF surrogate, the white-box model of the attack."""

    def __init__(self, cfg: ALBEFConfig):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_encoder = FusionBert(cfg.bert, with_mlm_head=True)
        # ITA/ITM heads: unused by the attack, part of the checkpoint surface
        self.vision_proj = nn.Linear(cfg.vit.hidden_size, cfg.embed_dim)
        self.text_proj = nn.Linear(cfg.bert.hidden_size, cfg.embed_dim)
        self.itm_head = nn.Linear(cfg.bert.hidden_size, 2)
        self.temp = nn.Parameter(torch.tensor(cfg.temp))

    def gen_feats(self, pixels, text_ids, text_mask):
        """(pixels, masked ids, mask) -> (img_feats, txt_feats, mlm_logits),
        feature stacks ``[B, 13, N, D]``."""
        image_embeds, img_feats = self.visual_encoder(pixels)
        image_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long,
                                device=image_embeds.device)
        _, txt_feats, mlm_logits = self.text_encoder(
            text_ids, attention_mask=text_mask, encoder_states=image_embeds,
            encoder_mask=image_mask, mode="multi_modal",
        )
        return img_feats, txt_feats, mlm_logits

    def gen_feats_from_embeds(self, pixels, text_embeds, text_mask):
        """Differentiable in the text embedding (``model_pretrain.py:85-104``)."""
        image_embeds, img_feats = self.visual_encoder(pixels)
        image_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long,
                                device=image_embeds.device)
        _, txt_feats, _ = self.text_encoder.encode_embeds(
            text_embeds, attention_mask=text_mask, encoder_states=image_embeds,
            encoder_mask=image_mask, mode="multi_modal",
        )
        return img_feats, txt_feats

    def get_mlm_logits(self, pixels, text_ids, text_mask):
        """MLM logits over the (already masked) paraphrase ids."""
        return self.gen_feats(pixels, text_ids, text_mask)[2]

    def embed_text(self, text_ids):
        """BERT embedding lookup (``adv_attack.py:369-384``)."""
        return self.text_encoder.embed(text_ids)

    def text_tower(self, ids, mask):
        """Last hidden states of the text-only layers (the similarity gate's
        encoder; ``run.py::_albef_text_tower`` of the JAX package)."""
        return self.text_encoder(ids, attention_mask=mask, mode="text")[0]


class AlbefVQA(nn.Module):
    """The fine-tuned ALBEF VQA victim, the black-box model of the attack."""

    def __init__(self, cfg: ALBEFConfig):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_encoder = FusionBert(cfg.bert, with_mlm_head=False)
        self.text_decoder = FusionBert(cfg.decoder_config, with_mlm_head=True)

    def encode_question(self, pixels, text_ids, text_mask):
        """(image, question) -> question states ``[B, S, D]``."""
        image_embeds, _ = self.visual_encoder(pixels)
        image_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long,
                                device=image_embeds.device)
        last, _, _ = self.text_encoder(
            text_ids, attention_mask=text_mask, encoder_states=image_embeds,
            encoder_mask=image_mask, mode="multi_modal",
        )
        return last

    def _decode_logits(self, answer_ids, answer_mask, question_states, question_mask):
        return self.text_decoder(
            answer_ids, attention_mask=answer_mask, encoder_states=question_states,
            encoder_mask=question_mask, mode="multi_modal",
        )[2]

    def answer_nll(self, answer_ids, answer_mask, question_states, question_mask,
                   pad_token_id: int = 0):
        """Per-token NLL of answer sequences shifted by one: ``[B, L-1]``."""
        logits = self._decode_logits(answer_ids, answer_mask, question_states, question_mask)
        targets = answer_ids[:, 1:]
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return nll * (targets != pad_token_id).float()

    def rank_answer(self, question_states, question_mask, answer_ids, answer_mask,
                    k: int, pad_token_id: int = 0):
        """Two-pass answer ranking (``model_vqa.py:149-203``): score every
        answer's first token from one BOS decode, keep the top ``k``, decode
        those ``k`` in full and re-rank by ``log p(first) + sum log p(rest)``.
        Returns ``(topk_ids [B, k], topk_probs [B, k])`` into the answer list."""
        num_q = question_states.shape[0]
        start_ids = answer_ids[:1, :1].expand(num_q, 1)
        logits = self._decode_logits(start_ids, None, question_states, question_mask)
        probs = torch.softmax(logits[:, 0, :].float(), dim=-1)  # [B, V]
        prob_first = probs[:, answer_ids[:, 1]]  # [B, A]
        topk_probs, topk_ids = torch.topk(prob_first, k, dim=-1)

        cand_ids = answer_ids[topk_ids].reshape(num_q * k, -1)
        cand_mask = answer_mask[topk_ids].reshape(num_q * k, -1)
        states_rep = question_states.repeat_interleave(k, dim=0)
        qmask_rep = question_mask.repeat_interleave(k, dim=0)
        nll = self.answer_nll(cand_ids, cand_mask, states_rep, qmask_rep, pad_token_id)
        log_probs_sum = torch.log(topk_probs) - nll.sum(-1).reshape(num_q, k)

        rerank_probs = torch.softmax(log_probs_sum, dim=-1)
        topk_probs2, rerank_id = torch.topk(rerank_probs, k, dim=-1)
        return torch.gather(topk_ids, 1, rerank_id), topk_probs2

    def forward(self, pixels, text_ids, text_mask, answer_ids, answer_mask, k: int = 128):
        states = self.encode_question(pixels, text_ids, text_mask)
        return self.rank_answer(states, text_mask, answer_ids, answer_mask, k,
                                pad_token_id=self.cfg.bert.pad_token_id)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, drawn on the module's device with the
    scales of the JAX package's initialisers: Linear and Conv kernels
    normal(0, 1/sqrt(fan_in)), biases 0, LayerNorm 1/0, embeddings and the
    ViT's [CLS]/position tables normal(0, 0.02)."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=device) * std)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, 1.0 / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, (nn.LayerNorm, ResidualLayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, VisionTransformer):
            normal_(m.cls_token, 0.02)
            normal_(m.pos_embed, 0.02)
    return module
