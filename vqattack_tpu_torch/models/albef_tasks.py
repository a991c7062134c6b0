"""ALBEF's downstream task models: visual entailment, NLVR2, image-text
retrieval.

Port of ``vqattack_tpu/models/albef_tasks.py`` (the reference's
``models/model_ve.py``, ``model_nlvr.py`` and ``model_retrieval.py``):

- :class:`AlbefVE`: the 12-layer fusion encoder and a two-layer ReLU head
  over the [CLS] state, 3 classes (entailment, neutral, contradiction);
- :class:`AlbefNLVR`: an 18-layer encoder whose cross-attention layers
  alternate between the pair's two image streams, a 2-way head.  The pixels
  stack the pair as ``[2B, 3, H, W]``, image 0 first, so that one ViT
  forward encodes both;
- :class:`AlbefRetrieval`: the contrastive projections (the shortlist) and
  the fusion ITM head (the re-rank).

Sub-module names follow the flax names, so that
``checkpoint/convert.py::load_jax_params`` carries a JAX tree across, and
``models/albef.py::init_weights`` draws every weight of these models (the
heads are ``Linear`` layers; ``temp`` keeps ``cfg.temp``, the JAX
initialiser's constant).  Pixels are NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from vqattack_tpu_torch.config import ALBEFConfig
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.layers import Linear
from vqattack_tpu_torch.models.vit import VisionTransformer


def _ones_mask(embeds: torch.Tensor) -> torch.Tensor:
    return torch.ones(embeds.shape[:2], dtype=torch.long, device=embeds.device)


def _normed(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ClsHead(nn.Module):
    """dense -> ReLU -> dense (``model_ve.py:28-32``)."""

    def __init__(self, width: int, num_classes: int, dtype="float32"):
        super().__init__()
        self.fc1 = Linear(width, width, compute_dtype=dtype)
        self.fc2 = Linear(width, num_classes, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class AlbefVE(nn.Module):
    """Visual entailment (SNLI-VE): the joint encode, then a 3-way head."""

    def __init__(self, cfg: ALBEFConfig, dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, dtype)
        self.text_encoder = FusionBert(cfg.bert, dtype=dtype)
        self.cls_head = ClsHead(cfg.bert.hidden_size, 3, dtype)

    def forward(self, pixels, text_ids, text_mask) -> torch.Tensor:
        image_embeds, _ = self.visual_encoder(pixels)
        last, _, _ = self.text_encoder(text_ids, attention_mask=text_mask,
                                       encoder_states=image_embeds,
                                       encoder_mask=_ones_mask(image_embeds), mode="multi_modal")
        return self.cls_head(last[:, 0])


class AlbefNLVR(nn.Module):
    """NLVR2: one statement, two images, the cross-attention alternating
    between them layer by layer (``model_nlvr.py:58-75``).  ``pixels`` stacks
    the pair, ``[2B, 3, H, W]`` with image 0 first."""

    def __init__(self, cfg: ALBEFConfig, num_layers: int = 18, dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, dtype)
        # model_nlvr.py:25: bert_config.num_hidden_layers = 18
        self.text_encoder = FusionBert(dataclasses.replace(cfg.bert, num_layers=num_layers),
                                       dtype=dtype)
        self.cls_head = ClsHead(cfg.bert.hidden_size, 2, dtype)

    def forward(self, pixels, text_ids, text_mask) -> torch.Tensor:
        b = text_ids.shape[0]
        image_embeds, _ = self.visual_encoder(pixels)
        img0, img1 = image_embeds[:b], image_embeds[b:]
        enc = self.text_encoder
        last, _ = enc.encode(enc.embed(text_ids), text_mask, (img0, img1),
                             (_ones_mask(img0), _ones_mask(img1)), mode="multi_modal")
        return self.cls_head(last[:, 0])


class AlbefRetrieval(nn.Module):
    """Image-text retrieval: the contrastive projections for the shortlist
    and the fusion ITM head for the re-rank (``model_retrieval.py``)."""

    def __init__(self, cfg: ALBEFConfig, dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, dtype)
        self.text_encoder = FusionBert(cfg.bert, dtype=dtype)
        self.vision_proj = Linear(cfg.vit.hidden_size, cfg.embed_dim, compute_dtype=dtype)
        self.text_proj = Linear(cfg.bert.hidden_size, cfg.embed_dim, compute_dtype=dtype)
        self.itm_head = Linear(cfg.bert.hidden_size, 2, compute_dtype=dtype)
        self.temp = nn.Parameter(torch.tensor(cfg.temp))

    def image_features(self, pixels) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(normalised ITA feature [B, E], image embeds [B, N, D])``."""
        image_embeds, _ = self.visual_encoder(pixels)
        return _normed(self.vision_proj(image_embeds[:, 0])), image_embeds

    def text_features(self, text_ids, text_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(normalised ITA feature [B, E], text-layer states [B, S, D])``."""
        last, _, _ = self.text_encoder(text_ids, attention_mask=text_mask, mode="text")
        return _normed(self.text_proj(last[:, 0])), last

    def itm_score(self, text_embeds, text_mask, image_embeds) -> torch.Tensor:
        """The fusion layers' match logits ``[B, 2]`` of text states against
        image embeds (the re-rank of the shortlisted pairs)."""
        last, _ = self.text_encoder.encode(text_embeds, text_mask, image_embeds,
                                           _ones_mask(image_embeds), mode="fusion")
        return self.itm_head(last[:, 0])

    def forward(self, pixels, text_ids, text_mask):
        """``(similarities [B, B] over temp, the pairs' ITM logits [B, 2])``."""
        img_feat, image_embeds = self.image_features(pixels)
        txt_feat, text_embeds = self.text_features(text_ids, text_mask)
        sim = img_feat @ txt_feat.T / self.temp
        return sim, self.itm_score(text_embeds, text_mask, image_embeds)
