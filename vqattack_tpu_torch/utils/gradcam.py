"""Grad-CAM over the fusion encoder's cross-attention.

Port of ``vqattack_tpu/utils/gradcam.py``.  The fusion BERT takes a
differentiable probe, a multiplicative scale on one layer's cross-attention
probabilities (``FusionBert.encode(cross_attn_scale=...,
cross_attn_scale_layer=...)``).  The gradient of a scalar score with respect
to the probe at ones is grad x attention, the Grad-CAM product, from one
ordinary backward pass.  A probed layer always takes the product + softmax
path; the rest of the model keeps ``--attn``'s choice (``ops/attention.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def gradcam_map(
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    attn_shape: Tuple[int, int, int, int],
    grid: Tuple[int, int],
    query_index: int = 0,
    device=None,
) -> np.ndarray:
    """A Grad-CAM heat map ``[B, grid_h, grid_w]``.

    ``score_fn(attn_scale) -> scalar`` runs the model with the probe
    ``[B, H, Q, K]`` (``attn_shape``) injected.  The map is relu(d score /
    d scale) at ones (= relu(grad x attention)), its mean over the heads, at
    the query token ``query_index``, the image [CLS] key dropped."""
    ones = torch.ones(attn_shape, dtype=torch.float32, device=device, requires_grad=True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(score_fn(ones), ones)  # [B, H, Q, K]
    cam = torch.mean(torch.clamp(grads, min=0.0), dim=1)[:, query_index, 1:]
    return cam.reshape(cam.shape[0], *grid).detach().cpu().numpy()


def albef_question_gradcam(
    model,
    pixels: torch.Tensor,
    text_ids: torch.Tensor,
    text_mask: torch.Tensor,
    layer: int = 8,
    query_index: int = 0,
) -> np.ndarray:
    """Where the fusion encoder looks when it encodes this question.

    ``model`` is an ``AlbefPretrain``; ``pixels`` NCHW on its device.  The
    score is the summed [CLS] state of the joint encoding; its
    attention gradient is mapped over the image patches at ``layer``.
    Returns ``[B, grid, grid]``."""
    cfg = model.cfg
    b = pixels.shape[0]
    grid = (cfg.vit.image_size // cfg.vit.patch_size,) * 2
    n_img = grid[0] * grid[1] + 1
    with torch.no_grad():  # the probe's gradient needs no graph through the image tower
        image_embeds, _ = model.visual_encoder(pixels)
        embeds = model.text_encoder.embed(text_ids)
    image_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long, device=pixels.device)

    def score_fn(attn_scale):
        last, _ = model.text_encoder.encode(
            embeds, text_mask, image_embeds, image_mask, mode="multi_modal",
            cross_attn_scale=attn_scale, cross_attn_scale_layer=layer)
        return torch.sum(last[:, 0])

    return gradcam_map(score_fn, (b, cfg.bert.num_heads, text_ids.shape[1], n_img), grid,
                       query_index, device=pixels.device)
