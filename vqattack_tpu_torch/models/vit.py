"""ViT-B/16 image encoder with per-layer feature taps.

Port of ``vqattack_tpu/models/vit.py`` (reference ``models/vit.py:97-177``):
patchify, prepend [CLS], add the (truncated) position embedding, 12 pre-LN
blocks, final LayerNorm on the output only.  The feature stack holds the
embedding output plus every block output before the final norm:
``[B, depth+1, N+1, D]``.  Pixels are NCHW (the reference layout).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vqattack_tpu_torch.config import ViTConfig
from vqattack_tpu_torch.models.layers import PatchEmbed, ResidualLayerNorm, ViTBlock


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, d))
        self.blocks = nn.ModuleList(
            ViTBlock(d, cfg.num_heads, cfg.mlp_ratio, cfg.layer_norm_eps,
                     fused_ln=cfg.fused_ln, softmax_dtype=cfg.softmax_dtype)
            for _ in range(cfg.depth)
        )
        self.norm = (ResidualLayerNorm(d, cfg.layer_norm_eps) if cfg.fused_ln
                     else nn.LayerNorm(d, eps=cfg.layer_norm_eps))

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels ``[B, 3, H, W]`` in [-1, 1] -> ``(normed output, feats)``."""
        x = self.patch_embed(pixels)
        b = x.shape[0]
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]]
        feats = [x]
        if self.cfg.fused_ln:
            # pending-residual carry (vit.py:89-103 of the JAX package): each
            # block's entry fuses the previous block's residual add with its
            # norm1; the final norm closes the last pending pair
            delta = None
            for i, block in enumerate(self.blocks):
                x, delta, tap = block(x, delta)
                if i > 0:
                    feats.append(tap)
            x, out = self.norm(x, delta)
            feats.append(x)
        else:
            for block in self.blocks:
                x = block(x)
                feats.append(x)
            out = self.norm(x)
        return out, torch.stack(feats, dim=1)
