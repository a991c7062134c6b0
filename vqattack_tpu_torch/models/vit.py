"""ViT-B/16 image encoder with per-layer feature taps.

Port of ``vqattack_tpu/models/vit.py`` (reference ``models/vit.py:97-177``):
patchify, prepend [CLS], add the (truncated) position embedding, 12 pre-LN
blocks, final LayerNorm on the output only.  The feature stack holds the
embedding output plus every block output before the final norm:
``[B, depth+1, N+1, D]``, or with ``stack_feats=False`` a ``depth+1``-tuple
of ``[B, N+1, D]``, which the attack's loss reduces layer by layer without
the stack (JAX ``vit.py:34``, ``:111-113``).  Pixels are NCHW (the
reference layout).
"""

from __future__ import annotations

import torch
from torch import nn

from vqattack_tpu_torch.config import ViTConfig
from vqattack_tpu_torch.models.layers import (
    LayerNorm,
    PatchEmbed,
    ResidualLayerNorm,
    ViTBlock,
    resolve_dtype,
)


class VisionTransformer(nn.Module):
    """``dtype`` is the compute dtype of every layer (``models/layers.py``);
    the [CLS] token and the position table are cast to it, as the JAX
    encoder casts them, and the feature taps come out in it."""

    def __init__(self, cfg: ViTConfig, dtype="float32", stack_feats: bool = True):
        super().__init__()
        self.cfg = cfg
        self.stack_feats = stack_feats
        self.compute_dtype = resolve_dtype(dtype)
        d = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, d, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, d))
        self.blocks = nn.ModuleList(
            ViTBlock(d, cfg.num_heads, cfg.mlp_ratio, cfg.layer_norm_eps,
                     fused_ln=cfg.fused_ln, softmax_dtype=cfg.softmax_dtype, dtype=dtype)
            for _ in range(cfg.depth)
        )
        self.norm = (ResidualLayerNorm(d, cfg.layer_norm_eps) if cfg.fused_ln
                     else LayerNorm(d, cfg.layer_norm_eps, dtype))

    def forward(self, pixels: torch.Tensor):
        """pixels ``[B, 3, H, W]`` in [-1, 1] -> ``(normed output, feats)``:
        the stacked ``[B, depth+1, N+1, D]`` or, with ``stack_feats=False``,
        the tuple of its layers."""
        dt = self.compute_dtype
        x = self.patch_embed(pixels)
        b = x.shape[0]
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]].to(dt)
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
        if not self.stack_feats:
            return out, tuple(feats)
        return out, torch.stack(feats, dim=1)
