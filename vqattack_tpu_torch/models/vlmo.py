"""VLMo: MoME multiway transformer, its heads and the attack-facing API.

Port of ``vqattack_tpu/models/vlmo.py`` (reference
``vlmo/modules/multiway_transformer.py`` and ``vlmo_module.py``):

- blocks with one shared self-attention and per-modality FFN experts
  (``mlp_text``/``mlp_imag``, and ``mlp_vl`` from ``vlffn_start_layer``),
  or, with ``moe=False`` (ViLT, ``config.vilt_base_config``), one shared
  ``norm2`` + ``mlp`` for every modality,
  the decomposed qkv bias (q and v biased, k not), layer scale
  ``gamma_1``/``gamma_2``, and the relative-position bias;
- one fused relative-position table ``[all_num_relative_distance, H * L]``,
  gathered per layer through host-side index tables;
- joint inference with per-layer feature taps, image tokens from index
  ``max_text_len``; the attack closures ``attack_feats``, ``attack_mlm``,
  ``attack_feats_from_embeds``; the 3,129-way VQA classifier; with
  ``with_nlvr2_head``, NLVR2's head over the pair's two pooled outputs
  (:meth:`VLMo.nlvr2_logits`, the second image at modality row 2, so the
  modality table holds at least 3 rows).

In the joint ``"vl"`` mode the sequence is split statically at
``max_text_len`` and each half runs its expert FFN.  Attention adds two
terms to the scores: the layer's ``[1, H, S, S]`` relative-position table
as ``bias`` and the padded-text mask as ``key_bias`` (``[B, S]``), so under
``--attn flash`` kernel K3 reads both without a ``[B, H, S, S]`` sum.
``dtype`` is the compute dtype of every layer (``models/layers.py``),
layer scale and the heads included.  Both attention terms are float32: the
table holds its values rounded to the compute dtype, as the JAX module
casts it, and the key mask is exact; the flash kernel reads them as they
are (the JAX wrapper casts its bias to float32), the product + softmax path
casts them to the scores' dtype (as the JAX einsum path does).
Pixels are NCHW.  Sub-module names follow the flax names, so
``checkpoint/convert.py::load_jax_params`` carries a JAX VLMo across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vqattack_tpu_torch.config import BertConfig, VLMoConfig
from vqattack_tpu_torch.models.albef import init_weights
from vqattack_tpu_torch.models.bert import BertEmbeddings, BertPredictionHead
from vqattack_tpu_torch.models.layers import (
    Embedding,
    LayerNorm,
    Linear,
    Mlp,
    MultiHeadAttention,
    PatchEmbed,
    gelu,
    mask_to_key_bias,
    resolve_dtype,
)


def build_relative_position_index(
    window: Tuple[int, int],
    max_text_len: int,
    max_text_len_of_initckpt: int = 196,
) -> Dict[str, np.ndarray]:
    """The three index tables of ``build_relative_position_embed``
    (``vlmo_module.py:818-883``): image-window pairwise indices (+3 special
    cls rows), text relative distances offset past the image block, and the
    two cross-modal constants, joined as ``joint``.  int32 arrays, and the
    table's row count as ``all_num_relative_distance``."""
    wh, ww = window
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    text_num_rel = 2 * max_text_len_of_initckpt
    all_num = num_rel + text_num_rel + 2

    ch, cw = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    coords = np.stack([ch, cw]).reshape(2, -1)  # [2, Wh*Ww]
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    img_idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int64)
    img_idx[1:, 1:] = rel.sum(-1)
    img_idx[0, :] = num_rel - 3
    img_idx[:, 0] = num_rel - 2
    img_idx[0, 0] = num_rel - 1

    tpos = np.arange(max_text_len - 1)
    tmat = tpos[None, :] - tpos[:, None]
    min_distance = 2 - max_text_len_of_initckpt
    tmat = tmat - min_distance + num_rel + 2
    txt_idx = np.zeros((max_text_len, max_text_len), np.int64)
    txt_idx[1:, 1:] = tmat
    txt_idx[0, :] = all_num - 3
    txt_idx[:, 0] = all_num - 2
    txt_idx[0, 0] = all_num - 1

    max_imag_len = wh * ww + 1
    t2i = np.full((max_text_len, max_imag_len), num_rel, np.int64)
    i2t = np.full((max_imag_len, max_text_len), num_rel + 1, np.int64)
    joint = np.concatenate([np.concatenate([txt_idx, t2i], axis=1),
                            np.concatenate([i2t, img_idx], axis=1)], axis=0)
    return {
        "image": img_idx.astype(np.int32),
        "text": txt_idx.astype(np.int32),
        "joint": joint.astype(np.int32),
        "all_num_relative_distance": all_num,
    }


class MultiWayBlock(nn.Module):
    """Shared attention, modality-expert FFNs (``multiway_transformer.py:121-201``).
    ``modality``: ``"text"``, ``"image"`` or ``"vl"`` (joint: the VL expert
    from ``vlffn_start_layer``, else the text expert on the first
    ``max_text_len`` tokens and the image expert on the rest).  With
    ``cfg.moe`` False (the single-stream ViLT block) one ``norm2`` + ``mlp``
    serves every modality."""

    def __init__(self, cfg: VLMoConfig, with_vlffn: bool, dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.with_vlffn = with_vlffn
        self.compute_dtype = resolve_dtype(dtype)
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        hidden = int(d * cfg.mlp_ratio)
        self.norm1 = LayerNorm(d, eps, dtype)
        self.attn = MultiHeadAttention(d, cfg.num_heads, softmax_dtype=cfg.softmax_dtype,
                                       q_bias=True, k_bias=False, v_bias=True, dtype=dtype)
        if cfg.layer_scale_init is not None:
            self.gamma_1 = nn.Parameter(torch.full((d,), float(cfg.layer_scale_init)))
            self.gamma_2 = nn.Parameter(torch.full((d,), float(cfg.layer_scale_init)))
        else:
            self.gamma_1 = self.gamma_2 = None
        if not cfg.moe:
            self.norm2 = LayerNorm(d, eps, dtype)
            self.mlp = Mlp(d, hidden, d, dtype)
            return
        self.norm2_text = LayerNorm(d, eps, dtype)
        self.mlp_text = Mlp(d, hidden, d, dtype)
        self.norm2_imag = LayerNorm(d, eps, dtype)
        self.mlp_imag = Mlp(d, hidden, d, dtype)
        if with_vlffn:
            self.norm2_vl = LayerNorm(d, eps, dtype)
            self.mlp_vl = Mlp(d, hidden, d, dtype)

    def _scaled(self, gamma, x):
        """Layer scale, ``gamma`` cast to the compute dtype as in the JAX block."""
        return x if gamma is None else gamma.to(self.compute_dtype) * x

    def forward(self, x: torch.Tensor, modality: str, bias: Optional[torch.Tensor] = None,
                key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self._scaled(self.gamma_1, self.attn(self.norm1(x), bias=bias,
                                                     key_bias=key_bias))
        g2 = self.gamma_2
        if not self.cfg.moe:  # single-stream: one FFN whatever the modality
            return x + self._scaled(g2, self.mlp(self.norm2(x)))
        if modality == "image":
            return x + self._scaled(g2, self.mlp_imag(self.norm2_imag(x)))
        if modality == "text":
            return x + self._scaled(g2, self.mlp_text(self.norm2_text(x)))
        if modality != "vl":
            raise ValueError(f"unknown modality {modality!r}")
        if self.with_vlffn:
            return x + self._scaled(g2, self.mlp_vl(self.norm2_vl(x)))
        t = self.cfg.max_text_len  # the static split (:192-197)
        x_text, x_imag = x[:, :t], x[:, t:]
        x_text = x_text + self._scaled(g2, self.mlp_text(self.norm2_text(x_text)))
        x_imag = x_imag + self._scaled(g2, self.mlp_imag(self.norm2_imag(x_imag)))
        return torch.cat([x_text, x_imag], dim=1)


class Pooler(nn.Module):
    """cls -> dense -> tanh (``heads.py:8``)."""

    def __init__(self, hidden_size: int, dtype="float32"):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))


class VQAClassifier(nn.Module):
    """dense(2D) -> LayerNorm -> GELU -> dense(labels) (``vlmo_module.py:274-280``).
    ``in_width``: fc1's input (default D; NLVR2's head takes the two pooled
    outputs, 2D, ``vlmo_module.py:283-290``)."""

    def __init__(self, hidden_size: int, num_labels: int, dtype="float32",
                 in_width: Optional[int] = None):
        super().__init__()
        self.fc1 = Linear(in_width or hidden_size, 2 * hidden_size, compute_dtype=dtype)
        self.norm = LayerNorm(2 * hidden_size, 1e-5, dtype)
        self.fc2 = Linear(2 * hidden_size, num_labels, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.norm(self.fc1(x))))


class LogitScale(nn.Module):
    """The learnable contrastive temperature ``scale`` (``log(1/0.07)``)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self) -> torch.Tensor:
        return self.scale


def _layer_cls(feats) -> torch.Tensor:
    """Per-layer cls states ``[B, L+1, D]`` of a stacked ``[B, L+1, S, D]``
    or of a tuple of per-layer ``[B, S, D]`` (``fused_feats``)."""
    if isinstance(feats, (tuple, list)):
        return torch.stack([f[:, 0] for f in feats], dim=1)
    return feats[:, :, 0, :]


class VLMo(nn.Module):
    """The VLMo surrogate (and, with its VQA head, the victim); with
    ``cfg.moe`` False the ViLT model.  Holds every parameter of the JAX
    module's ``init_all``.  ``with_nlvr2_head``: NLVR2's classifier, and a
    modality table of ``max(type_vocab_size, 3)`` rows (row 2 is the second
    image's; the reference widens a 2-row table at load,
    ``vlmo_module.py:291-296``).  ``fused_feats``: the attack closures
    return the per-layer token features as a tuple, which the attack's loss
    reduces layer by layer without the ``[B, L+1, S, D]`` stack (JAX
    ``vlmo.py:254-258``)."""

    def __init__(self, cfg: VLMoConfig, with_vqa_head: bool = True, dtype="float32",
                 with_nlvr2_head: bool = False, fused_feats: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fused_feats = fused_feats
        self.compute_dtype = resolve_dtype(dtype)
        d = cfg.hidden_size
        bert_cfg = BertConfig(vocab_size=cfg.vocab_size, hidden_size=d,
                              max_position_embeddings=cfg.max_position_embeddings,
                              type_vocab_size=cfg.type_vocab_size, layer_norm_eps=1e-12)
        self.text_embeddings = BertEmbeddings(bert_cfg, dtype)
        n_types = max(cfg.type_vocab_size, 3) if with_nlvr2_head else cfg.type_vocab_size
        self.token_type_embeddings = Embedding(n_types, d, dtype)
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, d, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = (nn.Parameter(torch.zeros(1, cfg.image_seq_len, d))
                          if cfg.use_abs_pos_emb else None)
        self.blocks = nn.ModuleList(
            MultiWayBlock(cfg, with_vlffn=i >= cfg.vlffn_start_layer, dtype=dtype)
            for i in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.pooler = Pooler(d, dtype)
        self.mlm_score = BertPredictionHead(bert_cfg, dtype)
        self.itm_score = Linear(d, 2, compute_dtype=dtype)
        self.itc_text_proj = Linear(d, d, bias=False, compute_dtype=dtype)
        self.itc_image_proj = Linear(d, d, bias=False, compute_dtype=dtype)
        self.logit_scale = LogitScale()
        if self._has_vlffn:
            self.itc_vl_text_proj = Linear(d, d, bias=False, compute_dtype=dtype)
            self.itc_vl_image_proj = Linear(d, d, bias=False, compute_dtype=dtype)
            self.logit_vl_scale = LogitScale()
        self.vqa_classifier = (VQAClassifier(d, cfg.vqa_label_size, dtype) if with_vqa_head
                               else None)
        self.nlvr2_classifier = (VQAClassifier(d, 2, dtype, in_width=2 * d) if with_nlvr2_head
                                 else None)
        if cfg.need_relative_position_embed:
            tables = build_relative_position_index(cfg.window_size, cfg.max_text_len)
            for kind in ("image", "text", "joint"):
                self.register_buffer(f"_rel_index_{kind}",
                                     torch.from_numpy(tables[kind].astype(np.int64)),
                                     persistent=False)
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(tables["all_num_relative_distance"], cfg.num_heads * cfg.depth))
        else:
            self.relative_position_bias_table = None

    @property
    def _has_vlffn(self) -> bool:
        return bool(self.cfg.moe) and self.cfg.vlffn_start_layer < self.cfg.depth

    # ------------------------------------------------------------- internals

    def _rel_bias(self, layer: int, kind: str) -> Optional[torch.Tensor]:
        """Layer ``layer``'s ``[1, H, S, S]`` bias from the fused table
        (``get_rel_pos_bias``, ``vlmo_module.py:807-816``), rounded to the
        compute dtype as the JAX module casts it and held in float32, the
        type the flash kernel reads; None without one."""
        if self.relative_position_bias_table is None:
            return None
        h = self.cfg.num_heads
        tbl = self.relative_position_bias_table[:, layer * h : (layer + 1) * h]
        idx = getattr(self, f"_rel_index_{kind}")
        bias = tbl[idx].permute(2, 0, 1)[None]  # [S, S, H] -> [1, H, S, S]
        return bias.to(self.compute_dtype).float()

    def visual_embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """patchify + cls + (optional) absolute position (``multiway_transformer.py:366-380``)."""
        dt = self.compute_dtype
        x = self.patch_embed(pixels)
        x = torch.cat([self.cls_token.to(dt).expand(x.shape[0], -1, -1), x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(dt)
        return x

    @torch.no_grad()
    def precompute_joint_biases(self) -> Optional[torch.Tensor]:
        """All layers' joint relative-position biases as one contiguous
        ``[depth, H, S, S]`` stack, without gradient.  The gather depends on
        the parameters only: an attack computes it once, not in every PGD
        forward, and K3 takes each layer's slice as a bias that needs no
        gradient."""
        if self.relative_position_bias_table is None:
            return None
        return torch.stack([self._rel_bias(i, "joint")[0]
                            for i in range(self.cfg.depth)]).contiguous()

    def _joint_trunk(self, text_ids, text_masks, pixels, image_token_type_idx: int = 1,
                     rel_biases: Optional[torch.Tensor] = None, stack: bool = True,
                     text_embeds: Optional[torch.Tensor] = None):
        """The shared VL forward: ``(normed x, feats [B, L+1, S, D], co_masks
        [B, S])`` with ``S = max_text_len + image_seq_len``.  ``rel_biases``
        (:meth:`precompute_joint_biases`) skips the per-layer gathers;
        ``stack=False`` returns the feats as a per-layer tuple;
        ``text_embeds`` (before the token-type add) bypasses the embedding
        lookup, the differentiable entry of the VL step."""
        if text_embeds is None:
            text_embeds = self.text_embeddings(text_ids)
        image_embeds = self.visual_embed(pixels)
        image_masks = torch.ones(image_embeds.shape[:2], dtype=text_masks.dtype,
                                 device=image_embeds.device)
        text_embeds = text_embeds + self.token_type_embeddings(torch.zeros_like(text_masks))
        image_embeds = image_embeds + self.token_type_embeddings(
            torch.full_like(image_masks, image_token_type_idx))
        x = torch.cat([text_embeds, image_embeds], dim=1)
        co_masks = torch.cat([text_masks, image_masks], dim=1)
        key_bias = mask_to_key_bias(co_masks)
        feats = [x]
        for i, blk in enumerate(self.blocks):
            bias = rel_biases[i][None] if rel_biases is not None else self._rel_bias(i, "joint")
            x = blk(x, "vl", bias, key_bias)
            feats.append(x)
        return self.norm(x), (torch.stack(feats, dim=1) if stack else tuple(feats)), co_masks

    # ----------------------------------------------------------- public API

    def infer(self, text_ids, text_masks, pixels) -> Dict[str, torch.Tensor]:
        """Joint VL inference (``vlmo_module.py:884-948``)."""
        xn, feats, _ = self._joint_trunk(text_ids, text_masks, pixels)
        t = self.cfg.max_text_len
        return {"text_feats": xn[:, :t], "image_feats": xn[:, t:],
                "cls_feats": self.pooler(xn), "raw_cls_feats": xn[:, 0], "feats": feats}

    def infer_text(self, text_ids, text_masks, vlffn: bool = False) -> Dict[str, torch.Tensor]:
        """The text-only tower (``vlmo_module.py:950-1006``); ``vlffn=True``
        adds the VL-expert branch from ``vlffn_start_layer`` as
        ``cls_vlffn_feats``."""
        x = self.text_embeddings(text_ids) + self.token_type_embeddings(
            torch.zeros_like(text_masks))
        key_bias = mask_to_key_bias(text_masks)
        feats = [x]
        for i, blk in enumerate(self.blocks):
            x = blk(x, "text", self._rel_bias(i, "text"), key_bias)
            feats.append(x)
        xn = self.norm(x)
        out = {"text_feats": xn, "cls_feats": self.itc_text_proj(xn[:, 0]),
               "mlm_logits": self.mlm_score(xn), "feats": torch.stack(feats, dim=1)}
        if vlffn and self._has_vlffn:
            start = self.cfg.vlffn_start_layer
            vl = feats[start]
            for i in range(start, self.cfg.depth):
                vl = self.blocks[i](vl, "vl", self._rel_bias(i, "text"), key_bias)
            out["cls_vlffn_feats"] = self.itc_vl_text_proj(self.norm(vl)[:, 0])
        return out

    def infer_image(self, pixels, vlffn: bool = False) -> Dict[str, torch.Tensor]:
        """The image-only tower (``vlmo_module.py:1101-1166``)."""
        x = self.visual_embed(pixels)
        x = x + self.token_type_embeddings(
            torch.ones(x.shape[:2], dtype=torch.long, device=x.device))
        feats = [x]
        for i, blk in enumerate(self.blocks):
            x = blk(x, "image", self._rel_bias(i, "image"))
            feats.append(x)
        xn = self.norm(x)
        out = {"image_feats": xn, "cls_feats": self.itc_image_proj(xn[:, 0]),
               "feats": torch.stack(feats, dim=1)}
        if vlffn and self._has_vlffn:
            start = self.cfg.vlffn_start_layer
            vl = feats[start]
            for i in range(start, self.cfg.depth):
                vl = self.blocks[i](vl, "vl", self._rel_bias(i, "image"))
            out["cls_vlffn_feats"] = self.itc_vl_image_proj(self.norm(vl)[:, 0])
        return out

    # ------------------------------------------------------- attack closures

    def attack_feats(self, pixels, text_ids, text_masks, rel_biases=None):
        """``pgd_attack`` (``vlmo_module.py:1387-1446``): ``(cls_feats [B, D],
        layer_cls [B, L+1, D], token_feats [B, L+1, S, D], token_mask [B, S])``;
        the mask selects the valid text tokens and every image token; the
        token feats a per-layer tuple with ``fused_feats``."""
        xn, feats, co_masks = self._joint_trunk(text_ids, text_masks, pixels,
                                                rel_biases=rel_biases,
                                                stack=not self.fused_feats)
        return self.pooler(xn), _layer_cls(feats), feats, co_masks

    def attack_mlm(self, pixels, mlm_ids, mlm_masks, rel_biases=None):
        """``pgd_mlm_attack`` (``vlmo_module.py:1448-1529``): MLM logits over
        the text half and the same feature stacks."""
        xn, feats, co_masks = self._joint_trunk(mlm_ids, mlm_masks, pixels,
                                                rel_biases=rel_biases,
                                                stack=not self.fused_feats)
        logits = self.mlm_score(xn[:, : self.cfg.max_text_len])
        return logits, _layer_cls(feats), feats, co_masks

    def attack_feats_from_embeds(self, pixels, text_embeds, text_masks, rel_biases=None):
        """``pgd_attack_vl`` (``vlmo_module.py:1328-1385``): text embeddings
        enter before the token-type add, differentiable."""
        xn, feats, co_masks = self._joint_trunk(None, text_masks, pixels,
                                                rel_biases=rel_biases,
                                                stack=not self.fused_feats,
                                                text_embeds=text_embeds)
        return self.pooler(xn), _layer_cls(feats), feats, co_masks

    def embed_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.text_embeddings(text_ids)

    def vqa_logits(self, pixels, text_ids, text_masks, rel_biases=None) -> torch.Tensor:
        """The victim: joint forward -> pooler -> the 3,129-way classifier
        (``objectives.py:375-414``)."""
        xn, _, _ = self._joint_trunk(text_ids, text_masks, pixels, rel_biases=rel_biases)
        return self.vqa_classifier(self.pooler(xn))

    def nlvr2_logits(self, pixels1, pixels2, text_ids, text_masks) -> torch.Tensor:
        """NLVR2 (``objectives.py:416-475``): the statement encoded with each
        image, at modality rows 1 and 2, the two pooled outputs concatenated
        into the 2-way head.  Needs ``with_nlvr2_head``."""
        x1, _, _ = self._joint_trunk(text_ids, text_masks, pixels1, 1)
        x2, _, _ = self._joint_trunk(text_ids, text_masks, pixels2, 2)
        return self.nlvr2_classifier(torch.cat([self.pooler(x1), self.pooler(x2)], dim=-1))

    def forward(self, text_ids, text_masks, pixels):
        return self.infer(text_ids, text_masks, pixels)


@torch.no_grad()
def init_vlmo_weights(model: VLMo, seed: int) -> VLMo:
    """Random weights from ``seed`` on the model's device: the JAX package's
    initialiser scales (:func:`~vqattack_tpu_torch.models.albef.init_weights`),
    layer scale at ``layer_scale_init``, the logit scales at ``log(1/0.07)``,
    [CLS] and position tables normal(0, 0.02), and the relative-position
    table normal(0, 0.5): a trained table's entries are of order one, where
    the JAX initialiser's zeros would leave the bias path with nothing to
    add."""
    init_weights(model, seed)
    device = model.cls_token.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=device) * std)

    normal_(model.cls_token, 0.02)
    if model.pos_embed is not None:
        normal_(model.pos_embed, 0.02)
    if model.relative_position_bias_table is not None:
        normal_(model.relative_position_bias_table, 0.5)
    for blk in model.blocks:
        for g in (blk.gamma_1, blk.gamma_2):
            if g is not None:
                g.fill_(float(model.cfg.layer_scale_init))
    for m in model.modules():
        if isinstance(m, LogitScale):
            m.scale.fill_(math.log(1 / 0.07))
    return model
