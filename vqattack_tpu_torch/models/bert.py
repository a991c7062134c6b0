"""Fusion BERT: text encoder with per-layer cross-attention to image states,
plus the MLM / LM head.

Port of ``vqattack_tpu/models/bert.py`` (reference ``models/xbert.py``):
post-LN layers; layers ``>= fusion_layer`` cross-attend to ``encoder_states``;
modes ``"text"`` (layers ``[0, fusion_layer)``), ``"fusion"``
(``[fusion_layer, L)``) and ``"multi_modal"`` (all); every forward returns
the stacked per-layer states ``[B, n_run+1, S, D]``.  With ``is_decoder``
and ``fusion_layer=0`` the same module is the causal answer decoder.
``dtype`` is the compute dtype of every layer (``models/layers.py``); the
mask biases are built in it, as the JAX module builds them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqattack_tpu_torch.config import BertConfig
from vqattack_tpu_torch.models.layers import (
    Embedding,
    LayerNorm,
    Linear,
    MultiHeadAttention,
    causal_bias,
    gelu,
    mask_to_bias,
    resolve_dtype,
)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LayerNorm."""

    def __init__(self, cfg: BertConfig, dtype="float32"):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, d, dtype)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, d, dtype)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, d, dtype)
        self.LayerNorm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class _AttentionOutput(nn.Module):
    """HF BertSelfOutput: dense -> residual add -> LayerNorm."""

    def __init__(self, cfg: BertConfig, dtype="float32"):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, compute_dtype=dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertLayer(nn.Module):
    """One post-LN BERT layer with optional cross-attention (``xbert.py:442-520``)."""

    def __init__(self, cfg: BertConfig, has_cross_attention: bool, dtype="float32"):
        super().__init__()
        d = cfg.hidden_size
        self.has_cross_attention = has_cross_attention
        self.attention_self = MultiHeadAttention(
            d, cfg.num_heads, use_out_proj=False, softmax_dtype=cfg.softmax_dtype, dtype=dtype)
        self.attention_output = _AttentionOutput(cfg, dtype)
        if has_cross_attention:
            self.crossattention_self = MultiHeadAttention(
                d, cfg.num_heads, kv_dim=cfg.encoder_width, use_out_proj=False,
                softmax_dtype=cfg.softmax_dtype, dtype=dtype)
            self.crossattention_output = _AttentionOutput(cfg, dtype)
        self.intermediate_dense = Linear(d, cfg.intermediate_size, compute_dtype=dtype)
        self.output_dense = Linear(cfg.intermediate_size, d, compute_dtype=dtype)
        self.output_LayerNorm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def forward(self, x, self_bias, encoder_states=None, cross_bias=None):
        x = self.attention_output(self.attention_self(x, bias=self_bias), x)
        if self.has_cross_attention:
            if encoder_states is None:
                raise ValueError("a cross-attention layer needs image states")
            x = self.crossattention_output(
                self.crossattention_self(x, kv=encoder_states, bias=cross_bias), x)
        h = self.output_dense(gelu(self.intermediate_dense(x)))
        return self.output_LayerNorm(h + x)


class BertPredictionHead(nn.Module):
    """MLM/LM head: dense -> GELU -> LayerNorm -> vocab decoder."""

    def __init__(self, cfg: BertConfig, dtype="float32"):
        super().__init__()
        d = cfg.hidden_size
        self.transform_dense = Linear(d, d, compute_dtype=dtype)
        self.transform_LayerNorm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.decoder = Linear(d, cfg.vocab_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform_LayerNorm(gelu(self.transform_dense(x))))


class FusionBert(nn.Module):
    def __init__(self, cfg: BertConfig, with_mlm_head: bool = False, dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = resolve_dtype(dtype)
        self.embeddings = BertEmbeddings(cfg, dtype)
        self.layer = nn.ModuleList(
            BertLayer(cfg, has_cross_attention=i >= cfg.fusion_layer, dtype=dtype)
            for i in range(cfg.num_layers)
        )
        self.mlm_head = BertPredictionHead(cfg, dtype) if with_mlm_head else None

    def embed(self, input_ids, token_type_ids=None) -> torch.Tensor:
        return self.embeddings(input_ids, token_type_ids)

    def encode(
        self,
        hidden_states: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_states: Optional[torch.Tensor] = None,
        encoder_mask: Optional[torch.Tensor] = None,
        mode: str = "multi_modal",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the layer range of ``mode``; returns ``(last, feats)``."""
        cfg = self.cfg
        ranges = {"text": (0, cfg.fusion_layer),
                  "fusion": (cfg.fusion_layer, cfg.num_layers),
                  "multi_modal": (0, cfg.num_layers)}
        if mode not in ranges:
            raise ValueError(f"unknown mode: {mode}")
        start, stop = ranges[mode]
        dtype = self.compute_dtype
        self_bias = None if attention_mask is None else mask_to_bias(attention_mask, dtype)
        if cfg.is_decoder:
            cb = causal_bias(hidden_states.shape[1], hidden_states.device, dtype)
            self_bias = cb if self_bias is None else self_bias + cb
        cross_bias = None if encoder_mask is None else mask_to_bias(encoder_mask, dtype)
        x = hidden_states
        feats = [x]
        for i in range(start, stop):
            x = self.layer[i](x, self_bias, encoder_states, cross_bias)
            feats.append(x)
        return x, torch.stack(feats, dim=1)

    def forward(self, input_ids, attention_mask=None, encoder_states=None,
                encoder_mask=None, mode: str = "multi_modal", token_type_ids=None):
        """ids -> ``(last_hidden, feats, mlm_logits or None)``."""
        x = self.embeddings(input_ids, token_type_ids)
        return self.encode_embeds(x, attention_mask, encoder_states, encoder_mask, mode)

    def encode_embeds(self, embeds, attention_mask=None, encoder_states=None,
                      encoder_mask=None, mode: str = "multi_modal"):
        """Pre-embedded inputs -> ``(last_hidden, feats, mlm_logits or None)``."""
        last, feats = self.encode(embeds, attention_mask, encoder_states, encoder_mask, mode)
        logits = self.mlm_head(last) if self.mlm_head is not None else None
        return last, feats, logits
