"""Synthetic checkpoints in the reference's names and layouts, from a seed.

No real ALBEF, VLMo or BERT checkpoint is in the repository, and none may
be downloaded where the tests and ``chip_smoke.py`` run, so both write
these: the state dicts the reference's torch modules save (timm ViT, HF
BERT, ALBEF's ``model_pretrain.py`` / ``model_vqa.py``, VLMo's
``vlmo_module.py``), every tensor drawn from ``numpy.random.default_rng(seed)``
so that a loaded parameter can be told from any other.  Each function
takes the port's config for the geometry and returns ``{name: tensor}``;
:func:`save_hf_bert_dir` writes a Hugging Face directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vqattack_tpu_torch.config import ALBEFConfig, BertConfig, ViTConfig, VLMoConfig

# VLMo heads (vlmo_module.py:229-296): a pre-trained file has the first
# four, a VQA fine-tuned one the classifier
VLMO_PRETRAIN_HEADS = ("mlm_score", "itm_score", "itc", "itc_vl")
VLMO_VQA_HEADS = ("vqa_classifier",)


class _Writer:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd: Dict[str, torch.Tensor] = {}

    def normal(self, name: str, shape, std: float = 0.02, mean: float = 0.0):
        a = self.rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        self.sd[name] = torch.from_numpy(a + np.float32(mean) if mean else a)

    def linear(self, name: str, d_in: int, d_out: int, bias: bool = True):
        self.normal(f"{name}.weight", (d_out, d_in), d_in ** -0.5)
        if bias:
            self.normal(f"{name}.bias", (d_out,))

    def layernorm(self, name: str, d: int, suffixes=("weight", "bias")):
        self.normal(f"{name}.{suffixes[0]}", (d,), 0.1, mean=1.0)
        self.normal(f"{name}.{suffixes[1]}", (d,))

    def position_ids(self, name: str, n: int):
        self.sd[name] = torch.arange(n)[None]


def _vit(w: _Writer, p: str, cfg: ViTConfig, src_image_size: int):
    d = cfg.hidden_size
    w.normal(f"{p}cls_token", (1, 1, d))
    w.normal(f"{p}pos_embed", (1, (src_image_size // cfg.patch_size) ** 2 + 1, d))
    w.normal(f"{p}patch_embed.proj.weight", (d, 3, cfg.patch_size, cfg.patch_size))
    w.normal(f"{p}patch_embed.proj.bias", (d,))
    hidden = int(d * cfg.mlp_ratio)
    for i in range(cfg.depth):
        b = f"{p}blocks.{i}"
        w.layernorm(f"{b}.norm1", d)
        w.linear(f"{b}.attn.qkv", d, 3 * d)
        w.linear(f"{b}.attn.proj", d, d)
        w.layernorm(f"{b}.norm2", d)
        w.linear(f"{b}.mlp.fc1", d, hidden)
        w.linear(f"{b}.mlp.fc2", hidden, d)
    w.layernorm(f"{p}norm", d)


def _bert(w: _Writer, p: str, cfg: BertConfig, num_layers: int, fusion_layer: int,
          ln=("weight", "bias")):
    d = cfg.hidden_size
    w.normal(f"{p}embeddings.word_embeddings.weight", (cfg.vocab_size, d))
    w.normal(f"{p}embeddings.position_embeddings.weight", (cfg.max_position_embeddings, d))
    w.normal(f"{p}embeddings.token_type_embeddings.weight", (cfg.type_vocab_size, d))
    w.layernorm(f"{p}embeddings.LayerNorm", d, ln)
    w.position_ids(f"{p}embeddings.position_ids", cfg.max_position_embeddings)
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}"
        kinds = ["attention"] + (["crossattention"] if i >= fusion_layer else [])
        for kind in kinds:
            width = cfg.encoder_width if kind == "crossattention" else d
            w.linear(f"{lp}.{kind}.self.query", d, d)
            w.linear(f"{lp}.{kind}.self.key", width, d)
            w.linear(f"{lp}.{kind}.self.value", width, d)
            w.linear(f"{lp}.{kind}.output.dense", d, d)
            w.layernorm(f"{lp}.{kind}.output.LayerNorm", d, ln)
        w.linear(f"{lp}.intermediate.dense", d, cfg.intermediate_size)
        w.linear(f"{lp}.output.dense", cfg.intermediate_size, d)
        w.layernorm(f"{lp}.output.LayerNorm", d, ln)


def _mlm_head(w: _Writer, p: str, d: int, vocab: int, decoder_weight: bool = True,
              ln=("weight", "bias")):
    w.linear(f"{p}predictions.transform.dense", d, d)
    w.layernorm(f"{p}predictions.transform.LayerNorm", d, ln)
    if decoder_weight:
        w.normal(f"{p}predictions.decoder.weight", (vocab, d))
    w.normal(f"{p}predictions.bias", (vocab,))


def albef_pretrain_state_dict(cfg: ALBEFConfig, seed: int = 0,
                              src_image_size: int = 224) -> Dict[str, torch.Tensor]:
    """``ALBEF.pth``'s ``model``: the online model with the ViT at
    ``src_image_size``, some momentum copies (``*_m``) and the two feature
    queues, which the converter leaves out."""
    w = _Writer(seed)
    _vit(w, "visual_encoder.", cfg.vit, src_image_size)
    _bert(w, "text_encoder.bert.", cfg.bert, cfg.bert.num_layers, cfg.bert.fusion_layer)
    _mlm_head(w, "text_encoder.cls.", cfg.bert.hidden_size, cfg.bert.vocab_size)
    # the tied decoder bias: saved under both names, one value
    w.sd["text_encoder.cls.predictions.decoder.bias"] = w.sd["text_encoder.cls.predictions.bias"]
    w.linear("vision_proj", cfg.vit.hidden_size, cfg.embed_dim)
    w.linear("text_proj", cfg.bert.hidden_size, cfg.embed_dim)
    w.linear("itm_head", cfg.bert.hidden_size, 2)
    w.sd["temp"] = torch.tensor(cfg.temp)
    d = cfg.vit.hidden_size
    w.normal("visual_encoder_m.cls_token", (1, 1, d))
    w.normal("visual_encoder_m.blocks.0.attn.qkv.weight", (3 * d, d))
    w.normal("text_encoder_m.bert.embeddings.word_embeddings.weight",
             (cfg.bert.vocab_size, cfg.bert.hidden_size))
    w.linear("vision_proj_m", d, cfg.embed_dim)
    for name in ("image_queue", "text_queue"):
        w.normal(name, (cfg.embed_dim, 65536), 0.05)
    w.sd["queue_ptr"] = torch.zeros(1, dtype=torch.long)
    return w.sd


def albef_vqa_state_dict(cfg: ALBEFConfig, seed: int = 0,
                         src_image_size: int = 384) -> Dict[str, torch.Tensor]:
    """ALBEF's fine-tuned VQA model: the ViT at ``src_image_size``, the
    question encoder as a ``BertModel`` (``text_encoder.*``), the answer
    decoder with its LM head, and some momentum copies."""
    w = _Writer(seed)
    _vit(w, "visual_encoder.", cfg.vit, src_image_size)
    _bert(w, "text_encoder.", cfg.bert, cfg.bert.num_layers, cfg.bert.fusion_layer)
    dec = cfg.decoder_config
    _bert(w, "text_decoder.bert.", dec, dec.num_layers, 0)
    _mlm_head(w, "text_decoder.cls.", dec.hidden_size, dec.vocab_size)
    d = cfg.vit.hidden_size
    w.normal("visual_encoder_m.blocks.0.attn.qkv.weight", (3 * d, d))
    w.normal("text_decoder_m.cls.predictions.bias", (dec.vocab_size,))
    return w.sd


def hf_bert_mlm_state_dict(cfg: BertConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The original ``bert-base-uncased`` ``BertForMaskedLM`` file: the
    pooler and the next-sentence head beside the MLM head, no decoder weight
    (tied to the word embeddings) and the TF-converted LayerNorm spelling
    ``gamma``/``beta``."""
    w = _Writer(seed)
    ln = ("gamma", "beta")
    _bert(w, "bert.", cfg, cfg.num_layers, cfg.num_layers, ln)
    w.linear("bert.pooler.dense", cfg.hidden_size, cfg.hidden_size)
    _mlm_head(w, "cls.", cfg.hidden_size, cfg.vocab_size, decoder_weight=False, ln=ln)
    w.linear("cls.seq_relationship", cfg.hidden_size, 2)
    return w.sd


def save_hf_bert_dir(directory: str, cfg: BertConfig, sd: Dict[str, torch.Tensor]) -> None:
    """``config.json`` + ``pytorch_model.bin``, as ``save_pretrained`` lays
    out a BERT directory."""
    os.makedirs(directory, exist_ok=True)
    config = {"architectures": ["BertForMaskedLM"], "model_type": "bert",
              "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
              "vocab_size": cfg.vocab_size, "max_position_embeddings": cfg.max_position_embeddings,
              "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.layer_norm_eps}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    torch.save(sd, os.path.join(directory, "pytorch_model.bin"))


def vlmo_state_dict(cfg: VLMoConfig, seed: int = 0, src_image_size: Optional[int] = None,
                    heads: Sequence[str] = VLMO_PRETRAIN_HEADS) -> Dict[str, torch.Tensor]:
    """A VLMo checkpoint's state dict at ``src_image_size`` (default: the
    config's): the multiway trunk with the decomposed qkv bias, layer scale
    where the config has it, the relative table (or ``pos_embed`` for the
    abs-pos models), the pooler and the named ``heads`` (of ``mlm_score``,
    ``itm_score``, ``itc``, ``itc_vl``, ``vqa_classifier``,
    ``nlvr2_classifier``)."""
    from vqattack_tpu_torch.models.vlmo import build_relative_position_index

    w = _Writer(seed)
    d, p = cfg.hidden_size, "transformer."
    window = (src_image_size or cfg.image_size) // cfg.patch_size
    w.normal(f"{p}cls_token", (1, 1, d))
    w.normal(f"{p}patch_embed.proj.weight", (d, 3, cfg.patch_size, cfg.patch_size))
    w.normal(f"{p}patch_embed.proj.bias", (d,))
    if cfg.use_abs_pos_emb:
        w.normal(f"{p}pos_embed", (1, window ** 2 + 1, d))
    hidden = int(d * cfg.mlp_ratio)
    for i in range(cfg.depth):
        b = f"{p}blocks.{i}"
        w.layernorm(f"{b}.norm1", d)
        w.linear(f"{b}.attn.qkv", d, 3 * d, bias=False)
        w.normal(f"{b}.attn.q_bias", (d,))
        w.normal(f"{b}.attn.v_bias", (d,))
        w.linear(f"{b}.attn.proj", d, d)
        experts = ("text", "imag") + (("vl",) if i >= cfg.vlffn_start_layer else ())
        for e in experts:
            w.layernorm(f"{b}.norm2_{e}", d)
            w.linear(f"{b}.mlp_{e}.fc1", d, hidden)
            w.linear(f"{b}.mlp_{e}.fc2", hidden, d)
        if cfg.layer_scale_init is not None:
            w.normal(f"{b}.gamma_1", (d,), 0.01, mean=cfg.layer_scale_init)
            w.normal(f"{b}.gamma_2", (d,), 0.01, mean=cfg.layer_scale_init)
    w.layernorm(f"{p}norm", d)
    if cfg.need_relative_position_embed:
        rows = build_relative_position_index((window, window), cfg.max_text_len)[
            "all_num_relative_distance"]
        w.normal("relative_position_bias_table", (rows, cfg.num_heads * cfg.depth), 0.5)
    w.normal("text_embeddings.word_embeddings.weight", (cfg.vocab_size, d))
    w.normal("text_embeddings.position_embeddings.weight", (cfg.max_position_embeddings, d))
    w.normal("text_embeddings.token_type_embeddings.weight", (2, d))
    w.layernorm("text_embeddings.LayerNorm", d)
    w.position_ids("text_embeddings.position_ids", cfg.max_position_embeddings)
    w.normal("token_type_embeddings.weight", (cfg.type_vocab_size, d))
    w.linear("pooler.dense", d, d)
    if "mlm_score" in heads:
        w.linear("mlm_score.transform.dense", d, d)
        w.layernorm("mlm_score.transform.LayerNorm", d)
        w.normal("mlm_score.decoder.weight", (cfg.vocab_size, d))
        w.normal("mlm_score.bias", (cfg.vocab_size,))
    if "itm_score" in heads:
        w.linear("itm_score.fc", d, 2)
    for kind in ("itc", "itc_vl"):
        if kind in heads:
            w.linear(f"{kind}_text_proj.fc", d, d, bias=False)
            w.linear(f"{kind}_image_proj.fc", d, d, bias=False)
            scale = "logit_scale" if kind == "itc" else "logit_vl_scale"
            w.sd[scale] = torch.tensor(np.float32(np.log(1 / 0.07) + 0.1 * w.rng.standard_normal()))
    for head, (d_in, labels) in (("vqa_classifier", (d, cfg.vqa_label_size)),
                                 ("nlvr2_classifier", (2 * d, 2))):
        if head in heads:
            w.linear(f"{head}.0", d_in, 2 * d)
            w.layernorm(f"{head}.1", 2 * d)
            w.linear(f"{head}.3", 2 * d, labels)
    return w.sd
