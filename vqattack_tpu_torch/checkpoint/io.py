"""Checkpoint files -> the port's parameter trees and modules.

Port of the ingestion helpers of ``vqattack_tpu/checkpoint/io.py``
(``load_albef_pretrain``, ``load_albef_vqa``, ``load_vlmo``,
``load_hf_bert_mlm``): each reads a file, converts it with
``checkpoint/convert.py`` to the flax-layout tree at the geometry of the
given config, and returns the tree, or loads it into ``into`` through
:func:`~vqattack_tpu_torch.checkpoint.convert.load_jax_params` and returns
the module.  The geometry comes from the config: the JAX ``load_vlmo``
converts 12 blocks whatever the model's depth, the port ``cfg.depth``.

``load_hf_bert_mlm`` reads a Hugging Face BERT directory without
``transformers``: ``config.json`` plus ``model.safetensors`` (read by the
small reader below) or ``pytorch_model.bin``, with the renames and the tied
decoder of ``BertForMaskedLM.from_pretrained``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from vqattack_tpu_torch.checkpoint.convert import (
    convert_albef_pretrain,
    convert_albef_vqa,
    convert_fusion_bert,
    convert_vlmo,
    load_jax_params,
    load_torch_checkpoint,
)
from vqattack_tpu_torch.config import ALBEFConfig, VLMoConfig

# VLMo heads a checkpoint may lack: a pre-trained file has no VQA classifier,
# a VQA fine-tuned one has only the pooler and the classifier
# (vlmo_module.py:229-296 builds each head from its task's loss weight)
VLMO_OPTIONAL_HEADS = ("mlm_score", "itm_score", "itc_text_proj", "itc_image_proj",
                       "itc_vl_text_proj", "itc_vl_image_proj", "logit_scale",
                       "logit_vl_scale", "vqa_classifier")
# checkpoint heads the port's VLMo has no module for
VLMO_DROPPED_HEADS = ("nlvr2_classifier",)


def _load(tree: Dict[str, Any], into: Optional[nn.Module], optional=()):
    if into is None:
        return tree
    return load_jax_params(into, tree, optional)


def load_albef_pretrain(path: str, cfg: ALBEFConfig, into: Optional[nn.Module] = None):
    """The ALBEF pre-trained surrogate (``adv_attack.py:83-92``), its
    position grid resized to ``cfg.vit.image_size``."""
    sd = load_torch_checkpoint(path)
    tree = convert_albef_pretrain(sd, cfg.vit.depth, cfg.bert.num_layers,
                                  cfg.bert.fusion_layer, new_num_patches=cfg.vit.num_patches)
    return _load(tree, into)


def load_albef_vqa(path: str, cfg: ALBEFConfig, into: Optional[nn.Module] = None):
    """The ALBEF VQA victim (``adv_attack.py:96-100``), its position grid
    resized to ``cfg.vit.image_size``."""
    sd = load_torch_checkpoint(path)
    tree = convert_albef_vqa(sd, cfg.vit.depth, cfg.bert.num_layers, cfg.bert.fusion_layer,
                             cfg.decoder_layers, new_num_patches=cfg.vit.num_patches)
    return _load(tree, into)


def load_vlmo(path: str, cfg: VLMoConfig, src_image_size: Optional[int] = None,
              into: Optional[nn.Module] = None):
    """A VLMo checkpoint trained at ``src_image_size`` (default: the
    config's), its relative table (or abs-pos grid) resized to
    ``cfg.image_size``.  Loading into a module, the heads of
    :data:`VLMO_OPTIONAL_HEADS` the file lacks keep their values and the
    heads of :data:`VLMO_DROPPED_HEADS` it has are dropped, both named on
    one printed line; every trunk tensor is required."""
    sd = load_torch_checkpoint(path)
    kw = {}
    if src_image_size is not None and src_image_size != cfg.image_size:
        kw = dict(new_window=cfg.image_size // cfg.patch_size,
                  src_window=src_image_size // cfg.patch_size)
    tree = convert_vlmo(sd, depth=cfg.depth, **kw)
    if into is None:
        return tree
    absent = [h for h in VLMO_OPTIONAL_HEADS
              if h not in tree and getattr(into, h, None) is not None]
    dropped = [h for h in VLMO_DROPPED_HEADS if tree.pop(h, None) is not None]
    if absent or dropped:
        print(f"{path}: heads absent from the checkpoint, kept at their initial values: "
              f"{', '.join(absent) or 'none'}; checkpoint heads with no module, dropped: "
              f"{', '.join(dropped) or 'none'}", flush=True)
    return _load(tree, into, absent)


# ---------------------------------------------------------------------------
# Hugging Face BERT directories
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
                       "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as float32 numpy: an 8-byte
    little-endian header length, a JSON header ``{name: {dtype, shape,
    data_offsets}}``, then the data, offsets relative to its start."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(raw)} bytes)")
    n = int.from_bytes(raw[:8], "little")
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes in a file of {len(raw)}")
    header = json.loads(raw[8 : 8 + n])
    data = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if info["dtype"] == "BF16":
            itemsize = 2
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            itemsize = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]]).itemsize
        else:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        if not 0 <= start <= end <= len(data) or end - start != count * itemsize:
            raise ValueError(f"{path}: {name} has offsets {start}..{end} for {shape} of "
                             f"{info['dtype']} in {len(data)} bytes of data")
        buf = data[start:end]
        if info["dtype"] == "BF16":
            # bfloat16 is the top half of a float32
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(buf, _SAFETENSORS_DTYPES[info["dtype"]]).astype(np.float32)
        out[name] = arr.reshape(shape)
    return out


def load_hf_bert_mlm(directory: str, into: Optional[nn.Module] = None):
    """The substitution-candidate MLM (``adv_attack.py:110``): a Hugging Face
    ``BertForMaskedLM`` directory, ``config.json`` and ``model.safetensors``
    (preferred) or ``pytorch_model.bin``, as the text-only ``FusionBert``
    with its MLM head.  ``LayerNorm.gamma``/``beta`` read as ``weight``/
    ``bias`` (the original TF-converted spelling) and the decoder is tied to
    the word embeddings when the file leaves it out, as ``from_pretrained``
    does."""
    with open(os.path.join(directory, "config.json")) as f:
        num_layers = int(json.load(f)["num_hidden_layers"])
    st, pt = (os.path.join(directory, n) for n in ("model.safetensors", "pytorch_model.bin"))
    if os.path.exists(st):
        raw = read_safetensors(st)
    elif os.path.exists(pt):
        raw = {k: v.to(torch.float32).numpy() for k, v in
               torch.load(pt, map_location="cpu", weights_only=True).items()}
    else:
        raise FileNotFoundError(f"{directory}: no model.safetensors or pytorch_model.bin "
                                f"beside config.json")
    sd = {}
    for k, v in raw.items():
        if k.endswith("LayerNorm.gamma"):
            k = k[: -len("gamma")] + "weight"
        elif k.endswith("LayerNorm.beta"):
            k = k[: -len("beta")] + "bias"
        sd[k] = v
    sd.setdefault("cls.predictions.decoder.weight", sd["bert.embeddings.word_embeddings.weight"])
    tree = convert_fusion_bert(sd, prefix="bert.", num_layers=num_layers,
                               fusion_layer=num_layers, mlm_prefix="cls.")
    return _load(tree, into)
