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

The training checkpoints (``save_train_state``, ``find_train_steps``,
``restore_latest_train_state``) keep the JAX package's surface: one
checkpoint a saved step under ``ckpt_dir``, the newest ``keep`` kept, the
newest restored on resume.  Each is one ``torch.save`` file,
``step_{N:08d}.pt``, of the step, the parameters by name and the optimizer
state; JAX's orbax directories are not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vqattack_tpu_torch.checkpoint.convert import (
    convert_albef_pretrain,
    convert_albef_vqa,
    convert_fusion_bert,
    convert_vilt,
    convert_vlmo,
    load_jax_params,
    load_torch_checkpoint,
    widen_token_type_embeddings,
)
from vqattack_tpu_torch.config import ALBEFConfig, VLMoConfig
from vqattack_tpu_torch.train.optim import named_params

# VLMo heads a checkpoint may lack: a pre-trained file has no VQA classifier,
# a VQA fine-tuned one has only the pooler and the classifier
# (vlmo_module.py:229-296 builds each head from its task's loss weight)
VLMO_OPTIONAL_HEADS = ("mlm_score", "itm_score", "itc_text_proj", "itc_image_proj",
                       "itc_vl_text_proj", "itc_vl_image_proj", "logit_scale",
                       "logit_vl_scale", "vqa_classifier", "nlvr2_classifier")
# checkpoint heads dropped where the model has no module for them (a VLMo
# built without ``with_nlvr2_head``)
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
              into: Optional[nn.Module] = None, token_types: Optional[int] = None):
    """A VLMo checkpoint trained at ``src_image_size`` (default: the
    config's), its relative table (or abs-pos grid) resized to
    ``cfg.image_size``.  ``token_types=3``: for ``VLMo(with_nlvr2_head=True)``,
    the modality table widened to 3 rows by the reference's copy of row 1
    (:func:`~vqattack_tpu_torch.checkpoint.convert.widen_token_type_embeddings`),
    and the text embeddings' table to ``cfg.type_vocab_size`` rows in the
    same way (the training CLI's NLVR2 config widens both; text is always
    type 0, so the copied rows are never read).  Loading into a module, the
    heads of :data:`VLMO_OPTIONAL_HEADS` the file lacks keep their values
    and the heads of :data:`VLMO_DROPPED_HEADS` it has and the module lacks
    are dropped, both named on one printed line; every trunk tensor is
    required."""
    sd = load_torch_checkpoint(path)
    kw = {}
    if src_image_size is not None and src_image_size != cfg.image_size:
        kw = dict(new_window=cfg.image_size // cfg.patch_size,
                  src_window=src_image_size // cfg.patch_size)
    tree = convert_vlmo(sd, depth=cfg.depth, **kw)
    if token_types is not None:
        tree = widen_token_type_embeddings(tree, token_types)
        tree["text_embeddings"] = widen_token_type_embeddings(tree["text_embeddings"],
                                                              cfg.type_vocab_size)
    if into is None:
        return tree
    absent = [h for h in VLMO_OPTIONAL_HEADS
              if h not in tree and getattr(into, h, None) is not None]
    dropped = [h for h in VLMO_DROPPED_HEADS
               if getattr(into, h, None) is None and tree.pop(h, None) is not None]
    if absent or dropped:
        print(f"{path}: heads absent from the checkpoint, kept at their initial values: "
              f"{', '.join(absent) or 'none'}; checkpoint heads with no module, dropped: "
              f"{', '.join(dropped) or 'none'}", flush=True)
    return _load(tree, into, absent)


def load_vilt(path: str, cfg: VLMoConfig, into: Optional[nn.Module] = None):
    """A ViLT-B/32 checkpoint (timm trunk names) into the single-stream
    ``VLMo`` of ``cfg`` (``moe=False``), its ``pos_embed`` resized to
    ``cfg.image_size``.  The heads of :data:`VLMO_OPTIONAL_HEADS` the file
    lacks keep their values; every trunk tensor is required."""
    sd = load_torch_checkpoint(path)
    tree = convert_vilt(sd, depth=cfg.depth, new_num_patches=cfg.num_patches)
    if into is None:
        return tree
    tree.pop("nlvr2_classifier", None)
    return _load(tree, into, [h for h in VLMO_OPTIONAL_HEADS if h not in tree])


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


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")


def _to_cpu(tree):
    """Nested dicts of tensors (and plain values) with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_train_state(state, ckpt_dir: str, step: int, keep: int = 3) -> str:
    """Write ``state`` (a ``train/trainer.py::TrainState``) as
    ``{ckpt_dir}/step_{step:08d}.pt`` and delete all but the newest ``keep``
    (the ModelCheckpoint surface, ``run.py:88-94``).  The file is written
    beside its name and renamed into place."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    payload = {"step": int(state.step),
               "params": _to_cpu(named_params(state.model)),
               "opt_state": _to_cpu(state.opt_state)}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for s in sorted(find_train_steps(ckpt_dir))[:-keep]:
        os.remove(_step_path(ckpt_dir, s))
    return path


def find_train_steps(ckpt_dir: str) -> List[int]:
    """The steps saved under ``ckpt_dir`` (none when it does not exist)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in map(_STEP_FILE.fullmatch, os.listdir(ckpt_dir)) if m]


def restore_latest_train_state(ckpt_dir: str, like):
    """The newest saved step loaded into ``like``'s module (in place) and
    returned as a state like ``like``, or None when nothing is saved
    (``resume_during_training``, ``run.py:118-124``).  Raises when the file's
    parameters or optimizer state do not match ``like``'s names and shapes."""
    steps = sorted(find_train_steps(ckpt_dir))
    if not steps:
        return None
    path = _step_path(ckpt_dir, steps[-1])
    saved = torch.load(path, map_location="cpu", weights_only=True)
    params = named_params(like.model)
    if set(saved["params"]) != set(params):
        raise KeyError(f"{path}: parameters {sorted(set(saved['params']) ^ set(params))[:8]} "
                       f"are in only one of the file and the model")
    with torch.no_grad():
        for name, p in params.items():
            if saved["params"][name].shape != p.shape:
                raise ValueError(f"{path}: {name} {tuple(saved['params'][name].shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(saved["params"][name])

    def place(saved_t, like_t, where):
        if isinstance(like_t, dict):
            if not isinstance(saved_t, dict) or set(saved_t) != set(like_t):
                raise KeyError(f"{path}: optimizer state {where} does not match the model's")
            return {k: place(saved_t[k], like_t[k], f"{where}/{k}") for k in like_t}
        if isinstance(like_t, torch.Tensor):
            if saved_t.shape != like_t.shape:
                raise ValueError(f"{path}: optimizer state {where} {tuple(saved_t.shape)} vs "
                                 f"{tuple(like_t.shape)}")
            return saved_t.to(device=like_t.device, dtype=like_t.dtype)
        return saved_t

    opt_state = place(saved["opt_state"], like.opt_state, "")
    return dataclasses.replace(like, step=int(saved["step"]), opt_state=opt_state)
