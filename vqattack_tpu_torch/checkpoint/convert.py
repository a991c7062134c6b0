"""Checkpoints into the port's modules: the reference's ``.pth`` files
converted to flax-layout trees, and any flax tree loaded into a module.

The converters (``load_torch_checkpoint``, ``convert_vit``,
``convert_fusion_bert``, ``convert_albef_pretrain``, ``convert_albef_vqa``,
``convert_vlmo``, ``resize_vlmo_rel_pos_table``,
``widen_token_type_embeddings``) are a copy of
``vqattack_tpu/checkpoint/convert.py``: key surgery from the reference's
torch names to the flax tree of the JAX package (timm's fused qkv split in
thirds), numpy in and out.  :func:`load_jax_params` is the one place that
writes a tree into a module, with its checks.

The port's sub-module names follow the flax module names, so each torch
parameter has one flax leaf: ``visual_encoder.blocks.3.attn.query.weight``
is ``visual_encoder/blocks_3/attn/query/kernel``.  The leaf changes with the
layer type:

- ``nn.Linear``: ``weight`` = ``kernel`` transposed (flax keeps ``[in, out]``);
- ``nn.Conv2d``: ``weight`` [O, I, kh, kw] = ``kernel`` [kh, kw, I, O] (HWIO);
- ``nn.LayerNorm`` and ``ResidualLayerNorm``: ``weight`` = ``scale``;
- ``nn.Embedding``: ``weight`` = ``embedding``;
- ``bias`` and bare parameters (``cls_token``, ``pos_embed``, ``temp``;
  VLMo's ``gamma_1``/``gamma_2``, ``relative_position_bias_table`` and the
  0-d ``logit_scale/scale``) keep their names.

The tree is nested dicts of numpy arrays (``jax.device_get`` of a flax
``variables`` or ``variables["params"]``).  Works for ``AlbefPretrain``,
``AlbefVQA``, the task models of ``models/albef_tasks.py``, the
candidate-MLM ``FusionBert`` and ``VLMo`` (the tree of its ``init_all``:
both experts of the VL layers, the ITC projections, both logit scales,
``itm_score``, NLVR2's head where the model has it, with nothing left
over).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vqattack_tpu_torch.models.layers import ResidualLayerNorm


def _flax_path(module_path: List[str]) -> List[str]:
    """``["blocks", "3", "attn"]`` -> ``["blocks_3", "attn"]``."""
    out: List[str] = []
    for part in module_path:
        if part.isdigit() and out:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return out


def _leaf_for(module: nn.Module, pname: str, value: torch.Tensor) -> Tuple[str, Any]:
    """(flax leaf name, numpy -> torch layout transform) of one parameter."""
    if pname == "weight":
        if isinstance(module, nn.Linear):
            return "kernel", lambda a: a.T
        if isinstance(module, nn.Conv2d):
            return "kernel", lambda a: a.transpose(3, 2, 0, 1)
        if isinstance(module, (nn.LayerNorm, ResidualLayerNorm)):
            return "scale", lambda a: a
        if isinstance(module, nn.Embedding):
            return "embedding", lambda a: a
        raise TypeError(f"no flax leaf for the weight of {type(module).__name__}")
    return pname, lambda a: a


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def flax_leaves(module: nn.Module):
    """``(torch name, flax path, numpy -> torch layout transform, parameter)``
    for every parameter of ``module``, in ``named_parameters`` order."""
    for mod_name, sub in module.named_modules():
        mod_path = mod_name.split(".") if mod_name else []
        for pname, param in sub.named_parameters(recurse=False):
            leaf, transform = _leaf_for(sub, pname, param)
            name = f"{mod_name}.{pname}" if mod_name else pname
            yield name, tuple(_flax_path(mod_path) + [leaf]), transform, param


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Dict[str, Any],
                    optional: Sequence[str] = ()) -> nn.Module:
    """Copy every parameter of ``module`` from the flax ``tree``.  Raises if a
    parameter has no leaf, a shape differs, or a leaf is left unused.  The
    parameters under the top-level names in ``optional`` (heads a checkpoint
    may lack) are left as they are when the tree has no leaf for them."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    used = set()
    for name, path, transform, param in flax_leaves(module):
        if path[0] in optional and path[0] not in tree:
            continue
        node: Any = tree
        for p in path:
            if not isinstance(node, dict) or p not in node:
                raise KeyError(f"no flax leaf {'/'.join(path)} for {name}")
            node = node[p]
        arr = np.array(transform(np.asarray(node)), order="C")
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: flax {arr.shape} vs torch "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(arr).to(param.dtype))
        used.add(path)
    unused = [p for p in _leaves(tree) if p not in used]
    if unused:
        raise KeyError(f"flax leaves with no torch parameter: "
                       f"{['/'.join(p) for p in unused[:8]]}")
    return module


@torch.no_grad()
def graft_jax_params(module: nn.Module, tree: Dict[str, Any]) -> int:
    """Copy the parameters of ``module`` that the flax ``tree`` has a leaf
    for and leave the others as they are: a pre-trained file's shared trunks
    into a task model whose heads stay at their initial values (the JAX
    training CLI's ``--init-ckpt`` merge).  Leaves with no parameter are
    skipped; a leaf of another shape raises.  Returns the number copied."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    copied = 0
    for name, path, transform, param in flax_leaves(module):
        node: Any = tree
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
        if node is None or isinstance(node, dict):
            continue
        arr = np.array(transform(np.asarray(node)), order="C")
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: flax {arr.shape} vs torch "
                             f"{tuple(param.shape)} ({name})")
        param.copy_(torch.from_numpy(arr).to(param.dtype))
        copied += 1
    return copied


# ---------------------------------------------------------------------------
# the reference's torch checkpoints -> flax trees
# ---------------------------------------------------------------------------


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth/.pt checkpoint into a flat {name: float32 np.ndarray} dict.

    Handles the reference's envelopes (``vlmo_module.py:307-319``):
    ``{'model': sd}``, ``{'state_dict': sd}``, ``{'module': sd}`` or a bare
    state dict; strips deepspeed ``module.`` prefixes
    (``vlmo_module.py:115-125``).  The envelopes carry non-tensor objects
    (ALBEF's config and optimizer, Lightning's hyper-parameters), so the file
    is unpickled in full: load only checkpoints from a source you trust.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "module"):
        if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        if not isinstance(v, torch.Tensor):
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().to(torch.float32).numpy()
    return out


def _linear(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _linear_nobias(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].T}


def _layernorm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _embedding(sd, prefix):
    return {"embedding": sd[f"{prefix}.weight"]}


def _conv(sd, prefix):
    out = {"kernel": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _split_qkv(sd, prefix):
    """timm fused qkv -> separate query/key/value Dense params."""
    w = sd[f"{prefix}.weight"]  # [3D, D]
    d = w.shape[0] // 3
    out = {"query": {"kernel": w[:d].T}, "key": {"kernel": w[d : 2 * d].T},
           "value": {"kernel": w[2 * d :].T}}
    if f"{prefix}.bias" in sd:
        b = sd[f"{prefix}.bias"]
        out["query"]["bias"] = b[:d]
        out["key"]["bias"] = b[d : 2 * d]
        out["value"]["bias"] = b[2 * d :]
    return out


def _classifier(sd, prefix):
    """``Sequential(0: dense, 1: LayerNorm, 2: GELU, 3: dense)``."""
    return {"fc1": _linear(sd, f"{prefix}.0"), "norm": _layernorm(sd, f"{prefix}.1"),
            "fc2": _linear(sd, f"{prefix}.3")}


def convert_vit(sd: Dict[str, np.ndarray], prefix: str = "", depth: int = 12,
                new_num_patches: Optional[int] = None) -> Dict[str, Any]:
    """``{prefix}cls_token / pos_embed / patch_embed.proj / blocks.N.*`` (timm
    and DeiT names, ``models/vit.py``) -> the ViT tree, the position grid
    resized to ``new_num_patches``."""
    from vqattack_tpu_torch.checkpoint.interpolate import interpolate_pos_embed

    p = prefix
    pos = sd[f"{p}pos_embed"]
    if new_num_patches is not None:
        pos = interpolate_pos_embed(pos, new_num_patches)
    tree: Dict[str, Any] = {
        "cls_token": sd[f"{p}cls_token"],
        "pos_embed": pos,
        "patch_embed": {"proj": _conv(sd, f"{p}patch_embed.proj")},
        "norm": _layernorm(sd, f"{p}norm"),
    }
    for i in range(depth):
        bp = f"{p}blocks.{i}"
        attn = _split_qkv(sd, f"{bp}.attn.qkv")
        attn["proj"] = _linear(sd, f"{bp}.attn.proj")
        tree[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{bp}.norm1"),
            "attn": attn,
            "norm2": _layernorm(sd, f"{bp}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{bp}.mlp.fc1"), "fc2": _linear(sd, f"{bp}.mlp.fc2")},
        }
    return tree


def convert_fusion_bert(sd: Dict[str, np.ndarray], prefix: str = "bert.",
                        num_layers: int = 12, fusion_layer: int = 6,
                        mlm_prefix: Optional[str] = None) -> Dict[str, Any]:
    """HF-style ``{prefix}embeddings.* / encoder.layer.N.*`` (and optionally
    ``{mlm_prefix}predictions.*``) -> the fusion-BERT tree (``models/xbert.py``);
    cross-attention from ``fusion_layer`` where the checkpoint has it."""
    p = prefix
    tree: Dict[str, Any] = {"embeddings": {
        "word_embeddings": _embedding(sd, f"{p}embeddings.word_embeddings"),
        "position_embeddings": _embedding(sd, f"{p}embeddings.position_embeddings"),
        "token_type_embeddings": _embedding(sd, f"{p}embeddings.token_type_embeddings"),
        "LayerNorm": _layernorm(sd, f"{p}embeddings.LayerNorm"),
    }}
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}"
        layer: Dict[str, Any] = {
            "attention_self": {name: _linear(sd, f"{lp}.attention.self.{name}")
                               for name in ("query", "key", "value")},
            "attention_output": {"dense": _linear(sd, f"{lp}.attention.output.dense"),
                                 "LayerNorm": _layernorm(sd, f"{lp}.attention.output.LayerNorm")},
            "intermediate_dense": _linear(sd, f"{lp}.intermediate.dense"),
            "output_dense": _linear(sd, f"{lp}.output.dense"),
            "output_LayerNorm": _layernorm(sd, f"{lp}.output.LayerNorm"),
        }
        if i >= fusion_layer and f"{lp}.crossattention.self.query.weight" in sd:
            layer["crossattention_self"] = {
                name: _linear(sd, f"{lp}.crossattention.self.{name}")
                for name in ("query", "key", "value")}
            layer["crossattention_output"] = {
                "dense": _linear(sd, f"{lp}.crossattention.output.dense"),
                "LayerNorm": _layernorm(sd, f"{lp}.crossattention.output.LayerNorm")}
        tree[f"layer_{i}"] = layer
    if mlm_prefix is not None:
        mp = mlm_prefix
        decoder = {"kernel": sd[f"{mp}predictions.decoder.weight"].T}
        if f"{mp}predictions.decoder.bias" in sd:
            decoder["bias"] = sd[f"{mp}predictions.decoder.bias"]
        else:
            decoder["bias"] = sd[f"{mp}predictions.bias"]
        tree["mlm_head"] = {
            "transform_dense": _linear(sd, f"{mp}predictions.transform.dense"),
            "transform_LayerNorm": _layernorm(sd, f"{mp}predictions.transform.LayerNorm"),
            "decoder": decoder,
        }
    return tree


def convert_albef_pretrain(sd: Dict[str, np.ndarray], depth: int = 12, num_layers: int = 12,
                           fusion_layer: int = 6,
                           new_num_patches: Optional[int] = None) -> Dict[str, Any]:
    """ALBEF pre-trained checkpoint (``model_pretrain.py``) -> the
    ``AlbefPretrain`` tree.  The momentum copies (``*_m``) and the feature
    queues are left out: the attack differentiates the online model only."""
    tree = {
        "visual_encoder": convert_vit(sd, "visual_encoder.", depth,
                                      new_num_patches=new_num_patches),
        "text_encoder": convert_fusion_bert(sd, "text_encoder.bert.", num_layers, fusion_layer,
                                            mlm_prefix="text_encoder.cls."),
        "vision_proj": _linear(sd, "vision_proj"),
        "text_proj": _linear(sd, "text_proj"),
        "itm_head": _linear(sd, "itm_head"),
    }
    if "temp" in sd:
        tree["temp"] = np.asarray(sd["temp"]).reshape(())
    return tree


def convert_albef_vqa(sd: Dict[str, np.ndarray], depth: int = 12, num_layers: int = 12,
                      fusion_layer: int = 6, decoder_layers: int = 6,
                      new_num_patches: Optional[int] = None) -> Dict[str, Any]:
    """ALBEF VQA checkpoint (``model_vqa.py``) -> the ``AlbefVQA`` tree.  The
    question encoder is a ``BertModel`` (``text_encoder.*``) in the
    reference's files and a masked-LM's ``text_encoder.bert.*`` in some."""
    enc = ("text_encoder.bert." if "text_encoder.bert.embeddings.word_embeddings.weight" in sd
           else "text_encoder.")
    return {
        "visual_encoder": convert_vit(sd, "visual_encoder.", depth,
                                      new_num_patches=new_num_patches),
        "text_encoder": convert_fusion_bert(sd, enc, num_layers, fusion_layer),
        "text_decoder": convert_fusion_bert(sd, "text_decoder.bert.", decoder_layers,
                                            fusion_layer=0, mlm_prefix="text_decoder.cls."),
    }


def convert_vlmo(sd: Dict[str, np.ndarray], depth: int = 12, new_window: Optional[int] = None,
                 src_window: Optional[int] = None) -> Dict[str, Any]:
    """VLMo checkpoint (``vlmo_base_patch16_*.pt``) -> the ``VLMo`` tree.

    The ``transformer.*`` trunk has a fused ``attn.qkv.weight`` without bias
    and separate ``attn.q_bias``/``v_bias`` (``multiway_transformer.py:75-93``);
    HF ``text_embeddings.*``; the modality ``token_type_embeddings``; one
    fused ``relative_position_bias_table``; the heads each where the file has
    them (``pooler``, ``mlm_score``, ``itm_score``, ``itc_*_proj``, the logit
    scales, ``vqa_classifier.{0,1,3}``, ``nlvr2_classifier``).
    ``new_window``/``src_window``: the 224 -> 480 resize of the relative
    table, or of ``pos_embed`` in the abs-pos models
    (``vlmo_module.py:615-619, 735-804``).
    """
    p = "transformer."
    resize = new_window is not None and src_window is not None and new_window != src_window
    tree: Dict[str, Any] = {
        "cls_token": sd[f"{p}cls_token"],
        "patch_embed": {"proj": _conv(sd, f"{p}patch_embed.proj")},
        "norm": _layernorm(sd, f"{p}norm"),
        "text_embeddings": {
            "word_embeddings": _embedding(sd, "text_embeddings.word_embeddings"),
            "position_embeddings": _embedding(sd, "text_embeddings.position_embeddings"),
            "token_type_embeddings": _embedding(sd, "text_embeddings.token_type_embeddings"),
            "LayerNorm": _layernorm(sd, "text_embeddings.LayerNorm"),
        },
        "token_type_embeddings": _embedding(sd, "token_type_embeddings"),
        "pooler": {"dense": _linear(sd, "pooler.dense")},
    }
    if f"{p}pos_embed" in sd:
        pos = sd[f"{p}pos_embed"]
        if resize:
            from vqattack_tpu_torch.checkpoint.interpolate import interpolate_pos_embed

            pos = interpolate_pos_embed(pos, new_window ** 2)
        tree["pos_embed"] = pos
    if "relative_position_bias_table" in sd:
        tbl = sd["relative_position_bias_table"]
        if resize:
            tbl = resize_vlmo_rel_pos_table(tbl, src_window, new_window)
        tree["relative_position_bias_table"] = tbl

    for i in range(depth):
        bp = f"{p}blocks.{i}"
        w = sd[f"{bp}.attn.qkv.weight"]
        d = w.shape[0] // 3
        layer: Dict[str, Any] = {
            "norm1": _layernorm(sd, f"{bp}.norm1"),
            "attn": {
                "query": {"kernel": w[:d].T, "bias": sd[f"{bp}.attn.q_bias"]},
                "key": {"kernel": w[d : 2 * d].T},
                "value": {"kernel": w[2 * d :].T, "bias": sd[f"{bp}.attn.v_bias"]},
                "proj": _linear(sd, f"{bp}.attn.proj"),
            },
        }
        for expert in ("text", "imag"):
            layer[f"norm2_{expert}"] = _layernorm(sd, f"{bp}.norm2_{expert}")
            layer[f"mlp_{expert}"] = {"fc1": _linear(sd, f"{bp}.mlp_{expert}.fc1"),
                                      "fc2": _linear(sd, f"{bp}.mlp_{expert}.fc2")}
        if f"{bp}.gamma_1" in sd:
            layer["gamma_1"] = sd[f"{bp}.gamma_1"]
            layer["gamma_2"] = sd[f"{bp}.gamma_2"]
        if f"{bp}.mlp_vl.fc1.weight" in sd:
            layer["norm2_vl"] = _layernorm(sd, f"{bp}.norm2_vl")
            layer["mlp_vl"] = {"fc1": _linear(sd, f"{bp}.mlp_vl.fc1"),
                               "fc2": _linear(sd, f"{bp}.mlp_vl.fc2")}
        tree[f"blocks_{i}"] = layer

    if "mlm_score.transform.dense.weight" in sd:
        tree["mlm_score"] = {
            "transform_dense": _linear(sd, "mlm_score.transform.dense"),
            "transform_LayerNorm": _layernorm(sd, "mlm_score.transform.LayerNorm"),
            "decoder": {"kernel": sd["mlm_score.decoder.weight"].T, "bias": sd["mlm_score.bias"]},
        }
    if "itm_score.fc.weight" in sd:
        tree["itm_score"] = _linear(sd, "itm_score.fc")
    # the ITC heads, and the VL-expert branch's (vlmo_module.py:247-253)
    for head in ("itc_text_proj", "itc_image_proj", "itc_vl_text_proj", "itc_vl_image_proj"):
        if f"{head}.fc.weight" in sd:
            tree[head] = _linear_nobias(sd, f"{head}.fc")
    for scale in ("logit_scale", "logit_vl_scale"):
        if scale in sd:
            tree[scale] = {"scale": np.asarray(sd[scale]).reshape(())}
    for head in ("vqa_classifier", "nlvr2_classifier"):
        if f"{head}.0.weight" in sd:
            tree[head] = _classifier(sd, head)
    return tree


def convert_vilt(sd: Dict[str, np.ndarray], depth: int = 12,
                 new_num_patches: Optional[int] = None) -> Dict[str, Any]:
    """ViLT-B/32 checkpoint -> the single-stream (``moe=False``) ``VLMo``
    tree (the JAX package's ``convert_vilt``).

    ViLT's blocks are timm's: a fused ``attn.qkv`` with a full bias, one
    ``norm2`` + ``mlp``.  The key's third of the bias is dropped: adding a
    constant to every key shifts each query's logits alike, which the
    softmax cancels (the identity VLMo's decomposed bias rests on,
    ``multiway_transformer.py:75-93``).  ``new_num_patches``: ``pos_embed``
    resized to that grid (:func:`interpolate_pos_embed`).
    """
    p = "transformer."
    pos = sd[f"{p}pos_embed"]
    if new_num_patches is not None:
        from vqattack_tpu_torch.checkpoint.interpolate import interpolate_pos_embed

        pos = interpolate_pos_embed(pos, new_num_patches)
    tree: Dict[str, Any] = {
        "cls_token": sd[f"{p}cls_token"],
        "pos_embed": pos,
        "patch_embed": {"proj": _conv(sd, f"{p}patch_embed.proj")},
        "norm": _layernorm(sd, f"{p}norm"),
        "text_embeddings": {
            "word_embeddings": _embedding(sd, "text_embeddings.word_embeddings"),
            "position_embeddings": _embedding(sd, "text_embeddings.position_embeddings"),
            "token_type_embeddings": _embedding(sd, "text_embeddings.token_type_embeddings"),
            "LayerNorm": _layernorm(sd, "text_embeddings.LayerNorm"),
        },
        "token_type_embeddings": _embedding(sd, "token_type_embeddings"),
        "pooler": {"dense": _linear(sd, "pooler.dense")},
    }
    for i in range(depth):
        bp = f"{p}blocks.{i}"
        w = sd[f"{bp}.attn.qkv.weight"]
        d = w.shape[0] // 3
        b = sd.get(f"{bp}.attn.qkv.bias")
        attn: Dict[str, Any] = {
            "query": {"kernel": w[:d].T},
            "key": {"kernel": w[d : 2 * d].T},
            "value": {"kernel": w[2 * d :].T},
            "proj": _linear(sd, f"{bp}.attn.proj"),
        }
        if b is not None:
            attn["query"]["bias"] = b[:d]
            attn["value"]["bias"] = b[2 * d :]
        tree[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{bp}.norm1"),
            "attn": attn,
            "norm2": _layernorm(sd, f"{bp}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{bp}.mlp.fc1"), "fc2": _linear(sd, f"{bp}.mlp.fc2")},
        }
    if "mlm_score.transform.dense.weight" in sd:
        tree["mlm_score"] = {
            "transform_dense": _linear(sd, "mlm_score.transform.dense"),
            "transform_LayerNorm": _layernorm(sd, "mlm_score.transform.LayerNorm"),
            "decoder": {"kernel": sd["mlm_score.decoder.weight"].T, "bias": sd["mlm_score.bias"]},
        }
    if "itm_score.fc.weight" in sd:
        tree["itm_score"] = _linear(sd, "itm_score.fc")
    for head in ("vqa_classifier", "nlvr2_classifier"):
        if f"{head}.0.weight" in sd:
            tree[head] = _classifier(sd, head)
    return tree


def widen_token_type_embeddings(tree: Dict[str, Any], n_types: int = 3) -> Dict[str, Any]:
    """NLVR2's load surgery: the modality token-type table widened to
    ``n_types`` rows, each new row a copy of row 1 (the image row), as the
    reference widens a 2-row checkpoint for its 3-row NLVR2 model
    (``vlmo_module.py:291-296``).  A table of ``n_types`` rows or more is
    left as it is.  Returns a shallow copy of ``tree``."""
    out = dict(tree)
    emb = np.asarray(out["token_type_embeddings"]["embedding"])
    if emb.shape[0] >= n_types:
        return out
    pad = np.broadcast_to(emb[1:2], (n_types - emb.shape[0], emb.shape[1]))
    out["token_type_embeddings"] = {"embedding": np.concatenate([emb, pad])}
    return out


def resize_vlmo_rel_pos_table(table: np.ndarray, src_window: int,
                              dst_window: int) -> np.ndarray:
    """Resize the fused VLMo table: only the image-window block ((2w-1)^2
    rows) resizes; the 3 image specials, the text distances and the 2 cross
    constants after it pass through (``vlmo_module.py:741-804``)."""
    from vqattack_tpu_torch.checkpoint.interpolate import interpolate_rel_pos_bias

    return interpolate_rel_pos_bias(table, 2 * src_window - 1, 2 * dst_window - 1)
