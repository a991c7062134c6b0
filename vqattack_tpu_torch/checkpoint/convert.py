"""Load a JAX (flax) parameter tree into the port's modules.

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
``AlbefVQA``, the candidate-MLM ``FusionBert`` and ``VLMo`` (the tree of
its ``init_all``: both experts of the VL layers, the ITC projections, both
logit scales, ``itm_score``, with nothing left over).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy every parameter of ``module`` from the flax ``tree``.  Raises if a
    parameter has no leaf, a shape differs, or a leaf is left unused."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    used = set()
    for mod_name, sub in module.named_modules():
        mod_path = mod_name.split(".") if mod_name else []
        for pname, param in sub.named_parameters(recurse=False):
            leaf, transform = _leaf_for(sub, pname, param)
            path = tuple(_flax_path(mod_path) + [leaf])
            node: Any = tree
            for p in path:
                if not isinstance(node, dict) or p not in node:
                    raise KeyError(f"no flax leaf {'/'.join(path)} for "
                                   f"{mod_name + '.' if mod_name else ''}{pname}")
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
