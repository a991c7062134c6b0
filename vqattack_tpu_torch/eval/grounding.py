"""RefCOCO visual-grounding evaluation: the REFER loader and the weakly
supervised box accuracy.

Port of ``vqattack_tpu/eval/grounding.py`` (the reference's
``refTools/refer_python3.py`` members that ``Grounding.py`` touches, and
``dataset/utils.py:149-213``'s ``grounding_eval``/``computeIoU``).  Heat maps
come from the Grad-CAM probe (``utils/gradcam.py``).

The mask's upsample is ``jax.image.resize(..., "bicubic")`` of the JAX
package, which is not ``F.interpolate(mode="bicubic")``: JAX takes Keys'
cubic with a = -0.5 at half-pixel centres, drops the taps outside the image
and renormalises the rest, and widens the kernel to antialias where it
downsamples; PyTorch takes a = -0.75 and replicates the border.  The port
builds JAX's weights per axis on the host (:func:`bicubic_weights`) and
runs ``Wh @ m @ Ww^T`` as two products on the mask's device.

Data layout (the UNC RefCOCO distribution): ``{root}/{dataset}/`` holding
``refs({splitBy}).p`` (a pickled list of ref dicts) and ``instances.json``
(COCO-style images/annotations/categories).  A ``.json`` refs file with the
same records is accepted too.
"""

from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch


class Refer:
    """Minimal REFER api (``refer_python3.py:39-140``)."""

    def __init__(self, data_root: str, dataset: str = "refcoco+", split_by: str = "unc"):
        data_dir = os.path.join(data_root, dataset)
        refs_p = os.path.join(data_dir, f"refs({split_by}).p")
        if os.path.exists(refs_p):
            with open(refs_p, "rb") as f:
                refs = pickle.load(f)
        else:
            with open(os.path.join(data_dir, f"refs({split_by}).json")) as f:
                refs = json.load(f)
        with open(os.path.join(data_dir, "instances.json")) as f:
            instances = json.load(f)

        self.Anns: Dict[Any, dict] = {a["id"]: a for a in instances["annotations"]}
        self.Imgs: Dict[Any, dict] = {i["id"]: i for i in instances["images"]}
        self.Cats: Dict[Any, str] = {c["id"]: c["name"] for c in instances.get("categories", [])}
        self.Refs: Dict[Any, dict] = {}
        self.refToAnn: Dict[Any, dict] = {}
        self.imgToRefs: Dict[Any, List[dict]] = defaultdict(list)
        for ref in refs:
            self.Refs[ref["ref_id"]] = ref
            self.refToAnn[ref["ref_id"]] = self.Anns[ref["ann_id"]]
            self.imgToRefs[ref["image_id"]].append(ref)

    def getRefIds(self, split: str = "") -> List[Any]:
        return [rid for rid, ref in self.Refs.items() if not split or ref.get("split") == split]

    def getRefBox(self, ref_id) -> List[float]:
        return self.refToAnn[ref_id]["bbox"]


def compute_iou(box1: Sequence[float], box2: Sequence[float]) -> float:
    """[x, y, w, h] IoU with the reference's inclusive-pixel convention
    (``dataset/utils.py:200-213``)."""
    inter_x1 = max(box1[0], box2[0])
    inter_y1 = max(box1[1], box2[1])
    inter_x2 = min(box1[0] + box1[2] - 1, box2[0] + box2[2] - 1)
    inter_y2 = min(box1[1] + box1[3] - 1, box2[1] + box2[3] - 1)
    if inter_x1 < inter_x2 and inter_y1 < inter_y2:
        inter = (inter_x2 - inter_x1 + 1) * (inter_y2 - inter_y1 + 1)
    else:
        inter = 0
    union = box1[2] * box1[3] + box2[2] * box2[3] - inter
    return float(inter) / union


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, for ``x >= 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[out_size, in_size]`` float64 weights of ``jax.image.resize``'s
    bicubic along one axis (``jax/_src/image/scale.py::compute_weight_mat``):
    half-pixel centres; the kernel widened by ``in/out`` where the axis
    shrinks (antialias); each output's taps renormalised to sum to 1 (zero
    where they sum to next to nothing); outputs whose centre falls outside
    the input zero.  An axis that keeps its size is the identity, as JAX
    skips it."""
    if in_size == out_size:
        return np.eye(out_size)
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def _upsample_bicubic(mask, height: int, width: int) -> torch.Tensor:
    """``[h, w]`` mask (an array, or a tensor on any device) -> ``[height,
    width]`` float32 on the mask's device, as ``jax.image.resize(mask,
    (height, width), "bicubic")``: ``Wh @ mask @ Ww^T``."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    wh, ww = (torch.as_tensor(bicubic_weights(n, size), dtype=torch.float32, device=m.device)
              for n, size in ((m.shape[0], height), (m.shape[1], width)))
    return wh @ (m @ ww.T)


def grounding_accuracy(
    results: Sequence[Mapping[str, Any]],
    dets: Mapping[str, Sequence[Sequence[float]]],
    refer: Refer,
    alpha: float = 0.5,
    mask_size: int = 24,
) -> Dict[str, float]:
    """Weakly supervised grounding accuracy (``dataset/utils.py:149-195``).

    ``results`` rows are ``{"ref_id", "pred"}``, ``pred`` a ``[mask_size,
    mask_size]`` Grad-CAM map (an array, or a tensor on the card);
    ``dets`` maps ``str(image_id)`` to candidate ``[x, y, w, h(,
    score...)]`` boxes.  Each map is upsampled to its image where it lies
    (:func:`_upsample_bicubic`), each box scored on the host by the mask's
    sum over it over ``area**alpha``, and the best box counted correct when
    its IoU with the ref box is at least 0.5.  Returns ``{"val_d",
    "testA_d", "testB_d"}``, splits with no refs left out."""
    correct = {"val": 0, "testA": 0, "testB": 0}
    num = {"val": 0, "testA": 0, "testB": 0}
    for res in results:
        ref = refer.Refs[res["ref_id"]]
        ref_box = refer.getRefBox(res["ref_id"])
        image = refer.Imgs[ref["image_id"]]
        pred = torch.as_tensor(res["pred"]).reshape(mask_size, mask_size)
        mask = _upsample_bicubic(pred, image["height"], image["width"]).cpu().numpy()
        max_score, pred_box = 0.0, None
        for det in dets[str(ref["image_id"])]:
            # the reference's slice bounds: int(y):int(y+h), int(x):int(x+w)
            # (int(y+h) != int(y)+int(h) for fractional boxes)
            score = float(
                mask[int(det[1]):int(det[1] + det[3]), int(det[0]):int(det[0] + det[2])].sum()
            ) / (det[2] * det[3]) ** alpha
            if score > max_score:
                max_score, pred_box = score, det[:4]
        split = ref.get("split")
        if split in num:
            num[split] += 1
            if pred_box is not None and compute_iou(ref_box, pred_box) >= 0.5:
                correct[split] += 1
    return {f"{split}_d": correct[split] / num[split]
            for split in ("val", "testA", "testB") if num[split]}
