"""Image preprocessing on the device: bicubic resize and normalisation.

Port of ``vqattack_tpu/data/device_transforms.py``.  The host decodes JPEG
bytes to uint8 only; the resize runs on the batch's device as two dense
products with a separable filter (``out = W_h @ img @ W_w^T``), so uint8
(a quarter of float32's bytes) crosses to the card.  The weights are PIL's
BICUBIC filter (Keys cubic, a = -0.5, half-pixel centres, the support
widened on a downsample), the filter behind the reference's
``transforms.Resize(..., Image.BICUBIC)``.  The products are plain
``torch.matmul``: no Pallas kernel stands behind the JAX function.  They
run in full float32 as long as TF32 stays off (``device.resolve_device``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _pil_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax < 1,
        (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` PIL-parity bicubic resampling matrix (antialiased)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        js = np.arange(lo, hi)
        weights = _pil_cubic((js + 0.5 - center) / filterscale)
        s = weights.sum()
        if s != 0:
            w[i, lo:hi] = weights / s
    return w


def device_preprocess(raw: torch.Tensor, out_size: int = 480) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> normalised float32 ``[B, 3, out, out]``
    (NCHW, the port's layout), in [-1, 1], on ``raw.device``: the rows'
    product, then the columns', as the JAX function sums them."""
    _, h, w, _ = raw.shape
    wh = torch.from_numpy(resize_matrix(h, out_size)).to(raw.device)
    ww = torch.from_numpy(resize_matrix(w, out_size)).to(raw.device)
    x = raw.permute(0, 3, 1, 2).float()  # [B, 3, H, W]
    x = torch.matmul(wh, x)               # [B, 3, out, W]
    x = torch.matmul(x, ww.t())           # [B, 3, out, out]
    x = torch.clamp(x, 0.0, 255.0)
    return (x / 255.0 - 0.5) / 0.5
