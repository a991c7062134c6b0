"""The attack's image transform: decode -> resize -> normalize.

Port of ``test_transform`` of ``vqattack_tpu/data/transforms.py`` (reference
``dataset/__init__.py:35-39``): Resize((480, 480), bicubic) + ToTensor +
Normalize(mean=std=0.5), pixels in [-1, 1], CHW float32 (the reference
layout).  PIL is imported only inside the function that decodes, so the
package imports without it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

MEAN = 0.5
STD = 0.5


def inception_normalize(x: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (mean = std = 0.5)."""
    return (x.astype(np.float32) / 255.0 - MEAN) / STD


def test_transform(size: int = 480) -> Callable:
    """PIL image -> ``[3, size, size]`` float32 in [-1, 1]."""

    def fn(img) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB").resize((size, size), Image.BICUBIC)
        return inception_normalize(np.asarray(img)).transpose(2, 0, 1)

    return fn
