"""Image transforms: decode -> (augment) -> resize -> normalize.

Port of ``test_transform``, ``train_transform`` and ``RandomAugment`` of
``vqattack_tpu/data/transforms.py``.  The test transform is the reference's
Resize((480, 480), bicubic) + ToTensor + Normalize(mean=std=0.5)
(``dataset/__init__.py:35-39``); the train transform adds a random resized
crop, a horizontal flip and RandAugment (``dataset/__init__.py:18-34``,
``dataset/randaugment.py``).  Pixels come out in [-1, 1], CHW float32 (the
reference layout).  PIL is imported only inside the functions that touch an
image, so the package imports without it.  The random draws are
``random.Random``'s in the JAX package's order, so one seed gives both
packages the same crops and ops.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

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


# ---------------------------------------------------------------------------
# RandAugment (the train path), the ops of the vendored randaugment.py at
# its level_to_args magnitudes for MAX_LEVEL = 10: enhance factor
# (m/10) 1.8 + 0.1, shear (m/10) 0.3, translate (m/10) 10 pixels, rotate
# (m/10) 30 degrees, solarize threshold (m/10) 256, posterize (m/10) 4 bits;
# geometric signs are drawn by the caller
# ---------------------------------------------------------------------------


def _op(name: str, img, v: float):
    from PIL import Image, ImageEnhance, ImageOps

    if name == "Identity":
        return img
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    if name == "Rotate":
        return img.rotate(v * 30)
    if name == "Solarize":
        return ImageOps.solarize(img, int(abs(v) * 256))
    if name == "Posterize":
        return ImageOps.posterize(img, max(1, int(abs(v) * 4)))
    enhance = {"Contrast": ImageEnhance.Contrast, "Color": ImageEnhance.Color,
               "Brightness": ImageEnhance.Brightness, "Sharpness": ImageEnhance.Sharpness}
    if name in enhance:
        return enhance[name](img).enhance(abs(v) * 1.8 + 0.1)
    affine = {"ShearX": (1, v * 0.3, 0, 0, 1, 0), "ShearY": (1, 0, 0, v * 0.3, 1, 0),
              "TranslateX": (1, 0, v * 10.0, 0, 1, 0), "TranslateY": (1, 0, 0, 0, 1, v * 10.0)}
    return img.transform(img.size, Image.AFFINE, affine[name])


RA_OPS = ("Identity", "AutoContrast", "Equalize", "Rotate", "Solarize", "Posterize",
          "Contrast", "Color", "Brightness", "Sharpness", "ShearX", "ShearY", "TranslateX",
          "TranslateY")
# the reference train transforms leave out the colour-destroying ops
# (Solarize, Posterize, Contrast, Color would corrupt colour answers):
# dataset/__init__.py:22,30,78
RA_REFERENCE_TRAIN_AUGS = ("Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
                           "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
# ops whose magnitude is negated half the time (randaugment.py:217,226,261)
_RA_SIGNED = {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY"}


class RandomAugment:
    """``n`` ops at magnitude ``m/10`` with the vendored augmenter's sampling
    (``randaugment.py:310-334``): drawn with replacement, each applied with
    probability 0.5, geometric magnitudes negated half the time.  ``augs``
    defaults to the reference train transforms' 10 ops."""

    def __init__(self, n: int = 2, m: int = 7, rng: Optional[random.Random] = None, augs=None):
        self.n, self.m = n, m
        self.rng = rng or random.Random()
        self.augs = tuple(augs) if augs else RA_REFERENCE_TRAIN_AUGS

    def __call__(self, img):
        for name in self.rng.choices(self.augs, k=self.n):
            if self.rng.random() > 0.5:  # the per-op gate (randaugment.py:330)
                continue
            v = self.m / 10.0
            if name in _RA_SIGNED and self.rng.random() > 0.5:
                v = -v
            img = _op(name, img, v)
        return img


def train_transform(size: int = 480, rng: Optional[random.Random] = None) -> Callable:
    """PIL image -> ``[3, size, size]`` float32: a crop of 0.5-1.0 of the
    area at the image's aspect, resized bicubic, a flip half the time,
    RandomAugment(2, 7), normalised."""
    rng = rng or random.Random()
    ra = RandomAugment(2, 7, rng)

    def fn(img) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB")
        w, h = img.size
        scale = rng.uniform(0.5, 1.0)
        cw, ch = int(w * scale ** 0.5), int(h * scale ** 0.5)
        x0 = rng.randint(0, max(0, w - cw))
        y0 = rng.randint(0, max(0, h - ch))
        img = img.crop((x0, y0, x0 + cw, y0 + ch)).resize((size, size), Image.BICUBIC)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = ra(img)
        return inception_normalize(np.asarray(img)).transpose(2, 0, 1)

    return fn
