"""Image transforms: decode -> (augment) -> resize -> normalize.

Port of ``vqattack_tpu/data/transforms.py``: ``test_transform``,
``train_transform`` and ``RandomAugment`` (ALBEF), and VLMo's registry
(``keys_to_transforms``): the pixelbert family's aspect-preserving
``min_max_resize`` and ``RandAugmentUDA``, and the square transforms.  The
test transform is the reference's
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


def denormalize(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8 [0, 255], element by element (any layout)."""
    return np.clip((x * STD + MEAN) * 255.0, 0, 255).astype(np.uint8)


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


# ---------------------------------------------------------------------------
# VLMo's pixelbert family (``vlmo/transforms/{pixelbert,randaug,utils}.py``):
# the aspect-preserving MinMax resize and the UDA/efficientnet 14-op
# RandAugment pool, magnitude m/30 mapped linearly onto each op's range
# ---------------------------------------------------------------------------


def min_max_resize(img, shorter: int = 800, longer: int = 1333):
    """Aspect-preserving bicubic resize: the shorter side to ``shorter``,
    capped so that the longer side is at most ``longer``, both rounded down
    to multiples of 32 (``vlmo/transforms/utils.py::MinMaxResize:5-26``)."""
    from PIL import Image

    w, h = img.size
    scale = shorter / min(w, h)
    if h < w:
        newh, neww = shorter, scale * w
    else:
        newh, neww = scale * h, shorter
    if max(newh, neww) > longer:
        scale = longer / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    newh, neww = int(newh + 0.5), int(neww + 0.5)
    newh, neww = newh // 32 * 32, neww // 32 * 32
    return img.resize((neww, newh), Image.BICUBIC)


def _solarize_add(img, v, threshold: int = 128):
    """``randaug.py::SolarizeAdd:83-90``: add ``v`` (truncated by the uint8
    cast, as the reference's astype) then solarize at 128."""
    from PIL import Image, ImageOps

    arr = np.clip(np.asarray(img).astype(np.float64) + v, 0, 255).astype(np.uint8)
    return ImageOps.solarize(Image.fromarray(arr), threshold)


def _signed(rng, v):
    """The geometric ops negate with p = 0.5 (``randaug.py:13,20,35,51,58``)."""
    return -v if rng.random() > 0.5 else v


# (op, min, max): ``randaug.py::augment_list:181-200``, the tensorflow/tpu
# efficientnet pool.  The magnitude v = m/30 (max - min) + min reaches the op
# raw (degrees, pixels, enhance factors, thresholds), unlike RandomAugment's
# m/10 above.
_UDA_POOL = (
    ("AutoContrast", 0, 1), ("Equalize", 0, 1), ("Rotate", 0, 30), ("Posterize", 0, 4),
    ("Solarize", 0, 256), ("SolarizeAdd", 0, 110), ("Color", 0.1, 1.9),
    ("Contrast", 0.1, 1.9), ("Brightness", 0.1, 1.9), ("Sharpness", 0.1, 1.9),
    ("ShearX", 0.0, 0.3), ("ShearY", 0.0, 0.3), ("TranslateXabs", 0.0, 100),
    ("TranslateYabs", 0.0, 100),
)


def _uda_op(name: str, img, v: float, rng):
    """One op of :data:`_UDA_POOL` at magnitude ``v``; the geometric ones
    draw their sign from ``rng`` as they are applied."""
    from PIL import Image, ImageEnhance, ImageOps

    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    if name == "Rotate":
        return img.rotate(_signed(rng, v))
    if name == "Posterize":
        return ImageOps.posterize(img, max(1, int(v)))
    if name == "Solarize":
        return ImageOps.solarize(img, v)
    if name == "SolarizeAdd":
        return _solarize_add(img, v)
    enhance = {"Color": ImageEnhance.Color, "Contrast": ImageEnhance.Contrast,
               "Brightness": ImageEnhance.Brightness, "Sharpness": ImageEnhance.Sharpness}
    if name in enhance:
        return enhance[name](img).enhance(v)
    s = _signed(rng, v)
    affine = {"ShearX": (1, s, 0, 0, 1, 0), "ShearY": (1, 0, 0, s, 1, 0),
              "TranslateXabs": (1, 0, s, 0, 1, 0), "TranslateYabs": (1, 0, 0, 0, 1, s)}
    return img.transform(img.size, Image.AFFINE, affine[name])


class RandAugmentUDA:
    """The pixelbert family's augmenter (``randaug.py::RandAugment:257-268``):
    ``n`` ops drawn with replacement from the 14-op pool, every one applied
    (no gate), at magnitude ``v = m/30 (max - min) + min``."""

    def __init__(self, n: int = 2, m: int = 9, rng: Optional[random.Random] = None):
        self.n, self.m = n, m
        self.rng = rng or random.Random()

    def __call__(self, img):
        for name, lo, hi in self.rng.choices(_UDA_POOL, k=self.n):
            img = _uda_op(name, img, (float(self.m) / 30) * float(hi - lo) + lo, self.rng)
        return img


def pixelbert_transform(size: int = 800) -> Callable:
    """MinMaxResize(size, 1333/800 size) + normalise
    (``vlmo/transforms/pixelbert.py:9-17``): PIL image -> ``[3, H, W]``,
    H and W varying with the image."""
    longer = int((1333 / 800) * size)

    def fn(img) -> np.ndarray:
        img = img.convert("RGB")
        return inception_normalize(np.asarray(min_max_resize(img, size, longer))).transpose(2, 0, 1)

    return fn


def pixelbert_transform_randaug(size: int = 800,
                                rng: Optional[random.Random] = None) -> Callable:
    """RandAugmentUDA(2, 9) before the resize (``pixelbert.py:20-29``
    inserts it at index 0)."""
    longer = int((1333 / 800) * size)
    ra = RandAugmentUDA(2, 9, rng)

    def fn(img) -> np.ndarray:
        img = ra(img.convert("RGB"))
        return inception_normalize(np.asarray(min_max_resize(img, size, longer))).transpose(2, 0, 1)

    return fn


def square_transform(size: int = 224) -> Callable:
    """VLMo's name for the test transform (``square_transform.py:11-18``)."""
    return test_transform(size)


def square_transform_randaug(size: int = 224,
                             rng: Optional[random.Random] = None) -> Callable:
    """A crop of 0.5-1.0 of the area, a flip and RandomAugment(2, 7)
    (``square_transform.py:21-31``): the ALBEF train transform."""
    return train_transform(size, rng)


_TRANSFORMS = {
    "pixelbert": pixelbert_transform,
    "pixelbert_randaug": pixelbert_transform_randaug,
    "square_transform": square_transform,
    "square_transform_randaug": square_transform_randaug,
}


def keys_to_transforms(keys, size: int = 224):
    """The registry (``vlmo/transforms/__init__.py:10-19``): a config's
    ``train/val_transform_keys`` resolve through it."""
    return [_TRANSFORMS[key](size=size) for key in keys]


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
