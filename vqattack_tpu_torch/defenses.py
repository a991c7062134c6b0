"""Input-transformation defenses (and the DI attack transform).

Port of ``vqattack_tpu/defenses.py`` on NCHW tensors.  The reference vendors
one defense, stochastic input resampling (``cleverhans/defenses``), and an
unused ``input_diversity`` random-resize-pad transform in its FGM kernels
(``fast_gradient_method.py:9-29``):

- :func:`random_resize_pad`: downscale by a random factor and place the
  image at a random offset on a zero canvas of the original size;
- :func:`spatial_smoothing`: the median-filter defense;
- :func:`bit_depth_reduction`: the quantization defense.

The random draws come from a key of ``rng.py`` (``split``, ``uniform``),
so a test can feed :func:`random_resize_pad` the JAX package's own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _linear_weights(n_in: int, n_out: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """``[n_in, n_out]`` weights of ``jax.image.scale_and_translate``'s
    linear method along one axis, antialiased: the triangle kernel widened
    by ``1 / scale`` when downscaling, each output's weights normalised to
    sum 1, and outputs whose sample point falls outside the input zero."""
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * inv \
        - translation * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]).abs()
    w = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def random_resize_pad(x: torch.Tensor, rng, min_scale: Optional[float] = None) -> torch.Tensor:
    """Randomly downscale (bilinear, antialiased) and pad back to the
    original size at a random offset (``input_diversity``,
    ``fast_gradient_method.py:9-29``).  ``x``: ``[B, C, H, W]``.

    ``min_scale`` defaults to the reference's range: it draws the resized
    height from ``uniform(H - 32, H)``, i.e. a scale in ``[(H - 32) / H,
    1)``.  The scale and the top and left offsets are three draws from the
    three keys of ``rng.split(3)``, as the JAX transform draws them."""
    b, c, h, w = x.shape
    if min_scale is None:
        min_scale = (h - 32) / h
    k_s, k_t, k_l = rng.split(3)
    s = torch.as_tensor(k_s.uniform((), min_scale, 1.0), dtype=torch.float32)
    top = torch.as_tensor(k_t.uniform((), 0.0, float((1.0 - s) * h)), dtype=torch.float32)
    left = torch.as_tensor(k_l.uniform((), 0.0, float((1.0 - s) * w)), dtype=torch.float32)
    s, top, left = (t.to(x.device) for t in (s, top, left))
    wh = _linear_weights(h, h, s, top).to(x.dtype)
    ww = _linear_weights(w, w, s, left).to(x.dtype)
    return torch.einsum("bchw,hH,wW->bcHW", x, wh, ww)


def spatial_smoothing(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Median over a ``window x window`` neighbourhood, edges replicated.
    ``x``: ``[B, C, H, W]``."""
    pad = window // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    h, w = x.shape[-2:]
    patches = [xp[..., i : i + h, j : j + w] for i in range(window) for j in range(window)]
    return torch.stack(patches).median(dim=0).values


def bit_depth_reduction(x: torch.Tensor, bits: int = 4, lo: float = -1.0,
                        hi: float = 1.0) -> torch.Tensor:
    """Quantize to ``2 ** bits`` levels over ``[lo, hi]`` (ties to even, as
    ``jnp.round``)."""
    levels = 2 ** bits - 1
    unit = (x - lo) / (hi - lo)
    return torch.round(unit * levels) / levels * (hi - lo) + lo
