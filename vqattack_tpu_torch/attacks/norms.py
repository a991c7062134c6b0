"""Norm-ball projection and steepest-ascent step directions.

Port of ``vqattack_tpu/attacks/norms.py`` (cleverhans
``torch/utils.py:8-149``).  Reductions run over all non-batch axes, so each
sample of a batch is projected on its own.

- :func:`clip_eta`: project a perturbation onto the L-inf / L2 eps-ball;
- :func:`optimize_linear`: the FGM step, the ``eps``-norm perturbation with
  the largest inner product with the gradient (L-inf, L1, L2);
- :func:`zero_out_clipped_grads`: drop gradient components that point out
  of the ``[clip_min, clip_max]`` box at its boundary;
- :func:`get_or_guess_labels`: the given labels, or the model's own argmax.
"""

from __future__ import annotations

from typing import Optional

import torch

_AVOID_ZERO_DIV = 1e-12

LINF = "linf"
L1 = "l1"
L2 = "l2"


def _reduce_axes(x: torch.Tensor):
    return tuple(range(1, x.dim()))


def clip_eta(eta: torch.Tensor, norm: str, eps: float) -> torch.Tensor:
    """Project ``eta`` into the eps-ball of ``norm``, per sample."""
    if norm == LINF:
        return torch.clamp(eta, -eps, eps)
    if norm == L2:
        sq = torch.sum(eta * eta, dim=_reduce_axes(eta), keepdim=True)
        n = torch.sqrt(torch.clamp(sq, min=_AVOID_ZERO_DIV))
        return eta * torch.clamp(eps / n, max=1.0)
    raise ValueError(f"clip_eta: unsupported norm {norm!r}")


def optimize_linear(grad: torch.Tensor, eps: float, norm: str = LINF) -> torch.Tensor:
    """The perturbation of norm ``eps`` with the largest inner product with
    ``grad`` (cleverhans ``optimize_linear``); ``sign(0) = 0``."""
    if norm == LINF:
        return eps * torch.sign(grad)
    if norm == L1:
        # every component tied at the largest |g| shares eps
        axes = _reduce_axes(grad)
        abs_grad = torch.abs(grad)
        max_abs = torch.amax(abs_grad, dim=axes, keepdim=True)
        tied = (abs_grad >= max_abs).to(grad.dtype)
        num_ties = torch.sum(tied, dim=axes, keepdim=True)
        return eps * torch.sign(grad) * tied / num_ties
    if norm == L2:
        sq = torch.sum(grad * grad, dim=_reduce_axes(grad), keepdim=True)
        return eps * grad / torch.sqrt(torch.clamp(sq, min=_AVOID_ZERO_DIV))
    raise ValueError(f"optimize_linear: unsupported norm {norm!r}")


def zero_out_clipped_grads(grad: torch.Tensor, x: torch.Tensor, clip_min: float,
                           clip_max: float) -> torch.Tensor:
    """Zero the gradient components that point out of the clip box where
    ``x`` sits on its boundary: an ascent step cannot move them."""
    signed = torch.sign(grad)
    clipped = ((x <= clip_min) & (signed < 0)) | ((x >= clip_max) & (signed > 0))
    return torch.where(clipped, torch.zeros_like(grad), grad)


def get_or_guess_labels(model_fn, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                        targeted: bool = False) -> torch.Tensor:
    """The attack's labels: ``y`` (required when ``targeted``), else the
    model's own argmax predictions."""
    if targeted:
        if y is None:
            raise ValueError("targeted attacks require explicit labels")
        return y
    if y is not None:
        return y
    return torch.argmax(model_fn(x), dim=1)
