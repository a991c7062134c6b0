"""Norm-ball projection and steepest-ascent step directions.

Port of ``vqattack_tpu/attacks/norms.py`` (cleverhans
``torch/utils.py:8-129``).  Reductions run over all non-batch axes, so each
sample of a batch is projected on its own.
"""

from __future__ import annotations

import torch

_AVOID_ZERO_DIV = 1e-12

LINF = "linf"
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
    if norm == L2:
        sq = torch.sum(grad * grad, dim=_reduce_axes(grad), keepdim=True)
        return eps * grad / torch.sqrt(torch.clamp(sq, min=_AVOID_ZERO_DIV))
    raise ValueError(f"optimize_linear: unsupported norm {norm!r}")
