"""AdaHessian: Adam's moments over a Hutchinson estimate of the Hessian's
diagonal.

Port of ``vqattack_tpu/train/adahessian.py`` (the reference's vendored
timm ``ALBEF_attack/optim/adahessian.py``):

- the diagonal is estimated with Hutchinson's method, ``diag(H) ~ z * (H
  z)`` with Rademacher ``z``; ``H z`` is the exact Hessian-vector product,
  the gradient of ``<grad, z>`` taken through the gradient's own graph
  (``torch.autograd.grad(..., create_graph=True)``, then a second
  ``grad``), where JAX takes ``jax.jvp(jax.grad(loss))``.  The loss is
  evaluated once; the gradient is the first ``grad``'s output;
- ``z`` is drawn leaf by leaf in the flax tree's order (its paths sorted),
  one key a leaf split off the step's key, each leaf flat at its size,
  shaped as the flax leaf and laid out as the parameter
  (``checkpoint/convert.py::FlaxToTorch``): the JAX package's draws, given
  its key;
- the update (``scale_by_adahessian``, then the masked decoupled decay,
  then ``* -lr(t)``) takes the estimate as ``hess_diag``; a conv kernel's
  estimate is first averaged over its spatial block, the reference's
  ``get_trace``: over H and W, dims (2, 3) of torch's OIHW (dims (0, 1) of
  flax's HWIO).

The kernels of ``ops/`` have no second derivative: a model that reaches
the fused LayerNorm or the flash attention raises in the first
``create_graph`` backward.  ``train/cli.py`` trains AdaHessian with the
plain LayerNorm and refuses the flash backend, as the JAX package can take
no Hessian through its Pallas kernels either.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

from vqattack_tpu_torch.checkpoint.convert import flax_leaves
from vqattack_tpu_torch.train.optim import Params, Rule, zeros

HESSIAN_KEY = 0x5EED  # folded into a train step's key for its z, as the JAX trainer folds it


def rademacher_like(model: nn.Module, key) -> Params:
    """One Rademacher ``z`` a parameter of ``model``, by name: leaf i of the
    flax tree's order from ``key.split(n)[i]``, drawn flat, shaped as the
    flax leaf, then laid out as the parameter."""
    leaves = sorted(flax_leaves(model), key=lambda leaf: leaf[1])
    z = {}
    for k, (name, _, transform, p) in zip(key.split(len(leaves)), leaves):
        flat = k.rademacher((p.numel(),), dtype=p.dtype).to(p.device)
        z[name] = transform(flat.reshape(transform.flax_shape(p.shape))).contiguous()
    return z


def grad_and_hvps(loss: torch.Tensor, params: Params, zs: List[Params]
                  ) -> Tuple[Params, List[Params]]:
    """``(gradient, [H z for z in zs])`` of ``loss`` (evaluated, with its
    graph) over ``params``.  A leaf the loss does not reach gets a zero
    gradient, and a leaf whose gradient has no graph (the loss reaches the
    parameters there linearly, or not at all) adds nothing to ``H z``."""
    names = list(params)
    tensors = [params[n] for n in names]
    grads = torch.autograd.grad(loss, tensors, create_graph=True, allow_unused=True)
    live = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]
    hvps = []
    for j, z in enumerate(zs):
        hz = [None] * len(names)
        if live:
            hz = torch.autograd.grad([grads[i] for i in live], tensors,
                                     grad_outputs=[z[names[i]] for i in live],
                                     retain_graph=j + 1 < len(zs), allow_unused=True)
        hvps.append({n: torch.zeros_like(p) if h is None else h.detach()
                     for n, p, h in zip(names, tensors, hz)})
    grad = {n: torch.zeros_like(p) if g is None else g.detach()
            for n, p, g in zip(names, tensors, grads)}
    return grad, hvps


def grad_and_hessian_diag(loss_fn: Callable[..., torch.Tensor], model: nn.Module, key, *args,
                          n_samples: int = 1) -> Tuple[Params, Params]:
    """``(gradient, Hutchinson diagonal)`` of ``loss_fn(model, *args)``,
    averaged over ``n_samples`` draws: the first from ``key``, draw i from
    ``key.fold_in(i)``, as the JAX package draws them."""
    params = {name: p for name, _, _, p in flax_leaves(model)}
    zs = [rademacher_like(model, key if i == 0 else key.fold_in(i)) for i in range(n_samples)]
    grad, hvps = grad_and_hvps(loss_fn(model, *args), params, zs)
    diag = {n: sum(z[n] * hz[n] for z, hz in zip(zs, hvps)) / n_samples for n in params}
    return grad, diag


def hutchinson_diag(loss_fn: Callable[..., torch.Tensor], model: nn.Module, key, *args,
                    n_samples: int = 1) -> Params:
    """The Rademacher estimate of ``diag(H)`` of ``loss_fn(model, *args)``."""
    return grad_and_hessian_diag(loss_fn, model, key, *args, n_samples=n_samples)[1]


def spatial_average(hd: torch.Tensor) -> torch.Tensor:
    """A conv kernel's estimate averaged over its spatial block: the mean
    over H and W of torch's OIHW, broadcast back; other leaves unchanged."""
    if hd.ndim == 4:
        return hd.mean(dim=(2, 3), keepdim=True).expand_as(hd)
    return hd


class AdaHessian(Rule):
    """``adahessian(lr, b1, b2, eps, weight_decay, mask)`` of the JAX
    package as a rule of ``train/optim.py``: ``mu`` the EMA of the
    gradient, ``nu`` of the spatially averaged estimate squared, the update
    ``(mu / c1) / (sqrt(nu / c2) + eps)`` (the factory's Hessian power 1),
    then ``+ wd p`` on the decayed leaves, then ``* -lr(t)``."""

    needs_hessian = True

    def __init__(self, decay: Dict[str, bool], weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> Dict[str, Any]:
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, grads, state, params, count, lr, hess_diag):
        b1, b2 = self.b1, self.b2
        c1, c2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
        new, out = {"mu": {}, "nu": {}}, {}
        for n, p in params.items():
            h = spatial_average(hess_diag[n])
            mu = b1 * state["mu"][n] + (1.0 - b1) * grads[n]
            nu = b2 * state["nu"][n] + (1.0 - b2) * (h * h)
            new["mu"][n], new["nu"][n] = mu, nu
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.wd(n):
                u = u + self.wd(n) * p
            out[n] = -lr * u
        return out, new
