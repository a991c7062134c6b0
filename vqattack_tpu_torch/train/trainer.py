"""The training state and one optimizer step.

Port of ``vqattack_tpu/train/trainer.py``.  The JAX step is one jitted
function of (state, batch, key) that returns a new state; here the state
holds the module, whose parameters :func:`make_train_step`'s step updates
in place (``train/optim.py``), the optimizer state and the step count.
Gradients are taken with ``torch.autograd.grad`` over every parameter, as
``jax.value_and_grad`` takes them over the whole tree: a parameter the loss
does not reach gets a zero gradient, which still counts in ``grad_norm``
and still moves its moments and its weight decay.  A second-order step
(AdaHessian) also takes a Hessian-vector product through the gradient's
graph, where JAX takes forward-over-reverse ``jax.jvp(jax.grad(loss))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from vqattack_tpu_torch.train.adahessian import HESSIAN_KEY, grad_and_hvps, rademacher_like
from vqattack_tpu_torch.train.optim import Optimizer, global_norm, named_params


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Dict[str, Any]


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(0, model, tx.init(named_params(model)))


# (model, batch, key) -> (loss, metrics); the key (``rng.py``) is the step's
# own, split off the run's key as the JAX CLI splits it, and draws what the
# loss samples (the pretraining losses' hard negatives); None where the
# loss draws nothing
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], Optional[Any]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(loss_fn: LossFn, tx: Optimizer, needs_hessian: bool = False):
    """``loss_fn(model, batch, key) -> (loss, metrics)`` -> a step
    ``(state, batch, key) -> (state, metrics)``; ``metrics`` gains
    ``grad_norm``, the global norm of the gradients before any clipping
    (``optax.global_norm``).

    ``needs_hessian=True`` drives a second-order optimizer (``adahessian``):
    the loss is evaluated once (a pretraining loss draws its hard negatives
    from the step's key, and a second evaluation would draw others), its
    gradient taken with a graph, and one Hessian-vector product ``H z``
    taken through it, ``z`` Rademacher from ``key.fold_in(0x5EED)``; the
    optimizer steps with ``hess_diag = z * H z``
    (``train/adahessian.py``)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor], key: Optional[Any] = None):
        params = named_params(state.model)
        loss, metrics = loss_fn(state.model, batch, key)
        if needs_hessian:
            if key is None:
                raise ValueError("a Hessian step draws its z from the step's key; pass one")
            z = rademacher_like(state.model, key.fold_in(HESSIAN_KEY))
            grads, (hz,) = grad_and_hvps(loss, params, [z])
            opt_state = tx.step(params, grads, state.opt_state,
                                hess_diag={n: z[n] * hz[n] for n in params})
        else:
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            opt_state = tx.step(params, grads, state.opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads.values())
        return TrainState(state.step + 1, state.model, opt_state), metrics

    return step
