"""Learning-rate schedules and optimizers, with optax's arithmetic.

Port of ``vqattack_tpu/train/optim.py``.  The JAX package builds its
optimizers from optax transforms; here each is written out as plain tensor
updates with optax's formulas, in optax's order, so that the same gradients
give the same parameters:

- ``adamw``: ``scale_by_adam`` (moments, bias correction by ``1 - b**t``,
  ``m / (sqrt(v) + eps)``), then ``+ weight_decay * p`` on the decayed
  leaves, then ``* -lr(t)``;
- ``adam``: the same without the decay;
- ``sgd``: ``+ weight_decay * p`` on the decayed leaves, then Nesterov
  momentum (``optax.trace``), then ``* -lr(t)``;

with ``lr(t)`` the schedule at the step count before the update, the head
learning-rate multiplier after it (``optax.multi_transform``), and global
norm clipping before everything (``optax.clip_by_global_norm``).  The
optimizer state is a dict of tensors keyed by the port's parameter names
(``checkpoint/io.py`` saves it); :meth:`Optimizer.step` updates the
parameters in place, where optax returns new ones.

Which leaves decay, and which belong to a head, is decided on each
parameter's flax path (``checkpoint/convert.py::flax_leaves``), so the same
leaves decay in both packages.  The optimizers of ``optim_extra.py``,
``lamb``, ``lion``, ``adafactor``, ``rmsprop``, the ``lookahead_`` wrapper
and AdaHessian are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from vqattack_tpu_torch.checkpoint.convert import flax_leaves

Schedule = Callable[[int], float]

NO_DECAY_NAMES = ("bias", "LayerNorm", "layer_norm", "norm", "embeddings",
                  "cls_token", "pos_embed", "gamma_", "temp",
                  "relative_position_bias_table")
HEAD_NAMES = ("vqa_classifier", "nlvr2_classifier", "mlm_head")
PORTED = ("adamw", "adam", "sgd")
NOT_PORTED = ("rmsprop", "adafactor", "lamb", "lion", "nadam", "radam", "adamp", "sgdp",
              "novograd", "nvnovograd", "rmsproptf", "adahessian")


def _path_contains(path: Sequence[str], names: Sequence[str]) -> bool:
    return any(any(n in k for n in names) for k in path)


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether weight decay applies (the torch no-decay
    convention: biases, norms, embeddings, position/cls tokens excluded),
    decided on the parameter's flax path as the JAX ``decay_mask`` does."""
    return {name: not _path_contains(path, NO_DECAY_NAMES)
            for name, path, _, _ in flax_leaves(model)}


def head_mask(model: nn.Module, head_names: Sequence[str] = HEAD_NAMES) -> Dict[str, bool]:
    """Parameter name -> whether it belongs to a head (``head_lr_mult``)."""
    return {name: _path_contains(path, head_names) for name, path, _, _ in flax_leaves(model)}


# ---------------------------------------------------------------------------
# schedules (optax's formulas)
# ---------------------------------------------------------------------------


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def fn(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) ** power + end

    return fn


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    def fn(count: int) -> float:
        c = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)

    return fn


def _exponential(init: float, steps: int, rate: float, end: Optional[float]) -> Schedule:
    if steps <= 0 or rate == 0:
        return lambda count: init

    def fn(count: int) -> float:
        value = init if count <= 0 else init * rate ** math.floor(count / steps)
        if end is not None:
            value = max(value, end) if rate < 1 else min(value, end)
        return value

    return fn


def create_schedule(
    kind: str = "cosine",
    base_lr: float = 2e-5,
    total_steps: int = 10000,
    warmup_steps: int = 0,
    warmup_lr: float = 0.0,
    min_lr: float = 0.0,
    decay_rate: float = 1.0,
    decay_steps: int = 0,
    power: float = 1.0,
) -> Schedule:
    """cosine | linear | polynomial | step | constant, with linear warmup:
    a function of the step count (0 first) giving the learning rate."""
    n = max(1, total_steps - warmup_steps)
    if kind == "cosine":
        main = _cosine(base_lr, n, min_lr / max(base_lr, 1e-12))
    elif kind == "linear":
        main = _polynomial(base_lr, min_lr, 1.0, n)
    elif kind == "polynomial":
        main = _polynomial(base_lr, min_lr, power, n)
    elif kind == "step":
        if decay_steps <= 0:
            raise ValueError("the step schedule needs decay_steps > 0")
        main = _exponential(base_lr, decay_steps, decay_rate, min_lr)
    elif kind == "constant":
        main = lambda count: base_lr  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    if warmup_steps <= 0:
        return main
    warm = _polynomial(warmup_lr, base_lr, 1.0, warmup_steps)
    return lambda count: warm(count) if count < warmup_steps else main(count - warmup_steps)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Optimizer:
    """One of :data:`PORTED` over named parameters.  ``init`` makes the
    state; ``step`` applies one update to the parameters in place and
    returns the next state."""

    def __init__(self, kind: str, schedule: Schedule, decay: Dict[str, bool],
                 head: Dict[str, bool], weight_decay: float = 0.02, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, momentum: float = 0.9,
                 head_lr_mult: float = 1.0, grad_clip: Optional[float] = None):
        self.kind, self.schedule = kind, schedule
        self.decay, self.head = decay, head
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.momentum, self.head_lr_mult, self.grad_clip = momentum, head_lr_mult, grad_clip

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: Dict[str, Any]) -> Dict[str, Any]:
        count = state["count"]
        if self.grad_clip:
            norm = global_norm(grads.values())
            if not bool(norm < self.grad_clip):
                grads = {n: (g / norm) * self.grad_clip for n, g in grads.items()}
        lr = self.schedule(count)
        new = {"count": count + 1}
        if self.kind == "sgd":
            new["trace"] = {}
        else:
            new["mu"], new["nu"] = {}, {}
            # 1 - b**t in float64: optax's float32 power loses up to ~3e-5
            # of 1 - b2**t to cancellation at small t
            bc1, bc2 = 1 - self.b1 ** (count + 1), 1 - self.b2 ** (count + 1)
        for n, p in params.items():
            g = grads[n]
            decayed = self.kind != "adam" and self.decay[n]
            if self.kind == "sgd":
                u = g + self.weight_decay * p if decayed else g
                tr = u + self.momentum * state["trace"][n]
                new["trace"][n] = tr
                u = u + self.momentum * tr
            else:
                mu = (1 - self.b1) * g + self.b1 * state["mu"][n]
                nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][n]
                new["mu"][n], new["nu"][n] = mu, nu
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if decayed:
                    u = u + self.weight_decay * p
            u = -lr * u
            if self.head_lr_mult != 1.0 and self.head[n]:
                u = self.head_lr_mult * u
            p.add_(u)
        return new


def create_optimizer(
    model: nn.Module,
    opt: str = "adamw",
    schedule: Schedule | float = 2e-5,
    weight_decay: float = 0.02,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    momentum: float = 0.9,
    head_lr_mult: float = 1.0,
    head_names: Sequence[str] = HEAD_NAMES,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    """The factory (``optim_factory.create_optimizer`` surface): masked decay,
    optional head lr multiplier, optional global-norm clipping."""
    if opt.startswith("lookahead_") or opt in NOT_PORTED:
        raise ValueError(f"optimizer {opt!r} is not ported yet; the port has {PORTED}")
    if opt not in PORTED:
        raise ValueError(f"unknown optimizer {opt!r}")
    if not callable(schedule):
        lr = float(schedule)
        schedule = lambda count: lr  # noqa: E731
    return Optimizer(opt, schedule, decay_mask(model), head_mask(model, head_names),
                     weight_decay, b1, b2, eps, momentum, head_lr_mult, grad_clip)


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters an optimizer updates, by the names of its masks."""
    return {name: p for name, _, _, p in flax_leaves(model)}

