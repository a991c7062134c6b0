"""Learning-rate schedules and optimizers, with optax's arithmetic.

Port of ``vqattack_tpu/train/optim.py``.  The JAX package builds its
optimizers from optax transforms; here each is written out as plain tensor
updates with optax's formulas, in optax's order, so that the same gradients
give the same parameters:

- ``adamw``: ``scale_by_adam`` (moments, bias correction by ``1 - b**t``,
  ``m / (sqrt(v) + eps)``), then ``+ weight_decay * p`` on the decayed
  leaves, then ``* -lr(t)``; ``adam`` without the decay; ``lamb`` the
  same as ``adamw``, then each leaf scaled by its trust ratio
  ``|p| / |u|`` (1 where either is 0) before the learning rate;
- ``sgd``: ``+ weight_decay * p`` on the decayed leaves, then Nesterov
  momentum (``optax.trace``), then ``* -lr(t)``;
- ``rmsprop``: the decay, then ``g / sqrt(nu + 1e-8)`` with ``nu`` the
  0.9-EMA of ``g**2`` from 0, then ``* -lr(t)``, then momentum;
- ``adafactor``: optax's defaults: the second moment factored into row and
  column means for a leaf whose two largest dimensions are at least 128
  (decay ``1 - t**-0.8``, eps 1e-30), each leaf's update clipped to an RMS
  of 1, times ``lr(t)`` and the parameter's RMS (at least 1e-3), negated;
- ``lion``: ``sign(0.1 g + 0.9 m)``, ``m`` the 0.99-EMA of ``g``, the
  decay, then ``* -lr(t)``;
- the rest of the timm zoo in ``optim_extra.py``, AdaHessian in
  ``adahessian.py``;

with ``lr(t)`` the schedule at the step count before the update, the head
learning-rate multiplier after it (``optax.multi_transform``), global norm
clipping before everything (``optax.clip_by_global_norm``), and a
``lookahead_`` prefix wrapping all of that (``optim_extra.Lookahead``).
The optimizer state is a dict of tensors keyed by the port's parameter
names, with plain numbers for the step counts (``checkpoint/io.py`` saves
it); :meth:`Optimizer.step` updates the parameters in place, where optax
returns new ones.  Each leaf's conditions (the trust ratio, Adafactor's
clip and parameter scale, AdamP's projection) are chosen on the device:
a step waits for the device nowhere.

Which leaves decay, and which belong to a head, is decided on each
parameter's flax path (``checkpoint/convert.py::flax_leaves``), so the same
leaves decay in both packages.  Parameters stay in torch's layout; where a
rule depends on it, the module that holds the rule says how.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vqattack_tpu_torch.checkpoint.convert import flax_leaves

Schedule = Callable[[int], float]

NO_DECAY_NAMES = ("bias", "LayerNorm", "layer_norm", "norm", "embeddings",
                  "cls_token", "pos_embed", "gamma_", "temp",
                  "relative_position_bias_table")
HEAD_NAMES = ("vqa_classifier", "nlvr2_classifier", "mlm_head")
# every name the JAX factory takes, and a "lookahead_" prefix on any but adahessian
OPTIMIZERS = ("adamw", "adam", "sgd", "rmsprop", "adafactor", "lamb", "lion", "nadam", "radam",
              "adamp", "sgdp", "novograd", "nvnovograd", "rmsproptf", "adahessian")


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

Params = Dict[str, torch.Tensor]


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def zeros(params: Params) -> Params:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


class Rule:
    """One optimizer's update rule over named parameters: ``init(params)``
    gives its state, ``update(grads, state, params, count, lr)`` the
    updates to add (the learning rate ``lr`` and the sign applied) and the
    next state; ``count`` is the number of updates made before this one.
    ``decay`` says which leaves take the weight decay (coupled or
    decoupled, as each rule adds it)."""

    needs_hessian = False

    def __init__(self, decay: Dict[str, bool], weight_decay: float):
        self.decay, self.weight_decay = decay, weight_decay

    def wd(self, name: str) -> float:
        return self.weight_decay if self.decay[name] else 0.0


class _Adam(Rule):
    """``adamw``, ``adam`` (``weight_decay`` 0) and ``lamb`` (``trust``)."""

    def __init__(self, decay, weight_decay, b1, b2, eps, trust=False):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps, self.trust = b1, b2, eps, trust

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, grads, state, params, count, lr):
        # 1 - b**t in float64: optax's float32 power loses up to ~3e-5
        # of 1 - b2**t to cancellation at small t
        bc1, bc2 = 1 - self.b1 ** (count + 1), 1 - self.b2 ** (count + 1)
        new, out = {"mu": {}, "nu": {}}, {}
        for n, p in params.items():
            g = grads[n]
            mu = (1 - self.b1) * g + self.b1 * state["mu"][n]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][n]
            new["mu"][n], new["nu"][n] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.wd(n):
                u = u + self.wd(n) * p
            if self.trust:  # optax.scale_by_trust_ratio
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                u = u * torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            out[n] = -lr * u
        return out, new


class _Sgd(Rule):
    """Coupled decay, then Nesterov momentum."""

    def __init__(self, decay, weight_decay, momentum):
        super().__init__(decay, weight_decay)
        self.momentum = momentum

    def init(self, params):
        return {"trace": zeros(params)}

    def update(self, grads, state, params, count, lr):
        new, out = {"trace": {}}, {}
        for n, p in params.items():
            u = grads[n] + self.wd(n) * p if self.wd(n) else grads[n]
            tr = u + self.momentum * state["trace"][n]
            new["trace"][n] = tr
            out[n] = -lr * (u + self.momentum * tr)
        return out, new


class _RmsProp(Rule):
    """``add_decayed_weights``, then ``optax.rmsprop(lr, momentum)`` at its
    defaults: decay 0.9, ``eps_in_sqrt`` (``g / sqrt(nu + 1e-8)``), the
    learning rate before the momentum trace."""

    DECAY, EPS = 0.9, 1e-8

    def __init__(self, decay, weight_decay, momentum):
        super().__init__(decay, weight_decay)
        self.momentum = momentum

    def init(self, params):
        return {"nu": zeros(params), "trace": zeros(params)}

    def update(self, grads, state, params, count, lr):
        new, out = {"nu": {}, "trace": {}}, {}
        for n, p in params.items():
            g = grads[n] + self.wd(n) * p if self.wd(n) else grads[n]
            nu = (1 - self.DECAY) * (g * g) + self.DECAY * state["nu"][n]
            tr = (g * torch.rsqrt(nu + self.EPS)) * -lr + self.momentum * state["trace"][n]
            new["nu"][n], new["trace"][n], out[n] = nu, tr, tr
        return out, new


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """Adafactor's ``(second largest, largest)`` dimensions of a leaf whose
    second largest is at least 128, else None (optax's ``_factored_dims``,
    ties in order).  The factored estimate is the outer product of the row
    and column means over the whole leaf's mean, symmetric in the two: a
    Dense kernel in torch's ``[out, in]`` gives flax's ``[in, out]``
    update transposed."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < 128:
        return None
    return order[-2], order[-1]


class _Adafactor(Rule):
    """``optax.adafactor(lr)`` at its defaults (no decay)."""

    DECAY, EPS, CLIP, MIN_SCALE = 0.8, 1e-30, 1.0, 1e-3

    def __init__(self):
        super().__init__({}, 0.0)

    def init(self, params):
        state = {"v_row": {}, "v_col": {}, "v": {}}
        for n, p in params.items():
            dims = factored_dims(p.shape)
            if dims is None:
                state["v"][n] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"][n] = torch.zeros_like(p.select(d0, 0))
                state["v_col"][n] = torch.zeros_like(p.select(d1, 0))
        return state

    def update(self, grads, state, params, count, lr):
        rate = 1.0 - (count + 1.0) ** -self.DECAY
        new, out = {"v_row": {}, "v_col": {}, "v": {}}, {}
        for n, p in params.items():
            g = grads[n]
            g2 = g * g + self.EPS
            dims = factored_dims(p.shape)
            if dims is None:
                v = rate * state["v"][n] + (1 - rate) * g2
                new["v"][n] = v
                u = g * torch.rsqrt(v)
            else:
                d1, d0 = dims
                vr = rate * state["v_row"][n] + (1 - rate) * g2.mean(d0)
                vc = rate * state["v_col"][n] + (1 - rate) * g2.mean(d1)
                new["v_row"][n], new["v_col"][n] = vr, vc
                row = torch.rsqrt(vr / vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True))
                u = g * row.unsqueeze(d0) * torch.rsqrt(vc).unsqueeze(d1)
            u = u / torch.clamp(_rms(u) / self.CLIP, min=1.0)  # clip_by_block_rms
            scale = _rms(p)  # scale_by_param_block_rms
            scale = torch.where(scale <= self.MIN_SCALE, torch.full_like(scale, self.MIN_SCALE),
                                scale)
            out[n] = -((u * lr) * scale)
        return out, new


class _Lion(Rule):
    """``optax.lion(lr, weight_decay, mask)``: b1 0.9 and b2 0.99, its
    defaults (the factory passes neither)."""

    B1, B2 = 0.9, 0.99

    def init(self, params):
        return {"mu": zeros(params)}

    def update(self, grads, state, params, count, lr):
        new, out = {"mu": {}}, {}
        for n, p in params.items():
            g, m = grads[n], state["mu"][n]
            u = torch.sign((1 - self.B1) * g + self.B1 * m)
            new["mu"][n] = (1 - self.B2) * g + self.B2 * m
            if self.wd(n):
                u = u + self.wd(n) * p
            out[n] = -lr * u
        return out, new


class Optimizer:
    """An update rule with the factory's wrapping: global-norm clipping of
    the gradients before it, the head learning-rate multiplier after it.
    ``init`` makes the state; ``step`` applies one update to the parameters
    in place and returns the next state.  A second-order rule
    (``needs_hessian``) takes the Hessian diagonal's estimate as
    ``hess_diag``."""

    def __init__(self, rule: Rule, schedule: Schedule, head: Dict[str, bool],
                 head_lr_mult: float = 1.0, grad_clip: Optional[float] = None):
        self.rule, self.schedule, self.head = rule, schedule, head
        self.head_lr_mult, self.grad_clip = head_lr_mult, grad_clip
        self.needs_hessian = rule.needs_hessian

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0, **self.rule.init(params)}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: Dict[str, Any],
             hess_diag: Optional[Params] = None) -> Dict[str, Any]:
        if self.needs_hessian != (hess_diag is not None):
            raise ValueError("a second-order optimizer steps with hess_diag, any other without")
        count = state["count"]
        if self.grad_clip:  # where(norm < clip, g, g / norm * clip), on the device
            norm = global_norm(grads.values())
            grads = {n: torch.where(norm < self.grad_clip, g, (g / norm) * self.grad_clip)
                     for n, g in grads.items()}
        extra = {} if hess_diag is None else {"hess_diag": hess_diag}
        updates, new = self.rule.update(grads, state, params, count, self.schedule(count),
                                        **extra)
        for n, p in params.items():
            u = updates[n]
            if self.head_lr_mult != 1.0 and self.head[n]:
                u = self.head_lr_mult * u
            p.add_(u)
        return {"count": count + 1, **new}


def _rule(opt: str, decay: Dict[str, bool], weight_decay: float, b1: float, b2: float,
          eps: float, momentum: float) -> Rule:
    """The update rule the JAX factory builds for ``opt``, with its wiring."""
    from vqattack_tpu_torch.train import adahessian, optim_extra

    if opt in ("adamw", "adam", "lamb"):
        return _Adam(decay, 0.0 if opt == "adam" else weight_decay, b1, b2, eps,
                     trust=opt == "lamb")
    if opt == "sgd":
        return _Sgd(decay, weight_decay, momentum)
    if opt == "rmsprop":
        return _RmsProp(decay, weight_decay, momentum)
    if opt == "adafactor":
        return _Adafactor()
    if opt == "lion":
        return _Lion(decay, weight_decay)
    if opt == "nadam":
        return optim_extra.Nadam(decay, weight_decay, b1, b2, eps)
    if opt == "radam":
        return optim_extra.Radam(decay, weight_decay, b1, b2, eps)
    if opt == "adamp":  # the factory's wd_ratio=0.01, nesterov (optim_factory.py:79-80)
        return optim_extra.AdamP(decay, weight_decay, b1, b2, eps, wd_ratio=0.01)
    if opt == "sgdp":
        return optim_extra.Sgdp(decay, weight_decay, momentum, eps)
    if opt == "novograd":  # decay as labelled: the JAX package's divergence, kept
        return optim_extra.NovoGrad(decay, weight_decay, b1, b2, eps)
    if opt == "nvnovograd":
        return optim_extra.NvNovoGrad(decay, weight_decay, b1, b2, eps)
    if opt == "rmsproptf":  # alpha 0.9 and the momentum (optim_factory.py:93-94)
        return optim_extra.RmsPropTF(decay, weight_decay, eps, momentum)
    if opt == "adahessian":
        return adahessian.AdaHessian(decay, weight_decay, b1, b2, eps)
    raise ValueError(f"unknown optimizer {opt!r}; the factory takes {OPTIMIZERS} and a "
                     f"lookahead_ prefix")


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
):
    """The factory (``optim_factory.create_optimizer`` surface): masked decay,
    optional head lr multiplier, optional global-norm clipping.  A
    ``lookahead_`` prefix wraps the base optimizer, built with the same
    multiplier and clipping (``optim_factory.py:119-121``), except around
    AdaHessian: the wrapper would step it without its Hessian diagonal,
    where the JAX factory's fails at the first step."""
    if opt.startswith("lookahead_"):
        from vqattack_tpu_torch.train.optim_extra import Lookahead

        base = opt[len("lookahead_"):]
        if base == "adahessian":
            raise ValueError("lookahead_adahessian: the lookahead wrapper steps its base "
                             "optimizer without a Hessian diagonal; use adahessian")
        return Lookahead(create_optimizer(
            model, base, schedule, weight_decay, b1, b2, eps, momentum, head_lr_mult,
            head_names, grad_clip))
    if not callable(schedule):
        lr = float(schedule)
        schedule = lambda count: lr  # noqa: E731
    rule = _rule(opt, decay_mask(model), weight_decay, b1, b2, eps, momentum)
    return Optimizer(rule, schedule, head_mask(model, head_names), head_lr_mult, grad_clip)


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters an optimizer updates, by the names of its masks."""
    return {name: p for name, _, _, p in flax_leaves(model)}
