"""The tail of the reference's vendored timm optimizer zoo, and the
lookahead wrapper, as update rules of ``train/optim.py``.

Port of ``vqattack_tpu/train/optim_extra.py`` (``ALBEF_attack/optim/``:
``nadam.py``, ``radam.py``, ``adamp.py``, ``sgdp.py``, ``novograd.py``,
``nvnovograd.py``, ``rmsprop_tf.py``, ``lookahead.py``), with the wiring
``optim_factory.create_optimizer:66-123`` gives each.  Weight decay is
coupled (folded into the update as the torch classes fold it), on the
leaves the factory's no-decay split leaves decayed (``Rule.wd``).  The
scalars that depend only on the step count (bias corrections, Nadam's momentum
schedule, RAdam's rectification and its branch, NovoGrad's first step)
are taken on the host in float64, as the reference takes them in Python;
each leaf's own conditions stay on the device.

AdamP and SGDP decide their projection on a channel view of the
parameter, ``p.reshape(p.shape[0], -1)``: here on the parameter in torch's
layout, each row an output channel, as the reference's torch classes view
it.  The JAX package applies the same view to flax's layout, where the
first axis of a Dense kernel is its input and of a conv kernel its height
(ROADMAP, reference-side divergences).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from vqattack_tpu_torch.train.optim import Params, Rule, zeros


class Nadam(Rule):
    """Nadam with the warming momentum schedule (``optim/nadam.py:35-90``);
    coupled L2 (``grad += wd * p``, ``:69-70``).  The schedule's product
    is a number of the state (``m_schedule``)."""

    SCHEDULE_DECAY = 4e-3

    def __init__(self, decay, weight_decay, b1, b2, eps):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"m_schedule": 1.0, "mu": zeros(params), "nu": zeros(params)}

    def update(self, grads, state, params, count, lr):
        b1, b2, t = self.b1, self.b2, count + 1
        mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self.SCHEDULE_DECAY))
        mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.SCHEDULE_DECAY))
        msch = state["m_schedule"] * mu_t
        c_g = -lr * (1.0 - mu_t) / (1.0 - msch)
        c_m = -lr * mu_t1 / (1.0 - msch * mu_t1)
        bc2 = 1.0 - b2 ** t
        new, out = {"m_schedule": msch, "mu": {}, "nu": {}}, {}
        for n, p in params.items():
            g = grads[n] + self.wd(n) * p if self.wd(n) else grads[n]
            m = b1 * state["mu"][n] + (1.0 - b1) * g
            v = b2 * state["nu"][n] + (1.0 - b2) * g * g
            denom = torch.sqrt(v / bc2) + self.eps
            new["mu"][n], new["nu"][n] = m, v
            out[n] = c_g * g / denom + c_m * m / denom
        return out, new


class Radam(Rule):
    """RAdam (``optim/radam.py:12-88``): the rectified step when the SMA
    length N >= 5, the plain momentum step before; N in float64 as the
    reference's Python takes it (``:131``); coupled decay ``- wd lr p``
    (``:76-77``)."""

    def __init__(self, decay, weight_decay, b1, b2, eps):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, grads, state, params, count, lr):
        b1, b2, t = self.b1, self.b2, count + 1
        b2t = b2 ** t
        n_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_max - 2.0 * t * b2t / (1.0 - b2t)
        rect = n_sma >= 5.0
        step = lr / (1.0 - b1 ** t)
        if rect:
            step *= math.sqrt((1.0 - b2t) * (n_sma - 4.0) / (n_max - 4.0) * (n_sma - 2.0)
                              / n_sma * n_max / (n_max - 2.0))
        new, out = {"mu": {}, "nu": {}}, {}
        for n, p in params.items():
            g = grads[n]
            v = b2 * state["nu"][n] + (1.0 - b2) * g * g
            m = b1 * state["mu"][n] + (1.0 - b1) * g
            new["mu"][n], new["nu"][n] = m, v
            u = -step * m / (torch.sqrt(v) + self.eps) if rect else -step * m
            out[n] = u - self.wd(n) * lr * p if self.wd(n) else u
        return out, new


def _row_cos(x: torch.Tensor, y: torch.Tensor, eps: float) -> torch.Tensor:
    """``|<x_i, y_i>| / (|x_i| + eps) / (|y_i| + eps)`` for each row i."""
    xn = torch.linalg.vector_norm(x, dim=1) + eps
    yn = torch.linalg.vector_norm(y, dim=1) + eps
    return (x * y).sum(1).abs() / xn / yn


def projection(p: torch.Tensor, grad: torch.Tensor, perturb: torch.Tensor, delta: float,
               wd_ratio: float, eps: float):
    """AdamP/SGDP's projection (``optim/adamp.py:28-53``): where the gradient
    is near-orthogonal to the parameter in every output channel (then, if
    not, over the whole layer), the update loses its component along the
    parameter and the decay shrinks by ``wd_ratio``.  Returns ``(perturb,
    wd scale)``; the choice is made on the device."""
    rows = p.shape[0]
    expand = (-1,) + (1,) * (p.ndim - 1)
    p_ch = p.reshape(rows, -1)
    cond_ch = _row_cos(grad.reshape(rows, -1), p_ch, eps).max() < delta / math.sqrt(
        p_ch.shape[1])
    p_n = p / (torch.linalg.vector_norm(p_ch, dim=1).reshape(expand) + eps)
    pert_ch = perturb - p_n * (p_n * perturb).reshape(rows, -1).sum(1).reshape(expand)
    cond_l = _row_cos(grad.reshape(1, -1), p.reshape(1, -1), eps).max() < delta / math.sqrt(
        p.numel())
    p_n = p / (torch.linalg.vector_norm(p) + eps)
    pert_l = perturb - p_n * (p_n * perturb).sum()
    # the reference tries the channel view first and stops at a match
    out = torch.where(cond_ch, pert_ch, torch.where(cond_l, pert_l, perturb))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    return out, torch.where(cond_ch | cond_l, wd_ratio * one, one)


DELTA = 0.1  # the projection's threshold (adamp.py, sgdp.py)


class AdamP(Rule):
    """AdamP (``optim/adamp.py:56-107``) with Nesterov momentum, as the
    factory builds it (``optim_factory.py:79-80``)."""

    def __init__(self, decay, weight_decay, b1, b2, eps, wd_ratio):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps, self.wd_ratio = b1, b2, eps, wd_ratio

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, grads, state, params, count, lr):
        b1, b2, t = self.b1, self.b2, count + 1
        step, sqrt_bc2 = lr / (1.0 - b1 ** t), math.sqrt(1.0 - b2 ** t)
        new, out = {"mu": {}, "nu": {}}, {}
        for n, p in params.items():
            g = grads[n]
            m = b1 * state["mu"][n] + (1.0 - b1) * g
            v = b2 * state["nu"][n] + (1.0 - b2) * g * g
            new["mu"][n], new["nu"][n] = m, v
            perturb = (b1 * m + (1.0 - b1) * g) / (torch.sqrt(v) / sqrt_bc2 + self.eps)
            wd_scale = 1.0
            if p.ndim > 1:
                perturb, wd_scale = projection(p, g, perturb, DELTA, self.wd_ratio, self.eps)
            u = -step * perturb
            out[n] = -lr * self.wd(n) * wd_scale * p + u if self.wd(n) else u
        return out, new


class Sgdp(Rule):
    """SGDP (``optim/sgdp.py:57-97``) with Nesterov momentum, no dampening
    and ``wd_ratio`` 0.1, as the factory builds it (``optim_factory.py:81-82``);
    decay scaled by ``1 / (1 - momentum)`` (``:92-93``)."""

    WD_RATIO = 0.1

    def __init__(self, decay, weight_decay, momentum, eps):
        super().__init__(decay, weight_decay)
        self.momentum, self.eps = momentum, eps

    def init(self, params):
        return {"buf": zeros(params)}

    def update(self, grads, state, params, count, lr):
        mom = self.momentum
        new, out = {"buf": {}}, {}
        for n, p in params.items():
            g = grads[n]
            buf = mom * state["buf"][n] + g
            new["buf"][n] = buf
            d_p = g + mom * buf
            wd_scale = 1.0
            if p.ndim > 1:
                d_p, wd_scale = projection(p, g, d_p, DELTA, self.WD_RATIO, self.eps)
            u = -lr * d_p
            out[n] = -lr * self.wd(n) * wd_scale / (1.0 - mom) * p + u if self.wd(n) else u
        return out, new


class NovoGrad(Rule):
    """Convergence-Lab NovoGrad (``optim/novograd.py:12-77``): a per-leaf
    second moment of the EMA-normalised gradient; the first step seeds the
    moments from the first gradient (``:30-46``).  The decay works as
    labelled, as in the JAX package, where the reference's reads a
    coefficient the factory leaves at 0."""

    def __init__(self, decay, weight_decay, b1, b2, eps):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        scalar = {n: torch.zeros((), dtype=torch.float32, device=p.device)
                  for n, p in params.items()}
        return {"v": scalar, "m": zeros(params), "grad_ema": dict(scalar)}

    def update(self, grads, state, params, count, lr):
        b1, b2, eps, t = self.b1, self.b2, self.eps, count + 1
        step = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        new, out = {"v": {}, "m": {}, "grad_ema": {}}, {}
        for n, p in params.items():
            g, w = grads[n], self.wd(n)
            g2 = torch.sum(g * g)
            if count == 0:  # the reference's first pass (novograd.py:33-46)
                v, m, ema = g2, g / (torch.sqrt(g2) + eps) + w * p, g2
            else:
                v, m = state["v"][n], state["m"][n]
                ema = b2 * state["grad_ema"][n] + (1.0 - b2) * g2
            gn = g / (torch.sqrt(ema) + eps)
            v = b2 * v + (1.0 - b2) * torch.sum(gn * gn)
            m = b1 * m + (gn / (torch.sqrt(v) + eps) + w * p)
            new["v"][n], new["m"][n], new["grad_ema"][n] = v, m, ema
            out[n] = -step * m
        return out, new


class NvNovoGrad(Rule):
    """NVIDIA's NovoGrad (``optim/nvnovograd.py:13-118``): a scalar second
    moment a leaf, seeded with the first ``|g|^2`` while it is 0
    (``:96-99``), coupled decay added to the normalised gradient
    (``:110-111``)."""

    def __init__(self, decay, weight_decay, b1, b2, eps):
        super().__init__(decay, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"m": zeros(params),
                "sq": {n: torch.zeros((), dtype=torch.float32, device=p.device)
                       for n, p in params.items()}}

    def update(self, grads, state, params, count, lr):
        b1, b2 = self.b1, self.b2
        new, out = {"m": {}, "sq": {}}, {}
        for n, p in params.items():
            g, sq = grads[n], state["sq"][n]
            norm = torch.sum(g * g)
            sq = torch.where(sq == 0.0, norm, b2 * sq + (1.0 - b2) * norm)
            gn = g / (torch.sqrt(sq) + self.eps)
            if self.wd(n):
                gn = gn + self.wd(n) * p
            m = b1 * state["m"][n] + gn
            new["m"][n], new["sq"][n], out[n] = m, sq, -lr * m
        return out, new


class RmsPropTF(Rule):
    """timm's RMSpropTF (``optim/rmsprop_tf.py:14-141``) as the factory
    builds it: ``alpha`` 0.9, eps inside the square root, the square
    average starting at ones, coupled decay, the learning rate folded into
    the momentum buffer (TF's semantics)."""

    ALPHA = 0.9

    def __init__(self, decay, weight_decay, eps, momentum):
        super().__init__(decay, weight_decay)
        self.eps, self.momentum = eps, momentum

    def init(self, params):
        return {"sq": {n: torch.ones_like(p) for n, p in params.items()},
                "buf": zeros(params)}

    def update(self, grads, state, params, count, lr):
        new, out = {"sq": {}, "buf": {}}, {}
        for n, p in params.items():
            g = grads[n] + self.wd(n) * p if self.wd(n) else grads[n]
            sq = state["sq"][n]
            sq = sq + (1.0 - self.ALPHA) * (g * g - sq)
            avg = torch.sqrt(sq + self.eps)
            if self.momentum > 0.0:
                buf = self.momentum * state["buf"][n] + lr * g / avg
                u = -buf
            else:
                buf, u = state["buf"][n], -lr * g / avg
            new["sq"][n], new["buf"][n], out[n] = sq, buf, u
        return out, new


class Lookahead:
    """The lookahead wrapper (``optim/lookahead.py:12-53``) around a
    ``train/optim.py::Optimizer``: every ``k`` steps of it, the slow weights
    move ``alpha`` of the way to the fast ones and the parameters take
    them.  The reference creates the slow weights at the first sync, so
    that sync only copies the fast weights; the state's copy starts as the
    parameters and the first sync overwrites it the same way."""

    ALPHA, K = 0.5, 6

    def __init__(self, inner):
        self.inner = inner
        self.needs_hessian = inner.needs_hessian

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0, "inner": self.inner.init(params),
                "slow": {n: p.detach().clone() for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: Dict[str, Any],
             hess_diag=None) -> Dict[str, Any]:
        inner = self.inner.step(params, grads, state["inner"], hess_diag)
        count = state["count"] + 1
        slow = state["slow"]
        if count % self.K == 0:
            first = count == self.K
            slow = {}
            for n, p in params.items():
                s = p.clone() if first else state["slow"][n] + self.ALPHA * (
                    p - state["slow"][n])
                p.copy_(s)
                slow[n] = s
        return {"count": count, "inner": inner, "slow": slow}
