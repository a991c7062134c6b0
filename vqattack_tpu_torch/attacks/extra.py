"""The attack zoo over a classifier: FGM, PGD, MIM, SPSA, semantic, noise and
Carlini-Wagner L2.

Port of ``vqattack_tpu/attacks/extra.py`` (the vendored cleverhans surface).
Each attack takes ``logits_fn(px) -> [B, C]`` and steps in plain tensor code,
as the JAX package does: none of them goes through the L-inf update K1, but
every forward and backward of ``logits_fn`` runs the model's own kernels.
Randomness comes from an ``rng.py`` key, drawn in the JAX package's order.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from vqattack_tpu_torch.attacks.norms import LINF, clip_eta, optimize_linear
from vqattack_tpu_torch.attacks.pgd import rand_init_eta

LogitsFn = Callable[[torch.Tensor], torch.Tensor]

# SPSA's draws a ``logits_fn`` call: 2 * SPSA_CHUNK perturbed copies of the
# batch go through the model at once (at B 2 and 941 tokens, K3 at batch 32).
SPSA_CHUNK = 8


def _ce_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.gather(torch.log_softmax(logits, dim=-1), 1, y[:, None])[:, 0]


def _one_hot(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    return F.one_hot(y, n_classes).to(torch.float32)


def _ce_grad(logits_fn: LogitsFn, px: torch.Tensor, y: torch.Tensor,
             targeted: bool) -> torch.Tensor:
    """d(sum CE)/d px, negated for a targeted attack."""
    x = px.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = torch.sum(_ce_loss(logits_fn(x), y))
        (g,) = torch.autograd.grad(-loss if targeted else loss, x)
    return g


def _ball(adv, x, eps, clip_min, clip_max):
    """L-inf projection onto the eps-ball around ``x``, then the box."""
    return torch.clamp(x + torch.clamp(adv - x, -eps, eps), clip_min, clip_max)


def fgm_classifier(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor,
                   eps: float = 0.3, norm: str = LINF, clip_min: float = -1.0,
                   clip_max: float = 1.0, targeted: bool = False) -> torch.Tensor:
    """One cross-entropy steepest-ascent step of norm ``eps``."""
    g = _ce_grad(logits_fn, x, y, targeted)
    return torch.clamp(x + optimize_linear(g, eps, norm), clip_min, clip_max)


def pgd_classifier(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor, key,
                   eps: float = 0.3, eps_iter: float = 0.01, nb_iter: int = 40,
                   norm: str = LINF, clip_min: float = -1.0, clip_max: float = 1.0,
                   targeted: bool = False) -> torch.Tensor:
    """Rand-init (from ``key``) and ``nb_iter`` FGM steps, each followed by
    the ball projection and the box."""
    adv = torch.clamp(x + rand_init_eta(key, x.shape, eps, norm, x.dtype), clip_min, clip_max)
    for _ in range(nb_iter):
        g = _ce_grad(logits_fn, adv, y, targeted)
        adv = torch.clamp(adv + optimize_linear(g, eps_iter, norm), clip_min, clip_max)
        adv = torch.clamp(x + clip_eta(adv - x, norm, eps), clip_min, clip_max)
    return adv


def momentum_iterative_method(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor,
                              eps: float = 0.3, eps_iter: float = 0.06, nb_iter: int = 10,
                              decay: float = 1.0, clip_min: float = -1.0,
                              clip_max: float = 1.0, targeted: bool = False) -> torch.Tensor:
    """MIM: the gradient over its per-sample mean |g| accumulates with
    ``decay``; sign steps follow the momentum."""
    axes = tuple(range(1, x.dim()))
    adv, m = x, torch.zeros_like(x)
    for _ in range(nb_iter):
        g = _ce_grad(logits_fn, adv, y, targeted)
        g = g / torch.clamp(torch.mean(torch.abs(g), dim=axes, keepdim=True), min=1e-12)
        m = decay * m + g
        adv = torch.clamp(adv + eps_iter * torch.sign(m), clip_min, clip_max)
        adv = _ball(adv, x, eps, clip_min, clip_max)
    return adv


def _margin(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The true class's logit less the best other one (``one_hot * 1e9``
    taken away in float32), ``[N]``."""
    real = torch.gather(logits, 1, y[:, None])[:, 0]
    other = torch.amax(logits - _one_hot(y, logits.shape[-1]) * 1e9, dim=-1)
    return real - other


@torch.no_grad()
def spsa(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor, key, eps: float = 0.3,
         nb_iter: int = 40, spsa_samples: int = 32, lr: float = 0.01, delta: float = 0.01,
         clip_min: float = -1.0, clip_max: float = 1.0) -> torch.Tensor:
    """Gradient-free SPSA: antithetic Rademacher draws estimate the margin's
    gradient; a sign step descends it, then the ball and the box.

    ``key.split(nb_iter)`` gives each step a key, split again into one key
    a draw.  ``SPSA_CHUNK`` draws go through ``logits_fn`` in one call:
    their ``2 * SPSA_CHUNK`` perturbed copies of the batch stacked along the
    batch axis (``logits_fn`` must take any number of rows).  The estimate is the
    mean over the draws, added in draw order."""
    b = x.shape[0]
    bshape = (b,) + (1,) * (x.dim() - 1)
    adv = x
    for step_key in key.split(nb_iter):
        g = torch.zeros_like(adv)
        draws = step_key.split(spsa_samples)
        for c0 in range(0, spsa_samples, SPSA_CHUNK):
            vs = [k.rademacher(adv.shape, adv.dtype).to(adv.device)
                  for k in draws[c0:c0 + SPSA_CHUNK]]
            n = len(vs)
            v = torch.cat(vs)  # [n * B, ...]
            px = torch.cat([torch.clamp(adv.repeat(n, *(1,) * (x.dim() - 1)) + s * delta * v,
                                        clip_min, clip_max) for s in (1, -1)])
            m = _margin(logits_fn(px), y.repeat(2 * n))
            est = ((m[:n * b] - m[n * b:]) / (2 * delta)).reshape((n,) + bshape) \
                * v.reshape((n,) + tuple(x.shape))
            for e in est:
                g = g + e
        g = g / spsa_samples
        adv = torch.clamp(adv - lr * torch.sign(g), clip_min, clip_max)  # descend the margin
        adv = _ball(adv, x, eps, clip_min, clip_max)
    return adv


def semantic(x: torch.Tensor, center: bool = True, max_val: float = 1.0) -> torch.Tensor:
    """Negated pixels: ``-x`` when centred, else ``max_val - x``."""
    return -x if center else max_val - x


def noise(x: torch.Tensor, key, eps: float = 0.3, clip_min: float = -1.0,
          clip_max: float = 1.0) -> torch.Tensor:
    """Uniform(+/-eps) noise, then the box: the baseline 'attack'."""
    eta = key.uniform(x.shape, -eps, eps, x.dtype).to(x.device)
    return torch.clamp(x + eta, clip_min, clip_max)


def carlini_wagner_l2(loss_grad_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor,
                      n_classes: int, key=None, **kw) -> torch.Tensor:
    """Carlini-Wagner L2 (:func:`cw_l2_search`'s adversarial images).
    ``key`` is unused, as in the JAX package."""
    return cw_l2_search(loss_grad_fn, x, y, n_classes, **kw)[0]


def cw_l2_search(loss_grad_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor, n_classes: int,
                 max_iterations: int = 100, binary_search_steps: int = 5,
                 initial_const: float = 1e-2, confidence: float = 0.0, lr: float = 5e-3,
                 clip_min: float = -1.0, clip_max: float = 1.0,
                 targeted: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carlini-Wagner L2: Adam in tanh space for ``max_iterations`` steps at
    each of ``binary_search_steps`` values of the constant; a sample's
    result is its lowest-L2 success (``f <= 0``), else the clipped input.

    The constant halves towards ``lo`` after a success and grows tenfold
    while no success has bounded it (``hi >= 1e9``).  Adam's step counter
    is float32 (``0.9 ** t``).  Returns ``(best_adv, best_l2 [B], margins
    [binary_search_steps, B])``: ``best_l2`` infinite where no search step
    succeeded, ``margins`` the objective's ``z`` (``f = max(z, 0)``, success
    ``z <= 0``) at each search step's final iterate."""
    b = x.shape[0]
    dev = x.device
    axes = tuple(range(1, x.dim()))
    bshape = (b,) + (1,) * (x.dim() - 1)
    x_clip = torch.clamp(x, clip_min, clip_max)
    scaled = torch.clamp((x_clip - clip_min) / (clip_max - clip_min), 1e-6, 1 - 1e-6)
    x_tanh = torch.atanh(scaled * 2 - 1)
    y_onehot = _one_hot(y, n_classes)

    def objective(w, const):
        adv = (torch.tanh(w) + 1) / 2 * (clip_max - clip_min) + clip_min
        logits = loss_grad_fn(adv)
        real = torch.sum(y_onehot * logits, dim=-1)
        other = torch.amax(logits - y_onehot * 1e9, dim=-1)
        z = (other - real if targeted else real - other) + confidence
        f = torch.maximum(z, torch.zeros((), dtype=z.dtype, device=dev))
        l2 = torch.sum((adv - x_clip) ** 2, dim=axes)
        return torch.sum(l2 + const * f), l2, z, adv

    lo = torch.zeros(b, device=dev)
    hi = torch.full((b,), 1e10, device=dev)
    const = torch.full((b,), initial_const, device=dev)
    best_adv = x_clip
    best_l2 = torch.full((b,), float("inf"), device=dev)
    margins = []
    for _ in range(binary_search_steps):
        w, m, v = x_tanh, torch.zeros_like(x), torch.zeros_like(x)
        t = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(max_iterations):
            wg = w.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(objective(wg, const)[0], wg)
            t = t + 1
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1 - 0.9 ** t)
            vh = v / (1 - 0.999 ** t)
            w = w - lr * mh / (torch.sqrt(vh) + 1e-8)
        with torch.no_grad():
            _, l2, z, adv = objective(w, const)
        margins.append(z)
        success = z <= 0.0  # f = max(z, 0) <= 0
        improved = success & (l2 < best_l2)
        best_adv = torch.where(improved.reshape(bshape), adv, best_adv)
        best_l2 = torch.where(improved, l2, best_l2)
        hi = torch.where(success, torch.minimum(hi, const), hi)
        lo = torch.where(success, lo, torch.maximum(lo, const))
        const = torch.where(hi < 1e9, (lo + hi) / 2, const * 10)
    return best_adv, best_l2, torch.stack(margins)
