"""PGD attack loops.

Port of ``vqattack_tpu/attacks/pgd.py``.  The JAX package compiles each
loop into one XLA program (``lax.scan``/``fori_loop``, and the fused
per-block programs).  PyTorch runs eagerly, so each is one Python loop; the
step semantics are the reference's (``projected_gradient_descent.py:106-189``):

- :func:`pgd_feature` (``ls==1``): one feature-loss step per iteration, each
  followed by the eps-ball projection and clamp;
- :func:`pgd_alternating` (``ls==0``): a feature step that only clamps, then
  an MLM step, then projection and clamp;
- :func:`pgd_vl_step`: one joint image + text-embedding step that updates the
  image and returns the text-embedding gradient at ``positions``;
- :func:`pgd_feature_block` / :func:`pgd_alternating_block`: one block of
  the per-sample schedule under the contract ``tests/test_pgd_fused.py``
  pins for the JAX fused programs: clean targets computed on block 0,
  rand-init only on the first block, the VL step at the end of every block
  but the last, and on the last block a zero text gradient.

Loss functions are ``loss_fn(adv_x, key, aux) -> (scalar, per_sample [B])``;
``key`` is an ``rng.py`` key, split exactly as the JAX code splits its keys.
The L-inf update (:func:`_update`) is kernel K1 on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from vqattack_tpu_torch.attacks.norms import LINF, clip_eta, optimize_linear
from vqattack_tpu_torch.ops.pgd_update import pgd_linf_update

LossFn = Callable[[torch.Tensor, Any, Any], Tuple[torch.Tensor, torch.Tensor]]


def rand_init_eta(key, shape: Sequence[int], eps: float, norm: str = LINF,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform(+/-eps) start perturbation, projected to the ball."""
    return clip_eta(key.uniform(shape, -eps, eps, dtype), norm, eps)


def _project(adv, ori, eps, norm, clip_min, clip_max):
    return torch.clamp(ori + clip_eta(adv - ori, norm, eps), clip_min, clip_max)


def _update(adv, grad, ori, eps, eps_iter, norm, clip_min, clip_max):
    """sign step + clamp + ball projection + clamp: kernel K1 for L-inf (its
    wrapper runs the plain version for a CPU tensor), plain for L2."""
    if norm == LINF:
        return pgd_linf_update(adv, grad, ori, eps, eps_iter, clip_min, clip_max)
    adv = torch.clamp(adv + optimize_linear(grad, eps_iter, norm), clip_min, clip_max)
    return _project(adv, ori, eps, norm, clip_min, clip_max)


def _value_and_grad(loss_fn: LossFn, adv: torch.Tensor, key, aux):
    """(per-sample loss, d loss / d adv) with autograd."""
    x = adv.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, per_sample = loss_fn(x, key, aux)
        (g,) = torch.autograd.grad(loss, x)
    return per_sample.detach(), g


def _start(x, key, eps, norm, rand_init, clip_min, clip_max):
    init_key, scan_key = key.split(2)
    if rand_init:
        x = torch.clamp(x + rand_init_eta(init_key, x.shape, eps, norm, x.dtype),
                        clip_min, clip_max)
    return x, scan_key


def pgd_feature(
    loss_fn: LossFn,
    x: torch.Tensor,
    ori_x: torch.Tensor,
    key,
    aux: Any = None,
    eps: float = 0.125,
    eps_iter: float = 0.01,
    nb_iter: int = 40,
    clip_min: float = -1.0,
    clip_max: float = 1.0,
    norm: str = LINF,
    rand_init: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feature-loss PGD (``ls==1``).  Returns ``(adv_x, losses [T, B])``."""
    adv, scan_key = _start(x, key, eps, norm, rand_init, clip_min, clip_max)
    losses = []
    for k in scan_key.split(nb_iter):
        per_sample, g = _value_and_grad(loss_fn, adv, k, aux)
        adv = _update(adv, g, ori_x, eps, eps_iter, norm, clip_min, clip_max)
        losses.append(per_sample)
    return adv, _stack(losses, x)


def pgd_alternating(
    feature_loss_fn: LossFn,
    mlm_loss_fn: LossFn,
    x: torch.Tensor,
    ori_x: torch.Tensor,
    key,
    aux: Any = None,
    eps: float = 0.125,
    eps_iter: float = 0.01,
    nb_iter: int = 20,
    clip_min: float = -1.0,
    clip_max: float = 1.0,
    norm: str = LINF,
    rand_init: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alternating feature + MAR PGD (``ls==0``, ``pgd:153-189``).  Returns
    ``(adv_x, feat_losses [T, B], mlm_losses [T, B])``."""
    adv, scan_key = _start(x, key, eps, norm, rand_init, clip_min, clip_max)
    feat_l, mlm_l = [], []
    for k in scan_key.split(nb_iter):
        k1, k2 = k.split(2)
        feat_ps, g1 = _value_and_grad(feature_loss_fn, adv, k1, aux)
        # the reference does not project between the pair: clamp only
        adv = torch.clamp(adv + optimize_linear(g1, eps_iter, norm), clip_min, clip_max)
        mlm_ps, g2 = _value_and_grad(mlm_loss_fn, adv, k2, aux)
        adv = _update(adv, g2, ori_x, eps, eps_iter, norm, clip_min, clip_max)
        feat_l.append(feat_ps)
        mlm_l.append(mlm_ps)
    return adv, _stack(feat_l, x), _stack(mlm_l, x)


def _stack(rows, x):
    if rows:
        return torch.stack(rows)
    return torch.zeros((0, x.shape[0]), dtype=torch.float32, device=x.device)


def pgd_vl_step(
    vl_loss_fn,
    image: torch.Tensor,
    text_embeds: torch.Tensor,
    ori_x: torch.Tensor,
    positions: torch.Tensor,
    key,
    aux: Any = None,
    eps: float = 0.125,
    eps_iter: float = 0.01,
    clip_min: float = -1.0,
    clip_max: float = 1.0,
    norm: str = LINF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One joint image + text-embedding step (``fgm_vl:96-130``).

    ``positions [B, P]``: sub-token indices of the substitutable words.
    Returns ``(adv_image, text_grad [B, P, D])``; the text embeddings are not
    perturbed, only their gradient is harvested."""
    img = image.detach().requires_grad_(True)
    emb = text_embeds.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, _ = vl_loss_fn(img, emb, key, aux)
        g_img, g_emb = torch.autograd.grad(loss, (img, emb))
    adv = _update(image, g_img, ori_x, eps, eps_iter, norm, clip_min, clip_max)
    idx = positions[:, :, None].expand(-1, -1, g_emb.shape[-1])
    return adv, torch.gather(g_emb, 1, idx)


def _block_common(targets_fn, target_keys, ori_x, tgt_key, aux, nb_iter, max_iter):
    if nb_iter > max_iter:
        raise ValueError(f"nb_iter={nb_iter} exceeds max_iter={max_iter}")
    if targets_fn is not None:
        tgts = targets_fn(ori_x, tgt_key, aux)
        aux = {**aux, **{k: tgts[k] for k in target_keys}}
    return aux


def _maybe_vl(vl_loss_fn, embed_fn, adv, ori_x, positions, vl_key, aux, do_vl,
              eps, eps_iter, norm, clip_min, clip_max):
    """The VL step at a block's end; a zero text gradient when ``do_vl`` is
    False (a sample's last block)."""
    embeds = embed_fn(aux["text_ids"])
    if not do_vl:
        return adv, torch.zeros((positions.shape[0], positions.shape[1], embeds.shape[-1]),
                                dtype=torch.float32, device=adv.device)
    adv, tg = pgd_vl_step(vl_loss_fn, adv, embeds, ori_x, positions, vl_key, aux,
                          eps=eps, eps_iter=eps_iter, clip_min=clip_min,
                          clip_max=clip_max, norm=norm)
    return adv, tg.float()


def pgd_feature_block(
    loss_fn: LossFn,
    vl_loss_fn,
    embed_fn,
    targets_fn: Optional[Callable[[torch.Tensor, Any, Dict], Dict[str, torch.Tensor]]],
    x: torch.Tensor,
    ori_x: torch.Tensor,
    key,
    vl_key,
    tgt_key,
    nb_iter: int,
    rand_init: bool,
    do_vl: bool,
    positions: torch.Tensor,
    aux: Dict[str, Any],
    target_keys: Tuple[str, ...],
    eps: float = 0.125,
    eps_iter: float = 0.01,
    max_iter: int = 40,
    clip_min: float = -1.0,
    clip_max: float = 1.0,
    norm: str = LINF,
):
    """One feature-PGD block: [clean targets] + ``nb_iter`` steps + [VL step].

    ``targets_fn(ori_x, key, aux)`` (first block only) computes the clean
    targets from ``aux["ori_ids"]``/``aux["ori_mask"]``; later blocks find them
    in ``aux``.  Returns ``(adv, losses [nb_iter, B], text_grad, targets)``."""
    aux = _block_common(targets_fn, target_keys, ori_x, tgt_key, aux, nb_iter, max_iter)
    adv, losses = pgd_feature(loss_fn, x, ori_x, key, aux, eps=eps, eps_iter=eps_iter,
                              nb_iter=nb_iter, clip_min=clip_min, clip_max=clip_max,
                              norm=norm, rand_init=rand_init)
    adv, text_grad = _maybe_vl(vl_loss_fn, embed_fn, adv, ori_x, positions, vl_key, aux,
                               do_vl, eps, eps_iter, norm, clip_min, clip_max)
    return adv, losses, text_grad, tuple(aux[k] for k in target_keys)


def pgd_alternating_block(
    feature_loss_fn: LossFn,
    mlm_loss_fn: LossFn,
    vl_loss_fn,
    embed_fn,
    targets_fn,
    x: torch.Tensor,
    ori_x: torch.Tensor,
    key,
    vl_key,
    tgt_key,
    nb_iter: int,
    rand_init: bool,
    do_vl: bool,
    positions: torch.Tensor,
    aux: Dict[str, Any],
    target_keys: Tuple[str, ...],
    eps: float = 0.125,
    eps_iter: float = 0.01,
    max_iter: int = 20,
    clip_min: float = -1.0,
    clip_max: float = 1.0,
    norm: str = LINF,
):
    """:func:`pgd_feature_block` for the alternating (MAR) algorithm; returns
    ``(adv, feat_losses, mlm_losses, text_grad, targets)``."""
    aux = _block_common(targets_fn, target_keys, ori_x, tgt_key, aux, nb_iter, max_iter)
    adv, feat_l, mlm_l = pgd_alternating(
        feature_loss_fn, mlm_loss_fn, x, ori_x, key, aux, eps=eps, eps_iter=eps_iter,
        nb_iter=nb_iter, clip_min=clip_min, clip_max=clip_max, norm=norm,
        rand_init=rand_init)
    adv, text_grad = _maybe_vl(vl_loss_fn, embed_fn, adv, ori_x, positions, vl_key, aux,
                               do_vl, eps, eps_iter, norm, clip_min, clip_max)
    return adv, feat_l, mlm_l, text_grad, tuple(aux[k] for k in target_keys)
