"""The port's attack zoo and multi-restart PGD against the JAX package's.

Norms and whole-batch losses; the seven attacks of ``attacks/extra.py`` on
a linear classifier (the JAX draws injected through ``JaxKey``); FGM and
PGD on a tiny VLMo-VQA victim; ``pgd_multi_restart`` on the tiny ALBEF
surrogate and its ranking semantics.  The models' weights are synthetic
state dicts in the reference's names through the JAX package's converters,
so no JAX initialisation compiles."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import JaxKey, nchw, nhwc, shallow_albef, tiny_configs
from vqattack_tpu.attacks import albef as jalbef
from vqattack_tpu.attacks import extra as jextra
from vqattack_tpu.attacks import losses as jlosses
from vqattack_tpu.attacks import norms as jnorms
from vqattack_tpu.attacks import pgd as jpgd
from vqattack_tpu.checkpoint.convert import convert_albef_pretrain as jconvert_albef
from vqattack_tpu.checkpoint.convert import convert_vlmo as jconvert_vlmo
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu_torch import attacks as tattacks
from vqattack_tpu_torch.attacks import albef as talbef
from vqattack_tpu_torch.attacks import extra as textra
from vqattack_tpu_torch.attacks import losses as tlosses
from vqattack_tpu_torch.attacks import norms as tnorms
from vqattack_tpu_torch.attacks import pgd as tpgd
from vqattack_tpu_torch.checkpoint import synthetic
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.checkpoint.io import VLMO_OPTIONAL_HEADS
from vqattack_tpu_torch.models.albef import AlbefPretrain
from vqattack_tpu_torch.models.vlmo import VLMo

T = torch.from_numpy


# ---------------------------------------------------------------------------
# norms and whole-batch losses
# ---------------------------------------------------------------------------


def test_l1_step_and_clipped_grads_match_jax():
    """L1 ``optimize_linear`` with ties (every component at the largest
    |g| shares eps; an all-zero sample has every component tied, sign 0),
    ``zero_out_clipped_grads`` on the box's faces and
    ``get_or_guess_labels``, at rtol 1e-6."""
    rng = np.random.default_rng(1)
    g = rng.normal(size=(3, 3, 4, 4)).astype(np.float32)
    g[0, 0, 0, :2] = [5.0, -5.0]  # a two-way tie at the maximum
    g[1] = 0.0
    np.testing.assert_allclose(tnorms.optimize_linear(T(g), 0.5, "l1").numpy(),
                               np.asarray(jnorms.optimize_linear(g, 0.5, "l1")), rtol=1e-6)
    step = tnorms.optimize_linear(T(g), 0.5, "l1").numpy()
    assert step[0, 0, 0, 0] == 0.25 and step[0, 0, 0, 1] == -0.25
    assert np.count_nonzero(step[0]) == 2 and not step[1].any()

    x = rng.uniform(-1, 1, g.shape).astype(np.float32)
    x[:, 0, 0] = -1.0
    x[:, 1, 0] = 1.0
    got = tnorms.zero_out_clipped_grads(T(g), T(x), -1.0, 1.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jnorms.zero_out_clipped_grads(g, x, -1.0, 1.0)),
                               rtol=1e-6)
    assert not got[2, 0, 0][g[2, 0, 0] < 0].any() and not got[2, 1, 0][g[2, 1, 0] > 0].any()

    w = rng.normal(size=(48, 5)).astype(np.float32)
    flat = x.reshape(3, -1)
    guess = tnorms.get_or_guess_labels(lambda v: v @ T(w), T(flat)).numpy()
    np.testing.assert_array_equal(guess, np.asarray(jnorms.get_or_guess_labels(
        lambda v: v @ w, flat)))
    y = T(np.array([1, 0, 4]))
    assert tnorms.get_or_guess_labels(None, T(flat), y) is y
    with pytest.raises(ValueError):
        tnorms.get_or_guess_labels(None, T(flat), targeted=True)


def test_whole_batch_losses_match_jax():
    """``feature_loss`` and ``mlm_loss`` (labels ``[B, S]`` and stacked
    ``[B, A, S]``, a padded all -100 variant among them) at rtol 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    b = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    mask = (np.arange(5) < np.array([[5], [3]])).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.feature_loss(T(a), T(b), T(b), T(a), T(mask)).numpy(),
        np.asarray(jlosses.feature_loss(a, b, b, a, mask)), rtol=1e-5)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    lab2 = rng.integers(0, 11, (2, 7))
    lab2[:, ::2] = -100
    lab3 = rng.integers(0, 11, (2, 3, 7))
    lab3[:, :, 1:5] = -100
    lab3[1, 2] = -100
    for lab in (lab2, lab3):
        got = tlosses.mlm_loss(T(logits), T(lab))
        assert got.dim() == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(jlosses.mlm_loss(logits, lab)),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the zoo on a linear classifier
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(3)
W = _rng.normal(size=(24, 5)).astype(np.float32)
BIAS = _rng.normal(size=(5,)).astype(np.float32) * 0.1
X = _rng.uniform(-0.6, 0.6, (4, 24)).astype(np.float32)
Y = np.array([0, 2, 4, 1])


def _jlogits(px):
    return px @ W + BIAS


def _tlogits(px):
    return px @ T(W) + T(BIAS)


ZOO = {
    "fgm": (lambda k: jextra.fgm_classifier(_jlogits, X, Y, eps=0.1),
            lambda k: textra.fgm_classifier(_tlogits, T(X), T(Y), eps=0.1)),
    "fgm_l1_targeted": (
        lambda k: jextra.fgm_classifier(_jlogits, X, Y, eps=0.5, norm="l1", targeted=True),
        lambda k: textra.fgm_classifier(_tlogits, T(X), T(Y), eps=0.5, norm="l1",
                                        targeted=True)),
    "pgd": (lambda k: jextra.pgd_classifier(_jlogits, X, Y, k, eps=0.3, eps_iter=0.05,
                                            nb_iter=5),
            lambda k: textra.pgd_classifier(_tlogits, T(X), T(Y), JaxKey(k), eps=0.3,
                                            eps_iter=0.05, nb_iter=5)),
    "pgd_l2": (lambda k: jextra.pgd_classifier(_jlogits, X, Y, k, eps=0.5, eps_iter=0.2,
                                               nb_iter=4, norm="l2"),
               lambda k: textra.pgd_classifier(_tlogits, T(X), T(Y), JaxKey(k), eps=0.5,
                                               eps_iter=0.2, nb_iter=4, norm="l2")),
    "mim": (lambda k: jextra.momentum_iterative_method(_jlogits, X, Y, eps=0.3, eps_iter=0.05,
                                                       nb_iter=5, decay=0.9),
            lambda k: textra.momentum_iterative_method(_tlogits, T(X), T(Y), eps=0.3,
                                                       eps_iter=0.05, nb_iter=5, decay=0.9)),
    "spsa": (lambda k: jextra.spsa(_jlogits, X, Y, k, eps=0.3, nb_iter=3, spsa_samples=12),
             lambda k: textra.spsa(_tlogits, T(X), T(Y), JaxKey(k), eps=0.3, nb_iter=3,
                                   spsa_samples=12)),
    "noise": (lambda k: jextra.noise(X, k, eps=0.3),
              lambda k: textra.noise(T(X), JaxKey(k), eps=0.3)),
    "semantic": (lambda k: np.concatenate([jextra.semantic(X), jextra.semantic(X, False)]),
                 lambda k: torch.cat([textra.semantic(T(X)), textra.semantic(T(X), False)])),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_matches_jax_on_a_linear_classifier(name):
    """Each attack against the JAX one on the same inputs and draws, atol
    1e-6.  SPSA takes 12 draws, in chunks of ``SPSA_CHUNK`` (8, the last of
    4): the estimate is the mean over the same draws either way."""
    assert 12 % textra.SPSA_CHUNK, "SPSA's last chunk must be ragged"
    key = jax.random.key(7)
    jrun, trun = ZOO[name]
    got, want = trun(key).numpy(), np.asarray(jrun(key))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if name != "semantic":
        assert np.abs(got - X).max() > 1e-3 and got.min() >= -1 and got.max() <= 1


def test_zoo_exports_match_jax():
    import vqattack_tpu.attacks as jattacks

    names = {n for n in dir(jattacks) if not n.startswith("_")} - {
        "albef", "extra", "losses", "norms", "pgd", "vlmo", "mar_labels", "text_attack",
        "orchestrator", "batched", "vlmo_orchestrator"}
    assert names and all(callable(getattr(tattacks, n)) for n in names), sorted(names)


def test_carlini_wagner_l2_matches_jax():
    """The same success per sample and the adversarial images within 1e-4.

    The labels are the classifier's own predictions (``get_or_guess_labels``),
    so every search step starts with ``f > 0``: there the gradient carries
    ``const * df``, and not only the L2 term's gradient, which at the start
    is the round-off of tanh(arctanh(x)) - x, whose sign Adam's normalised
    first step would blow up to +/-lr.  Each start's margin (true logit
    less the best other one) is stated below.  Every success decision
    compared is clear of a float32 near-tie: at each search step's final
    iterate the port's margin is at least 1e-3 away from 0 (1.9e-3 at the
    closest), over a thousand times the 5e-7 by which the two packages'
    logits differ at their results; and a failed sample's result is its
    clipped input."""
    y = np.argmax(_jlogits(X), axis=1)
    start = _margin_np(_jlogits(X), y)
    assert start.min() >= 0.5, start  # [1.05, 1.14, 0.65, 0.91]
    kw = dict(max_iterations=40, binary_search_steps=4, lr=0.05, initial_const=0.05)
    j_adv = np.asarray(jextra.carlini_wagner_l2(_jlogits, X, y, 5, jax.random.key(0), **kw))
    best, best_l2, margins = textra.cw_l2_search(_tlogits, T(X), T(y), 5, **kw)
    assert margins.shape == (4, 4) and np.abs(margins.numpy()).min() >= 1e-3, margins
    success = np.isfinite(best_l2.numpy())
    j_success = np.abs(j_adv - X).max(axis=1) > 0
    np.testing.assert_array_equal(success, j_success)
    assert success.any() and (margins.numpy() > 0).any()  # both outcomes occur on the way
    np.testing.assert_allclose(best.numpy(), j_adv, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(best.numpy()[~success], X[~success])
    np.testing.assert_allclose(best_l2.numpy()[success],
                               ((best.numpy() - X) ** 2).sum(1)[success], rtol=1e-5)
    assert torch.equal(textra.carlini_wagner_l2(_tlogits, T(X), T(y), 5, None, **kw), best)


def _margin_np(logits, y):
    real = logits[np.arange(len(y)), y]
    return real - np.max(logits - np.eye(logits.shape[1])[y] * 1e9, axis=1)


# ---------------------------------------------------------------------------
# FGM and PGD on a tiny VLMo-VQA victim
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlmo_victim():
    jv, tv = (dataclasses.replace(c.vlmo, depth=2, vlffn_start_layer=1)
              for c in tiny_configs(64))
    sd = synthetic.vlmo_state_dict(tv, seed=4, heads=synthetic.VLMO_VQA_HEADS)
    tree = {"params": jconvert_vlmo({k: v.numpy() for k, v in sd.items()}, depth=tv.depth)}
    absent = [h for h in VLMO_OPTIONAL_HEADS if h not in tree["params"]]
    t_model = load_jax_params(VLMo(tv), tree, absent).eval().requires_grad_(False)
    j_model = JVLMo(jv)
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = np.array([[2, 10, 11, 12, 3, 0, 0, 0]] * 2, np.int32)
    mask = (ids > 0).astype(np.int32)
    tids, tmask = T(ids).long(), T(mask).long()

    def jlogits(p):
        return j_model.apply(j_tree, p, ids[:p.shape[0]], mask[:p.shape[0]],
                             method=JVLMo.vqa_logits)

    def tlogits(p):
        return t_model.vqa_logits(p, tids[:p.shape[0]], tmask[:p.shape[0]])

    y = torch.argmax(tlogits(T(nchw(px))), -1).numpy()
    return jlogits, tlogits, px, y


def test_fgm_on_the_vlmo_victim_signs_agree(vlmo_victim):
    """FGM's step is eps * sign(grad): wherever |grad| exceeds 1e-3 of its
    largest magnitude the two packages' images agree exactly (below that
    band float32 reassociation may flip a sign)."""
    jlogits, tlogits, px, y = vlmo_victim
    g = nhwc(textra._ce_grad(tlogits, T(nchw(px)), T(y).long(), False).numpy())
    j_adv = np.asarray(jextra.fgm_classifier(jlogits, px, y, eps=0.05))
    t_adv = nhwc(textra.fgm_classifier(tlogits, T(nchw(px)), T(y).long(), eps=0.05).numpy())
    band = np.abs(g) > 1e-3 * np.abs(g).max()
    assert band.mean() > 0.5
    np.testing.assert_array_equal(t_adv[band], j_adv[band])
    assert np.abs(t_adv - j_adv).max() <= 2 * 0.05 + 1e-6


def test_pgd_classifier_on_the_vlmo_victim_matches_jax(vlmo_victim):
    """4 PGD steps from the JAX rand-init: within the trajectory budget of
    ``test_torch_attack.py`` (a flipped sign moves a pixel by 2*eps_iter a
    step; mean |diff| under 1e-4)."""
    jlogits, tlogits, px, y = vlmo_victim
    key = jax.random.key(9)
    j_adv = np.asarray(jextra.pgd_classifier(jlogits, px, y, key, eps=0.125, eps_iter=0.01,
                                             nb_iter=4))
    t_adv = nhwc(textra.pgd_classifier(tlogits, T(nchw(px)), T(y).long(), JaxKey(key),
                                       eps=0.125, eps_iter=0.01, nb_iter=4).numpy())
    d = np.abs(t_adv - j_adv)
    assert d.max() <= 2 * 0.01 * 4 + 1e-6 and d.mean() < 1e-4
    assert np.abs(t_adv - px).max() <= 0.125 + 1e-6


# ---------------------------------------------------------------------------
# multi-restart PGD
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def surrogate():
    """The tiny ALBEF surrogate in both packages, its clean targets and
    the two packages' loss auxiliaries, batch 2."""
    jc, tc = (shallow_albef(c) for c in tiny_configs(64))
    a = tc.albef
    sd = synthetic.albef_pretrain_state_dict(a, seed=1, src_image_size=a.vit.image_size)
    tree = {"params": jconvert_albef({k: v.numpy() for k, v in sd.items()}, depth=a.vit.depth,
                                     num_layers=a.bert.num_layers,
                                     fusion_layer=a.bert.fusion_layer)}
    t_sur = load_jax_params(AlbefPretrain(a), tree).eval().requires_grad_(False)
    j_sur = JAlbefPretrain(jc.albef)
    rng = np.random.default_rng(2)
    ori = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = np.array([[2, 10, 11, 12, 13, 3, 0, 0], [2, 14, 15, 3, 0, 0, 0, 0]], np.int32)
    mask = (ids > 0).astype(np.int32)
    with torch.no_grad():  # the clean targets, one input of both packages' losses
        img_t, txt_t, _ = (f.numpy() for f in t_sur.gen_feats(T(nchw(ori)), T(ids).long(),
                                                              T(mask).long()))
    tok_mask = mask.astype(np.float32)
    j_aux = {"variables": tree, "text_ids": jnp.asarray(ids), "text_mask": jnp.asarray(mask),
             "tgt_img": jnp.asarray(img_t), "tgt_txt": jnp.asarray(txt_t), "txt_token_mask": jnp.asarray(tok_mask),
             "special_ids": (4, 0, 2)}
    t_aux = {"text_ids": T(ids).long(), "text_mask": T(mask).long(),
             "tgt_img": T(img_t), "tgt_txt": T(txt_t),
             "txt_token_mask": T(tok_mask), "special_ids": (4, 0, 2)}
    return jalbef.make_feature_loss(j_sur), talbef.make_feature_loss(t_sur), ori, j_aux, t_aux


def _pick(best_losses, per_restart):
    """The restart whose trajectory ``best_losses [T, B]`` is, per sample."""
    return np.argmin(np.abs(np.stack(per_restart) - best_losses[None]).max(axis=1), axis=0)


def test_multi_restart_matches_jax(surrogate):
    """R = 3 restarts of 3 steps on the tiny ALBEF, the JAX draws injected:
    the same restart picked for each sample, the adversarial images within
    the trajectory budget and the picked trajectory's losses within rtol
    1e-4 (``test_torch_attack.py::test_pgd_feature_trajectory_matches_jax``)."""
    jloss, tloss, ori, j_aux, t_aux = surrogate
    atk = dict(eps=0.125, eps_iter=0.01, nb_iter=3)
    key = jax.random.key(12)
    # one compiled program (the JAX function's ranking re-evaluation is
    # eager outside a jit)
    j_adv, j_l = jax.jit(lambda x, k, aux: jpgd.pgd_multi_restart(
        jloss, x, x, k, aux, n_restarts=3, **atk))(jnp.asarray(ori), key, j_aux)
    t_adv, t_l = tpgd.pgd_multi_restart(tloss, T(nchw(ori)), T(nchw(ori)), JaxKey(key), t_aux,
                                        n_restarts=3, **atk)
    assert t_l.shape == (3, 2)
    # each restart alone, from the same split keys: which one each package took
    runs = [tpgd.pgd_feature(tloss, T(nchw(ori)), T(nchw(ori)), k, t_aux, rand_init=True, **atk)
            for k in JaxKey(key).split(4)[:3]]
    per_restart = [l.numpy() for _, l in runs]
    t_pick, j_pick = _pick(t_l.numpy(), per_restart), _pick(np.asarray(j_l), per_restart)
    np.testing.assert_array_equal(t_pick, j_pick)
    finals = np.stack([tloss(a, k, t_aux)[1].numpy()
                       for (a, _), k in zip(runs, JaxKey(key).split(4)[-1].split(3))])
    np.testing.assert_array_equal(t_pick, np.argmax(finals, axis=0))
    d = np.abs(nhwc(t_adv.numpy()) - np.asarray(j_adv))
    assert d.max() <= 2 * 0.01 * 3 + 1e-6 and d.mean() < 1e-4
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=1e-4)
    assert np.abs(t_adv.numpy() - nchw(ori)).max() <= 0.125 + 1e-6


def _stochastic_loss(adv, key, aux):
    """A MAR-family stand-in: the loss depends on the key."""
    ps = torch.sum(adv * aux["w"], dim=tuple(range(1, adv.dim())))
    ps = ps + key.uniform((adv.shape[0],), -0.1, 0.1)
    return ps.sum(), ps


def test_multi_restart_ranking():
    """The ranking semantics the JAX package pins (``tests/test_pgd.py::
    test_multi_restart_ranking``): the same key gives the same selection,
    stochastic loss too, and the pick is the argmax of ``loss_fn(final_adv,
    fresh key)`` over restarts, the fresh keys split from the last of
    ``n_restarts + 1``; ``best_losses`` is the picked restart's trajectory,
    one update stale."""
    x = torch.zeros(2, 5)
    aux = {"w": torch.ones(2, 5)}
    key = JaxKey(jax.random.key(7))
    kw = dict(eps=0.5, eps_iter=0.1, nb_iter=3)
    adv1, l1 = tpgd.pgd_multi_restart(_stochastic_loss, x, x, key, aux, n_restarts=3, **kw)
    adv2, _ = tpgd.pgd_multi_restart(_stochastic_loss, x, x, key, aux, n_restarts=3, **kw)
    assert torch.equal(adv1, adv2)

    keys = key.split(4)
    runs = [tpgd.pgd_feature(_stochastic_loss, x, x, k, aux, rand_init=True, **kw)
            for k in keys[:3]]
    final = torch.stack([_stochastic_loss(a, k, aux)[1]
                         for (a, _), k in zip(runs, keys[-1].split(3))])
    best = torch.argmax(final, dim=0)
    assert torch.equal(adv1, torch.stack([runs[r][0][i] for i, r in enumerate(best.tolist())]))
    assert torch.equal(l1, torch.stack([runs[r][1][:, i] for i, r in enumerate(best.tolist())], 1))
