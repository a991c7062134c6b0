"""The port's attack pieces against the JAX package's: losses, norms, the PGD
loops over the tiny ALBEF surrogate with the JAX draws injected, the block
contract, and the host text attack (tokenizer, MAR labels, candidates,
substitution selection, similarity gate)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import WORDS, JaxKey, nchw, nhwc, tiny_configs, tiny_models
from vqattack_tpu.attacks import albef as jalbef
from vqattack_tpu.attacks import losses as jlosses
from vqattack_tpu.attacks import mar_labels as jmar
from vqattack_tpu.attacks import norms as jnorms
from vqattack_tpu.attacks import pgd as jpgd
from vqattack_tpu.attacks import text_attack as jtext
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.text import similarity as jsim
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch.attacks import albef as talbef
from vqattack_tpu_torch.attacks import losses as tlosses
from vqattack_tpu_torch.attacks import mar_labels as tmar
from vqattack_tpu_torch.attacks import norms as tnorms
from vqattack_tpu_torch.attacks import pgd as tpgd
from vqattack_tpu_torch.attacks import text_attack as ttext
from vqattack_tpu_torch.text import similarity as tsim
from vqattack_tpu_torch.text.filter_words import default_filter_words
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

T = torch.from_numpy
ATK = dict(eps=0.125, eps_iter=0.01, clip_min=-1.0, clip_max=1.0)


# ---------------------------------------------------------------------------
# losses and norms (tolerance 1e-5 relative: float32 reductions in another
# order)
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    b = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    a[0, 0, 0] = 0.0  # the 1e-6 norm floor
    mask = (np.arange(5) < np.array([[5], [3]])).astype(np.float32)
    np.testing.assert_allclose(tlosses.cosine_sim(T(a), T(b)).numpy(),
                               np.asarray(jlosses.cosine_sim(a, b)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tlosses.per_sample_feature_loss(T(a), T(b), T(b), T(a), T(mask)).numpy(),
        np.asarray(jlosses.per_sample_feature_loss(a, b, b, a, mask)), rtol=1e-5)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    lab2 = rng.integers(0, 11, (2, 7))
    lab2[:, ::2] = -100
    lab3 = rng.integers(0, 11, (2, 3, 7))
    lab3[:, :, 1:5] = -100
    lab3[1, 2] = -100  # an all-ignored (padded) variant adds 0
    for lab in (lab2, lab3):
        np.testing.assert_allclose(
            tlosses.per_sample_mlm_loss(T(logits), T(lab)).numpy(),
            np.asarray(jlosses.per_sample_mlm_loss(logits, lab)), rtol=1e-5)


def test_norms_match_jax():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    g[0, 0, 0] = 0.0  # sign(0) = 0
    for norm in ("linf", "l2"):
        np.testing.assert_allclose(tnorms.clip_eta(T(g), norm, 0.5).numpy(),
                                   np.asarray(jnorms.clip_eta(g, norm, 0.5)), rtol=1e-6)
        np.testing.assert_allclose(tnorms.optimize_linear(T(g), 0.01, norm).numpy(),
                                   np.asarray(jnorms.optimize_linear(g, 0.01, norm)), rtol=1e-6)


# ---------------------------------------------------------------------------
# PGD over the tiny surrogate, JAX draws injected
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def surrogate():
    jc, tc = tiny_configs(64)
    (j_sur, _, _), (p_sur, _, _), (t_sur, _, _) = tiny_models(jc, tc, victim=False, mlm=False)
    rng = np.random.default_rng(2)
    ori = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    ids = np.array([[2, 10, 11, 12, 13, 3, 0, 0]], np.int32)
    mask = (ids > 0).astype(np.int32)
    mlm_ids = np.array([[2, 14, 4, 15, 16, 3, 0, 0]], np.int32)
    labels = np.full((1, 2, 8), -100, np.int64)
    labels[0, 0, 2] = 20
    img_t, txt_t, _ = j_sur.apply(p_sur, ori, ids, mask, method=JAlbefPretrain.gen_feats)
    j_aux = {"variables": p_sur, "text_ids": jnp.asarray(ids), "text_mask": jnp.asarray(mask),
             "tgt_img": img_t, "tgt_txt": txt_t,
             "txt_token_mask": jnp.ones((1, 8), jnp.float32), "special_ids": (4, 0, 2),
             "mlm_ids": jnp.asarray(mlm_ids), "mlm_mask": jnp.asarray(mask),
             "mlm_labels": jnp.asarray(labels)}
    t_aux = {"text_ids": T(ids).long(), "text_mask": T(mask).long(),
             "tgt_img": T(np.array(img_t)), "tgt_txt": T(np.array(txt_t)),
             "txt_token_mask": torch.ones(1, 8), "special_ids": (4, 0, 2),
             "mlm_ids": T(mlm_ids).long(), "mlm_mask": T(mask).long(), "mlm_labels": T(labels)}
    t_sur.requires_grad_(False)
    return j_sur, t_sur, ori, j_aux, t_aux


def test_pgd_gradient_signs_agree(surrogate):
    """At one iterate, the feature and MLM loss gradients have the same sign
    wherever |grad| exceeds 1e-3 of its largest magnitude (below that band
    float32 reassociation may flip a sign)."""
    j_sur, t_sur, ori, j_aux, t_aux = surrogate
    key = jax.random.key(3)
    for jmake, tmake in ((jalbef.make_feature_loss, talbef.make_feature_loss),
                         (jalbef.make_mlm_loss, talbef.make_mlm_loss)):
        jloss = jmake(j_sur)
        jg = np.asarray(jax.jit(jax.grad(lambda x, a: jloss(x, key, a)[0]))(jnp.asarray(ori), j_aux))
        _, tg = tpgd._value_and_grad(tmake(t_sur), T(nchw(ori)), JaxKey(key), t_aux)
        tg = nhwc(tg.numpy())
        band = np.abs(jg) > 1e-3 * np.abs(jg).max()
        assert band.mean() > 0.5
        np.testing.assert_array_equal(np.sign(tg[band]), np.sign(jg[band]))


def _drift(t_adv, j_adv, steps):
    """Trajectory budget: a sign flip moves a pixel by 2*eps_iter per step,
    so at most 2*eps_iter*steps anywhere, and flips below the gradient band
    stay rare: mean |diff| under 1e-4."""
    d = np.abs(nhwc(t_adv) - np.asarray(j_adv))
    assert d.max() <= 2 * ATK["eps_iter"] * steps + 1e-6
    assert d.mean() < 1e-4


def test_pgd_feature_trajectory_matches_jax(surrogate):
    j_sur, t_sur, ori, j_aux, t_aux = surrogate
    key = jax.random.key(4)
    j_adv, j_l = jpgd.pgd_feature(jalbef.make_feature_loss(j_sur), jnp.asarray(ori),
                                  jnp.asarray(ori), key, j_aux, nb_iter=3, rand_init=True, **ATK)
    t_adv, t_l = tpgd.pgd_feature(talbef.make_feature_loss(t_sur), T(nchw(ori)), T(nchw(ori)),
                                  JaxKey(key), t_aux, nb_iter=3, rand_init=True, **ATK)
    _drift(t_adv.numpy(), j_adv, 3)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=1e-4)
    assert np.abs(t_adv.numpy() - nchw(ori)).max() <= ATK["eps"] + 1e-6


def test_pgd_alternating_trajectory_matches_jax(surrogate):
    j_sur, t_sur, ori, j_aux, t_aux = surrogate
    key = jax.random.key(5)
    j_adv, j_f, j_m = jpgd.pgd_alternating(
        jalbef.make_feature_loss(j_sur), jalbef.make_mlm_loss(j_sur), jnp.asarray(ori),
        jnp.asarray(ori), key, j_aux, nb_iter=2, rand_init=True, **ATK)
    t_adv, t_f, t_m = tpgd.pgd_alternating(
        talbef.make_feature_loss(t_sur), talbef.make_mlm_loss(t_sur), T(nchw(ori)),
        T(nchw(ori)), JaxKey(key), t_aux, nb_iter=2, rand_init=True, **ATK)
    _drift(t_adv.numpy(), j_adv, 4)
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), rtol=1e-4)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), rtol=1e-4)


def test_pgd_vl_step_matches_jax(surrogate):
    """Image update within one step's drift; the harvested text gradient
    within 1e-3 of its largest magnitude.  The step starts off the clean
    image: there the loss sits at its minimum and the gradient is noise."""
    j_sur, t_sur, ori, j_aux, t_aux = surrogate
    adv = np.clip(ori + np.random.default_rng(8).uniform(-0.1, 0.1, ori.shape), -1, 1)
    adv = adv.astype(np.float32)
    emb = j_sur.apply(j_aux["variables"], j_aux["text_ids"], method=JAlbefPretrain.embed_text)
    pos = np.array([[1, 3]], np.int32)
    key = jax.random.key(6)
    j_adv, j_tg = jpgd.pgd_vl_step(jalbef.make_vl_loss(j_sur), jnp.asarray(adv), emb,
                                   jnp.asarray(ori), jnp.asarray(pos), key, j_aux, **ATK)
    t_adv, t_tg = tpgd.pgd_vl_step(talbef.make_vl_loss(t_sur), T(nchw(adv)),
                                   t_sur.embed_text(t_aux["text_ids"]), T(nchw(ori)),
                                   T(pos).long(), JaxKey(key), t_aux, **ATK)
    _drift(t_adv.numpy(), j_adv, 1)
    j_tg = np.asarray(j_tg)
    np.testing.assert_allclose(t_tg.numpy(), j_tg, rtol=0, atol=1e-3 * np.abs(j_tg).max())


# ---------------------------------------------------------------------------
# the per-block contract (toy losses, port only)
# ---------------------------------------------------------------------------


def _toy():
    table = torch.linspace(-1, 1, 10 * 4).reshape(10, 4)
    seen = []

    def loss_fn(adv, key, aux):
        seen.append(adv.detach().clone())
        ps = ((adv - aux["tgt_img"]) ** 2).flatten(1).sum(1)
        return ps.sum(), ps

    def vl_loss_fn(img, emb, key, aux):
        ps = (img ** 2).flatten(1).sum(1) + (emb * aux["tgt_txt"][:, :1, :1]).flatten(1).sum(1)
        return ps.sum(), ps

    def embed_fn(ids):
        return table[ids]

    def targets_fn(ori_x, key, aux):
        return {"tgt_img": ori_x * 0.5, "tgt_txt": torch.ones(1, 2, 3, 4)}

    return loss_fn, vl_loss_fn, embed_fn, targets_fn, seen


def _block(first: bool, do_vl: bool, nb_iter=2):
    loss_fn, vl_loss_fn, embed_fn, targets_fn, seen = _toy()
    x = torch.full((1, 3, 4, 4), 0.2)
    aux = {"text_ids": torch.tensor([[1, 2, 3]])}
    if not first:
        aux.update(tgt_img=torch.zeros(1, 3, 4, 4), tgt_txt=torch.ones(1, 2, 3, 4))
    from vqattack_tpu_torch.rng import TorchKey

    key = TorchKey(0, "cpu")
    out = tpgd.pgd_feature_block(
        loss_fn, vl_loss_fn, embed_fn, targets_fn if first else None, x, x, key, key, key,
        nb_iter=nb_iter, rand_init=first, do_vl=do_vl, positions=torch.tensor([[0, 2]]),
        aux=aux, target_keys=("tgt_img", "tgt_txt"), max_iter=4, **ATK)
    return x, out, seen


def test_block_contract_first_and_last_blocks():
    x, (adv, losses, tg, tgts), seen = _block(first=True, do_vl=True)
    # clean targets come from targets_fn on the first block
    assert torch.equal(tgts[0], x * 0.5)
    # rand-init on the first block only: the first step sees a moved start
    assert not torch.equal(seen[0], x)
    assert losses.shape == (2, 1) and tg.shape == (1, 2, 4) and tg.abs().sum() > 0

    x, (adv2, losses2, tg2, tgts2), seen2 = _block(first=False, do_vl=False)
    assert torch.equal(seen2[0], x)  # no rand-init on a later block
    assert torch.equal(tgts2[0], torch.zeros(1, 3, 4, 4))  # targets taken from aux
    assert torch.equal(tg2, torch.zeros(1, 2, 4))  # last block: zero text grad
    # and no VL step: the block's result is the PGD loop's alone
    loss_fn, _, _, _, _ = _toy()
    from vqattack_tpu_torch.rng import TorchKey

    aux = {"tgt_img": torch.zeros(1, 3, 4, 4)}
    ref, _ = tpgd.pgd_feature(loss_fn, x, x, TorchKey(0, "cpu"), aux, nb_iter=2, **ATK)
    assert torch.equal(adv2, ref)
    with pytest.raises(ValueError, match="exceeds max_iter"):
        _block(first=False, do_vl=False, nb_iter=5)


# ---------------------------------------------------------------------------
# host text attack
# ---------------------------------------------------------------------------

TEXTS = ["what color is the dog", "What's the man's hat?", "the [MASK] is red",
         "red[SEP]", "a frisbee in the park", "unknownword dog"]


def _toks():
    return WordPieceTokenizer.toy(WORDS), JTokenizer.toy(WORDS)


def test_tokenizer_matches_jax():
    t, j = _toks()
    for s in TEXTS:
        for a, b in zip(t.encode(s, 12), j.encode(s, 12)):
            np.testing.assert_array_equal(a, b)
        assert t.word_spans(s) == j.word_spans(s)
        assert t.tokenize(s) == j.tokenize(s)


@pytest.mark.parametrize("para,ans,allc", [
    ("the dog is red.", "red", ["red", "blue"]),
    ("the man wears a blue hat", "blue hat", ["red hat", "blue hat", "a dog"]),
    ("the dog is in the park", "cat", []),
])
def test_mar_labels_match_jax(para, ans, allc):
    t, j = _toks()
    a = tmar.build_mar_labels(para, ans, allc, t, 12, 3)
    b = jmar.build_mar_labels(para, ans, allc, j, 12, 3)
    assert (a.old_alg, a.paraphrase_words, a.mask_positions, a.true_len) == (
        b.old_alg, b.paraphrase_words, b.mask_positions, b.true_len)
    for x, y in ((a.labels, b.labels), (a.mlm_ids, b.mlm_ids)):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)


def test_candidates_and_substitution_match_jax():
    """Same candidates and schedules from the same MLM top-k, and the same
    accepted substitutions from the same text gradients, embeddings and gate
    scores."""
    t, j = _toks()
    rng = np.random.default_rng(7)
    vocab = t.vocab_size
    logits = rng.normal(size=(1, 64, vocab)).astype(np.float32) * 3

    def topk(ids, mask):
        idx = np.argsort(-logits[: len(ids)], axis=-1)[..., :5]
        return np.take_along_axis(logits[: len(ids)], idx, -1), idx

    q = "what color is the dog in the park"
    fw = default_filter_words()
    ct = ttext.generate_candidates(q, t, topk, fw, 40, 5, 0.3)
    cj = jtext.generate_candidates(q, j, None, fw, 40, 5, 0.3, mlm_topk_fn=topk)
    assert (ct.candidate_lists, ct.iter_list, ct.attack_positions) == (
        cj.candidate_lists, cj.iter_list, cj.attack_positions)
    assert ttext.compute_iter_schedule(3, 40) == jtext.compute_iter_schedule(3, 40)

    n_pos = len(ct.attack_positions)
    grad = rng.normal(size=(n_pos, 16)).astype(np.float32)
    ori_emb = rng.normal(size=(12, 16)).astype(np.float32)
    table = rng.normal(size=(vocab, 16)).astype(np.float32)

    def embed(texts):
        return np.stack([table[t.encode(s, 12)[0]] for s in texts])

    def gate(refs, texts):
        return np.asarray([1.0 - 0.01 * (len(s) % 7) for s in texts], np.float32)

    req_t = ttext.SubstitutionRequest(q, q, grad, ct, ori_emb, 0.95)
    req_j = jtext.SubstitutionRequest(q, q, grad, cj, ori_emb, 0.95)
    out_t = ttext.select_substitutions_multi([req_t], embed, gate, max_length=12)
    out_j = jtext.select_substitutions_multi([req_j], embed, gate, max_length=12)
    assert out_t == out_j


def test_bert_gate_matches_jax(surrogate):
    """Mean-pooled text-tower gate on the same weights: scores within 1e-5,
    the same operating point."""
    j_sur, t_sur, _, j_aux, _ = surrogate
    t, j = _toks()
    variables = j_aux["variables"]

    def j_embed(ids, mask):
        return j_sur.apply(variables, ids, mask,
                           method=lambda m, i, k: m.text_encoder(i, attention_mask=k,
                                                                 mode="text")[0])

    jg = jsim.make_gate("bert", embed_fn=j_embed, tokenizer=j, max_length=8)
    tg = tsim.make_gate("bert", embed_fn=t_sur.text_tower, tokenizer=t, max_length=8)
    ref, cands = TEXTS[0], TEXTS[1:4]
    np.testing.assert_allclose(tg.scores(ref, cands), jg.scores(ref, cands), atol=1e-5)
    assert tg.operating_point(0.95) == jg.operating_point(0.95)
    assert tsim.pad_to_bucket(cands) == jsim.pad_to_bucket(cands)
    assert tsim.make_gate("none").operating_point(0.95) == 0.0
    with pytest.raises(ValueError, match="not ported"):
        tsim.make_gate("use")
