"""The attack's per-layer feature loss without the stack (``fused_feats``).

``AlbefPretrain(fused_feats=True)`` returns the ViT's 13 taps as a tuple and
``VLMo(fused_feats=True)`` the joint trunk's; the losses reduce each layer
in place.  Held here:

- against the JAX package's ``fused_feats=True`` modules on the same
  weights: ALBEF's feature, VL and mixed losses and their image (and
  embedding) gradients; VLMo's three attack forwards, their losses and
  gradients; ``_layer_cls`` on a tuple.  Tolerances as in
  ``tests/test_torch_vlmo_attack.py``: per-sample losses within 1e-4
  relative, gradients within 1e-3 relative plus 1e-6 of their largest;
- against the port's stacked form, within ``tests/test_fused_loss.py``'s
  tolerances: losses ``rtol=1e-6``, gradients ``rtol=1e-5, atol=1e-7``;
- through the orchestrators: the clean targets of a fused surrogate are the
  stacked one's (in either ``tap_dtype``), and the per-sample pipelines, the
  lockstep engines and a two-replica CPU ``mesh=`` run a fused surrogate to
  the stacked one's results.

One compiled JAX program per model (every loss and gradient in one jit).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (JaxKey, fixed_topk, nchw, nhwc, shallow_albef, tiny_configs,
                             tiny_mlm, tiny_models, tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu.attacks import albef as jalbef
from vqattack_tpu.attacks import vlmo as jvlmo
from vqattack_tpu.attacks.batched import make_mixed_second_loss as jmixed_loss
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.models.vlmo import _layer_cls_of
from vqattack_tpu_torch.attacks import albef as talbef
from vqattack_tpu_torch.attacks import vlmo as tvlmo
from vqattack_tpu_torch.attacks.batched import (BatchedAlbefAttack, BatchedVlmoAttack,
                                                make_mixed_second_loss)
from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline
from vqattack_tpu_torch.models.albef import AlbefPretrain
from vqattack_tpu_torch.models.vlmo import VLMo, _layer_cls
from vqattack_tpu_torch.parallel import make_mesh
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

T = torch.from_numpy
# against JAX (tests/test_torch_vlmo_attack.py)
JAX_LOSS = dict(rtol=1e-4)
JAX_GRAD_RTOL = 1e-3
# fused against stacked (tests/test_fused_loss.py)
LOSS = dict(rtol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-7)
# engine results, fused against stacked (tests/test_torch_parallel.py)
ENGINE_LOSS = dict(rtol=2e-4, atol=1e-5)
WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park"]
CANDIDATES = {"cat": ["hat"]}


def _fused_twin(module, cls, cfg, **kw):
    """``cls(cfg, fused_feats=True, **kw)`` with ``module``'s weights."""
    twin = cls(cfg, fused_feats=True, **kw)
    twin.load_state_dict(module.state_dict())
    return twin.eval().requires_grad_(False)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=JAX_GRAD_RTOL, atol=1e-6 * np.abs(want).max())


def _torch_aux(j_aux):
    return {k: (v if k == "special_ids" else
                T(np.array(v)).long() if np.asarray(v).dtype.kind == "i" else T(np.array(v)))
            for k, v in j_aux.items() if k != "variables"}


# --------------------------------------------------------------------- ALBEF


def _one_vit_block(cfg):
    """The JAX program's compile scales with depth: one ViT block."""
    vit = dataclasses.replace(cfg.albef.vit, depth=1)
    return dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit))


@pytest.fixture(scope="module")
def albef():
    """The shallow tiny ALBEF (one ViT block, so two taps; two text layers)
    in both packages and both forms; a batch of 2 with a padded question,
    the clean targets from the port's stacked surrogate."""
    jc, tc = (_one_vit_block(shallow_albef(c)) for c in tiny_configs(64))
    (_, _, _), (p_sur, _, _), (t_sur, _, _) = tiny_models(jc, tc, victim=False, mlm=False)
    t_sur.requires_grad_(False)
    t_fused = _fused_twin(t_sur, AlbefPretrain, tc.albef)
    j_fused = JAlbefPretrain(jc.albef, fused_feats=True)
    rng = np.random.default_rng(0)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ori = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = np.array([[2, 10, 11, 12, 13, 3, 0, 0], [2, 20, 21, 3, 0, 0, 0, 0]], np.int32)
    mask = (ids > 0).astype(np.int32)
    mlm_ids = np.array([[2, 14, 4, 15, 16, 3, 0, 0], [2, 4, 22, 23, 3, 0, 0, 0]], np.int32)
    labels = np.full((2, 2, 8), -100, np.int64)
    labels[0, 0, 2], labels[1, 0, 1], labels[1, 1, 1] = 20, 30, 31
    with torch.no_grad():
        img_t, txt_t, _ = t_sur.gen_feats(T(nchw(ori)), T(ids).long(), T(mask).long())
    j_aux = {"variables": p_sur, "text_ids": ids, "text_mask": mask,
             "tgt_img": img_t.numpy(), "tgt_txt": txt_t.numpy(),
             "txt_token_mask": mask.astype(np.float32), "special_ids": (4, 0, 2),
             "mlm_ids": mlm_ids, "mlm_mask": (mlm_ids > 0).astype(np.int32),
             "mlm_labels": labels, "mlm_weight": np.array([0.25, 1.0], np.float32)}
    embeds = t_sur.embed_text(T(ids).long()).numpy()
    return t_sur, t_fused, j_fused, px, embeds, j_aux


def _albef_losses(t_model, px, embeds, aux, key):
    """(feature, VL, mixed) per-sample losses and gradients of the port."""
    out = []
    for make, vl in ((talbef.make_feature_loss, False), (talbef.make_vl_loss, True),
                     (make_mixed_second_loss, False)):
        x = T(nchw(px)).requires_grad_(True)
        if vl:
            e = T(embeds).requires_grad_(True)
            total, ps = make(t_model)(x, e, JaxKey(key), aux)
            grads = torch.autograd.grad(total, (x, e))
        else:
            total, ps = make(t_model)(x, JaxKey(key), aux)
            grads = torch.autograd.grad(total, (x,))
        out.append((ps.detach().numpy(), [g.numpy() for g in grads]))
    return out


def test_albef_fused_losses_match_jax_and_the_stacked_form(albef):
    """The fused feature, VL and mixed losses and their gradients against
    the JAX ``AlbefPretrain(fused_feats=True)`` (one compiled program), and
    against the port's stacked surrogate."""
    t_sur, t_fused, j_fused, px, embeds, j_aux = albef
    key = jax.random.key(7)
    feat, vl, mixed = (jalbef.make_feature_loss(j_fused), jalbef.make_vl_loss(j_fused),
                       jmixed_loss(j_fused))

    @jax.jit
    def jax_all(x, e, arrays):
        aux = dict(arrays, special_ids=j_aux["special_ids"])
        (_, f_ps), f_g = jax.value_and_grad(lambda a: feat(a, key, aux), has_aux=True)(x)
        (_, v_ps), v_g = jax.value_and_grad(lambda a, b: vl(a, b, key, aux), argnums=(0, 1),
                                            has_aux=True)(x, e)
        (_, m_ps), m_g = jax.value_and_grad(lambda a: mixed(a, key, aux), has_aux=True)(x)
        return (f_ps, (f_g,)), (v_ps, v_g), (m_ps, (m_g,))

    aux = {k: v for k, v in j_aux.items() if k != "special_ids"}
    want = jax_all(jnp.asarray(px), jnp.asarray(embeds), aux)
    t_aux = _torch_aux(j_aux)
    fused = _albef_losses(t_fused, px, embeds, t_aux, key)
    stacked = _albef_losses(t_sur, px, embeds, t_aux, key)
    for (f_ps, f_g), (s_ps, s_g), (j_ps, j_g) in zip(fused, stacked, want):
        np.testing.assert_allclose(f_ps, np.asarray(j_ps), **JAX_LOSS)
        np.testing.assert_allclose(f_ps, s_ps, **LOSS)
        for fg, sg, jg in zip(f_g, s_g, j_g):
            _grad_close(nhwc(fg) if fg.ndim == 4 else fg, jg)
            np.testing.assert_allclose(fg, sg, **GRAD)


def test_albef_fused_taps_are_the_stacked_layers():
    """``stack_feats=False``: the same tap list as a tuple, in the plain
    trunk and in the pending-residual (``fused_ln``) one, whose second
    block's tap is the residual the first hands it."""
    from vqattack_tpu_torch.models.vit import VisionTransformer

    x = torch.from_numpy(nchw(np.random.default_rng(5).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)))
    for fused_ln in (False, True):
        cfg = dataclasses.replace(tiny_configs(64)[1].albef.vit, fused_ln=fused_ln)
        torch.manual_seed(0)
        enc = VisionTransformer(cfg)
        twin = VisionTransformer(cfg, stack_feats=False)
        twin.load_state_dict(enc.state_dict())
        with torch.no_grad():
            out_s, feats = enc(x)
            out_f, taps = twin(x)
        assert isinstance(taps, tuple) and len(taps) == cfg.depth + 1
        assert torch.equal(out_s, out_f) and torch.equal(torch.stack(taps, 1), feats)


@pytest.mark.parametrize("tap_dtype", ["float32", "bfloat16"])
def test_albef_clean_targets_stay_stacked(albef, tap_dtype):
    """A fused surrogate's clean targets are the stacked surrogate's, bit
    for bit, cast layer by layer under ``tap_dtype``."""
    t_sur, t_fused, _, _, _, j_aux = albef
    cfg = tiny_configs(64, tap_dtype=tap_dtype)[1]
    tok = WordPieceTokenizer.toy(WORDS)
    aux = {"ori_ids": T(j_aux["text_ids"]).long(), "ori_mask": T(j_aux["text_mask"]).long()}
    ori = torch.zeros(2, 3, 32, 32)
    got = [AlbefAttackPipeline(cfg, m, tok, NullGate(), device="cpu")._targets_fn(
        ori, TorchKey(3, "cpu"), aux) for m in (t_sur, t_fused)]
    for k in ("tgt_img", "tgt_txt"):
        assert got[1][k].dtype == getattr(torch, tap_dtype)
        assert torch.equal(got[0][k], got[1][k])


# ---------------------------------------------------------------------- VLMo


@pytest.fixture(scope="module")
def vlmo():
    """The two-block tiny VLMo (a split block, then the VL expert) in both
    packages and both forms; a batch of 2 with a padded question."""
    jc, tc = tiny_vlmo_configs(64, depth=2)
    _, j_params, t_model = tiny_vlmo(jc, tc, seed=0)
    t_model.requires_grad_(False)
    t_fused = _fused_twin(t_model, VLMo, tc.vlmo)
    j_fused = JVLMo(jc.vlmo, fused_feats=True)
    s = tc.vlmo.max_text_len
    rng = np.random.default_rng(1)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(5, 64, (2, s)).astype(np.int32)
    ids[:, 0] = 2
    mask = (np.arange(s) < np.array([[s], [s - 3]])).astype(np.int32)
    ids = ids * mask
    labels = np.full((2, s), -100, np.int64)
    labels[0, 2], labels[1, 1] = 20, 30
    with torch.no_grad():
        _, cls_t, tok_t, m_t = t_model.attack_feats(
            T(nchw(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))), T(ids).long(),
            T(mask).long())
    j_aux = {"variables": j_params, "text_ids": ids, "text_mask": mask,
             "tgt_layer_cls": cls_t.numpy(), "tgt_tokens": tok_t.numpy(),
             "tgt_token_mask": m_t.float().numpy(), "mlm_ids": ids, "mlm_mask": mask,
             "mlm_labels": labels}
    embeds = t_model.embed_text(T(ids).long()).numpy()
    return t_model, t_fused, j_fused, px, embeds, j_aux


def _vlmo_run(t_model, px, embeds, aux):
    """``attack_feats``, then the three losses (over ``attack_feats``,
    ``attack_mlm`` and ``attack_feats_from_embeds``) and their gradients."""
    with torch.no_grad():
        fwd = t_model.attack_feats(T(nchw(px)), aux["text_ids"], aux["text_mask"])
    losses = []
    for make, vl in ((tvlmo.make_feature_loss, False), (tvlmo.make_mlm_loss, False),
                     (tvlmo.make_vl_loss, True)):
        x = T(nchw(px)).requires_grad_(True)
        if vl:
            e = T(embeds).requires_grad_(True)
            total, ps = make(t_model)(x, e, None, aux)
            grads = torch.autograd.grad(total, (x, e))
        else:
            total, ps = make(t_model)(x, None, aux)
            grads = torch.autograd.grad(total, (x,))
        losses.append((ps.detach().numpy(), [g.numpy() for g in grads]))
    return fwd, losses


def test_vlmo_fused_forwards_and_losses_match_jax_and_the_stacked_form(vlmo):
    """``attack_feats`` of the fused model (the token feats a tuple of depth
    + 1 layers) and the losses over ``attack_feats``, ``attack_mlm`` and
    ``attack_feats_from_embeds`` with their gradients, against the JAX
    ``VLMo(fused_feats=True)`` in one compiled program and against the
    port's stacked model."""
    t_model, t_fused, j_fused, px, embeds, j_aux = vlmo
    feat, mlm, vl = (jvlmo.make_feature_loss(j_fused), jvlmo.make_mlm_loss(j_fused),
                     jvlmo.make_vl_loss(j_fused))

    @jax.jit
    def jax_all(x, e, aux):
        fwd = j_fused.apply(aux["variables"], x, aux["text_ids"], aux["text_mask"],
                            method=JVLMo.attack_feats)
        (_, f_ps), f_g = jax.value_and_grad(lambda a: feat(a, None, aux), has_aux=True)(x)
        (_, m_ps), m_g = jax.value_and_grad(lambda a: mlm(a, None, aux), has_aux=True)(x)
        (_, v_ps), v_g = jax.value_and_grad(lambda a, b: vl(a, b, None, aux), argnums=(0, 1),
                                            has_aux=True)(x, e)
        return fwd, ((f_ps, (f_g,)), (m_ps, (m_g,)), (v_ps, v_g))

    j_fwd, j_losses = jax_all(jnp.asarray(px), jnp.asarray(embeds), j_aux)
    t_aux = _torch_aux(j_aux)
    f_fwd, f_losses = _vlmo_run(t_fused, px, embeds, t_aux)
    s_fwd, s_losses = _vlmo_run(t_model, px, embeds, t_aux)
    depth = t_model.cfg.depth
    head, layer_cls, tokens, token_mask = f_fwd
    assert isinstance(tokens, tuple) and len(tokens) == depth + 1
    assert isinstance(j_fwd[2], tuple) and len(j_fwd[2]) == depth + 1
    for got, want in ((head, j_fwd[0]), (layer_cls, j_fwd[1])) + tuple(zip(tokens, j_fwd[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
    np.testing.assert_array_equal(token_mask.numpy(), np.asarray(j_fwd[3]))
    # the fused forward computes what the stacked one does
    assert torch.equal(head, s_fwd[0]) and torch.equal(layer_cls, s_fwd[1])
    assert torch.equal(torch.stack(tokens, 1), s_fwd[2])
    for (f_ps, f_g), (s_ps, s_g), (j_ps, j_g) in zip(f_losses, s_losses, j_losses):
        np.testing.assert_allclose(f_ps, np.asarray(j_ps), **JAX_LOSS)
        np.testing.assert_allclose(f_ps, s_ps, **LOSS)
        for fg, sg, jg in zip(f_g, s_g, j_g):
            _grad_close(nhwc(fg) if fg.ndim == 4 else fg, jg)
            np.testing.assert_allclose(fg, sg, **GRAD)


def test_layer_cls_and_the_feature_loss_take_tuples_as_jax_does():
    """``_layer_cls`` of a tuple, and the per-layer feature losses with a
    tuple on the adversarial side against a stacked or a tuple target,
    against the JAX functions and the stacked form."""
    from vqattack_tpu.attacks.losses import per_sample_feature_loss as j_feature_loss
    from vqattack_tpu_torch.attacks.losses import per_sample_feature_loss

    rng = np.random.default_rng(4)
    adv, tgt = (rng.normal(size=(2, 3, 5, 16)).astype(np.float32) for _ in range(2))
    cls_a, cls_b = (rng.normal(size=(2, 3, 16)).astype(np.float32) for _ in range(2))
    mask = (np.arange(5) < np.array([[5], [2]])).astype(np.float32)

    @jax.jit
    def jax_side(adv, tgt, cls_a, cls_b, mask):
        layers = tuple(adv[:, i] for i in range(3))
        return (_layer_cls_of(layers),
                jvlmo.vlmo_per_sample_feature_loss(cls_a, layers, cls_b, tgt, mask),
                j_feature_loss(adv, layers, tgt, tgt, mask, mask))

    j_cls, j_vlmo, j_both = (np.asarray(a) for a in jax_side(adv, tgt, cls_a, cls_b, mask))
    adv_t = tuple(T(adv[:, i]) for i in range(3))
    tgt_t = tuple(T(tgt[:, i]) for i in range(3))
    layer_cls = _layer_cls(adv_t)
    np.testing.assert_array_equal(layer_cls.numpy(), j_cls)
    assert torch.equal(layer_cls, _layer_cls(T(adv)))
    stacked = tvlmo.vlmo_per_sample_feature_loss(T(cls_a), T(adv), T(cls_b), T(tgt), T(mask))
    np.testing.assert_allclose(stacked.numpy(), j_vlmo, rtol=1e-5)
    for target in (T(tgt), tgt_t):
        got = tvlmo.vlmo_per_sample_feature_loss(T(cls_a), adv_t, T(cls_b), target, T(mask))
        np.testing.assert_allclose(got.numpy(), stacked.numpy(), **LOSS)
        both = per_sample_feature_loss(adv_t, adv_t, target, target, T(mask), T(mask))
        np.testing.assert_allclose(both.numpy(), j_both, rtol=1e-5)
        np.testing.assert_allclose(both.numpy(), per_sample_feature_loss(
            T(adv), T(adv), T(tgt), T(tgt), T(mask), T(mask)).numpy(), **LOSS)


@pytest.mark.parametrize("tap_dtype", ["float32", "bfloat16"])
def test_vlmo_clean_targets_stay_stacked(vlmo, tap_dtype):
    t_model, t_fused, _, px, _, j_aux = vlmo
    cfg = tiny_vlmo_configs(64, depth=2, tap_dtype=tap_dtype)[1]
    tok = WordPieceTokenizer.toy(WORDS)
    args = (T(nchw(px)), T(j_aux["text_ids"]).long(), T(j_aux["text_mask"]).long())
    got = [VlmoAttackPipeline(cfg, m, tok, NullGate(), device="cpu").clean_targets(*args)
           for m in (t_model, t_fused)]
    assert got[1][1].dim() == 4 and got[1][1].dtype == getattr(torch, tap_dtype)
    for a, b in zip(*got):
        assert torch.equal(a, b)


# ---------------------------------------------- the attack paths, port only


def _assert_close_results(got, want):
    """The same schedules and texts, loss trajectories within the mesh
    tests' tolerances, the images within the PGD drift budget."""
    assert [r.qid for r in got] == [r.qid for r in want]
    for a, b in zip(got, want):
        assert (a.old_alg, a.num_blocks, a.adv_text, list(a.substitutions)) == (
            b.old_alg, b.num_blocks, b.adv_text, list(b.substitutions))
        np.testing.assert_allclose(a.feat_losses, b.feat_losses, **ENGINE_LOSS)
        if b.mlm_losses is not None:
            np.testing.assert_allclose(a.mlm_losses, b.mlm_losses, **ENGINE_LOSS)
        d = np.abs(a.adv_image - b.adv_image)
        assert d.max() <= 2 * 0.01 * 12 and d.mean() < 1e-3


def _samples(n, questions, seed):
    rng = np.random.default_rng(seed)
    return [{"qid": str(4000 + i), "question": questions[i % len(questions)][0],
             "paraphrase": questions[i % len(questions)][1],
             "target_answer": questions[i % len(questions)][2],
             "all_correct_answers": ["red", "blue"],
             "pixels": nchw(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))}
            for i in range(n)]


@pytest.fixture(scope="module")
def albef_pipelines():
    """Stacked and fused ALBEF pipelines on the same tiny weights, 6
    iterations, one substitutable word (3 blocks)."""
    tok = WordPieceTokenizer.toy(WORDS)
    jc, tc = (shallow_albef(c) for c in tiny_configs(tok.vocab_size, num_iters=6))
    (_, _, _), (_, _, _), (t_sur, _, t_mlm) = tiny_models(jc, tc, victim=False)
    fused = _fused_twin(t_sur, AlbefPretrain, tc.albef)
    out = []
    for sur in (t_sur, fused):
        p = AlbefAttackPipeline(tc, sur, tok, NullGate(), mlm_model=t_mlm, device="cpu")
        p.candidate_mlm_topk = fixed_topk(tok, CANDIDATES)
        out.append(p)
    return out


ALBEF_QUESTIONS = [("what color is the cat", None, None),
                   ("what color is the cat", "the cat is blue.", "blue")]


def test_albef_per_sample_and_batched_run_a_fused_surrogate(albef_pipelines):
    """The per-sample pipeline (feature-only and MAR) and the lockstep
    engine at batch 4 (a MAR bucket and a feature bucket) with a fused
    surrogate give the stacked surrogate's results."""
    stacked, fused = albef_pipelines
    px = _samples(1, ALBEF_QUESTIONS, 0)[0]["pixels"]
    for para, ans in ((None, None), ("the cat is blue.", "blue")):
        args = (px, "what color is the cat", "9", para, ans, ["red", "blue"])
        got = fused.attack_sample(*args, key=TorchKey(2, "cpu"))
        _assert_close_results([got], [stacked.attack_sample(*args, key=TorchKey(2, "cpu"))])
    samples = _samples(4, ALBEF_QUESTIONS, 1)
    want = BatchedAlbefAttack(stacked).run(samples, batch_size=4, rng=TorchKey(5, "cpu"))
    got = BatchedAlbefAttack(fused).run(samples, batch_size=4, rng=TorchKey(5, "cpu"))
    assert sorted({r.old_alg for r in got}) == [0, 1]
    _assert_close_results(got, want)


def test_albef_fused_block_on_a_two_replica_mesh(albef_pipelines):
    """One batched chunk through the engine on ``make_mesh(devices=[cpu,
    cpu])`` with a fused surrogate (each replica a copy of it) against the
    unsharded engine with the stacked surrogate."""
    stacked, fused = albef_pipelines
    samples = _samples(4, ALBEF_QUESTIONS[1:], 2)
    want = BatchedAlbefAttack(stacked).run(samples, batch_size=4, rng=TorchKey(6, "cpu"))
    engine = BatchedAlbefAttack(fused, mesh=make_mesh(devices=["cpu", "cpu"]))
    got = engine.run(samples, batch_size=4, rng=TorchKey(6, "cpu"))
    assert engine.last_chunk_sizes == [4]
    assert all(r.old_alg == 0 for r in got)
    _assert_close_results(got, want)


VLMO_QUESTIONS = [("what color is the cat?", None, None),
                  ("what color is the cat?", "the cat is blue", "blue")]


def test_vlmo_per_sample_batched_and_mesh_run_a_fused_model():
    """The VLMo per-sample pipeline, the lockstep engine and a two-replica
    mesh with a fused model give the stacked model's results."""
    tok = WordPieceTokenizer.toy(WORDS)
    jc, tc = tiny_vlmo_configs(tok.vocab_size, depth=2, num_iters=6)
    _, _, t_model = tiny_vlmo(jc, tc, seed=0)
    _, _, t_mlm = tiny_mlm(jc, tc, seed=2)
    fused = _fused_twin(t_model, VLMo, tc.vlmo)
    pipes = []
    for m in (t_model, fused):
        p = VlmoAttackPipeline(tc, m, tok, NullGate(), mlm_model=t_mlm, id2answer={0: "red"},
                               device="cpu")
        p.candidate_mlm_topk = fixed_topk(tok, CANDIDATES)
        pipes.append(p)
    stacked, fused_p = pipes
    px = _samples(1, VLMO_QUESTIONS, 3)[0]["pixels"]
    args = (px, "what color is the cat?", "9", "the cat is blue", "blue", ["red", "blue"])
    _assert_close_results([fused_p.attack_sample(*args, key=TorchKey(2, "cpu"))],
                          [stacked.attack_sample(*args, key=TorchKey(2, "cpu"))])
    samples = _samples(4, VLMO_QUESTIONS, 4)
    want = BatchedVlmoAttack(stacked).run(samples, batch_size=4, rng=TorchKey(7, "cpu"))
    got = BatchedVlmoAttack(fused_p).run(samples, batch_size=4, rng=TorchKey(7, "cpu"))
    assert sorted({r.old_alg for r in got}) == [0, 1]
    _assert_close_results(got, want)
    mesh = BatchedVlmoAttack(fused_p, mesh=make_mesh(devices=["cpu", "cpu"]))
    _assert_close_results(mesh.run(samples[1::2], batch_size=2, rng=TorchKey(8, "cpu")),
                          BatchedVlmoAttack(stacked).run(samples[1::2], batch_size=2,
                                                         rng=TorchKey(8, "cpu")))
