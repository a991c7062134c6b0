"""The port's pretraining slice against the JAX package: the MLM collator,
the pretraining objectives and losses (``albef_pretrain``,
``vlmo_pretrain``), the key's ``categorical``, the training CLI on the three tasks from ``--ann``, one train step of each
task through both CLIs from ``--arrow-root`` (the same weights, data and
draws), the
pretraining datasets on tables written by the JAX writers, and the port's
writers against the JAX writers.

The hard negatives are drawn by :class:`torch_port_util.JaxKey`, which
replays ``jax.random.categorical`` on the logits the port hands it, so both
packages draw the same indices.  Tolerances are those of
``tests/test_torch_train.py``: losses rtol 1e-5; gradients rtol 1e-3 with
atol 1e-5 of each tensor's largest value or 1e-6 of the model's largest
gradient, whichever is larger; the global norm rtol 1e-4; parameters after
one AdamW step rtol 1e-5 and atol 1e-4 lr where the JAX gradient exceeds
1e-6, else 2 lr.  Collated arrays and written tables are compared exactly.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (JaxKey, _host, jax_params_of, nchw, shallow_albef, tiny_configs,
                             tiny_models, tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu.data import arrow_writer as jarrow_writer
from vqattack_tpu.data import collators as jcollators
from vqattack_tpu.data import pretrain_datasets as jdatasets
from vqattack_tpu.data import pretrain_writers as jwriters
from vqattack_tpu.data.transforms import test_transform as jax_transform
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.text.tokenizer import SPECIAL_TOKENS
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu.train import objectives as jobj
from vqattack_tpu.train import trainer as jtrainer
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.checkpoint.convert import flax_leaves, load_jax_params
from vqattack_tpu_torch.data import arrow_writer, collators, pretrain_datasets, pretrain_writers
from vqattack_tpu_torch.data.transforms import test_transform as port_transform
from vqattack_tpu_torch.models.albef import AlbefPretrain, init_weights
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer
from vqattack_tpu_torch.train import cli, objectives, optim, trainer

T = torch.from_numpy
VOCAB = 64
B = 3  # a batch of three: every row has two hard negatives to draw from


def _leaf(tree, path):
    node = tree["params"] if "params" in tree else tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _port_layout(model, tree):
    """The JAX tree's leaves by the port's parameter names, in its layout."""
    return {name: transform(_leaf(tree, path)) for name, path, transform, _ in
            flax_leaves(model)}


def _close_grads(model, grads, j_grads):
    """The port's gradients (by name) against the JAX tree's."""
    want = _port_layout(model, j_grads)
    largest = max(float(np.abs(g).max()) for g in want.values())
    assert largest > 0
    for name, p in optim.named_params(model).items():
        g = grads.get(name)
        g = np.zeros(p.shape, np.float32) if g is None else g.detach().numpy()
        atol = max(1e-5 * float(np.abs(want[name]).max()), 1e-6 * largest)
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=atol, err_msg=name)


@pytest.fixture
def row_norm(monkeypatch):
    """``jnp.linalg.norm(x, -1, keepdims=True)`` taken along the last axis.
    The JAX package's ``albef_pretrain_loss`` normalises the ITM
    similarities' features with that call, whose second argument is
    ``ord``: it divides by the matrix's ord -1 norm, a scalar, where the
    reference (``F.normalize(..., dim=-1)``, ``model_pretrain.py``) and the
    port divide each row by its own norm.  The tests hold the port against
    the JAX function with that call taken per row."""
    norm = jnp.linalg.norm

    def per_row(x, ord=None, axis=None, keepdims=False):
        if ord == -1 and axis is None:
            return norm(x, axis=-1, keepdims=keepdims)
        return norm(x, ord, axis, keepdims)

    monkeypatch.setattr(jnp.linalg, "norm", per_row)


def test_the_jax_itm_similarities_are_not_row_normalised():
    """What :func:`row_norm` repairs: the JAX call gives one scalar, not a
    norm a row."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32))
    assert jnp.linalg.norm(x, -1, keepdims=True).shape == (1, 1)


def _jnp(batch):
    """A numpy batch as JAX arrays (indexable by traced indices)."""
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    out = {}
    for k, v in batch.items():
        v = T(nchw(v) if k == "pixels" else np.asarray(v))
        out[k] = v.long() if v.dtype == torch.int32 else v
    return out


# ---------------------------------------------------------------------------
# the tiny models, built once a module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def albef():
    jc, tc = (_shallow(c) for c in tiny_configs(VOCAB))
    (j_model, _, _), (params, _, _), (model, _, _) = tiny_models(jc, tc, victim=False, mlm=False)
    return j_model, params, model.train(), jc


@pytest.fixture(scope="module")
def vlmo():
    jc, tc = (_shallow(c) for c in tiny_vlmo_configs(VOCAB))
    j_model, params, model = tiny_vlmo(jc, tc, seed=0)
    return j_model, params, model.train(), jc


def _text_batch(rng, n, t):
    ids = rng.integers(5, VOCAB, (n, t)).astype(np.int32)
    ids[:, 0] = 2  # [CLS]
    mask = np.ones_like(ids)
    mask[1, t - 3:] = 0
    ids[1, t - 3:] = 0
    mlm_ids = ids.copy()
    labels = np.full_like(ids, -100)
    for b, pos in ((0, 2), (0, 5), (1, 3), (2, 1), (2, 6)):
        labels[b, pos], mlm_ids[b, pos] = ids[b, pos], 4  # [MASK]
    return {"text_ids": ids, "text_mask": mask, "mlm_ids": mlm_ids, "mlm_labels": labels}


def _albef_batch(jc, seed=3):
    rng = np.random.default_rng(seed)
    size = jc.albef.vit.image_size
    return {"pixels": rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
            **_text_batch(rng, B, 8)}


def _vlmo_batch(jc, seed=4):
    rng = np.random.default_rng(seed)
    size = jc.vlmo.image_size
    return {"pixels": rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
            **_text_batch(rng, B, jc.vlmo.max_text_len)}


# ---------------------------------------------------------------------------
# the collator and the key
# ---------------------------------------------------------------------------


def _tokenizers(tmp_path):
    toks = list(SPECIAL_TOKENS) + ["the", "dog", "is", "red", "play", "##ing", "##s", "un",
                                   "##like", "##ly", "cat"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(toks) + "\n")
    return JTokenizer.from_file(str(path)), WordPieceTokenizer.from_file(str(path))


@pytest.mark.parametrize("whole_word", [False, True])
def test_mlm_collate_matches_jax_bit_for_bit(tmp_path, whole_word):
    """Twenty batches from one seed: every array equal to the JAX
    collator's; whole-word masking masks a word's ``##`` pieces with it."""
    j_tok, t_tok = _tokenizers(tmp_path)
    texts = ["the dog is playing", "unlikely cats", "the cat plays the dog is red",
             "dogs"] * 2
    j_rng, t_rng = np.random.default_rng(5), np.random.default_rng(5)
    masked = 0
    for _ in range(20):
        want = jcollators.mlm_collate(texts, j_tok, 10, 0.3, whole_word=whole_word, rng=j_rng)
        got = collators.mlm_collate(texts, t_tok, 10, 0.3, whole_word=whole_word, rng=t_rng)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        labels = got["text_labels_mlm"]
        masked += int((labels != -100).sum())
        if whole_word:  # a piece is labelled exactly when its head word is
            ids = got["text_ids"]
            for b in range(len(texts)):
                for pos in range(1, ids.shape[1]):
                    if t_tok.convert_ids_to_tokens([int(ids[b, pos])])[0].startswith("##"):
                        assert (labels[b, pos] != -100) == (labels[b, pos - 1] != -100)
    assert masked > 0


def test_categorical_draws_in_proportion_to_the_softmax():
    """The port's ``TorchKey.categorical``: over 40000 rows each index's
    rate within 0.0125 (five standard deviations) of its softmax
    probability, and never the index at -inf; ``JaxKey.categorical`` gives
    ``jax.random.categorical``'s draws."""
    logits = torch.tensor([0.3, -1.0, 1.2, -torch.inf, 0.0])
    n = 40000
    draws = TorchKey(0, torch.device("cpu")).categorical(logits.expand(n, -1))
    assert draws.shape == (n,) and draws.dtype == torch.long
    rates = torch.bincount(draws, minlength=5).double() / n
    assert rates[3] == 0
    np.testing.assert_allclose(rates.numpy(), torch.softmax(logits.double(), 0).numpy(),
                               atol=0.0125)
    key = jax.random.key(3)
    x = np.random.default_rng(0).normal(size=(6, 7)).astype(np.float32)
    np.testing.assert_array_equal(JaxKey(key).categorical(T(x)).numpy(),
                                  np.asarray(jax.random.categorical(key, x, axis=-1)))


# ---------------------------------------------------------------------------
# the objectives, each against JAX
# ---------------------------------------------------------------------------


def _feats(seed, n=4, d=6, q=8):
    rng = np.random.default_rng(seed)
    f = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(4)]
    queues = [rng.normal(size=(d, q)).astype(np.float32) for _ in range(2)]
    return f, [q_ / np.linalg.norm(q_, axis=0) for q_ in queues]


OBJECTIVES = ["contrastive", "contrastive_queues", "hard_negatives", "itm", "feature_queue",
              "soft_contrastive", "soft_masked_lm", "masked_lm"]


@pytest.mark.parametrize("which", OBJECTIVES)
def test_objective_matches_jax(which):
    (img, txt, t_img, t_txt), (qi, qt) = _feats(OBJECTIVES.index(which))
    temp = 0.07
    J, P = jnp.asarray, T
    if which in ("contrastive", "contrastive_queues"):
        queues = (qi, qt) if which == "contrastive_queues" else (None, None)
        want = jobj.contrastive_loss(J(img), J(txt), temp, *(None if q is None else J(q)
                                                             for q in queues))
        got = objectives.contrastive_loss(P(img), P(txt), temp, *(None if q is None else P(q)
                                                                  for q in queues))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    elif which == "soft_contrastive":
        want = jobj.soft_contrastive_loss(J(img), J(txt), temp, J(t_img), J(t_txt), 0.4,
                                          J(qi), J(qt))
        got = objectives.soft_contrastive_loss(P(img), P(txt), temp, P(t_img), P(t_txt), 0.4,
                                               P(qi), P(qt))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    elif which == "hard_negatives":
        key = jax.random.key(9)
        sim = img @ txt.T
        want = jobj.sample_hard_negatives(key, J(sim), J(sim.T))
        got = objectives.sample_hard_negatives(JaxKey(key), P(sim), P(sim.T))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert (g.numpy() != np.arange(len(sim))).all()  # never the own pair
    elif which == "itm":
        pos, neg = img[:, :2], txt[:, :2].repeat(2, 0)
        np.testing.assert_allclose(float(objectives.itm_loss(P(pos), P(neg))),
                                   float(jobj.itm_loss(J(pos), J(neg))), rtol=1e-5)
    elif which == "feature_queue":
        queue, ptr = qi, 0
        j_queue, j_ptr = J(qi), J(0)
        for step in range(3):  # the third write wraps to column 0
            feats = (img + step).astype(np.float32)
            queue, ptr = objectives.update_feature_queue(P(np.asarray(queue)), ptr, P(feats))
            j_queue, j_ptr = jobj.update_feature_queue(j_queue, j_ptr, J(feats))
            np.testing.assert_array_equal(queue.numpy(), np.asarray(j_queue))
            assert ptr == int(j_ptr)
        assert ptr == 4
        with pytest.raises(ValueError, match="multiple of batch size"):
            objectives.update_feature_queue(P(qi), 0, P(img[:3]))
    else:
        rng = np.random.default_rng(1)
        logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
        t_logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
        labels = rng.integers(0, 11, (2, 5))
        labels[0, :3] = -100
        if which == "masked_lm":
            want = jobj.masked_lm_loss(J(logits), J(labels))
            got = objectives.masked_lm_loss(P(logits), P(labels))
        else:
            want = jobj.soft_masked_lm_loss(J(logits), J(labels), J(t_logits), 0.4)
            got = objectives.soft_masked_lm_loss(P(logits), P(labels), P(t_logits), 0.4)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_momentum_update_matches_jax(albef):
    """The EMA teacher over the two modules' named parameters against
    ``jax.tree_util`` over the trees."""
    j_model, params, model, _ = albef
    rng = np.random.default_rng(2)
    t_params = jax.tree_util.tree_map(
        lambda x: (x + rng.normal(size=x.shape) * 0.1).astype(x.dtype), params)
    teacher = load_jax_params(copy.deepcopy(model), t_params)
    want = jobj.momentum_update(params, t_params, 0.9)
    got = objectives.momentum_update(model, teacher, 0.9)
    assert got is teacher
    want = _port_layout(teacher, _host(want))
    for name, p in optim.named_params(teacher).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the whole pretraining losses: the terms and the gradients
# ---------------------------------------------------------------------------


def _albef_case(albef, distill):
    """ALBEF's loss: the hard path, or with a teacher (the parameters
    perturbed) at alpha 0.4 and queues of 6 features."""
    j_model, params, model, jc = albef
    batch = _albef_batch(jc)
    if not distill:
        return (params, model, batch,
                lambda p, key: jobj.albef_pretrain_loss(j_model, p, _jnp(batch), key),
                objectives.albef_pretrain_loss, ("loss_ita", "loss_itm", "loss_mlm"))
    rng = np.random.default_rng(7)
    t_params = jax.tree_util.tree_map(
        lambda x: (x + rng.normal(size=x.shape) * 0.05).astype(x.dtype), params)
    teacher = load_jax_params(copy.deepcopy(model), t_params).eval()
    d = jc.albef.embed_dim
    queues = {k: rng.normal(size=(d, 6)).astype(np.float32) for k in ("image_queue",
                                                                      "text_queue")}
    queues = {k: q / np.linalg.norm(q, axis=0) for k, q in queues.items()}

    def jloss(p, key):
        return jobj.albef_pretrain_loss(j_model, p, _jnp(batch), key,
                                        queue_state={k: jnp.asarray(q) for k, q in queues.items()},
                                        teacher_params=t_params, alpha=0.4)

    def tloss(m, tb, key):
        return objectives.albef_pretrain_loss(m, tb, key,
                                              queue_state={k: T(q) for k, q in queues.items()},
                                              teacher=teacher, alpha=0.4)

    return params, model, batch, jloss, tloss, ("loss_ita", "loss_itm", "loss_mlm")


def _vlmo_case(vlmo, weights):
    """VLMo's loss with every weight at 1, or with ITC weighed 0 (computed,
    for ITM's negatives, but left out of the total) and MLM at 2."""
    j_model, params, model, jc = vlmo
    batch = _vlmo_batch(jc)

    def jloss(p, key):
        return jobj.vlmo_pretrain_loss(j_model, p, _jnp(batch), key, weights=weights)

    def tloss(m, tb, key):
        return objectives.vlmo_pretrain_loss(m, tb, key, weights=weights)

    return params, model, batch, jloss, tloss, ("itc_loss", "itc_vl_loss", "itm_loss",
                                                "itm_acc", "mlm_loss")


# the hard ALBEF path and VLMo with every weight at 1 are the CLI's losses:
# test_train_step_matches_jax holds their terms and gradients
LOSS_CASES = {
    "albef_distill_queues": lambda a, v: _albef_case(a, True),
    "vlmo_zero_itc_weight": lambda a, v: _vlmo_case(v, {"itc": 0.0, "itm": 1.0, "mlm": 2.0}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_pretrain_loss_matches_jax(albef, vlmo, row_norm, case):
    """The loss, each of its terms and every gradient against
    ``jax.value_and_grad`` of the JAX loss, on the JAX draws."""
    params, model, batch, jloss, tloss, terms = LOSS_CASES[case](albef, vlmo)
    key = jax.random.key(21)
    (j_total, j_metrics), j_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params, key)
    loss, metrics = tloss(model, _port_batch(batch), JaxKey(key))
    np.testing.assert_allclose(float(loss), float(j_total), rtol=1e-5)
    for k in terms:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5, err_msg=k)
    if case == "vlmo_zero_itc_weight":
        np.testing.assert_allclose(float(loss), float(metrics["itm_loss"] + 2 * metrics[
            "mlm_loss"]), rtol=1e-6)
    ps = optim.named_params(model)
    grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    _close_grads(model, dict(zip(ps, grads)), _host(j_grads))


def test_vlmo_pretrain_loss_refuses_a_batch_of_one(vlmo):
    _, _, model, jc = vlmo
    batch = _port_batch({k: v[:1] for k, v in _vlmo_batch(jc).items()})
    with pytest.raises(ValueError, match="batch >= 2"):
        objectives.vlmo_pretrain_loss(model, batch, TorchKey(0, torch.device("cpu")))


def test_pretrain_loss_weights_match_the_jax_cli():
    """Zero weights kept; a preset with none of mlm/itc/itm exits."""
    from vqattack_tpu.named_configs import vlmo_named_config as j_named
    from vqattack_tpu.train import cli as jcli
    from vqattack_tpu_torch.named_configs import vlmo_named_config

    for name in ("task_mlm_itm_itc_base_plus", "task_mlm_itm_itc_base"):
        got = cli.pretrain_loss_weights(vlmo_named_config(name))
        assert got == jcli.pretrain_loss_weights(j_named(name))
    assert cli.pretrain_loss_weights(vlmo_named_config("task_mlm_itm_itc_base"))["itc"] == 0.0
    for mod, named in ((cli, vlmo_named_config), (jcli, j_named)):
        with pytest.raises(SystemExit, match="none of mlm/itc/itm"):
            mod.pretrain_loss_weights(named("task_textmlm_base"))


# ---------------------------------------------------------------------------
# raw corpora, the writers and the datasets
# ---------------------------------------------------------------------------


WORDS = ["a", "the", "dog", "cat", "red", "photo", "caption", "region", "sentence", "of",
         "images", "match", "sign", "what", "does", "say"]


def _save_img(path, seed, fmt="JPEG", size=40):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.random.default_rng(seed).integers(0, 255, (size, size, 3), np.uint8)
    Image.fromarray(arr, "RGB").save(path, fmt)


def _raw_corpora(root):
    """A raw tree of each corpus in the reference's layouts, the inputs of
    ``vlmo/utils/write_*.py``; two or more captions an image."""
    coco, images = root / "coco", []
    for i, split in enumerate(["train", "val", "restval", "test", "train"]):
        fn = f"COCO_{split}_{i:06d}.jpg"
        _save_img(str(coco / ("val2014" if split in ("val", "test") else "train2014") / fn), i)
        images.append({"filename": fn, "split": split,
                       "sentences": [{"raw": f"a {split} photo of a dog"},
                                     {"raw": f"the red {split} cat"}]})
    (coco / "karpathy").mkdir()
    (coco / "karpathy" / "dataset_coco.json").write_text(json.dumps({"images": images}))
    f30k, images = root / "f30k", []
    for i, split in enumerate(["train", "val", "test"]):
        _save_img(str(f30k / "flickr30k-images" / f"f30k_{i}.jpg"), 10 + i)
        images.append({"filename": f"f30k_{i}.jpg", "split": split,
                       "sentences": [{"raw": f"a {split} caption"}]})
    (f30k / "karpathy").mkdir()
    (f30k / "karpathy" / "dataset_flickr30k.json").write_text(json.dumps({"images": images}))
    gcc = root / "gcc"
    for split in ("train", "val"):
        annot = []
        for i in range(3):
            fn = f"cc_{split}_{i}.jpg"
            _save_img(str(gcc / f"images_{split}" / "0" / fn), 20 + i)
            annot.append([f"images_{split}/0/{fn}", f"a {split} caption of the cat {i}"])
        (gcc / f"{split}_annot.json").write_text(json.dumps(annot))
    sbu, annot = root / "sbu", []
    for i in range(2):
        _save_img(str(sbu / "images_train" / "0" / f"sbu_{i}.jpg"), 30 + i)
        annot.append([f"images_train/0/sbu_{i}.jpg", f"the sbu photo {i}"])
    (sbu / "annot.json").write_text(json.dumps(annot))
    vg, regions = root / "vg", []
    for i in range(2):
        _save_img(str(vg / "images" / "VG_100K" / f"{100 + i}.jpg"), 40 + i)
        regions.append({"regions": [
            {"image_id": 100 + i, "phrase": f"a region of the dog {i}", "width": 5,
             "height": 6, "x": 1, "y": 2},
            {"image_id": 100 + i, "phrase": "the red region", "width": 3, "height": 4,
             "x": 0, "y": 0}]})
    (vg / "annotations").mkdir(parents=True)
    (vg / "annotations" / "region_descriptions.json").write_text(json.dumps(regions))
    wk = root / "wikibk"
    wk.mkdir()
    for i in range(2):
        (wk / f"wikibk.{i}.txt").write_text(
            "".join(f"the sentence {j} of shard {i} says a dog\n" for j in range(3)))
    nl, rows = root / "nlvr2root", []
    for i in range(2):
        iden = f"train-{i}-0"
        base = nl / "images" / "train" / "7" / iden
        _save_img(str(base) + "-img0.png", 50 + i, "PNG")
        _save_img(str(base) + "-img1.png", 60 + i, "PNG")
        rows.append({"identifier": iden + "-0", "sentence": f"the images match {i}",
                     "label": "True" if i == 0 else "False", "directory": 7})
    (nl / "nlvr2" / "data").mkdir(parents=True)
    (nl / "nlvr2" / "data" / "train.json").write_text("\n".join(json.dumps(r) for r in rows))
    tv = root / "textvqa"
    _save_img(str(tv / "train_images" / "tvimg0.jpg"), 70)
    for split, qid in (("train", 1), ("val", 2)):
        (tv / f"TextVQA_0.5.1_{split}.json").write_text(json.dumps({"data": [
            {"image_id": "tvimg0", "question_id": qid, "question": f"what does the {split} sign say",
             "answers": ["sign"] * 4 + ["stop sign"] * 6}]}))
    vqa = root / "vqa"
    for image_id in (1, 2):
        _save_img(str(vqa / "img" / f"COCO_val2014_{image_id:012d}.jpg"), 80 + image_id)
    (vqa / "q.json").write_text(json.dumps({"questions": [
        {"question": "what color is the dog?", "question_id": 500, "image_id": 1},
        {"question": "is the cat red?", "question_id": 501, "image_id": 2}]}))
    (vqa / "a.json").write_text(json.dumps({"annotations": [
        {"question_id": 500, "answers": [{"answer": a} for a in ["red"] * 7 + ["two"] * 3]},
        {"question_id": 501, "answers": [{"answer": "yes"}] * 10}]}))


WRITERS = [("write_coco_karpathy", "coco"), ("write_f30k_karpathy", "f30k"),
           ("write_conceptual_caption", "gcc"), ("write_sbu", "sbu"), ("write_vg", "vg"),
           ("write_wikibk", "wikibk"), ("write_nlvr2", "nlvr2root"),
           ("write_text_vqa", "textvqa")]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The raw tree, and the tables the JAX writers made of it (the VQAv2
    table too, by ``arrow_writer.write_vqa_arrow``)."""
    pytest.importorskip("pyarrow")
    pytest.importorskip("PIL")
    raw = tmp_path_factory.mktemp("raw")
    _raw_corpora(raw)
    out = tmp_path_factory.mktemp("arrow_jax")
    for fn, sub in WRITERS:
        getattr(jwriters, fn)(str(raw / sub), str(out))
    jarrow_writer.write_vqa_arrow(str(raw / "vqa" / "q.json"), str(raw / "vqa" / "a.json"),
                                  str(raw / "vqa" / "img"), str(out / "vqav2_val.arrow"))
    return raw, out


def _read(path):
    import pyarrow as pa

    with pa.memory_map(str(path), "r") as source:
        return pa.ipc.RecordBatchFileReader(source).read_all()


def test_port_writers_write_the_jax_writers_tables(corpora, tmp_path):
    """Each writer of the port on the same raw files: the same files, each
    table of an equal schema and equal rows; the VQAv2 writer returns the
    same answer vocabulary."""
    raw, want_dir = corpora
    for fn, sub in WRITERS:
        got = getattr(pretrain_writers, fn)(str(raw / sub), str(tmp_path))
        assert [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in getattr(jwriters, fn)(str(raw / sub), str(tmp_path / "j"))]
    vocab = arrow_writer.write_vqa_arrow(str(raw / "vqa" / "q.json"), str(raw / "vqa" / "a.json"),
                                         str(raw / "vqa" / "img"), str(tmp_path / "vqav2_val.arrow"))
    assert vocab == jarrow_writer.write_vqa_arrow(
        str(raw / "vqa" / "q.json"), str(raw / "vqa" / "a.json"), str(raw / "vqa" / "img"),
        str(tmp_path / "j" / "vqav2_val.arrow"))
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in tmp_path.glob("*.arrow")) == names and len(names) == 17
    for name in names:
        got, want = _read(tmp_path / name), _read(want_dir / name)
        assert got.schema.equals(want.schema), name
        assert got.to_pylist() == want.to_pylist(), name


@pytest.mark.parametrize("name", list(pretrain_datasets.PRETRAIN_DATASETS))
def test_pretrain_datasets_match_jax(corpora, name):
    """Every item of each corpus's train split (and of coco's val split)
    equal to the JAX dataset's on the JAX writers' tables; the pixels of
    the port's NCHW against the JAX package's NHWC."""
    _, root = corpora
    splits = ("train", "val") if name == "coco" else ("train",)
    for split in splits:
        got = pretrain_datasets.make_pretrain_dataset(name, str(root), port_transform(32), split)
        want = jdatasets.make_pretrain_dataset(name, str(root), jax_transform(32), split)
        assert len(got) == len(want) > 0
        assert got.index_mapper == want.index_mapper
        for i in range(len(got)):
            g, w = got[i], want[i]
            assert set(g) == set(w), name
            for k in w:
                if k.startswith("pixels"):
                    assert g[k].shape == (1, 3, 32, 32)
                    np.testing.assert_array_equal(g[k], nchw(w[k]), err_msg=f"{name} {k}")
                else:
                    assert g[k] == w[k], (name, k)
    with pytest.raises(FileNotFoundError):
        pretrain_datasets.make_pretrain_dataset(name, str(root / "none"), port_transform(32))


def test_concat_dataset_matches_jax(corpora):
    _, root = corpora
    parts = [pretrain_datasets.make_pretrain_dataset(n, str(root), port_transform(32))
             for n in ("sbu", "vg", "wikibk")]
    j_parts = [jdatasets.make_pretrain_dataset(n, str(root), jax_transform(32))
               for n in ("sbu", "vg", "wikibk")]
    got, want = pretrain_datasets.ConcatDataset(parts), jdatasets.ConcatDataset(j_parts)
    assert len(got) == len(want) == 2 + 4 + 6
    for i in range(len(got)):
        assert got[i]["question"] == want[i]["question"]
        assert ("pixels" in got[i]) == ("pixels" in want[i])


# ---------------------------------------------------------------------------
# the CLI: --ann, --arrow-root, against the JAX CLI
# ---------------------------------------------------------------------------


def _shallow(cfg):
    """``shallow_albef`` and two VLMo blocks, a split block (``mlp_text`` /
    ``mlp_imag``) and then the VL expert: the JAX references' compiles
    scale with depth."""
    return dataclasses.replace(shallow_albef(cfg), vlmo=dataclasses.replace(
        cfg.vlmo, depth=2, vlffn_start_layer=1))


def _cli_files(tmp_path, task):
    """A vocabulary of the corpora's words and letter pieces, and the same
    shallow tiny RunConfig in both packages' files; the CLI arguments."""
    from vqattack_tpu import config as jcfg

    toks = list(SPECIAL_TOKENS) + WORDS
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        toks += [c, f"##{c}"]
    (tmp_path / "vocab.txt").write_text("\n".join(toks) + "\n")
    cfg = _shallow(tcfg.tiny_test_config(vocab_size=len(toks)))
    tcfg.save_config(cfg, str(tmp_path / "cfg.json"))
    jcfg.save_config(_shallow(jcfg.tiny_test_config(vocab_size=len(toks))),
                     str(tmp_path / "jcfg.json"))
    return cfg, ["--task", task, "--vocab", str(tmp_path / "vocab.txt"), "--batch-size", "2",
                 "--lr", "1e-4", "--log-every", "1", "--image-size", "32"]


TASKS = ["albef_pretrain", "vlmo_pretrain", "vlmo_textmlm"]


@pytest.mark.parametrize("task", TASKS)
def test_cli_trains_from_ann_on_the_cpu(tmp_path, corpora, task):
    """``train.cli.main`` from annotation files and PIL images (the
    question as the caption): three steps, every loss and gradient norm
    finite, a different batch each step."""
    raw, _ = corpora
    _, argv = _cli_files(tmp_path, task)
    ann = [{"image": f"COCO_train_{i:06d}.jpg", "question": q, "question_id": i}
           for i, q in ((0, "a photo of the dog"), (2, "the red cat"), (4, "a dog photo"))]
    (tmp_path / "ann.json").write_text(json.dumps(ann * 2))
    summary = cli.main(argv + ["--config", str(tmp_path / "cfg.json"),
                               "--ann", str(tmp_path / "ann.json"), "--image-root",
                               str(raw / "coco" / "train2014"), "--steps", "3",
                               "--device", "cpu"])
    assert summary["task"] == task and summary["step"] == 3 and len(summary["losses"]) == 3
    assert np.isfinite(summary["losses"] + summary["grad_norms"]).all()
    assert min(summary["grad_norms"]) > 0


class _SeededRandom(random.Random):
    """``random.Random()`` seeded with 0."""

    def __init__(self, seed=None):
        super().__init__(0)


def _recording(make_step, recorded):
    """``make_train_step`` whose steps append ``(state, metrics)`` to
    ``recorded``."""
    def make(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, key):
            state, metrics = step(state, batch, key)
            recorded.append((state, metrics))
            return state, metrics

        return run

    return make


def _adam_mu(opt_state):
    """The first moment of optax's Adam state."""
    nodes = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    (state,) = [n for n in nodes if hasattr(n, "mu")]
    return state.mu


@pytest.mark.parametrize("task", TASKS)
def test_train_step_matches_jax(tmp_path, corpora, task, monkeypatch, row_norm):
    """One step of each task through both CLIs, from ``--arrow-root`` over
    the JAX writers' tables (the task's default corpora: wikibk for
    ``vlmo_textmlm``, else the caption corpora, f30k's absence skipped),
    the JAX model's ``init`` giving the port CLI's random weights, each
    train transform's ``random.Random`` seeded alike, and the port's step key
    replaced by the JAX CLI's, at batch 3: the loss and its terms (the hard
    ALBEF path, VLMo with every weight at 1), every gradient (as Adam's
    first moment after one step, ``mu = 0.1 g``, in both packages),
    ``grad_norm`` and every parameter after the AdamW step."""
    from vqattack_tpu.train import cli as jcli

    _, root = corpora
    for f30k in root.glob("f30k_*.arrow"):  # a corpus missing from the directory
        f30k.rename(tmp_path / f30k.name)
    try:
        cfg, argv = _cli_files(tmp_path, task)
        argv[argv.index("--batch-size") + 1] = "3"  # two hard negatives to draw from a row
        argv += ["--arrow-root", str(root), "--steps", "1"]
        # the JAX CLI's model starts from the port CLI's weights (--seed 0)
        if task == "albef_pretrain":
            j_class, drawn = JAlbefPretrain, init_weights(AlbefPretrain(cfg.albef), 0)
        else:
            j_class, drawn = JVLMo, init_vlmo_weights(VLMo(cfg.vlmo), 0)
        variables = jax_params_of(drawn)
        monkeypatch.setattr(j_class, "init", lambda self, *a, **kw: variables)
        j_rec, t_rec = [], []
        monkeypatch.setattr(jtrainer, "make_train_step",
                            _recording(jtrainer.make_train_step, j_rec))
        monkeypatch.setattr(trainer, "make_train_step", _recording(trainer.make_train_step, t_rec))
        # each train transform's unseeded random.Random seeded alike
        monkeypatch.setattr(random, "Random", _SeededRandom)
        # the JAX CLI leaves the process's compile cache where the suite set it
        monkeypatch.setattr("vqattack_tpu.utils.cache.enable_compile_cache", lambda *a: None)
        jcli.main(argv + ["--config", str(tmp_path / "jcfg.json")])
        monkeypatch.setattr("vqattack_tpu_torch.rng.TorchKey",
                            lambda seed, device: JaxKey(jax.random.key(seed)))
        summary = cli.main(argv + ["--config", str(tmp_path / "cfg.json"), "--device", "cpu"])
    finally:
        for f30k in tmp_path.glob("f30k_*.arrow"):
            f30k.rename(root / f30k.name)
    assert len(j_rec) == len(t_rec) == 1 and summary["step"] == 1
    (j_state, j_metrics), (t_state, t_metrics) = j_rec[0], t_rec[0]
    terms = [k for k in j_metrics if "loss" in k and np.ndim(j_metrics[k]) == 0]
    assert "loss" in terms and (len(terms) > 1) == (task != "vlmo_textmlm")
    for k in terms:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(t_metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    assert summary["losses"] == [float(t_metrics["loss"])]
    model, lr = t_state.model, 1e-4
    # every gradient, as Adam's first moment after one step: 0.1 g in both
    j_mu = _host(_adam_mu(j_state.opt_state))
    _close_grads(model, t_state.opt_state["mu"], j_mu)
    want = _port_layout(model, _host(j_state.params))
    want_g = _port_layout(model, j_mu)
    for name, p in optim.named_params(model).items():
        atol = np.where(np.abs(want_g[name]) > 1e-7, 1e-4 * lr, 2 * lr)
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[name]),
                                     atol + 1e-5 * np.abs(want[name]) + 1e-12, err_msg=name)


def test_cli_arrow_root_without_corpora_exits(tmp_path):
    _, argv = _cli_files(tmp_path, "vlmo_textmlm")
    with pytest.raises(SystemExit, match="no arrow corpora from"):
        cli.main(argv + ["--arrow-root", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--arrow-root, are required"):
        cli.main(argv + ["--device", "cpu"])
