"""The port's Grad-CAM analysis path and evaluators against the JAX package's.

The cross-attention probe and ``albef_question_gradcam`` on the tiny ALBEF,
the probe's path under ``attention_impl("flash")``, both ``visualize`` CLIs
on one image and checkpoint, the grounding resize against
``jax.image.resize`` (and not ``F.interpolate``), ``grounding_accuracy``
on a synthetic RefCOCO layout, the caption scorers and the retrieval
recalls.  The models' weights are synthetic state dicts in the reference's
names through the JAX package's converter, so no JAX initialisation
compiles."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import nchw, synth_assets_module
from vqattack_tpu import config as jcfg
from vqattack_tpu import visualize as jvisualize
from vqattack_tpu.checkpoint.convert import convert_albef_pretrain as jconvert_albef
from vqattack_tpu.eval import caption_scorers as jcap
from vqattack_tpu.eval import grounding as jground
from vqattack_tpu.eval import retrieval_eval as jret
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.utils.gradcam import albef_question_gradcam as j_gradcam
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch import visualize as tvisualize
from vqattack_tpu_torch.checkpoint import synthetic
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.eval import caption_scorers as tcap
from vqattack_tpu_torch.eval import grounding as tground
from vqattack_tpu_torch.eval import retrieval_eval as tret
from vqattack_tpu_torch.models.albef import AlbefPretrain
from vqattack_tpu_torch.models.layers import MultiHeadAttention
from vqattack_tpu_torch.ops import attention
from vqattack_tpu_torch.utils.gradcam import albef_question_gradcam

T = torch.from_numpy


def _albef_tree(a, seed=1):
    sd = synthetic.albef_pretrain_state_dict(a, seed=seed, src_image_size=a.vit.image_size)
    return {"params": jconvert_albef({k: v.numpy() for k, v in sd.items()}, depth=a.vit.depth,
                                     num_layers=a.bert.num_layers,
                                     fusion_layer=a.bert.fusion_layer)}


# ---------------------------------------------------------------------------
# the probe and Grad-CAM
# ---------------------------------------------------------------------------


def test_visualize_clis_match(tmp_path, monkeypatch, capsys):
    """Both ``visualize`` CLIs on one image, vocabulary, config (width 32 at
    the reference depth, which the JAX loader converts) and synthetic
    ``--surrogate-ckpt``: the PNGs within one level a channel."""
    synth = synth_assets_module()
    synth.make_vocab(str(tmp_path / "vocab.txt"))
    synth.make_image(str(tmp_path / "img.png"), size=80)
    configs = []
    for mod in (jcfg, tcfg):
        c = mod.tiny_test_config(image_size=64, vocab_size=30522)
        albef = dataclasses.replace(
            c.albef, vit=dataclasses.replace(c.albef.vit, depth=12),
            bert=dataclasses.replace(c.albef.bert, num_layers=12, fusion_layer=6))
        configs.append(dataclasses.replace(c, albef=albef))
    jcfg.save_config(configs[0], str(tmp_path / "jcfg.json"))
    tcfg.save_config(configs[1], str(tmp_path / "tcfg.json"))
    sd = synthetic.albef_pretrain_state_dict(configs[1].albef, seed=2, src_image_size=32)
    torch.save({"model": sd}, tmp_path / "ALBEF.pth")
    common = ["--image", str(tmp_path / "img.png"), "--question", "what color is the dog",
              "--vocab", str(tmp_path / "vocab.txt"), "--surrogate-ckpt",
              str(tmp_path / "ALBEF.pth")]
    monkeypatch.setattr("vqattack_tpu.utils.cache.enable_compile_cache", lambda *a: None)
    jvisualize.main(common + ["--config", str(tmp_path / "jcfg.json"),
                              "--out", str(tmp_path / "jax.png")])
    cam = tvisualize.main(common + ["--config", str(tmp_path / "tcfg.json"),
                                    "--out", str(tmp_path / "port.png"), "--device", "cpu"])
    assert cam.shape == (4, 4) and cam.max() > 0
    assert "wrote" in capsys.readouterr().out
    from PIL import Image

    j_png = np.asarray(Image.open(tmp_path / "jax.png")).astype(int)
    t_png = np.asarray(Image.open(tmp_path / "port.png")).astype(int)
    assert j_png.shape == t_png.shape == (64, 64, 3)
    assert np.abs(j_png - t_png).max() <= 1


def test_gradcam_matches_jax():
    """``albef_question_gradcam`` at layer 3 (of 4, fusion from 2) at 64 px
    (a 4x4 grid) on a padded question: within 1e-5 of the JAX map's largest value,
    non-negative, not all zero.  (The JAX function runs eagerly; at the
    shapes of :func:`test_visualize_clis_match`, which runs first, its
    primitives are compiled already.)"""
    jc, tc = (c.albef for c in (jcfg.tiny_test_config(64), tcfg.tiny_test_config(64)))
    tree = _albef_tree(tc)
    model = load_jax_params(AlbefPretrain(tc), tree).eval().requires_grad_(False)
    rng = np.random.default_rng(4)
    px = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ids = np.array([[2, 10, 11, 12, 13, 3, 0, 0]], np.int32)
    mask = (ids > 0).astype(np.int32)
    want = j_gradcam(JAlbefPretrain(jc), jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask), layer=3)
    got = albef_question_gradcam(model, T(nchw(px)), T(ids).long(), T(mask).long(), layer=3)
    assert got.shape == want.shape == (1, 4, 4)
    assert got.min() >= 0 and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_a_probed_layer_never_reaches_the_flash_call(monkeypatch):
    """Under ``attention_impl("flash")`` at 130 queries: without a probe the
    layer calls the flash kernel's wrapper; with one it takes the product +
    softmax path, whose output equals the wrapper's times the probe's
    effect, and the probe gets grad x attention as its gradient."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(16, 2).eval()
    x = torch.randn(2, 130, 16)
    calls = []
    real = attention.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    with attention.attention_impl("flash"), torch.no_grad():
        plain = mha(x)
    assert len(calls) == 1
    scale = torch.ones(2, 2, 130, 130, requires_grad=True)
    with attention.attention_impl("flash"):
        probed = mha(x, attn_scale=scale)
        (g,) = torch.autograd.grad(probed.sum(), scale)
    assert len(calls) == 1
    torch.testing.assert_close(probed.detach(), plain, rtol=1e-5, atol=1e-6)
    # grad x attention, directly: d sum(out) / d p_ij = p_ij * sum_d v_jd
    with torch.no_grad():
        q = mha.query(x).view(2, 130, 2, 8).transpose(1, 2)
        k = mha.key(x).view(2, 130, 2, 8).transpose(1, 2)
        v = mha.value(x).view(2, 130, 2, 8).transpose(1, 2)
        p = torch.softmax(q @ k.transpose(-1, -2) * 8 ** -0.5, -1)
        want = p * mha.proj.weight.sum(0).view(2, 8)[None, :, None, :].mul(v).sum(-1)[:, :, None]
    torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the grounding resize and accuracy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,h,w", [(24, 333, 500), (30, 480, 640), (48, 20, 30)])
def test_upsample_bicubic_matches_jax_image_resize(m, h, w):
    """Keys' cubic with a = -0.5, renormalised at the edges, antialiased
    where it shrinks (48 -> 20x30): within 1e-5 of ``jax.image.resize``."""
    mask = np.random.default_rng(m).uniform(0, 1, (m, m)).astype(np.float32)
    want = np.asarray(jax.image.resize(mask, (h, w), method="bicubic"))
    got = tground._upsample_bicubic(T(mask), h, w)
    assert got.shape == (h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tground._upsample_bicubic(mask, h, w).numpy(), want, rtol=0,
                               atol=1e-5)


def test_upsample_bicubic_is_not_f_interpolate():
    """PyTorch's bicubic (a = -0.75, border replicated) differs from JAX's by
    more than 0.05 on a uniform 24x24 mask at 333x500."""
    mask = np.random.default_rng(24).uniform(0, 1, (24, 24)).astype(np.float32)
    want = np.asarray(jax.image.resize(mask, (333, 500), method="bicubic"))
    torch_bicubic = F.interpolate(T(mask)[None, None], size=(333, 500), mode="bicubic",
                                  align_corners=False)[0, 0].numpy()
    assert np.abs(torch_bicubic - want).max() > 0.05
    w = tground.bicubic_weights(24, 333)
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=0, atol=1e-12)


def _refer(tmp_path):
    """A RefCOCO layout (``refs(unc).json`` + ``instances.json``): four
    images of 333-640 px, one ref each over the three splits and one with
    no split, two to four fractional detection boxes an image."""
    rng = np.random.default_rng(0)
    sizes = [(333, 500), (480, 640), (427, 640), (640, 480)]
    images, anns, refs, dets = [], [], [], {}
    for i, (h, w) in enumerate(sizes):
        images.append({"id": i, "height": h, "width": w})
        box = [float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
               float(rng.uniform(w / 8, w / 2)), float(rng.uniform(h / 8, h / 2))]
        anns.append({"id": 100 + i, "image_id": i, "bbox": box, "category_id": 1})
        refs.append({"ref_id": 200 + i, "ann_id": 100 + i, "image_id": i,
                     "split": ["val", "testA", "testB", "train"][i]})
        cands = [[b + 0.37 for b in box]] + [
            [float(rng.uniform(0, w / 2)) + 0.5, float(rng.uniform(0, h / 2)) + 0.25,
             float(rng.uniform(20, w / 2)) + 0.75, float(rng.uniform(20, h / 2)) + 0.5, 0.9]
            for _ in range(1 + i % 3)]
        dets[str(i)] = cands
    root = tmp_path / "refcoco+"
    root.mkdir()
    (root / "refs(unc).json").write_text(json.dumps(refs))
    (root / "instances.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "dog"}]}))
    return str(tmp_path), dets


def test_grounding_accuracy_matches_jax(tmp_path):
    """The same accuracies a split (and IoUs) from both packages: maps with
    a hot spot on the ref box for two refs, on a decoy for one, noise for
    the last; one map given as a tensor."""
    root, dets = _refer(tmp_path)
    j_ref, t_ref = jground.Refer(root), tground.Refer(root)
    assert t_ref.getRefIds() == j_ref.getRefIds() and t_ref.getRefIds("val") == [200]
    rng = np.random.default_rng(1)
    results = []
    for i, rid in enumerate(t_ref.getRefIds()):
        img = t_ref.Imgs[t_ref.Refs[rid]["image_id"]]
        box = dets[str(i)][0] if i != 1 else dets[str(i)][1]
        pred = rng.uniform(0, 0.1, (24, 24)).astype(np.float32)
        if i < 3:
            r0, c0 = int(box[1] / img["height"] * 24), int(box[0] / img["width"] * 24)
            pred[r0:r0 + 4, c0:c0 + 4] += 1.0
        results.append({"ref_id": rid, "pred": T(pred) if i == 2 else pred})
    j_results = [{**r, "pred": np.asarray(r["pred"])} for r in results]
    got = tground.grounding_accuracy(results, dets, t_ref)
    assert got == jground.grounding_accuracy(j_results, dets, j_ref)
    assert set(got) == {"val_d", "testA_d", "testB_d"} and got["val_d"] == 1.0
    for b1, b2 in ((dets["0"][0], t_ref.getRefBox(200)), (dets["1"][1], dets["1"][0])):
        assert tground.compute_iou(b1, b2) == jground.compute_iou(b1, b2)


# ---------------------------------------------------------------------------
# caption scorers and retrieval recalls
# ---------------------------------------------------------------------------


def test_caption_scorers_match_jax():
    cands = ["a dog runs in the park", "the red hat", "a cat", ""]
    refs = [["a dog is running in a park", "dog runs in the park"], ["a red hat", "the hat"],
            ["a black cat sits"], ["nothing here"]]
    for name in ("bleu", "rouge_l", "cider"):
        got = getattr(tcap, name)(cands, refs)
        assert got == getattr(jcap, name)(cands, refs), name
    assert tcap.bleu(cands[:2], refs[:2]) > 0 and tcap.cider(cands, refs) > 0


def test_retrieval_recalls_match_jax():
    """``irtr_recall``, the ITM re-rank and the IRTR loss from features and
    scores given as tensors (the port) and arrays (JAX): the same recalls."""
    rng = np.random.default_rng(2)
    img = rng.normal(size=(6, 8)).astype(np.float32)
    txt = (np.repeat(img, 2, axis=0) + rng.normal(size=(12, 8)) * 0.8).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    gt = np.repeat(np.arange(6), 2)
    itm = rng.normal(size=(12, 6)).astype(np.float32)
    itm[np.arange(12), gt] += 1.0
    got = tret.irtr_recall(T(img), T(txt), T(gt), ks=(1, 3))
    assert got == jret.irtr_recall(img, txt, gt, ks=(1, 3))
    assert 0 < got["t2i_r@1"] < 1
    got = tret.irtr_recall_with_rerank(T(img), T(txt), gt, lambda t, i: T(itm[t, i]),
                                       k_test=3, ks=(1, 3))
    assert got == jret.irtr_recall_with_rerank(img, txt, gt, lambda t, i: itm[t, i],
                                               k_test=3, ks=(1, 3))
    assert tret.recall_at_k(itm, gt) == jret.recall_at_k(itm, gt)
    pos, negs = itm[np.arange(12), gt], itm[:, :3]
    assert tret.irtr_loss_np(T(pos), T(negs)) == jret.irtr_loss_np(pos, negs)
