"""The port's models against the JAX package's, on the same weights.

The flax parameters of the tiny geometry (``tiny_test_config``) are loaded
into the port with ``checkpoint/convert.py::load_jax_params``; inputs come
from a seeded numpy generator and go through both packages on the CPU.
``fused_ln`` routes the ViT's residual+LayerNorm sites through K2 (its plain
version on the CPU), in both packages.

Tolerances: forward values rtol 1e-4 / atol 1e-5 and gradients rtol 1e-3 /
atol 1e-6, scaled to each tensor's largest magnitude: float32 matrix
products and reductions accumulate in other orders in the two frameworks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import JaxKey, nchw, nhwc, tiny_configs, tiny_models
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.albef import mlm_random_mask as jax_mlm_random_mask
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.albef import AlbefPretrain, init_weights, mlm_random_mask
from vqattack_tpu_torch.models.layers import PatchEmbed
from vqattack_tpu_torch.rng import TorchKey

VOCAB = 64


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.fixture(scope="module")
def models():
    jc, tc = tiny_configs(VOCAB)
    (j_sur, j_vic, j_mlm), params, (t_sur, t_vic, t_mlm) = tiny_models(jc, tc)
    return jc, tc, (j_sur, j_vic, j_mlm), params, (t_sur, t_vic, t_mlm)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (b, 8)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    ids[1, 6:] = 0
    return px, ids, mask


@pytest.mark.parametrize("fused_ln", [False, True])
def test_albef_pretrain_matches_jax(models, fused_ln):
    """gen_feats (image + text feature stacks, MLM logits), d/dpixels of a
    feature loss, and gen_feats_from_embeds with d/dembeds."""
    jc, tc, _, (p_sur, _, _), (t_sur, _, _) = models
    jc_f = dataclasses.replace(jc.albef, vit=dataclasses.replace(jc.albef.vit, fused_ln=fused_ln))
    tc_f = dataclasses.replace(tc.albef, vit=dataclasses.replace(tc.albef.vit, fused_ln=fused_ln))
    j_sur = JAlbefPretrain(jc_f)
    port = AlbefPretrain(tc_f)
    port.load_state_dict(t_sur.state_dict())
    px, ids, mask = _inputs()
    rng = np.random.default_rng(1)
    w_img = rng.normal(size=(2, 3, 5, 32)).astype(np.float32)
    w_txt = rng.normal(size=(2, 5, 8, 32)).astype(np.float32)

    def jloss(p, x):
        img, txt, logits = j_sur.apply(p, x, ids, mask, method=JAlbefPretrain.gen_feats)
        return (jnp.sum(img * w_img) + jnp.sum(txt * w_txt)), (img, txt, logits)

    (_, (j_img, j_txt, j_logits)), j_g = jax.jit(
        jax.value_and_grad(jloss, argnums=1, has_aux=True))(p_sur, jnp.asarray(px))

    x = torch.from_numpy(nchw(px)).requires_grad_(True)
    img, txt, logits = port.gen_feats(x, torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert img.shape == (2, 3, 5, 32) and txt.shape == (2, 5, 8, 32)
    loss = (img * torch.from_numpy(w_img)).sum() + (txt * torch.from_numpy(w_txt)).sum()
    (g,) = torch.autograd.grad(loss, x)
    _close(img.detach(), j_img, 1e-4, 1e-5)
    _close(txt.detach(), j_txt, 1e-4, 1e-5)
    _close(logits.detach(), j_logits, 1e-4, 1e-5)
    _close(nhwc(g), j_g, 1e-3, 1e-6)

    # the text-embedding-differentiable variant of the VL step
    emb = j_sur.apply(p_sur, jnp.asarray(ids), method=JAlbefPretrain.embed_text)

    def jvl(e):
        i, t = j_sur.apply(p_sur, jnp.asarray(px), e, mask,
                           method=JAlbefPretrain.gen_feats_from_embeds)
        return jnp.sum(t * w_txt) + jnp.sum(i * w_img)

    j_ge = jax.jit(jax.grad(jvl))(emb)
    e = port.embed_text(torch.from_numpy(ids).long()).detach()
    _close(e, emb, 1e-5, 1e-6)
    e.requires_grad_(True)
    i2, t2 = port.gen_feats_from_embeds(torch.from_numpy(nchw(px)), e,
                                        torch.from_numpy(mask).long())
    (ge,) = torch.autograd.grad((t2 * torch.from_numpy(w_txt)).sum()
                                + (i2 * torch.from_numpy(w_img)).sum(), e)
    _close(ge, j_ge, 1e-3, 1e-6)


def test_candidate_mlm_text_mode_matches_jax(models):
    _, _, (_, _, j_mlm), (_, _, p_mlm), (_, _, t_mlm) = models
    _, ids, mask = _inputs(2)
    j_last, j_feats, j_logits = j_mlm.apply(p_mlm, ids, mask, mode="text")
    last, feats, logits = t_mlm(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                                mode="text")
    _close(last.detach(), j_last, 1e-4, 1e-5)
    _close(feats.detach(), j_feats, 1e-4, 1e-5)
    _close(logits.detach(), j_logits, 1e-4, 1e-5)


def test_albef_vqa_rank_answer_matches_jax(models):
    """Same ranked answer ids; probabilities within 1e-4."""
    jc, _, (_, j_vic, _), (_, p_vic, _), (_, t_vic, _) = models
    px, ids, mask = _inputs(3)
    rng = np.random.default_rng(4)
    a_ids = rng.integers(5, VOCAB, (6, 4)).astype(np.int32)
    a_ids[:, 0] = 2
    a_mask = np.ones_like(a_ids)
    a_mask[2:, 3] = 0
    a_ids[2:, 3] = 0
    j_ids, j_probs = jax.jit(lambda p: j_vic.apply(
        p, px, ids, mask, jnp.asarray(a_ids), jnp.asarray(a_mask), 4))(p_vic)
    t_ids, t_probs = t_vic(torch.from_numpy(nchw(px)), torch.from_numpy(ids).long(),
                           torch.from_numpy(mask).long(), torch.from_numpy(a_ids).long(),
                           torch.from_numpy(a_mask).long(), 4)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_probs.detach().numpy(), np.asarray(j_probs), atol=1e-4)


def test_mlm_random_mask_replays_jax_draws():
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 1000, (4, 25)).astype(np.int32)
    ids[:, 0] = 101
    ids[2, 20:] = 0
    key = jax.random.key(7)
    j_out, j_lab = jax_mlm_random_mask(key, jnp.asarray(ids), 1000, 103, 0, 101, 0.15)
    t_out, t_lab = mlm_random_mask(JaxKey(key), torch.from_numpy(ids).long(), 1000, 103, 0, 101,
                                   0.15)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))


def test_torch_key_mask_rates():
    """The port's own sampler: 15% of the selectable positions, then 80%
    [MASK], 10% a random token, 10% kept.  Tolerances: 1 percentage point
    for the selection (~6,100 draws of 40,000 positions), 3 for the split."""
    ids = torch.full((64, 625), 500, dtype=torch.long)
    ids[:, 0] = 101
    out, labels = mlm_random_mask(TorchKey(0, "cpu"), ids, 30522, 103, 0, 101, 0.15)
    sel = labels != -100
    assert not sel[:, 0].any()
    rate = sel[:, 1:].float().mean().item()
    assert abs(rate - 0.15) < 0.01
    masked = (out[sel] == 103).float().mean().item()
    kept = (out[sel] == 500).float().mean().item()
    assert abs(masked - 0.8) < 0.03
    assert abs(kept - 0.1) < 0.03  # a random token equal to 500 is 1 in 30,522
    assert torch.equal(out[~sel], ids[~sel])


def test_load_jax_params_rejects_mismatches(models):
    _, tc, _, (p_sur, _, _), _ = models
    tree = jax.tree_util.tree_map(np.asarray, p_sur)["params"]
    port = AlbefPretrain(tc.albef)
    missing = {k: v for k, v in tree.items() if k != "itm_head"}
    with pytest.raises(KeyError, match="itm_head"):
        load_jax_params(port, missing)
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(port, extra)
    bad = dict(tree, itm_head={"kernel": np.zeros((3, 2), np.float32),
                               "bias": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="itm_head"):
        load_jax_params(port, bad)


def test_patch_embed_rejects_indivisible_images():
    with pytest.raises(ValueError, match="not divisible"):
        PatchEmbed(16, 3, 8)(torch.zeros(1, 3, 40, 32))


def test_init_weights_is_seeded(models):
    _, tc, _, _, _ = models
    a = init_weights(AlbefPretrain(tc.albef), seed=3).state_dict()
    b = init_weights(AlbefPretrain(tc.albef), seed=3).state_dict()
    c = init_weights(AlbefPretrain(tc.albef), seed=4).state_dict()
    key = "visual_encoder.blocks.0.attn.query.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])
    assert torch.equal(a["visual_encoder.norm.weight"], torch.ones(32))
