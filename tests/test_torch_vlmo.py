"""The port's VLMo against the JAX package's, on the same weights, and the
two-term attention it hands to kernel K3.

The flax parameters of the tiny VLMo (``tiny_test_config`` at 2 blocks of
width 32, the VL expert in the last, 13 joint tokens) are the port's random
weights, which ``load_jax_params`` must load back leaving no leaf unused; inputs come
from a seeded numpy generator.  The tiny joint sequence is under the flash
threshold of 128 queries, so the two-term attention (the relative-position
table as ``bias``, the padded-text mask as ``key_bias``) is held to the JAX
sum ``bias + mask`` directly at 130 tokens.

Tolerances: forward values rtol 1e-4 / atol 1e-5 and gradients rtol 1e-3 /
atol 1e-6, scaled to each tensor's largest magnitude (float32 products and
reductions in other orders); the emulated kernel arithmetic within the
card's 2e-5 of each tensor's largest magnitude (at least 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (assert_same_tree, init_tree_shapes, jit_apply, nchw, tiny_vlmo,
                             tiny_vlmo_configs)
from vqattack_tpu.models.layers import MultiHeadAttention as JMultiHeadAttention
from vqattack_tpu.models.layers import mask_to_bias as jmask_to_bias
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.models.vlmo import build_relative_position_index as jbuild_index
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.layers import MultiHeadAttention, mask_to_key_bias
from vqattack_tpu_torch.models.vlmo import VLMo, build_relative_position_index
from vqattack_tpu_torch.ops import attention

T = torch.from_numpy
VOCAB = 64


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("window,text_len", [((2, 2), 8), ((30, 30), 40)])
def test_relative_position_index_equals_jax(window, text_len):
    """The tiny tables and the full 480 px / 40-token ones."""
    t, j = build_relative_position_index(window, text_len), jbuild_index(window, text_len)
    assert t["all_num_relative_distance"] == j["all_num_relative_distance"]
    for kind in ("image", "text", "joint"):
        assert t[kind].dtype == j[kind].dtype == np.int32
        np.testing.assert_array_equal(t[kind], j[kind])
    assert t["joint"].shape == ((text_len + window[0] * window[1] + 1),) * 2


@pytest.fixture(scope="module")
def vlmo():
    jc, tc = tiny_vlmo_configs(VOCAB, depth=2)
    return tiny_vlmo(jc, tc)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (b, 8)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones_like(ids)
    mask[1, 5:] = 0  # padded text keys in the middle of the joint sequence
    ids[1, 5:] = 0
    return px, ids, mask


def _long(a):
    return T(np.asarray(a)).long()


def test_load_jax_params_takes_every_leaf_of_init_all(vlmo):
    """Both experts of the VL layer, the ITC projections, both logit scales,
    ``itm_score``, the bare layer scales and the relative-position table:
    every leaf has its parameter (``load_jax_params`` raises on a leftover),
    and the port's tree is flax's ``init_all`` tree, leaf for leaf."""
    j_model, params, model = vlmo
    cfg = j_model.cfg
    ids = jnp.ones((1, cfg.max_text_len), jnp.int32)
    assert_same_tree(params, init_tree_shapes(
        j_model, ids, ids, jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
        method=JVLMo.init_all))
    load_jax_params(VLMo(model.cfg), params)
    p = params["params"]
    assert set(p["blocks_1"]) >= {"mlp_text", "mlp_imag", "mlp_vl", "norm2_vl", "gamma_1"}
    assert p["logit_vl_scale"]["scale"].shape == ()
    n_leaves = len(jax.tree_util.tree_leaves(p))
    assert n_leaves == len(list(model.parameters()))
    assert "key" in p["blocks_0"]["attn"] and "bias" not in p["blocks_0"]["attn"]["key"]
    assert model.blocks[0].attn.key.bias is None


def test_infer_infer_text_and_biases_match_jax(vlmo):
    j_model, params, model = vlmo
    px, ids, mask = _inputs()
    j = jit_apply(j_model, params, ids, mask, px, method=JVLMo.infer)
    with torch.no_grad():
        t = model.infer(_long(ids), _long(mask), T(nchw(px)))
    for k in ("text_feats", "image_feats", "cls_feats", "raw_cls_feats", "feats"):
        _close(t[k].numpy(), j[k], 1e-4, 1e-5)
    j = jit_apply(j_model, params, ids, mask, vlffn=True, method=JVLMo.infer_text)
    with torch.no_grad():
        t = model.infer_text(_long(ids), _long(mask), vlffn=True)
    for k in ("text_feats", "cls_feats", "mlm_logits", "feats", "cls_vlffn_feats"):
        _close(t[k].numpy(), j[k], 1e-4, 1e-5)
    j_b = j_model.apply(params, method=JVLMo.precompute_joint_biases)
    t_b = model.precompute_joint_biases()
    assert t_b.shape == (2, 2, 13, 13) and not t_b.requires_grad and t_b.is_contiguous()
    np.testing.assert_array_equal(t_b.numpy(), np.asarray(j_b))


def test_attack_closures_and_their_gradients_match_jax(vlmo):
    """attack_feats (with and without the precomputed biases), attack_mlm
    and attack_feats_from_embeds: outputs and d/dpixels (and d/dembeds) of a
    weighted sum; vqa_logits."""
    j_model, params, model = vlmo
    px, ids, mask = _inputs(1)
    rng = np.random.default_rng(2)
    w_tok = rng.normal(size=(2, 3, 13, 32)).astype(np.float32)
    w_cls = rng.normal(size=(2, 3, 32)).astype(np.float32)
    rel = model.precompute_joint_biases()
    j_rel = j_model.apply(params, method=JVLMo.precompute_joint_biases)
    embeds = np.array(j_model.apply(params, ids, method=JVLMo.embed_text))
    np.testing.assert_allclose(model.embed_text(_long(ids)).detach().numpy(), embeds,
                               rtol=1e-4, atol=1e-5)

    def jloss(method, text):
        def f(p, x, t):
            out = j_model.apply(p, x, t, mask, j_rel, method=method)
            return jnp.sum(out[1] * w_cls) + jnp.sum(out[2] * w_tok) + jnp.sum(out[0]), out
        return jax.value_and_grad(f, argnums=(1, 2) if text is embeds else 1, has_aux=True)

    cases = [(JVLMo.attack_feats, model.attack_feats, ids),
             (JVLMo.attack_mlm, model.attack_mlm, ids),
             (JVLMo.attack_feats_from_embeds, model.attack_feats_from_embeds, embeds)]
    for j_method, t_method, text in cases:
        (_, j_out), j_g = jax.jit(jloss(j_method, text))(params, jnp.asarray(px),
                                                         jnp.asarray(text))
        x = T(nchw(px)).requires_grad_(True)
        t_text = T(text).requires_grad_(True) if text is embeds else _long(text)
        out = t_method(x, t_text, _long(mask), rel)
        loss = (out[1] * T(w_cls)).sum() + (out[2] * T(w_tok)).sum() + out[0].sum()
        if text is embeds:
            g_x, g_t = torch.autograd.grad(loss, (x, t_text))
            _close(g_t.numpy(), j_g[1], 1e-3, 1e-6)
            j_gx = j_g[0]
        else:
            (g_x,) = torch.autograd.grad(loss, x)
            j_gx = j_g
        for a, b in zip(out, j_out):
            _close(a.detach().numpy(), b, 1e-4, 1e-5)
        _close(g_x.numpy(), nchw(j_gx), 1e-3, 1e-6)
    # without the precomputed biases: the per-layer gathers, the same numbers
    with torch.no_grad():
        a = model.attack_feats(T(nchw(px)), _long(ids), _long(mask))
        b = model.attack_feats(T(nchw(px)), _long(ids), _long(mask), rel)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    j_logits = jit_apply(j_model, params, px, ids, mask, method=JVLMo.vqa_logits)
    with torch.no_grad():
        t_logits = model.vqa_logits(T(nchw(px)), _long(ids), _long(mask))
    assert t_logits.shape == (2, 16)
    _close(t_logits.numpy(), j_logits, 1e-4, 1e-5)


# ---------------------------------------------------------------------------
# the two-term attention: 130 tokens, 40 of them text, the last 12 text keys
# padded (the masked keys sit in the middle of the sequence)
# ---------------------------------------------------------------------------

S, TEXT, H, DH = 130, 40, 2, 64
SCALE = DH ** -0.5


def _two_terms(seed, b=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, S, H, DH)).astype(np.float32) for _ in range(3))
    table = (rng.normal(size=(1, H, S, S)) * 0.5).astype(np.float32)
    mask = np.ones((b, S), np.int32)
    mask[1, TEXT - 12 : TEXT] = 0
    return q, k, v, table, mask


def _jax_einsum(q, k, v, bias):
    """The JAX ``MultiHeadAttention`` einsum path with one summed bias."""
    attn = jnp.einsum("bqhd,bkhd->bhqk", q * SCALE, k) + bias
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(attn, axis=-1), v)


def test_two_term_attention_matches_the_jax_summed_bias():
    """The plain version (``flash_attention`` on a CPU tensor) and the
    port's ``MultiHeadAttention`` on both paths, with the table as ``bias``
    and the mask as ``key_bias``, against the JAX einsum path with the sum
    ``table + mask`` (its VLMo form, ``rel_biases[i][None] + mask_bias``)."""
    q, k, v, table, mask = _two_terms(0)
    j_bias = jnp.asarray(table) + jmask_to_bias(jnp.asarray(mask), jnp.float32)
    ref = np.asarray(_jax_einsum(q, k, v, j_bias))
    kb = mask_to_key_bias(T(mask))
    for kbias in (kb, kb[:, None, None, :]):  # [B, Sk] and its [B, 1, 1, Sk] view
        out = attention.flash_attention(T(q), T(k), T(v), T(table), SCALE, key_bias=kbias)
        _close(out.numpy(), ref, 1e-5, 1e-5)

    x = np.random.default_rng(1).normal(size=(2, S, H * DH)).astype(np.float32)
    j_mha = JMultiHeadAttention(num_heads=H, head_dim=DH, out_dim=H * DH, k_bias=False)
    params = jax.jit(j_mha.init)(jax.random.key(0), x)
    ref = np.asarray(j_mha.apply(params, x, bias=j_bias))
    t_mha = load_jax_params(MultiHeadAttention(H * DH, H, k_bias=False), jax.device_get(params))
    for impl in ("xla", "flash"):
        with attention.attention_impl(impl), torch.no_grad():
            out = t_mha(T(x), bias=T(table), key_bias=kb).numpy()
        _close(out, ref, 1e-5, 1e-5)


def _emulated(q, k, v, table, key_bias, do):
    """``(o, dq, dk, dv)`` with the kernel's arithmetic on the CPU: every
    product through ``mm_3xtf32``, the scores ``(s * scale + table) +
    key_bias`` as the kernel adds them, P recomputed from the log-sum-exp."""
    mm = attention.mm_3xtf32
    qh, kh, vh, doh = (T(x).transpose(1, 2) for x in (q, k, v, do))
    s = mm(qh, kh.transpose(-1, -2)) * SCALE + T(table) + T(key_bias)[:, None, None, :]
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = mm(p, vh)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - (doh * o).sum(-1, keepdim=True))
    grads = (mm(ds, kh) * SCALE, mm(ds.transpose(-1, -2), qh) * SCALE,
             mm(p.transpose(-1, -2), doh))
    return [t.transpose(1, 2).numpy() for t in (o, *grads)]


@pytest.mark.parametrize("fill", [-1e9, -np.inf])
def test_the_kernels_two_term_arithmetic_matches_the_jax_oracle(fill):
    """The emulated kernel against ``jax.vjp`` of the einsum path with the
    summed bias, forward and gradients, within the card's 2e-5; ``fill`` is
    the masked keys' value (the model's -1e9, or ``-inf``)."""
    q, k, v, table, mask = _two_terms(3)
    key_bias = np.where(mask > 0, 0.0, fill).astype(np.float32)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    j_bias = jnp.asarray(table) + jnp.asarray(key_bias)[:, None, None, :]
    out, vjp = jax.vjp(lambda q, k, v: _jax_einsum(q, k, v, j_bias), q, k, v)
    refs = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    for name, got, ref in zip(("o", "dq", "dk", "dv"), _emulated(q, k, v, table, key_bias, do),
                              refs):
        assert np.isfinite(got).all(), name
        err = float(np.abs(got - ref).max())
        assert err <= 2e-5 * max(1.0, float(np.abs(ref).max())), f"{name}: max abs err {err}"


def test_two_term_backward_reference_matches_autograd():
    """``flash_attention_bwd_reference`` with both terms (the kernel's
    backward from the log-sum-exp) against autograd of the plain forward."""
    q, k, v, table, mask = _two_terms(5)
    kb = mask_to_key_bias(T(mask))
    xs = [T(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = attention.flash_attention_reference(*xs, T(table), SCALE, return_lse=True,
                                                 key_bias=kb)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(o, xs, do)
    got = attention.flash_attention_bwd_reference(*(x.detach() for x in xs), T(table), SCALE,
                                                  o.detach(), lse.detach(), do, key_bias=kb)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), 1e-5, 1e-6)
