"""Flash attention (kernel K3's plain versions) against the JAX package:
the library kernel's own oracle behind the JAX wrapper's padding and bias
preparation, the JAX einsum path of ``MultiHeadAttention``, ``jax.grad`` of
that path for the backward written from the log-sum-exp, the kernel's
3xTF32 arithmetic (emulated) against both, and the port's
``MultiHeadAttention`` flash branch against its product + softmax path on a
tiny ViT with more than 128 tokens."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from torch_port_util import assert_same_tree, init_tree_shapes, jax_params_of, jit_apply, nchw
from vqattack_tpu import config as jcfg
from vqattack_tpu.models.layers import MultiHeadAttention as JMultiHeadAttention
from vqattack_tpu.models.vit import VisionTransformer as JVisionTransformer
from vqattack_tpu.ops.attention import _prepare
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.albef import init_weights
from vqattack_tpu_torch.models.layers import MultiHeadAttention
from vqattack_tpu_torch.models.vit import VisionTransformer
from vqattack_tpu_torch.ops import attention

T = torch.from_numpy
B, H, DH = 2, 2, 64
SCALE = DH ** -0.5


def _qkv(s: int, seed: int, b: int = B):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, H, DH)).astype(np.float32) for _ in range(3)]


def _bias(kind: str, s: int, seed: int):
    rng = np.random.default_rng(seed + 100)
    if kind == "dense":  # the VLMo relative-position form
        return (rng.normal(size=(B, H, s, s)) * 0.5).astype(np.float32)
    if kind == "key_mask":  # a [B, 1, 1, S] key mask, the last key masked
        mask = np.ones((B, s), np.float32)
        if s > 1:
            mask[1, -1] = 0.0
        return np.where(mask > 0, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return None


def _jax_einsum(q, k, v, bias):
    """The einsum path of the JAX ``MultiHeadAttention`` (``layers.py``)."""
    attn = jnp.einsum("bqhd,bkhd->bhqk", q * SCALE, k)
    if bias is not None:
        attn = attn + bias
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(attn, axis=-1), v)


CASES = [(s, kind) for s in (1, 130) for kind in ("none", "dense", "key_mask")]


@pytest.mark.parametrize("s,kind", CASES)
def test_flash_attention_matches_the_library_oracle(s, kind):
    """The port's ``flash_attention`` (the plain path on the CPU) against the
    JAX wrapper's ``_prepare`` (padding to 128 with segment ids, or the
    pre-divided dense bias with its key pad) and the library kernel's
    ``mha_reference``, sliced back to ``Sq``.  Tolerance 2e-5 absolute on
    outputs of order 1, the bound the JAX package's own test gives this
    oracle: float32 sums over up to 130 keys in another order."""
    q, k, v = _qkv(s, seed=s)
    bias = _bias(kind, s, seed=s)
    qt, kt, vt, ab, seg, sq = _prepare(q, k, v, None if bias is None else jnp.asarray(bias), SCALE)
    ref = mha_reference(qt, kt, vt, ab, segment_ids=None if seg is None else SegmentIds(*seg),
                        sm_scale=SCALE)
    ref = np.asarray(ref)[:, :, :sq].transpose(0, 2, 1, 3)
    out = attention.flash_attention(T(q), T(k), T(v), None if bias is None else T(bias), SCALE)
    assert out.shape == (B, s, H, DH)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("s,kind", CASES)
def test_flash_attention_and_its_backward_match_the_einsum_path(s, kind):
    """Forward against the JAX einsum path; the log-sum-exp backward
    (``flash_attention_bwd_reference``, the kernel's algorithm) against
    ``jax.vjp`` of that path for dq, dk and dv.  Tolerance 1e-5 relative to
    each tensor's largest magnitude, and at least 1e-5: float32
    reassociation over at most 130 keys or queries, and P recomputed as
    exp(S - L) instead of the softmax's exp(S - max) / sum.  (With one key,
    dq and dk are exactly 0 and what is computed is the rounding residue of
    P * (dO V^T - D), whose terms are of order 1.)"""
    q, k, v = _qkv(s, seed=10 + s)
    bias = _bias(kind, s, seed=10 + s)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else T(bias)
    do = np.random.default_rng(20 + s).normal(size=(B, s, H, DH)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda q, k, v: _jax_einsum(q, k, v, jb), q, k, v)
    j_grads = vjp(jnp.asarray(do))

    o, lse = attention.flash_attention_reference(T(q), T(k), T(v), tb, SCALE, return_lse=True)
    assert lse.shape == (2, B, H, s)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    t_grads = attention.flash_attention_bwd_reference(T(q), T(k), T(v), tb, SCALE, o, lse, T(do))
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * max(np.abs(j).max(), 1.0),
                                   err_msg=name)


def _one_tf32_pass(a, b):
    return attention.tf32_round(a) @ attention.tf32_round(b)


def _emulated(q, k, v, bias, do, mm=attention.mm_3xtf32):
    """``(o, dq, dk, dv)`` with every product of the kernel (Q K^T, P V,
    dO V^T, dS K, dS^T Q, P^T dO) through ``mm``, by default
    ``mm_3xtf32``: the kernel's arithmetic on the CPU, in the
    ``[B, S, H, Dh]`` layout."""
    qh, kh, vh, doh = (T(x).transpose(1, 2) for x in (q, k, v, do))  # [B, H, S, Dh]
    s = mm(qh, kh.transpose(-1, -2)) * SCALE
    if bias is not None:
        s = s + T(bias)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = mm(p, vh)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - (doh * o).sum(-1, keepdim=True))
    grads = (mm(ds, kh) * SCALE, mm(ds.transpose(-1, -2), qh) * SCALE,
             mm(p.transpose(-1, -2), doh))
    return [t.transpose(1, 2).numpy() for t in (o, *grads)]


def _oracles(q, k, v, bias, do):
    """The forward by the library kernel's ``mha_reference`` (behind the JAX
    wrapper's ``_prepare``) and the gradients by ``jax.vjp`` of the einsum
    path."""
    qt, kt, vt, ab, seg, sq = _prepare(q, k, v, None if bias is None else jnp.asarray(bias), SCALE)
    out = mha_reference(qt, kt, vt, ab, segment_ids=None if seg is None else SegmentIds(*seg),
                        sm_scale=SCALE)
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda q, k, v: _jax_einsum(q, k, v, jb), q, k, v)
    grads = vjp(jnp.asarray(do))
    return [np.asarray(out)[:, :, :sq].transpose(0, 2, 1, 3)] + [np.asarray(g) for g in grads]


def _card_tolerance(ref):
    """The tolerance the card holds K3 to: 2e-5 of the largest magnitude, at least 1."""
    return 2e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("s,kind", [(901, "none")] + CASES)
def test_the_kernels_3xtf32_products_match_the_jax_oracles(s, kind):
    """The kernel's arithmetic, every product in three TF32 passes (emulated
    by ``mm_3xtf32``: hi rounded as ``cvt.rna`` rounds, lo truncated as the
    tensor cores read it), against ``mha_reference``
    (forward) and ``jax.vjp`` of the einsum path (dq, dk, dv), within the
    card's 2e-5 of each tensor's largest magnitude (at least 1), at one
    ViT-length head pair [1, 901, 2, 64] and the lengths and biases of
    ``CASES``."""
    b = 1 if s == 901 else B
    q, k, v = _qkv(s, seed=30 + s, b=b)
    bias = _bias(kind, s, seed=30 + s)
    do = np.random.default_rng(40 + s).normal(size=(b, s, H, DH)).astype(np.float32)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), _emulated(q, k, v, bias, do),
                              _oracles(q, k, v, bias, do)):
        err = float(np.abs(got - ref).max())
        assert err <= _card_tolerance(ref), f"{name}: max abs err {err}"


def test_a_single_tf32_pass_misses_the_cards_tolerance():
    """Why the kernel splits every operand: with one TF32 pass (11
    significant bits) the output and every gradient at [1, 901, 2, 64] are
    outside the card's tolerance (by 8-17x), with three passes inside it."""
    q, k, v = _qkv(901, seed=50, b=1)
    do = np.random.default_rng(51).normal(size=q.shape).astype(np.float32)
    refs = _oracles(q, k, v, None, do)
    for mm, inside in ((_one_tf32_pass, False), (attention.mm_3xtf32, True)):
        for name, got, ref in zip(("o", "dq", "dk", "dv"), _emulated(q, k, v, None, do, mm),
                                  refs):
            err = float(np.abs(got - ref).max())
            assert (err <= _card_tolerance(ref)) == inside, (mm.__name__, name, err)


def test_tf32_round_ties_away_from_zero_and_tf32_truncate_cuts():
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                      3.0, -0.0, 2 - ulp / 4], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, -0.0, 2.0]
    assert attention.tf32_round(x).tolist() == want
    assert attention.tf32_truncate(x).tolist() == [1.0, -1.0, 1.0, 1 + ulp, 3.0, -0.0, 2 - ulp]


def test_multihead_attention_flash_branch_matches_the_jax_einsum_path():
    """The port's ``MultiHeadAttention`` under ``attention_impl("flash")`` at
    130 queries (the flash branch: q/k/v handed over as [B, S, H, Dh] views)
    against the JAX module's einsum path on the same weights, with a key
    mask.  Tolerance 1e-5 relative to the output's largest magnitude."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 130, H * DH)).astype(np.float32)
    bias = _bias("key_mask", 130, seed=3)
    j_mha = JMultiHeadAttention(num_heads=H, head_dim=DH, out_dim=H * DH)
    params = jax.jit(j_mha.init)(jax.random.key(0), x)
    ref = np.asarray(j_mha.apply(params, x, bias=jnp.asarray(bias)))
    t_mha = load_jax_params(MultiHeadAttention(H * DH, H), jax.device_get(params))
    calls = []
    real = attention.flash_attention

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    attention.flash_attention = spy
    try:
        with attention.attention_impl("flash"), torch.no_grad():
            out = t_mha(T(x), bias=T(bias)).numpy()
    finally:
        attention.flash_attention = real
    assert calls == [(B, 130, H, DH)]
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tiny_vit_flash_equals_xla_and_matches_jax():
    """A tiny ViT at 192 px (145 tokens, width 32): the port's features and
    their pixel gradient under ``attention_impl("flash")`` equal its
    ``"xla"`` path, and both match the JAX ViT on the ``"xla"`` path (its
    flash path needs a TPU).  Tolerance 1e-5 relative to each tensor's
    largest magnitude (float32 reassociation over 2 blocks)."""
    jvit = dataclasses.replace(jcfg.tiny_test_config().albef.vit, image_size=192)
    tvit = dataclasses.replace(tcfg.tiny_test_config().albef.vit, image_size=192)
    px = np.random.default_rng(4).uniform(-1, 1, (1, 192, 192, 3)).astype(np.float32)
    j_model = JVisionTransformer(jvit)
    # the port's random weights as flax variables: no flax init compiles
    model = init_weights(VisionTransformer(tvit), seed=1).eval().requires_grad_(False)
    params = jax_params_of(model)
    assert_same_tree(params, init_tree_shapes(j_model, px))
    _, j_feats = jit_apply(j_model, params, px)
    outs = {}
    for impl in ("xla", "flash"):
        p = T(nchw(px)).requires_grad_(True)
        with attention.attention_impl(impl):
            out, feats = model(p)
            (g,) = torch.autograd.grad(feats.square().mean() + out.square().mean(), p)
        outs[impl] = (feats.detach().numpy(), g.numpy())
    assert outs["flash"][0].shape == (1, 3, 145, 32)
    for a, b in zip(outs["flash"], outs["xla"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    j_feats = np.asarray(j_feats)
    np.testing.assert_allclose(outs["flash"][0], j_feats, rtol=0,
                               atol=1e-5 * np.abs(j_feats).max())


def test_backend_selection_and_kernel_wrapper_refusals():
    assert attention.get_impl() == "xla"
    with attention.attention_impl("flash"):
        assert attention.get_impl() == "flash"
    assert attention.get_impl() == "xla"
    with pytest.raises(ValueError, match="unknown attention backend"):
        attention.set_impl("pallas")
    q = torch.zeros(1, 4, 1, DH)
    # the kernel wrappers take CUDA tensors only; flash_attention routes a
    # CPU tensor to the plain version instead
    with pytest.raises(ValueError, match="expected cuda"):
        attention.flash_attention_fwd(q, q, q, None, SCALE)
    assert attention.flash_attention(q, q, q, None, SCALE).shape == (1, 4, 1, DH)
