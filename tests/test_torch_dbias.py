"""Kernel K3's bias gradient (dbias), its plain version against the JAX
package: ``flash_attention_bwd_reference(..., dbias=True)`` (the oracle the
card holds the kernel to, and the CPU's path) against ``jax.grad`` of the
JAX einsum path and against the library's own backward oracle
(``mha_reference_bwd``'s ``dab``) behind the JAX wrapper's ``_prepare``,
for a ``[1, H, S, S]`` table with a key bias, a ``[B, H, S, S]`` bias and
ragged lengths; the tiny VLMo's relative-position table gradient under
``attention_impl("flash")`` against the port's product + softmax path and
the JAX package's flash path; and the refusals of a gradient no kernel
gives.

Tolerance: 2e-5 of the largest |dbias| (at least 1e-6 absolute), the card
tests' bound for K3: float32 sums over up to 130 keys in other orders.
The model's table gradient: rtol 1e-4, atol 1e-5 of its largest value
(a sum over every layer, query and key of the joint sequence).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_flash
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference,
    mha_reference_bwd,
    mha_reference_no_custom_vjp,
)

from torch_port_util import nchw, tiny_vlmo, tiny_vlmo_configs
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.ops.attention import _prepare
from vqattack_tpu.ops.attention import attention_impl as jattention_impl
from vqattack_tpu_torch.ops import attention

T = torch.from_numpy
B, H, DH = 2, 2, 64
SCALE = DH ** -0.5

# (Sq, Sk, bias form): the table form of VLMo ([1, H, S, S] with the
# padded-text key bias), a dense [B, H, S, S] bias, and a cross shape
CASES = [(130, 130, "table"), (70, 70, "table"), (130, 130, "dense"), (70, 130, "dense")]


def _case(sq, sk, form, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, sq, H, DH)).astype(np.float32)
    k, v = (rng.normal(size=(B, sk, H, DH)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, sq, H, DH)).astype(np.float32)
    lead = 1 if form == "table" else B
    bias = (rng.normal(size=(lead, H, sq, sk)) * 0.5).astype(np.float32)
    key_bias = None
    if form == "table":
        mask = np.ones((B, sk), np.float32)
        mask[1, sk - 9:] = 0  # the second row's padded text
        key_bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    return q, k, v, do, bias, key_bias


def _plain_dbias(q, k, v, do, bias, key_bias):
    kb = None if key_bias is None else T(key_bias)
    o, lse = attention.flash_attention_reference(T(q), T(k), T(v), T(bias), SCALE,
                                                 return_lse=True, key_bias=kb)
    grads = attention.flash_attention_bwd_reference(T(q), T(k), T(v), T(bias), SCALE, o, lse,
                                                    T(do), key_bias=kb, dbias=True)
    assert len(grads) == 4 and grads[3].shape == bias.shape
    return grads[3].numpy()


def _summed(bias, key_bias):
    """The JAX form of the two terms: one bias, the key bias added."""
    if key_bias is None:
        return bias
    return bias + jnp.asarray(key_bias)[:, None, None, :]


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= max(1e-6, 2e-5 * float(np.abs(want).max())), f"max abs err {err}"


@pytest.mark.parametrize("sq,sk,form", CASES)
def test_plain_dbias_matches_jax_grad_of_the_einsum_path(sq, sk, form):
    """``jax.vjp`` of the JAX ``MultiHeadAttention`` einsum path with respect
    to the bias; the key bias rides in the sum, as the JAX VLMo adds it."""
    q, k, v, do, bias, key_bias = _case(sq, sk, form, seed=sq + sk)

    def einsum(b):
        s = jnp.einsum("bqhd,bkhd->bhqk", q * SCALE, k) + _summed(b, key_bias)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)

    _, vjp = jax.vjp(einsum, jnp.asarray(bias))
    _close(_plain_dbias(q, k, v, do, bias, key_bias), np.asarray(vjp(jnp.asarray(do))[0]))


@pytest.mark.parametrize("sq,sk,form", CASES)
def test_plain_dbias_matches_the_library_dab_through_prepare(sq, sk, form):
    """The library's backward oracle behind the JAX wrapper: ``_prepare``
    pads to 128 and divides the bias by the scale (``ab = bias / scale``),
    the library's dQ kernel returns ``dab = ds * scale``, and XLA sums it
    over the bias's broadcast dimensions, so the bias's gradient is ``dab /
    scale`` on the unpadded rows and keys, summed.  ``mha_reference_bwd``
    takes a scale of 1, so it runs on ``q * scale`` and ``ab * scale``,
    where its ``dab`` is ``ds`` itself."""
    q, k, v, do, bias, key_bias = _case(sq, sk, form, seed=sq + 2 * sk)
    qt, kt, vt, ab, seg, n = _prepare(q, k, v, _summed(jnp.asarray(bias), key_bias), SCALE)
    seg = None if seg is None else SegmentIds(*seg)
    qs, abs_ = qt * SCALE, ab * SCALE
    o, l, m = mha_reference_no_custom_vjp(qs, kt, vt, abs_, seg, save_residuals=True)
    dot = jnp.pad(jnp.asarray(do).transpose(0, 2, 1, 3),
                  ((0, 0), (0, 0), (0, qt.shape[2] - sq), (0, 0)))
    dab = mha_reference_bwd(qs, kt, vt, abs_, seg, o, l, m, dot)[3]
    want = np.asarray(dab)[:, :, :n, :sk]
    if bias.shape[0] == 1:  # XLA's transpose of the broadcast over B
        want = want.sum(axis=0, keepdims=True)
    _close(_plain_dbias(q, k, v, do, bias, key_bias), want)


def test_autograd_through_the_plain_path_gives_the_same_dbias():
    """On a CPU tensor ``flash_attention`` runs the plain forward under
    autograd: its bias gradient is the backward reference's dbias."""
    q, k, v, do, bias, key_bias = _case(130, 130, "table", seed=7)
    tb = T(bias).requires_grad_(True)
    out = attention.flash_attention(T(q), T(k), T(v), tb, SCALE, key_bias=T(key_bias))
    (got,) = torch.autograd.grad(out, tb, T(do))
    _close(got.numpy(), _plain_dbias(q, k, v, do, bias, key_bias))


def test_gradients_no_kernel_gives_are_refused():
    """A bias that needs a gradient with bf16 q/k/v (the bf16 instance has
    no dbias) and a key bias that needs one are refused before any launch;
    a float32 bias with a gradient is taken."""
    bias = torch.zeros(1, H, 4, 4, requires_grad=True)
    kb = torch.zeros(B, 4, requires_grad=True)
    with pytest.raises(ValueError, match="no dbias"):
        attention.check_gradients(torch.bfloat16, bias, None)
    with pytest.raises(ValueError, match="key bias has no gradient"):
        attention.check_gradients(torch.float32, None, kb)
    attention.check_gradients(torch.float32, bias, kb.detach())
    attention.check_gradients(torch.bfloat16, bias.detach(), None)
    with pytest.raises(ValueError, match="dbias without a bias"):
        z = torch.zeros(B, 4, H, DH)
        attention.flash_attention_bwd_reference(z, z, z, None, SCALE, z, torch.zeros(B, H, 4),
                                                z, dbias=True)


# ---------------------------------------------------------------------------
# the tiny VLMo's relative-position table under flash
# ---------------------------------------------------------------------------

IMAGE = 176  # (176 / 16)^2 + 1 = 122 image tokens + 8 text tokens = 130 >= 128
VOCAB = 64


def _flash_reference(q, k, v, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0,
                     block_sizes=None, debug=False):
    """The library's flash kernel as the JAX package's CPU tests run it:
    through ``mha_reference`` (whose backward returns ``dab`` and takes a
    scale of 1, so the scale goes into q and ab)."""
    return mha_reference(q * sm_scale, k, v, None if ab is None else ab * sm_scale,
                         segment_ids=segment_ids, causal=causal)


def test_tiny_vlmo_table_gradient_under_flash_matches_xla_and_jax(monkeypatch):
    """The VQA loss's gradient with respect to the tiny VLMo's
    relative-position table (130 joint tokens, so every joint attention
    takes the flash branch, the table's gather under gradient) under
    ``attention_impl("flash")``, against the port's product + softmax
    path and the JAX package's flash path (the library kernel replaced by
    its reference) on the same weights."""
    jc, tc = (dataclasses.replace(c, vlmo=dataclasses.replace(c.vlmo, image_size=IMAGE))
              for c in tiny_vlmo_configs(VOCAB, depth=2))
    j_model, params, model = tiny_vlmo(jc, tc, seed=0)
    rng = np.random.default_rng(3)
    px = rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    w = rng.normal(size=(2, jc.vlmo.vqa_label_size)).astype(np.float32)

    calls = []
    monkeypatch.setattr(pallas_flash, "flash_attention",
                        lambda *a, **kw: calls.append(1) or _flash_reference(*a, **kw))

    def jloss(p):
        return jnp.sum(j_model.apply(p, px, ids, mask, method=JVLMo.vqa_logits) * w)

    with jattention_impl("flash"):
        j_grad = jax.jit(jax.grad(jloss))(params)["params"]["relative_position_bias_table"]
    assert calls  # the JAX side took its flash path

    flash_calls, real = [], attention.flash_attention

    def spy(q, k, v, bias, scale, key_bias=None):
        flash_calls.append(bias.requires_grad)
        return real(q, k, v, bias, scale, key_bias)

    monkeypatch.setattr(attention, "flash_attention", spy)
    grads = {}
    for impl in ("flash", "xla"):
        model.zero_grad()
        with attention.attention_impl(impl):
            logits = model.vqa_logits(T(nchw(px)), T(ids).long(), T(mask).long())
        torch.sum(logits * T(w)).backward()
        grads[impl] = model.relative_position_bias_table.grad.numpy().copy()
    assert flash_calls == [True] * jc.vlmo.depth  # every layer's table needed a gradient
    scale = float(np.abs(j_grad).max())
    assert scale > 0
    for impl in ("flash", "xla"):
        np.testing.assert_allclose(grads[impl], np.asarray(j_grad), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(grads["flash"], grads["xla"], rtol=1e-4, atol=1e-5 * scale)
