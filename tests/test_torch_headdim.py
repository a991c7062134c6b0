"""Kernel K3 at head dim 34 (VLMo-base+: 544 over 16 heads) against the JAX
package, on the CPU.

The card's kernels take head dim 34 as a template instance of their head-dim
64 code, reading each head in place as a box of one folded TMA map over the
``[B, S, H * 34]`` projection (40 float32 or 64 bf16 columns, from a column
on 16 bytes at or before the head's first), the columns around the head
zeroed where they would reach a product.  What the CPU can hold of that:

- K3's plain versions (float32 and bf16) and the kernel's 3xTF32 arithmetic
  (``mm_3xtf32``) at head dims 34, 40 and 64, with a key bias, against the
  library kernel's ``mha_reference`` behind the JAX wrapper's ``_prepare``
  and ``jax.vjp`` of the JAX einsum path (of ``mha_reference`` in bf16);
- the folded route's arithmetic: the plain version on each head's box, the
  neighbours' columns in it and the kernels' operands zeroed, read back at
  the head's columns, against the plain version on the packed heads;
- a tiny VLMo-base+ geometry (width 68 over 2 heads, so head dim 34;
  absolute position embeddings, no relative-position table, no layer scale;
  176 px, so the joint sequence is 130 tokens and takes the flash branch)
  loaded from the JAX parameters: the model, and one batched attack block,
  against the JAX package under ``attention_impl("flash")``, whose Pallas
  kernel runs as the JAX package's own tests run it on the CPU, through the
  library's ``mha_reference``.

Tolerances as in ``tests/test_torch_attention.py`` (float32: 2e-5 absolute
on outputs of order 1, 1e-5 of each gradient's largest magnitude; the
emulated kernel arithmetic within the card's 2e-5 of the largest magnitude,
at least 1), ``tests/test_torch_dtype.py`` (bf16: one bf16 ulp, 2^-7, of the
largest magnitude, at least 1) and ``tests/test_torch_vlmo.py`` (the model:
forward rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-6, scaled to
the largest magnitude).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_flash
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from torch_port_util import (JaxKey, assert_same_tree, fixed_topk, init_tree_shapes, nchw, nhwc,
                             tiny_mlm, tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu.attacks.batched import BatchedVlmoAttack as JBatched
from vqattack_tpu.attacks.vlmo_orchestrator import VlmoAttackPipeline as JPipeline
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.ops.attention import _prepare
from vqattack_tpu.ops.attention import attention_impl as jattention_impl
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch.attacks.batched import BatchedVlmoAttack
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.vlmo import VLMo
from vqattack_tpu_torch.ops import attention
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

T = torch.from_numpy
BF16 = torch.bfloat16
B, H = 2, 2


def _inputs(s: int, dh: int, seed: int):
    """q, k, v, dO ``[B, s, H, dh]`` and a ``[B, s]`` key bias: five keys of
    row 1 at -1e9 (padded text inside the sequence), none of row 0."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, s, H, dh)).astype(np.float32) for _ in range(4))
    key_bias = np.zeros((B, s), np.float32)
    if s > 8:
        key_bias[1, s // 3 : s // 3 + 5] = -1e9
    return q, k, v, do, key_bias


def _library_forward(q, k, v, key_bias, scale):
    """``mha_reference`` behind the JAX wrapper's ``_prepare``, which
    receives the key bias as its one bias, sliced back to ``Sq``."""
    dense = jnp.broadcast_to(jnp.asarray(key_bias)[:, None, None, :],
                             (q.shape[0], 1, q.shape[1], k.shape[1]))
    qt, kt, vt, ab, seg, sq = _prepare(q, k, v, dense, scale)
    seg = None if seg is None else SegmentIds(*seg)
    out = mha_reference(qt, kt, vt, ab, segment_ids=seg, sm_scale=scale)
    return np.asarray(out)[:, :, :sq].transpose(0, 2, 1, 3)


def _einsum_grads(q, k, v, key_bias, do, scale):
    """``jax.vjp`` of the JAX ``MultiHeadAttention`` einsum path."""
    bias = jnp.asarray(key_bias)[:, None, None, :]

    def f(q, k, v):
        attn = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k) + bias
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(attn, axis=-1), v)

    _, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("dh", [34, 40, 64])
def test_plain_float32_version_matches_the_jax_oracles(dh):
    """``flash_attention`` on CPU tensors (the plain version) against
    ``mha_reference``, and the log-sum-exp backward
    (``flash_attention_bwd_reference``, the kernels' algorithm) against
    ``jax.vjp`` of the einsum path, at 130 tokens with a key bias."""
    scale = dh ** -0.5
    q, k, v, do, kb = _inputs(130, dh, seed=dh)
    out = attention.flash_attention(T(q), T(k), T(v), None, scale, key_bias=T(kb))
    assert out.shape == (B, 130, H, dh)
    np.testing.assert_allclose(out.numpy(), _library_forward(q, k, v, kb, scale), rtol=0,
                               atol=2e-5)
    o, lse = attention.flash_attention_reference(T(q), T(k), T(v), None, scale,
                                                 return_lse=True, key_bias=T(kb))
    grads = attention.flash_attention_bwd_reference(T(q), T(k), T(v), None, scale, o, lse,
                                                    T(do), T(kb))
    for name, t, j in zip(("dq", "dk", "dv"), grads, _einsum_grads(q, k, v, kb, do, scale)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * max(np.abs(j).max(), 1.0),
                                   err_msg=name)


def _emulated(q, k, v, key_bias, do, scale):
    """``(o, dq, dk, dv)`` with every product of the kernel through
    ``mm_3xtf32`` (the float32 kernel's tensor-core arithmetic)."""
    mm = attention.mm_3xtf32
    qh, kh, vh, doh = (T(x).transpose(1, 2) for x in (q, k, v, do))  # [B, H, S, Dh]
    s = mm(qh, kh.transpose(-1, -2)) * scale + T(key_bias)[:, None, None, :]
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = mm(p, vh)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - (doh * o).sum(-1, keepdim=True))
    grads = (mm(ds, kh) * scale, mm(ds.transpose(-1, -2), qh) * scale,
             mm(p.transpose(-1, -2), doh))
    return [t.transpose(1, 2).numpy() for t in (o, *grads)]


@pytest.mark.parametrize("s,dh", [(130, 34), (941, 34), (130, 40)])
def test_the_kernels_3xtf32_products_at_head_dim_34(s, dh):
    """The float32 kernel's arithmetic (every product in three TF32 passes,
    the 40-column tile's zero columns included at 34) against
    ``mha_reference`` and ``jax.vjp`` within the card's tolerance, at 130
    tokens and at VLMo's 941."""
    scale = dh ** -0.5
    q, k, v, do, kb = _inputs(s, dh, seed=100 + s + dh)
    # the kernel's 40-wide tiles: zero columns past 34, which it never stores
    width = 40
    padded = [np.pad(x, ((0, 0), (0, 0), (0, 0), (0, width - dh))) for x in (q, k, v, do)]
    got = [x[..., :dh] for x in _emulated(*padded[:3], kb, padded[3], scale)]
    refs = [_library_forward(q, k, v, kb, scale)] + _einsum_grads(q, k, v, kb, do, scale)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, refs):
        err = float(np.abs(a - r).max())
        assert err <= 2e-5 * max(1.0, float(np.abs(r).max())), f"{name}: max abs err {err}"


@pytest.mark.parametrize("s", [37, 130])
def test_plain_bf16_version_at_head_dim_34_matches_the_library_oracle(s):
    """K3's plain bf16 forward and backward at head dim 34, with the key
    bias, against ``mha_reference`` and its ``jax.vjp`` on the same bf16
    values upcast to float32 (as ``tests/test_torch_dtype.py`` holds it at
    64).  The scale 34^-0.5 is not a power of two, so scaling dS after its
    rounding (the kernels' order) and before it differ by a rounding."""
    dh = 34
    scale = dh ** -0.5
    q, k, v, do, kb = _inputs(s, dh, seed=200 + s)
    tq, tk, tv, tdo = (T(x).to(BF16) for x in (q, k, v, do))
    q, k, v, do = (x.float().numpy() for x in (tq, tk, tv, tdo))
    dense = jnp.broadcast_to(jnp.asarray(kb)[:, None, None, :], (B, 1, s, s))
    qt, kt, vt, ab, seg, sq = _prepare(q, k, v, dense, scale)
    seg = None if seg is None else SegmentIds(*seg)
    ref = np.asarray(mha_reference(qt, kt, vt, ab, segment_ids=seg, sm_scale=scale))
    ref = ref[:, :, :sq].transpose(0, 2, 1, 3)
    # mha_reference's backward takes sm_scale 1: the scale in q, the bias unscaled
    _, vjp = jax.vjp(lambda q_, k_, v_: mha_reference(q_ * scale, k_, v_, ab * scale,
                                                      segment_ids=seg), qt, kt, vt)
    dot = jnp.pad(jnp.transpose(jnp.asarray(do), (0, 2, 1, 3)),
                  ((0, 0), (0, 0), (0, qt.shape[2] - s), (0, 0)))
    want = [ref] + [np.asarray(g)[:, :, :s].transpose(0, 2, 1, 3) for g in vjp(dot)]

    o, lse = attention.flash_attention_reference(tq, tk, tv, None, scale, return_lse=True,
                                                 key_bias=T(kb))
    grads = attention.flash_attention_bwd_reference(tq, tk, tv, None, scale, o, lse, tdo,
                                                    T(kb))
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert got.dtype == BF16 and got.shape == (B, s, H, dh), name
        err = float(np.abs(got.float().numpy() - w).max())
        assert err <= 2 ** -7 * max(1.0, float(np.abs(w).max())), f"{name}: {err}"


def _folded_box(x, h, dtype):
    """Head h's box of the folded map over ``x`` ``[B, S, H * 34]`` as TMA
    brings it, zeros past column ``H * 34``: float32, 40 columns from ``34 h
    - 2 (h % 2)``; bf16, 64 from ``34 h - (2 h mod 8)``.  Returns ``(box
    [B, S, 1, width], shift)``, the head at box columns ``shift .. shift +
    33``."""
    width, shift = (40, 2 * (h % 2)) if dtype == torch.float32 else (64, (2 * h) % 8)
    start = 34 * h - shift
    assert start * x.element_size() % 16 == 0  # a box starts on 16 bytes
    box = torch.nn.functional.pad(x, (0, width))[..., start:start + width]
    return box[:, :, None], shift


def _only_head(box, shift):
    out = box.clone()
    out[..., :shift] = 0
    out[..., shift + 34:] = 0
    return out


@pytest.mark.parametrize("dtype,h", [(torch.float32, 2), (BF16, 2), (BF16, 3), (BF16, 4)],
                         ids=["float32-2_heads", "bf16-2_heads", "bf16-3_heads", "bf16-4_heads"])
def test_the_folded_route_changes_nothing_outside_the_head(dtype, h):
    """The kernels' route at head dim 34 in plain PyTorch, head by head: the
    plain forward and backward on each head's box of the folded map over
    packed ``[B, S, H * 34]`` q, k, v, O and dO, the neighbours' columns in
    it, the operands the kernel zeroes zeroed (float32: q, k, v and dO
    outside the head, as the splitters and the register loads do; bf16:
    only the register A operands, q and dO), the outputs read back at the
    head's columns: the plain version on the unpadded inputs (float32 sums
    over 34 or 40 terms, the extra ones zero: within 1e-6 of the largest
    magnitude, at least 1; bf16 outputs within one bf16 ulp of it), for H
    a multiple of 4 and not, where bf16 rows are off 16 bytes."""
    s, dh = 130, 34
    scale = dh ** -0.5
    rng = np.random.default_rng(310 + h)
    q, k, v, do = (T(rng.normal(size=(B, s, h, dh)).astype(np.float32)).to(dtype)
                   for _ in range(4))
    kb = torch.zeros(B, s)
    kb[1, s // 3 : s // 3 + 5] = -1e9
    o, lse = attention.flash_attention_reference(q, k, v, None, scale, True, kb)
    grads = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do, kb)
    rows = [t.reshape(B, s, h * dh) for t in (q, k, v, o, do)]
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    for head in range(h):
        boxes = [_folded_box(x, head, dtype) for x in rows]
        shift = boxes[0][1]
        qb, kb_, vb, ob, dob = (box for box, _ in boxes)
        if dtype == torch.float32:
            qb, kb_, vb, dob = (_only_head(t, shift) for t in (qb, kb_, vb, dob))
        else:
            qb, dob = _only_head(qb, shift), _only_head(dob, shift)
        o_b, lse_b = attention.flash_attention_reference(qb, kb_, vb, None, scale, True, kb)
        grads_b = attention.flash_attention_bwd_reference(qb, kb_, vb, None, scale, ob,
                                                          lse_b, dob, kb)
        err = float((lse_b[:, :, 0] - lse[:, :, head]).abs().max())
        assert err <= 1e-6 * max(1.0, float(lse.abs().max())), f"head {head} lse: {err}"
        for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_b, *grads_b)):
            want, got = a[:, :, head].float(), b[:, :, 0, shift:shift + dh].float()
            err = float((got - want).abs().max())
            assert err <= tol * max(1.0, float(want.abs().max())), f"head {head} {name}: {err}"


# ---------------------------------------------------------------------------
# a tiny VLMo-base+ geometry through both packages
# ---------------------------------------------------------------------------

VOCAB = 64
IMAGE = 176  # (176 / 16)^2 + 1 = 122 image tokens + 8 text tokens = 130 >= 128


def _flash_reference(q, k, v, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0,
                     block_sizes=None, debug=False):
    """The library's flash kernel, ``softmax((q k^T + ab) * sm_scale) v``,
    as the JAX package's CPU tests run it: through its own
    ``mha_reference``, whose backward takes ``sm_scale`` 1, so the scale goes
    into q and ab."""
    return mha_reference(q * sm_scale, k, v, None if ab is None else ab * sm_scale,
                         segment_ids=segment_ids, causal=causal)


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX package under ``attention_impl("flash")``, the library
    kernel replaced by its reference; counts the JAX flash calls."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return _flash_reference(*a, **kw)

    monkeypatch.setattr(pallas_flash, "flash_attention", spy)
    with jattention_impl("flash"):
        yield calls


def _base_plus_configs(**attack_kw):
    """The tiny RunConfig of both packages with VLMo-base+'s form: 68 wide
    over 2 heads (head dim 34), absolute position embeddings, no
    relative-position table, no layer scale, 176 px."""
    out = []
    for c in tiny_vlmo_configs(VOCAB, depth=1, **attack_kw):
        vlmo = dataclasses.replace(c.vlmo, image_size=IMAGE, hidden_size=68, num_heads=2,
                                   use_abs_pos_emb=True, need_relative_position_embed=False,
                                   layer_scale_init=None)
        out.append(dataclasses.replace(c, vlmo=vlmo))
    return out


def _base_plus_models(jc, tc, seed: int):
    """(JAX module, JAX params, port module), the port's random weights from
    ``seed`` as flax variables (``tiny_vlmo``)."""
    return tiny_vlmo(jc, tc, seed)


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _tiny_base_plus_under_flash(dtype):
    """The tiny base+ VLMo of ``dtype`` (its trunk's compute dtype) in both
    packages under ``attention_impl("flash")``: ``((port features, JAX
    features), (port pixel gradient, JAX one), (port VQA logits, JAX ones))``
    on the same weights, with the port's flash calls checked (the key bias
    alone, no table, head dim 34, q/k/v in ``dtype``)."""
    jc, tc = _base_plus_configs()
    j_model, params, model = _base_plus_models(jc, tc, seed=0)
    ids0 = jnp.ones((1, jc.vlmo.max_text_len), jnp.int32)
    assert_same_tree(params, init_tree_shapes(j_model, ids0, ids0,
                                              jnp.zeros((1, IMAGE, IMAGE, 3)),
                                              method=JVLMo.init_all))
    if dtype == BF16:
        j_model = JVLMo(jc.vlmo, dtype=jnp.bfloat16)
        model = load_jax_params(VLMo(tc.vlmo, dtype="bfloat16"), params).eval()
    assert model.precompute_joint_biases() is None
    assert model.blocks[0].attn.head_dim == 34 and model.pos_embed is not None
    rng = np.random.default_rng(5)
    px = rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    w_tok = rng.normal(size=(2, 2, 130, 68)).astype(np.float32)
    w_cls = rng.normal(size=(2, 2, 68)).astype(np.float32)

    def jloss(p, x):
        out = j_model.apply(p, x, ids, mask, None, method=JVLMo.attack_feats)
        return (jnp.sum(out[1].astype(jnp.float32) * w_cls)
                + jnp.sum(out[2].astype(jnp.float32) * w_tok)
                + jnp.sum(out[0].astype(jnp.float32))), out

    # one compiled program (eager, every primitive compiles on its own)
    (_, j_out), j_g, j_logits = jax.jit(lambda p, x: (
        *jax.value_and_grad(jloss, argnums=1, has_aux=True)(p, x),
        j_model.apply(p, x, ids, mask, method=JVLMo.vqa_logits)))(params, jnp.asarray(px))
    calls, real = [], attention.flash_attention

    def spy(*a, **kw):
        calls.append((tuple(a[0].shape), a[0].dtype))
        assert a[3] is None and a[5] is not None  # the key bias alone, no table
        return real(*a, **kw)

    attention.flash_attention = spy
    try:
        with attention.attention_impl("flash"):
            x = T(nchw(px)).requires_grad_(True)
            out = model.attack_feats(x, T(ids).long(), T(mask).long(), None)
            loss = ((out[1].float() * T(w_cls)).sum() + (out[2].float() * T(w_tok)).sum()
                    + out[0].float().sum())
            (g,) = torch.autograd.grad(loss, x)
            with torch.no_grad():
                logits = model.vqa_logits(T(nchw(px)), T(ids).long(), T(mask).long())
    finally:
        attention.flash_attention = real
    assert calls == [((2, 130, 2, 34), dtype)] * 2
    return (out, j_out), (g, j_g), (logits, j_logits)


def test_tiny_base_plus_model_under_flash_matches_jax(jax_flash):
    """The tiny base+ VLMo: no table (``precompute_joint_biases`` is None),
    its attack features and their pixel gradient and its VQA logits under
    ``attention_impl("flash")``, where every joint attention (130 queries,
    head dim 34) takes K3 with the padded-text key bias alone, against the
    JAX module under its flash path on the same weights."""
    (out, j_out), (g, j_g), (logits, j_logits) = _tiny_base_plus_under_flash(torch.float32)
    assert jax_flash  # the JAX side took its flash path
    for a, b in zip(out, j_out):
        _close(a.detach().numpy(), b, 1e-4, 1e-5)
    _close(g.numpy(), nchw(j_g), 1e-3, 1e-6)
    _close(logits.numpy(), j_logits, 1e-4, 1e-5)


def test_tiny_base_plus_bf16_model_under_flash_matches_jax(jax_flash):
    """The bf16 case of :func:`test_tiny_base_plus_model_under_flash_matches_jax`:
    the tiny base+ VLMo with its trunk in bf16 in both packages
    (``VLMo(dtype="bfloat16")``, ``JVLMo(dtype=jnp.bfloat16)``), every joint
    attention the bf16 K3 at head dim 34, held as ``tests/test_torch_dtype.py``
    holds the bf16 VLMo: features and logits within four bf16 ulps (2^-5) of
    the largest magnitude, and the pixel gradient's signs, what a PGD step
    takes, agreeing on more than 85% of the pixels."""
    (out, j_out), (g, j_g), (logits, j_logits) = _tiny_base_plus_under_flash(BF16)
    assert jax_flash  # the JAX side took its flash path
    for name, a, b in zip(("cls_feats", "layer_cls", "token_feats", "vqa_logits"),
                          (*out[:3], logits), (*j_out[:3], j_logits)):
        assert (a.dtype, b.dtype) == (BF16, jnp.bfloat16), name
        want = np.asarray(b.astype(jnp.float32))
        err = float(np.abs(a.detach().float().numpy() - want).max())
        assert err <= 2 ** -5 * max(1.0, float(np.abs(want).max())), f"{name}: {err}"
    assert g.dtype == torch.float32
    assert float((np.sign(g.numpy()) == np.sign(nchw(np.asarray(j_g)))).mean()) > 0.85


WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park", "dog-cat"]


def test_one_batched_base_plus_block_under_flash_matches_jax(jax_flash):
    """One attack block (4 PGD iterations, one substitutable word) of the
    lockstep engine on the tiny base+ VLMo, both packages under
    ``attention_impl("flash")`` with the same draws: the same schedule and
    text, losses within 1e-3, the image within the PGD drift budget."""
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    jc, tc = _base_plus_configs(num_iters=4, dynamic_pgd=True, fused_block=True)
    jc = dataclasses.replace(jc, vlmo=dataclasses.replace(jc.vlmo, vocab_size=t_tok.vocab_size))
    tc = dataclasses.replace(tc, vlmo=dataclasses.replace(tc.vlmo, vocab_size=t_tok.vocab_size))
    j_model, j_params, t_model = _base_plus_models(jc, tc, seed=0)
    j_mlm, p_mlm, t_mlm = tiny_mlm(jc, tc, seed=2)
    id2answer = {i: f"ans{i}" for i in range(16)}
    jp = JPipeline(jc, j_model, j_params, j_params, j_tok, JNullGate(), mlm_model=j_mlm,
                   mlm_params=p_mlm, id2answer=id2answer)
    tp = VlmoAttackPipeline(tc, t_model, t_tok, NullGate(), mlm_model=t_mlm,
                            id2answer=id2answer, device="cpu")
    jp.candidate_mlm_topk = tp.candidate_mlm_topk = fixed_topk(t_tok, {"dog": ["cat"]})
    rng = np.random.default_rng(0)
    samples = [{"qid": qid, "question": "what color is the dog?", "paraphrase": None,
                "target_answer": "red", "all_correct_answers": ["red"],
                "pixels": rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)}
               for qid in ("1", "2")]
    key = jax.random.key(3)
    j = {r.qid: r for r in JBatched(jp).run(samples, batch_size=2, rng=key)}
    assert jax_flash, "the JAX side never took its flash path"
    calls, real = [], attention.flash_attention

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    attention.flash_attention = spy
    try:
        with attention.attention_impl("flash"):
            t = BatchedVlmoAttack(tp).run([dict(s, pixels=nchw(s["pixels"])) for s in samples],
                                          batch_size=2, rng=JaxKey(key))
    finally:
        attention.flash_attention = real
    assert calls and set(calls) == {(2, 130, 2, 34)}
    for r in t:
        jr = j[r.qid]
        assert (r.old_alg, r.num_blocks, r.adv_text) == (jr.old_alg, jr.num_blocks, jr.adv_text)
        np.testing.assert_allclose(r.feat_losses, jr.feat_losses, rtol=1e-3)
        d = np.abs(nhwc(r.adv_image) - jr.adv_image)
        assert d.max() <= 2 * 0.01 * 4 and d.mean() < 1e-3
