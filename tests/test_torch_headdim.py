"""Kernel K3 at head dim 34 (VLMo-base+: 544 over 16 heads) against the JAX
package, on the CPU.

The card's kernels take head dim 34 as a template instance of their head-dim
64 code: the float32 kernel reads 40 columns, the last 6 zero-filled, and the
bf16 one reads rows the wrapper copies into zero-padded 40-wide tensors.
What the CPU can hold of that:

- K3's plain versions (float32 and bf16) and the kernel's 3xTF32 arithmetic
  (``mm_3xtf32``) at head dims 34, 40 and 64, with a key bias, against the
  library kernel's ``mha_reference`` behind the JAX wrapper's ``_prepare``
  and ``jax.vjp`` of the JAX einsum path (of ``mha_reference`` in bf16);
- the padded route's arithmetic: the plain version on zero-padded inputs,
  sliced back, against the plain version unpadded, and exactly zero
  gradients in the padded columns;
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

from torch_port_util import JaxKey, fixed_topk, nchw, nhwc, tiny_mlm, tiny_vlmo_configs
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


def test_kernel_width_and_pad_heads():
    """The bf16 kernel reads head dim 34 as 40-wide rows, everything else
    as it is; ``pad_heads`` appends zero columns to a contiguous copy and
    leaves a tensor of the width alone."""
    assert attention.kernel_width(BF16, 34) == 40
    assert attention.kernel_width(BF16, 64) == 64
    assert attention.kernel_width(torch.float32, 34) == 34
    assert attention.kernel_width(torch.float32, 64) == 64
    assert attention.HEAD_DIMS == (34, 64)
    x = torch.randn(2, 5, 16 * 34).view(2, 5, 16, 34)[:, :, 3:7]  # a strided view
    p = attention.pad_heads(x, 40)
    assert p.shape == (2, 5, 4, 40) and p.is_contiguous()
    assert torch.equal(p[..., :34], x) and not p[..., 34:].any()
    assert attention.pad_heads(x, 34) is x


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_the_padded_route_changes_nothing_but_adds_zero_columns(dtype):
    """The bf16 kernel's route at head dim 34 in plain PyTorch: q, k, v
    padded with zeros to 40 columns, the plain forward and backward, the
    outputs sliced back to 34, equal the plain version on the unpadded
    inputs (float32 sums over 34 or 40 terms, the extra ones zero: within
    1e-6 of the largest magnitude, at least 1, and the bf16 outputs within
    one bf16 ulp of it); the padded columns of O and of every gradient are
    exactly zero, through the explicit backward and through autograd."""
    s, dh, width = 130, 34, 40
    scale = dh ** -0.5
    q, k, v, do, kb = (T(x) for x in _inputs(s, dh, seed=300))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    kb_t = kb
    qp, kp, vp, dop = (attention.pad_heads(x, width) for x in (q, k, v, do))
    o, lse = attention.flash_attention_reference(q, k, v, None, scale, True, kb_t)
    o_p, lse_p = attention.flash_attention_reference(qp, kp, vp, None, scale, True, kb_t)
    grads = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do, kb_t)
    grads_p = attention.flash_attention_bwd_reference(qp, kp, vp, None, scale, o_p, lse_p, dop,
                                                      kb_t)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads),
                          (o_p, lse_p, *grads_p)):
        b = b if name == "lse" else b[..., :dh]
        err = float((a.float() - b.float()).abs().max())
        assert err <= (1e-6 if name == "lse" else tol) * max(1.0, float(a.float().abs().max())), \
            f"{name}: {err}"
    for name, t in zip(("o", "dq", "dk", "dv"), (o_p, *grads_p)):
        assert not t[..., dh:].any(), f"{name}: nonzero padded columns"
    leaves = [x.detach().clone().requires_grad_(True) for x in (qp, kp, vp)]
    out = attention.flash_attention(*leaves, None, scale, key_bias=kb_t)
    for leaf, g in zip(leaves, torch.autograd.grad((out.float() * dop.float()).sum(), leaves)):
        assert not g[..., dh:].any()


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


def _base_plus_configs(depth: int = 2, **attack_kw):
    """The tiny RunConfig of both packages with VLMo-base+'s form: 68 wide
    over 2 heads (head dim 34), absolute position embeddings, no
    relative-position table, no layer scale, 176 px."""
    out = []
    for c in tiny_vlmo_configs(VOCAB, depth=depth, **attack_kw):
        vlmo = dataclasses.replace(c.vlmo, image_size=IMAGE, hidden_size=68, num_heads=2,
                                   use_abs_pos_emb=True, need_relative_position_embed=False,
                                   layer_scale_init=None)
        out.append(dataclasses.replace(c, vlmo=vlmo))
    return out


def _base_plus_models(jc, tc, seed: int):
    cfg = jc.vlmo
    px = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    ids = jnp.ones((1, cfg.max_text_len), jnp.int32)
    j_model = JVLMo(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: j_model.init(k, ids, jnp.ones_like(ids), px, method=JVLMo.init_all))(
            jax.random.key(seed)))
    return j_model, params, load_jax_params(VLMo(tc.vlmo), params).eval()


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def test_tiny_base_plus_model_under_flash_matches_jax(jax_flash):
    """The tiny base+ VLMo: no table (``precompute_joint_biases`` is None),
    its attack features and their pixel gradient and its VQA logits under
    ``attention_impl("flash")``, where every joint attention (130 queries,
    head dim 34) takes K3 with the padded-text key bias alone, against the
    JAX module under its flash path on the same weights."""
    jc, tc = _base_plus_configs()
    j_model, params, model = _base_plus_models(jc, tc, seed=0)
    assert model.precompute_joint_biases() is None
    assert model.blocks[0].attn.head_dim == 34 and model.pos_embed is not None
    rng = np.random.default_rng(5)
    px = rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    w_tok = rng.normal(size=(2, 3, 130, 68)).astype(np.float32)
    w_cls = rng.normal(size=(2, 3, 68)).astype(np.float32)

    def jloss(p, x):
        out = j_model.apply(p, x, ids, mask, None, method=JVLMo.attack_feats)
        return jnp.sum(out[1] * w_cls) + jnp.sum(out[2] * w_tok) + jnp.sum(out[0]), out

    # one compiled program (eager, every primitive compiles on its own)
    (_, j_out), j_g, j_logits = jax.jit(lambda p, x: (
        *jax.value_and_grad(jloss, argnums=1, has_aux=True)(p, x),
        j_model.apply(p, x, ids, mask, method=JVLMo.vqa_logits)))(params, jnp.asarray(px))
    assert jax_flash  # the JAX side took its flash path
    calls, real = [], attention.flash_attention

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        assert a[3] is None and a[5] is not None  # the key bias alone, no table
        return real(*a, **kw)

    attention.flash_attention = spy
    try:
        with attention.attention_impl("flash"):
            x = T(nchw(px)).requires_grad_(True)
            out = model.attack_feats(x, T(ids).long(), T(mask).long(), None)
            loss = (out[1] * T(w_cls)).sum() + (out[2] * T(w_tok)).sum() + out[0].sum()
            (g,) = torch.autograd.grad(loss, x)
            with torch.no_grad():
                logits = model.vqa_logits(T(nchw(px)), T(ids).long(), T(mask).long())
    finally:
        attention.flash_attention = real
    assert calls == [(2, 130, 2, 34)] * 4
    for a, b in zip(out, j_out):
        _close(a.detach().numpy(), b, 1e-4, 1e-5)
    _close(g.numpy(), nchw(j_g), 1e-3, 1e-6)
    _close(logits.numpy(), j_logits, 1e-4, 1e-5)


WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park", "dog-cat"]


def test_one_batched_base_plus_block_under_flash_matches_jax(jax_flash):
    """One attack block (4 PGD iterations, one substitutable word) of the
    lockstep engine on the tiny base+ VLMo, both packages under
    ``attention_impl("flash")`` with the same draws: the same schedule and
    text, losses within 1e-3, the image within the PGD drift budget."""
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    jc, tc = _base_plus_configs(depth=2, num_iters=4, dynamic_pgd=True, fused_block=True)
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
