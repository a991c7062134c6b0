"""K3's plain versions on a row whose every key carries a finite -1e9.

The key bias of batch row 1 masks every key, beside a relative-position
table.  The softmax of such a row is uniform, as the JAX einsum path's is,
and its gradients are those of a uniform softmax.  The forward saves the row
maximum ``m`` (about -1e9) and ``log l`` apart, because ``m + log l`` rounds
back to ``m`` there (the float32 ulp at 1e9 is 64): ``P = exp(S - L)`` would
then be 1 for every key instead of ``1 / Sk``, and dq, dk, dv would be Sk
times too large.  The oracle is ``jax.vjp`` of the JAX ``MultiHeadAttention``
einsum path with the two terms summed into one bias, as the JAX VLMo adds
them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqattack_tpu_torch.ops import attention

T = torch.from_numpy
B, H, DH = 2, 2, 64
SCALE = DH ** -0.5


def _case(s: int, seed: int):
    """q, k, v, dO, a [1, H, S, S] table and a [B, S] key bias whose row 1
    is -1e9 at every key (row 0 masks nothing)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, s, H, DH)).astype(np.float32) for _ in range(4))
    table = (rng.normal(size=(1, H, s, s)) * 0.5).astype(np.float32)
    key_bias = np.zeros((B, s), np.float32)
    key_bias[1] = -1e9
    return q, k, v, do, table, key_bias


def _jax_grads(q, k, v, do, table, key_bias):
    """``(o, dq, dk, dv)`` of the JAX einsum path (``layers.py``)."""
    bias = jnp.asarray(table) + jnp.asarray(key_bias)[:, None, None, :]

    def attend(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q * SCALE, k) + bias
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)

    o, vjp = jax.vjp(attend, q, k, v)
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(do)))]


def _plain(q, k, v, do, table, key_bias):
    """``(o, stats, dq, dk, dv)`` of the port's plain forward and backward."""
    args = (T(q), T(k), T(v), T(table), SCALE)
    o, stats = attention.flash_attention_reference(*args, return_lse=True, key_bias=T(key_bias))
    grads = attention.flash_attention_bwd_reference(*args, o, stats, T(do), key_bias=T(key_bias))
    return o, stats, grads


def _close(got, want, what):
    """Within 1e-5 of the largest magnitude of ``want`` (at least 1e-5):
    float32 sums over at most 130 keys or queries in another order."""
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("s", [37, 130])
def test_masked_row_plain_backward_matches_jax_vjp(s):
    """The plain forward and backward against ``jax.vjp`` of the einsum
    path, on the whole batch (row 0 unmasked, row 1 masked whole), within
    1e-5 of each tensor's largest value; row 1's output is the mean of V."""
    q, k, v, do, table, key_bias = _case(s, seed=s)
    want = _jax_grads(q, k, v, do, table, key_bias)
    o, stats, grads = _plain(q, k, v, do, table, key_bias)
    assert stats.shape == (2, B, H, s)
    np.testing.assert_allclose(stats[0, 1].numpy(), -1e9, rtol=1e-6)
    np.testing.assert_allclose(stats[1, 1].numpy(), np.log(s), rtol=1e-6)
    _close(o.numpy(), want[0], "o")
    np.testing.assert_allclose(o[1].numpy(), np.broadcast_to(v[1].mean(0), (s, H, DH)),
                               rtol=0, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want[1:]):
        _close(g.numpy(), w, name)
        _close(g[1].numpy(), w[1], f"{name} of the masked row")


def test_a_single_saved_log_sum_exp_misses_the_masked_row():
    """What the split repairs: with ``L = m + log l`` saved as one float32
    (given here as m = L and log l = 0), L rounds to m on the masked row,
    and the backward's dv there is Sk times the JAX value."""
    s = 130
    q, k, v, do, table, key_bias = _case(s, seed=3)
    want = _jax_grads(q, k, v, do, table, key_bias)
    o, stats, _ = _plain(q, k, v, do, table, key_bias)
    fused = stats[0] + stats[1]
    assert torch.equal(fused[1], stats[0, 1])  # log l is lost
    single = torch.stack([fused, torch.zeros_like(fused)])
    dv = attention.flash_attention_bwd_reference(T(q), T(k), T(v), T(table), SCALE, o, single,
                                                 T(do), key_bias=T(key_bias))[2]
    np.testing.assert_allclose(dv[1].numpy(), s * want[3][1], rtol=1e-4, atol=1e-3)


def test_no_terms_statistics_sum_to_the_log_sum_exp():
    """Without a bias or key bias the statistics are m and log l too
    (``[2, B, H, Sq]``); their sum is the rows' log-sum-exp within 1e-6
    (the bf16 kernel's fused exponent takes ``L = m + log l``), and the
    backward from them matches ``jax.vjp``."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=(B, 70, H, DH)).astype(np.float32) for _ in range(4))
    o, lse = attention.flash_attention_reference(T(q), T(k), T(v), None, SCALE,
                                                 return_lse=True)
    assert lse.shape == (2, B, H, 70)
    scores = torch.einsum("bqhd,bkhd->bhqk", T(q) * SCALE, T(k))
    torch.testing.assert_close(lse[0] + lse[1], torch.logsumexp(scores, -1), rtol=0, atol=1e-6)

    def attend(q, k, v):
        sc = jnp.einsum("bqhd,bkhd->bhqk", q * SCALE, k)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(sc, axis=-1), v)

    _, vjp = jax.vjp(attend, q, k, v)
    grads = attention.flash_attention_bwd_reference(T(q), T(k), T(v), None, SCALE, o, lse, T(do))
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(do))):
        _close(g.numpy(), np.asarray(w), name)


def test_masked_row_bf16_plain_backward_tracks_float32():
    """The bf16 plain version (P and dS rounded as the kernel rounds them)
    on the masked row: its statistics are the float32 ones of the bf16
    inputs, and its gradients of row 1 are within two bf16 ulps (2^-6) of
    the largest value of the float32 plain version's on the same inputs,
    not Sk times them."""
    s = 130
    q, k, v, do, table, key_bias = _case(s, seed=11)
    qb, kb, vb, dob = (T(x).bfloat16() for x in (q, k, v, do))
    kbias, tbl = T(key_bias), T(table)
    o, stats = attention.flash_attention_reference(qb, kb, vb, tbl, SCALE, return_lse=True,
                                                   key_bias=kbias)
    assert stats.shape == (2, B, H, s) and stats.dtype == torch.float32
    grads = attention.flash_attention_bwd_reference(qb, kb, vb, tbl, SCALE, o, stats, dob,
                                                    key_bias=kbias)
    f32 = [t.float() for t in (qb, kb, vb, dob)]
    o32, st32 = attention.flash_attention_reference(*f32[:3], tbl, SCALE, return_lse=True,
                                                    key_bias=kbias)
    want = attention.flash_attention_bwd_reference(*f32[:3], tbl, SCALE, o32, st32, f32[3],
                                                   key_bias=kbias)
    torch.testing.assert_close(stats, st32, rtol=1e-6, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        err = float((g[1].float() - w[1]).abs().max())
        assert err <= 2 ** -6 * float(w.abs().max()), f"{name}: {err}"
