"""The port's kernels K1 (PGD L-inf update) and K2 (fused residual +
LayerNorm): their plain versions, which the CPU runs, against the JAX
package's Pallas kernels run in the Pallas interpreter, and the wrappers'
routing.  The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import nchw
from vqattack_tpu.ops import fused_ln as jfused
from vqattack_tpu.ops.pgd_update import pgd_linf_update as jax_pgd_linf_update
from vqattack_tpu_torch.attacks.pgd import _update
from vqattack_tpu_torch.ops import fused_ln, pgd_update

EPS, EPS_ITER, CMIN, CMAX = 0.125, 0.01, -1.0, 1.0


def _pgd_case(seed=0, shape=(2, 16, 16, 3)):
    rng = np.random.default_rng(seed)
    ori = rng.uniform(-1, 1, shape).astype(np.float32)
    adv = np.clip(ori + rng.uniform(-0.2, 0.2, shape), -1, 1).astype(np.float32)
    grad = rng.normal(size=shape).astype(np.float32)
    grad[rng.uniform(size=shape) < 0.05] = 0.0  # sign(0) = 0
    adv.flat[:4] = [1.0, -1.0, 0.0, 0.5]  # clip-box edges
    return adv, grad, ori


def test_pgd_update_plain_matches_pallas_bit_exact():
    """Tolerance: none.  Both compute the same IEEE float32 chain."""
    adv, grad, ori = _pgd_case()
    want = np.asarray(jax_pgd_linf_update(jnp.asarray(adv), jnp.asarray(grad),
                                          jnp.asarray(ori), EPS, EPS_ITER, CMIN, CMAX))
    got = pgd_update.pgd_linf_update_reference(
        *(torch.from_numpy(nchw(a)) for a in (adv, grad, ori)), EPS, EPS_ITER, CMIN, CMAX)
    np.testing.assert_array_equal(got.numpy(), nchw(want))


def test_pgd_update_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    adv, grad, ori = (torch.from_numpy(nchw(a)) for a in _pgd_case(1))
    before = pgd_update.pgd_linf_update.launches
    out = _update(adv, grad, ori, EPS, EPS_ITER, "linf", CMIN, CMAX)
    ref = pgd_update.pgd_linf_update_reference(adv, grad, ori, EPS, EPS_ITER, CMIN, CMAX)
    assert torch.equal(out, ref)
    assert pgd_update.pgd_linf_update.launches == before  # no kernel launched
    meta = [t.to("meta") for t in (adv, grad, ori)]
    with pytest.raises(ValueError, match="unsupported device"):
        pgd_update.pgd_linf_update(*meta, EPS, EPS_ITER, CMIN, CMAX)


def _ln_case(rows, d=256, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    delta = (rng.normal(size=(rows, d)) * 0.3).astype(np.float32)
    gamma = (rng.normal(size=(d,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    gs = rng.normal(size=(rows, d)).astype(np.float32)
    gh = rng.normal(size=(rows, d)).astype(np.float32)
    return x, delta, gamma, beta, gs, gh


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfused, "INTERPRET", True)


# 300 rows: the TPU kernel's last 256-row tile is ragged
@pytest.mark.parametrize("rows", [64, 300])
def test_residual_layernorm_plain_matches_jax_forward(rows, interpret):
    """Tolerance 2e-6 absolute: float32 row statistics reduced in another
    order by each framework."""
    x, delta, gamma, beta, _, _ = _ln_case(rows)
    jx = [jnp.asarray(a) for a in (x, delta, gamma, beta)]
    s_k, h_k = jfused._fused_residual_layernorm(*jx, 1e-6)
    s_r, h_r = jfused.residual_layernorm_reference(*jx, 1e-6)
    s, h = fused_ln.residual_layernorm_reference(
        *(torch.from_numpy(a) for a in (x, delta, gamma, beta)), 1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_k))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_k), rtol=0, atol=2e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=0, atol=2e-6)


def test_residual_layernorm_plain_matches_jax_forward_bf16():
    """bf16 stream: the residual sum is bit-exact (one rounded add); h is
    within one bf16 ulp (rtol 2^-7, atol 2^-9, the bar of
    tests/test_fused_ln.py), since both round a float32 result that may
    differ in its last bits."""
    x, delta, gamma, beta, _, _ = _ln_case(300, seed=2)
    jx = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(delta, jnp.bfloat16),
          jnp.asarray(gamma), jnp.asarray(beta)]
    s_r, h_r = jfused.residual_layernorm_reference(*jx, 1e-6)
    tx = [torch.from_numpy(x).bfloat16(), torch.from_numpy(delta).bfloat16(),
          torch.from_numpy(gamma), torch.from_numpy(beta)]
    s, h = fused_ln.residual_layernorm_reference(*tx, 1e-6)
    assert s.dtype == h.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(s_r, np.float32))
    np.testing.assert_allclose(h.float().numpy(), np.asarray(h_r, np.float32),
                               rtol=2 ** -7, atol=2 ** -9)


@pytest.mark.parametrize("rows", [64, 300])
def test_residual_layernorm_grads_match_jax_vjp(rows, interpret):
    """torch.autograd through the plain version, and the explicit plain
    backward the kernel computes, against jax.vjp of the interpret-mode
    kernel pair.  Tolerance: dx 1e-5 absolute; dgamma/dbeta (sums over
    ``rows`` rows) 1e-5 relative to the sum of the terms' magnitudes."""
    x, delta, gamma, beta, gs, gh = _ln_case(rows, seed=1)
    jx = [jnp.asarray(a) for a in (x, delta, gamma, beta)]
    _, vjp = jax.vjp(lambda a, b, g, bb: jfused._fused_residual_layernorm(a, b, g, bb, 1e-6),
                     *jx)
    jdx, jdd, jdg, jdb = (np.asarray(v) for v in vjp((jnp.asarray(gs), jnp.asarray(gh))))

    tx = [torch.from_numpy(a).requires_grad_(True) for a in (x, delta, gamma, beta)]
    s, h = fused_ln.residual_layernorm_reference(*tx, 1e-6)
    grads = torch.autograd.grad((s, h), tx, (torch.from_numpy(gs), torch.from_numpy(gh)))
    dx, dd, dg, db = (g.numpy() for g in grads)
    np.testing.assert_allclose(dx, jdx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dd, jdd, rtol=0, atol=1e-5)
    xhat = (x + delta - (x + delta).mean(-1, keepdims=True)) / (x + delta).std(-1, keepdims=True)
    mag_g = np.abs(gh * xhat).sum(0)
    mag_b = np.abs(gh).sum(0)
    assert (np.abs(dg - jdg) <= 1e-5 * mag_g).all()
    assert (np.abs(db - jdb) <= 1e-5 * mag_b).all()

    # the explicit backward (the CUDA kernel's oracle) agrees with autograd
    pdx, pdg, pdb = fused_ln.residual_layernorm_bwd_reference(
        s.detach(), torch.from_numpy(gs), torch.from_numpy(gh), tx[2].detach(), 1e-6)
    np.testing.assert_allclose(pdx.numpy(), dx, rtol=0, atol=1e-5)
    assert (np.abs(pdg.numpy() - dg) <= 1e-5 * mag_g).all()
    assert (np.abs(pdb.numpy() - db) <= 1e-5 * mag_b).all()
    dxn, dgn, dbn = fused_ln.residual_layernorm_bwd_reference(
        s.detach(), None, torch.from_numpy(gh), tx[2].detach(), 1e-6, param_grads=False)
    assert dgn is None and dbn is None
    np.testing.assert_allclose(dxn.numpy() + gs, dx, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 37, 901, 7208, 14416])
def test_residual_layernorm_bwd_partition(rows, monkeypatch):
    """The backward kernel's grid: every row falls to exactly one warp, in
    ascending runs (warp w of the grid takes [w * rows_a_warp, (w + 1) *
    rows_a_warp)); at most 8 warps a block and one block an SM, which bounds
    the dgamma/dbeta scratch; and the result depends on rows and D alone:
    the device is never asked."""
    def no_device(*a, **k):
        raise AssertionError("the partition asked the device")

    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    parts = {d: fused_ln.bwd_partition(rows, d) for d in (100, 544, 768, 1024)}
    assert len(set(parts.values())) == 1
    assert fused_ln.bwd_partition(rows, 768) == parts[768]
    rows_per_warp, warps_per_block, blocks = parts[768]
    # the kernel's 256 threads; at most one block an SM, so at most 132 rows
    # in the dgamma/dbeta scratch [2, blocks, D]
    assert 1 <= warps_per_block <= 8 and 1 <= blocks <= fused_ln.H100_SMS
    runs = [range(w * rows_per_warp, min((w + 1) * rows_per_warp, rows))
            for w in range(blocks * warps_per_block)]
    assert [r for run in runs for r in run] == list(range(rows))
    # one wave: no more warps than the H100's SMs hold at BWD_WARPS_PER_SM,
    # and no block without a row
    assert blocks * warps_per_block <= fused_ln.H100_SMS * fused_ln.BWD_WARPS_PER_SM
    assert (blocks - 1) * warps_per_block * rows_per_warp < rows
    if rows <= fused_ln.H100_SMS * fused_ln.BWD_WARPS_PER_SM:
        assert rows_per_warp == 1  # one warp a row, spread over the SMs
    with pytest.raises(ValueError):
        fused_ln.bwd_partition(rows, fused_ln.MAX_D + 1)


@pytest.mark.parametrize("d,dtype,offset,vectorised", [
    (768, torch.float32, 0, True), (768, torch.bfloat16, 0, True),
    (100, torch.float32, 0, True), (100, torch.bfloat16, 0, False),
    (544, torch.bfloat16, 0, True), (768, torch.float32, 2, False),
    (768, torch.bfloat16, 2, False), (768, torch.bfloat16, 8, True)])
def test_residual_layernorm_bwd_picks_its_instance(d, dtype, offset, vectorised):
    """The 16-byte instance where a row is a whole number of 16-byte vectors
    and every tensor starts on a 16-byte boundary, else the scalar one; a
    missing gs does not count."""
    def view():
        return torch.zeros(3 * d + offset + 64, dtype=dtype)[offset:offset + 3 * d].view(3, d)

    s, gs, gh = view(), view(), view()
    # the CPU allocator aligns storage to 64 bytes
    assert s.is_contiguous() and s.data_ptr() % 16 == offset * s.element_size() % 16
    assert fused_ln.bwd_vectorised(d, s, gs, gh) == vectorised
    assert fused_ln.bwd_vectorised(d, s, None, gh) == vectorised


def test_residual_layernorm_routes_by_device():
    """CPU tensors take the plain version (no launch); delta=None is a plain
    LayerNorm everywhere; other devices are refused."""
    x, delta, gamma, beta, _, _ = _ln_case(8, d=32)
    tx = [torch.from_numpy(a) for a in (x, delta, gamma, beta)]
    before = (fused_ln.residual_layernorm_fwd.launches, fused_ln.residual_layernorm_bwd.launches)
    s, h = fused_ln.residual_layernorm(*tx, 1e-6)
    s_r, h_r = fused_ln.residual_layernorm_reference(*tx, 1e-6)
    assert torch.equal(s, s_r) and torch.equal(h, h_r)
    s0, h0 = fused_ln.residual_layernorm(tx[0], None, tx[2], tx[3], 1e-6)
    ln = torch.nn.functional.layer_norm(tx[0], (32,), tx[2], tx[3], 1e-6)
    assert torch.equal(s0, tx[0])
    torch.testing.assert_close(h0, ln, rtol=0, atol=2e-6)
    assert (fused_ln.residual_layernorm_fwd.launches,
            fused_ln.residual_layernorm_bwd.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ln.residual_layernorm(*(t.to("meta") for t in tx), 1e-6)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_ln.residual_layernorm_fwd(*tx, 1e-6)
