"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device.  Imports nothing of JAX, so on a machine
with a card and no JAX it runs without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from vqattack_tpu_torch.attacks.pgd import _update
from vqattack_tpu_torch.ops import fused_ln, pgd_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def test_pgd_linf_update_kernel_bit_exact(gen):
    shape = (2, 3, 64, 48)
    ori = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    adv = (ori + (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 0.3).clamp(-1, 1)
    grad = torch.randn(shape, generator=gen, device="cuda")
    grad[torch.rand(shape, generator=gen, device="cuda") < 0.05] = 0
    before = pgd_update.pgd_linf_update.launches
    out = _update(adv, grad, ori, 0.125, 0.01, "linf", -1.0, 1.0)
    assert pgd_update.pgd_linf_update.launches == before + 1
    ref = pgd_update.pgd_linf_update_reference(adv, grad, ori, 0.125, 0.01, -1.0, 1.0)
    assert torch.equal(out, ref)
    with pytest.raises(TypeError):
        pgd_update.pgd_linf_update(adv.double(), grad.double(), ori.double(),
                                   0.125, 0.01, -1.0, 1.0)


@pytest.mark.parametrize("rows,dtype", [(901, torch.float32), (1000, torch.float32),
                                        (901, torch.bfloat16), (37, torch.bfloat16)])
def test_residual_layernorm_kernels(gen, rows, dtype):
    """s bit-exact; h and dx within 1e-5 (float32) or one bf16 ulp (rtol
    2^-7, atol 2^-9); dgamma/dbeta within 1e-5 of the terms' magnitudes and
    the same on every run."""
    d = 768
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    delta = (torch.randn(rows, d, generator=gen, device="cuda") * 0.3).to(dtype)
    gamma = torch.randn(d, generator=gen, device="cuda") * 0.1 + 1
    beta = torch.randn(d, generator=gen, device="cuda") * 0.1
    gs = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    gh = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7,
                                                                          atol=2 ** -9)
    s, h = fused_ln.residual_layernorm_fwd(x, delta, gamma, beta)
    s_r, h_r = fused_ln.residual_layernorm_reference(x, delta, gamma, beta)
    assert torch.equal(s, s_r)
    torch.testing.assert_close(h.float(), h_r.float(), **tol)
    dx, dg, db = fused_ln.residual_layernorm_bwd(s, gs, gh, gamma)
    dx2, dg2, db2 = fused_ln.residual_layernorm_bwd(s, gs, gh, gamma)
    dx_r, dg_r, db_r = fused_ln.residual_layernorm_bwd_reference(s, gs, gh, gamma)
    torch.testing.assert_close(dx.float(), dx_r.float(), **tol)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2)
    sf = s.float()
    xhat = (sf - sf.mean(-1, keepdim=True)) * torch.rsqrt(
        sf.var(-1, unbiased=False, keepdim=True) + 1e-6)
    assert ((dg - dg_r).abs() <= 1e-5 * (gh.float() * xhat).abs().sum(0) + 1e-6).all()
    assert ((db - db_r).abs() <= 1e-5 * gh.float().abs().sum(0) + 1e-6).all()
    dxn, dgn, dbn = fused_ln.residual_layernorm_bwd(s, None, gh, gamma, param_grads=False)
    dxn_r, _, _ = fused_ln.residual_layernorm_bwd_reference(s, None, gh, gamma,
                                                            param_grads=False)
    assert dgn is None and dbn is None
    torch.testing.assert_close(dxn.float(), dxn_r.float(), **tol)
