"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device.  Imports nothing of JAX, so on a machine
with a card and no JAX it runs without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from vqattack_tpu_torch.attacks.pgd import _update
from vqattack_tpu_torch.ops import attention, fused_ln, pgd_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in float32
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


def _attention_case(gen, b, sq, sk, kind, h=4):
    """q, k, v as [B, S, H, 64] views of packed projections (strided, as the
    model hands them over), and a bias of the given broadcast form."""
    def packed(s):
        return torch.randn(b, s, 3, h, 64, generator=gen, device="cuda")
    q = packed(sq)[:, :, 0]
    kv = packed(sk)
    k, v = kv[:, :, 1], kv[:, :, 2]
    bias = None
    if kind == "table":  # the VLMo form: one [1, H, Sq, Sk] table
        bias = torch.randn(1, h, sq, sk, generator=gen, device="cuda") * 0.5
    elif kind == "key_mask":  # [B, 1, 1, Sk], a third of the keys masked
        keep = torch.rand(b, sk, generator=gen, device="cuda") > 0.33
        keep[:, 0] = True
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    elif kind == "left_pad":  # [B, 1, 1, Sk], the first 70 keys at -inf:
        # every row's first key tile is masked whole
        keep = torch.arange(sk, device="cuda") >= 70
        bias = torch.where(keep, 0.0, -torch.inf).expand(b, sk)[:, None, None, :]
    return q, k, v, bias


def _close(got, ref, what):
    """Within 2e-5 of the reference's largest magnitude (at least 1): float32
    sums over up to 901 keys or queries in another order than cuBLAS's, with
    the 3xTF32 split's error (about 2^-22 of each term) in the kernel's."""
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("b,sq,sk,kind", [
    (2, 1, 1, "none"), (2, 63, 63, "none"), (2, 130, 130, "none"), (1, 901, 901, "none"),
    (2, 200, 77, "none"), (2, 130, 130, "table"), (2, 130, 130, "key_mask"),
    (1, 901, 901, "key_mask"), (2, 130, 130, "left_pad"), (1, 901, 901, "left_pad"),
])
def test_flash_attention_kernels(gen, b, sq, sk, kind):
    """K3 forward (output and log-sum-exp) and backward against the plain
    versions, ragged lengths, both bias forms and a -inf key mask; the backward is the same
    bit for bit on every run."""
    q, k, v, bias = _attention_case(gen, b, sq, sk, kind)
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, bias, scale)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, bias, scale, return_lse=True)
    _close(o, o_r, "o")
    _close(lse, lse_r, "lse")
    do = torch.randn(o.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do)
    again = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do)
    refs = attention.flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do)
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        assert g.shape == r.shape
        assert torch.equal(g, g2), f"{name} differs between two runs"
        _close(g, r, name)


def test_flash_attention_autograd_and_refusals(gen):
    """The autograd Function against autograd through the plain version, one
    launch of each kernel per call; and the wrapper refuses what the kernel
    does not take."""
    q, k, v, bias = _attention_case(gen, 2, 150, 150, "key_mask")
    w = torch.randn(2, 150, 4, 64, generator=gen, device="cuda")
    grads = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fwd, bwd = attention.flash_attention_fwd.launches, attention.flash_attention_bwd.launches
        out = fn(*xs, bias, 0.125)
        grads.append(torch.autograd.grad((out * w).sum(), xs))
        if fn is attention.flash_attention:
            assert attention.flash_attention_fwd.launches == fwd + 1
            assert attention.flash_attention_bwd.launches == bwd + 1
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        _close(a, r, name)
    with pytest.raises(ValueError, match="64"):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32], None, 0.125)
    with pytest.raises(TypeError):
        attention.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), None, 0.125)
    with pytest.raises(ValueError, match="no gradient"):
        attention.flash_attention(q, k, v, bias.clone().requires_grad_(True), 0.125)


def test_flash_attention_refuses_rows_off_16_bytes(gen):
    """The kernel copies rows in 16-byte chunks: a view whose rows start
    elsewhere (here columns 1..64 of a 65-wide buffer) is refused, not read
    wrong."""
    buf = torch.randn(2, 130, 4, 65, generator=gen, device="cuda")
    q = buf[..., 1:65]
    with pytest.raises(ValueError, match="16 bytes"):
        attention.flash_attention_fwd(q, q, q, None, 0.125)
    wide = torch.randn(2, 130, 4, 66, generator=gen, device="cuda")  # aligned start, stride 66
    with pytest.raises(ValueError, match="16 bytes"):
        attention.flash_attention(wide[..., :64], wide[..., :64], wide[..., :64], None, 0.125)


def test_flash_attention_backward_bit_identical_at_the_victims_batch(gen):
    """At [16, 901, 12, 64], the victim's batch at ViT length, two backward
    runs give the same bits (no atomics), and the forward agrees with the
    plain version."""
    q, k, v, _ = _attention_case(gen, 16, 901, 901, "none", h=12)
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale)
    _close(o, attention.flash_attention_reference(q, k, v, None, scale), "o")
    do = torch.randn(o.shape, generator=gen, device="cuda")
    first = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do)
    second = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{name} differs between two runs"


def _two_terms(gen, b, s, kind, h=4, text=40):
    """A [1, H, S, S] table as ``bias`` and a [B, S] key bias: ``"text_pad"``
    masks (-1e9) the last 12 of the first ``text`` keys of row 1, the
    padded text of VLMo's joint sequence; ``"left_pad"`` masks the first 70
    keys of every row at -inf, the whole first key tile; ``"zero"`` masks
    nothing."""
    q, k, v, _ = _attention_case(gen, b, s, s, "none", h)
    table = torch.randn(1, h, s, s, generator=gen, device="cuda") * 0.5
    key_bias = torch.zeros(b, s, device="cuda")
    if kind == "text_pad":
        key_bias[min(1, b - 1), text - 12 : text] = -1e9
    elif kind == "left_pad":
        key_bias[:, :70] = -torch.inf
    return q, k, v, table, key_bias


@pytest.mark.parametrize("b,s,kind", [
    (2, 1, "zero"), (2, 63, "text_pad"), (2, 130, "text_pad"), (1, 941, "text_pad"),
    (3, 941, "text_pad"), (2, 130, "left_pad"), (1, 941, "left_pad"),
])
def test_flash_attention_kernels_with_a_key_bias(gen, b, s, kind):
    """K3 with both terms (the table and the key bias) against the plain
    versions at ragged lengths and VLMo's 941 tokens, with padded text keys
    inside the sequence and a -inf first key tile; the [1, Sk] broadcast
    key bias too; the backward the same bit for bit."""
    q, k, v, table, kb = _two_terms(gen, b, s, kind)
    scale = 64 ** -0.5
    for key_bias in (kb, kb[:1]):
        o, lse = attention.flash_attention_fwd(q, k, v, table, scale, key_bias)
        o_r, lse_r = attention.flash_attention_reference(q, k, v, table, scale,
                                                         return_lse=True, key_bias=key_bias)
        _close(o, o_r, "o")
        _close(lse, lse_r, "lse")
        do = torch.randn(o.shape, generator=gen, device="cuda")
        grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
        again = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
        refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do,
                                                       key_bias)
        for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
            assert torch.equal(g, g2), f"{name} differs between two runs"
            _close(g, r, name)


def test_flash_attention_key_bias_autograd_counts_and_refusals(gen):
    """The autograd Function with both terms against autograd through the
    plain version, counted as key-bias launches; the wrapper refuses a key
    bias of the wrong shape, type, layout or with a gradient."""
    q, k, v, table, kb = _two_terms(gen, 2, 150, "text_pad")
    w = torch.randn(2, 150, 4, 64, generator=gen, device="cuda")
    grads = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fwd, bwd = (attention.flash_attention_fwd.key_bias_launches,
                    attention.flash_attention_bwd.key_bias_launches)
        out = fn(*xs, table, 0.125, key_bias=kb[:, None, None, :])
        grads.append(torch.autograd.grad((out * w).sum(), xs))
        if fn is attention.flash_attention:
            assert attention.flash_attention_fwd.key_bias_launches == fwd + 1
            assert attention.flash_attention_bwd.key_bias_launches == bwd + 1
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        _close(a, r, name)
    with pytest.raises(ValueError, match="key_bias"):
        attention.flash_attention(q, k, v, table, 0.125, key_bias=kb[:, :149])
    with pytest.raises(ValueError, match="key_bias"):
        attention.flash_attention(q, k, v, table, 0.125, key_bias=kb[:, None, :])
    with pytest.raises(TypeError, match="key_bias"):
        attention.flash_attention(q, k, v, table, 0.125, key_bias=kb.double())
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(q, k, v, table, 0.125,
                                  key_bias=torch.zeros(150, 2, device="cuda").t())
    with pytest.raises(ValueError, match="no gradient"):
        attention.flash_attention(q, k, v, table, 0.125, key_bias=kb.clone().requires_grad_(True))


def test_flash_attention_two_term_backward_bit_identical_at_the_victims_batch(gen):
    """At [16, 941, 12, 64] with the table and the padded-text key bias,
    VLMo's victim batch: two backward runs give the same bits, and the
    forward agrees with the plain version."""
    q, k, v, table, kb = _two_terms(gen, 16, 941, "text_pad", h=12)
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, kb)
    _close(o, attention.flash_attention_reference(q, k, v, table, scale, key_bias=kb), "o")
    do = torch.randn(o.shape, generator=gen, device="cuda")
    first = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb)
    second = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{name} differs between two runs"
