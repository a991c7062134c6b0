"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device.  Imports nothing of JAX, so on a machine
with a card and no JAX it runs without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from vqattack_tpu_torch.attacks import extra
from vqattack_tpu_torch.attacks import pgd as tpgd
from vqattack_tpu_torch.attacks.pgd import _update
from vqattack_tpu_torch.models.layers import MultiHeadAttention
from vqattack_tpu_torch.ops import attention, fused_ln, pgd_update
from vqattack_tpu_torch.rng import TorchKey

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
                                        (901, torch.bfloat16), (37, torch.bfloat16),
                                        (8 * 257, torch.float32)])
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


# (rows, D, storage offset in elements): the main path's width at one row,
# 7 (fewer rows than SMs), one image's 901 and the batch-16 step's 14416;
# the widest row, 544 and 100 (the scalar instance on a bf16 stream); and
# contiguous views 2 elements past a 16-byte boundary (the scalar instance)
K2_BWD_CASES = [(1, 768, 0), (7, 768, 0), (901, 768, 0), (14416, 768, 0), (7, 1024, 0),
                (901, 1024, 0), (901, 544, 0), (7, 100, 0), (901, 100, 0), (901, 768, 2),
                (7, 1024, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", K2_BWD_CASES)
def test_residual_layernorm_bwd_kernel_cases(gen, rows, d, offset, dtype):
    """K2's backward at every width, row count and alignment its wrapper
    takes, with and without gs and parameter gradients: dx within 1e-5
    (float32) or one bf16 ulp (rtol 2^-7, atol 2^-9) of the plain version;
    dgamma/dbeta within 1e-5 of the terms' magnitudes; all three the same
    bit for bit over three calls; one launch a call; the 16-byte instance
    exactly where D is a whole number of 16-byte vectors and the storage
    is aligned."""
    def view(t):
        out = torch.empty(rows * d + offset, dtype=dtype, device="cuda")[offset:].view(rows, d)
        return out.copy_(t)

    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    delta = (torch.randn(rows, d, generator=gen, device="cuda") * 0.3).to(dtype)
    gamma = torch.randn(d, generator=gen, device="cuda") * 0.1 + 1
    beta = torch.randn(d, generator=gen, device="cuda") * 0.1
    s = view(fused_ln.residual_layernorm_reference(x, delta, gamma, beta)[0])
    gs, gh = (view(torch.randn(rows, d, generator=gen, device="cuda").to(dtype))
              for _ in range(2))
    assert s.is_contiguous() and s.data_ptr() % 16 == (2 * s.element_size() if offset else 0)
    vectorised = offset == 0 and d * s.element_size() % 16 == 0
    assert fused_ln.bwd_vectorised(d, s, gs, gh) == vectorised
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7,
                                                                          atol=2 ** -9)
    sf = s.float()
    xhat = (sf - sf.mean(-1, keepdim=True)) * torch.rsqrt(
        sf.var(-1, unbiased=False, keepdim=True) + 1e-6)
    for g_s in (gs, None):
        for param_grads in (True, False):
            counts = fused_ln.residual_layernorm_bwd.launches + \
                fused_ln.residual_layernorm_bwd.bf16_launches
            runs = [fused_ln.residual_layernorm_bwd(s, g_s, gh, gamma, param_grads=param_grads)
                    for _ in range(3)]
            assert (fused_ln.residual_layernorm_bwd.launches
                    + fused_ln.residual_layernorm_bwd.bf16_launches) == counts + 3
            dx_r, dg_r, db_r = fused_ln.residual_layernorm_bwd_reference(
                s, g_s, gh, gamma, param_grads=param_grads)
            dx, dg, db = runs[0]
            torch.testing.assert_close(dx.float(), dx_r.float(), **tol)
            assert all(torch.equal(r[0], dx) for r in runs)
            if not param_grads:
                assert dg is None and db is None
                continue
            assert all(torch.equal(r[1], dg) and torch.equal(r[2], db) for r in runs)
            assert ((dg - dg_r).abs() <= 1e-5 * (gh.float() * xhat).abs().sum(0) + 1e-6).all()
            assert ((db - db_r).abs() <= 1e-5 * gh.float().abs().sum(0) + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("param_grads", [True, False])
def test_residual_layernorm_autograd_function(gen, dtype, param_grads):
    """K2's autograd Function against autograd through the plain version on
    a float32 or bf16 stream, gamma and beta float32, with and without their
    gradients (the attack's frozen LayerNorms take none): float32 within 1e-4
    of each tensor's largest magnitude (at least 1); on a bf16 stream dx and
    ddelta within two bf16 ulps (2^-6) of it, since autograd through the
    plain version rounds the LayerNorm's gradient to bf16 before it adds the
    gradient of s, the kernel adds in float32 and rounds once."""
    rows, d = 901, 768
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    delta = (torch.randn(rows, d, generator=gen, device="cuda") * 0.3).to(dtype)
    gamma = torch.randn(d, generator=gen, device="cuda") * 0.1 + 1
    beta = torch.randn(d, generator=gen, device="cuda") * 0.1
    w_s, w_h = (torch.randn(rows, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    grads = []
    for fn in (fused_ln.residual_layernorm, fused_ln.residual_layernorm_reference):
        xs = [t.clone().requires_grad_(True) for t in (x, delta)]
        ps = [t.clone().requires_grad_(param_grads) for t in (gamma, beta)]
        counts = fused_ln.residual_layernorm_fwd.bf16_launches
        s, h = fn(*xs, *ps, 1e-6)
        assert s.dtype == h.dtype == dtype
        if fn is fused_ln.residual_layernorm:
            assert fused_ln.residual_layernorm_fwd.bf16_launches == counts + (dtype == torch.bfloat16)
        loss = (s.float() * w_s.float()).sum() + (h.float() * w_h.float()).sum()
        grads.append(torch.autograd.grad(loss, xs + (ps if param_grads else [])))
    for name, a, b in zip(("dx", "ddelta", "dgamma", "dbeta"), *grads):
        assert a.dtype == b.dtype, name
        rel = 2 ** -6 if dtype == torch.bfloat16 and name in ("dx", "ddelta") else 1e-4
        err = float((a.float() - b.float()).abs().max())
        assert err <= rel * max(1.0, float(b.float().abs().max())), f"{name}: {err}"


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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.flash_attention(q.half(), k.half(), v.half(), None, 0.125)
    with pytest.raises(TypeError, match="q torch.float32"):
        attention.flash_attention(q, k.bfloat16(), v.bfloat16(), None, 0.125)
    with pytest.raises(ValueError, match="no dbias"):
        attention.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  bias.clone().requires_grad_(True), 0.125)


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


# ---------------------------------------------------------------------------
# the float32 Hopper kernels at head dim 64 (csrc/flash_attention_tf32.cu)
# ---------------------------------------------------------------------------


def _one_key_residue(q, k, v, do, scale):
    """With one key P = 1, so dS = dO V^T - D, and dq and dk are 0 in exact
    arithmetic: what the kernel and the plain version compute is the
    rounding residue of dS, which dK sums over every query.  A 3xTF32 term
    a b errs by up to 2^-21 |a b| twice (each lo read truncated to TF32) and
    2^-22 |a b| once (lo lo dropped), so dO V^T errs by up to 2^-19 of
    sum_d |dO_d V_d| with the float32 sums; this bound, carried through dq
    = scale dS K and dk = scale sum_q dS_q Q_q, is what dq and dk are held
    to (elementwise, plus the usual 2e-5)."""
    e = 2.0 ** -19 * torch.einsum("bqhd,bkhd->bhqk", do.abs(), v.abs())  # [B, H, Sq, 1]
    return {"dq": scale * torch.einsum("bhqk,bkhd->bqhd", e, k.abs()),
            "dk": scale * torch.einsum("bhqk,bqhd->bkhd", e, q.abs())}


def _check_f32_case(gen, q, k, v, bias, key_bias, scale=64 ** -0.5):
    """Forward (output, m and log l) and backward against the plain
    versions (:func:`_close`), the backward twice, bit for bit, and each
    call counted as a launch of the Hopper kernels."""
    fwd, bwd = (f.tf32_wgmma_launches for f in (attention.flash_attention_fwd,
                                                 attention.flash_attention_bwd))
    o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, key_bias)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, bias, scale, return_lse=True,
                                                     key_bias=key_bias)
    _close(o, o_r, "o")
    _close(lse, lse_r, "lse")
    do = torch.randn(o.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias)
    again = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do, key_bias)
    residue = _one_key_residue(q, k, v, do, scale) if k.shape[1] == 1 else {}
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        assert g.shape == r.shape
        assert torch.equal(g, g2), f"{name} differs between two runs"
        if name in residue:
            err = (g - r).abs() - residue[name]
            assert float(err.max()) <= 2e-5, f"{name}: over its residue bound by {err.max()}"
        else:
            _close(g, r, name)
    assert attention.flash_attention_fwd.tf32_wgmma_launches == fwd + 1
    assert attention.flash_attention_bwd.tf32_wgmma_launches == bwd + 2


# The Hopper float32 kernels' tile edges: a block holds 128 rows in two
# warpgroups of 64; the forward walks 64-key tiles, dQ 32-key and dK/dV
# 32-query tiles, the last one ragged.
_F32_EDGES = (1, 5, 63, 64, 65, 127, 128, 129, 901, 941)


@pytest.mark.parametrize("sq,sk", [(s, s) for s in _F32_EDGES] + [
    (1, 941), (941, 1), (5, 128), (128, 5), (64, 129), (129, 64), (65, 901), (901, 127),
    (31, 33), (33, 31)])
def test_flash_attention_f32_tile_edges(gen, sq, sk):
    """K3-float32 at head dim 64, forward and backward, at every tile edge
    of its walks, Sq = Sk and Sq != Sk."""
    q, k, v, _ = _attention_case(gen, 2, sq, sk, "none", h=2)
    _check_f32_case(gen, q, k, v, None, None)


@pytest.mark.parametrize("s,lo,hi", [
    (130, 0, 64), (130, 64, 128), (130, 128, 130), (901, 0, 64), (901, 0, 128),
    (901, 896, 901), (941, 896, 941)])
def test_flash_attention_f32_inf_key_bias_over_a_tile(gen, s, lo, hi):
    """A -inf key bias over keys [lo, hi) of every row, with the table: over
    a whole 64-key tile (the forward's; two of dQ's 32-key ones), the first
    one included, so that a row's first tile is all -inf, or over the ragged
    last one."""
    q, k, v, table, _ = _two_terms(gen, 2, s, "zero", h=2)
    key_bias = torch.zeros(2, s, device="cuda")
    key_bias[:, lo:hi] = -torch.inf
    _check_f32_case(gen, q, k, v, table, key_bias)


def test_flash_attention_f32_backward_bit_identical_at_the_batched_chunk(gen):
    """At [8, 901, 12, 64] without terms (ALBEF's batched chunk), two
    backward runs give the same bits, and everything is held as in
    :func:`test_flash_attention_f32_tile_edges`."""
    q, k, v, _ = _attention_case(gen, 8, 901, 901, "none", h=12)
    _check_f32_case(gen, q, k, v, None, None)


def test_flash_attention_f32_routes_by_head_dim(gen):
    """Both head dims run the Hopper kernels (head dim 34 counted as an hd34
    launch too), as ``k3_route`` says; contiguous q/k/v at 34 are read in
    place, with no copy."""
    assert attention.k3_route(torch.float32, 64) == "tf32_wgmma"
    assert attention.k3_route(torch.float32, 34) == "tf32_wgmma"
    for dh, hd34 in ((64, 0), (34, 1)):
        q, k, v = (torch.randn(2, 130, 2, dh, generator=gen, device="cuda") for _ in range(3))
        before = {n: getattr(attention.flash_attention_fwd, n)
                  for n in ("launches", "hd34_launches", "tf32_wgmma_launches",
                            "hd34_copy_launches")}
        o, _ = attention.flash_attention_fwd(q, k, v, None, dh ** -0.5)
        _close(o, attention.flash_attention_reference(q, k, v, None, dh ** -0.5), "o")
        after = {n: getattr(attention.flash_attention_fwd, n) for n in before}
        assert {n: after[n] - before[n] for n in before} == {
            "launches": 1, "hd34_launches": hd34, "tf32_wgmma_launches": 1,
            "hd34_copy_launches": 0}


# ---------------------------------------------------------------------------
# the bias gradient (dbias): the float32 dQ kernel's dbias instance
# ---------------------------------------------------------------------------


def _dbias_close(got, ref, what):
    """Within 2e-5 of the largest |dbias| (at least 1e-6): dS is formed from
    the same float32 terms as dQ's, summed over the batch in the same order
    as the plain version's (``planned_batch_sum``)."""
    tol = max(1e-6, 2e-5 * float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("b,s,form", [
    (1, 941, "table"), (8, 941, "table"), (2, 130, "dense"), (2, 70, "table"),
    (2, 130, "left_pad"),
])
def test_flash_attention_dbias_kernel(gen, b, s, form):
    """The dbias instance against the plain backward's dbias: VLMo's table
    ``[1, H, S, S]`` with the padded-text key bias at batch 1 and 8, a
    ``[B, H, S, S]`` bias, ragged lengths and a -inf first key tile; dbias
    the same bit for bit on every run, dq/dk/dv as the plain version's."""
    kind = "left_pad" if form == "left_pad" else "text_pad"
    q, k, v, table, kb = _two_terms(gen, b, s, kind, text=min(40, s))
    if form == "dense":
        table = torch.randn(b, 4, s, s, generator=gen, device="cuda") * 0.5
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, kb)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    before = attention.flash_attention_bwd.dbias_launches
    grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)
    again = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)
    assert attention.flash_attention_bwd.dbias_launches == before + 2
    refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, kb,
                                                   dbias=True)
    assert grads[3].shape == table.shape
    for name, g, g2, r in zip(("dq", "dk", "dv", "dbias"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        (_dbias_close if name == "dbias" else _close)(g, r, name)


def test_flash_attention_dbias_autograd_counts_and_the_attack_backward(gen):
    """The autograd Function with a table that needs a gradient against
    autograd through the plain version (q, k, v and the table's gradients),
    counted as one dbias launch; with a table that needs none, the attack's
    case, no dbias launch, and the gradients the same bits as the plain
    backward kernels give."""
    q, k, v, table, kb = _two_terms(gen, 2, 150, "text_pad")
    w = torch.randn(2, 150, 4, 64, generator=gen, device="cuda")
    grads = []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v, table)]
        before = attention.flash_attention_bwd.dbias_launches
        out = fn(*xs[:3], xs[3], 0.125, key_bias=kb)
        grads.append(torch.autograd.grad((out * w).sum(), xs))
        if fn is attention.flash_attention:
            assert attention.flash_attention_bwd.dbias_launches == before + 1
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        _close(a, r, name)
    _dbias_close(grads[0][3], grads[1][3], "dtable")

    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = attention.flash_attention_bwd.dbias_launches
    out = attention.flash_attention(*xs, table, 0.125, key_bias=kb)
    got = torch.autograd.grad(out, xs, w)
    assert attention.flash_attention_bwd.dbias_launches == before
    o, lse = attention.flash_attention_fwd(q, k, v, table, 0.125, kb)
    want = attention.flash_attention_bwd(q, k, v, table, 0.125, o, lse, w, kb)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, r), name


# the sum over the batch inside the kernel, beyond the training batch of 8:
# (B, Sq, Sk, heads, head dim, form); "table" is a [1, H, Sq, Sk] table with
# the padded-text key bias, "table_alone" without it, "left_pad" the table
# with a -inf first key tile, "dense" a [B, H, Sq, Sk] bias (no sum over B).
# B 3 is one cluster of 3 blocks, 9 two of 8 (the second padded past B),
# 16 two whole ones, 24 three
DBIAS_BATCH_CASES = [
    (3, 941, 941, 12, 64, "table"), (9, 941, 941, 12, 64, "table"),
    (16, 941, 941, 12, 64, "table"), (24, 237, 237, 12, 64, "table"),
    (3, 130, 130, 4, 64, "dense"), (9, 130, 130, 4, 64, "left_pad"),
    (9, 200, 77, 4, 64, "table_alone"), (24, 70, 70, 4, 64, "dense"),
    (3, 197, 197, 16, 34, "table_alone"), (9, 237, 237, 16, 34, "table"),
    (16, 196, 196, 16, 34, "table"), (24, 130, 130, 16, 34, "left_pad"),
    (9, 130, 130, 16, 34, "dense"), (16, 200, 77, 16, 34, "table_alone"),
]


@pytest.mark.parametrize("b,sq,sk,h,dh,form", DBIAS_BATCH_CASES)
def test_flash_attention_dbias_cluster_sum(gen, b, sq, sk, h, dh, form):
    """The dbias instance's sum over B (clusters of min(B, 8) blocks, the
    clusters' partial planes added in order past 8) against the plain
    backward's dbias, summed in the same order, at both head dims, ragged
    and cross lengths, a -inf first key tile and a [B, H, S, S] bias; dbias
    and dq/dk/dv the same bit for bit on a repeat."""
    q = torch.randn(b, sq, h * dh, generator=gen, device="cuda").view(b, sq, h, dh)
    k, v = (torch.randn(b, sk, h * dh, generator=gen, device="cuda").view(b, sk, h, dh)
            for _ in range(2))
    kb = None
    if form in ("table", "left_pad"):
        kb = torch.zeros(b, sk, device="cuda")
        if form == "table":
            kb[1, 28:40] = -1e9
        else:
            kb[:, :70] = -torch.inf
    lead = b if form == "dense" else 1
    bias = torch.randn(lead, h, sq, sk, generator=gen, device="cuda") * 0.5
    plan = attention.dbias_plan((b, h, sq, sk), tuple(bias.shape))
    assert plan.cluster == (1 if form == "dense" else min(b, 8))
    scale = dh ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, kb)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    before = attention.flash_attention_bwd.dbias_launches
    grads = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, kb, dbias=True)
    again = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, kb, dbias=True)
    assert attention.flash_attention_bwd.dbias_launches == before + 2
    refs = attention.flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do, kb,
                                                   dbias=True)
    assert grads[3].shape == bias.shape
    for name, g, g2, r in zip(("dq", "dk", "dv", "dbias"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        (_dbias_close if name == "dbias" else _close)(g, r, name)


def test_flash_attention_dbias_allocates_no_batch_of_planes(gen):
    """One backward with dbias at VLMo's training shape, [8, 941, 12, 64]
    with the [1, 12, 941, 941] table: its peak allocation is dq, dk, dv, D
    and the one [1, 12, 941, 941] gradient plane, far under the [8, 12, 941,
    941] buffer the sum over B would take outside the kernel."""
    b, s, h = 8, 941, 12
    q, k, v, table, kb = _two_terms(gen, b, s, "text_pad", h=h)
    o, lse = attention.flash_attention_fwd(q, k, v, table, 0.125, kb)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = attention.flash_attention_bwd(q, k, v, table, 0.125, o, lse, do, kb, dbias=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    plane = h * s * s * 4
    assert grads[3].shape == table.shape
    assert peak <= 3 * q.numel() * 4 + b * h * s * 4 + plane + 16 * 2 ** 20, peak
    assert peak < b * plane


@pytest.mark.parametrize("dh", [64, 34])
def test_dbias_cluster_occupancy(gen, dh):
    """Every cluster size the plan takes (1 to 8 blocks) fits the card with
    and without the key bias (cudaOccupancyMaxActiveClusters > 0); 9 blocks,
    past the portable maximum, are refused."""
    for key_bias in (False, True):
        for cluster in range(1, attention.DBIAS_CLUSTER + 1):
            assert attention.dbias_max_clusters(dh, key_bias, cluster) > 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        attention.dbias_max_clusters(dh, False, attention.DBIAS_CLUSTER + 1)


# the pretraining path's shapes: (B, S, heads, head dim, key bias, table).
# ALBEF's ViT at 256 px (257 tokens: two 128-row tiles and one row);
# VLMo-base+ (head dim 34): the image tower at 224 px, ITM's joint trunk on
# 3 x 8 pairs and MLM's on 8 (40 text tokens and 197 image ones), the text
# tower at 196 tokens; VLMo-base's joint and text tables (head dim 64)
PRETRAIN_SHAPES = [(8, 257, 12, 64, False), (8, 197, 16, 34, False), (24, 237, 16, 34, True),
                   (8, 237, 16, 34, True), (8, 196, 16, 34, True)]
PRETRAIN_DBIAS_SHAPES = [(2, 257, 12, 64, False), (8, 197, 16, 34, False),
                         (24, 237, 16, 34, True), (8, 196, 16, 34, True),
                         (8, 237, 12, 64, True), (8, 196, 12, 64, True)]


def _pretrain_case(gen, b, s, h, dh, key_bias):
    """q, k, v at [B, S, H, Dh] as views of [B, S, H * Dh] projections, and
    the padded text's key bias (-1e9 on keys 28..39 of row 1) or none."""
    q, k, v = (torch.randn(b, s, h * dh, generator=gen, device="cuda").view(b, s, h, dh)
               for _ in range(3))
    kb = None
    if key_bias:
        kb = torch.zeros(b, s, device="cuda")
        kb[1, 28:40] = -1e9
    return q, k, v, kb


@pytest.mark.parametrize("b,s,h,dh,key_bias", PRETRAIN_SHAPES)
def test_flash_attention_at_the_pretraining_shapes(gen, b, s, h, dh, key_bias):
    """K3 forward and backward against the plain versions at each shape
    the pretraining path gives it, the backward the same bit for bit."""
    q, k, v, kb = _pretrain_case(gen, b, s, h, dh, key_bias)
    scale = dh ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale, kb)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, None, scale, return_lse=True,
                                                     key_bias=kb)
    _close(o, o_r, "o")
    _close(lse, lse_r, "lse")
    do = torch.randn(q.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, kb)
    again = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, kb)
    refs = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do, kb)
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        _close(g, r, name)


@pytest.mark.parametrize("b,s,h,dh,key_bias", PRETRAIN_DBIAS_SHAPES)
def test_flash_attention_dbias_at_the_pretraining_shapes(gen, b, s, h, dh, key_bias):
    """The dbias instance with a [1, H, S, S] table at the pretraining
    shapes: head dim 34 (the dQ kernel's 40-column tiles writing dS; the
    table alone at 197 tokens), VLMo-base's joint and text tables and 257
    tokens; against the plain backward, the same bit for bit."""
    q, k, v, kb = _pretrain_case(gen, b, s, h, dh, key_bias)
    table = torch.randn(1, h, s, s, generator=gen, device="cuda") * 0.5
    scale = dh ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, kb)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)
    again = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)
    refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, kb,
                                                   dbias=True)
    assert grads[3].shape == table.shape
    for name, g, g2, r in zip(("dq", "dk", "dv", "dbias"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        (_dbias_close if name == "dbias" else _close)(g, r, name)


# ---------------------------------------------------------------------------
# the bfloat16 instance (csrc/flash_attention_bf16.cu)
# ---------------------------------------------------------------------------


def _bf16_close(got, plain, truth, what):
    """The bf16 kernel and its plain version both against ``truth``, the
    float32 computation from the same bf16 inputs: the kernel's error is at
    most twice the plain version's, plus one bf16 ulp of the largest value
    (2^-7 of it).  The plain version rounds where the library kernel rounds
    (P before P V, dS before dS K), so its error is the bf16 arithmetic's own;
    the kernel rounds at the same places but P against a running maximum,
    tile by tile, and sums in another order, an error of the same size; an
    output rounded to bf16 the other way differs by one ulp.  The ulp is
    taken of at least 1, as the float32 check takes its scale: with one key
    dq and dk are exactly 0, and what is computed is the rounding residue of
    P * (dO V^T - D), whose terms are of order 1."""
    got, plain, truth = got.float(), plain.float(), truth.float()
    err, err_plain = float((got - truth).abs().max()), float((plain - truth).abs().max())
    tol = 2 * err_plain + 2 ** -7 * max(1.0, float(truth.abs().max()))
    assert err <= tol, f"{what}: max abs err {err} > {tol} (plain version's {err_plain})"


def _bf16_truth(q, k, v, bias, scale, do, key_bias=None):
    """``(o, dq, dk, dv)`` in float32 from the bf16 inputs: the float32 plain
    versions, nothing rounded to bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    o, lse = attention.flash_attention_reference(qf, kf, vf, bias, scale, return_lse=True,
                                                 key_bias=key_bias)
    return (o, *attention.flash_attention_bwd_reference(qf, kf, vf, bias, scale, o, lse,
                                                        do.float(), key_bias))


def _check_bf16_case(q, k, v, bias, key_bias, do, scale=64 ** -0.5):
    o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, key_bias)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32 and o.shape == q.shape
    o_p, lse_p = attention.flash_attention_reference(q, k, v, bias, scale, return_lse=True,
                                                     key_bias=key_bias)
    truth = _bf16_truth(q, k, v, bias, scale, do, key_bias)
    _bf16_close(o, o_p, truth[0], "o")
    _close(lse, lse_p, "lse")  # float32 from exact bf16 products
    grads = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias)
    again = attention.flash_attention_bwd(q, k, v, bias, scale, o, lse, do, key_bias)
    plain = attention.flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do, key_bias)
    for name, g, g2, p, t in zip(("dq", "dk", "dv"), grads, again, plain, truth[1:]):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert torch.equal(g, g2), f"{name} differs between two runs"
        _bf16_close(g, p, t, name)


@pytest.mark.parametrize("b,s,kind", [
    (2, 1, "none"), (2, 37, "none"), (2, 130, "none"), (1, 901, "none"), (8, 901, "none"),
    (2, 130, "text_pad"), (1, 941, "text_pad"), (3, 941, "text_pad"), (2, 130, "left_pad"),
])
def test_flash_attention_bf16_kernels(gen, b, s, kind):
    """K3's bf16 instance, forward and backward, against its plain version
    and the float32 computation (:func:`_bf16_close`) at ragged lengths,
    ALBEF's 901 tokens without terms (batch 1 and the batched chunk of 8)
    and VLMo's 941 with the table and the padded-text key bias, and a -inf
    first key tile; the backward the same bit for bit."""
    if kind == "none":
        q, k, v, _ = _attention_case(gen, b, s, s, "none")
        table = key_bias = None
    else:
        q, k, v, table, key_bias = _two_terms(gen, b, s, kind)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, table, key_bias, do)


def test_flash_attention_bf16_backward_bit_identical_at_the_victims_batch(gen):
    """At [16, 941, 12, 64] with both terms (VLMo's victim batch in bf16),
    two backward runs give the same bits, and everything is held as in
    :func:`test_flash_attention_bf16_kernels`."""
    q, k, v, table, kb = _two_terms(gen, 16, 941, "text_pad", h=12)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, table, kb, do)


def test_flash_attention_bf16_autograd_counts_and_key_bias_guard(gen):
    """The autograd Function on bf16 q/k/v with both terms against autograd
    through the plain version, counted as bf16 key-bias launches and not as
    float32 ones; the terms must stay float32: a bf16 key bias or table is
    refused, not cast."""
    q, k, v, table, kb = _two_terms(gen, 2, 150, "text_pad")
    q, k, v = (t.bfloat16() for t in (q, k, v))
    w = torch.randn(2, 150, 4, 64, generator=gen, device="cuda")
    outs, grads = [], []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        before = {n: getattr(attention.flash_attention_fwd, n) for n in (
            "launches", "key_bias_launches", "bf16_launches", "bf16_key_bias_launches")}
        bwd = attention.flash_attention_bwd.bf16_key_bias_launches
        out = fn(*xs, table, 0.125, key_bias=kb)
        assert out.dtype == torch.bfloat16
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out.float() * w).sum(), xs))
        if fn is attention.flash_attention:
            after = {n: getattr(attention.flash_attention_fwd, n) for n in before}
            assert {n: after[n] - before[n] for n in before} == {
                "launches": 0, "key_bias_launches": 0, "bf16_launches": 1,
                "bf16_key_bias_launches": 1}
            assert attention.flash_attention_bwd.bf16_key_bias_launches == bwd + 1
    # autograd through the plain forward rounds its P where the kernels do,
    # but differentiates the bf16 output's division by l itself: one bf16
    # ulp of each tensor's largest value apart at most twice over
    pairs = [("o", *outs)] + list(zip(("dq", "dk", "dv"), *grads))
    for name, a, r in pairs:
        err = float((a.float() - r.float()).abs().max())
        assert err <= 2 ** -6 * float(r.float().abs().max()), f"{name}: {err}"
    with pytest.raises(TypeError, match="key_bias"):
        attention.flash_attention(q, k, v, table, 0.125, key_bias=kb.bfloat16())
    with pytest.raises(TypeError, match="bias"):
        attention.flash_attention(q, k, v, table.bfloat16(), 0.125, key_bias=kb)


# The wgmma kernels' tile edges: the forward walks 128-key tiles (the ragged
# one, 16, 64 or 128 wide, first), dQ 64-key and dK/dV 64-query tiles (the
# last 16 or 64 wide); a block holds 128 rows in two warpgroups of 64.
_EDGES = (1, 5, 63, 64, 65, 127, 128, 129, 901, 941)


@pytest.mark.parametrize("sq,sk", [(s, s) for s in _EDGES] + [
    (1, 941), (941, 1), (5, 128), (128, 5), (64, 129), (129, 64), (65, 901), (901, 127)])
def test_flash_attention_bf16_tile_edges(gen, sq, sk):
    """K3-bf16 forward and backward at every tile edge of its walks, Sq = Sk
    and Sq != Sk, held as in :func:`test_flash_attention_bf16_kernels`."""
    q, k, v, _ = _attention_case(gen, 2, sq, sk, "none", h=2)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, None, None, do)


@pytest.mark.parametrize("s,form", [
    (130, "bias"), (941, "bias"), (130, "key_bias"), (941, "key_bias"), (901, "both")])
def test_flash_attention_bf16_broadcast_terms(gen, s, form):
    """A bias broadcast over batch, heads and query rows ([1, 1, 1, Sk]) and
    a key bias broadcast over the batch ([1, Sk], a fifth of the keys at
    -1e9), alone and together."""
    q, k, v, _ = _attention_case(gen, 3, s, s, "none", h=2)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    bias = key_bias = None
    if form in ("bias", "both"):
        bias = torch.randn(1, 1, 1, s, generator=gen, device="cuda")
    if form in ("key_bias", "both"):
        keep = torch.rand(1, s, generator=gen, device="cuda") > 0.2
        keep[:, 0] = True
        key_bias = torch.where(keep, 0.0, -1e9)
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, bias, key_bias, do)


@pytest.mark.parametrize("s,lo,hi", [
    (130, 0, 64), (130, 128, 130), (901, 0, 128), (901, 896, 901), (941, 896, 941)])
def test_flash_attention_bf16_inf_key_bias_over_a_tile(gen, s, lo, hi):
    """A -inf key bias over keys [lo, hi) of every row, with the table: over
    the first 128-key tile, or over the ragged last one, which the forward
    walks first, so that a row's first tile is all -inf."""
    q, k, v, table, _ = _two_terms(gen, 2, s, "zero", h=2)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    key_bias = torch.zeros(2, s, device="cuda")
    key_bias[:, lo:hi] = -torch.inf
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, table, key_bias, do)


def test_flash_attention_bf16_backward_bit_identical_at_the_batched_chunk(gen):
    """At [8, 901, 12, 64] without terms (ALBEF's batched chunk in bf16), two
    backward runs give the same bits, and everything is held as in
    :func:`test_flash_attention_bf16_kernels`."""
    q, k, v, _ = _attention_case(gen, 8, 901, 901, "none", h=12)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, None, None, do)


# ---------------------------------------------------------------------------
# head dim 34 (VLMo-base+: 544 over 16 heads), both instances
# ---------------------------------------------------------------------------


def _hd34_case(gen, b, sq, sk, kind, dtype, h=16):
    """q, k, v at [B, S, H, 34] as views of [B, S, H * 34] projections (a
    head starts 136 bytes, 68 in bf16, after the last, as the model hands
    them over) and a key bias: ``"text_pad"`` masks (-1e9) keys 28..39 of
    row 1 (VLMo's padded text inside the joint sequence), ``"left_pad"``
    the first 70 keys of every row at -inf, ``"none"`` gives none."""
    q, k, v = (torch.randn(b, s, h * 34, generator=gen, device="cuda").to(dtype).view(
        b, s, h, 34) for s in (sq, sk, sk))
    key_bias = None
    if kind == "text_pad":
        key_bias = torch.zeros(b, sk, device="cuda")
        key_bias[min(1, b - 1), max(0, min(40, sk) - 12) : min(40, sk)] = -1e9
    elif kind == "left_pad":
        key_bias = torch.zeros(b, sk, device="cuda")
        key_bias[:, :70] = -torch.inf
    return q, k, v, key_bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,kind", [
    (2, 1, 1, "none"), (2, 63, 63, "text_pad"), (2, 130, 130, "text_pad"),
    (2, 200, 77, "text_pad"), (2, 77, 200, "none"), (1, 941, 941, "text_pad"),
    (8, 941, 941, "text_pad"), (16, 941, 941, "text_pad"), (2, 941, 941, "left_pad"),
])
def test_flash_attention_hd34_kernels(gen, b, sq, sk, kind, dtype):
    """K3 at head dim 34 in both dtypes, forward and backward, against the
    plain versions (float32: :func:`_close`; bf16: :func:`_bf16_close`
    against the float32 computation) at ragged lengths, Sq != Sk, VLMo-base+'s
    941 tokens at batch 1, 8 and 16 with the padded-text key bias and a -inf
    first key tile; outputs of the inputs' shapes; the backward the same bit
    for bit."""
    q, k, v, key_bias = _hd34_case(gen, b, sq, sk, kind, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = 34 ** -0.5
    if dtype == torch.bfloat16:
        _check_bf16_case(q, k, v, None, key_bias, do, scale)
        return
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale, key_bias)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, None, scale, return_lse=True,
                                                     key_bias=key_bias)
    assert o.shape == q.shape and o.is_contiguous()
    _close(o, o_r, "o")
    _close(lse, lse_r, "lse")
    grads = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, key_bias)
    again = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do, key_bias)
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        assert g.shape == r.shape
        assert torch.equal(g, g2), f"{name} differs between two runs"
        _close(g, r, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd34_with_a_table_and_packed_views(gen, dtype):
    """Head dim 34 with both terms (a [1, H, S, S] table and the key bias)
    and q/k/v as views of one packed [B, S, 3, H, 34] buffer."""
    b, s, h = 2, 130, 4
    qkv = torch.randn(b, s, 3, h, 34, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    table = torch.randn(1, h, s, s, generator=gen, device="cuda") * 0.5
    key_bias = torch.zeros(b, s, device="cuda")
    key_bias[1, 28:40] = -1e9
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = 34 ** -0.5
    if dtype == torch.bfloat16:
        _check_bf16_case(q, k, v, table, key_bias, do, scale)
        return
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, key_bias)
    _close(o, attention.flash_attention_reference(q, k, v, table, scale, key_bias=key_bias), "o")
    grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, key_bias)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        _close(g, r, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd34_autograd_counts_and_refusals(gen, dtype):
    """The autograd Function at head dim 34 against autograd through the
    plain version, counted as a head-dim-34 launch of the dtype's instance
    (and as a key-bias launch); the gradients come back in the inputs'
    shapes.  The float32 kernels read q/k/v through the folded map: a view
    whose base is off 16 bytes is copied into packed rows (counted, one a
    tensor) and gives the plain version's output; an odd head count is
    refused (dO's rows); a head dim of neither 34 nor 64 is refused in both
    dtypes.  The bf16 kernels read through their own folded map: such a view
    is copied and counted too, and 3 heads (rows of 102 elements, off 16
    bytes) run: q, k, v copied into rows of 104, O back in such rows, dO
    copied there, each counted."""
    q, k, v, key_bias = _hd34_case(gen, 2, 150, 150, "text_pad", dtype)
    w = torch.randn(q.shape, generator=gen, device="cuda")
    prefix = "bf16_" if dtype == torch.bfloat16 else ""
    names = [prefix + n for n in ("launches", "key_bias_launches", "hd34_launches")]
    outs, grads = [], []
    for fn in (attention.flash_attention, attention.flash_attention_reference):
        xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        before = [getattr(attention.flash_attention_fwd, n) for n in names]
        bwd = getattr(attention.flash_attention_bwd, prefix + "hd34_launches")
        out = fn(*xs, None, 34 ** -0.5, key_bias=key_bias)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out.float() * w).sum(), xs))
        if fn is attention.flash_attention:
            after = [getattr(attention.flash_attention_fwd, n) for n in names]
            assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
            assert getattr(attention.flash_attention_bwd, prefix + "hd34_launches") == bwd + 1
    for name, a, r in [("o", *outs)] + list(zip(("dq", "dk", "dv"), *grads)):
        assert a.shape == r.shape == q.shape, name
        if dtype == torch.float32:
            _close(a, r, name)
        else:  # as test_flash_attention_bf16_autograd_counts_and_key_bias_guard holds it
            err = float((a.float() - r.float()).abs().max())
            assert err <= 2 ** -6 * float(r.float().abs().max()), f"{name}: {err}"
    with pytest.raises(ValueError, match="34, 64"):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32], None, 0.125)
    if dtype == torch.float32:
        buf = torch.randn(2, 130, 4 * 34 + 1, generator=gen, device="cuda")
        off = buf[..., 1:].view(2, 130, 4, 34)  # the base 4 bytes off 16
        copies = attention.flash_attention_fwd.hd34_copy_launches
        o, _ = attention.flash_attention_fwd(off, off, off, None, 0.125)
        assert attention.flash_attention_fwd.hd34_copy_launches == copies + 3
        _close(o, attention.flash_attention_reference(off, off, off, None, 0.125), "o")
        odd = torch.randn(2, 130, 3, 34, generator=gen, device="cuda")
        with pytest.raises(ValueError, match="H must be even"):
            attention.flash_attention_fwd(odd, odd, odd, None, 0.125)
        return
    buf = torch.randn(2, 130, 4 * 34 + 1, generator=gen, device="cuda").bfloat16()
    off = buf[..., 1:].view(2, 130, 4, 34)  # the base 2 bytes off 16
    copies = attention.flash_attention_fwd.hd34_copy_launches
    o, _ = attention.flash_attention_fwd(off, off, off, None, 0.125)
    assert attention.flash_attention_fwd.hd34_copy_launches == copies + 3
    _bf16_close(o, attention.flash_attention_reference(off, off, off, None, 0.125),
                _bf16_truth(off, off, off, None, 0.125, torch.zeros_like(off))[0], "o")
    q3, k3, v3 = (torch.randn(2, 130, 3 * 34, generator=gen, device="cuda").bfloat16().view(
        2, 130, 3, 34) for _ in range(3))
    do = torch.randn(q3.shape, generator=gen, device="cuda").bfloat16()
    copies = [attention.flash_attention_fwd.hd34_copy_launches,
              attention.flash_attention_bwd.hd34_copy_launches]
    o, _ = attention.flash_attention_fwd(q3, k3, v3, None, 34 ** -0.5)
    assert o.stride() == (130 * 104, 104, 34, 1)
    _check_bf16_case(q3, k3, v3, None, None, do, 34 ** -0.5)
    # two forwards and two backwards: q, k, v each time, and dO in each backward
    assert [attention.flash_attention_fwd.hd34_copy_launches,
            attention.flash_attention_bwd.hd34_copy_launches] == [copies[0] + 6, copies[1] + 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk", [(2, 63, 63), (2, 200, 77), (2, 941, 941)])
def test_flash_attention_hd34_no_neighbour_head_leaks_in(gen, b, sq, sk, dtype):
    """Head dim 34 on the Hopper route in both dtypes, q/k/v [B, S, 16, 34]
    in the projections' layout (read in place: no copy), every odd head's v
    and dO at 1e3 times the others' (and its q, k at 3 times): each head's
    output columns, forward and backward, against the plain version within
    the dtype's tolerance of that head's largest magnitude (float32 2e-5;
    bf16 :func:`_bf16_close`).  A box whose columns past the head (float32:
    the next head's first 6 of 40; bf16: up to 30 on the right and 6 on the
    left of 64) reached a product would add a large head's products into a
    small one, and a store past the head's 34 columns would overwrite its
    neighbour's."""
    q, k, v, key_bias = _hd34_case(gen, b, sq, sk, "text_pad", torch.float32)
    odd = torch.arange(16, device="cuda") % 2 == 1
    big = torch.where(odd, 1e3, 1.0)[:, None]
    q, k = ((t * torch.where(odd, 3.0, 1.0)[:, None]).to(dtype) for t in (q, k))
    v = (v * big).to(dtype)
    do = (torch.randn(q.shape, generator=gen, device="cuda") * big).to(dtype)
    assert all(attention.fits_folded_box(t) for t in (q, k, v))
    assert attention.k3_route(dtype, 34) == ("tf32_wgmma" if dtype == torch.float32
                                             else "bf16_wgmma")
    scale = 34 ** -0.5
    copies = [attention.flash_attention_fwd.hd34_copy_launches,
              attention.flash_attention_bwd.hd34_copy_launches]
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale, key_bias)
    o_r = attention.flash_attention_reference(q, k, v, None, scale, key_bias=key_bias)
    grads = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, key_bias)
    refs = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do, key_bias)
    assert [attention.flash_attention_fwd.hd34_copy_launches,
            attention.flash_attention_bwd.hd34_copy_launches] == copies
    truth = (_bf16_truth(q, k, v, None, scale, do, key_bias) if dtype == torch.bfloat16
             else (None,) * 4)
    for name, g, r, t in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_r, *refs), truth):
        assert torch.isfinite(g).all(), name
        for h in range(16):
            if dtype == torch.float32:
                _close(g[:, :, h], r[:, :, h], f"{name} head {h}")
            else:
                _bf16_close(g[:, :, h], r[:, :, h], t[:, :, h], f"{name} head {h}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd34_backward_bit_identical_at_the_victims_batch(gen, dtype):
    """At [16, 941, 16, 34] with the padded-text key bias, VLMo-base+'s
    victim batch: two backward runs give the same bits."""
    q, k, v, key_bias = _hd34_case(gen, 16, 941, 941, "text_pad", dtype)
    scale = 34 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale, key_bias)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    first = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, key_bias)
    second = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, key_bias)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{name} differs between two runs"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(2, 130), (2, 941)])
def test_flash_attention_rows_masked_whole_by_a_finite_bias(gen, b, s, dtype):
    """A row whose every key carries -1e9 (the key bias of batch row 1),
    beside the table: the row maximum m is then about -1e9, the forward
    saves m and log l apart, and P is formed as exp2(((S - m) - log l)
    log2 e), subtracted first, in both instances, so the kernels agree with
    their plain versions forward and backward (with L log2 e rounded first,
    off by ~64 in the exponent, they did not in bf16)."""
    q, k, v, table, kb = _two_terms(gen, b, s, "zero")
    kb[1] = -1e9
    if dtype == torch.float32:
        scale = 64 ** -0.5
        o, lse = attention.flash_attention_fwd(q, k, v, table, scale, kb)
        o_r, lse_r = attention.flash_attention_reference(q, k, v, table, scale,
                                                         return_lse=True, key_bias=kb)
        _close(o, o_r, "o")
        _close(lse, lse_r, "lse")
        do = torch.randn(o.shape, generator=gen, device="cuda")
        grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb)
        refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, kb)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            _close(g, r, name)
        return
    q, k, v = (t.bfloat16() for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    _check_bf16_case(q, k, v, table, kb, do)


def _softmax_autograd(q, k, v, bias, key_bias, do, scale):
    """``(o, dq, dk, dv)`` of autograd through the explicit float32 softmax
    from the same inputs, as the JAX einsum path computes it (-1e9 swamps
    a score in float32, so a row masked whole is uniform): independent of
    the saved statistics."""
    xs = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", xs[0] * scale, xs[1])
    if bias is not None:
        s = s + bias
    s = s + key_bias[:, None, None, :]
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), xs[2])
    return (o.detach(), *torch.autograd.grad(o, xs, do.float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table", [True, False])
def test_flash_attention_masked_row_backward_matches_softmax_autograd(gen, dtype, table):
    """The masked row's gradients against autograd of the softmax, not the
    plain version, which shares the kernels' saved statistics: with L = m +
    log l saved as one float32, both gave Sk times the true dq, dk, dv on
    that row.  Row 1 of [2, 185, 12, 64] (ViLT's joint length, the key bias
    alone or beside a table) within 2e-5 (float32) or two bf16 ulps (2^-6)
    of the largest true value (at least 1)."""
    b, s, h = 2, 185, 12
    q, k, v, _ = _attention_case(gen, b, s, s, "none", h)
    bias = torch.randn(1, h, s, s, generator=gen, device="cuda") * 0.5 if table else None
    kb = torch.zeros(b, s, device="cuda")
    kb[1] = -1e9
    q, k, v = (t.to(dtype) for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = attention.flash_attention_fwd(q, k, v, bias, 0.125, kb)
    assert lse.shape == (2, b, h, s)
    grads = attention.flash_attention_bwd(q, k, v, bias, 0.125, o, lse, do, kb)
    truth = _softmax_autograd(q, k, v, bias, kb, do, 0.125)
    rel = 2e-5 if dtype == torch.float32 else 2 ** -6
    for name, g, t in zip(("o", "dq", "dk", "dv"), (o, *grads), truth):
        err = float((g[1].float() - t[1]).abs().max())
        assert err <= rel * max(1.0, float(t.abs().max())), f"{name} of the masked row: {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 16])
def test_flash_attention_at_the_vilt_shape(gen, dtype, b):
    """K3 at ViLT-B/32's joint sequence, [B, 185, 12, 64] (a ragged second
    key tile), with the key bias alone (the padded text of the first 40
    tokens at -1e9), forward and backward against the plain versions
    (float32: :func:`_close`; bf16: :func:`_check_bf16_case`), the
    backward the same bit for bit."""
    s, h = 185, 12
    q, k, v, _ = _attention_case(gen, b, s, s, "none", h)
    kb = torch.zeros(b, s, device="cuda")
    kb[:, 30:40] = -1e9
    do = torch.randn(q.shape, generator=gen, device="cuda")
    if dtype == torch.bfloat16:
        _check_bf16_case(*(t.bfloat16() for t in (q, k, v)), None, kb, do.bfloat16())
        return
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale, kb)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, None, scale, return_lse=True,
                                                     key_bias=kb)
    _close(o, o_r, "o")
    _close(lse, lse_r, "lse")
    grads = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, kb)
    again = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do, kb)
    refs = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do, kb)
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        _close(g, r, name)


# ---------------------------------------------------------------------------
# the attack zoo and multi-restart PGD on the card against the same calls on
# the CPU
# ---------------------------------------------------------------------------


class _DrawnOnCpu(TorchKey):
    """A key that draws on the CPU and hands the draws to ``device``: a CPU
    run and a card run see the same noise."""

    def __init__(self, seed, device):
        super().__init__(seed, "cpu")
        self.target = torch.device(device)

    def uniform(self, *a, **kw):
        return super().uniform(*a, **kw).to(self.target)

    def rademacher(self, *a, **kw):
        return super().rademacher(*a, **kw).to(self.target)

    def randint(self, *a, **kw):
        return super().randint(*a, **kw).to(self.target)


def _zoo(device):
    g = torch.Generator().manual_seed(3)
    w = torch.randn(24, 5, generator=g).to(device)
    bias = (torch.randn(5, generator=g) * 0.1).to(device)
    x = (torch.rand(4, 24, generator=g) * 1.2 - 0.6).to(device)

    def logits(px):
        return px @ w + bias

    y = torch.argmax(logits(x), dim=1)  # the classifier's own answers

    def key():
        return _DrawnOnCpu(7, device)

    best, best_l2, _ = extra.cw_l2_search(logits, x, y, 5, max_iterations=40,
                                          binary_search_steps=4, lr=0.05, initial_const=0.05)
    return {
        "fgm": extra.fgm_classifier(logits, x, y, eps=0.1),
        "pgd": extra.pgd_classifier(logits, x, y, key(), eps=0.3, eps_iter=0.05, nb_iter=5),
        "mim": extra.momentum_iterative_method(logits, x, y, eps=0.3, eps_iter=0.05, nb_iter=5),
        "spsa": extra.spsa(logits, x, y, key(), eps=0.3, nb_iter=3, spsa_samples=12),
        "semantic": extra.semantic(x),
        "noise": extra.noise(x, key(), eps=0.3),
        "cw_l2": best, "cw_l2_success": torch.isfinite(best_l2),
    }


def test_zoo_on_the_card_matches_the_cpu(gen):
    """The seven attacks on a linear classifier, on the card and on the CPU
    from the same draws: the same CW-L2 successes, every image within 1e-5
    (CW-L2's 40 Adam steps, 1e-4)."""
    card, cpu = _zoo("cuda"), _zoo("cpu")
    assert torch.equal(card.pop("cw_l2_success").cpu(), cpu.pop("cw_l2_success"))
    for name, adv in card.items():
        assert adv.is_cuda
        tol = 1e-4 if name == "cw_l2" else 1e-5
        torch.testing.assert_close(adv.cpu(), cpu[name], rtol=0, atol=tol, msg=name)


def test_multi_restart_on_the_card_matches_the_cpu(gen):
    """``pgd_multi_restart`` (R = 3, 4 steps) over one attention layer at
    [2, 130, 2, 64] under ``attention_impl("flash")``: on the card K1 ends
    every step and K3 runs every forward and backward; against the CPU run
    from the same draws the same restart per sample, the losses within rtol
    1e-4 and the images within the PGD drift budget."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(128, 2).requires_grad_(False)
    w = torch.randn(2, 130, 128)
    x = torch.rand(2, 130, 128) * 2 - 1
    kw = dict(eps=0.125, eps_iter=0.01, nb_iter=4)

    def run(device):
        m, wd = mha.to(device), w.to(device)

        def loss_fn(adv, key, aux):
            ps = (m(adv) * wd).flatten(1).sum(1)
            return ps.sum(), ps

        with attention.attention_impl("flash"):
            return tpgd.pgd_multi_restart(loss_fn, x.to(device), x.to(device),
                                          _DrawnOnCpu(5, device), None, n_restarts=3, **kw)

    k1, fwd, bwd = (pgd_update.pgd_linf_update.launches, attention.flash_attention_fwd.launches,
                    attention.flash_attention_bwd.launches)
    adv_c, l_c = run("cuda")
    assert pgd_update.pgd_linf_update.launches - k1 == 12
    assert attention.flash_attention_fwd.launches - fwd == 12 + 3
    assert attention.flash_attention_bwd.launches - bwd == 12
    adv, l = run("cpu")
    torch.testing.assert_close(l_c.cpu(), l, rtol=1e-4, atol=0)
    d = (adv_c.cpu() - adv).abs()
    assert float(d.max()) <= 2 * 0.01 * 4 + 1e-6 and float(d.mean()) < 1e-4
    assert float((adv_c.cpu() - x).abs().max()) <= 0.125 + 1e-6


# ---------------------------------------------------------------------------
# the fine-tuning slice's shapes: ALBEF's ViT at 384 px (577 tokens: four
# 128-row tiles and 65 rows), nlvr2's pairs at 2 x 8; VLMo-base at 384 px
# (617 joint tokens), vlmo_irtr's 8 x 3 pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [8, 16])
def test_flash_attention_at_the_finetuning_shapes(gen, b):
    """K3 without terms at [B, 577, 12, 64] (retrieval and ve at batch 8,
    nlvr2's 16 images) against the plain versions, the backward the same
    bit for bit."""
    q, k, v, _ = _attention_case(gen, b, 577, 577, "none", h=12)
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, None, scale)
    o_r, lse_r = attention.flash_attention_reference(q, k, v, None, scale, return_lse=True)
    _close(o, o_r, "o")
    _close(lse, lse_r, "lse")
    do = torch.randn(o.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do)
    again = attention.flash_attention_bwd(q, k, v, None, scale, o, lse, do)
    refs = attention.flash_attention_bwd_reference(q, k, v, None, scale, o, lse, do)
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        _close(g, r, name)


def _vlmo_base_384_table(gen, h=12):
    """One layer's [1, H, 617, 617] bias of a VLMo-base table at 384 px: the
    index tables of a 24 x 24 window and 40 text tokens, the layer's
    columns drawn normal(0, 0.5) as ``init_vlmo_weights`` draws them."""
    from vqattack_tpu_torch.models.vlmo import build_relative_position_index

    idx = build_relative_position_index((24, 24), 40)
    table = torch.randn(idx["all_num_relative_distance"], h, generator=gen, device="cuda") * 0.5
    joint = torch.as_tensor(idx["joint"], dtype=torch.long, device="cuda")
    return table[joint].permute(2, 0, 1)[None].contiguous()


def test_flash_attention_dbias_at_the_vlmo_irtr_shape(gen):
    """The dbias instance at vlmo_irtr's [24, 617, 12, 64] (clusters of 8,
    three planes added by the plane pass) with VLMo-base's table at 384 px
    and the padded text's key bias (rows of 12 to 30 real tokens of 40):
    against the plain backward, dbias and dq/dk/dv the same bit for bit on
    a repeat."""
    b, s = 24, 617
    q, k, v, _ = _attention_case(gen, b, s, s, "none", h=12)
    table = _vlmo_base_384_table(gen)
    kb = torch.zeros(b, s, device="cuda")
    for row in range(b):
        kb[row, 12 + (row * 7) % 19: 40] = -1e9
    plan = attention.dbias_plan((b, 12, s, s), tuple(table.shape))
    assert (plan.cluster, plan.groups) == (8, 3)
    scale = 64 ** -0.5
    o, lse = attention.flash_attention_fwd(q, k, v, table, scale, kb)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    grads = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)
    again = attention.flash_attention_bwd(q, k, v, table, scale, o, lse, do, kb, dbias=True)
    refs = attention.flash_attention_bwd_reference(q, k, v, table, scale, o, lse, do, kb,
                                                   dbias=True)
    assert grads[3].shape == table.shape
    for name, g, g2, r in zip(("dq", "dk", "dv", "dbias"), grads, again, refs):
        assert torch.equal(g, g2), f"{name} differs between two runs"
        (_dbias_close if name == "dbias" else _close)(g, r, name)


def test_vlmo_irtr_step_on_the_card(gen):
    """One ``vlmo_irtr`` step (two negatives) of a two-block VLMo-base at
    384 px, batch 2, on the card under flash and under xla from the same
    weights and offsets: the losses within 1e-5; each entry of the
    relative-position table's gradient within 1e-4 of its mass (the |bias
    gradients| the gather adds into it) or 1e-6 of the largest entry, as
    ``chip_smoke.py``'s ``TABLE_GRAD_TOL``; under flash one K3 forward and
    one dbias backward a block, at [6, 617]."""
    import copy
    import dataclasses

    from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
    from vqattack_tpu_torch.named_configs import vlmo_config_from_named, vlmo_named_config
    from vqattack_tpu_torch.train import objectives

    cfg = dataclasses.replace(vlmo_config_from_named(vlmo_named_config(
        "task_finetune_irtr_f30k_base_image384")), depth=2, vlffn_start_layer=1)
    with torch.device("cuda"):
        # .to: the relative-position indices are buffers made from numpy
        model = init_vlmo_weights(VLMo(cfg), 0).to("cuda")
    batch = {"pixels": torch.rand(2, 3, 384, 384, generator=gen, device="cuda") * 2 - 1,
             "text_ids": torch.randint(1000, 2000, (2, 40), generator=gen, device="cuda"),
             "text_mask": torch.ones(2, 40, dtype=torch.long, device="cuda")}
    batch["text_mask"][1, 25:] = 0
    out = {}
    for impl in ("flash", "xla"):
        m = copy.deepcopy(model)
        biases, rel_bias = [], m._rel_bias

        def recorded(layer, kind):  # each attention's gathered bias, for its gradient
            biases.append((layer, kind, rel_bias(layer, kind)))
            return biases[-1][2]

        m._rel_bias = recorded
        fwd = attention.flash_attention_fwd.launches
        dbias = attention.flash_attention_bwd.dbias_launches
        with attention.attention_impl(impl):
            loss, _ = objectives.vlmo_irtr_train_loss(m, batch, TorchKey(3, "cuda"), num_negs=2)
            g, *layer_grads = torch.autograd.grad(
                loss, [m.relative_position_bias_table] + [b for *_, b in biases])
        n = 2 if impl == "flash" else 0
        assert attention.flash_attention_fwd.launches - fwd == n
        assert attention.flash_attention_bwd.dbias_launches - dbias == n
        assert torch.isfinite(loss) and bool(torch.isfinite(g).all())
        mass = torch.zeros_like(g)
        for (layer, kind, _), lg in zip(biases, layer_grads):
            idx = getattr(m, f"_rel_index_{kind}").flatten()
            mass[:, layer * 12:(layer + 1) * 12].index_add_(
                0, idx, lg[0].abs().permute(1, 2, 0).reshape(-1, 12))
        out[impl] = (float(loss), g, mass)
    (lf, gf, _), (lx, gx, mass) = out["flash"], out["xla"]
    assert abs(lf - lx) <= 1e-5 * max(1.0, abs(lx))
    assert float(gx.abs().max()) > 0
    assert bool(((gf - gx).abs() <= 1e-4 * mass + 1e-6 * float(gx.abs().max())).all())


def test_kernels_refuse_a_second_backward(gen):
    """K2 and K3 (float32) give their first-order gradients, and a backward
    that builds a graph through them (``create_graph=True``, a Hessian-vector
    product) raises instead of handing back gradients blind to the inputs;
    the failed backward launches no kernel."""
    x = torch.randn(901, 768, generator=gen, device="cuda", requires_grad=True)
    delta = torch.randn(901, 768, generator=gen, device="cuda", requires_grad=True)
    gamma = (torch.randn(768, generator=gen, device="cuda") * 0.1 + 1).requires_grad_()
    beta = (torch.randn(768, generator=gen, device="cuda") * 0.1).requires_grad_()
    s, h = fused_ln.residual_layernorm(x, delta, gamma, beta)
    loss = (h ** 3).sum() + (s ** 2).sum()
    before = fused_ln.residual_layernorm_bwd.launches
    torch.autograd.grad(loss, [x, gamma], retain_graph=True)
    assert fused_ln.residual_layernorm_bwd.launches == before + 1
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(loss, [x, gamma], create_graph=True)
    assert fused_ln.residual_layernorm_bwd.launches == before + 1
    q, k, v = (torch.randn(2, 197, 12, 64, generator=gen, device="cuda", requires_grad=True)
               for _ in range(3))
    o = attention.flash_attention(q, k, v, None, 0.125)
    loss = (o ** 3).sum()
    before = attention.flash_attention_bwd.launches
    torch.autograd.grad(loss, [q, k, v], retain_graph=True)
    assert attention.flash_attention_bwd.launches == before + 1
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(loss, [q, k, v], create_graph=True)
    assert attention.flash_attention_bwd.launches == before + 1


class _OptimizerLeaves(torch.nn.Module):
    """Leaves of the models' kinds at a width where Adafactor factors."""

    def __init__(self):
        super().__init__()
        self.patch_embed = torch.nn.Module()
        self.patch_embed.proj = torch.nn.Conv2d(3, 128, 8, stride=8)
        self.query = torch.nn.Linear(128, 128)
        self.intermediate = torch.nn.Linear(128, 512)
        self.LayerNorm = torch.nn.LayerNorm(128)
        self.vqa_classifier = torch.nn.Linear(256, 300)


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd", "rmsprop", "adafactor", "lamb", "lion",
                                 "nadam", "radam", "adamp", "sgdp", "novograd", "nvnovograd",
                                 "rmsproptf", "adahessian", "lookahead_adamw"])
def test_optimizer_steps_on_the_card_match_the_cpu(gen, opt):
    """7 steps (lookahead syncs once) from the same parameters, gradients
    (and Hessian diagonals) on the card and on the CPU: every parameter
    within rtol 1e-5 and 1e-4 of a step (lr 1e-2 times the head's 2), the
    zoo's CPU tolerance (``tests/test_torch_optim_zoo.py``); only
    reductions' orders differ.  No clipping: see ``chip_smoke.py``'s
    ``OPT_ATOL``."""
    import copy

    from vqattack_tpu_torch.train import optim

    torch.manual_seed(0)
    cpu = _OptimizerLeaves()
    card = copy.deepcopy(cpu).to("cuda")
    txs = [optim.create_optimizer(m, opt, optim.create_schedule("cosine", 1e-2, 9,
                                                                warmup_steps=2),
                                  weight_decay=0.05, head_lr_mult=2.0)
           for m in (cpu, card)]
    params = [optim.named_params(m) for m in (cpu, card)]
    states = [tx.init(p) for tx, p in zip(txs, params)]
    g_cpu = torch.Generator().manual_seed(1)
    for _ in range(7):
        grads = {n: torch.randn(p.shape, generator=g_cpu) * 0.1 for n, p in params[0].items()}
        hess = ({n: torch.randn(p.shape, generator=g_cpu) for n, p in params[0].items()}
                if opt == "adahessian" else None)
        for i, (tx, p) in enumerate(zip(txs, params)):
            dev = "cpu" if i == 0 else "cuda"
            states[i] = tx.step(p, {n: g.to(dev) for n, g in grads.items()}, states[i],
                                None if hess is None else {n: h.to(dev) for n, h in hess.items()})
    for n, p in params[0].items():
        torch.testing.assert_close(params[1][n].cpu(), p, rtol=1e-5, atol=1e-4 * 1e-2 * 2,
                                   msg=lambda m: f"{opt} {n}: {m}")


def test_hessian_vector_products_on_the_card_are_symmetric(gen, monkeypatch):
    """A two-block ViT under the plain LayerNorm and xla attention on the
    card: ``z1 . (H z2) = z2 . (H z1)`` (H is symmetric; the products are
    taken in float64 from the float32 HVPs, within 1e-4 of their size),
    and the Hutchinson diagonal of the same loss on the card and on the
    CPU within 1e-3 of each leaf's largest entry (an entry of ``H z`` is a
    sum of terms of both signs, far larger than itself, rounded in other
    orders on the two devices) or 1e-6 of the model's largest (a key
    projection's bias has a Hessian of rounding noise: the softmax is
    blind to it)."""
    import copy
    import dataclasses

    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.models.vit import VisionTransformer
    from vqattack_tpu_torch.train import adahessian

    # the patch conv in float32, as on the CPU
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    vit_cfg = dataclasses.replace(cfg_mod.tiny_test_config().albef.vit, image_size=64, depth=2,
                                  fused_ln=False)
    torch.manual_seed(0)
    cpu = VisionTransformer(vit_cfg)
    card = copy.deepcopy(cpu).to("cuda")
    px = torch.rand(2, 3, 64, 64, generator=gen, device="cuda") * 2 - 1

    def loss_fn(m, x):
        return (m(x)[0] ** 2).mean()

    params = {n: p for n, p in card.named_parameters()}
    z1, z2 = (adahessian.rademacher_like(card, TorchKey(s, "cuda")) for s in (1, 2))
    _, (h1, h2) = adahessian.grad_and_hvps(loss_fn(card, px), params, [z1, z2])
    a = sum(float((z1[n].double() * h2[n].double()).sum()) for n in params)
    b = sum(float((z2[n].double() * h1[n].double()).sum()) for n in params)
    assert abs(a - b) <= 1e-4 * max(abs(a), abs(b)) and abs(a) > 0
    _, d_card = adahessian.grad_and_hessian_diag(loss_fn, card, TorchKey(3, "cpu"), px)
    _, d_cpu = adahessian.grad_and_hessian_diag(loss_fn, cpu, TorchKey(3, "cpu"), px.cpu())
    largest = max(float(d.abs().max()) for d in d_cpu.values())
    for n, d in d_cpu.items():
        err = float((d_card[n].cpu() - d).abs().max())
        assert err <= 1e-3 * float(d.abs().max()) + 1e-6 * largest, (n, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_feats_on_the_card_match_the_stacked_form(gen, dtype):
    """The feature loss of a two-block ALBEF at width 128 (head dim 64, K2
    at the ViT's norm sites, K3 under flash) and of a two-block VLMo, with
    ``fused_feats`` against the stacked form from the same weights at batch
    4: per-sample losses within 1e-5 relative in float32 (2^-8 x 13 in
    bf16, whose fused sum is rounded once a layer), the image gradient
    within 1e-5 of its largest entry (1e-2 in bf16); the same kernel
    launches in both forms."""
    import dataclasses

    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.attacks import albef as albef_losses
    from vqattack_tpu_torch.attacks import vlmo as vlmo_losses
    from vqattack_tpu_torch.models.albef import AlbefPretrain, init_weights
    from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

    base = cfg_mod.tiny_test_config(image_size=192)
    vit = dataclasses.replace(base.albef.vit, hidden_size=128, fused_ln=True)
    bert = dataclasses.replace(base.albef.bert, hidden_size=128, encoder_width=128,
                               intermediate_size=256, num_layers=2, fusion_layer=1)
    albef = dataclasses.replace(base.albef, vit=vit, bert=bert)
    vcfg = dataclasses.replace(base.vlmo, hidden_size=128, depth=2, vlffn_start_layer=1)
    b, s = 4, base.attack.max_text_len
    px = torch.rand(b, 3, 192, 192, generator=gen, device="cuda") * 2 - 1
    ids = torch.randint(5, 64, (b, s), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 5:] = 0
    ids = ids * mask
    with torch.device("cuda"):
        a_stacked = init_weights(AlbefPretrain(albef, dtype=dtype), 0).to("cuda")
        v_stacked = init_vlmo_weights(VLMo(vcfg, dtype=dtype), 0).to("cuda")
    pairs = []
    for cls, stacked, cfg in ((AlbefPretrain, a_stacked, albef), (VLMo, v_stacked, vcfg)):
        fused = cls(cfg, dtype=dtype, fused_feats=True).to("cuda")
        fused.load_state_dict(stacked.state_dict())
        pairs.append((stacked.eval().requires_grad_(False), fused.eval().requires_grad_(False)))
    with torch.no_grad(), attention.attention_impl("flash"):
        img_t, txt_t, _ = a_stacked.gen_feats(px.flip(0), ids, mask)
        _, cls_t, tok_t, m_t = v_stacked.attack_feats(px.flip(0), ids, mask)
    aux = {"text_ids": ids, "text_mask": mask, "tgt_img": img_t, "tgt_txt": txt_t,
           "txt_token_mask": mask.float(), "special_ids": (4, 0, 2),
           "tgt_layer_cls": cls_t, "tgt_tokens": tok_t, "tgt_token_mask": m_t.float()}
    loss_tol, grad_tol = (1e-5, 1e-5) if dtype == "float32" else (13 * 2 ** -8, 1e-2)
    kernels = (fused_ln.residual_layernorm_fwd, attention.flash_attention_fwd,
               attention.flash_attention_bwd)
    attr = ("" if dtype == "float32" else "bf16_") + "launches"
    for (stacked, fused), make in zip(pairs, (albef_losses.make_feature_loss,
                                              vlmo_losses.make_feature_loss)):
        out = []
        for model in (stacked, fused):
            before = [getattr(fn, attr) for fn in kernels]
            with attention.attention_impl("flash"):
                ps, g = tpgd._value_and_grad(make(model), px, TorchKey(1, "cuda"), aux)
            out.append((ps.float(), g.float(),
                        tuple(getattr(fn, attr) - n0 for fn, n0 in zip(kernels, before))))
        (ps_s, g_s, n_s), (ps_f, g_f, n_f) = out
        assert n_s == n_f and n_f[1] == n_f[2] > 0
        assert bool(torch.isfinite(ps_f).all()) and float(g_s.abs().max()) > 0
        assert float((ps_f - ps_s).abs().max()) <= loss_tol * float(ps_s.abs().max())
        assert float((g_f - g_s).abs().max()) <= grad_tol * float(g_s.abs().max())


def test_device_preprocess_on_the_card_matches_the_cpu(gen):
    """``device_preprocess`` of a seeded uint8 batch, 96 x 72 to 64: the
    card's products (TF32 off) against the CPU's within 1e-5."""
    from vqattack_tpu_torch.data.device_transforms import device_preprocess

    raw = torch.randint(0, 256, (4, 96, 72, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    got = device_preprocess(raw, 64)
    assert got.device.type == "cuda" and got.shape == (4, 3, 64, 64)
    torch.testing.assert_close(got.cpu(), device_preprocess(raw.cpu(), 64), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cut_layers_on_the_card_equal_uncut(gen, dtype):
    """The column-cut layers of the model axis (``parallel/tensor.py``) on
    the row ``[cuda:0, cuda:0]`` against the uncut layers at ALBEF's width
    (TF32 off): a cut ``Linear``'s output and its weights' gradients within
    1e-5 (float32) or 2^-7 (bf16) relative, its input gradient, a sum of the
    pieces' partial products, within that share of its largest value; the
    cut ``Embedding`` and table equal."""
    from vqattack_tpu_torch.models.layers import Embedding, Linear
    from vqattack_tpu_torch.parallel.tensor import ColumnEmbedding, ColumnLinear, ColumnParameter

    row = [torch.device("cuda", 0)] * 2
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.manual_seed(0)
    lin = Linear(768, 3072, compute_dtype=dtype).cuda()
    x = torch.randn(8, 901, 768, generator=gen, device="cuda", requires_grad=True)
    ct = torch.randn(8, 901, 3072, generator=gen, device="cuda").to(dtype)
    cut = ColumnLinear(lin, row)
    y_cut = cut(x)
    g_cut = torch.autograd.grad(y_cut, (x, *cut.pieces), ct)
    y = lin(x)
    g = torch.autograd.grad(y, (x, lin.weight), ct)
    assert y_cut.dtype == y.dtype == dtype and y_cut.device == y.device
    for got, want in ((y_cut, y), (g_cut[0], g[0]), (torch.cat(g_cut[1:]), g[1])):
        assert float((got.float() - want.float()).abs().max()) <= tol * float(
            want.float().abs().max())

    emb = Embedding(30522, 768, compute_dtype=dtype).cuda()
    ids = torch.randint(0, 30522, (8, 35), generator=gen, device="cuda")
    assert torch.equal(ColumnEmbedding(emb, row)(ids), emb(ids))
    table = torch.randn(3970, 144, generator=gen, device="cuda")
    assert torch.equal(ColumnParameter(table, row)[:, 12:24], table[:, 12:24])
