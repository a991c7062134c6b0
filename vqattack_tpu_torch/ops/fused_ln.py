"""Fused residual add + LayerNorm: kernel K2 (forward and backward).

Port of ``vqattack_tpu/ops/fused_ln.py``.  ``residual_layernorm(x, delta,
gamma, beta)`` returns ``(s, h)`` with ``s = x + delta`` in the stream dtype
and ``h = LayerNorm(s)`` computed with float32 statistics and cast back to
the stream dtype.  On a CUDA tensor both directions are the kernels of
``csrc/fused_ln.cu`` behind a ``torch.autograd.Function``; on a CPU tensor
the plain version below runs under autograd.

The plain versions (:func:`residual_layernorm_reference` and
:func:`residual_layernorm_bwd_reference`) are also the oracles the kernels
are held against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vqattack_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# widest row the kernel keeps in registers (256 threads x 4 values)
MAX_D = 1024
# rows per block of the backward kernel: each block writes one row of the
# [n_row_blocks, D] dgamma/dbeta scratch
BWD_ROWS_PER_BLOCK = 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def residual_layernorm_reference(
    x: torch.Tensor,
    delta: Optional[torch.Tensor],
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x [+ delta], LayerNorm(x [+ delta]))`` with float32 statistics."""
    s = x if delta is None else x + delta
    sf = s.float()
    mean = sf.mean(dim=-1, keepdim=True)
    var = (sf - mean).square().mean(dim=-1, keepdim=True)
    h = (sf - mean) * torch.rsqrt(var + eps)
    h = h * gamma.float() + beta.float()
    return s, h.to(x.dtype)


def residual_layernorm_bwd_reference(
    s: torch.Tensor,
    gs: Optional[torch.Tensor],
    gh: torch.Tensor,
    gamma: torch.Tensor,
    eps: float = 1e-6,
    param_grads: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward the kernel computes, in plain PyTorch:
    ``(dx, dgamma, dbeta)`` over rows ``s.reshape(-1, D)``."""
    d = s.shape[-1]
    sf = s.reshape(-1, d).float()
    ghf = gh.reshape(-1, d).float()
    mean = sf.mean(dim=-1, keepdim=True)
    var = (sf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (sf - mean) * rstd
    dxhat = ghf * gamma.float()
    c1 = dxhat.mean(dim=-1, keepdim=True)
    c2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - c1 - xhat * c2)
    if gs is not None:
        dx = gs.reshape(-1, d).float() + dx
    dx = dx.to(s.dtype).reshape(s.shape)
    if not param_grads:
        return dx, None, None
    return dx, (ghf * xhat).sum(dim=0), ghf.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(
            f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} does not match "
            f"{tuple(like.shape)} {like.dtype} on {like.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_params(gamma: torch.Tensor, d: int, device: torch.device) -> None:
    if gamma.shape != (d,) or gamma.dtype != torch.float32 or gamma.device != device:
        raise ValueError(
            f"LayerNorm parameter {tuple(gamma.shape)} {gamma.dtype} on "
            f"{gamma.device}: expected ({d},) float32 on {device}"
        )
    if not gamma.is_contiguous():
        raise ValueError("LayerNorm parameter is not contiguous")


def _check_stream_tensor(x: torch.Tensor) -> Tuple[int, int]:
    """(rows, D) of the tensor every other argument is checked against."""
    if x.device.type != "cuda":
        raise ValueError(f"residual_layernorm kernel: tensor on {x.device}, expected cuda")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"residual_layernorm kernel: {x.dtype}; takes float32 or bfloat16")
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"residual_layernorm kernel: feature width {d} not in (0, {MAX_D}]")
    if not x.is_contiguous():
        raise ValueError("residual_layernorm kernel: input is not contiguous")
    return x.numel() // d, d


def residual_layernorm_fwd(x, delta, gamma, beta, eps: float = 1e-6):
    """Forward kernel: ``(s, h)`` for CUDA tensors ``x``, ``delta`` of one
    shape ``[..., D]`` and float32 ``gamma``, ``beta`` of shape ``[D]``."""
    rows, d = _check_stream_tensor(x)
    _check_rows("delta", delta, x)
    _check_params(gamma, d, x.device)
    _check_params(beta, d, x.device)
    s = torch.empty_like(x)
    h = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        status = lib.vq_residual_layernorm_fwd(
            _DTYPE_CODES[x.dtype], x.data_ptr(), delta.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), s.data_ptr(), h.data_ptr(),
            rows, d, eps, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "residual_layernorm_fwd")
    residual_layernorm_fwd.launches += 1
    return s, h


def residual_layernorm_bwd(s, gs, gh, gamma, eps: float = 1e-6, param_grads: bool = True):
    """Backward kernel: ``(dx, dgamma, dbeta)``.  ``gs`` may be ``None`` (no
    gradient reached ``s``).  With ``param_grads=False`` the parameter sums
    are skipped and ``(dx, None, None)`` comes back."""
    rows, d = _check_stream_tensor(s)
    _check_rows("grad of h", gh, s)
    if gs is not None:
        _check_rows("grad of s", gs, s)
    _check_params(gamma, d, s.device)
    dx = torch.empty_like(s)
    part = dgdb = None
    if param_grads:
        n_row_blocks = -(-rows // BWD_ROWS_PER_BLOCK)
        part = torch.empty((2, n_row_blocks, d), dtype=torch.float32, device=s.device)
        dgdb = torch.empty((2, d), dtype=torch.float32, device=s.device)
    lib = _build.load()
    with torch.cuda.device(s.device):
        status = lib.vq_residual_layernorm_bwd(
            _DTYPE_CODES[s.dtype], s.data_ptr(),
            None if gs is None else gs.data_ptr(), gh.data_ptr(),
            gamma.data_ptr(), dx.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dgdb is None else dgdb.data_ptr(),
            rows, d, BWD_ROWS_PER_BLOCK, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "residual_layernorm_bwd")
    residual_layernorm_bwd.launches += 1
    if dgdb is None:
        return dx, None, None
    return dx, dgdb[0], dgdb[1]


# launches of each kernel in this process (plain counts for chip_smoke.py)
residual_layernorm_fwd.launches = 0
residual_layernorm_bwd.launches = 0


class _ResidualLayerNormFn(torch.autograd.Function):
    """The kernel pair as one differentiable op (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, x, delta, gamma, beta, eps):
        s, h = residual_layernorm_fwd(x, delta, gamma, beta, eps)
        ctx.save_for_backward(s, gamma)
        ctx.eps = eps
        return s, h

    @staticmethod
    def backward(ctx, gs, gh):
        s, gamma = ctx.saved_tensors
        need_x = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_params = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        if gh is None:
            # only s was used downstream: the LayerNorm branch has no gradient
            zeros_p = torch.zeros_like(gamma) if need_params else None
            return gs, gs, zeros_p, zeros_p, None
        if not (need_x or need_params):
            return None, None, None, None, None
        dx, dg, db = residual_layernorm_bwd(
            s, None if gs is None else gs.contiguous(), gh.contiguous(), gamma,
            ctx.eps, param_grads=need_params,
        )
        return dx, dx, dg, db, None


def residual_layernorm(
    x: torch.Tensor,
    delta: Optional[torch.Tensor],
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(x + delta, LayerNorm(x + delta))``.

    ``delta=None`` is a plain LayerNorm with nothing to fuse and always takes
    the plain version, as in the JAX package.  Otherwise a CUDA tensor runs
    the kernels and a CPU tensor the plain version."""
    if delta is None or x.device.type == "cpu":
        return residual_layernorm_reference(x, delta, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"residual_layernorm: unsupported device {x.device}")
    return _ResidualLayerNormFn.apply(x.contiguous(), delta.contiguous(), gamma, beta, eps)
