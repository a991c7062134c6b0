"""Shared transformer building blocks.

Port of ``vqattack_tpu/models/layers.py``.  Sub-module names follow the flax
modules (``query``/``key``/``value``/``proj``, ``fc1``/``fc2``,
``norm1``/``norm2``), so ``checkpoint/convert.py`` maps one tree onto the
other by name.  Attention is the explicit product + softmax of the JAX
einsum path; the flash kernel (``--attn flash``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqattack_tpu_torch.ops.fused_ln import residual_layernorm

NEG_INF = -1e9  # additive-mask fill, as in the JAX package

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(d) -> torch.dtype:
    """Config string or torch dtype -> torch dtype."""
    return _DTYPES[d] if isinstance(d, str) else d


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, K] {0,1} key mask -> [B, 1, 1, K] additive attention bias."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    bias = torch.where(mask > 0, zero, torch.full_like(zero, NEG_INF))
    return bias[:, None, None, :]


def causal_bias(seq_len: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[1, 1, Q, K] additive causal bias (answer-decoder self-attention)."""
    i = torch.arange(seq_len, device=device)
    allowed = i[None, :] <= i[:, None]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))[None, None]


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (reference ``vit.py:11-29``)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v projections; self- or
    cross-attention (``kv``), additive ``bias``; ``use_out_proj=False`` is the
    HF BERT layout, whose output dense lives in the next block."""

    def __init__(self, dim: int, num_heads: int, kv_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, use_out_proj: bool = True,
                 softmax_dtype="float32"):
        super().__init__()
        kv_dim = dim if kv_dim is None else kv_dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.softmax_dtype = resolve_dtype(softmax_dtype)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(kv_dim, dim)
        self.value = nn.Linear(kv_dim, dim)
        self.proj = nn.Linear(dim, out_dim or dim) if use_out_proj else None

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        b, sq, _ = x.shape
        sk = kv.shape[1]
        h, dh = self.num_heads, self.head_dim
        # [B, S, H*Dh] -> [B, H, S, Dh]
        q = self.query(x).view(b, sq, h, dh).transpose(1, 2)
        k = self.key(kv).view(b, sk, h, dh).transpose(1, 2)
        v = self.value(kv).view(b, sk, h, dh).transpose(1, 2)
        attn = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
        if bias is not None:
            attn = attn + bias.to(attn.dtype)
        attn = torch.softmax(attn.to(self.softmax_dtype), dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, sq, h * dh)
        return out if self.proj is None else self.proj(out)


class ResidualLayerNorm(nn.Module):
    """``(x + delta, LayerNorm(x + delta))`` with a LayerNorm's parameters.
    Runs the fused kernel on the card (``ops/fused_ln.py``) and its plain
    version on the CPU; ``delta=None`` is a plain LayerNorm."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor]):
        return residual_layernorm(x, delta, self.weight, self.bias, self.eps)


class ViTBlock(nn.Module):
    """Pre-LN transformer block (reference ``vit.py:77-94``).

    With ``fused_ln`` the block takes and returns a pending-residual pair,
    as in the JAX package (``layers.py:188-238``): ``forward(x, delta)``
    first forms ``x + delta`` (the previous block's un-added MLP output)
    through the fused residual+LayerNorm kernel and returns
    ``(s, mlp_out, x_tap)`` with its own MLP output un-added; ``x_tap`` is
    this block's input stream, the previous block's feature tap."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_norm_eps: float = 1e-6, fused_ln: bool = False,
                 softmax_dtype="float32"):
        super().__init__()
        self.fused_ln = fused_ln
        norm = (lambda: ResidualLayerNorm(dim, layer_norm_eps)) if fused_ln else (
            lambda: nn.LayerNorm(dim, eps=layer_norm_eps))
        self.norm1 = norm()
        self.attn = MultiHeadAttention(dim, num_heads, softmax_dtype=softmax_dtype)
        self.norm2 = norm()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor] = None):
        if self.fused_ln:
            x, h = self.norm1(x, delta)
            s, h2 = self.norm2(x, self.attn(h))
            return s, self.mlp(h2), x
        if delta is not None:
            raise ValueError("delta is only taken by a fused_ln block")
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Patchify + project (timm ``PatchEmbed``): NCHW pixels -> [B, N, D]."""

    def __init__(self, patch_size: int, in_chans: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, hidden_size, patch_size, stride=patch_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        h, w = pixels.shape[-2:]
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(
                f"PatchEmbed: image {h}x{w} is not divisible by the patch size {p}"
            )
        return self.proj(pixels).flatten(2).transpose(1, 2)
