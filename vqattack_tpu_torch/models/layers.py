"""Shared transformer building blocks.

Port of ``vqattack_tpu/models/layers.py``.  Sub-module names follow the flax
modules (``query``/``key``/``value``/``proj``, ``fc1``/``fc2``,
``norm1``/``norm2``), so ``checkpoint/convert.py`` maps one tree onto the
other by name.  Attention is the explicit product + softmax of the JAX
einsum path, or under ``attention_impl("flash")`` (``--attn flash``) the
flash kernel K3 for sequences of at least 128 queries (``ops/attention.py``).
It adds up to two terms to the scaled scores: ``bias``, broadcast
``[1|B, 1|H, 1|Sq, Sk]`` (VLMo's relative-position table, a causal mask),
and ``key_bias``, one value a key ``[B, Sk]`` (a key mask).

Every layer to which flax gives a ``dtype`` takes a compute dtype, with
flax's semantics rather than ``torch.autocast``'s: parameters stay float32
(what ``checkpoint/convert.py`` loads); :class:`Linear`, :class:`Conv2d` and
:class:`Embedding` compute in the compute dtype from their parameters cast
to it; :class:`LayerNorm` takes its statistics and affine map in float32 and
returns the compute dtype; GELU runs in the compute dtype and the softmax in
``softmax_dtype``, cast back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqattack_tpu_torch.ops import attention
from vqattack_tpu_torch.ops.fused_ln import residual_layernorm

NEG_INF = -1e9  # additive-mask fill, as in the JAX package

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(d) -> torch.dtype:
    """Config string or torch dtype -> torch dtype."""
    return _DTYPES[d] if isinstance(d, str) else d


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype=)``):
    the input, the float32 weight and bias cast to it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype="float32"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, as :class:`Linear`."""

    def __init__(self, *args, compute_dtype="float32", **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt))


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``compute_dtype``, the values
    of flax ``Embed(dtype=)``, which casts the table before the lookup."""

    def __init__(self, num_embeddings: int, embedding_dim: int, compute_dtype="float32"):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=)``: statistics, normalisation and the float32
    affine map in float32, the result in ``compute_dtype``."""

    def __init__(self, dim: int, eps: float, compute_dtype="float32"):
        super().__init__(dim, eps=eps)
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def mask_to_key_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, K] {0,1} key mask -> [B, K] additive bias, one value a key."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask > 0, zero, torch.full_like(zero, NEG_INF))


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, K] {0,1} key mask -> [B, 1, 1, K] additive attention bias."""
    return mask_to_key_bias(mask, dtype)[:, None, None, :]


def causal_bias(seq_len: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[1, 1, Q, K] additive causal bias (answer-decoder self-attention)."""
    i = torch.arange(seq_len, device=device)
    allowed = i[None, :] <= i[:, None]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))[None, None]


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (reference ``vit.py:11-29``)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dtype="float32"):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, compute_dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v projections; self- or
    cross-attention (``kv``), additive ``bias`` and ``key_bias``;
    ``use_out_proj=False`` is the HF BERT layout, whose output dense lives in
    the next block.  ``q_bias``/``k_bias``/``v_bias`` give each projection a
    bias or none (VLMo's decomposed qkv bias: q and v, not k).  q, k and v
    come out in ``dtype``; the product + softmax path casts both terms to the
    scores' dtype (as the JAX einsum path does), the flash kernel takes them
    in float32 (as the JAX wrapper's ``_prepare`` makes its bias)."""

    def __init__(self, dim: int, num_heads: int, kv_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, use_out_proj: bool = True,
                 softmax_dtype="float32", q_bias: bool = True, k_bias: bool = True,
                 v_bias: bool = True, dtype="float32"):
        super().__init__()
        kv_dim = dim if kv_dim is None else kv_dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.softmax_dtype = resolve_dtype(softmax_dtype)
        self.query = Linear(dim, dim, bias=q_bias, compute_dtype=dtype)
        self.key = Linear(kv_dim, dim, bias=k_bias, compute_dtype=dtype)
        self.value = Linear(kv_dim, dim, bias=v_bias, compute_dtype=dtype)
        self.proj = Linear(dim, out_dim or dim, compute_dtype=dtype) if use_out_proj else None

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                key_bias: Optional[torch.Tensor] = None,
                attn_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``(s * scale + bias) + key_bias``, softmax, times v.  For a 0 /
        -1e9 ``key_bias`` this is the JAX sum ``s * scale + (bias +
        mask)`` after the softmax: the two differ only in masked columns,
        whose weights are 0 either way.

        ``attn_scale`` ``[B, H, Sq, Sk]``, the Grad-CAM probe, multiplies the
        probabilities after their cast back to the compute dtype: the
        gradient of a score with respect to it, at ones, is grad x
        attention (``utils/gradcam.py``).  A probe takes the product +
        softmax path under ``--attn flash`` too: the flash kernel forms no
        probabilities, so a probe there would get no gradient."""
        kv = x if kv is None else kv
        b, sq, _ = x.shape
        sk = kv.shape[1]
        h, dh = self.num_heads, self.head_dim
        # [B, S, H*Dh] -> [B, S, H, Dh] views, no copy
        q = self.query(x).view(b, sq, h, dh)
        k = self.key(kv).view(b, sk, h, dh)
        v = self.value(kv).view(b, sk, h, dh)
        if attention.get_impl() == "flash" and sq >= 128 and attn_scale is None:
            out = attention.flash_attention(q, k, v, bias, dh ** -0.5, key_bias)
        else:
            # [B, H, S, Dh]
            q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            attn = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
            if bias is not None:
                attn = attn + bias.to(attn.dtype)
            if key_bias is not None:
                attn = attn + key_bias.to(attn.dtype)[:, None, None, :]
            attn = torch.softmax(attn.to(self.softmax_dtype), dim=-1).to(q.dtype)
            if attn_scale is not None:
                attn = attn * attn_scale
            out = torch.matmul(attn, v).transpose(1, 2)
        out = out.reshape(b, sq, h * dh)
        return out if self.proj is None else self.proj(out)


class ResidualLayerNorm(nn.Module):
    """``(x + delta, LayerNorm(x + delta))`` with a LayerNorm's parameters.
    Runs the fused kernel on the card (``ops/fused_ln.py``) and its plain
    version on the CPU; ``delta=None`` is a plain LayerNorm.  Both outputs
    keep the stream's dtype, the trunk's compute dtype; the statistics are
    float32 either way."""

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
                 softmax_dtype="float32", dtype="float32"):
        super().__init__()
        self.fused_ln = fused_ln
        norm = (lambda: ResidualLayerNorm(dim, layer_norm_eps)) if fused_ln else (
            lambda: LayerNorm(dim, layer_norm_eps, dtype))
        self.norm1 = norm()
        self.attn = MultiHeadAttention(dim, num_heads, softmax_dtype=softmax_dtype, dtype=dtype)
        self.norm2 = norm()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

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

    def __init__(self, patch_size: int, in_chans: int, hidden_size: int, dtype="float32"):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, hidden_size, patch_size, stride=patch_size,
                           compute_dtype=dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        h, w = pixels.shape[-2:]
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(
                f"PatchEmbed: image {h}x{w} is not divisible by the patch size {p}"
            )
        return self.proj(pixels).flatten(2).transpose(1, 2)
