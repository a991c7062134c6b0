"""The folded map through which K3's float32 Hopper kernels read head dim 34.

A head of a ``[B, S, 544]`` projection starts 136 bytes after the last, off
the 16-byte strides a TMA map takes, so the kernels fold the heads into the
columns, one ``(H * 34, S, B)`` map, and read a head's rows as a 40-column
box.  A box starts on 16 bytes (TMA traps otherwise), so an odd head's box
starts 2 columns early, at ``34 h - 2``, and its columns are 2-35 of the
box; an even head's box starts at ``34 h``.  The columns past the head's 34
(the next head's, or TMA's zeros past column 544 for the last head) are
zeroed by the splitters before any product over the head dim.  What the
CPU can hold of that:

- the wrapper's map contract (``ops/attention.py::fits_folded_box``): the
  model's projection views, a fused-qkv view and a contiguous tensor are
  read in place; a view off 16 bytes and a head-transposed view are copied
  into packed rows and counted (``hd34_copy_launches``);
- the box read emulated on a ``[B, S, 544]`` tensor, from its 16-byte
  start: the kernel's 3xTF32 product (``mm_3xtf32``) over the head's
  40-column split tiles with columns 34-39 zeroed is the 34-wide product
  bit for bit, at even and odd heads; unzeroed, it is not.

Runs on the CPU in well under a second: no kernel, nothing of JAX.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from vqattack_tpu_torch.ops import attention

B, S, H, DH = 2, 37, 16, 34
WIDTH = H * DH  # 544


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _counter():
    return types.SimpleNamespace(hd34_copy_launches=0)


def _projections():
    """Views of three [B, S, 544] projections, as ``models/layers.py`` hands
    them over."""
    return [_randn(B, S, WIDTH, seed=i).view(B, S, H, DH) for i in range(3)]


def _fused():
    """q, k and v as views of one [B, S, 1632] fused projection."""
    qkv = _randn(B, S, 3 * WIDTH, seed=3)
    return [qkv[..., i * WIDTH:(i + 1) * WIDTH].view(B, S, H, DH) for i in range(3)]


@pytest.mark.parametrize("make", [
    _projections, _fused, lambda: [_randn(B, S, H, DH, seed=4)],
], ids=["projection_views", "fused_qkv_view", "contiguous"])
def test_read_in_place(make):
    for t in make():
        assert attention.fits_folded_box(t), t.stride()
        counted = _counter()
        assert attention.folded_or_copied(t, counted) is t
        assert counted.hd34_copy_launches == 0


def _off_by_one_float():
    buf = _randn(B, S, WIDTH + 1, seed=5)
    return buf[..., 1:].view(B, S, H, DH)  # the base 4 bytes off 16


def _head_transposed():
    return _randn(B, H, S, DH, seed=6).transpose(1, 2)  # head stride S * 34


@pytest.mark.parametrize("make", [_off_by_one_float, _head_transposed],
                         ids=["offset_by_one_float", "head_transposed"])
def test_copied_and_counted(make):
    t = make()
    assert not attention.fits_folded_box(t)
    counted = _counter()
    packed = attention.folded_or_copied(t, counted)
    assert counted.hd34_copy_launches == 1
    assert attention.fits_folded_box(packed) and packed.stride() == (S * WIDTH, WIDTH, DH, 1)
    assert torch.equal(packed, t)


def test_a_copy_rounds_odd_rows_up_to_16_bytes():
    t = _randn(B, S, 3, DH, seed=7)  # 3 heads: rows of 102 floats
    assert not attention.fits_folded_box(t)
    packed = attention.folded_or_copied(t, _counter())
    assert packed.stride() == (S * 104, 104, DH, 1) and torch.equal(packed, t)
    assert attention.fits_folded_box(packed)


def _box(x, h, zeroed):
    """Head h's 40 columns as the splitters see them: the 40-column box of
    ``x`` ``[B, S, 544]`` that TMA brings from column ``34 h - shift`` (zeros
    past column 544), read from column ``shift`` (2 for an odd head, 0 for
    an even one; nothing past the box), with columns 34-39 zeroed as the
    splitters zero them, or not."""
    shift = 2 * (h % 2)
    start = DH * h - shift
    assert start * 4 % 16 == 0  # a TMA box starts on 16 bytes
    box = torch.nn.functional.pad(x, (0, 40))[..., start:start + 40]
    tile = torch.nn.functional.pad(box, (0, shift))[..., shift:shift + 40].clone()
    if zeroed:
        tile[..., DH:] = 0
    return tile


@pytest.mark.parametrize("h", [0, 7, 8, H - 1])
def test_the_zeroed_box_gives_the_head_products_bit_for_bit(h):
    q, k = (_randn(B, S, WIDTH, seed=10 + i) for i in range(2))
    head = slice(DH * h, DH * (h + 1))
    want = attention.mm_3xtf32(q[..., head], k[..., head].transpose(-1, -2))
    got = attention.mm_3xtf32(_box(q, h, True), _box(k, h, True).transpose(-1, -2))
    assert torch.equal(got, want)
    if h < H - 1:  # unzeroed, the next head's columns add their products
        leaked = attention.mm_3xtf32(_box(q, h, False), _box(k, h, False).transpose(-1, -2))
        assert not torch.equal(leaked, want)
        assert float((leaked - want).abs().max()) > 1.0
    else:  # the last head's box past column 544 is TMA's zeros either way
        assert torch.equal(_box(q, h, False), _box(q, h, True))
