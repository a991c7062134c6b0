"""The folded map through which K3's Hopper kernels read head dim 34.

A head of a ``[B, S, 544]`` projection starts 136 bytes (68 in bf16) after
the last, off the 16-byte strides a TMA map takes, so the kernels fold the
heads into the columns, one ``(H * 34, S, B)`` map, and read a head's rows
as one box that starts on 16 bytes (TMA traps otherwise) at or before the
head's first column:

- float32 (``csrc/flash_attention_tf32.cu``): a 40-column box from ``34 h -
  2 (h % 2)``, the head at its columns 0-33 or 2-35; the columns past the
  head's 34 are zeroed by the splitters before any product over the head
  dim;
- bf16 (``csrc/flash_attention_bf16.cu``): a 64-column box from ``34 h -
  shift``, ``shift = 2 h mod 8``, the head at its columns ``shift .. shift +
  33``; the register A operand of every product over the head dim is zeroed
  outside them, the products run 3 k16 steps (columns 0-47), and a store
  writes accumulator column ``j`` to the head's column ``j - shift``.

What the CPU can hold of that:

- the wrapper's map contract (``ops/attention.py::fits_folded_box``) in
  both dtypes: the model's projection views, a fused-qkv view and a
  contiguous tensor are read in place; a view off 16 bytes and a
  head-transposed view are copied into packed rows and counted
  (``hd34_copy_launches``); bf16 rows of ``H * 34`` with H not a multiple of
  4 are off 16 bytes and copied into rows rounded up to 8 elements, the
  layout O comes back in (``packed_rows``, ``in_packed_rows``);
- the box reads emulated on a ``[B, S, 544]`` tensor, from its 16-byte
  start: float32, the kernel's 3xTF32 product (``mm_3xtf32``) over the
  head's 40-column split tiles with columns 34-39 zeroed is the 34-wide
  product bit for bit, at even and odd heads; bf16, the product over the
  box's first 48 columns with the A operand zeroed outside the head is the
  34-wide product (bit for bit in float64, where bf16 products sum
  exactly; within float32 rounding summed in the kernel's k16 steps), and
  unzeroed it is not; the stores put every head's columns in place and
  nothing else.

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
BF16 = torch.bfloat16


def _randn(*shape, seed=0, dtype=torch.float32):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return x.to(dtype)


def _counter():
    return types.SimpleNamespace(hd34_copy_launches=0)


def _projections(dtype=torch.float32):
    """Views of three [B, S, 544] projections, as ``models/layers.py`` hands
    them over."""
    return [_randn(B, S, WIDTH, seed=i, dtype=dtype).view(B, S, H, DH) for i in range(3)]


def _fused(dtype=torch.float32):
    """q, k and v as views of one [B, S, 1632] fused projection."""
    qkv = _randn(B, S, 3 * WIDTH, seed=3, dtype=dtype)
    return [qkv[..., i * WIDTH:(i + 1) * WIDTH].view(B, S, H, DH) for i in range(3)]


def _contiguous(dtype=torch.float32):
    return [_randn(B, S, H, DH, seed=4, dtype=dtype)]


IN_PLACE = {"projection_views": _projections, "fused_qkv_view": _fused,
            "contiguous": _contiguous}


@pytest.mark.parametrize("make,dtype", [(m, torch.float32) for m in IN_PLACE.values()]
                         + [(m, BF16) for m in IN_PLACE.values()],
                         ids=list(IN_PLACE) + [f"{n}-bf16" for n in IN_PLACE])
def test_read_in_place(make, dtype):
    for t in make(dtype):
        assert t.dtype == dtype
        assert attention.fits_folded_box(t), t.stride()
        counted = _counter()
        assert attention.folded_or_copied(t, counted) is t
        assert counted.hd34_copy_launches == 0


def _off_by_one_element(dtype=torch.float32):
    buf = _randn(B, S, WIDTH + 1, seed=5, dtype=dtype)
    return buf[..., 1:].view(B, S, H, DH)  # the base 4 (bf16: 2) bytes off 16


def _head_transposed(dtype=torch.float32):
    return _randn(B, H, S, DH, seed=6, dtype=dtype).transpose(1, 2)  # head stride S * 34


COPIED = {"offset_by_one_float": _off_by_one_element, "head_transposed": _head_transposed}


@pytest.mark.parametrize("make,dtype", [(m, torch.float32) for m in COPIED.values()]
                         + [(m, BF16) for m in COPIED.values()],
                         ids=list(COPIED) + [f"{n}-bf16" for n in COPIED])
def test_copied_and_counted(make, dtype):
    t = make(dtype)
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


@pytest.mark.parametrize("h,row", [(2, 72), (3, 104), (16, 544)])
def test_bf16_rows_of_any_head_count(h, row):
    """bf16 rows of ``h`` heads: the projection views fit the folded map
    where ``h * 34`` is a multiple of 8 (H a multiple of 4), else they are
    copied into rows of ``row`` elements, counted; O comes back in such rows
    (``packed_rows``), and dO in another layout is copied there, counted
    (``in_packed_rows``): any head count runs."""
    assert attention.folded_row(h, BF16) == row
    q = _randn(B, S, h * DH, seed=8, dtype=BF16).view(B, S, h, DH)
    counted = _counter()
    read = attention.folded_or_copied(q, counted)
    assert counted.hd34_copy_launches == (row != h * DH)
    assert torch.equal(read, q) and attention.fits_folded_box(read)
    assert read.stride() == (S * row, row, DH, 1)
    o = attention.packed_rows(B, S, h, DH, BF16, "cpu")
    assert o.shape == (B, S, h, DH) and o.stride() == (S * row, row, DH, 1)
    assert o.data_ptr() % 16 == 0 and attention.fits_folded_box(o)
    assert attention.in_packed_rows(o, counted) is o
    copies = counted.hd34_copy_launches
    do = _randn(B, S, h, DH, seed=9, dtype=BF16)  # contiguous, as autograd hands it over
    got = attention.in_packed_rows(do, counted)
    assert (got is do) == (row == h * DH) and torch.equal(got, do)
    assert got.stride() == (S * row, row, DH, 1)
    assert counted.hd34_copy_launches == copies + (row != h * DH)


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


BF16_HEADS = [0, 1, 2, 3, 7, H - 1]


def _bf16_box(x, h):
    """Head h's bf16 box as TMA brings it into the tile: the 64 columns of
    ``x`` ``[B, S, 544]`` from column ``34 h - shift`` (zeros past column
    544), and ``shift = 2 h mod 8``, where the head starts in it."""
    shift = (2 * h) % 8
    start = DH * h - shift
    assert start * 2 % 16 == 0  # a TMA box starts on 16 bytes
    return torch.nn.functional.pad(x, (0, 64))[..., start:start + 64], shift


def _zeroed(box, shift):
    """The register A operand as ``load_head`` leaves it: 0 outside the
    head's columns ``[shift, shift + 34)``."""
    a = box.clone()
    a[..., :shift] = 0
    a[..., shift + DH:] = 0
    return a


def _k16_product(a, b, dtype):
    """``a b^T`` over the box's first 48 columns as the kernel runs it: 3
    k16 steps of exact bf16 products, the steps summed in order in
    ``dtype``."""
    acc = 0
    for kk in range(3):
        cols = slice(16 * kk, 16 * (kk + 1))
        acc = acc + a[..., cols].to(dtype) @ b[..., cols].to(dtype).transpose(-1, -2)
    return acc


@pytest.mark.parametrize("h", BF16_HEADS)
def test_the_bf16_box_with_a_zeroed_operand_gives_the_head_products(h):
    """S = Q K^T over the 48 columns of 3 k16 steps, the A operand (Q) zeroed
    outside the head and the B operand (K) the box as it arrives, the
    neighbours' columns in it: the 34-wide product, bit for bit in float64
    (bf16 products sum exactly there) and within float32 rounding (2^-20 of
    the largest magnitude) in the kernel's float32 order.  With A unzeroed,
    a neighbour's columns add their products (at the last head, the ones of
    the head before)."""
    q, k = (_randn(B, S, WIDTH, seed=20 + i, dtype=BF16) for i in range(2))
    head = slice(DH * h, DH * (h + 1))
    qb, shift = _bf16_box(q, h)
    kb, _ = _bf16_box(k, h)
    assert torch.equal(qb[..., shift:shift + DH], q[..., head]) and shift + DH <= 40
    want = q[..., head].double() @ k[..., head].double().transpose(-1, -2)
    assert torch.equal(_k16_product(_zeroed(qb, shift), kb, torch.float64), want)
    got32 = _k16_product(_zeroed(qb, shift), kb, torch.float32)
    assert float((got32.double() - want).abs().max()) <= 2 ** -20 * float(want.abs().max())
    leaked = _k16_product(qb, kb, torch.float64)
    assert float((leaked - want).abs().max()) > 1.0
    if h == H - 1:  # the last head's box runs past column 544: TMA's zeros there
        assert not qb[..., shift + DH:].any()


@pytest.mark.parametrize("h", BF16_HEADS)
def test_the_bf16_box_gives_the_head_outputs_and_d(h):
    """The products whose output is the head dim (O = P V, dQ = dS K, ...)
    at wgmma N = 40 over the box's columns 0-39 hold the head's outputs in
    accumulator columns ``shift .. shift + 33``; and D = rowsum(dO o O) over
    the 48 columns, dO zeroed outside the head and O the box as it arrives,
    is the head's, bit for bit in float64."""
    p = _randn(B, S, S, seed=30, dtype=BF16)
    v, do, o = (_randn(B, S, WIDTH, seed=31 + i, dtype=BF16) for i in range(3))
    head = slice(DH * h, DH * (h + 1))
    vb, shift = _bf16_box(v, h)
    acc = p.double() @ vb[..., :40].double()
    assert torch.equal(acc[..., shift:shift + DH], p.double() @ v[..., head].double())
    dob, _ = _bf16_box(do, h)
    ob, _ = _bf16_box(o, h)
    d = (_zeroed(dob, shift)[..., :48].double() * ob[..., :48].double()).sum(-1)
    assert torch.equal(d, (do[..., head].double() * o[..., head].double()).sum(-1))


def test_the_bf16_stores_put_every_head_in_place():
    """``store_rows`` at head dim 34: each head's accumulator (N = 40
    columns, the head at ``shift .. shift + 33``) written pair by pair
    (bf16x2: columns 8 j + 2 c and + 1) to column ``34 h + j - shift`` for
    ``j`` in the head only, into a packed [B, S, 544] output that starts as
    NaN: every column written once, each head's own values, every pair on
    4 bytes."""
    x = _randn(B, S, WIDTH, seed=40, dtype=BF16)
    out = torch.full((B, S, WIDTH), float("nan"), dtype=BF16)
    writes = torch.zeros(WIDTH, dtype=torch.int64)
    for h in range(H):
        acc, shift = _bf16_box(x, h)
        acc = acc[..., :40]
        for j in range(0, 40, 2):  # the pairs of accumulator columns
            if shift <= j < shift + DH:
                col = DH * h + j - shift
                assert col * 2 % 4 == 0
                out[..., col:col + 2] = acc[..., j:j + 2]
                writes[col:col + 2] += 1
    assert torch.equal(out, x) and bool((writes == 1).all())
