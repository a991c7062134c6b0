"""Attention backend selection and flash attention: kernel K3.

Port of ``vqattack_tpu/ops/attention.py``.  The backend is a process-wide
choice with the JAX package's values, so the CLI's ``--attn`` carries over:

- ``"xla"`` (default): the explicit product + softmax of
  ``models/layers.py::MultiHeadAttention``;
- ``"flash"``: :func:`flash_attention`, taken by ``MultiHeadAttention`` for
  sequences of at least 128 queries (the ViT's 901 tokens).

:func:`flash_attention` takes the JAX layout ``[B, S, H, Dh]`` and returns
``[B, Sq, H, Dh]``.  On a CUDA tensor it runs the kernels behind
``csrc/flash_attention.cu``'s entry points in a ``torch.autograd.Function``
(forward, and the backward from the saved row statistics): in float32 the
Hopper kernels of ``csrc/flash_attention_tf32.cu`` (tf32 ``wgmma`` and TMA)
at both head dims, and for the bias gradient's dQ pass that file's
``mma.sync`` kernel (:func:`k3_route` names the instance a call takes); on
a CPU tensor it runs the plain version under autograd.  There is no
sequence padding and no dense bias: the kernel masks ragged lengths itself,
reads ``bias`` through broadcast strides
and ``key_bias``, a second term with one value a key (VLMo's padded-text
mask beside its relative-position table), as a vector.  The plain versions
are also the kernels' oracles on the card: :func:`flash_attention_bwd_reference`
is the backward written from the saved statistics exactly as the kernel
computes it.  The kernel runs its products
on the tensor cores in three TF32 passes; :func:`mm_3xtf32` emulates that
arithmetic on the CPU for the tests.

The kernels take head dims 34 (VLMo-base+: 544 over 16 heads) and 64
(ALBEF's ViT, VLMo-base and -large).  q/k/v at head dim 34 are read in
place, as views of the model's projections, like those at 64, in both
dtypes: the heads folded into the columns of one TMA map, a box a head from
a column on 16 bytes (40 float32 columns, 64 bf16 ones; :func:`fits_folded_box`
says which tensors it takes; the wrapper copies the others into packed rows
and counts the copies, :func:`folded_or_copied`).  O comes back packed, in
rows of ``H * 34`` rounded up to 16 bytes (:func:`folded_row`), which the
backward reads O and dO in; the gradients come back contiguous.

The forward saves each query row's softmax statistics for the backward,
the row maximum ``m`` and ``log l`` apart (``[2, B, H, Sq]`` float32), as
the library kernel saves m and l, and the backward forms ``P = exp((S - m)
- log l)``.  A row whose every key carries a finite -1e9 has ``m`` near
-1e9, where ``m + log l`` rounds back to ``m`` (the float32 ulp there is
64), so a single saved ``L = m + log l`` would give ``exp(S - L) = 1`` for
every key, not ``1 / Sk``.  The bf16 instances without a term form ``L``
once as they load the row and keep their fused exponent ``S log2 e - L
log2 e``: their maximum is a product's and never nears -1e9.

The float32 kernels also give the bias its gradient (dbias, the library
backward's ``dab``): where the bias needs one, as VLMo's relative-position
table does in training, the dQ kernel's dbias instance sums dS, the
gradient of the post-scale score, over the batch inside the kernel for a
bias broadcast over B: a thread-block cluster of up to 8 blocks adds its
batch rows' dS tiles in a fixed order through distributed shared memory
(:func:`dbias_plan` says how many blocks a cluster and how many clusters a
tile; no ``[B, H, Sq, Sk]`` buffer).  A broadcast over H or Sq is summed
here over the kernel's output.  The bfloat16 instance and the key bias take
no gradient.

q/k/v may be float32 or bfloat16 (the three alike; the surrogate trunk's
compute dtype).  The bfloat16 instance (``csrc/flash_attention_bf16.cu``)
multiplies bf16 operands once with float32 accumulation and returns O and
the gradients in bf16; ``bias`` and ``key_bias`` stay float32, as the JAX
wrapper's ``_prepare`` makes its bias.  Its plain version rounds where the
library kernel rounds (P before P V and P^T dO, dS before dS K and dS^T Q)
and computes everything else in float32 from the bf16 inputs.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from vqattack_tpu_torch.ops import _build

HEAD_DIMS = (34, 64)  # the head widths the kernels take: VLMo-base+'s; ALBEF's and VLMo's

_IMPL = "xla"
_KINDS = ("xla", "flash")


def get_impl() -> str:
    return _IMPL


def set_impl(kind: str) -> None:
    """Process-wide backend choice (the CLI ``--attn`` flag); prefer the
    :func:`attention_impl` context in library code."""
    global _IMPL
    if kind not in _KINDS:
        raise ValueError(f"unknown attention backend {kind!r}; use one of {_KINDS}")
    _IMPL = kind


@contextlib.contextmanager
def attention_impl(kind: str):
    """``with attention_impl("flash"): ...`` selects the backend inside."""
    prev = get_impl()
    set_impl(kind)
    try:
        yield
    finally:
        set_impl(prev)


# ---------------------------------------------------------------------------
# the bias gradient's sum over the batch
# ---------------------------------------------------------------------------

DBIAS_CLUSTER = 8  # blocks a cluster at most: the portable maximum


class DbiasPlan(NamedTuple):
    """How the dbias instance sums dS over the batch: ``cluster`` blocks a
    thread-block cluster (batch rows summed together, in rank order),
    ``groups`` clusters along the batch (partial sums added in order), and
    the ``[groups, H, Sq, Sk]`` buffer of those partial sums where there is
    more than one (None: the kernel writes the gradient itself)."""

    cluster: int
    groups: int
    scratch_shape: Optional[Tuple[int, int, int, int]]


def dbias_plan(dims, bias_shape) -> DbiasPlan:
    """The plan for ``dims = (B, H, Sq, Sk)`` and a bias of ``bias_shape``
    (``[1|B, 1|H, 1|Sq, Sk]``), the rule ``csrc/flash_attention.cu``'s
    ``vq_flash_attention_bwd`` applies: a bias broadcast over B > 1 is
    summed over B by clusters of ``min(B, 8)`` blocks, ``ceil(B / 8)`` of
    them, batch row ``g * cluster + rank`` in rank ``rank`` of cluster
    ``g``; any other bias takes clusters of one block, one a batch row, and
    no sum."""
    b, h, sq, sk = dims
    if bias_shape[0] != 1 or b == 1:
        return DbiasPlan(1, b, None)
    cluster = min(b, DBIAS_CLUSTER)
    groups = -(-b // cluster)
    return DbiasPlan(cluster, groups, (groups, h, sq, sk) if groups > 1 else None)


def planned_batch_sum(ds: torch.Tensor, plan: DbiasPlan) -> torch.Tensor:
    """``ds [B, H, Sq, Sk]`` summed over B in ``plan``'s order, as the kernel
    sums it: within each cluster its batch rows in rank order, then the
    clusters' sums in order, both left to right (the padding past B adds
    nothing); ``ds`` itself where the plan sums nothing."""
    if plan.cluster == 1:
        return ds
    total = None
    for g in range(plan.groups):
        part = None
        for b in range(g * plan.cluster, min((g + 1) * plan.cluster, ds.shape[0])):
            part = ds[b:b + 1] if part is None else part + ds[b:b + 1]
        total = part if total is None else total + part
    return total


def dbias_buffers(dims, bias_shape, device):
    """``(buffer, gradient)``: the float32 buffer the kernel writes and the
    gradient in it, ``[1|B, H, Sq, Sk]`` (the bias's batch dimension, full H
    and Sq): with partial sums (:func:`dbias_plan`), the ``[groups, H, Sq,
    Sk]`` scratch and its plane 0, where the kernel's last pass adds them;
    else one tensor, both."""
    b, h, sq, sk = dims
    plan = dbias_plan(dims, bias_shape)
    if plan.scratch_shape is not None:
        scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=device)
        return scratch, scratch[:1]
    grad = torch.empty((bias_shape[0], h, sq, sk), dtype=torch.float32, device=device)
    return grad, grad


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _key_bias_2d(key_bias):
    """A ``[1|B, Sk]`` or ``[1|B, 1, 1, Sk]`` key bias as ``[1|B, Sk]``."""
    if key_bias is not None and key_bias.dim() == 4 and key_bias.shape[1:3] == (1, 1):
        return key_bias[:, 0, 0]
    return key_bias


def _scores(q, k, bias, scale, key_bias=None):
    """``[B, H, Sq, Sk]`` scores ``((q * scale) k^T + bias) + key_bias``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if bias is not None:
        s = s + bias.to(s.dtype)
    key_bias = _key_bias_2d(key_bias)
    return s if key_bias is None else s + key_bias.to(s.dtype)[:, None, None, :]


def _round(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to ``like``'s dtype and read back as float32:
    where the bf16 kernel casts a float32 product to an operand (nothing for
    float32)."""
    return x.to(like.dtype).float()


def _reference_bf16(q, k, v, bias, scale, return_lse, key_bias):
    """The bfloat16 kernel's forward in plain PyTorch: scores and row sums in
    float32 from the bf16 inputs, ``P = exp(S - max)`` rounded to bf16 before
    P V (the library's ``p.astype(v.dtype)``), the output divided by the
    float32 row sum and rounded to bf16."""
    s = _scores(q.float(), k.float(), bias, scale, key_bias)
    m = s.amax(-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(-1)  # [B, H, Sq]
    out = torch.einsum("bhqk,bkhd->bqhd", _round(p, v), v.float())
    out = (out / l.transpose(1, 2)[..., None]).to(q.dtype)
    if return_lse:
        return out, torch.stack([m[..., 0], torch.log(l)])
    return out


def flash_attention_reference(q, k, v, bias, scale, return_lse: bool = False,
                              key_bias=None):
    """``softmax((q * scale) k^T + bias + key_bias) v`` by the explicit
    product, in the ``[B, S, H, Dh]`` layout; with ``return_lse`` also the
    rows' statistics that the kernel saves: their maxima and the logs of
    their sums, ``[2, B, H, Sq]``.  bf16 q/k/v take the bf16 kernel's
    arithmetic (:func:`_reference_bf16`)."""
    if q.dtype == torch.bfloat16:
        return _reference_bf16(q, k, v, bias, scale, return_lse, key_bias)
    s = _scores(q, k, bias, scale, key_bias)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    if not return_lse:
        return out
    m = s.amax(-1)
    return out, torch.stack([m, torch.log(torch.exp(s - m[..., None]).sum(-1))])


def flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do, key_bias=None,
                                  dbias: bool = False):
    """The kernel's backward in plain PyTorch: ``(dq, dk, dv)`` from the
    forward output ``o``, its row statistics ``lse`` (m and log l) and the
    output gradient ``do``, with ``P = exp((S - m) - log l)`` recomputed
    (both additive terms) and ``D = rowsum(do * o)``.  With ``dbias`` also
    the bias's gradient, dS summed over the bias's broadcast dimensions, in
    the bias's shape, as a fourth output (for bf16 q/k/v dS before its
    rounding), over B in the kernel's order (:func:`planned_batch_sum`).
    For bf16 q/k/v everything is float32 from the bf16 inputs
    but P and dS, rounded to bf16 as the kernel (and the library kernel)
    hands them to the next product, and the gradients come back bf16; scale is applied after dS's
    rounding, as the kernel applies it (the same bits as before it for a
    power of two, 1/8 at head dim 64; at head dim 34 the two orders differ
    by a rounding)."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = _scores(qf, kf, bias, scale, key_bias)
    p = torch.exp((s - lse[0][..., None]) - lse[1][..., None])
    d = (dof * of).sum(-1).transpose(1, 2)  # [B, H, Sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, q), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds_f = p * (dp - d[..., None])
    ds = _round(ds_f, q)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    grads = dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
    if dbias:
        if bias is None:
            raise ValueError("flash_attention_bwd_reference: dbias without a bias")
        plan = dbias_plan(tuple(ds_f.shape), tuple(bias.shape))
        return grads + (planned_batch_sum(ds_f, plan).sum_to_size(bias.shape),)
    return grads


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``'s rounding, by the two integer operations
    the kernel uses.  Used by the tests only (:func:`mm_3xtf32`)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    # sign and magnitude: adding half of the dropped 13 bits' unit to the
    # magnitude, then truncating, rounds a tie away from zero
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` cut to TF32 (its top 19 bits), as the tensor cores read
    an operand.  Used by the tests only (:func:`mm_3xtf32`)."""
    return (x.to(torch.float32).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's tensor cores compute it, for the tests only:
    each operand split as ``hi = tf32_round(x)`` and ``lo = x - hi``, which
    the tensor cores read truncated to TF32, and ``a_lo b_hi + a_hi b_lo``
    then ``+ a_hi b_hi`` summed in float32 (``lo lo`` dropped)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


FOLDED_HEAD_DIM = 34  # q/k/v read through the folded map (a box a head)


def folded_row(h: int, dtype: torch.dtype, head_dim: int = FOLDED_HEAD_DIM) -> int:
    """Elements in a row of ``h`` packed heads of ``head_dim`` rounded up to
    16 bytes (a TMA stride): the rows of O, of the dO the backward reads and
    of a copy :func:`folded_or_copied` makes."""
    chunk = 128 // torch.finfo(dtype).bits
    return -(-h * head_dim // chunk) * chunk


def fits_folded_box(t: torch.Tensor) -> bool:
    """Whether the Hopper kernels read ``t`` (``[B, S, H, 34]``, float32 or
    bf16) in place: their TMA map folds the heads into the columns, ``(H *
    34, S, B)`` over ``t``'s row and batch strides, and reads a head's rows
    as one box from a column on 16 bytes at or before the head's first
    (float32: 40 columns from ``34 h - 2 (h % 2)``; bf16: 64 columns from
    ``34 h - (2 h mod 8)``).  So the heads must be packed (head stride 34,
    the head dim contiguous), the row and batch strides multiples of 16
    bytes (4 floats, 8 bf16) and the base on 16 bytes; a dimension of
    extent 1 is never stepped, so its stride is free.  The views of the
    model's ``[B, S, 544]`` projections, of a fused ``[B, S, 1632]`` one and
    a contiguous ``[B, S, 16, 34]`` qualify; bf16 rows of ``H * 34`` with H
    not a multiple of 4 do not."""
    b, s, h, d = t.shape
    sb, ss, sh, sd = t.stride()
    chunk = 16 // t.element_size()
    return ((d == 1 or sd == 1) and (h == 1 or sh == d) and (s == 1 or ss % chunk == 0)
            and (b == 1 or sb % chunk == 0) and t.data_ptr() % 16 == 0)


def folded_or_copied(t: torch.Tensor, counted) -> torch.Tensor:
    """``t`` (``[B, S, H, 34]``) where :func:`fits_folded_box` takes it, else
    a copy that it takes (:func:`packed_rows`), counted in
    ``counted.hd34_copy_launches``."""
    if fits_folded_box(t):
        return t
    counted.hd34_copy_launches += 1
    return packed_rows(*t.shape, t.dtype, t.device).copy_(t)


def packed_rows(b: int, s: int, h: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An empty ``[b, s, h, d]`` with packed heads in rows of
    :func:`folded_row` elements, on 16 bytes: the layout O comes back in,
    contiguous where ``h * d`` fills the rows."""
    row = folded_row(h, dtype, d)
    if row == h * d:
        return torch.empty((b, s, h, d), dtype=dtype, device=device)
    return torch.empty((b, s, row), dtype=dtype, device=device)[..., :h * d].view(b, s, h, d)


def in_packed_rows(t: torch.Tensor, counted) -> torch.Tensor:
    """``t`` (O, or dO, ``[B, S, H, Dh]``) where it lies as
    :func:`packed_rows` lays it out, the backward's TMA maps read it so;
    else such a copy, at head dim 34 counted in
    ``counted.hd34_copy_launches``."""
    b, s, h, d = t.shape
    row = folded_row(h, t.dtype, d)
    want = (s * row, row, d, 1)
    if t.data_ptr() % 16 == 0 and all(n == 1 or st == w
                                      for n, st, w in zip(t.shape, t.stride(), want)):
        return t
    if d == FOLDED_HEAD_DIM:
        counted.hd34_copy_launches += 1
    return packed_rows(b, s, h, d, t.dtype, t.device).copy_(t)


def check_gradients(dtype: torch.dtype, bias, key_bias) -> None:
    """Raise on a term whose gradient no kernel gives: a bias that needs
    one with other than float32 q/k/v (the bf16 instance has no dbias), or
    a key bias that needs one."""
    if bias is not None and bias.requires_grad and dtype != torch.float32:
        raise ValueError(f"flash_attention kernel: a bias that needs a gradient takes float32 "
                         f"q/k/v; the {dtype} instance has no dbias (not ported yet)")
    if key_bias is not None and key_bias.requires_grad:
        raise ValueError("flash_attention kernel: the key bias has no gradient")


def _check_inputs(q, k, v, bias, key_bias=None) -> Tuple[int, int, int, int]:
    """``(B, H, Sq, Sk)`` after checking what the kernel takes."""
    check_gradients(q.dtype, bias, key_bias)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} on {t.device}, expected cuda")
        if t.dtype not in _ENTRY_POINTS:
            raise TypeError(f"flash_attention kernel: {name} is {t.dtype}; takes float32 "
                            f"or bfloat16")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: {name} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4 or t.shape[-1] not in HEAD_DIMS or t.shape[-1] != q.shape[-1]:
            raise ValueError(f"flash_attention kernel: {name} {tuple(t.shape)}; takes "
                             f"[B, S, H, Dh] with Dh one of {HEAD_DIMS}, alike for q, k, v")
        if t.shape[-1] == FOLDED_HEAD_DIM:
            continue  # read in place where it fits, else copied, whatever its layout
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s head dim is not contiguous")
        # TMA maps take a base and strides on 16 bytes
        chunk = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % chunk for st, n in zip(t.stride()[:3], t.shape)
                                    if n > 1):
            raise ValueError(f"flash_attention kernel: {name}'s rows do not start on 16 "
                             f"bytes (data pointer {t.data_ptr()}, strides {t.stride()}); the "
                             f"b, s and h strides must be multiples of {chunk}")
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    if q.dtype == torch.float32 and dh == FOLDED_HEAD_DIM and h * dh % 4:
        raise ValueError(f"flash_attention kernel: {h} heads of 34 floats; the float32 kernels "
                         f"read dO's [B, Sq, H * 34] rows by TMA, which takes strides of 16 "
                         f"bytes: H must be even")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.device != q.device:
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if sq == 0 or sk == 0:
        raise ValueError("flash_attention kernel: empty sequence")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel: bias {bias.dtype} on {bias.device}; "
                            f"takes float32 on {q.device}")
        if bias.dim() != 4 or any(n not in (1, full) for n, full in
                                  zip(bias.shape, (b, h, sq, sk))) or bias.shape[3] != sk:
            raise ValueError(f"flash_attention kernel: bias {tuple(bias.shape)} does not "
                             f"broadcast as [1|B, 1|H, 1|Sq, Sk] to {(b, h, sq, sk)}")
    if key_bias is not None:
        if key_bias.device != q.device or key_bias.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel: key_bias {key_bias.dtype} on "
                            f"{key_bias.device}; takes float32 on {q.device}")
        kb = _key_bias_2d(key_bias)
        if kb.dim() != 2 or kb.shape[0] not in (1, b) or kb.shape[1] != sk:
            raise ValueError(f"flash_attention kernel: key_bias {tuple(key_bias.shape)} is "
                             f"not [1|B, Sk] or [1|B, 1, 1, Sk] for B={b}, Sk={sk}")
        if sk > 1 and kb.stride(1) != 1:
            raise ValueError("flash_attention kernel: key_bias is not contiguous along Sk")
    return b, h, sq, sk


def _common_args(q, k, v, bias, key_bias, b, h, sq, sk):
    """Pointers, sizes and element strides of the C entry points."""
    if bias is None:
        bias_ptr, bias_strides = None, (0, 0, 0, 0)
    else:
        bias_ptr = bias.data_ptr()
        # a broadcast dimension reads with stride 0
        bias_strides = bias.expand(b, h, sq, sk).stride()
    kb = _key_bias_2d(key_bias)
    if kb is None:
        kb_ptr, kb_stride = None, 0
    else:
        kb_ptr, kb_stride = kb.data_ptr(), kb.expand(b, sk).stride(0)
    strides = []
    for t in (q, k, v):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, kb_ptr],
            [b, h, sq, sk, q.shape[-1], *strides, *bias_strides, kb_stride])


def _folded(q, k, v, head_dim, counted):
    """q, k, v as the kernels read them at head dim 34
    (:func:`folded_or_copied`, copies counted on ``counted``); as they are
    at 64."""
    if head_dim != FOLDED_HEAD_DIM:
        return q, k, v
    return tuple(folded_or_copied(t, counted) for t in (q, k, v))


def _launch_fwd(q, k, v, bias, scale, key_bias, dims, head_dim):
    """The forward kernel on checked q/k/v (at head dim 34 copied where the
    folded map does not take them, :func:`folded_or_copied`): ``(o, lse)``,
    o ``[B, Sq, H, Dh]`` in :func:`packed_rows`, lse the row statistics
    ``[2, B, H, Sq]``."""
    b, h, sq, sk = dims
    q, k, v = _folded(q, k, v, head_dim, flash_attention_fwd)
    ptrs, sizes = _common_args(q, k, v, bias, key_bias, b, h, sq, sk)
    out = packed_rows(b, sq, h, head_dim, q.dtype, q.device)
    lse = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        status = getattr(lib, _ENTRY_POINTS[q.dtype] + "fwd")(
            *ptrs, out.data_ptr(), lse.data_ptr(), *sizes, scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "flash_attention_fwd")
    _build.count_launch(flash_attention_fwd, *_counts(q.dtype, key_bias, head_dim))
    return out, lse


def _launch_bwd(q, k, v, bias, scale, o, lse, do, key_bias, dims, head_dim, dbias=False):
    """The backward kernels on tensors as :func:`_launch_fwd` takes them, o
    and do laid out as it returns o (else copied, :func:`in_packed_rows`):
    ``(dq, dk, dv)`` contiguous, and with ``dbias`` (float32, a bias given)
    also the bias's gradient summed over B where the bias broadcasts over
    it, ``[1|B, H, Sq, Sk]`` float32 (:func:`dbias_buffers`)."""
    b, h, sq, sk = dims
    q, k, v = _folded(q, k, v, head_dim, flash_attention_bwd)
    for name, t, shape, dtype in (("o", o, (b, sq, h, head_dim), q.dtype),
                                  ("grad of o", do, (b, sq, h, head_dim), q.dtype),
                                  ("lse", lse, (2, b, h, sq), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or (name == "lse"
                                                           and not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype}; "
                             f"takes {dtype} {shape}")
    o, do = (in_packed_rows(t, flash_attention_bwd) for t in (o, do))
    if dbias and (bias is None or q.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: dbias takes a bias and float32 q/k/v "
                         f"(bias {'absent' if bias is None else 'given'}, q {q.dtype})")
    if dbias and bias.shape[0] == b > 1 and bias.stride(0) == 0:
        # one gradient a batch row: the kernel reads batch stride 0 as a
        # broadcast over B, which it sums over
        bias = bias.contiguous()
    ptrs, sizes = _common_args(q, k, v, bias, key_bias, b, h, sq, sk)
    dq = torch.empty((b, sq, h, head_dim), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, head_dim), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    buf = grad = None
    if dbias:
        buf, grad = dbias_buffers(dims, tuple(bias.shape), q.device)
    # the float32 entry point takes dbias's pointer (null: no dbias), the bf16 one none
    ds_arg = () if q.dtype == torch.bfloat16 else (None if buf is None else buf.data_ptr(),)
    lib = _build.load()
    with torch.cuda.device(q.device):
        status = getattr(lib, _ENTRY_POINTS[q.dtype] + "bwd")(
            *ptrs, o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), *ds_arg, *sizes, scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(status, "flash_attention_bwd")
    _build.count_launch(flash_attention_bwd, *_counts(q.dtype, key_bias, head_dim, dbias),
                        *(("dbias_launches",) if dbias else ()))
    return (dq, dk, dv) if grad is None else (dq, dk, dv, grad)


def flash_attention_fwd(q, k, v, bias, scale: float, key_bias=None):
    """Forward kernel: ``(o [B, Sq, H, Dh] in q's dtype, lse [2, B, H, Sq]
    float32)``, lse the rows' maxima and the logs of their sums; o in
    :func:`packed_rows`, as :func:`flash_attention_bwd` reads it."""
    dims = _check_inputs(q, k, v, bias, key_bias)
    return _launch_fwd(q, k, v, bias, scale, key_bias, dims, q.shape[-1])


def flash_attention_bwd(q, k, v, bias, scale: float, o, lse, do, key_bias=None,
                        dbias: bool = False):
    """Backward kernels (the D pass, dK/dV over key tiles, dQ over query
    tiles): ``(dq, dk, dv)`` contiguous, in the shapes and dtype of ``q``,
    ``k``, ``v``; ``o`` and ``do`` in that dtype, copied where they do not
    lie as :func:`flash_attention_fwd` returns o (:func:`in_packed_rows`),
    ``lse`` the forward's statistics.  With
    ``dbias`` (float32 q/k/v and a bias) the dQ kernel's dbias instance
    runs and the bias's gradient, dS summed over the bias's broadcast
    dimensions (over B inside the kernel, :func:`dbias_plan`), comes back
    fourth, in the bias's shape.  The same bit for bit on every run: no
    atomics."""
    dims = _check_inputs(q, k, v, bias, key_bias)
    grads = _launch_bwd(q, k, v, bias, scale, o, lse, do, key_bias, dims, q.shape[-1], dbias)
    return grads[:3] + (grads[3].sum_to_size(bias.shape),) if dbias else grads


def dbias_max_clusters(head_dim: int, key_bias: bool, cluster: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the dbias instance at
    ``head_dim`` (with a key bias or not) in clusters of ``cluster`` blocks:
    how many the card holds at once (0: the launch is refused)."""
    n = _build.load().vq_flash_attention_dbias_clusters(head_dim, int(key_bias), cluster)
    if n < 0:
        raise RuntimeError(f"dbias_max_clusters: CUDA error {-n}")
    return n


# the C entry points (``<prefix>fwd``, ``<prefix>bwd``) of each q/k/v dtype
_ENTRY_POINTS = {torch.float32: "vq_flash_attention_",
                 torch.bfloat16: "vq_flash_attention_bf16_"}


# The instances of K3, by the rule the entry points apply (k3_route)
K3_ROUTES = {
    # float32 at head dim 64 or 34 (a 40-column box of the folded map):
    # csrc/flash_attention_tf32.cu (wgmma, TMA)
    "tf32_wgmma": "vqattack_tpu_torch/csrc/flash_attention_tf32.cu",
    # float32 with dbias, at either head dim: csrc/flash_attention.cu's dQ
    # kernel with the cluster sum (its entry points launch it), the forward
    # and dK/dV kernels of csrc/flash_attention_tf32.cu
    "tf32_wgmma_dbias": "vqattack_tpu_torch/csrc/flash_attention.cu",
    # bfloat16 at either head dim (34 through the folded map: a 64-column
    # box a head, 48 columns executed over the head dim, 40 into it): wgmma,
    # TMA, no dbias
    "bf16_wgmma": "vqattack_tpu_torch/csrc/flash_attention_bf16.cu",
}


def k3_route(dtype: torch.dtype, head_dim: int, dbias: bool = False) -> str:
    """The K3 instance a call on ``dtype`` q/k/v at ``head_dim`` takes
    (``dbias``: a backward that also gives the bias its gradient), a key of
    :data:`K3_ROUTES`: float32 runs the Hopper kernels at both head dims (at
    34 through the folded map, :func:`fits_folded_box`), with dbias beside
    the ``mma.sync`` dQ kernel; bfloat16 its own kernels at both head dims
    (at 34 through the folded map too).  Raises for what no instance
    takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"k3_route: head dim {head_dim}; the kernels take {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        if dbias:
            raise ValueError("k3_route: the bf16 instance has no dbias")
        return "bf16_wgmma"
    if dtype != torch.float32:
        raise TypeError(f"k3_route: {dtype}; the kernels take float32 or bfloat16")
    return "tf32_wgmma_dbias" if dbias else "tf32_wgmma"


def _counts(dtype, key_bias, head_dim, dbias=False):
    """The counts a launch adds one to: each dtype's instances apart, those
    with a key bias (VLMo's attention) also apart, those at head dim 34
    (VLMo-base+'s) also apart, and the float32 calls that run the Hopper
    kernels (``tf32_wgmma_launches``: :func:`k3_route`, every float32 call)
    also apart."""
    prefix = "bf16_" if dtype == torch.bfloat16 else ""
    tf32 = k3_route(dtype, head_dim, dbias).startswith("tf32_wgmma")
    return ((prefix + "launches",)
            + ((prefix + "key_bias_launches",) if key_bias is not None else ())
            + ((prefix + "hd34_launches",) if head_dim == 34 else ())
            + (("tf32_wgmma_launches",) if tf32 else ()))


# calls of each entry point in this process: float32 (``launches``) and
# bfloat16 (``bf16_launches``) instances, and those of each with a key bias
# and at head dim 34, and the float32 calls of the Hopper kernels; the
# backward's with dbias also apart; and the tensors at head dim 34 (q/k/v,
# and the backward's o and do, in either dtype) copied into packed rows on
# the way to each (``hd34_copy_launches``, one a tensor): plain counts for
# chip_smoke.py
for _fn in (flash_attention_fwd, flash_attention_bwd):
    for _name in ("launches", "key_bias_launches", "hd34_launches", "bf16_launches",
                  "bf16_key_bias_launches", "bf16_hd34_launches", "tf32_wgmma_launches",
                  "hd34_copy_launches"):
        setattr(_fn, _name, 0)
flash_attention_bwd.dbias_launches = 0


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel pair as one differentiable op (the library kernel's VJP).
    q, k, v (the model's views) and o are saved as they are; the backward
    takes the output's gradient as autograd hands it over (copied only
    where it does not lie as o does).  A bias that needs a gradient gets it
    from the dbias instance; the key bias gets none.  Differentiable once: a backward
    that builds a graph (``create_graph=True``, a Hessian-vector product)
    raises, where the kernels' gradients would carry no dependence on q, k
    and v and the second derivative would come back short."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, key_bias):
        dims = _check_inputs(q, k, v, bias, key_bias)
        o, lse = _launch_fwd(q, k, v, bias, scale, key_bias, dims, q.shape[-1])
        ctx.save_for_backward(q, k, v, bias, o, lse, key_bias)
        ctx.scale, ctx.dims = scale, dims
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise RuntimeError("flash_attention: the kernels have no second derivative; a "
                               "Hessian needs attention_impl('xla')")
        q, k, v, bias, o, lse, key_bias = ctx.saved_tensors
        need_dbias = ctx.needs_input_grad[3]
        grads = _launch_bwd(q, k, v, bias, ctx.scale, o, lse, do, key_bias, ctx.dims,
                            q.shape[-1], need_dbias)
        dq, dk, dv = grads[:3]
        return dq, dk, dv, grads[3].sum_to_size(bias.shape) if need_dbias else None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, H, Dh]
    v: torch.Tensor,
    bias: Optional[torch.Tensor],  # [1|B, 1|H, 1|Sq, Sk] additive, post-scale
    scale: float,
    key_bias: Optional[torch.Tensor] = None,  # [1|B, Sk] or [1|B, 1, 1, Sk]
) -> torch.Tensor:
    """``softmax((q k^T) * scale + bias + key_bias) v`` as ``[B, Sq, H, Dh]``.

    A CUDA tensor runs the kernels (float32 or bfloat16 q/k/v, ``Dh`` 34 or
    64, a float32 bias, with a gradient for float32 q/k/v only, and a
    float32 key bias without gradient; anything else raises); a CPU tensor
    runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale, key_bias=key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttentionFn.apply(q, k, v, bias, scale, key_bias)
