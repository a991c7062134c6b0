"""Checkpoint geometry adaptation: position-embedding resizing.

Port of ``vqattack_tpu/checkpoint/interpolate.py``.  The reference adapts
224 px checkpoints to 480 px models by bicubic interpolation of the patch
position grid (``models/vit.py:181-205``, ``vlmo_module.py:88-112``) and by
geometric-progression resampling of relative-position-bias tables
(``vlmo_module.py:741-804``).  The bicubic resize is the reference's own
call, ``torch.nn.functional.interpolate``; the table resize needs scipy,
imported inside the function that uses it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def interpolate_pos_embed(
    pos_embed: np.ndarray, new_num_patches: int, num_extra_tokens: int = 1
) -> np.ndarray:
    """Bicubic-resize the patch grid of an absolute position embedding.

    ``pos_embed``: [1, old_patches + extra, D]; the extra tokens (the [CLS])
    lead and are kept unchanged (``vit.py:191-203``).  Returns float32
    [1, new_num_patches + extra, D].
    """
    pos = torch.from_numpy(np.ascontiguousarray(pos_embed, dtype=np.float32))
    dim = pos.shape[-1]
    orig_size = int(round(math.sqrt(pos.shape[-2] - num_extra_tokens)))
    new_size = int(round(math.sqrt(new_num_patches)))
    if orig_size == new_size:
        return np.asarray(pos_embed)
    extra = pos[:, :num_extra_tokens]
    grid = pos[:, num_extra_tokens:].reshape(1, orig_size, orig_size, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(new_size, new_size), mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, new_size * new_size, dim)
    return torch.cat([extra, grid], dim=1).numpy()


def _geometric_points(src_size: int, dst_size: int) -> np.ndarray:
    """The BEiT/VLMo geometric-progression source-coordinate layout
    (``vlmo_module.py:764-783``): find ratio ``q`` in [1.01, 1.5] such that
    the geometric sum ``1 + q + ... + q^(src//2 - 1)`` reaches ``dst//2``,
    then lay source samples at cumulative-geometric distances around 0."""
    n = src_size // 2
    target = dst_size // 2

    def gp(r):
        return (1.0 - r ** n) / (1.0 - r)  # a=1

    # NB: the ratio used is the midpoint tested in the FINAL bisection
    # iteration (the loop variable q), not a post-loop (left+right)/2 —
    # recomputing shifts q by ~5e-7 and every source coordinate with it
    left, right = 1.01, 1.5
    q = (left + right) / 2.0
    while right - left > 1e-6:
        q = (left + right) / 2.0
        if gp(q) > target:
            right = q
        else:
            left = q
    dis, cur = [], 1.0
    for i in range(n):
        dis.append(cur)
        cur += q ** (i + 1)
    r_ids = [-d for d in reversed(dis)]
    return np.array(r_ids + [0] + dis, dtype=np.float64)


def interpolate_rel_pos_bias(table: np.ndarray, src_size: int, dst_size: int) -> np.ndarray:
    """Resize a relative-position-bias grid from ``src_size^2`` rows to
    ``dst_size^2`` rows per column via geometric-coordinate cubic
    interpolation (``vlmo_module.py:741-804``).

    ``src_size``/``dst_size`` are the *grid* sizes ``2*window - 1`` (odd),
    as the reference names them.  ``table``: ``[src_size^2 (+ extra
    trailing rows), H]``; the extra rows pass through.
    """
    from scipy.interpolate import RectBivariateSpline

    table = np.asarray(table)
    num_extra = table.shape[0] - src_size ** 2
    if src_size == dst_size:
        return table
    extra = table[table.shape[0] - num_extra:] if num_extra > 0 else table[:0]
    body = table[: src_size ** 2]

    x = _geometric_points(src_size, dst_size)
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)  # dst_size integer positions

    k = min(3, src_size - 1)  # cubic when the grid allows (the real 27-grid case)
    out = []
    for h in range(body.shape[1]):
        z = body[:, h].reshape(src_size, src_size).astype(np.float64)
        f = RectBivariateSpline(x, x, z, kx=k, ky=k)
        out.append(f(dx, dx).reshape(-1))
    new_body = np.stack(out, axis=1).astype(table.dtype)
    if num_extra > 0:
        return np.concatenate([new_body, extra], axis=0)
    return new_body
