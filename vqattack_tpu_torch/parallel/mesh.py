"""The device mesh of the data-parallel attack sweep.

Port of ``vqattack_tpu/parallel/mesh.py``.  The JAX mesh is one program
that GSPMD partitions over a ``jax.sharding.Mesh``.  PyTorch has no such
partitioner, so the port's mesh is a list of devices along the ``data``
axis: the batch of independent attack samples is cut into one row slice a
device (:func:`shard_batch`), each device holds its own copy of the
surrogate (:func:`shard_params`), and the lockstep engine
(``attacks/batched.py``) drives each slice on its device from a host thread
of its own.

The ``model`` axis stays 1: tensor parallelism over it is not ported (no
CLI of the JAX package reaches it either), and ``model_parallelism > 1`` is
refused.  An explicit ``devices`` list may name one device more than once:
two replicas on one card run concurrently, each on half of the batch.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: the data axis, in order (a device may repeat)."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}


def make_mesh(n_devices: Optional[int] = None, model_parallelism: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A data mesh of ``n_devices``: by default the first local cards
    (``cuda:0 .. n-1``; all of them when ``n_devices`` is None), else the
    first of ``devices``.  Raises when there are fewer devices than asked
    for, when there is no card and no ``devices``, and for
    ``model_parallelism > 1``."""
    if model_parallelism != 1:
        raise NotImplementedError(
            f"model_parallelism={model_parallelism}: tensor parallelism over the mesh's "
            f"'{MODEL_AXIS}' axis is not ported (ROADMAP.md, Queue 1: tensor parallelism "
            f"over the model axis); the port's mesh is data-parallel only")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: a mesh needs at least one device")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a mesh "
                               "of other devices")
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(f"make_mesh: {n} devices asked for, {count} CUDA "
                               f"device(s) present")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                                 f"{len(devices)} given")
            devices = devices[:n_devices]
        if not devices:
            raise ValueError("make_mesh: empty device list")
    return Mesh(tuple(devices))


def shard_params(module: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One replica of ``module`` a device of the data axis, each a copy on
    its device whose parameters and buffers equal the source's bit for
    bit (the ``model`` axis is 1: nothing is cut)."""
    return [copy.deepcopy(module).to(device) for device in mesh.devices]


def shard_rows(mesh: Mesh, b: int) -> List[Tuple[torch.device, int, int]]:
    """``(device, lo, hi)`` of each shard of a ``b``-row batch: one slice a
    data-axis device when ``b`` divides by the axis, else the whole batch on
    the first device (warned once a (batch, mesh) shape)."""
    n = mesh.shape[DATA_AXIS]
    if b % n:
        _warn_indivisible_once(b, n)
        return [(mesh.devices[0], 0, b)]
    step = b // n
    return [(device, i * step, (i + 1) * step) for i, device in enumerate(mesh.devices)]


def map_shards(fn: Callable[[int], Any], n: int) -> List[Any]:
    """``[fn(0), ..., fn(n - 1)]``: inline for one shard, else on one host
    thread a shard, all at once (each device's launches queue while the
    others' threads run)."""
    if n == 1:
        return [fn(0)]
    with ThreadPoolExecutor(max_workers=n) as ex:
        futures = [ex.submit(fn, i) for i in range(n)]
        return [f.result() for f in futures]


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """The batch (a tensor, or a dict, list or tuple of them) cut along its
    leading axis into one row slice a data-axis device, each on its device:
    a list of the batch's structure, one a shard.  Every tensor with a
    leading axis must have the same number of rows; tensors without one and
    other leaves are the same in every shard (tensors moved).  Rows that do
    not divide by the axis run whole on the mesh's first device, one shard,
    warned once a (batch, mesh) shape: if every chunk of a sweep lands
    there, ``--batch-size`` is not a multiple of ``--mesh-devices`` and the
    mesh computes nothing in parallel."""
    rows = {x.shape[0] for x in _leaves(batch) if isinstance(x, torch.Tensor) and x.ndim}
    if len(rows) != 1:
        raise ValueError(f"shard_batch: the batch's tensors disagree on their rows: {rows}")
    (b,) = rows
    return [_map(batch, lambda x: _take(x, device, lo, hi)) for device, lo, hi in
            shard_rows(mesh, b)]


def _take(x, device, lo, hi):
    if not isinstance(x, torch.Tensor):
        return x
    return (x[lo:hi] if x.ndim else x).to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


_warned_indivisible: set = set()


def _warn_indivisible_once(b: int, n: int) -> None:
    if (b, n) in _warned_indivisible:
        return
    _warned_indivisible.add((b, n))
    warnings.warn(
        f"batch axis {b} not divisible by data-mesh size {n}: running it whole on the "
        f"mesh's first device (fine for a sweep's tail bucket; if this happens for EVERY "
        f"bucket, pick --batch-size as a multiple of --mesh-devices)",
        stacklevel=3,
    )
