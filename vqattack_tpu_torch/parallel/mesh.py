"""The device mesh of the attack sweep: a data x model grid.

Port of ``vqattack_tpu/parallel/mesh.py``.  The JAX mesh is one program
that GSPMD partitions over a ``jax.sharding.Mesh``.  PyTorch has no such
partitioner, so the port writes both axes out in one process:

- ``data``: the batch of independent attack samples is cut into one row
  slice a data-axis position (:func:`shard_batch`), each position holds its
  own copy of the surrogate (:func:`shard_params`), and the lockstep engine
  (``attacks/batched.py``) drives each slice from a host thread of its own;
- ``model``: each position is a row of ``model_parallelism`` devices over
  which its copy's 2-D parameters are cut column-wise, the rule of the JAX
  ``shard_params`` (``parallel/tensor.py``); activations are gathered on the
  row's first device, so everything else runs there at the unsharded
  shapes.

``Mesh.devices`` is the data axis, the first device of each row, where a
row slice of the batch and its replica's uncut parameters live.  An explicit
``devices`` list may name one device more than once: two replicas on one
card run concurrently, each on half of the batch, and a row ``[cuda:0,
cuda:0]`` cuts a replica's parameters in two on the one card.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vqattack_tpu_torch.parallel.tensor import column_cuts, cut_replica

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``rows``: one row of devices a data-axis position, each row the
    model axis, in order (a device may repeat)."""

    rows: Tuple[Tuple[torch.device, ...], ...]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The data axis: the first device of each row."""
        return tuple(row[0] for row in self.rows)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.rows), MODEL_AXIS: len(self.rows[0])}


def make_mesh(n_devices: Optional[int] = None, model_parallelism: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices`` folded into ``n_devices // model_parallelism``
    rows of ``model_parallelism``, in order (the JAX ``reshape(n // mp,
    mp)``): by default the first local cards (``cuda:0 .. n-1``; all of
    them when ``n_devices`` is None), else the first of ``devices``.
    Raises when there are fewer devices than asked for, when there is no
    card and no ``devices``, and when ``model_parallelism`` is below 1 or
    does not divide the device count."""
    if model_parallelism < 1:
        raise ValueError(f"make_mesh: model_parallelism={model_parallelism} for "
                         f"n_devices={n_devices}: the model axis needs at least one device")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: a mesh needs at least one device")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a mesh "
                               "of other devices")
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} CUDA "
                             f"device(s) present")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [_indexed(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                                 f"{len(devices)} given")
            devices = devices[:n_devices]
        if not devices:
            raise ValueError("make_mesh: empty device list")
    n = len(devices)
    if n % model_parallelism:
        raise ValueError(f"make_mesh: {n} devices do not fold into rows of "
                         f"model_parallelism={model_parallelism}")
    return Mesh(tuple(tuple(devices[i : i + model_parallelism])
                      for i in range(0, n, model_parallelism)))


def _indexed(device) -> torch.device:
    """``device`` as its tensors name it: ``cuda`` is the current card's
    index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_params(module: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One replica of ``module`` a data-axis position, each a copy on its
    row: with a model axis of 1 a copy on the position's device; else every
    2-D parameter whose flax leaf's last axis divides by the model axis cut
    column-wise over the row (``parallel/tensor.py``) and the others whole
    on the row's first device.  Every value equals the source's bit for
    bit.  Cut after the weights are loaded."""
    if mesh.shape[MODEL_AXIS] == 1:
        return [copy.deepcopy(module).to(device) for device in mesh.devices]
    cuts = column_cuts(module, mesh.shape[MODEL_AXIS])
    return [cut_replica(module, row, cuts) for row in mesh.rows]


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
