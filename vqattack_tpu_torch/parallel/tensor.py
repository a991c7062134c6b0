"""Column-cut layers: the tensor parallelism of the mesh's ``model`` axis.

Port of what ``vqattack_tpu/parallel/mesh.py::shard_params`` asks of GSPMD
on a data x model mesh: every 2-D leaf of the flax tree whose last axis
divides by the model axis is cut along that axis (``P(None, "model")``),
and everything else is replicated.  PyTorch has no partitioner, so the cut
is written out here, in one process, for one row of the mesh (the devices
of one data-axis position):

- :class:`ColumnLinear`: a ``Linear`` whose weight ``[out, in]`` is cut on
  dim 0 (the flax kernel's ``out`` axis), piece ``j`` on the row's device
  ``j``, each piece a product of its own output columns;
- :class:`ColumnEmbedding`: an ``Embedding`` whose table ``[vocab, D]`` is
  cut on dim 1, each piece a lookup of its own columns;
- :class:`ColumnParameter`: a bare 2-D parameter cut on dim 1 (VLMo's
  ``relative_position_bias_table``), gathered where it is read.

Every cut is a column cut: each output column is computed whole on one
device from the same operands as the uncut product, and the pieces'
outputs are gathered on the row's first device (``.to`` and ``cat``,
through which autograd carries the gradients back).  There is no
row-parallel pair and no all-reduce.  Parameters that are not cut (the
biases, the LayerNorms, everything not 2-D) stay whole on the row's first
device, so the kernels there see the unsharded shapes.

:func:`column_cuts` reads the JAX rule on the flax layout of
``checkpoint/convert.py``; :func:`cut_replica` builds one row's copy.
Cut a module after its weights are loaded: ``flax_leaves`` knows no cut
layer.
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vqattack_tpu_torch.checkpoint.convert import flax_leaves
from vqattack_tpu_torch.models.layers import Embedding, Linear


def _pieces(param: torch.Tensor, dim: int, row: Sequence[torch.device]) -> nn.ParameterList:
    """``param`` cut in ``len(row)`` equal pieces along ``dim``, piece ``j``
    a copy on ``row[j]``, bit for bit."""
    return nn.ParameterList(
        nn.Parameter(p.detach().to(device, copy=True).contiguous(),
                     requires_grad=param.requires_grad)
        for p, device in zip(torch.chunk(param, len(row), dim), row))


def _gather(parts, lead: torch.device) -> torch.Tensor:
    """The pieces' outputs, in order, concatenated on ``lead`` along the
    last axis."""
    return torch.cat([y.to(lead) for y in parts], -1)


class ColumnLinear(nn.Module):
    """A :class:`~vqattack_tpu_torch.models.layers.Linear` with its weight cut
    on dim 0 over a row: piece ``j`` computes ``F.linear`` of its output
    columns on its device, in the compute dtype, as ``Linear.forward``
    does; it takes over the layer's bias, whole on the row's first device,
    and each piece adds its slice."""

    def __init__(self, layer: Linear, row: Sequence[torch.device]):
        super().__init__()
        self.lead = torch.device(row[0])
        self.compute_dtype = layer.compute_dtype
        self.pieces = _pieces(layer.weight, 0, row)
        self.bias = layer.bias  # the replica's own, on the row's first device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, outs, lo = self.compute_dtype, [], 0
        for w in self.pieces:
            hi = lo + w.shape[0]
            b = None if self.bias is None else self.bias[lo:hi].to(w.device, dt)
            outs.append(F.linear(x.to(w.device, dt), w.to(dt), b))
            lo = hi
        return _gather(outs, self.lead)


class ColumnEmbedding(nn.Module):
    """An :class:`~vqattack_tpu_torch.models.layers.Embedding` with its table
    cut on dim 1 over a row: each piece looks up its columns on its device,
    the rows come out in the compute dtype."""

    def __init__(self, layer: Embedding, row: Sequence[torch.device]):
        super().__init__()
        self.lead = torch.device(row[0])
        self.compute_dtype = layer.compute_dtype
        self.pieces = _pieces(layer.weight, 1, row)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return _gather([F.embedding(ids.to(t.device), t).to(self.compute_dtype)
                        for t in self.pieces], self.lead)


class ColumnParameter(nn.Module):
    """A bare 2-D parameter cut on dim 1 over a row.  Calling it, or
    indexing it as the parameter was indexed, reads the table gathered on
    the row's first device."""

    def __init__(self, param: torch.Tensor, row: Sequence[torch.device]):
        super().__init__()
        self.lead = torch.device(row[0])
        self.pieces = _pieces(param, 1, row)

    def forward(self) -> torch.Tensor:
        return _gather(list(self.pieces), self.lead)

    def __getitem__(self, index) -> torch.Tensor:
        return self()[index]


def column_cuts(module: nn.Module, model_parallelism: int) -> Dict[str, int]:
    """``{parameter name: the torch dim cut}`` of the JAX rule on
    ``module``'s flax tree: every 2-D leaf whose last flax axis divides by
    ``model_parallelism``, cut along the torch axis that holds that flax
    axis (dim 0 of a ``Linear`` weight, dim 1 of an ``Embedding`` table or
    a bare parameter).  Empty for a model axis of 1."""
    if model_parallelism == 1:
        return {}
    cuts = {}
    for name, _, transform, param in flax_leaves(module):
        shape = transform.flax_shape(param.shape)
        if len(shape) == 2 and shape[-1] % model_parallelism == 0:
            cuts[name] = 1 if transform.perm is None else transform.perm.index(1)
    return cuts


def cut_layer(replica: nn.Module, name: str) -> nn.Module:
    """The cut layer of ``replica`` that holds parameter ``name`` of its
    source (a name of :func:`column_cuts`)."""
    owner, _, pname = name.rpartition(".")
    return replica.get_submodule(owner if pname == "weight" else name)


def cut_replica(module: nn.Module, row: Sequence[torch.device],
                cuts: Dict[str, int]) -> nn.Module:
    """A copy of ``module`` for one row of the mesh: the parameters named in
    ``cuts`` (:func:`column_cuts`) cut over ``row``, everything else on
    ``row[0]``, each value equal to the source's bit for bit."""
    lead = torch.device(row[0])
    replica = copy.deepcopy(module).to(lead)
    for name, dim in cuts.items():
        owner_name, _, pname = name.rpartition(".")
        owner = replica.get_submodule(owner_name)
        if pname == "weight" and isinstance(owner, Linear) and dim == 0:
            parent_name, _, attr = owner_name.rpartition(".")
            setattr(replica.get_submodule(parent_name), attr, ColumnLinear(owner, row))
        elif pname == "weight" and isinstance(owner, Embedding) and dim == 1:
            parent_name, _, attr = owner_name.rpartition(".")
            setattr(replica.get_submodule(parent_name), attr, ColumnEmbedding(owner, row))
        elif pname != "weight" and dim == 1:
            cut = ColumnParameter(getattr(owner, pname), row)
            delattr(owner, pname)  # a parameter's name takes no module
            setattr(owner, pname, cut)
        else:
            raise TypeError(f"{name}: no column cut for dim {dim} of a "
                            f"{type(owner).__name__}")
    return replica
