"""Injectable randomness for the attack: a key object with JAX's shape.

The JAX package threads ``jax.random`` keys through the attack (split per
block, per iteration, per MLM mask).  The port keeps that structure so each
call site reads like its JAX counterpart, but the default key draws from a
``torch.Generator`` on the attack's device.  Tests substitute a key that
replays the JAX package's own draws, which makes the two packages'
trajectories comparable.

A key provides ``split(n)``, ``fold_in(data)``, ``uniform(shape, lo, hi)``,
``randint(shape, lo, hi)``, ``rademacher(shape)`` and ``categorical(logits)``.
Image-shaped draws are requested in the port's NCHW layout.  A key with
state (:class:`TorchKey`) also provides ``clone()``; a key without it is a
value whose draws depend on the key alone.  :class:`RowsKey` gives a shard
of a batch the rows of the whole batch's draws (the data mesh,
``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class TorchKey:
    """A key over one ``torch.Generator``.

    ``split`` hands out views of the same stream: draws are taken in call
    order, which is deterministic for a given schedule.  ``fold_in`` starts
    a fresh stream whose seed depends on this key's seed and ``data``, so a
    sample's draws do not depend on which samples ran before it."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def split(self, n: int = 2) -> List["TorchKey"]:
        return [self] * n

    def fold_in(self, data: int) -> "TorchKey":
        return TorchKey((self.seed * 1_000_003 + int(data)) % (2 ** 63), self.device)

    def clone(self) -> "TorchKey":
        """A key whose draws to come are this key's, from a generator of
        its own."""
        out = TorchKey(self.seed, self.device)
        out.generator.set_state(self.generator.get_state())
        return out

    def uniform(self, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device,
                       dtype=dtype)
        return u * (hi - lo) + lo

    def randint(self, shape: Sequence[int], lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, tuple(shape), generator=self.generator,
                             device=self.device)

    def rademacher(self, shape: Sequence[int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """+1 or -1, each with probability 1/2."""
        r = torch.randint(0, 2, tuple(shape), generator=self.generator, device=self.device)
        return (2 * r - 1).to(dtype)

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        """One index a row of ``logits``, drawn over the last axis with
        probability ``softmax(logits)``: the argmax of the logits plus Gumbel
        noise, as ``jax.random.categorical`` draws.  An entry at ``-inf`` is
        never drawn (unless its whole row is)."""
        u = torch.rand(tuple(logits.shape), generator=self.generator, device=self.device,
                       dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        return torch.argmax(logits.float() + gumbel.to(logits.device), dim=-1)


def clone_key(key):
    """An independent copy of ``key``'s draws to come: ``key.clone()``, or
    ``key`` itself where it has no state to share."""
    return key.clone() if hasattr(key, "clone") else key


class RowsKey:
    """Rows ``lo:hi`` of a ``total``-row batch's draws from ``key``.

    Every draw is made at the whole batch's size and sliced, so a shard of
    the batch draws what the whole batch gives its rows, whatever the number
    of shards; the draws land on ``device``.  Each shard needs a key of its
    own (:func:`clone_key`): a stateful key's draws advance with every call.
    A draw's leading axis must be the batch's."""

    def __init__(self, key, lo: int, hi: int, total: int, device: torch.device):
        self.key, self.lo, self.hi, self.total = key, lo, hi, total
        self.device = torch.device(device)

    def _wrap(self, key) -> "RowsKey":
        return RowsKey(key, self.lo, self.hi, self.total, self.device)

    def split(self, n: int = 2) -> List["RowsKey"]:
        return [self._wrap(k) for k in self.key.split(n)]

    def fold_in(self, data: int) -> "RowsKey":
        return self._wrap(self.key.fold_in(data))

    def _whole(self, shape: Sequence[int]):
        shape = tuple(shape)
        if not shape or shape[0] != self.hi - self.lo:
            raise ValueError(f"RowsKey: a draw of shape {shape} for rows {self.lo}:{self.hi}; "
                             f"its leading axis must be the shard's rows")
        return (self.total,) + shape[1:]

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.lo : self.hi].to(self.device)

    def uniform(self, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self._rows(self.key.uniform(self._whole(shape), lo, hi, dtype))

    def randint(self, shape: Sequence[int], lo: int, hi: int) -> torch.Tensor:
        return self._rows(self.key.randint(self._whole(shape), lo, hi))

    def rademacher(self, shape: Sequence[int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self._rows(self.key.rademacher(self._whole(shape), dtype))

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        """The shard's logits in place in a whole batch of zeros: each row
        of a categorical draw depends on its own logits alone."""
        whole = torch.zeros(self._whole(logits.shape), dtype=logits.dtype,
                            device=logits.device)
        whole[self.lo : self.hi] = logits
        return self._rows(self.key.categorical(whole))
