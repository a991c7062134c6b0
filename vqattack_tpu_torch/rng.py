"""Injectable randomness for the attack: a key object with JAX's shape.

The JAX package threads ``jax.random`` keys through the attack (split per
block, per iteration, per MLM mask).  The port keeps that structure so each
call site reads like its JAX counterpart, but the default key draws from a
``torch.Generator`` on the attack's device.  Tests substitute a key that
replays the JAX package's own draws, which makes the two packages'
trajectories comparable.

A key provides ``split(n)``, ``fold_in(data)``, ``uniform(shape, lo, hi)``,
``randint(shape, lo, hi)`` and ``rademacher(shape)``.  Image-shaped draws are requested in the
port's NCHW layout.
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
