"""Profiling and step timing.

Port of ``vqattack_tpu/utils/profiling.py``:

- :func:`trace`: a ``torch.profiler`` trace of the CPU and, where there is a
  card, CUDA activity, written as a Chrome trace (``trace.json``) into
  ``log_dir``;
- :func:`hard_sync`: waits for the devices of a tree's tensors, then reads
  one element of each leaf back to the host;
- :class:`StepTimer`: wall-clock step timing around :func:`hard_sync`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the ``torch.profiler.profile`` (its
    ``key_averages()`` and ``events()`` are read after the block) and writes
    ``log_dir/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def hard_sync(tree: Any) -> None:
    """Wait for every leaf of ``tree``: ``torch.cuda.synchronize`` on each
    card that holds one, then one element of EACH leaf read back to the
    host, so that no independently launched computation is still in
    flight when a timer stops."""
    leaves = list(_leaves(tree))
    for device in {x.device for x in leaves if x.is_cuda}:
        torch.cuda.synchronize(device)
    for x in leaves:
        if x.numel():
            x.reshape(-1)[:1].cpu()


class StepTimer:
    def __init__(self):
        self.times: List[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def timeit(self, fn, *args, warmup: int = 1, reps: int = 3, **kw):
        """Run ``fn`` with a hard sync after each call; returns
        ``(mean seconds of the reps, last result)``."""
        out = None
        for _ in range(warmup):
            out = fn(*args, **kw)
            hard_sync(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args, **kw)
            hard_sync(out)
        self.times.append((time.perf_counter() - t0) / reps)
        return self.times[-1], out

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))
