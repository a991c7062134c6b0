"""Windowed meters and progress logging.

Port of ``vqattack_tpu/utils/meters.py`` (reference ``ALBEF_attack/utils.py:
11-163``: ``SmoothedValue`` with a window and global statistics, and
``MetricLogger.log_every`` printing iteration and data time, ETA and device
memory).  The device memory is ``torch.cuda.memory_allocated`` where a card
has been used.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, Optional

import torch


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.window)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.window) / max(1, len(self.window))

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value, max=max(self.window) if self.window else 0.0,
        )


def _device_mem_mb() -> Optional[float]:
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_allocated() / 1024 / 1024


class MetricLogger:
    def __init__(self, delimiter: str = "  ", log_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.log_fn = log_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "") -> Iterator:
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                parts = [header, f"[{i}" + (f"/{total}]" if total else "]")]
                if total:
                    eta = iter_time.global_avg * (total - i)
                    parts.append(f"eta: {datetime.timedelta(seconds=int(eta))}")
                parts += [str(self), f"time: {iter_time}", f"data: {data_time}"]
                mem = _device_mem_mb()
                if mem is not None:
                    parts.append(f"mem: {mem:.0f}MB")
                self.log_fn(self.delimiter.join(p for p in parts if p))
            end = time.time()
        elapsed = time.time() - start
        self.log_fn(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")
