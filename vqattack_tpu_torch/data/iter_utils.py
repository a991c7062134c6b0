"""Threaded, order-preserving prefetch over a dataset.

Port of ``vqattack_tpu/data/iter_utils.py``: it stands in for torch
DataLoader workers, so that JPEG decoding and resizing (PIL releases the
interpreter lock while it decodes) overlap the device's work.  Items come
out in the order of ``indices``, whatever order the workers finish them in.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Dict, Iterator, Optional, Sequence


class _WorkerError:
    """An item's exception, raised on the consumer's side in its place."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def threaded_iter(
    dataset,
    indices: Optional[Sequence[int]] = None,
    num_workers: int = 4,
    prefetch: int = 8,
) -> Iterator[Dict[str, Any]]:
    """``dataset[i]`` for each ``i`` of ``indices`` (default: all), in that
    order, read by ``num_workers`` threads at most ``prefetch`` items ahead.

    - an item whose read raises raises in its place, after every item
      before it, and no worker is left blocked;
    - a repeated index fills its own slot each time;
    - closing the generator (a ``break``, or its collection) releases the
      workers blocked on the full queue;
    - ``num_workers=0`` reads inline, in the caller's thread.

    The reads run concurrently: ``dataset[i]`` must be safe to call from
    several threads, and a transform that draws from a shared random
    generator draws in the workers' order, not in ``indices``'."""
    indices = list(indices if indices is not None else range(len(dataset)))
    if num_workers <= 0:
        for i in indices:
            yield dataset[i]
        return
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    # workers draw (position, index) pairs, so that repeated indices fill
    # distinct output slots instead of colliding in an index-keyed map
    it = iter(enumerate(indices))
    lock = threading.Lock()
    stop = threading.Event()
    sentinel = object()

    def _put(x) -> bool:
        # a put that gives up once the consumer is gone (``stop``): a plain
        # put would block the worker for ever on a queue nobody drains
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        # the sentinel must reach the consumer even if dataset[i] raises: a
        # worker gone without its sentinel would leave the consumer waiting
        try:
            while not stop.is_set():
                with lock:
                    nxt = next(it, None)
                if nxt is None:
                    return
                pos, i = nxt
                try:
                    item = dataset[i]
                except BaseException as e:  # re-raised in order on the consumer's side
                    if not _put((pos, _WorkerError(e))):
                        return
                    continue
                if not _put((pos, item)):
                    return
        finally:
            _put(sentinel)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(num_workers)]
    for t in threads:
        t.start()
    done = want = 0
    buf: Dict[int, Any] = {}

    def ready():
        # the items at the head of the order, as far as they have arrived
        nonlocal want
        while want in buf:
            nxt = buf.pop(want)
            want += 1
            if isinstance(nxt, _WorkerError):
                raise nxt.exc
            yield nxt

    try:
        while done < num_workers:
            got = q.get()
            if got is sentinel:
                done += 1
                continue
            pos, item = got
            buf[pos] = item
            yield from ready()
        yield from ready()
    finally:
        # the consumer has left (exhaustion, break, error): release the
        # workers blocked on the full queue, then drain it so their puts end
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
