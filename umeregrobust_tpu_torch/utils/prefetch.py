"""Host-side input prefetching: overlap data prep with device compute
(the port's own copy of umeregrobust_tpu/utils/prefetch.py).

The reference keeps the accelerator fed with
DataLoader(num_workers=8, pin_memory=True) (train_coloring.py:351-356);
here a small bounded-queue producer thread does it. Data prep is numpy
(voxelize, SEM-equalize, pad) and releases the GIL inside numpy kernels,
so one or two threads hide it behind the device step.

Usage:
    for batch in prefetch(batches_iter, depth=2):
        step(batch)          # device computes while the thread preps next
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

__all__ = ["prefetch", "prefetch_map"]

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a daemon thread, keeping up to `depth` items ready.

    Exceptions raised by the producer are re-raised at the consuming site.
    The producer thread stops when the iterator is exhausted or the
    interpreter exits (daemon=True); a consumer that abandons iteration
    early leaves at most `depth` prepped items to be garbage-collected.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: list = []

    def run():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


def prefetch_map(
    fn: Callable[[T], U], it: Iterable[T], workers: int = 4, depth: int = 8
) -> Iterator[U]:
    """Ordered parallel map with a bounded in-flight window — the
    multi-worker analog of the reference's DataLoader(num_workers=8):
    `fn` (numpy-heavy prep, releases the GIL) runs on `workers` threads
    while results stream out in input order; at most `depth` items are
    in flight, and pulling from `it` `depth` ahead also overlaps any IO
    the iterator does. Exceptions from `fn` re-raise at the consuming
    site in order."""
    ex = ThreadPoolExecutor(max_workers=workers)
    pending: collections.deque = collections.deque()
    try:
        for item in it:
            pending.append(ex.submit(fn, item))
            if len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
