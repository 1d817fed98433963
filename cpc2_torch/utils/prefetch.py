"""Host-side pipeline overlap: a single-thread, bounded-queue prefetcher (a
copy of `cpc2_tpu/utils/prefetch.py`).

The trainer ends each step in a device synchronise, so the loader's
per-batch work (sampling, the window gather, host augmentation, pinning)
would otherwise run between steps on the main thread. Wrapping the loader
in a background prefetch of depth one or more runs batch N+1's host work
while step N computes (the reference gets the same overlap from DataLoader
worker processes, `cpc/dataset.py:528-534`).
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Iterates `iterable` on a daemon thread, buffering up to `depth`
    items. Order-preserving; exceptions re-raise at the consuming site.

    `transform`, when given, runs on the worker thread per item before
    queueing: the hook that moves per-batch host work (pinning a batch
    for its copy to the card) off the stepping thread. `close()` stops a
    worker whose consumer gives up before the end."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 2, transform=None):
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error = None
        self._transform = transform
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iterable,), daemon=True)
        self._thread.start()

    def _worker(self, iterable):
        try:
            for item in iterable:
                if self._stop.is_set():
                    break
                if self._transform is not None:
                    item = self._transform(item)
                self._queue.put(item)
        except BaseException as exc:  # re-raised on the consumer thread
            self._error = exc
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker after the item it is producing and wait for it;
        the items still buffered are dropped."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()


def prefetch(iterable, depth: int = 2, transform=None):
    """Background-prefetch `iterable` (depth <= 0 disables)."""
    if depth <= 0:
        it = iter(iterable)
        if transform is None:
            return it
        return map(transform, it)
    return PrefetchIterator(iterable, depth, transform=transform)
