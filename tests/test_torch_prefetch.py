"""`cpc2_torch/utils/prefetch.py`, the port's copy of the background
prefetcher that runs the loader ahead of the training steps: the cases of
`tests/test_prefetch.py`, and `close()` stopping a worker whose consumer
gave up early."""

import threading
import time

import pytest

from cpc2_torch.utils.prefetch import PrefetchIterator, prefetch


def test_order_preserved():
    assert list(prefetch(range(50), depth=4)) == list(range(50))


def test_transform_runs_on_worker_thread():
    main = threading.get_ident()
    seen = []

    def tf(x):
        seen.append(threading.get_ident())
        return x * 2

    out = list(prefetch(range(10), depth=2, transform=tf))
    assert out == [2 * i for i in range(10)]
    assert all(t != main for t in seen)


def test_transform_without_thread():
    assert list(prefetch(range(5), depth=0, transform=lambda x: -x)) \
        == [0, -1, -2, -3, -4]


def test_exception_reraised_at_consumer():
    def gen():
        yield 1
        raise RuntimeError("loader broke")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader broke"):
        for _ in it:
            pass


def test_transform_exception_reraised():
    def tf(x):
        if x == 3:
            raise ValueError("bad item")
        return x

    it = prefetch(range(10), depth=2, transform=tf)
    got = []
    with pytest.raises(ValueError, match="bad item"):
        for v in it:
            got.append(v)
    assert got == [0, 1, 2]


def test_bounded_buffer_backpressure():
    """The worker never runs more than depth items ahead of the consumer."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    it = PrefetchIterator(gen(), depth=2)
    next(it)
    time.sleep(0.2)
    # queue(depth=2) + one in-flight put + the consumed one
    assert len(produced) <= 5, len(produced)
    assert list(it) == list(range(1, 100))


def test_close_stops_an_abandoned_worker():
    """A consumer that stops early (a step that raised) closes the
    iterator: the worker stops after the item it is producing instead of
    waiting forever on a full queue."""
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = PrefetchIterator(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()
    assert len(produced) <= 6, len(produced)
