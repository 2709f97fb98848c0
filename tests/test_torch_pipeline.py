"""The port's ordered_parallel_map (dsrc_tpu_torch/parallel/pipeline.py)
with head=True, the shape DsrcModule.compress and .decompress take: the
reader thread starts first and reads ahead while the first item runs on the
calling thread, and the workers start after it.

- The reader has pulled item 1 while item 0 runs (the head waits on an
  event the source sets, with a timeout, so that it cannot hang).
- Results come in input order, with 1 and 3 workers.
- No more than `depth` items are queued during the head; api.read_ahead
  counts them.
- A reader error raised while the head runs surfaces after it, as raised.
- An error of the head stops the reader before it is raised.
"""
import threading
import time

import pytest

from dsrc_tpu_torch.config import DsrcException
from dsrc_tpu_torch.parallel.pipeline import ordered_parallel_map
from dsrc_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

WAIT = 30.0         # seconds a test waits for the reader before failing


class Source:
    """Items 0..n-1 (forever when n is None), counting what was pulled and
    on which thread; `pulled[k]` is set once item k has been pulled."""

    def __init__(self, n=None, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self.count = 0
        self.threads = []
        self.pulled = {}
        self.failed = threading.Event()

    def event(self, k):
        return self.pulled.setdefault(k, threading.Event())

    def __iter__(self):
        i = 0
        while self.n is None or i < self.n:
            if i == self.fail_at:
                self.failed.set()
                raise DsrcException("bad block")
            self.count += 1
            self.threads.append(threading.current_thread())
            self.event(i).set()
            yield i
            i += 1


def _settled(src, timeout=WAIT):
    """Wait until src stops pulling (its count unchanged for 0.2 s)."""
    end = time.monotonic() + timeout
    last = -1
    while src.count != last and time.monotonic() < end:
        last = src.count
        time.sleep(0.2)
    return src.count


@pytest.mark.parametrize("workers", [1, 3])
def test_head_runs_while_the_reader_reads_in_order(workers):
    src = Source(40)
    main = threading.current_thread()
    seen = []

    def fn(x):
        if x == 0:
            assert threading.current_thread() is main
            assert src.event(1).wait(WAIT), "the reader did not read ahead"
            seen.append(src.threads[1])
        return x * x

    out = list(ordered_parallel_map(iter(src), fn, workers, head=True))
    assert out == [x * x for x in range(40)]
    # item 0 is pulled on the calling thread, the rest by the reader
    assert src.threads[0] is main and seen[0] is not main


def test_read_ahead_is_bounded_by_depth_and_counted():
    depth = 3
    src = Source(40)

    def fn(x):
        if x == 0:
            assert src.event(depth + 1).wait(WAIT)
            # items 1..depth queued, item depth + 1 pulled and waiting for
            # room in the queue
            assert _settled(src) == depth + 2
        return x

    trace.start()
    try:
        out = list(ordered_parallel_map(iter(src), fn, 2, depth=depth,
                                        head=True))
    finally:
        rec = trace.stop()
    assert out == list(range(40))
    assert rec.by_name()["api.read_ahead"].count == depth


def test_no_read_ahead_count_with_the_recorder_off(monkeypatch):
    def no_record():
        raise AssertionError("recorded with the recorder off")
    monkeypatch.setattr(trace, "_buffer", no_record)
    assert not trace.active()
    out = list(ordered_parallel_map(iter(range(10)), lambda x: x, 2,
                                    head=True))
    assert out == list(range(10))


def test_reader_error_during_the_head_surfaces_after_it():
    src = Source(10, fail_at=2)
    done = []
    cancelled = threading.Event()

    def fn(x):
        if x == 0:
            assert src.failed.wait(WAIT)
            done.append(x)
        return x

    with pytest.raises(DsrcException, match="bad block"):
        list(ordered_parallel_map(iter(src), fn, 2, head=True,
                                  on_error=cancelled.set))
    assert done == [0] and cancelled.is_set()


def test_head_error_stops_the_reader():
    depth = 4
    src = Source()
    cancelled = threading.Event()

    def fn(x):
        if x == 0:
            assert src.event(1).wait(WAIT)
            raise ValueError("head failed")
        return x

    with pytest.raises(ValueError, match="head failed"):
        list(ordered_parallel_map(iter(src), fn, 2, depth=depth, head=True,
                                  on_error=cancelled.set))
    # the reader has stopped: nothing is pulled after the raise, and no
    # more than a queue's worth and one item ever was
    n = src.count
    time.sleep(0.3)
    assert src.count == n <= depth + 2
    assert cancelled.is_set()
