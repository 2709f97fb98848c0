"""Host pipeline runtime — the counterpart of the reference's thread-pool
block pipeline (TDataQueue/TDataPool/FastqReader/DsrcWorker/ordered writer,
DataQueue.h:33, DsrcWorker.cpp:30-104, DsrcIo.cpp:19-89).

Structure (compression):

    reader thread:   chunker -> bounded in-queue (backpressure = DataPool)
    worker threads:  pop block -> BlockCodec.compress (device) -> out-queue
    writer (caller): ordered merge by block id -> archive

Workers overlap host-side (de)serialization with device compute; ordering is
restored exactly like the reference's partId map (FastqIo.cpp:71-135) via a
holdback dict.  Errors propagate first-error-wins (MultithreadedErrorHandler,
ErrorHandler.h:57) through a shared slot; all threads drain cooperatively.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from ..config import DsrcException
from ..utils import trace

_STOP = object()


class _ErrorSlot:
    """First-error-wins (reference MultithreadedErrorHandler); on_error
    runs once, at the first error."""

    def __init__(self, on_error: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._on_error = on_error
        self.error: Optional[BaseException] = None

    def set(self, exc: BaseException) -> None:
        with self._lock:
            first = self.error is None
            if first:
                self.error = exc
        if first and self._on_error is not None:
            self._on_error()

    def check(self) -> None:
        if self.error is not None:
            raise self.error


def ordered_parallel_map(items: Iterator, fn: Callable, num_workers: int,
                         depth: int = 0,
                         on_error: Optional[Callable[[], None]] = None,
                         head: bool = False):
    """Apply fn to items on worker threads, yielding results in input order.

    The in-queue is bounded (backpressure like TDataPool); workers take
    items in input order; results are re-merged by index like the
    reference's ordered writers.  Exceptions from any thread are re-raised
    in the consumer; on_error runs at the first one (to release calls of fn
    that wait on one another: items left after an error are skipped).

    head: fn of the first item runs on the calling thread before any
    worker starts (the first block seeds what later blocks wait on), while
    the reader already queues the items after it; the number it had queued
    when the head returned is counted as api.read_ahead.  An error of the
    head stops the reader before it is raised.
    """
    num_workers = max(1, num_workers)
    depth = depth or num_workers * 4
    inq: "queue.Queue" = queue.Queue(maxsize=depth)
    outq: "queue.Queue" = queue.Queue()
    err = _ErrorSlot(on_error)
    items = iter(items)
    first = next(items, _STOP) if head else _STOP
    start = 0 if first is _STOP else 1
    queued = [0]

    def reader():
        try:
            for i, item in enumerate(items, start):
                inq.put((i, item))
                queued[0] += 1
                if err.error is not None:   # read no further
                    break
        except BaseException as e:  # noqa: BLE001 — propagated to consumer
            err.set(e)
        finally:
            for _ in range(num_workers):
                inq.put(_STOP)

    def worker():
        while True:
            got = inq.get()
            if got is _STOP:
                outq.put(_STOP)
                return
            i, item = got
            if err.error is not None:
                continue
            try:
                outq.put((i, fn(item)))
            except BaseException as e:  # noqa: BLE001
                err.set(e)
                outq.put(_STOP)
                return

    reading = threading.Thread(target=reader, daemon=True)
    workers = [threading.Thread(target=worker, daemon=True)
               for _ in range(num_workers)]
    done = []                   # the head's result
    reading.start()
    if first is not _STOP:
        try:
            done.append(fn(first))
        except BaseException as e:  # noqa: BLE001
            err.set(e)
            for t in workers:       # they drain the in-queue
                t.start()
            reading.join()
            raise err.error         # the first: the head's or the reader's
        trace.count("api.read_ahead", queued[0])
    for t in workers:
        t.start()
    yield from done

    hold = {}
    next_id = start
    stops = 0
    try:
        while stops < num_workers:
            with trace.span("api.wait"):
                got = outq.get()
            if got is _STOP:
                stops += 1
                continue
            i, res = got
            hold[i] = res
            while next_id in hold:
                yield hold.pop(next_id)
                next_id += 1
        err.check()
        if hold:
            raise DsrcException("pipeline lost blocks (internal error)")
    finally:
        err.check()
