"""The port's recorder: named spans on the host's clock, and the count of
the host's reads of device values.

Off by default.  While it is off, `span(...)` tests one module flag and
returns a shared no-op context: it allocates nothing, takes no lock and
reads no clock.

    trace.start()            # every span, handed over by stop()
    trace.start(keep=False)  # folded totals only, in constant memory
    ...                      # DsrcModule.compress / .decompress calls
    rec = trace.stop()       # a Recording

A span records its name, its perf_counter_ns start and end, its parent (the
span open on the same thread, or the one given as `under=`), the
DsrcModule call it belongs to (`op`: the calls' spans share it, on every
thread), its block, its thread and a byte count.  Spans live in lists of
their own thread; the lock is taken once a thread a session.  Each span's
self time is its duration less the time its children on the same thread
cover; totals fold durations, self times, counts and bytes by (op, name),
as spans close when only totals are kept, else from the spans.

The names, at the layer boundaries of the port:

  op.compress, op.decompress  DsrcModule.compress / .decompress, the root
  api.analyze      the dataset analysis of the first block
  api.read         the next block from the chunker or the archive
  api.write        a block written to the archive or the FASTQ output
  api.wait         the calling thread blocked on the workers' results
  block            one block job, inline or on a worker (block, FASTQ
                   bytes)
  codec.compress, codec.decompress   BlockCodec.compress / .decompress
  codec.stage      host staging and parsing, and the uploads
  codec.tag        title coding (the tag coder, the value-field planes)
  codec.model      issuing the device pipeline (the positional and
                   context-model coders, the transforms)
  codec.serialize  the bit writers and readers, the FASTQ text layout
  codec.sync       one read of device values by the host (ops/streams.py:
                   to_numpy, item), with its bytes; a leaf

The codec.stage, .tag, .model and .serialize spans of one block do not
nest in one another.  The syncs are the count and bytes of codec.sync.

A count (`count(name)`) has no duration and is not a span: it adds to its
name's count in the totals, under the call of the span open on its thread,
and shows in table() with no time.  The counts:

  dna.<scheme>     the bases of a block's DNA stream that scheme <scheme>
                   (models/dna.py: EMPTY, PACK2, CTX4, CTX8, CTX4P, CTX8P,
                   A19, RAW) coded or decoded
  api.read_ahead   the blocks (archive blobs in a decompress) the reader
                   thread had queued when block 0's job returned on the
                   calling thread, once a call (parallel/pipeline.py)

Clock: start() takes one (perf_counter_ns, time_ns) pair, `anchor`.  A
Chrome trace exported by torch.profiler (Kineto) stamps its events in
wall-clock microseconds less its `baseTimeNanoseconds`, so
`trace_us(t_ns, anchor, base_ns)` puts a span's time on that clock.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

SYNC = "codec.sync"

_on = False
_keep = False
_session = 0
_anchor = (0, 0)
_local = threading.local()
_lock = threading.Lock()
_buffers: List["_Buffer"] = []
_ids = itertools.count(1)
_ops = itertools.count(1)


class Span(NamedTuple):
    """One closed span.  parent: the id of its parent span, 0 for none;
    op: the DsrcModule call, 0 outside one; block: -1 for none; tid:
    threading.get_ident() of its thread."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    op: int
    block: int
    tid: int
    nbytes: int


class Total(NamedTuple):
    """Spans of one name folded: summed durations and self times in
    seconds (over threads), their count and bytes."""
    seconds: float
    self_seconds: float
    count: int
    nbytes: int


class Recording(NamedTuple):
    """What one session recorded.  spans: every span, in no order (empty
    when started with keep=False); totals: by (op, name); anchor:
    (perf_counter_ns, time_ns) read together at start()."""
    spans: List[Span]
    totals: Dict[Tuple[int, str], Total]
    anchor: Tuple[int, int]

    def by_name(self, op: Optional[int] = None) -> Dict[str, Total]:
        """Totals by name, over every call (op None) or of one call."""
        return fold(self.totals, op)

    def syncs(self, op: Optional[int] = None) -> Tuple[int, int]:
        """(reads of device values, their bytes), over every call or of
        one."""
        t = self.by_name(op).get(SYNC)
        return (t.count, t.nbytes) if t else (0, 0)


class _Buffer:
    """One thread's closed spans (Span's fields and the self time, as
    plain tuples) or totals, and its open-span stack, in one session."""
    __slots__ = ("session", "tid", "stack", "spans", "totals")

    def __init__(self, session: int):
        self.session = session
        self.tid = threading.get_ident()
        self.stack: List["_Open"] = []
        self.spans: List[tuple] = []
        self.totals: Dict[Tuple[int, str], list] = {}


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None or buf.session != _session:
        buf = _local.buf = _Buffer(_session)
        with _lock:
            if buf.session == _session:
                _buffers.append(buf)
    return buf


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span while it is open; `with` gives it back, to pass as `under=`
    to spans that run on other threads."""
    __slots__ = ("name", "nbytes", "block", "op", "parent", "id", "t0",
                 "child", "buf")

    def __init__(self, name: str, nbytes: int, block: int,
                 under: Optional["_Open"], op: int = 0):
        self.name = name
        self.nbytes = nbytes
        self.block = block
        self.op = op
        self.parent = under

    def __enter__(self) -> "_Open":
        buf = self.buf = _buffer()
        up = self.parent if self.parent is not None else (
            buf.stack[-1] if buf.stack else None)
        if up is not None:
            self.parent = up.id
            if not self.op:
                self.op = up.op
            if self.block < 0:
                self.block = up.block
        else:
            self.parent = 0
        self.id = next(_ids)
        self.child = 0
        buf.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        buf = self.buf
        buf.stack.pop()
        dur = t1 - self.t0
        if buf.stack:
            buf.stack[-1].child += dur
        if _keep:
            buf.spans.append((self.name, self.t0, t1, self.id, self.parent,
                              self.op, self.block, buf.tid, self.nbytes,
                              dur - self.child))
            return False
        tot = buf.totals.get((self.op, self.name))
        if tot is None:
            tot = buf.totals[(self.op, self.name)] = [0, 0, 0, 0]
        tot[0] += dur
        tot[1] += dur - self.child
        tot[2] += 1
        tot[3] += self.nbytes
        return False


def span(name: str, nbytes: int = 0, block: int = -1, under=None):
    """A context for one span of `name` (the names in the module's doc).
    under: the span, open on another thread, that this one runs for (its
    parent and call); block and op are otherwise the parent's."""
    if not _on:
        return _NULL
    return _Open(name, nbytes, block, under)


def op(kind: str):
    """The root span of one DsrcModule call, "op.<kind>", with a new call
    id."""
    if not _on:
        return _NULL
    return _Open("op." + kind, 0, -1, None, next(_ops))


def sync(t):
    """A codec.sync span for a read of tensor `t` by the host."""
    if not _on:
        return _NULL
    return _Open(SYNC, t.nelement() * t.element_size(), -1, None)


def count(name: str, n: int = 1) -> None:
    """Add n to the count of `name` (no duration, not a span)."""
    if not _on:
        return
    buf = _buffer()
    key = (buf.stack[-1].op if buf.stack else 0, name)
    tot = buf.totals.get(key)
    if tot is None:
        tot = buf.totals[key] = [0, 0, 0, 0]
    tot[2] += n


def current():
    """The innermost span open on this thread (None: none, or the recorder
    is off), to pass as `under=` to work handed to other threads."""
    if not _on:
        return None
    buf = _buffer()
    return buf.stack[-1] if buf.stack else None


def active() -> bool:
    return _on


def start(keep: bool = True) -> None:
    """Turn the recorder on (a new session; what an earlier session held
    is dropped).  keep: every span, else only the folded totals."""
    global _on, _keep, _session, _anchor
    with _lock:
        _session += 1
        _buffers.clear()
        _keep = keep
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        _anchor = ((p0 + p1) // 2, wall)
        _on = True


def stop() -> Recording:
    """Turn the recorder off and hand over what the session recorded (its
    totals stay readable by totals() until the next start())."""
    global _on
    with _lock:
        _on = False
        bufs = list(_buffers)
    return Recording([Span(*s[:9]) for b in bufs for s in list(b.spans)],
                     _merge(bufs), _anchor)


def totals(op: Optional[int] = None) -> Dict[str, Total]:
    """The current or last session's totals by name, over every call or
    of one."""
    with _lock:
        bufs = list(_buffers)
    return fold(_merge(bufs), op)


def _merge(bufs) -> Dict[Tuple[int, str], Total]:
    acc: Dict[Tuple[int, str], list] = {}
    for b in bufs:
        folded = [((s[5], s[0]), (s[2] - s[1], s[9], 1, s[8]))
                  for s in list(b.spans)]
        for key, t in folded + list(b.totals.items()):
            a = acc.setdefault(key, [0, 0, 0, 0])
            for i in range(4):
                a[i] += t[i]
    return {k: Total(v[0] / 1e9, v[1] / 1e9, v[2], v[3])
            for k, v in acc.items()}


def fold(totals: Dict[Tuple[int, str], Total],
         op: Optional[int] = None) -> Dict[str, Total]:
    """Totals by (op, name) -> by name, over every call or of one."""
    acc: Dict[str, list] = {}
    for (o, name), t in totals.items():
        if op is None or o == op:
            a = acc.setdefault(name, [0.0, 0.0, 0, 0])
            for i, v in enumerate(t):
                a[i] += v
    return {k: Total(*v) for k, v in acc.items()}


def trace_us(t_ns: int, anchor: Tuple[int, int], base_ns: int) -> float:
    """A perf_counter_ns time on the clock of a Kineto Chrome trace whose
    baseTimeNanoseconds is base_ns, in microseconds."""
    return (t_ns - anchor[0] + anchor[1] - base_ns) / 1e3


def table(rec: Recording, op: Optional[int] = None) -> List[str]:
    """-v's lines: each span name's self seconds (summed over threads),
    count and MB, and each count's, then the syncs."""
    lines = [f"{'span':18s} {'self s':>9s} {'count':>8s} {'MB':>10s}"]
    for name, t in sorted(rec.by_name(op).items()):
        lines.append(f"{name:18s} {t.self_seconds:9.3f} {t.count:8d} "
                     f"{t.nbytes / (1 << 20):10.1f}")
    n, nb = rec.syncs(op)
    lines.append(f"device-to-host reads: {n} ({nb / (1 << 20):.1f} MB)")
    return lines
