"""What one run recorded, and the arithmetic that turns it into metrics.

Host times are time.perf_counter seconds; device events and the operations'
windows in the trace are in the trace's microseconds.  Nothing here needs
a card: the tests drive it with fixed spans and events.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import statistics
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

from . import work

if TYPE_CHECKING:
    from .program import Program

MIB = 1 << 20


@dataclasses.dataclass
class Op:
    """One operation of the window: "compress" or "decompress".
    fastq_bytes: the FASTQ bytes it read (compress) or wrote
    (decompress); archive_bytes: the archive it wrote (compress)."""
    index: int
    kind: str
    start: float
    end: float
    fastq_bytes: int
    archive_bytes: int = 0
    ok: bool = True

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Span:
    """A call of BlockCodec.compress or .decompress inside operation op."""
    kind: str
    op: int
    start: float
    end: float


@dataclasses.dataclass
class Call:
    """One call of a hand-written kernel inside operation op: the bytes and
    integer operations its algorithm needs."""
    op: int
    kernel: str
    nbytes: int
    nops: int


@dataclasses.dataclass
class Trace:
    """The device trace of the window: device events (kernels, copies,
    sets) of the program as (start_us, end_us, name), sorted by start;
    each operation's window by its index; host events (start_us, end_us,
    name), sorted by start, to say what the host was doing; base_ns: the
    Chrome trace's baseTimeNanoseconds (its clock is wall-clock us less
    it), None where the trace gave none."""
    device: List[Tuple[float, float, str]]
    ops: Dict[int, Tuple[float, float]]
    host: List[Tuple[float, float, str]]
    base_ns: Optional[int] = None


@dataclasses.dataclass
class Run:
    """program: what the program's own recorder kept over the window (a
    traced run's; yardstick/program.py), None in an untraced run."""
    ops: List[Op]
    spans: List[Span] = dataclasses.field(default_factory=list)
    calls: List[Call] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None
    peaks: Optional[work.Peaks] = None
    program: Optional["Program"] = None

    def of_kind(self, kind: str) -> List[Op]:
        return [o for o in self.ops if o.kind == kind and o.ok]


# ---------------------------------------------------------------- end to end

def rate_mibps(run: Run, kind: str) -> Optional[float]:
    """FASTQ MiB over the seconds of every operation of this kind."""
    ops = run.of_kind(kind)
    secs = sum(o.seconds for o in ops)
    if not ops or secs <= 0:
        return None
    return sum(o.fastq_bytes for o in ops) / MIB / secs


def ratio(run: Run) -> Optional[float]:
    """FASTQ bytes over archive bytes, over every compress."""
    ops = run.of_kind("compress")
    arch = sum(o.archive_bytes for o in ops)
    return sum(o.fastq_bytes for o in ops) / arch if arch else None


# ------------------------------------------------------ the benchmark's spans

def _codec_seconds(run: Run, kind: str) -> Tuple[float, List[Op]]:
    ops = run.of_kind(kind)
    ids = {o.index for o in ops}
    return sum(s.end - s.start for s in run.spans
               if s.op in ids), ops


def codec_overlap(run: Run, kind: str) -> Optional[float]:
    """Summed BlockCodec seconds over the operations' wall seconds: how
    many blocks are in the codec at once, on average."""
    codec, ops = _codec_seconds(run, kind)
    wall = sum(o.seconds for o in ops)
    return codec / wall if ops and codec > 0 and wall > 0 else None


def codec_ms_per_mib(run: Run, kind: str) -> Optional[float]:
    """Summed BlockCodec milliseconds over the operations' FASTQ MiB."""
    codec, ops = _codec_seconds(run, kind)
    mib = sum(o.fastq_bytes for o in ops) / MIB
    return codec * 1e3 / mib if ops and codec > 0 and mib > 0 else None


# ------------------------------------------------------------ the device trace

def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of intervals."""
    total, end = 0.0, -math.inf
    for s, t in sorted(intervals):
        if t > end:
            total += t - max(s, end)
            end = t
    return total


def device_events(run: Run, kind: Optional[str] = None
                  ) -> List[Tuple[float, float, str]]:
    """The trace's device events that start inside an operation of this
    kind (every kind: None)."""
    tr = run.trace
    if tr is None:
        return []
    wins = sorted(tr.ops[o.index] for o in run.ops
                  if (kind is None or o.kind == kind) and o.index in tr.ops)
    starts = [w[0] for w in wins]
    out = []
    for ev in tr.device:
        i = bisect.bisect_right(starts, ev[0]) - 1
        if i >= 0 and ev[0] <= wins[i][1]:
            out.append(ev)
    return out


def _traced_mib(run: Run, kind: str) -> float:
    tr = run.trace
    return sum(o.fastq_bytes for o in run.of_kind(kind)
               if tr is not None and o.index in tr.ops) / MIB


def launches_per_mib(run: Run, kind: str) -> Optional[float]:
    """Device kernels, copies and sets a FASTQ MiB."""
    evs, mib = device_events(run, kind), _traced_mib(run, kind)
    return len(evs) / mib if evs and mib > 0 else None


def device_busy_ms_per_mib(run: Run, kind: str) -> Optional[float]:
    """Milliseconds in which the device ran anything, a FASTQ MiB."""
    evs, mib = device_events(run, kind), _traced_mib(run, kind)
    if not evs or mib <= 0:
        return None
    return busy_us((s, t) for s, t, _ in evs) / 1e3 / mib


def kernel_device_s(run: Run, kernel: work.Kernel, kind: str) -> float:
    return sum(t - s for s, t, name in device_events(run, kind)
               if kernel.matches(name)) / 1e6


def roofline_share(run: Run, kernel: work.Kernel, kind: str
                   ) -> Optional[Tuple[float, str]]:
    """(% of the kernel's roofline, its bound) over its calls inside the
    operations of this kind."""
    if run.peaks is None:
        return None
    ids = {o.index for o in run.of_kind(kind)}
    calls = [(c.nbytes, c.nops) for c in run.calls
             if c.kernel == kernel.name and c.op in ids]
    return work.roofline(calls, kernel_device_s(run, kernel, kind),
                         run.peaks)


def window_us(run: Run) -> Optional[Tuple[float, float]]:
    """The traced window: the first operation's start to the last's end."""
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return (min(w[0] for w in tr.ops.values()),
            max(w[1] for w in tr.ops.values()))


def host_doing(host: List[Tuple[float, float, str]], starts: List[float],
               at: float) -> Optional[str]:
    """The host event that started last among those running at `at`."""
    i = bisect.bisect_right(starts, at) - 1
    while i >= 0:
        s, t, name = host[i]
        if t >= at:
            return name
        i -= 1
    return None


def trace_offset_us(run: Run) -> Optional[float]:
    """The trace's clock less the host clock's, in microseconds: the
    median over the operations of where each starts in the trace (its
    range, on the calling thread) less where it starts on the host."""
    tr = run.trace
    d = [tr.ops[o.index][0] - o.start * 1e6 for o in run.ops
         if tr is not None and o.index in tr.ops]
    return statistics.median(d) if d else None


def host_events(run: Run) -> List[Tuple[float, float, str]]:
    """What the host was doing, in the trace's clock: the trace's host
    events (torch operations on the calling thread; the profiler records
    no other thread's) and, on every thread, the program's own spans
    (yardstick/program.py: api.read, codec.tag, ...) where the run has
    them, else the benchmark's BlockCodec spans, sorted by start."""
    from . import program
    tr = run.trace
    prog = program.of(run)
    spans = program.host_events(prog) if prog is not None else []
    if not spans:
        off = trace_offset_us(run)
        spans = [] if off is None else [
            (s.start * 1e6 + off, s.end * 1e6 + off, f"BlockCodec.{s.kind}")
            for s in run.spans]
    return sorted(tr.host + spans)


def breakdown(run: Run, top: int = 10) -> Optional[dict]:
    """The device operations that took most time, and the device's idle
    time inside the operations by what the host was doing at each gap's
    middle (the host event that started last among those running then),
    both in seconds."""
    tr = run.trace
    if tr is None:
        return None
    evs = device_events(run)
    by_name: Dict[str, float] = {}
    for s, t, name in evs:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    host = host_events(run)
    starts = [h[0] for h in host]
    kinds = {o.index: o.kind for o in run.ops}
    idle: Dict[str, float] = {}
    for op, (a, b) in tr.ops.items():
        inside = sorted((max(s, a), min(t, b)) for s, t, _ in evs
                        if s < b and t > a)
        cur = a
        for s, t in inside + [(b, b)]:
            if s > cur:
                doing = host_doing(host, starts, (cur + s) / 2)
                key = f"{kinds.get(op, '?')}: {doing or 'outside the codec'}"
                idle[key] = idle.get(key, 0.0) + (s - cur) / 1e6
            cur = max(cur, t)

    def top_of(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(by_name), "idle_gaps": top_of(idle)}
