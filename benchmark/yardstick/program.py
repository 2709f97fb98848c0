"""The program's own spans and counts (dsrc_tpu_torch/utils/trace.py) in a
run, and the arithmetic of the metrics that read them.

A traced run (yardstick/cell.run_window) turns the program's recorder on
just before its window and off as it closes, inside the profiler session,
and keeps what it recorded as the run's `program` (a Program): the
recorder's spans, its totals (the counts among them), its clock anchor and
the trace's baseTimeNanoseconds.  An untraced run never turns it on.  A
run without a program, or a program without spans, gives no metric: each
reader returns None.

The span names are the program's: op.compress / op.decompress (one a
DsrcModule call), api.read / api.write / api.wait / api.analyze, block
(one a block job), codec.compress / codec.decompress (BlockCodec), below
them the stages codec.stage, codec.tag, codec.model, codec.serialize and
the leaf codec.sync (one read of device values by the host).  Its counts
(api.read_ahead, dna.<scheme>) live in the totals, by (call, name).  A
reader of a new span or count is a file under metrics/ that calls these
helpers.  Nothing here needs a card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .record import MIB, Op, Run

STAGES = ("stage", "tag", "model", "sync", "serialize")
SYNC = "codec.sync"
# the calling thread blocked on the workers: a wait, not host work
WAITS = ("api.wait",)


@dataclasses.dataclass
class Program:
    """spans: the recorder's spans (name, start_ns, end_ns, id, parent, op,
    block, tid, nbytes; perf_counter_ns); anchor: (perf_counter_ns,
    time_ns) read together when the recorder started; base_ns: the device
    trace's baseTimeNanoseconds (None without a trace); totals: the
    recorder's totals by (op, name), each with a `count` (the spans of
    that name in the call, or what the program counted under it)."""
    spans: list
    anchor: Tuple[int, int]
    base_ns: Optional[int] = None
    totals: dict = dataclasses.field(default_factory=dict)


class Recorder:
    """The program's recorder on, every span kept, for the length of a
    `with` block; program(base_ns) then gives what it recorded."""

    def __init__(self):
        self.recording = None

    def __enter__(self) -> "Recorder":
        from dsrc_tpu_torch.utils import trace
        trace.start(keep=True)
        return self

    def __exit__(self, *exc):
        from dsrc_tpu_torch.utils import trace
        self.recording = trace.stop()
        return False

    def program(self, base_ns: Optional[int]) -> Program:
        rec = self.recording
        return Program(rec.spans, rec.anchor, base_ns, dict(rec.totals))


def of(run: Run) -> Optional[Program]:
    prog = getattr(run, "program", None)
    return prog if prog is not None and prog.spans else None


def offset_us(prog: Program) -> Optional[float]:
    """The trace's clock less the host clock (perf_counter), in us, by the
    anchor: Kineto stamps wall-clock us less baseTimeNanoseconds."""
    if prog.base_ns is None:
        return None
    return (prog.anchor[1] - prog.anchor[0] - prog.base_ns) / 1e3


def op_of_calls(run: Run, prog: Program) -> Dict[int, int]:
    """Each program call (the op of its op.* root span) -> the index of the
    window's operation of that kind whose host-clock interval contains
    it."""
    out = {}
    for s in prog.spans:
        if not s.name.startswith("op."):
            continue
        kind = s.name[3:]
        a, b = s.start_ns / 1e9, s.end_ns / 1e9
        for o in run.ops:
            if o.kind == kind and o.start <= a and b <= o.end:
                out[s.op] = o.index
                break
    return out


def self_ns(spans) -> Dict[int, int]:
    """Each span's duration less the time its children on its own thread
    cover."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    tid = {s.id: s.tid for s in spans}
    for s in spans:
        if s.parent in own and tid[s.parent] == s.tid:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def _of_kind(run: Run, prog: Program, kind: str):
    """(the program's spans of the calls matched to ok operations of this
    kind, those operations)."""
    calls = op_of_calls(run, prog)
    ops = {o.index: o for o in run.of_kind(kind)}
    mine = {c for c, i in calls.items() if i in ops}
    return [s for s in prog.spans if s.op in mine], \
        [ops[calls[c]] for c in mine]


def _codec_descendants(spans, kind: str) -> List:
    """The spans below a codec.<kind> span on its thread, and those spans."""
    by_id = {s.id: s for s in spans}
    top = "codec." + kind
    out = []
    for s in spans:
        up = s
        while up is not None and up.name != top:
            up = by_id.get(up.parent)
            if up is not None and up.tid != s.tid:
                up = None
        if up is not None:
            out.append(s)
    return out


def stage_ms_per_mib(run: Run, stage: str, kind: str) -> Optional[float]:
    """Self ms of codec.<stage> spans below codec.<kind> ("other": the self
    ms of codec.<kind> itself), summed over the operations of this kind,
    a FASTQ MiB."""
    prog = of(run)
    if prog is None:
        return None
    spans, ops = _of_kind(run, prog, kind)
    mib = sum(o.fastq_bytes for o in ops) / MIB
    if not ops or mib <= 0:
        return None
    name = "codec." + (kind if stage == "other" else stage)
    below = _codec_descendants(spans, kind)
    if not below:
        return None
    own = self_ns(spans)
    return sum(own[s.id] for s in below if s.name == name) / 1e6 / mib


def syncs_per_mib(run: Run, kind: str) -> Optional[float]:
    """Reads of device values by the host (codec.sync spans) in the
    operations of this kind, a FASTQ MiB."""
    prog = of(run)
    if prog is None:
        return None
    spans, ops = _of_kind(run, prog, kind)
    mib = sum(o.fastq_bytes for o in ops) / MIB
    if not ops or mib <= 0:
        return None
    return sum(1 for s in spans if s.name == SYNC) / mib


def span_ms_per_mib(run: Run, name: str, kind: str) -> Optional[float]:
    """Summed ms of the program's spans named `name` (on every thread) in
    the operations of this kind, a FASTQ MiB."""
    prog = of(run)
    if prog is None:
        return None
    spans, ops = _of_kind(run, prog, kind)
    mib = sum(o.fastq_bytes for o in ops) / MIB
    mine = [s for s in spans if s.name == name]
    if not ops or not mine or mib <= 0:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) / 1e6 / mib


def call_counts(run: Run, name: str, kind: str
                ) -> Optional[List[Tuple[int, Op]]]:
    """The program's count `name` in each call matched to an operation of
    this kind (op_of_calls, as the spans are), with that operation; 0 in a
    call that did not count it.  None where no such call counted it."""
    prog = of(run)
    if prog is None:
        return None
    calls = op_of_calls(run, prog)
    ops = {o.index: o for o in run.of_kind(kind)}
    mine = sorted(c for c, i in calls.items() if i in ops)
    if not any((c, name) in prog.totals for c in mine):
        return None
    return [(prog.totals[(c, name)].count if (c, name) in prog.totals
             else 0, ops[calls[c]]) for c in mine]


def block0_share(run: Run, kind: str) -> Optional[float]:
    """Seconds of block 0's block span (inline, before the workers start)
    over the operations' wall seconds."""
    prog = of(run)
    if prog is None:
        return None
    spans, ops = _of_kind(run, prog, kind)
    wall = sum(o.seconds for o in ops)
    b0 = [s for s in spans if s.name == "block" and s.block == 0]
    if not ops or not b0 or wall <= 0:
        return None
    return sum(s.end_ns - s.start_ns for s in b0) / 1e9 / wall


def host_events(prog: Program, waits: bool = False
                ) -> List[Tuple[float, float, str]]:
    """The program's spans as host events on the trace's clock, by the
    anchor: (start_us, end_us, name).  Without waits (api.wait) unless
    asked: record.breakdown names a gap by the event that started last
    among those running, and the calling thread's wait, entered again after
    each block it takes, would otherwise name the gaps in which the
    workers' codec runs."""
    off = offset_us(prog)
    if off is None:
        return []
    return [(s.start_ns / 1e3 + off, s.end_ns / 1e3 + off, s.name)
            for s in prog.spans if waits or s.name not in WAITS]
