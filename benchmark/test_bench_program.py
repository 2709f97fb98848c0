"""The metrics that read the program's own spans and counts
(yardstick/program.py; metrics/stage_ms_per_MiB.py, syncs_per_MiB.py,
block0_share.py, api_ms_per_MiB.py, read_ahead.py) on fixed spans, and tiny
windows on the CPU: a traced one, whose run carries what the program's
recorder kept (yardstick/cell.run_window), and an untraced one, which
never turns it on."""
from __future__ import annotations

import copy
import json
import os
import time
from typing import NamedTuple

import pytest
from conftest import BENCH_DIR, ROOT
from yardstick import program, record, spec
from yardstick.record import MIB, Op, Run, Span, Trace

import stages as S

NAME_RE = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
# the readers of the program's spans and counts, by family
PROGRAM_FAMILIES = ("stage_ms_per_MiB", "syncs_per_MiB", "block0_share",
                    "api_ms_per_MiB", "read_ahead")


class T(NamedTuple):
    """A recorder total, as the program folds one (its count is read)."""
    seconds: float
    self_seconds: float
    count: int
    nbytes: int


class P(NamedTuple):
    """A program span as the recorder hands it over."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    op: int
    block: int
    tid: int
    nbytes: int = 0


def _ns(s: float) -> int:
    return round(s * 1e9)


def _spans():
    """Call 1 (compress, inside operation 0): block 0 inline on thread 10,
    block 1 on worker thread 11, a read on reader thread 12; call 2
    (decompress, inside operation 1), with a write; call 3 inside no
    operation."""
    m = _ns
    return [
        P("op.compress", m(0.1), m(1.9), 1, 0, 1, -1, 10),
        P("block", m(0.2), m(1.0), 2, 1, 1, 0, 10, MIB // 2),
        P("codec.compress", m(0.2), m(1.0), 3, 2, 1, 0, 10),
        P("codec.stage", m(0.2), m(0.4), 4, 3, 1, 0, 10),
        P("codec.sync", m(0.3), m(0.35), 5, 4, 1, 0, 10, 8),
        P("codec.model", m(0.5), m(0.9), 6, 3, 1, 0, 10),
        P("codec.sync", m(0.6), m(0.7), 7, 6, 1, 0, 10, 4),
        P("block", m(0.3), m(1.5), 8, 1, 1, 1, 11, MIB // 2),
        P("codec.compress", m(0.3), m(1.5), 9, 8, 1, 1, 11),
        P("codec.tag", m(0.4), m(1.4), 10, 9, 1, 1, 11),
        P("api.wait", m(1.0), m(1.5), 11, 1, 1, -1, 10),
        P("op.decompress", m(2.1), m(2.9), 12, 0, 2, -1, 10),
        P("block", m(2.1), m(2.5), 13, 12, 2, 0, 10, MIB),
        P("codec.decompress", m(2.1), m(2.5), 14, 13, 2, 0, 10),
        P("codec.serialize", m(2.2), m(2.4), 15, 14, 2, 0, 10),
        P("codec.sync", m(2.3), m(2.35), 16, 15, 2, 0, 10, 2),
        P("op.compress", m(5.0), m(6.0), 17, 0, 3, -1, 10),
        P("codec.sync", m(5.1), m(5.2), 18, 17, 3, -1, 10),
        P("api.read", m(0.15), m(0.25), 19, 1, 1, -1, 12, MIB // 2),
        P("api.write", m(2.6), m(2.8), 20, 12, 2, -1, 10, MIB),
    ]


def _totals():
    """The counts of api.read_ahead: call 1 queued 2, call 2 one, call 3
    (inside no operation) 5."""
    return {(1, "api.read_ahead"): T(0.0, 0.0, 2, 0),
            (2, "api.read_ahead"): T(0.0, 0.0, 1, 0),
            (3, "api.read_ahead"): T(0.0, 0.0, 5, 0),
            (1, "codec.sync"): T(0.15, 0.15, 2, 12)}


def _run(with_program: bool = True) -> Run:
    ops = [Op(0, "compress", 0.0, 2.0, MIB, MIB // 4),
           Op(1, "decompress", 2.0, 3.0, MIB)]
    tr = Trace([(100.0, 200.0, "kernel")], {0: (1e6, 3e6), 1: (3e6, 4e6)},
               [])
    run = Run(ops, [Span("compress", 0, 0.2, 1.0),
                    Span("compress", 0, 0.3, 1.5),
                    Span("decompress", 1, 2.1, 2.5)], [], tr)
    if with_program:
        # perf_counter 0 is the trace's 1e6 us: wall - perf - base = 1e9 ns
        run.program = program.Program(_spans(), (0, 10 ** 9 + 5), 5,
                                      _totals())
    return run


def _program_metrics():
    """BENCHMARK.json's per-layer entries that read the program."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per = json.load(f)["per_layer"]
    return [m for m in per if m["name"].split(".")[0] in PROGRAM_FAMILIES]


def test_self_time_of_nested_spans_on_two_threads():
    own = program.self_ns(_spans())
    assert own[3] == _ns(0.2)         # 0.8 s less stage and model
    assert own[4] == _ns(0.15) and own[6] == _ns(0.3)
    assert own[9] == _ns(0.2)         # worker's codec less its tag
    # thread 11's block is not taken off thread 10's root
    assert own[1] == _ns(1.8) - _ns(0.8) - _ns(0.5)


def test_calls_matched_to_operations_by_containment():
    run = _run()
    assert program.op_of_calls(run, run.program) == {1: 0, 2: 1}


def test_stage_ms_per_mib():
    run = _run()
    got = {s: program.stage_ms_per_mib(run, s, "compress")
           for s in program.STAGES + ("other",)}
    assert got == pytest.approx({"stage": 150.0, "tag": 1000.0,
                                 "model": 300.0, "sync": 150.0,
                                 "serialize": 0.0, "other": 400.0})
    # the six add up to the codec's span ms a MiB
    assert sum(got.values()) == pytest.approx(
        record.codec_ms_per_mib(run, "compress"))
    dec = {s: program.stage_ms_per_mib(run, s, "decompress")
           for s in program.STAGES + ("other",)}
    assert dec == pytest.approx({"stage": 0.0, "tag": 0.0, "model": 0.0,
                                 "sync": 50.0, "serialize": 150.0,
                                 "other": 200.0})


def test_syncs_and_block0_share():
    run = _run()
    assert program.syncs_per_mib(run, "compress") == 2
    assert program.syncs_per_mib(run, "decompress") == 1
    assert program.block0_share(run, "compress") == pytest.approx(0.4)
    assert program.block0_share(run, "decompress") == pytest.approx(0.4)


def test_anchor_puts_spans_on_the_trace_clock():
    run = _run()
    assert program.offset_us(run.program) == pytest.approx(1e6)
    ev = program.host_events(run.program)
    assert ev[0] == (pytest.approx(1.1e6), pytest.approx(2.9e6),
                     "op.compress")
    # the calling thread's wait names no gap unless asked for
    assert "api.wait" not in {e[2] for e in ev}
    assert len(program.host_events(run.program, waits=True)) == \
        len(ev) + 1
    run.program.base_ns = None
    assert program.host_events(run.program) == []


def test_api_span_ms_and_read_ahead_count():
    run = _run()
    api = {n: spec.load_reader(BENCH_DIR, n)[1]
           for n in ("api_ms_per_MiB.read.compress",
                     "api_ms_per_MiB.write.decompress",
                     "read_ahead.compress", "read_ahead.decompress")}
    assert api["api_ms_per_MiB.read.compress"](run) == pytest.approx(100.0)
    assert api["api_ms_per_MiB.write.decompress"](run) == \
        pytest.approx(200.0)
    # by the call that each operation holds; call 3's count is no one's
    assert api["read_ahead.compress"](run) == 2.0
    assert api["read_ahead.decompress"](run) == 1.0
    assert [n for n, _ in program.call_counts(run, "api.read_ahead",
                                              "compress")] == [2]
    assert program.call_counts(run, "dna.A19", "compress") is None
    assert program.span_ms_per_mib(run, "api.write", "compress") is None
    # a call of the kind that counted nothing reads 0 beside one that did
    del run.program.totals[(2, "api.read_ahead")]
    assert api["read_ahead.decompress"](run) is None
    run.ops.append(Op(2, "decompress", 2.05, 3.0, MIB))
    run.program.spans.append(P("op.decompress", _ns(2.06), _ns(2.09), 21,
                               0, 4, -1, 10))
    run.program.totals[(4, "api.read_ahead")] = T(0.0, 0.0, 3, 0)
    assert sorted(n for n, _ in program.call_counts(
        run, "api.read_ahead", "decompress")) == [0, 3]


def test_readers_by_name_and_none_without_the_program():
    import re
    names = [m["name"] for m in _program_metrics()]
    assert len(names) == 20
    assert {m["source"] for m in _program_metrics()} == {
        "program_span", "program_counter"}
    with_p, without = _run(), _run(False)
    for name in names:
        assert re.match(NAME_RE, name)
        _, read = spec.load_reader(BENCH_DIR, name)
        assert read(without) is None
        assert read(with_p) is not None
    empty = _run()
    empty.program = program.Program([], (0, 0), 0)
    assert all(spec.load_reader(BENCH_DIR, n)[1](empty) is None
               for n in names)


def test_existing_metrics_do_not_move_with_program_spans():
    """The metrics that read the benchmark's own spans and the trace read
    the same with the program's spans beside them; the breakdown's device
    operations and idle seconds are the same, only named otherwise."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per = json.load(f)["per_layer"]
    plain, prog = _run(False), _run()
    for m in per:
        if m["name"].split(".")[0] in PROGRAM_FAMILIES:
            continue
        _, read = spec.load_reader(BENCH_DIR, m["name"])
        assert read(copy.deepcopy(plain)) == read(prog), m["name"]
    a, b = record.breakdown(plain), record.breakdown(prog)
    assert a["device_ops"] == b["device_ops"]
    assert sum(v for _, v in a["idle_gaps"]) == pytest.approx(
        sum(v for _, v in b["idle_gaps"]))


def test_breakdown_names_idle_gaps_by_program_spans():
    """With the program's spans, a gap is named by the program span that
    started last among those running at its middle (the calling thread's
    wait left out); without them, by the benchmark's BlockCodec spans."""
    gaps = dict(record.breakdown(_run())["idle_gaps"])
    assert gaps["compress: codec.tag"] == pytest.approx(2.0)
    dec = [k for k in gaps if k.startswith("decompress: ")]
    assert len(dec) == 1 and gaps[dec[0]] == pytest.approx(1.0)
    assert dec[0].split(": ")[1] in {"op.decompress", "block",
                                     "codec.decompress"}
    plain = dict(record.breakdown(_run(False))["idle_gaps"])
    assert plain["compress: BlockCodec.compress"] == pytest.approx(2.0)
    no_base = _run()
    no_base.program.base_ns = None
    assert dict(record.breakdown(no_base)["idle_gaps"]) == plain


@pytest.fixture(scope="module")
def traced_tiny(tiny_root):
    """One traced tiny round trip on the CPU: (cell, outcome)."""
    import torch
    from yardstick import cell as C
    c = spec.load_cell("tiny-m0-umi-rt", *tiny_root)
    out = C.run_window(c, 11, 0.0, True, torch.device("cpu"),
                       time.perf_counter())
    return c, out


def test_cpu_window_with_the_recorder(traced_tiny):
    """A traced tiny round trip on the CPU carries the program's recording
    from run_window itself: the anchor agrees with record.trace_offset_us
    (the median of the operations' starts), the stage metrics add up to
    codec_ms_per_MiB, and the idle seconds of the breakdown are named by
    the program's spans."""
    _, out = traced_tiny
    run = out.run
    assert run.program is not None and run.trace.base_ns is not None
    assert run.program.base_ns == run.trace.base_ns
    res = S.program_part(run, run.program)
    assert abs(res["offset_us"]["anchor_less_estimate_ms"]) < 1.0
    for k in S.OPS:
        assert res["stage_sum_ms_per_MiB"][k] == pytest.approx(
            res["codec_ms_per_MiB"][k], rel=0.05)
        assert program.syncs_per_mib(run, k) > 0
        assert 0 < program.block0_share(run, k) < 1
    assert res["syncs"] > 0 and res["spans"] > res["syncs"]
    # on the CPU each operation is one idle gap, named at its middle: by a
    # program span or a torch operation started inside it
    named = dict(record.breakdown(run)["idle_gaps"])
    plain = S.idle_by_name(run)
    assert sum(named.values()) == pytest.approx(sum(plain.values()))
    assert all(n.split(": ")[0] in S.OPS for n in named)
    assert not any(n.endswith("BlockCodec.compress")
                   or n.endswith("BlockCodec.decompress") for n in named)
    spans = {s.name for s in run.program.spans}
    assert any(n.split(": ", 1)[1] in spans for n in named)


def test_traced_window_reads_every_program_metric(traced_tiny):
    """Through cell.metrics, as run.py reports them: every reader of the
    program's spans and counts gives a number, and the six stages add up
    to codec_ms_per_MiB."""
    from yardstick import cell as C
    c, out = traced_tiny
    got = C.metrics(c, out, True)
    for m in _program_metrics():
        assert isinstance(got[m["name"]]["value"], float), m["name"]
        assert got[m["name"]]["unit"] == m["unit"]
    for k in S.OPS:
        stages = sum(got[f"stage_ms_per_MiB.{s}.{k}"]["value"]
                     for s in S.STAGE_NAMES)
        assert stages == pytest.approx(
            got[f"codec_ms_per_MiB.{k}"]["value"], rel=0.05)


def test_read_ahead_counts_the_blocks_after_block_0(traced_tiny):
    """The count reader: the reader thread had every block after block 0
    queued when block 0's job returned (three blocks of the tiny input)."""
    from yardstick import cell as C
    c, out = traced_tiny
    blocks = C._num_blocks(out.archives[0])
    assert blocks == 3
    got = C.metrics(c, out, True)
    assert got["read_ahead.compress"]["value"] == blocks - 1
    assert 0 <= got["read_ahead.decompress"]["value"] <= blocks - 1


def test_untraced_window_leaves_the_recorder_off(tiny_root, monkeypatch):
    """An untraced window never turns the program's recorder on: it is off
    inside every operation, and the run carries no program."""
    import torch
    from dsrc_tpu_torch import DsrcModule
    from dsrc_tpu_torch.utils import trace as ptrace
    from yardstick import cell as C
    seen = []
    for name in ("compress", "decompress"):
        real = getattr(DsrcModule, name)

        def spy(self, *a, _real=real, **k):
            seen.append(ptrace.active())
            return _real(self, *a, **k)
        monkeypatch.setattr(DsrcModule, name, spy)
    c = spec.load_cell("tiny-m0-semi-rt", *tiny_root)
    out = C.run_window(c, 13, 0.0, False, torch.device("cpu"),
                       time.perf_counter())
    # the warm round trip and the window's
    assert len(seen) == 4 and not any(seen)
    assert out.run.program is None and out.run.trace is None
    got = C.metrics(c, out, False)
    assert set(got) == {m.name for m in c.end_to_end}
