"""The metrics that read the program's own spans (yardstick/program.py,
metrics/stage_ms_per_MiB.py, syncs_per_MiB.py, block0_share.py) on fixed
spans, and a tiny traced window on the CPU with the program's recorder on
(stages.py)."""
from __future__ import annotations

import copy
import os
import time
from typing import NamedTuple

import pytest
from conftest import BENCH_DIR
from yardstick import program, record, spec, trace
from yardstick.record import MIB, Op, Run, Span, Trace

import stages as S

NAME_RE = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


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
    block 1 on worker thread 11; call 2 (decompress, inside operation 1);
    call 3 inside no operation."""
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
    ]


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
        run.program = program.Program(_spans(), (0, 10 ** 9 + 5), 5)
    return run


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


def test_readers_by_name_and_none_without_the_program():
    import re
    assert len(S.METRICS) == 16
    with_p, without = _run(), _run(False)
    for name in S.METRICS:
        assert re.match(NAME_RE, name)
        _, read = spec.load_reader(BENCH_DIR, name)
        assert read(without) is None
        assert read(with_p) is not None
    empty = _run()
    empty.program = program.Program([], (0, 0), 0)
    assert all(spec.load_reader(BENCH_DIR, n)[1](empty) is None
               for n in S.METRICS)


def test_existing_metrics_do_not_move_with_program_spans():
    import json
    from conftest import ROOT
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per = json.load(f)["per_layer"]
    plain, prog = _run(False), _run()
    for m in per:
        _, read = spec.load_reader(BENCH_DIR, m["name"])
        assert read(copy.deepcopy(plain)) == read(prog), m["name"]
    assert record.breakdown(plain) == record.breakdown(prog)


def test_cpu_window_with_the_recorder(tiny_root, monkeypatch):
    """A traced tiny round trip on the CPU with the recorder on: the anchor
    agrees with record.trace_offset_us (the median of the operations'
    starts), the stage metrics add up to codec_ms_per_MiB, and the idle
    seconds of the breakdown are named by the program's spans."""
    import torch
    from yardstick import cell as C
    monkeypatch.setattr(trace, "parse", trace.parse)
    seen = S.keep_base_time(trace)
    c = spec.load_cell("tiny-m0-umi-rt", *tiny_root)
    rec = S.Recorder()
    out = C.run_window(c, 11, 0.0, True, torch.device("cpu"),
                       time.perf_counter(), faults=rec)
    run = out.run
    run.program = program.Program(rec.rec.spans, rec.rec.anchor,
                                  seen["base_ns"])
    res = S.program_part(run, run.program)
    assert abs(res["offset_us"]["anchor_less_estimate_ms"]) < 1.0
    for k in S.OPS:
        assert res["stage_sum_ms_per_MiB"][k] == pytest.approx(
            res["codec_ms_per_MiB"][k], rel=0.05)
        assert res["metrics"][f"syncs_per_MiB.{k}"] > 0
        assert 0 < res["metrics"][f"block0_share.{k}"] < 1
    assert res["syncs"] > 0 and res["spans"] > res["syncs"]
    # on the CPU each operation is one idle gap, named at its middle: by a
    # program span or a torch operation started inside it
    named = dict(res["breakdown_with_program"])
    plain = dict(record.breakdown(run)["idle_gaps"])
    assert sum(named.values()) == pytest.approx(sum(plain.values()))
    assert all(n.split(": ")[0] in S.OPS for n in named)
