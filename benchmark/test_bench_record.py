"""The metric arithmetic on fixed spans, operations and trace events."""
from __future__ import annotations

import pytest
from yardstick import record, trace, work
from yardstick.record import MIB, Call, Op, Run, Span, Trace


def _rt_run():
    ops = [Op(0, "compress", 0.0, 2.0, 64 * MIB, 16 * MIB),
           Op(1, "decompress", 2.0, 3.0, 64 * MIB),
           Op(2, "compress", 3.0, 5.0, 64 * MIB, 16 * MIB),
           Op(3, "decompress", 5.0, 6.0, 64 * MIB),
           Op(4, "compress", 6.0, 6.5, 64 * MIB, 0, ok=False)]
    spans = [Span("compress", 0, 0.0, 1.0), Span("compress", 0, 0.5, 2.0),
             Span("decompress", 1, 2.0, 2.5),
             Span("compress", 2, 3.0, 4.0), Span("decompress", 3, 5.0, 6.0)]
    return Run(ops, spans)


def test_rates_and_ratio():
    run = _rt_run()
    assert record.rate_mibps(run, "compress") == pytest.approx(128 / 4)
    assert record.rate_mibps(run, "decompress") == pytest.approx(128 / 2)
    assert record.ratio(run) == pytest.approx(4.0)
    assert record.rate_mibps(run, "other") is None


def test_codec_spans():
    run = _rt_run()
    assert record.codec_overlap(run, "compress") == pytest.approx(3.5 / 4)
    assert record.codec_overlap(run, "decompress") == pytest.approx(0.75)
    assert record.codec_ms_per_mib(run, "compress") == \
        pytest.approx(3500 / 128)


def _traced_run():
    ops = [Op(0, "compress", 0.0, 0.001, MIB, MIB // 4),
           Op(1, "decompress", 0.001, 0.002, MIB)]
    dev = [(100.0, 200.0, "void (anonymous namespace)::rans_encode_kernel"
            "<4>(int const*)"),
           (150.0, 300.0, "Memcpy HtoD (Pageable -> Device)"),
           (1200.0, 1300.0, "void (anonymous namespace)::rans_decode_"
            "kernel<1>(int)"),
           (5000.0, 5100.0, "outside every operation")]
    tr = Trace(dev, {0: (0.0, 1000.0), 1: (1000.0, 2000.0)},
               [(400.0, 900.0, "aten::copy_")])
    calls = [Call(0, "k1", 3_350_000, 0), Call(1, "k2", 0, 0)]
    return Run(ops, [Span("compress", 0, 0.0, 0.00095)], calls, tr,
               work.Peaks(3.35e12, 1e12))


def test_device_trace_metrics():
    run = _traced_run()
    assert record.launches_per_mib(run, "compress") == 2
    assert record.launches_per_mib(run, "decompress") == 1
    assert record.device_busy_ms_per_mib(run, "compress") == \
        pytest.approx(0.2)
    assert record.busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    # K1: 3.35 MB at 3.35 TB/s is 1 us of a 100 us kernel
    share, bound = record.roofline_share(run, work.K1, "compress")
    assert share == pytest.approx(1.0) and bound == "bytes"
    assert record.roofline_share(run, work.K3, "decompress") is None
    assert record.window_us(run) == (0.0, 2000.0)


def test_breakdown():
    bd = record.breakdown(_traced_run())
    names = [n for n, _ in bd["device_ops"]]
    assert "outside every operation" not in names
    assert bd["device_ops"][0][0].startswith("Memcpy")
    idle = dict(bd["idle_gaps"])
    # compress: idle 0-100 and 300-1000 us; 0-100 inside the codec span,
    # 300-1000 at its middle (650) in aten::copy_
    assert idle["compress: aten::copy_"] == pytest.approx(700e-6)
    assert idle["compress: BlockCodec.compress"] == pytest.approx(100e-6)
    assert idle["decompress: outside the codec"] == pytest.approx(900e-6)


def test_chrome_trace_parse():
    ev = [{"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel",
           "pid": 0, "tid": 13, "ts": 1, "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "reduce_kernel",
           "pid": 0, "tid": 13, "ts": 5, "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "rans_encode_kernel",
           "pid": 0, "tid": 7, "ts": 10, "dur": 4},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "pid": 0,
           "tid": 7, "ts": 20, "dur": 2},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.op.0",
           "pid": 0, "tid": 7, "ts": 0, "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "bench.op.0",
           "pid": 1, "tid": 1, "ts": 0, "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
           "tid": 1, "ts": 2, "dur": 3},
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3}]
    tr = trace.parse({"traceEvents": ev})
    assert [d[2] for d in tr.device] == ["rans_encode_kernel", "Memcpy"]
    assert tr.ops == {0: (0.0, 30.0)}
    assert tr.host == [(2.0, 5.0, "aten::add")]
    assert tr.base_ns is None
    # the clock's base, which puts the program's spans on the trace's clock
    based = trace.parse({"traceEvents": ev,
                         "baseTimeNanoseconds": 1700000000123456789})
    assert based.base_ns == 1700000000123456789
    assert based.device == tr.device and based.host == tr.host
