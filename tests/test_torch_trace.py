"""The port's recorder (dsrc_tpu_torch/utils/trace.py) on the CPU.

- Off by default: a span is one shared no-op context, and an untraced
  round trip makes no span.
- Archives are the same bytes with the recorder on and off (UNIFORM, SEMI
  title mode 2, SEMI title mode 0, GENERIC at -d2 -q2), and decode.
- With two workers and three or more blocks, every codec.* span lies under
  a block span whose parent is its call's op.* root, blocks run on worker
  threads, and the codec's stages partition its time: below
  codec.compress / .decompress only codec.stage, .tag, .model, .serialize
  and .sync, none nested in another but the sync, a leaf; their self times
  and the codec span's own add up to its duration.
- The sync count equals the tensor-to-host conversions seen by patching
  torch.Tensor during the round trip (no exclusion: the plain versions of
  the kernels convert nothing on these paths).
- Nested spans on two threads, `under=`, folded totals, the sessions;
  counts, with no duration.
- A span opened inside a torch.profiler record_function range lands
  inside it on the trace's clock (the anchor and baseTimeNanoseconds).
- CLI -v prints the table; last_stage_times reads the recorder.
"""
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dsrc_tpu_torch import cli
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.io.archive import ArchiveReader
from dsrc_tpu_torch.utils import trace
from dsrc_tpu_torch.utils.synth import make_fastq_fast, make_fastq_realistic
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 1 << 17
READ_AHEAD = "api.read_ahead"
STAGES = ("codec.stage", "codec.tag", "codec.model", "codec.serialize")
CONVERSIONS = ("item", "tolist", "numpy", "__int__", "__bool__",
               "__float__", "__index__")


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    if trace.active():
        trace.stop()


def _umi(n: int, seed: int) -> bytes:
    """make_fastq_fast's reads with an 8-base UMI in each read name: every
    block takes SEMI title mode 0."""
    rng = np.random.default_rng(seed)
    lines = make_fastq_fast(n, 100, seed=seed).split(b"\n")
    out = []
    for i in range(0, len(lines) - 1, 4):
        name, _, rest = lines[i].partition(b" ")
        umi = bytes(rng.choice(list(b"ACGT"), 8).astype(np.uint8))
        out += [name + b"_" + umi + b" " + rest] + lines[i + 1:i + 4]
    return b"\n".join(out) + b"\n"


CASES = {
    "uniform": (lambda: make_fastq_fast(1200, 100, seed=1,
                                        fixed_width=True), {}, 1),
    "semi2": (lambda: make_fastq_fast(1200, 100, seed=2), {}, 2),
    "semi0": (lambda: _umi(1100, 3), {}, 2),
    "generic": (lambda: make_fastq_realistic(1300, 100, seed=4),
                dict(dna_compression_level=2, quality_compression_level=2),
                0),
}


class Conversions:
    """Counts the tensor-to-host conversions while it is entered."""

    def __init__(self):
        self.n = 0
        self.lock = threading.Lock()

    def __enter__(self):
        self.real = {m: getattr(torch.Tensor, m) for m in CONVERSIONS}
        for m, real in self.real.items():
            def counted(t, *a, _real=real, **k):
                with self.lock:
                    self.n += 1
                return _real(t, *a, **k)
            setattr(torch.Tensor, m, counted)
        return self

    def __exit__(self, *exc):
        for m, real in self.real.items():
            setattr(torch.Tensor, m, real)
        return False


def _module(kw):
    return DsrcModule(InputParameters(fastq_block_size_bytes=BLOCK,
                                      num_workers=2, **kw), device="cpu")


@pytest.fixture(scope="module")
def runs():
    """Each case: the input, its archive untraced and traced, the traced
    decode, the Recording of the traced round trip and the conversions
    counted during it."""
    out = {}
    for name, (make, kw, scheme) in CASES.items():
        data = make()
        plain = io.BytesIO()
        _module(kw).compress(io.BytesIO(data), plain)
        traced, text = io.BytesIO(), io.BytesIO()
        mod = _module(kw)
        with Conversions() as conv:
            trace.start()
            try:
                mod.compress(io.BytesIO(data), traced)
                stages_c = mod.last_stage_times
                mod.decompress(io.BytesIO(traced.getvalue()), text)
            finally:
                rec = trace.stop()
        out[name] = dict(data=data, plain=plain.getvalue(),
                         traced=traced.getvalue(), text=text.getvalue(),
                         rec=rec, conversions=conv.n, scheme=scheme,
                         stages_c=stages_c)
    return out


def test_off_by_default_and_shared_null():
    probe = ("from dsrc_tpu_torch.utils import trace\n"
             "print(trace.active(), trace.span('a') is trace.op('b') is "
             "trace.sync(None) is trace.span('c'), trace.current())")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "True", "None"]


def test_untraced_round_trip_makes_no_span(monkeypatch):
    def no_span(*a, **k):
        raise AssertionError("a span was made with the recorder off")
    monkeypatch.setattr(trace, "_Open", no_span)
    data = make_fastq_fast(600, 100, seed=9)
    arch, text = io.BytesIO(), io.BytesIO()
    mod = _module({})
    mod.compress(io.BytesIO(data), arch)
    assert mod.last_stage_times is None
    mod.decompress(io.BytesIO(arch.getvalue()), text)
    assert text.getvalue() == data


@pytest.mark.parametrize("name", list(CASES))
def test_archives_equal_with_recorder_on(runs, name):
    r = runs[name]
    assert r["traced"] == r["plain"]
    assert r["text"] == r["data"]
    reader = ArchiveReader(io.BytesIO(r["plain"]))
    assert reader.num_blocks >= 3
    assert {reader.read_block(i)[0] for i in range(reader.num_blocks)} \
        == {r["scheme"]}


def _self_ns(spans):
    """Each span's duration less what its children on its thread cover."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    tid = {s.id: s.tid for s in spans}
    for s in spans:
        if s.parent in own and tid[s.parent] == s.tid:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


@pytest.mark.parametrize("name", list(CASES))
def test_codec_spans_lie_under_blocks_under_the_root(runs, name):
    spans = runs[name]["rec"].spans
    by_id = {s.id: s for s in spans}
    roots = {s.op: s for s in spans if s.name.startswith("op.")}
    assert sorted(r.name for r in roots.values()) == \
        ["op.compress", "op.decompress"]
    blocks = [s for s in spans if s.name == "block"]
    for b in blocks:
        assert b.parent == roots[b.op].id and b.block >= 0
    for kind in ("compress", "decompress"):
        mine = [b for b in blocks if roots[b.op].name == "op." + kind]
        assert sorted(b.block for b in mine) == list(range(len(mine)))
        assert len(mine) >= 3
        # block 0 inline, later blocks on the two workers
        assert {b.tid for b in mine if b.block > 0} - {roots[mine[0].op].tid}
    codec = [s for s in spans if s.name.startswith("codec.")]
    assert codec
    for s in codec:
        up = by_id[s.parent]
        while up.name not in ("block", "api.analyze"):
            up = by_id[up.parent]
        # the first block's dataset analysis reads device values too
        assert up.name == "block" or s.name == trace.SYNC
        assert up.op == s.op and up.block == s.block


@pytest.mark.parametrize("name", list(CASES))
def test_codec_stages_partition_the_codec_time(runs, name):
    rec = runs[name]["rec"]
    spans = rec.spans
    by_id = {s.id: s for s in spans}
    own = _self_ns(spans)
    stages = set(STAGES) | {trace.SYNC}
    for c in (s for s in spans if s.name in ("codec.compress",
                                             "codec.decompress")):
        below = [s for s in spans if s.parent == c.id]
        total = own[c.id]
        todo = list(below)
        while todo:
            s = todo.pop()
            assert s.name in stages and s.tid == c.tid, s
            kids = [k for k in spans if k.parent == s.id]
            if s.name in STAGES:
                # a stage holds only syncs, and a sync holds nothing
                assert all(k.name == trace.SYNC for k in kids), s
            else:
                assert not kids
            todo += kids
            total += own[s.id]
        assert total == c.end_ns - c.start_ns
    assert all(by_id[s.parent].name != trace.SYNC for s in spans
               if s.parent in by_id)
    # the folded totals are the spans' self times and counts; a count
    # (dna.<scheme>, the bases a DNA scheme coded; api.read_ahead) is no
    # span and has no duration
    for nm, t in rec.by_name().items():
        mine = [s for s in spans if s.name == nm]
        if nm.startswith("dna.") or nm == READ_AHEAD:
            assert not mine and t.seconds == t.self_seconds == 0
            continue
        assert t.count == len(mine)
        assert t.self_seconds == pytest.approx(
            sum(own[s.id] for s in mine) / 1e9, abs=1e-9)
        assert t.nbytes == sum(s.nbytes for s in mine)


@pytest.mark.parametrize("name", list(CASES))
def test_sync_count_equals_tensor_conversions(runs, name):
    r = runs[name]
    n, nbytes = r["rec"].syncs()
    assert n == r["conversions"] > 0
    assert nbytes > 0


def test_last_stage_times_read_the_recorder(runs):
    st = runs["semi2"]["stages_c"]
    assert set(st) == {"api.read", "block", "api.write"}
    assert st["block"].count >= 3
    assert st["block"].nbytes == st["api.read"].nbytes == \
        len(runs["semi2"]["data"])
    assert 0 < st["api.write"].nbytes < len(runs["semi2"]["traced"])
    assert all(t.seconds > 0 for t in st.values())


@pytest.mark.parametrize("name", list(CASES))
def test_read_ahead_counted_once_a_call(runs, name):
    """api.read_ahead: the blocks the reader had queued when block 0's job
    returned, at most the blocks after it and the in-queue's depth (two
    workers: 8), once a call; never a span."""
    rec = runs[name]["rec"]
    nblocks = ArchiveReader(io.BytesIO(runs[name]["plain"])).num_blocks
    roots = [s for s in rec.spans if s.name.startswith("op.")]
    assert len(roots) == 2
    for root in roots:
        t = rec.by_name(root.op)[READ_AHEAD]
        assert 0 <= t.count <= min(nblocks - 1, 8)
        assert t.seconds == t.self_seconds == t.nbytes == 0
    assert not [s for s in rec.spans if s.name == READ_AHEAD]


def test_read_ahead_not_recorded_while_the_recorder_is_off(monkeypatch):
    calls = []
    real = trace.count
    monkeypatch.setattr(trace, "count",
                        lambda *a: (calls.append(a), real(*a)))

    def no_record():
        raise AssertionError("recorded with the recorder off")
    monkeypatch.setattr(trace, "_buffer", no_record)
    data = make_fastq_fast(1200, 100, seed=9)
    arch = io.BytesIO()
    _module({}).compress(io.BytesIO(data), arch)
    assert ArchiveReader(io.BytesIO(arch.getvalue())).num_blocks >= 3
    # one count call a compress, which records nothing
    assert [c[0] for c in calls if c[0] == READ_AHEAD] == [READ_AHEAD]


def test_nested_spans_on_two_threads():
    trace.start()
    with trace.op("compress") as root:
        with trace.span("codec.stage"):
            time.sleep(0.01)
            with trace.span("codec.sync", 8):
                time.sleep(0.01)

        def worker():
            with trace.span("block", 100, 1, under=root):
                with trace.span("codec.model"):
                    time.sleep(0.02)
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    rec = trace.stop()
    by = {s.name: s for s in rec.spans}
    assert by["block"].parent == root.id
    assert by["block"].tid != by["op.compress"].tid
    assert by["codec.model"].parent == by["block"].id
    assert {s.op for s in rec.spans} == {root.op}
    assert by["codec.model"].block == 1
    own = _self_ns(rec.spans)
    tot = rec.by_name()
    # the worker's block does not come off the root's self time
    assert own[root.id] == (by["op.compress"].end_ns
                            - by["op.compress"].start_ns
                            - (by["codec.stage"].end_ns
                               - by["codec.stage"].start_ns))
    assert tot["codec.stage"].self_seconds == pytest.approx(
        tot["codec.stage"].seconds - tot["codec.sync"].seconds)
    assert tot["codec.sync"].nbytes == 8 and tot["block"].nbytes == 100
    assert rec.syncs() == (1, 8)
    assert 0.009 < tot["codec.stage"].self_seconds < 0.1


@pytest.mark.parametrize("keep", [True, False])
def test_many_threads_lose_no_span(keep):
    """More threads than cores, switching every microsecond: every span of
    every thread is kept or counted, each with its own id."""
    n_threads, n_spans = 3 * (os.cpu_count() or 4), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.start(keep=keep)
        with trace.op("compress") as root:
            def worker(i):
                for j in range(n_spans):
                    with trace.span("block", 1, i, under=root):
                        with trace.span("codec.sync", 2):
                            pass
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        rec = trace.stop()
    finally:
        sys.setswitchinterval(old)
    tot = rec.by_name(root.op)
    assert tot["block"].count == n_threads * n_spans
    assert tot["block"].nbytes == n_threads * n_spans
    assert rec.syncs() == (n_threads * n_spans, 2 * n_threads * n_spans)
    if keep:
        assert len({s.id for s in rec.spans}) == len(rec.spans) == \
            2 * n_threads * n_spans + 1


def test_folded_sessions_keep_no_spans():
    trace.start(keep=False)
    for _ in range(1000):
        with trace.span("codec.tag"):
            pass
    rec = trace.stop()
    assert rec.spans == [] and rec.by_name()["codec.tag"].count == 1000
    assert trace.totals()["codec.tag"].count == 1000   # until the next start
    trace.start()
    assert trace.totals() == {}
    trace.stop()


@pytest.mark.parametrize("keep", [True, False])
def test_count_has_no_duration_and_joins_the_table(keep):
    """A count adds to its name's count under the call of the span open on
    its thread, makes no span and no time, and shows in table()."""
    trace.count("dna.A19")                 # off: nothing
    trace.start(keep=keep)
    with trace.op("decompress") as root:
        with trace.span("codec.serialize"):
            trace.count("dna.A19")
        trace.count("dna.A19", 2)
    trace.count("dna.A19")                 # outside any call
    rec = trace.stop()
    assert rec.by_name(root.op)["dna.A19"] == (0.0, 0.0, 3, 0)
    assert rec.by_name()["dna.A19"].count == 4
    assert all(s.name != "dna.A19" for s in rec.spans)
    assert rec.by_name()["codec.serialize"].count == 1
    row = [ln for ln in trace.table(rec) if ln.startswith("dna.A19")]
    assert row and row[0].split()[1:3] == ["0.000", "4"]


def test_span_lands_inside_its_profiler_range():
    from torch.profiler import ProfilerActivity, profile, record_function
    trace.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"range.{i}"):
                time.sleep(0.001)
                with trace.span("codec.tag", block=i):
                    time.sleep(0.002)
                time.sleep(0.001)
    rec = trace.stop()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            chrome = json.load(f)
    finally:
        os.remove(path)
    base = int(chrome["baseTimeNanoseconds"])
    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in chrome["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("range.")}
    for s in rec.spans:
        a, b = ranges[f"range.{s.block}"]
        start = trace.trace_us(s.start_ns, rec.anchor, base)
        end = trace.trace_us(s.end_ns, rec.anchor, base)
        assert a - 50 <= start and end <= b + 50
        # the sleeps around the span place it within the range
        assert start - a > 1000 - 50 and b - end > 1000 - 50


@pytest.mark.parametrize("mode", ["c", "d"])
def test_cli_verbose_prints_the_span_table(tmp_path, capsys, mode):
    src = tmp_path / "in.fastq"
    arc = tmp_path / "out.xfqz"
    src.write_bytes(make_fastq_fast(400, 50, seed=5))
    assert cli.main(["c", str(src), str(arc)], device="cpu") == 0
    capsys.readouterr()
    argv = ["c", "-v", str(src), str(arc)] if mode == "c" else \
        ["d", "-v", str(arc), str(tmp_path / "back.fastq")]
    assert cli.main(argv, device="cpu") == 0
    err = capsys.readouterr().err
    names = [line.split()[0] for line in err.splitlines() if line.strip()]
    assert ("op.compress" if mode == "c" else "op.decompress") in names
    for nm in ("api.read", "api.write", "block", "codec.stage",
               "codec.model", "codec.serialize", "codec.sync"):
        assert nm in names
    assert "device-to-host reads:" in err
    assert "native host library:" in err
    assert not trace.active()
