"""One run of one cell: set-up, the measured window, the checks, and the
result line.

The loop is one closed-loop client, as the CLI is: each operation starts
when the last has returned, and ends when its bytes are on the host (the
archive or the FASTQ text in memory).  The window runs whole operations
(whole round trips) until --seconds have passed.

  round_trip    DsrcModule.compress of the generated FASTQ into memory,
                then DsrcModule.decompress of that archive into memory

Set-up warms what the window runs: a round trip of the data's first
block, at the configuration's block size (the kernels are built before,
by nvcc, so no shape of the window compiles inside it).

A traced run also turns the program's own recorder on just before the
window and off as it closes, inside the profiler session, and keeps its
spans and counts as the run's `program` (yardstick/program.py); an
untraced run never turns it on.
"""
from __future__ import annotations

import contextlib
import io
import sys
import time
import traceback
from typing import List, Optional

import numpy as np

from . import check, gen, hooks, program, record, trace, work
from .record import Op, Run
from .spec import Cell

LOOPS = ("round_trip",)
WARM_BLOCKS = 1


def _rng(purpose: int, seed: int) -> np.random.Generator:
    return np.random.default_rng([purpose, gen.data_seed(seed)])


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Outcome:
    """What a run leaves for the checks and the metrics."""

    def __init__(self):
        self.run: Optional[Run] = None
        self.data = b""
        self.archives: List[bytes] = []
        self.outputs: List[bytes] = []
        self.setup_s = 0.0
        self.window_s = 0.0
        self.memory_peak = 0
        self.kernel_lines: List[dict] = []


def _peaks(device) -> work.Peaks:
    """The card's peaks: the data sheet's HBM rate, the int32 rate derived
    from its SM count and the maximum SM clock nvidia-smi reports."""
    import torch
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return work.Peaks.of_card(sms, card_clock_mhz())


def card_clock_mhz() -> float:
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0])


def run_window(cell: Cell, seed: int, seconds: float, traced: bool,
               device, t_start: float, params: Optional[dict] = None,
               faults=None) -> Outcome:
    """Set-up and the window of one run.  params: the program's
    InputParameters keywords (default: the configuration's); faults: a
    context manager entered around the window (tests break the timed path
    with it)."""
    import torch
    from dsrc_tpu_torch import DsrcModule, InputParameters
    traffic = cell.traffic
    loop = traffic["loop"]
    if loop not in LOOPS:
        raise ValueError(f"unknown loop {loop!r} (one of {LOOPS})")
    params = dict(cell.config["params"] if params is None else params)
    prm = InputParameters(**params)
    prm.validate()
    out = Outcome()
    data = out.data = gen.make_input(traffic["data"], seed)
    bsize = check.block_size(params)
    mod = DsrcModule(prm, device=device)
    _log(f"set-up: {len(data)} FASTQ bytes generated at "
         f"{time.perf_counter() - t_start:.3f} s")

    kinds = ["compress", "decompress"]
    warm = data if WARM_BLOCKS * bsize >= len(data) else \
        gen.cut_records(data, WARM_BLOCKS * bsize - 4096)
    a = io.BytesIO()
    mod.compress(io.BytesIO(warm), a)
    mod.decompress(io.BytesIO(a.getvalue()), io.BytesIO())
    if device.type == "cuda":
        torch.cuda.synchronize()

    side = torch.cuda.Stream(device) if traced and device.type == "cuda" \
        else None
    kernels = [m.module.KERNEL for m in cell.per_layer
               if getattr(m.module, "KERNEL", None) is not None]
    session = trace.Session(side) if traced else None
    spans_cm = hooks.Spans() if traced else None
    calls_cm = hooks.KernelCalls(kernels, side) if traced else None
    recorder = program.Recorder() if traced else None
    ops: List[Op] = []
    spans = []
    first_error = []

    def attempt(kind, fn):
        idx = len(ops)
        hooks.Current.op = idx
        ctx = session.op(idx) if session else contextlib.nullcontext()
        t0 = time.perf_counter()
        res, ok = None, True
        with ctx:
            try:
                res = fn()
            except Exception:                      # noqa: BLE001
                ok = False
                if not first_error:
                    first_error.append(traceback.format_exc())
        t1 = time.perf_counter()
        hooks.Current.op = None
        ops.append(Op(idx, kind, t0, t1, 0, 0, ok))
        return ops[-1], res

    def window():
        t_win = time.perf_counter()
        out.setup_s = t_win - t_start
        while True:
            buf = io.BytesIO()
            op, _ = attempt("compress", lambda: mod.compress(
                io.BytesIO(data), buf))
            arch = buf.getvalue()
            op.fastq_bytes, op.archive_bytes = len(data), len(arch)
            if op.ok:
                out.archives.append(arch)
                dst = io.BytesIO()
                op, _ = attempt("decompress", lambda: mod.decompress(
                    io.BytesIO(arch), dst))
                op.fastq_bytes = dst.tell()
                if op.ok:
                    out.outputs.append(dst.getvalue())
            if time.perf_counter() - t_win >= seconds:
                break
        out.window_s = time.perf_counter() - t_win

    with (faults or contextlib.nullcontext()):
        if traced:
            with session, spans_cm as spans, calls_cm, recorder:
                window()
        else:
            window()
    if device.type == "cuda":
        torch.cuda.synchronize()
        out.memory_peak = max(torch.cuda.max_memory_allocated(i)
                              for i in range(cell.chips))
    if first_error:
        _log("first failed operation:\n" + first_error[0])
    out.run = Run(ops, spans, calls_cm.calls() if traced else [],
                  session.trace if traced else None,
                  _peaks(device) if traced and device.type == "cuda"
                  else None,
                  recorder.program(session.trace.base_ns) if traced
                  else None)
    if traced:
        for kernel in kernels:
            for kind in kinds:
                mine = [c for c in out.run.calls if c.kernel == kernel.name
                        and ops[c.op].kind == kind]
                if mine:
                    out.kernel_lines.append(_kernel_line(
                        out.run, kernel, kind, mine))
    return out


def _kernel_line(run: Run, kernel: work.Kernel, kind: str, calls) -> dict:
    line = {"kernel": kernel.name, "op": kind, "calls": len(calls),
            "bytes": sum(c.nbytes for c in calls),
            "int_ops": sum(c.nops for c in calls),
            "device_ms": record.kernel_device_s(run, kernel, kind) * 1e3}
    if run.peaks is not None:
        tb = sum(c.nbytes for c in calls) / run.peaks.hbm_bytes_per_s
        to = sum(c.nops for c in calls) / run.peaks.int32_ops_per_s
        line.update(bytes_bound_ms=tb * 1e3, ops_bound_ms=to * 1e3,
                    bound="bytes" if tb >= to else "operations")
    return line


def checks(cell: Cell, seed: int, out: Outcome, params: Optional[dict] = None
           ) -> dict:
    """Every number compared, each with its limit: {name: (value, limit)}.
    Runs once the window has closed and the program's state is freed."""
    params = dict(cell.config["params"] if params is None else params)
    data = out.data
    offsets = check.record_offsets(data)
    failed = sum(1 for o in out.run.ops if not o.ok)
    res = {"ops_failed": (failed, 0)}
    first = out.archives[0] if out.archives else b""
    res["archives_unlike_first"] = (sum(1 for a in out.archives
                                        if a != first), 0)
    faults = check.container_faults(first, params, len(offsets) - 1)
    for f in faults:
        _log(f"container fault: {f}")
    res["container_faults"] = (len(faults), 0)
    if out.outputs:
        res["fastq_bytes_wrong"] = (sum(check.bytes_wrong(data, o)
                                        for o in out.outputs), 0)
    nblocks = _num_blocks(first)
    k = min(int(cell.traffic.get("reference_blocks", 1)), nblocks)
    blocks = sorted(int(b) for b in _rng(2, seed).choice(
        nblocks, k, replace=False)) if k else []
    t0 = time.perf_counter()
    wrong = check.reference_block_bytes_wrong(first, data, offsets, blocks) \
        if blocks else {}
    _log(f"reference: blocks {blocks} of {nblocks} decoded on the CPU in "
         f"{time.perf_counter() - t0:.3f} s")
    res["reference_bytes_wrong"] = (sum(wrong.values()) if blocks
                                    else len(data), 0)
    return res


def _num_blocks(archive: bytes) -> int:
    from refdsrc.io.archive import ArchiveReader
    try:
        return ArchiveReader(io.BytesIO(archive)).num_blocks
    except Exception:                              # noqa: BLE001
        return 0


E2E = {
    "compress_MiBps": lambda run: record.rate_mibps(run, "compress"),
    "decompress_MiBps": lambda run: record.rate_mibps(run, "decompress"),
    "ratio": record.ratio,
}


def metrics(cell: Cell, out: Outcome, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced) as {name: {"value", "unit"}}; a metric with nothing to read
    is left out."""
    res = {}
    if traced:
        for m in cell.per_layer:
            v = m.reader(out.run)
            if v is not None:
                res[m.name] = {"value": float(v), "unit": m.unit}
        return res
    for m in cell.end_to_end:
        v = out.setup_s if m.name == "setup_s" else E2E[m.name](out.run)
        if v is not None:
            res[m.name] = {"value": float(v), "unit": m.unit}
    return res


def result(cell: Cell, seed: int, out: Outcome, traced: bool,
           device_info: dict, free=None) -> dict:
    """The result line: correct, attempted, failed, metrics, device (with
    busy_s and window_s when traced), the breakdown when traced, and the
    checks, last.  The trace is dropped and `free` called (the card's
    cache emptied) before the checks run."""
    run = out.run
    line = {"metrics": metrics(cell, out, traced), "device": device_info}
    win = record.window_us(run)
    if traced and win is not None:
        busy = record.busy_us((max(s, win[0]), min(t, win[1]))
                              for s, t, _ in run.trace.device
                              if s < win[1] and t > win[0])
        device_info.update(busy_s=busy / 1e6 / cell.chips,
                           window_s=(win[1] - win[0]) / 1e6)
    breakdown = record.breakdown(run) if traced else None
    run.trace = None
    if free is not None:
        free()
    res = checks(cell, seed, out)
    failed = sum(1 for o in run.ops if not o.ok)
    final = {"correct": all(v <= lim for v, lim in res.values()),
             "attempted": len(run.ops), "failed": failed}
    final.update(line)
    if breakdown is not None:
        final["breakdown"] = breakdown
    final["checks"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in res.items()}
    return final
