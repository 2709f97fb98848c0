#!/usr/bin/env python3
"""Run one cell of the benchmark once, as run.py does, and print beside its
result what the program's own recorder (dsrc_tpu_torch/utils/trace.py)
shows that the result line does not.

    python3 benchmark/stages.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--recorder <0|1>]
    python3 benchmark/stages.py --span-cost <n>

From the root of a checkout, on an NVIDIA card, as run.py runs a cell.
The last line on standard output is one JSON object:

  --trace 1   run.py's result line (the cell's per-layer metrics, those
              that read the program's spans and counts among them, and its
              breakdown, whose idle gaps the program's spans name), and
              under "program": the codec's ms a MiB beside the sum of its
              six stages, the count of spans and syncs, the idle seconds
              that the benchmark's BlockCodec spans put down to a
              BlockCodec call (run.py's naming before the program's spans)
              and those the program's spans name by a codec stage, with and
              without the calling thread's waits, and the trace's offset
              from the host clock by the recorder's anchor beside
              record.trace_offset_us's estimate.
  --trace 0   run.py's untraced result line (the end-to-end metrics), with
              the recorder on around the window (--recorder 1, the
              default; run.py never turns it on untraced) or off: the
              recorder's cost, seed against seed.
  --span-cost n   ns per span entered and left, recorder off and on (n
              spans each), on this host's CPU; no card needed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
OPS = ("compress", "decompress")
STAGE_NAMES = ("stage", "tag", "model", "sync", "serialize", "other")
CODEC_STAGES = ("codec.stage", "codec.tag", "codec.model",
                "codec.serialize", "codec.sync")


def idle_by_name(run, program_events=None) -> dict:
    """Every idle gap's seconds by what record.breakdown names it: by the
    benchmark's BlockCodec spans, or with program_events by those among
    the trace's host events (the program's codec.compress and .decompress
    spans are the same calls, on the anchor's clock rather than
    record.trace_offset_us's estimate)."""
    from yardstick import record
    run = dataclasses.replace(run, program=None)
    if program_events is not None:
        tr = dataclasses.replace(run.trace, host=sorted(
            run.trace.host + list(program_events)))
        run = dataclasses.replace(run, trace=tr, spans=[])
    return dict(record.breakdown(run, top=10 ** 6)["idle_gaps"])


def program_part(run, prog) -> dict:
    from yardstick import program, record
    res = {"codec_ms_per_MiB": {k: record.codec_ms_per_mib(run, k)
                                for k in OPS}}
    res["stage_sum_ms_per_MiB"] = {
        k: sum(program.stage_ms_per_mib(run, s, k) or 0.0
               for s in STAGE_NAMES) for k in OPS}
    res["syncs"] = sum(1 for s in prog.spans if s.name == program.SYNC)
    res["spans"] = len(prog.spans)
    est, anchor = record.trace_offset_us(run), program.offset_us(prog)
    res["offset_us"] = {"anchor": anchor, "trace_offset_us": est,
                        "anchor_less_estimate_ms":
                        None if est is None or anchor is None
                        else (anchor - est) / 1e3}
    if run.trace is None or anchor is None:
        return res
    plain = idle_by_name(run)
    named = idle_by_name(run, program.host_events(prog))
    waits = idle_by_name(run, program.host_events(prog, waits=True))
    for k in OPS:
        codec = sum(v for n, v in plain.items()
                    if n == f"{k}: BlockCodec.{k}")
        res[f"idle_s.{k}"] = {"BlockCodec": codec}
        for key, by in (("codec_stages", named),
                        ("codec_stages_with_waits", waits)):
            stage = sum(v for n, v in by.items()
                        if n.split(": ", 1)[0] == k
                        and n.split(": ", 1)[1] in CODEC_STAGES)
            res[f"idle_s.{k}"][key] = stage
            res[f"idle_s.{k}"][key + "_share"] = \
                stage / codec if codec else None
    return res


def span_cost(n: int) -> dict:
    """ns a `with` of a span, recorder off and on, beside a `with` of a
    shared no-op context (what the loop and the statement cost alone)."""
    import contextlib
    from dsrc_tpu_torch.utils import trace
    null = contextlib.nullcontext()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with null:
            pass
    out = {"nullcontext": (time.perf_counter_ns() - t0) / n}
    for on in (False, True):
        if on:
            trace.start(keep=True)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("codec.tag"):
                pass
        dt = time.perf_counter_ns() - t0
        if on:
            trace.stop()
        out["on" if on else "off"] = dt / n
    return {"span_ns": out, "spans": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--span-cost", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, BENCH_DIR)
    import run as R
    if args.span_cost:
        print(json.dumps(span_cost(args.span_cost)), flush=True)
        return 0
    R.cache_dirs(ROOT)
    R.few_threads()
    from yardstick import cell as C
    from yardstick import program, spec
    c = spec.load_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import dsrc_tpu_torch  # noqa: F401
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    traced = bool(args.trace)
    print(json.dumps({"card": R.card_line(), "workload": c.name,
                      "seed": args.seed, "seconds": args.seconds,
                      "trace": args.trace,
                      "recorder": args.recorder or traced}), flush=True)
    # a traced window has the recorder on (run_window); an untraced one
    # only here, around it, to read its cost
    rec = program.Recorder() if args.recorder and not traced else None
    out = C.run_window(c, args.seed, args.seconds, traced, device, T_START,
                       faults=rec)
    run = out.run
    extra = None
    if traced and run.program is not None:
        extra = program_part(run, run.program)
    elif rec is not None:
        extra = {"spans": len(rec.recording.spans)}
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": c.chips, "memory_peak_bytes": out.memory_peak}
    result = C.result(c, args.seed, out, traced, device_info,
                      free=torch.cuda.empty_cache)
    if extra is not None:
        result["program"] = extra
    leaked = R.forbidden_modules(list(sys.modules))
    if leaked:
        print(f"JAX or the JAX package was loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
