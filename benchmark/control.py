#!/usr/bin/env python3
"""The control of a cell's comparison: the cell run with the program's own
lower precision, its lossy quality binning (-l, lossy_quality=True), in
place of the lossless settings that the configuration states.  It has to
come out not correct; its readings are the upper ends from which the
limits were set (PERF.md).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 0]

One line a seed: the checks' values.  --seconds 0 runs one operation (one
round trip), enough for every number the checks compare.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import run as R
    R.cache_dirs(ROOT)
    R.few_threads()
    import torch
    from yardstick import cell as C
    from yardstick import spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    c = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    params = dict(c.config["params"], lossy_quality=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = C.run_window(c, seed, args.seconds, False, device, t0,
                           params=params)
        res = C.result(c, seed, out, False, {}, free=torch.cuda.empty_cache)
        print(json.dumps({"workload": c.name, "control": "lossy_quality",
                          "seed": seed, "correct": res["correct"],
                          "checks": {k: v["value"] for k, v in
                                     res["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
