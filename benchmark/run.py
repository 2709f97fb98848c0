#!/usr/bin/env python3
"""Run one cell of the benchmark of dsrc_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints, as its last line on standard output,
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device (with --trace 1 also busy_s and window_s), with --trace 1 a
breakdown, and last "checks": every number compared, beside its limit
(also the last lines on standard error).  Exits non-zero, and prints no
result, without a CUDA card (or with fewer than the cell asks for),
without the program, or when a JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the JAX package and JAX itself, by the top-level name of a module
FORBIDDEN = ("jax", "jaxlib", "flax", "dsrc_tpu")
# one thread for each library's own pool: the program's two workers and
# its calling thread each ran one of a pool of the host's size beside it
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: dsrc_tpu_torch is not dsrc_tpu."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernels build into build/dsrc_tpu_torch/)."""
    base = os.path.join(root, "build", "benchmark_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def few_threads() -> None:
    """Library thread pools of one thread, before numpy and torch load."""
    for var in THREAD_VARS:
        os.environ[var] = "1"


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,"
             "clocks.sm", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    few_threads()
    sys.path.insert(0, ROOT)
    from yardstick import cell as C
    from yardstick import spec
    c = spec.load_cell(args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"{c.name} asks for {c.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import dsrc_tpu_torch  # noqa: F401  (the program, from the checkout)
    from dsrc_tpu_torch.utils import native
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    traced = bool(args.trace)
    print(json.dumps({"card": card_line(), "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "torch_threads": torch.get_num_threads(),
                      "native_host_library": native.available(),
                      "workload": c.name, "seed": args.seed,
                      "seconds": args.seconds, "trace": args.trace}),
          flush=True)

    out = C.run_window(c, args.seed, args.seconds, traced, device, T_START)
    run = out.run
    for line in out.kernel_lines:
        print(json.dumps(line), flush=True)
    kinds = sorted({o.kind for o in run.ops})
    print(json.dumps({"setup_s": out.setup_s, "window_s": out.window_s,
                      "ops": {k: len([o for o in run.ops if o.kind == k])
                              for k in kinds},
                      "op_seconds": {k: [o.seconds for o in run.ops
                                         if o.kind == k] for k in kinds},
                      "memory_peak_bytes": out.memory_peak}), flush=True)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": c.chips, "memory_peak_bytes": out.memory_peak}
    result = C.result(c, args.seed, out, traced, device_info,
                      free=torch.cuda.empty_cache)
    leaked = forbidden_modules(list(sys.modules))
    if leaked:
        print(f"JAX or the JAX package was loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
