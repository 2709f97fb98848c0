#!/usr/bin/env python3
"""Run the port's CLI once on one NVIDIA card at the given options, on the
input of one of chip_smoke.py's phases, and report what happened.

    python3 cli_probe.py -b1024 -d2 -q2                 # the m2 input
    python3 cli_probe.py --input b1024 -b1024 -d2 -q2   # the b1024 input

Inputs: `m2` (the default), the 640 MB make_fastq_realistic file of the m2
phase; `b1024`, the file of the b1024 phase made from it (two full 1 GB
blocks and a 100 MB third: at -b1024, blocks 1 and 2 are on the card at
once), and before the CLI run that phase's lone -b1024 -d2 -q2 block
through BlockCodec (chip_smoke.b1024_block: each stage's peak device
memory per byte of capacity).

Compress and decompress through cli.main on files
(chip_smoke.cli_round_trip): one JSON line with the MB/s, the ratio, the
device's peak memory of each (allocated and reserved), each block codec
call's span, the launches and the stage seconds; or, when a run raises,
the error (its type, message and the last lines of its traceback) and the
device's peak memory up to it.  Then the card's name and power limit.
Exits 0 when every run is byte-exact, 1 on an error, 2 without a card.
"""
from __future__ import annotations

import sys
import time
import traceback

import chip_smoke as CS


def _run(line: dict, fn, device) -> dict:
    """line updated with what fn returns, or with the error it raised."""
    import torch
    try:
        res = fn()
        res.pop("archive", None)
        line.update(res, ok=True)
    except Exception as e:  # noqa: BLE001 — the probe reports the error
        line.update(ok=False, error=type(e).__name__, message=str(e)[:2000],
                    traceback=traceback.format_exc().splitlines()[-12:],
                    peak_device_bytes=torch.cuda.max_memory_allocated(device),
                    peak_reserved_bytes=torch.cuda.max_memory_reserved(
                        device))
    CS.emit(line)
    return line


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("cli_probe: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    which = "m2"
    if argv[:1] == ["--input"]:
        which, argv = argv[1], argv[2:]
    from dsrc_tpu_torch.ops import cuda_build
    device = torch.device("cuda", 0)
    cuda_build.load_all()
    t0 = time.perf_counter()
    data = CS.m2_input(CS.realistic_of_size(128 * CS.MB - 4096, seed=81))
    lines = []
    if which == "b1024":
        block, data = CS.b1024_input(data)
        lines.append(_run({"phase": "cli_probe", "input": "b1024_block"},
                          lambda: CS.b1024_block(device, block), device))
        del block
        torch.cuda.empty_cache()
    elif which != "m2":
        raise SystemExit(f"cli_probe: unknown input {which!r}")
    line = {"phase": "cli_probe", "input": which, "cli": " ".join(argv),
            "input_bytes": len(data),
            "make_input_s": time.perf_counter() - t0}
    lines.append(_run(line, lambda: CS.cli_round_trip(device, "probe", data,
                                                      argv), device))
    print(CS.card_info(), flush=True)
    return 0 if all(x["ok"] for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
