#!/usr/bin/env python3
"""Run the port's CLI once on one NVIDIA card at the given options, on the
input of chip_smoke.py's `m2` phase (a 640 MB make_fastq_realistic file),
and report what happened.

    python3 cli_probe.py -b1024 -d2 -q2

Compress and decompress through cli.main on files
(chip_smoke.cli_round_trip): one JSON line with the MB/s, the ratio, the
device's peak memory of each, the launches and the stage seconds; or, when
the round trip raises, the error (its type, message and the last lines of
its traceback) and the device's peak memory up to it.  Then the card's name
and power limit.  Exits 0 on a byte-exact round trip, 1 on an error, 2
without a card.
"""
from __future__ import annotations

import sys
import time
import traceback

import chip_smoke as CS


def main(opts) -> int:
    import torch
    if not torch.cuda.is_available():
        print("cli_probe: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from dsrc_tpu_torch.ops import cuda_build
    device = torch.device("cuda", 0)
    cuda_build.load_all()
    t0 = time.perf_counter()
    data = CS.m2_input(CS.realistic_of_size(128 * CS.MB - 4096, seed=81))
    line = {"phase": "cli_probe", "cli": " ".join(opts),
            "input_bytes": len(data),
            "make_input_s": time.perf_counter() - t0}
    try:
        res = CS.cli_round_trip(device, "probe", data, opts)
        res.pop("archive")
        line.update(res, ok=True)
    except Exception as e:  # noqa: BLE001 — the probe reports the error
        line.update(ok=False, error=type(e).__name__, message=str(e)[:2000],
                    traceback=traceback.format_exc().splitlines()[-12:],
                    peak_device_bytes=torch.cuda.max_memory_allocated(
                        device))
    CS.emit(line)
    print(CS.card_info(), flush=True)
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
