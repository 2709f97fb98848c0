#!/usr/bin/env python3
"""Drive the PyTorch port (dsrc_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure raises and the
script exits non-zero without printing a result:

  1 card     the card's name and power limit (nvidia-smi) and torch's name
  2 build    nvcc builds every kernel of dsrc_tpu_torch/csrc (in parallel);
             each kernel's registers, shared memory and spills (ptxas -v)
  3 kernels  K1 (rANS encode) and K2 (rANS decode) against their plain
             PyTorch versions on the card, exact integer equality, at the
             shapes of the main path's 8 MB blocks: SEMI quality (A=64),
             SEMI title value planes (A=256), UNIFORM titles (A=128); K2 on
             right- and left-aligned payloads.  Times by CUDA events: a
             call as the host issues them (`*_ms`, and per step) and the
             device's work alone (`*_device_ms`).  Then, correctness
             only, K1 on a stream that uses every freq in [1, 2^14), and
             K2 on a stream whose cum table exceeds its shared-memory
             budget.
  4 semi     a 64 MB SEMI file (variable titles, 8 blocks of 8 MB) through
             DsrcModule(device="cuda"): compress, decompress, byte compare
  5 uniform  the same with a 16 MB fixed-width (UNIFORM) file
  6 golden   tests/data's golden UNIFORM and SEMI archives decode
             byte-exactly on the card, and compressing their inputs on the
             card writes the golden archives' exact bytes
  7 profile  the SEMI round trip again under torch.profiler: the device's
             busy share of the wall time, its time by kernel, and K1's and
             K2's device time

Phases 4 and 5 are the main path: each sets the launch counts to 0, drives
the path and reads the counts, and fails when a kernel was not launched.
The lines before the last are the nvidia-smi line and the kernels line; the
last line is {"ok": true, "device": {...}}.  Needs one CUDA card and nvcc;
exits non-zero without one.
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
MB = 1 << 20

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 rate, and the
# int32 instruction rate of the CUDA cores (132 SMs x 64 INT32 lanes x
# 1.98 GHz boost); the rANS kernels do integer work only.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per coded symbol: encode = emit test (shift, compare,
# and), divide, remainder, shift, two adds, select; decode = mask, the
# binary search (one compare and select per halving), multiply, shift,
# add, subtract, renorm compare, shift/or
ENC_OPS_PER_SYM = 8
DEC_OPS_BASE = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card: CUDA events around
    reps calls, after one warm-up call.  Where a call's host work (Python,
    allocation, launch) is longer than its device work, this is the host's
    rate of issue; time_device_ms leaves the host out."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_device_ms(fn, reps: int):
    """Mean milliseconds of the device's work per call of fn: CUDA events
    around reps calls that the host queues while the card spins
    (torch.cuda._sleep), after one warm-up call.  The spin starts at about
    20 ms and doubles until the start event was still pending when the
    host had queued the last call, so that no gap between calls is timed;
    None if 6 tries were not enough."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 40_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    return None


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def block_streams(device, semi_records: int, uniform_records: int,
                  read_len: int = 100):
    """The positional streams of one SEMI and one UNIFORM block as the main
    path builds them: [(name, symbols [Rpad, P], num_rec, nsym, group)]."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.models import block as B
    from dsrc_tpu_torch.models import tag as TAG
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    from dsrc_tpu_torch.utils.synth import make_fastq_fast
    wr = UP.WIRE_DEFAULT

    semi = np.frombuffer(make_fastq_fast(semi_records, read_len, seed=7),
                         np.uint8)
    read_len, num_rec, qm, _sm, tstream, tl = B.stage_semi_raw(semi)
    rpad = B._rpad_bucket(num_rec) + 256        # first-block hint rule
    vmat, _meta = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                           np.asarray(tl))
    v0, pcs = B.semi_tok_planes(vmat, num_rec)
    vpad = np.zeros((rpad, vmat.shape[1]), np.int32)
    vpad[:num_rec] = vmat
    planes = UP._value_planes(torch.from_numpy(vpad).to(device),
                              torch.from_numpy(v0).to(device), pcs)
    qual = torch.from_numpy(np.ascontiguousarray(qm[:rpad])).to(device)
    qsyms, _mode = UP._choose_qual_syms(qual.to(torch.int32) - 33,
                                        num_rec, wr)

    uni = np.frombuffer(make_fastq_fast(uniform_records, read_len, seed=8,
                                        fixed_width=True), np.uint8)
    shape = B.BlockShape.for_block_size(len(uni))
    mat, unum, spec, urpad = B.stage_uniform_block(uni, shape.cap, device)
    title = mat[:, 1:1 + spec.title_len].to(torch.int32) - 32
    tsyms = UP.title_delta(torch.clamp(title, 0, wr.title_a - 1),
                           wr.title_group, wr.title_a)
    return [("semi_qual", qsyms.contiguous(), num_rec, wr.qual_a,
             wr.qual_group),
            ("semi_value_planes", planes.contiguous(), num_rec, UP.VAL_A,
             wr.val_group),
            ("uniform_titles", tsyms.contiguous(), unum, wr.title_a,
             wr.title_code_group)]


def _left_aligned(payload, nwords, states):
    """A K1 stream as a deserialized block holds it: words left-aligned at
    their compact width (ops/streams.serialize_rans + deserialize_rans)."""
    import torch
    from dsrc_tpu_torch.ops.streams import deserialize_rans, serialize_rans
    from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
    w = BitWriter()
    serialize_rans(w, 1, payload, nwords, states)
    _n, pl, _st, _nw = deserialize_rans(BitReader(w.getvalue()))
    return torch.from_numpy(pl).to(payload.device)


def kernel_checks(device, streams, reps: int):
    """K1 and K2 against their plain versions on each stream.  Returns the
    per-kernel records of the qual stream (the largest) with the maximum
    error over every stream; prints one JSON line per stream."""
    import torch
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    timed = reps > 0
    records = {}
    worst = {"rans_encode": 0, "rans_decode": 0}

    def err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    for name, syms, num_rec, nsym, group in streams:
        freq, cum, active, table = UP.positional_models(syms, num_rec, nsym,
                                                        group)
        t_steps, lanes = freq.shape
        enc = RK.rans_encode_from_freqs(freq, cum, active)
        enc_plain = RK.rans_encode_plain(freq, cum, active)
        e_enc = max(err(a, b) for a, b in zip(enc, enc_plain))
        if any(a.shape != b.shape for a, b in zip(enc, enc_plain)) or e_enc:
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"{name}: max abs err {e_enc}")
        payload, nwords, states = enc
        cumrow = cum_from_freqs(table).contiguous()
        n_act = int(active.sum())
        line = {"phase": "kernels", "stream": name, "T": t_steps,
                "L": lanes, "A": nsym, "P": syms.shape[1],
                "active_symbols": n_act, "k1_max_abs_err": e_enc}
        dec_err = 0
        for align, pl in (("right", payload),
                          ("left", _left_aligned(payload, nwords, states))):
            wptr = UP.start_words(pl, nwords, align == "left")
            args = (pl, states, wptr, cumrow, num_rec, group)
            dec = RK.rans_decode(*args)
            dec_plain = RK.rans_decode_plain(*args)
            e = err(dec, dec_plain)
            live = dec[:num_rec] != syms[:num_rec]
            if dec.shape != dec_plain.shape or e or bool(live.any()):
                raise AssertionError(
                    f"K2 ({align}-aligned) on {name}: max abs err {e} vs "
                    f"plain, {int(live.sum())} symbols differ from the "
                    f"encoded ones")
            dec_err = max(dec_err, e)
            line[f"k2_{align}_max_abs_err"] = e
        worst["rans_encode"] = max(worst["rans_encode"], e_enc)
        worst["rans_decode"] = max(worst["rans_decode"], dec_err)

        # bounds: each input read once, each output written once (bytes),
        # and the integer work of the coded symbols (operations)
        enc_bytes = (freq.numel() * 4 + cum.numel() * 4 + active.numel()
                     + payload.numel() * 4 + nwords.numel() * 4
                     + states.numel() * 4)
        enc_ops = ENC_OPS_PER_SYM * n_act
        pl_left = _left_aligned(payload, nwords, states)
        dec_bytes = (pl_left.numel() * 4 + states.numel() * 4 + lanes * 4
                     + cumrow.numel() * 4 + syms.numel() * 4)
        dec_ops = (DEC_OPS_BASE + max(1, (nsym - 1).bit_length())) * n_act
        bounds = {}
        for kname, nbytes, nops in (("rans_encode", enc_bytes, enc_ops),
                                    ("rans_decode", dec_bytes, dec_ops)):
            t_b = nbytes / HBM_BYTES_PER_S * 1e3
            t_o = nops / INT32_OPS_PER_S * 1e3
            bounds[kname] = (max(t_b, t_o),
                             "bytes" if t_b >= t_o else "operations")
        if timed:
            wptr_l = UP.start_words(pl_left, nwords, True)
            dargs = (pl_left, states, wptr_l, cumrow, num_rec, group)
            calls = {
                "rans_encode": (
                    lambda: RK.rans_encode_from_freqs(freq, cum, active),
                    lambda: RK.rans_encode_plain(freq, cum, active)),
                "rans_decode": (lambda: RK.rans_decode(*dargs),
                                lambda: RK.rans_decode_plain(*dargs)),
            }
            ms = {k: (time_ms(fn, reps), time_ms(plain, 2),
                      time_device_ms(fn, reps))
                  for k, (fn, plain) in calls.items()}
        else:
            ms = {k: (None, None, None) for k in bounds}
        for kname in ("rans_encode", "rans_decode"):
            (line[f"{kname}_ms"], line[f"{kname}_plain_ms"],
             line[f"{kname}_device_ms"]) = ms[kname]
            line[f"{kname}_bound_ms"], line[f"{kname}_bound_by"] = \
                bounds[kname]
        for kname in ("rans_encode", "rans_decode"):
            line[f"{kname}_ns_per_step"] = (
                ms[kname][0] * 1e6 / t_steps if timed else None)
        emit(line)
        if name == "semi_qual":
            for kname in ("rans_encode", "rans_decode"):
                records[kname] = dict(
                    ms=ms[kname][0], plain_ms=ms[kname][1],
                    bound_ms=bounds[kname][0], bound_by=bounds[kname][1])
    for kname in records:
        records[kname]["max_abs_err"] = worst[kname]
    return records


def all_freq_check(device) -> int:
    """K1 against its plain version, correctness only, on a stream whose
    active steps use every freq in [1, 2^14) (T = 640 steps of 33 lanes,
    shuffled), with random cum in [0, 2^14 - f], a lane that is never
    active, lanes with inactive tails, and unused freqs where inactive.
    Returns the max abs error; prints one line."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import M
    t_steps, lanes = 640, 33
    rng = np.random.default_rng(12)
    active = np.ones((t_steps, lanes), bool)
    active[:, 7] = False                          # a lane that emits nothing
    active[600:, 20:] = False                     # inactive tails
    n_act = int(active.sum())
    freq = rng.integers(0, 1 << 15, (t_steps, lanes))   # unused where inactive
    freq[active] = rng.permutation(np.concatenate(
        [np.arange(1, M), rng.integers(1, M, n_act - M + 1)]))
    cum = (rng.random((t_steps, lanes)) * (M - freq + 1)).astype(np.int64)
    freq, cum, active = (torch.from_numpy(a).to(device) for a in (
        freq.astype(np.int32), cum.astype(np.int32), active))
    got = RK.rans_encode_from_freqs(freq, cum, active)
    ref = RK.rans_encode_plain(freq, cum, active)
    e = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            for a, b in zip(got, ref))
    n_freqs = torch.unique(freq[active]).numel()
    if e or n_freqs != M - 1 or int(got[1][7]) != 0:
        raise AssertionError(f"K1 on the all-freq stream: max abs err {e}, "
                             f"{n_freqs} distinct active freqs")
    emit({"phase": "kernels", "stream": "all_freqs", "T": t_steps,
          "L": lanes, "distinct_active_freqs": n_freqs,
          "k1_max_abs_err": e})
    return e


def oversized_table_check(device) -> int:
    """K2 against its plain version (and the encoded symbols) on a stream
    whose cum table (P = 1024 positions, A = 512) is larger than K2's
    shared-memory budget, so that the kernel walks it in position tiles;
    right- and left-aligned.  Returns the max abs error; prints one line."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    rpad, p, nsym, group = 8 * 33, 1024, 512, 8
    num_rec = rpad - 5
    rng = np.random.default_rng(11)
    mat = np.minimum(rng.geometric(0.02, (rpad, p)) - 1, nsym - 1)
    mat = torch.from_numpy(mat.astype(np.int32)).to(device)
    freq, cum, active, table = UP.positional_models(mat, num_rec, nsym,
                                                    group)
    payload, nwords, states = RK.rans_encode_from_freqs(freq, cum, active)
    cumrow = cum_from_freqs(table).contiguous()
    _ne, stride, tile_rows = RK.dec_layout(nsym, p)
    line = {"phase": "kernels", "stream": "oversized_table", "T": p * group,
            "L": payload.shape[0], "A": nsym, "P": p,
            "table_bytes": cumrow.numel() * 4,
            "smem_budget_bytes": RK.DEC_SMEM_BUDGET,
            "tile_rows": tile_rows, "row_stride": stride}
    worst = 0
    for align, pl in (("right", payload),
                      ("left", _left_aligned(payload, nwords, states))):
        wptr = UP.start_words(pl, nwords, align == "left")
        args = (pl, states, wptr, cumrow, num_rec, group)
        dec = RK.rans_decode(*args)
        plain = RK.rans_decode_plain(*args)
        e = int((dec.to(torch.int64) - plain.to(torch.int64)).abs().max())
        if tile_rows >= p or e or not torch.equal(dec[:num_rec],
                                                  mat[:num_rec]):
            raise AssertionError(f"K2 ({align}-aligned) on the oversized "
                                 f"table: max abs err {e}, tile_rows "
                                 f"{tile_rows} of {p}")
        line[f"k2_{align}_max_abs_err"] = e
        worst = max(worst, e)
    emit(line)
    return worst


# --------------------------------------------------------------------------
# Phases 4-6: the main path through DsrcModule
# --------------------------------------------------------------------------

def round_trip(device, name: str, data: bytes, params=None) -> dict:
    """Compress and decompress `data` through DsrcModule on `device`, with
    the launch counts set to 0 just before and read just after."""
    import torch
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.ops import rans_kernels as RK
    mod = DsrcModule(params, device=device)
    arch = io.BytesIO()
    out = io.BytesIO()
    RK.reset_launch_counts()
    t0 = time.perf_counter()
    mod.compress(io.BytesIO(data), arch)
    t1 = time.perf_counter()
    stages_c = dict(mod.last_stage_times.seconds)
    arch.seek(0)
    mod.decompress(arch, out)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = RK.launch_counts()
    stages_d = dict(mod.last_stage_times.seconds)
    if out.getvalue() != data:
        raise AssertionError(f"{name}: round trip is not byte-exact")
    for k, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name}: kernel {k} was not launched on "
                                 f"the main path")
    mb = len(data) / MB
    return {"phase": name, "input_bytes": len(data),
            "archive_bytes": len(arch.getvalue()),
            "ratio": len(data) / len(arch.getvalue()),
            "compress_s": t1 - t0, "decompress_s": t2 - t1,
            "compress_MBps": mb / (t1 - t0),
            "decompress_MBps": mb / (t2 - t1),
            "roundtrip_MBps": mb / (t2 - t0),
            # host-clock seconds per stage, summed over the worker threads
            "compress_stage_s": stages_c, "decompress_stage_s": stages_d,
            "launches": counts}


def fastq_of_size(nbytes: int, seed: int, fixed_width: bool) -> bytes:
    """Synthetic Illumina FASTQ (read length 100) cut at the last whole
    record within nbytes."""
    import numpy as np
    from dsrc_tpu_torch.utils.synth import make_fastq_fast
    data = make_fastq_fast(nbytes // 240, 100, seed=seed,
                           fixed_width=fixed_width)
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4]
    return data[:int(ends[np.searchsorted(ends, nbytes) - 1]) + 1]


def profile_round_trip(device, data: bytes) -> dict:
    """One SEMI round trip under torch.profiler: the device's busy time
    (union of its kernel and copy intervals) as a share of the wall time,
    and device time by kernel name.  The profiler's own cost inflates the
    wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        round_trip(device, "semi", data)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no work on the device")
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(dev, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(v for n, v in by_name.items() if f"{k}_kernel" in n) / 1e3
            for k in ("rans_encode", "rans_decode")}
    return {"phase": "profile", "wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "device_events": len(dev),
            "top_device_ms": {k: v / 1e3 for k, v in top},
            "kernel_device_ms": ours}


def golden(device) -> dict:
    """Golden archives decode byte-exactly; their inputs compress to the
    golden bytes (the settings tools/make_golden.py used)."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    out = {"phase": "golden"}
    for name in ("golden_uniform", "golden_semi"):
        fq = open(os.path.join(DATA, name + ".fastq"), "rb").read()
        xz = open(os.path.join(DATA, name + ".xfqz"), "rb").read()
        dec = io.BytesIO()
        DsrcModule(device=device).decompress(io.BytesIO(xz), dec)
        if dec.getvalue() != fq:
            raise AssertionError(f"{name}.xfqz does not decode byte-exactly")
        arch = io.BytesIO()
        DsrcModule(InputParameters(fastq_block_size_bytes=1 << 17),
                   device=device).compress(io.BytesIO(fq), arch)
        if arch.getvalue() != xz:
            raise AssertionError(f"{name}: compressing its input does not "
                                 f"write the golden archive's bytes")
        out[name] = "decode and encode byte-exact"
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from dsrc_tpu_torch.ops import cuda_build
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = card_info()
    emit({"phase": "card", "nvidia_smi": smi, "torch_name": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_build.load_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(cuda_build.SOURCES),
          "ptxas": cuda_build.build_usage()})

    streams = block_streams(device, (8 * MB) // 250, (8 * MB) // 250)
    records = kernel_checks(device, streams, reps=50)
    records["rans_encode"]["max_abs_err"] = max(
        records["rans_encode"]["max_abs_err"], all_freq_check(device))
    records["rans_decode"]["max_abs_err"] = max(
        records["rans_decode"]["max_abs_err"], oversized_table_check(device))

    launches = {"rans_encode": 0, "rans_decode": 0}
    # a little under 8 and 2 whole 8 MB blocks: the chunker cuts each block
    # at a record boundary
    semi = fastq_of_size(64 * MB - 4096, seed=7, fixed_width=False)
    res = round_trip(device, "semi", semi)
    emit(res)
    uni = fastq_of_size(16 * MB - 1024, seed=8, fixed_width=True)
    res_u = round_trip(device, "uniform", uni)
    emit(res_u)
    for r in (res, res_u):
        for k, n in r["launches"].items():
            launches[k] += n
    emit(golden(device))
    emit(profile_round_trip(device, semi))

    replaces = {"rans_encode": "dsrc_tpu/ops/rans_pallas.py:73",
                "rans_decode": "dsrc_tpu/ops/rans_pallas.py:250"}
    sources = {"rans_encode": "dsrc_tpu_torch/csrc/rans_enc.cu",
               "rans_decode": "dsrc_tpu_torch/csrc/rans_dec.cu"}
    kernels = [dict(name=k, route="cuda", source=sources[k],
                    replaces=replaces[k], launches=launches[k],
                    max_abs_err=records[k]["max_abs_err"],
                    ms=records[k]["ms"], plain_ms=records[k]["plain_ms"],
                    bound_ms=records[k]["bound_ms"],
                    bound_by=records[k]["bound_by"], library_ms=None)
               for k in ("rans_encode", "rans_decode")]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
