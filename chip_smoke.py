#!/usr/bin/env python3
"""Drive the PyTorch port (dsrc_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure raises and the
script exits non-zero without printing a result:

  1 card     the card's name and power limit (nvidia-smi), torch's name,
             and whether native/libdsrc_host.so serves the host's stages
             (it is not built here; else its numpy fallbacks do)
  2 build    nvcc builds every kernel of dsrc_tpu_torch/csrc and
             k4_variants.py's least-step probe (in parallel); each
             kernel's registers, shared memory and spills (ptxas -v)
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
             GENERIC (-m1 settings): K1 and K3 (context-model decode)
             against their plain versions on the quality (K3 mode 2), DNA
             pair (mode 0) and title text (mode 1) streams of one 8 MB
             block, K3 on every band.  K4 (A19's order-0 decode) on
             19-symbol streams at n = 3.3 M (T = 2,048; against its plain
             version too) and at the DNA stream shapes of a 64 MB -m1 and
             a 256 MB -m2 block (T = 16,384 and 65,536): equal to the
             encoded symbols and to K2 at P = 1 (the route that served A19
             before K4), both timed, with K4's chain floor (lane 0 alone)
             and its chain bound (T times the least step the card allows,
             k4_variants.least_step).  Then
             K3's and K1's times per band and per stream at the quality
             and DNA shapes of a 64 MB block, with K3's route (where its
             table rows live) and its chain floor (the warp of lane 0
             alone on the last band), and at the shapes of a 256 MB -m2
             block (synthetic streams from a seed, decoded to their
             encoded symbols; no plain version at that size).
             K5 (histogram): every K5 launch of phases 4-13 is held to
             its plain version on its own inputs, exactly, as the path
             runs (HistPlainCheck; the distributed children check their
             own).  After phase 13, every K5 call of one round trip each
             of a 64 MB -m1 block, an 8 MB SEMI block and an 8 MB mode-0
             block, recorded with its inputs and replayed: exact against
             its plain version on each route that can hold the bins
             (shared, global), timed (host-issued and device, and on
             each such route), beside today's library calls on the same
             ids (index_add_, bincount) and its bound; the routes' times
             over widths and densities (the route sweep, which
             hist_route's floor is read from); then its edge cases on
             every route that holds them (n = 0, 1, 15, 17, 33, the
             shared route's widest, every value type, a base one element
             past an aligned address, one bin, the last bin, a mask that
             drops all, the quality contexts' widths at 0.125 and 16 a
             bin, context bands at odd and aligned first columns,
             positional P = 1, 4, 37, 100, 4,099, 2^24 bins).
  4 semi     a 64 MB SEMI file (variable titles, 8 blocks of 8 MB) through
             DsrcModule(device="cuda"): compress, decompress, byte compare
  5 uniform  the same with a 16 MB fixed-width (UNIFORM) file
  6 generic  the -m1 preset (-d2 -q2, 64 MB blocks) on a 128 MB realistic
             file through DsrcModule(device="cuda"); the 8 MB -m1 archive on
             the card equal to the port's archive on the CPU; 8 MB round
             trips at -d0 -q0 on variable-length reads, -l -q2 on 4-level
             quality, -c, and DNA with more than 8 symbols (A19); one 64 MB
             -m1 block with IUPAC codes in its DNA (A19 at full width), K4
             launched once for each A19 block
  7 semi_mode0  -m0 on a 64 MB file whose read names carry an 8-base UMI
             (a free-text field: every block SEMI title mode 0, the titles
             through the tag coder, K1 and K3); one 8 MB block's archive on
             the card equal to the port's archive of it on the CPU
  8 colour   SOLiD reads (50 colours, '.' present): a 64 MB -m1 file (one
             block), and 8 MB at -m1 (archive equal to the CPU's; K1 and K3
             against their plain versions on every band of its CTX8P DNA
             stream), -d0 -q0, -l (on its lossy fixed point) and -c
  9 record_api  about 200,000 records through DsrcArchive(device="cuda")
             and back in order; records across the block boundary of the
             128 MB -m1 archive through read_records and through CLI -r
 10 mesh     the block mesh over [cuda:0, cuda:0], one host thread an
             entry: dryrun; DsrcModule with that mesh patched in on the
             64 MB SEMI file (four batches of two blocks) and the 64 MB
             mode-0 file (compress one-device, as block 0 is no mesh
             class), each archive equal to the one-device card archive and
             each mode-0 blob parsed once on decode; with two or more
             cards, the SEMI file through DsrcModule(device="cuda") over
             all of them beside the one-device path (else "multi_card":
             false)
 11 distributed  two processes on the one card (gloo), each
             DsrcModule(device="cuda:0").compress(..., distributed=True):
             the 64 MB SEMI file and the 128 MB -m1 file, each archive
             equal to the single-process card archive and decompressed on
             the card to the input; with two or more cards, the SEMI file
             under NCCL, one process a card
 12 m2       the -m2 preset (-d3 -q2, 256 MB blocks) at its real size: a
             640 MB realistic file (two full 256 MB blocks, then the
             128 MB -m1 file as a short block; blocks 1 and 2 on the card
             at once) through CLI `c -m2` and `d` on files under
             build/chip_smoke/, byte-exact, K1 and K3 launched, the
             device's peak memory of each; block 0 of the card's archive
             equal to the port's CPU bytes for its text
 13 b1024    the largest block size the CLI accepts, -b1024 -d2 -q2
             (capacity 1,073,758,208), on the m2 phase's records repeated:
             one 1 GB block through BlockCodec, each stage's peak device
             memory (allocated and reserved) per byte of capacity,
             allocated at most 24; then CLI `c -b1024 -d2 -q2` and `d` on
             a 2.1 GB file (two full blocks and 100 MB), byte-exact, with
             blocks 1 and 2 on the card at once (their compress spans
             overlap)
 14 golden   tests/data's golden archives (UNIFORM, SEMI, GENERIC, lossy)
             decode byte-exactly on the card, and compressing their inputs
             on the card writes the golden archives' exact bytes
 15 profile  the SEMI round trip, one 8 MB mode-0 block's and one 64 MB -m1
             block's round trip again under torch.profiler: the device's
             busy share of the wall time, its time by kernel, each
             kernel's device time, the launch counts, and PyTorch's
             index_add_ and bincount kernels by their whole names

Phases 4-13 are the main paths: each run sets the launch counts to 0,
drives the path and reads the counts, and fails when a kernel of that path
was not launched (a distributed child counts its own launches and prints
them).  The lines before the last are the script's seconds, the
nvidia-smi line and the kernels line; the last line is {"ok": true,
"device": {...}}.  Needs
one CUDA card and nvcc; exits non-zero without one.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import re
import subprocess
import sys
import threading
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


def time_once(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events,
    no warm-up.  For the plain versions, loops of small PyTorch ops that
    take long enough for one call to be their time."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
            ms = {k: (time_ms(fn, reps), time_once(plain)[1],
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
# Phase 3, GENERIC: K1 and K3 on the context-model streams, K4 on A19
# --------------------------------------------------------------------------

def m1_params(block_bytes: int, **kw):
    """The -m1 preset (-d2 -q2) at a given block size, with extra
    settings."""
    from dsrc_tpu_torch.config import InputParameters
    p = InputParameters.preset(1)
    p.fastq_block_size_bytes = block_bytes
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def realistic_of_size(nbytes: int, seed: int, platform: str = "hiseq"):
    """make_fastq_realistic (read length 100) cut at the last whole record
    within nbytes."""
    import numpy as np
    from dsrc_tpu_torch.utils.synth import make_fastq_realistic
    data = make_fastq_realistic(nbytes // 250, 100, platform=platform,
                                seed=seed)
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4]
    return data[:int(ends[np.searchsorted(ends, nbytes) - 1]) + 1]


def ctx_streams(device, block: bytes, params):
    """The context-model streams of one GENERIC block as the -m1 path codes
    them: quality (CTX, K3 mode 2), DNA base pairs (CTX4P, mode 0) and the
    block's titles as one text field (the tag text stream, mode 1).  Each
    is a dict: name, mode, num_ctx, nsym, edges, lanes/active/ctx [T, L]
    (the encoder's view), aux [L, T] (K3's), n."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.api import analyze_first_block
    from dsrc_tpu_torch.models import block as B
    from dsrc_tpu_torch.models import dna as DNA
    from dsrc_tpu_torch.models import quality as Q
    from dsrc_tpu_torch.models import tag as TAG
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    arr = np.frombuffer(block, np.uint8)
    shape = B.BlockShape.for_block_size(params.fastq_block_size_bytes)
    settings = params.to_settings()
    ds = analyze_first_block(arr, shape, device=device)
    g = B.BlockCodec(shape, settings, ds, device).stage_generic(arr)
    cap = shape.cap
    out = []

    def add(*args, **kw):
        out.append(ctx_stream(*args, **kw))

    # quality, CTX scheme at order 2
    n = g.q_total
    hist = Q.quality_hist(g.qvals, n).cpu().numpy()
    present = np.flatnonzero(hist)
    a_pad = Q._a_pad(len(present))
    lut = np.zeros(256, np.int32)
    lut[present] = np.arange(len(present))
    dense = torch.from_numpy(lut).to(device)[g.qvals.to(torch.int64)]
    nc, lanes_n, edges = Q._geom(cap, n)
    num_ctx, mode, reset, bucket = Q.ctxq_model(
        g.qual_len_d, nc, settings.quality_order, a_pad, lanes_n,
        Q._pow2ceil(n))
    add("quality", mode, num_ctx, a_pad, edges, dense[:nc], n,
        aux=(reset, bucket), lanes_n=lanes_n)
    # DNA base pairs, CTX4P at order 6 (N bases fold into the quality)
    if int(g.dna[:g.dna_total].max()) >= 4:
        raise AssertionError("the -m1 block's DNA is not 4-symbol")
    npairs = (g.dna_total + 1) // 2
    pairs = DNA._to_pairs(g.dna, g.dna_total, cap, 4)
    ncp = C.stream_cap(cap // 2, npairs)
    lanes_p = C.pick_num_lanes(ncp)
    order = DNA._order4p_eff(settings.dna_order, npairs)
    add("dna_pairs", CK.CtxMode(CK.MODE_HISTORY, sbits=4,
                                cmask=(1 << (4 * order)) - 1),
        1 << (4 * order), 16, C.band_edges(ncp // lanes_p), pairs[:ncp],
        npairs, ctx=(order, 4), lanes_n=lanes_p)
    # titles as one free-text field: contexts min(position, 15)
    n = g.t_total
    nc = C.stream_cap(cap, n)
    lanes_n = C.pick_num_lanes(nc)
    text = torch.from_numpy(np.pad(g.titles[:n].astype(np.int64),
                                   (0, nc - n))).to(device)
    tctx = torch.from_numpy(np.pad(TAG._text_ctx({0: g.title_len}, [0]),
                                   (0, nc - n))).to(device)
    add("tag_text", CK.CtxMode(CK.MODE_PRECOMPUTED), TAG.TEXT_NUM_CTX, 256,
        C.band_edges(nc // lanes_n), text, n, ctx=tctx, lanes_n=lanes_n)
    return out


def ctx_stream(name, mode, num_ctx, nsym, edges, sym, n, ctx=None, aux=None,
               lanes_n=None):
    """One context-model stream as ctx_streams describes it, from the flat
    symbols `sym` (n valid) over lanes_n lanes.  ctx: (order, sym_bits)
    in mode 0, the flat context ids in mode 1; aux: (reset, bucket) [T, L]
    in mode 2."""
    import torch
    from dsrc_tpu_torch.models import quality as Q
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops.rans import lane_active, lane_lengths, lane_split
    device = sym.device
    lanes = lane_split(sym.to(torch.int64), lanes_n)
    t_steps = lanes.shape[0]
    lengths = lane_lengths(n, lanes_n, t_steps, device)
    active = lane_active(t_steps, lengths)
    lanes = torch.where(active, lanes, 0)
    if mode.kind == CK.MODE_HISTORY:
        ctx = C.history_ctx_lanes(lanes, *ctx)
    elif mode.kind == CK.MODE_PRECOMPUTED:
        ctx = lane_split(ctx, lanes_n)
        aux = torch.where(active, ctx, 0).T
    else:
        reset, bucket = aux
        ctx = Q.ctxq_contexts(lanes, reset, bucket, mode)
        aux = Q.ctxq_aux(reset, bucket)
    return dict(name=name, mode=mode, num_ctx=num_ctx, nsym=nsym,
                edges=edges, lanes=lanes, active=active,
                ctx=torch.where(active, ctx, 0), lengths=lengths,
                aux=None if aux is None else
                aux.to(torch.int32).contiguous(), n=n)


def m2_streams(device, seed: int = 92):
    """Synthetic quality and DNA-pair streams at the shapes of one 256 MB
    -m2 block (-d3 -q2; about 2^27 quality values of 100-base reads):
    quality in mode 2 (T = 65,536, L = 2,048, A = 64, CTX order 2: 4,096
    contexts, lags (6, 2)), DNA pairs in mode 0 (T = 32,768, A = 16, order
    2: 256 contexts).  Symbols are i.i.d. from a skewed distribution made
    from numpy with `seed` (the chain's work does not depend on what the
    model learns)."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.models import quality as Q
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    rng = np.random.default_rng(seed)

    def skewed(n, nsym):
        # uniform bytes through a skewed 256-entry table of symbols
        cdf = np.cumsum(rng.dirichlet(np.full(nsym, 0.5))) * 256
        lut = np.minimum(np.searchsorted(cdf, np.arange(256), side="right"),
                         nsym - 1).astype(np.uint8)
        return torch.from_numpy(lut[rng.integers(0, 256, n, np.uint8)]) \
            .to(device)

    lanes_n, out = 2048, []
    n = 65536 * lanes_n
    lens = torch.full((-(-n // 100),), 100, dtype=torch.int32, device=device)
    num_ctx, mode, reset, bucket = Q.ctxq_model(lens, n, 2, 64, lanes_n, n)
    if num_ctx != 4096 or mode.lags != (6, 2):
        raise AssertionError(f"-m2 quality model {num_ctx} {mode.lags}")
    out.append(ctx_stream("quality", mode, num_ctx, 64,
                          C.band_edges(n // lanes_n), skewed(n, 64), n,
                          aux=(reset, bucket), lanes_n=lanes_n))
    n = 32768 * lanes_n
    out.append(ctx_stream("dna_pairs", CK.CtxMode(CK.MODE_HISTORY, sbits=4,
                                                  cmask=(1 << 8) - 1),
                          256, 16, C.band_edges(n // lanes_n),
                          skewed(n, 16), n, ctx=(2, 4), lanes_n=lanes_n))
    return out


def _err(a, b) -> int:
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def k3_bytes_ops(st, payload_bytes: int, t0: int, t1: int, cum_numel: int):
    """K3's bound inputs for steps [t0, t1): bytes (payload words the band
    consumes counted once for the stream, per-lane state in and out, the
    table, aux in, symbols and ids out) and operations (per active step:
    the rANS arithmetic, the context and carry update, one compare per
    table entry)."""
    lanes = st["lanes"].shape[1]
    steps = lanes * (t1 - t0)
    active = int(st["active"][t0:t1].sum())
    nbytes = (payload_bytes + 2 * 4 * 4 * lanes + cum_numel * 4
              + (4 * steps if st["aux"] is not None else 0) + 8 * steps)
    ops = (DEC_OPS_BASE + 4 + st["nsym"]) * active
    return nbytes, ops


def bound(nbytes: float, nops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / INT32_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def ctx_checks(device, streams, shape_name: str, timed: bool,
               check_plain: bool):
    """For each stream: K1 against its plain version on the stream's
    (freq, cum) (check_plain), then the band loop of ops/ctx.decode_ctx_lanes
    with K3 launched per band and, per band, held against the plain
    version from the same state (check_plain); the decoded symbols must
    equal the encoded ones.  Times K1 and each band's K3 (timed).  Prints
    one line per stream; returns {stream name: record}."""
    import torch
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs, quantize_counts
    records = {}
    for st in streams:
        lanes, active, nsym = st["lanes"], st["active"], st["nsym"]
        t_steps, l = lanes.shape
        freq, cum = C.ctx_models(lanes, active, st["ctx"], st["num_ctx"],
                                 nsym, st["edges"])
        enc = RK.rans_encode_from_freqs(freq, cum, active)
        line = {"phase": "kernels", "stream": f"{shape_name}_{st['name']}",
                "mode": st["mode"].kind, "T": t_steps, "L": l, "A": nsym,
                "C": st["num_ctx"], "n": st["n"], "bands": len(st["edges"]) - 1,
                "table_bytes": st["num_ctx"] * (nsym + 1) * 4,
                "route": CK.ctx_route(st["num_ctx"], nsym)}
        if check_plain:
            plain = RK.rans_encode_plain(freq, cum, active)
            e1 = max(_err(a, b) for a, b in zip(enc, plain))
            if e1 or any(a.shape != b.shape for a, b in zip(enc, plain)):
                raise AssertionError(f"K1 differs from its plain version on "
                                     f"{line['stream']}: max abs err {e1}")
            line["k1_max_abs_err"] = e1
        payload = _left_aligned(*enc).contiguous()
        states = enc[2]
        payload_bytes = 2 * int(enc[1].sum())
        if timed:
            line["k1_ms"] = time_ms(
                lambda: RK.rans_encode_from_freqs(freq, cum, active), 5)
            line["k1_device_ms"] = time_device_ms(
                lambda: RK.rans_encode_from_freqs(freq, cum, active), 5)
            line["k1_bound_ms"], line["k1_bound_by"] = bound(
                freq.numel() * 9 + enc[0].numel() * 4 + l * 8,
                ENC_OPS_PER_SYM * int(active.sum()))
        # the band loop of decode_ctx_lanes, with per-band checks and times
        x = states.clone()
        wptr = torch.zeros(l, dtype=torch.int32, device=device)
        carry = torch.zeros(l, dtype=torch.int32, device=device)
        osym = torch.empty((l, t_steps), dtype=torch.int32, device=device)
        octx = torch.empty_like(osym)
        nbins = st["num_ctx"] * nsym
        hist = torch.zeros(nbins, dtype=torch.int64, device=device)
        steps = torch.arange(t_steps, device=device)
        bands, e3 = [], 0
        for b in range(len(st["edges"]) - 1):
            t0, t1 = st["edges"][b], st["edges"][b + 1]
            cumt = cum_from_freqs(quantize_counts(
                hist.view(st["num_ctx"], nsym))).contiguous()
            args = (payload, st["lengths"], cumt, st["aux"])

            def band(state, fn=CK.ctx_decode_band, t0=t0, t1=t1, args=args,
                     outs=None):
                xs, ws, cs = (v.clone() for v in state)
                os_, oc = outs if outs is not None else \
                    (torch.empty_like(osym), torch.empty_like(octx))
                fn(args[0], xs, ws, cs, args[1], args[2], args[3], os_, oc,
                   t0, t1, st["mode"])
                return xs, ws, cs, os_, oc

            rec = {"t0": t0, "t1": t1}
            if check_plain:
                got = band((x, wptr, carry))
                ref = band((x, wptr, carry), CK.ctx_decode_band_plain)
                e = max(_err(a, b) for a, b in zip(got[:3], ref[:3]))
                e = max(e, _err(got[3][:, t0:t1], ref[3][:, t0:t1]),
                        _err(got[4][:, t0:t1], ref[4][:, t0:t1]))
                if e:
                    raise AssertionError(
                        f"K3 differs from its plain version on "
                        f"{line['stream']} band {b}: max abs err {e}")
                e3 = max(e3, e)
            if timed:
                state = (x, wptr, carry)
                rec["ms"] = time_ms(lambda: band(state), 5)
                rec["device_ms"] = time_device_ms(lambda: band(state), 5)
                if b == len(st["edges"]) - 2:
                    # the chain floor: the warp of lane 0 alone (its
                    # 32/t lanes) on the last band
                    w = 32 // CK.row_layout(nsym)[0]
                    one = (payload[:w], st["lengths"][:w], cumt,
                           None if st["aux"] is None else st["aux"][:w])
                    ms1 = time_device_ms(lambda: band(
                        (x[:w], wptr[:w], carry[:w]), args=one,
                        outs=(osym[:w].clone(), octx[:w].clone())), 5)
                    line["k3_one_warp_alone_ns_per_step"] = (
                        None if ms1 is None else ms1 * 1e6 / (t1 - t0))
                share = int(active[t0:t1].sum()) / max(1, int(active.sum()))
                nb, no = k3_bytes_ops(st, payload_bytes * share, t0, t1,
                                      cumt.numel())
                rec["bound_ms"], rec["bound_by"] = bound(nb, no)
            x, wptr, carry, _, _ = band((x, wptr, carry), outs=(osym, octx))
            if b + 2 < len(st["edges"]):
                act = steps[None, t0:t1] < st["lengths"][:, None]
                hist += C.hist_update(octx[:, t0:t1].to(torch.int64) * nsym
                                      + osym[:, t0:t1], act, nbins)
            bands.append(rec)
        if not torch.equal(torch.where(active, osym.T, 0), lanes.to(
                torch.int32)):
            raise AssertionError(f"K3 does not decode the encoded symbols of "
                                 f"{line['stream']}")
        line["k3_launches"] = len(bands)
        if check_plain:
            line["k3_max_abs_err"] = e3
        if timed:
            line["bands"] = bands
            for k in ("ms", "device_ms", "bound_ms"):
                line[f"k3_{k}"] = sum(r[k] for r in bands)
            nb, no = k3_bytes_ops(st, payload_bytes, 0, t_steps, sum(
                st["num_ctx"] * (nsym + 1) for _ in bands))
            line["k3_stream_bound_ms"], line["k3_stream_bound_by"] = \
                bound(nb, no)
            line["k3_ns_per_step"] = line["k3_ms"] * 1e6 / t_steps
            line["k3_device_ns_per_step"] = line["k3_device_ms"] * 1e6 / \
                t_steps
            ns1 = line.get("k3_one_warp_alone_ns_per_step")
            line["k3_chain_floor_ms"] = (None if ns1 is None
                                         else ns1 * t_steps / 1e6)
        emit(line)
        records[st["name"]] = dict(line, payload=payload, states=states,
                                   stream=st)
    return records


def k3_plain_ms(rec) -> float:
    """The plain version's time over a whole stream (its band loop, K3
    replaced by ctx_decode_band_plain), one timed call."""
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    st = rec["stream"]

    def run():
        saved = C.ctx_decode_band
        C.ctx_decode_band = CK.ctx_decode_band_plain
        try:
            return C.decode_ctx_lanes(rec["payload"], rec["states"],
                                      st["lengths"], st["lanes"].shape[0],
                                      st["num_ctx"], st["nsym"], st["edges"],
                                      st["mode"], st["aux"])
        finally:
            C.ctx_decode_band = saved
    return time_once(run)[1]


# A19's streams: (n, name); T = 2,048 at n = 3.3 M, and the T of the DNA
# stream of a full 64 MB -m1 block (16,384) and a 256 MB -m2 block (65,536)
A19_SHAPES = ((3_300_000, "a19"), (25_000_000, "a19_m1_64MB"),
              (100_000_000, "a19_m2_256MB"))
# integer operations per A19 step: mask, slot-table load, multiply-add,
# renorm compare, shift/or and select
A19_OPS_PER_SYM = 6


def a19_stream(device, n: int) -> dict:
    """A 19-symbol stream of n symbols laid out as models/dna.py lays out a
    block's DNA, drawn on the card (inverse CDF of a Dirichlet(0.7) mix) and
    encoded through K1 (dna._a19_encode), with its payload left-aligned as
    a decoded block holds it (ops/streams.deserialize_rans)."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.models import dna as DNA
    from dsrc_tpu_torch.ops import ctx as C
    rng = np.random.default_rng(19)
    nc = C.stream_cap(1 << 30, n)
    lanes = C.pick_num_lanes(nc, target_per_lane=2048)
    cdf = torch.from_numpy(np.cumsum(rng.dirichlet(np.full(19, 0.7)))[:-1]
                           .astype(np.float32)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    syms = torch.zeros(nc, dtype=torch.int32, device=device)
    syms[:n] = torch.searchsorted(
        cdf, torch.rand(n, generator=gen, device=device), out_int32=True)
    payload, nwords, states, freqs = DNA._a19_encode(syms, n, 19, lanes, nc)
    pl = _left_aligned(payload, nwords, states).contiguous()
    del payload
    return dict(n=n, syms=syms, payload=pl, nwords=nwords, states=states,
                wptr=torch.zeros(lanes, dtype=torch.int32, device=device),
                freqs=freqs, fields=tuple(freqs.tolist()), lanes=lanes,
                t=nc // lanes)


def a19_least_step(device) -> dict:
    """The least dependent step the card allows (k4_variants.least_step:
    one shared-memory load, one multiply-add, a compare-select; the best
    of its forms), from the library k4_variants.build_least started."""
    import k4_variants
    return k4_variants.least_step(device, os.path.join(
        ROOT, "build", "chip_smoke", "libk4_least.so"))


def a19_check(device, n: int, name: str, least: dict,
              plain: bool = False) -> dict:
    """K4 (A19's order-0 decode, ops/a19_kernels.a19_decode) on a19_stream
    (device, n): equal to the encoded symbols, to K2 at P = 1 and group T
    (the route that served A19 before K4) and, with `plain`, to
    a19_decode_plain, all on the same inputs.  Times, by CUDA events: K4
    host-issued (`ms`) and device (`device_ms`), K2's route (`k2_*`), the
    plain version (with `plain`), and K4's chain floor: lane 0 alone, its T
    steps one after another (no schedule of the lanes decodes the stream
    faster than its longest lane).  Bounds: bytes (payload words, states,
    start words, table in; symbols out) and operations; the chain bound,
    T times the least step the card allows (`least`)."""
    import torch
    from dsrc_tpu_torch.ops import a19_kernels as AK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    t_start = time.perf_counter()
    st = a19_stream(device, n)
    t, lanes = st["t"], st["lanes"]
    args = (st["payload"], st["states"], st["wptr"], st["fields"], n, t)
    k2_args = (st["payload"], st["states"], st["wptr"],
               cum_from_freqs(st["freqs"])[None, :].contiguous(), n, t)
    got = AK.a19_decode(*args)
    k2 = RK.rans_decode(*k2_args).reshape(-1)
    e_k2 = _err(got, k2)
    if e_k2 or not torch.equal(got[:n].to(torch.int32), st["syms"][:n]):
        raise AssertionError(f"{name}: K4 differs from K2 at P = 1 (max abs "
                             f"err {e_k2}) or from the encoded symbols")
    del k2
    line = {"phase": "kernels", "stream": name, "n": n, "T": t, "L": lanes,
            "A": 19, "k2_max_abs_err": e_k2}
    if plain:
        ref, line["plain_ms"] = time_once(
            lambda: AK.a19_decode_plain(*args))
        e = _err(got, ref)
        if e:
            raise AssertionError(f"{name}: K4 differs from a19_decode_plain:"
                                 f" max abs err {e}")
        line["max_abs_err"] = e
    line["ms"] = time_ms(lambda: AK.a19_decode(*args), 5)
    line["device_ms"] = time_device_ms(lambda: AK.a19_decode(*args), 5)
    line["k2_ms"] = time_ms(lambda: RK.rans_decode(*k2_args), 3)
    line["k2_device_ms"] = time_device_ms(lambda: RK.rans_decode(*k2_args),
                                          3)
    line["bound_ms"], line["bound_by"] = bound(
        2 * int(st["nwords"].sum()) + 8 * lanes + 4 * 19 + lanes * t,
        A19_OPS_PER_SYM * n)
    line["least_step_ns"] = least["ns"]
    line["chain_bound_ms"] = least["ns"] * t / 1e6
    one = (st["payload"][:1], st["states"][:1], st["wptr"][:1],
           st["fields"], t, t)
    if not torch.equal(AK.a19_decode(*one).to(torch.int32),
                       st["syms"][:t]):
        raise AssertionError(f"{name}: lane 0 alone through K4")
    line["chain_floor_ms"] = time_device_ms(lambda: AK.a19_decode(*one), 5)
    line["k2_chain_floor_ms"] = time_device_ms(
        lambda: RK.rans_decode(*(v[:1] for v in k2_args[:3]), k2_args[3],
                               t, t), 3)
    line["device_ns_per_step"] = line["device_ms"] * 1e6 / t
    line["seconds"] = time.perf_counter() - t_start
    emit(line)
    return line


def with_iupac(data: bytes, seed: int) -> bytes:
    """Replace about 1% of the bases whose quality is at least 20 by IUPAC
    codes, so that the DNA keeps more than 8 distinct symbols (scheme
    A19).  Records are 4 lines; all of them at once, on the host."""
    import numpy as np
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(data, np.uint8).copy()
    nl = np.flatnonzero(arr == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    ends = np.append(nl, len(arr))
    seq = np.arange(1, len(starts) - 1, 4)
    lens = ends[seq] - starts[seq]
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    pos = np.repeat(starts[seq], lens) + within
    qpos = np.repeat(starts[seq + 2], lens) + within
    pick = (rng.random(len(pos)) < 0.01) & (arr[qpos] >= 33 + 20)
    codes = np.frombuffer(b"RWSKMDVHBY", np.uint8)
    arr[pos[pick]] = codes[rng.integers(0, len(codes), int(pick.sum()))]
    return arr.tobytes()


def lossy_fixed_point(device, data: bytes, params, blank: bytes = b"N"
                      ) -> bytes:
    """What a lossy archive of data decodes to (binned qualities, `blank`
    where a bin is 0: N, or '.' in colour space); checked to keep the
    titles and the bases of data.  Lossy coding is idempotent on it, so its
    round trip is byte-exact, as the golden lossy fixture's is."""
    from dsrc_tpu_torch.api import DsrcModule
    arch, out = io.BytesIO(), io.BytesIO()
    DsrcModule(params, device=device).compress(io.BytesIO(data), arch)
    arch.seek(0)
    DsrcModule(params, device=device).decompress(arch, out)
    got, want = out.getvalue().split(b"\n"), data.split(b"\n")
    if got[0::4] != want[0::4] or len(got) != len(want) or any(
            g != w and any(a != b and a != blank[0]
                           for a, b in zip(g, w))
            for g, w in zip(got[1::4], want[1::4])):
        raise AssertionError("lossy decode changed titles or bases")
    return out.getvalue()


def generic_phase(device, big: bytes, small: bytes, block64: bytes):
    """The -m1 path at full width (big: 128 MB) and the GENERIC options at
    8 MB (small: an 8 MB realistic file) on the card; then one 64 MB -m1
    block (block64) with IUPAC codes in its DNA (scheme A19, K4 launched
    once a block)."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.utils.synth import make_fastq
    gen = ("rans_encode", "ctx_decode", "hist")
    res = round_trip(device, "generic_m1_128MB", big, m1_params(64 * MB),
                     gen, keep_archive=True)
    big_archive = res.pop("archive")
    emit(res)
    p8 = m1_params(8 * MB)
    r8 = round_trip(device, "generic_m1_8MB", small, p8, gen)
    cpu = io.BytesIO()
    DsrcModule(p8, device="cpu").compress(io.BytesIO(small), cpu)
    if cpu.getvalue() != r8.pop("archive"):
        raise AssertionError("the 8 MB -m1 archive on the card differs from "
                             "the port's archive on the CPU")
    r8["equals_cpu_archive"] = True
    emit(r8)
    runs = [res, r8]
    variable = make_fastq(8 * MB // 170, 70, seed=83, variable_length=True)
    lossy = InputParameters(fastq_block_size_mb=8, lossy_quality=True,
                            quality_compression_level=2)
    for name, data, params, kern in (
            ("generic_d0q0_variable", variable,
             InputParameters(fastq_block_size_mb=8), gen),
            ("generic_lossy_q2_4level",
             lossy_fixed_point(device, realistic_of_size(
                 8 * MB - 1024, 84, "novaseq"), lossy), lossy, gen),
            ("generic_crc", small,
             m1_params(8 * MB, calculate_crc32=True), gen),
            ("generic_a19", with_iupac(small, 85),
             InputParameters(fastq_block_size_mb=8, dna_compression_level=1),
             gen + ("a19_decode",)),
            ("generic_m1_64MB_a19", with_iupac(block64, 86),
             m1_params(64 * MB), gen + ("a19_decode",))):
        r = round_trip(device, name, data, params, kern)
        r.pop("archive")
        a19_blocks = sum(d == "A19" for d, _ in r["schemes"])
        if kern[-1] == "a19_decode" and not (
                a19_blocks == r["launches"]["a19_decode"] >= 1):
            raise AssertionError(f"{name}: {a19_blocks} A19 blocks, "
                                 f"{r['launches']['a19_decode']} K4 "
                                 f"launches")
        emit(r)
        runs.append(r)
    return runs, big_archive


# --------------------------------------------------------------------------
# Phase 3: K5 (histogram) on the calls of the main path
# --------------------------------------------------------------------------

# integer operations per counted element: the mask and length tests, the
# range test, the bin arithmetic (clamp, multiply-add) and the atomic
HIST_OPS_PER_ELEM = 8


def _hist_call(form, vals, rows, cols, t0, nsym, nbins, ctx, mask,
               lengths) -> dict:
    """A K5 call as hist_kernels._launch is given it: its form (the
    wrapper's name), inputs and shape."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    return dict(form=form, vals=vals, rows=rows, cols=cols, t0=t0,
                nsym=nsym, nbins=nbins, ctx=ctx, mask=mask, lengths=lengths,
                route=HK._ROUTE or HK.hist_route(nbins, rows * cols))


def hist_capture(device, name: str, data: bytes, params=None) -> list:
    """One round trip of `data` through DsrcModule on the card with every
    K5 launch recorded: its form and a copy of its inputs (each wrapper
    reaches the card through hist_kernels._launch)."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    calls = []
    launch = HK._launch

    def record(form, hist, vals, ld, t0, rows, cols, hi_kind, nsym, nctx,
               nbins, ctx=None, mask=None, lengths=None):
        copy = lambda t: None if t is None else t.clone()  # noqa: E731
        calls.append(_hist_call(form, vals.clone(), rows, cols, t0, nsym,
                                nbins, copy(ctx), copy(mask), copy(lengths)))
        launch(form, hist, vals, ld, t0, rows, cols, hi_kind, nsym, nctx,
               nbins, ctx=ctx, mask=mask, lengths=lengths)
    HK._launch = record
    try:
        round_trip(device, name, data, params, kernels=("hist",))
    finally:
        HK._launch = launch
    return calls


def hist_plain_into(c, hist, chunk: int) -> None:
    """The plain version of K5 call c added into hist (its first nbins
    bins), over at most `chunk` elements at a time (rows of the context
    and positional forms), so that its temporaries stay small."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    rows, cols, nb = c["rows"], c["cols"], c["nbins"]
    if c["form"] == "hist_count":
        v = c["vals"].reshape(-1)
        m = None if c["mask"] is None else c["mask"].reshape(-1)
        for i in range(0, v.numel(), chunk):
            HK.hist_count_plain(hist, v[i:i + chunk],
                                None if m is None else m[i:i + chunk])
        return
    step = max(1, chunk // max(1, cols))
    for r in range(0, rows, step):
        if c["form"] == "hist_count_ctx":
            HK.hist_count_ctx_plain(hist, c["ctx"][r:r + step],
                                    c["vals"][r:r + step], c["nsym"],
                                    c["lengths"][r:r + step], c["t0"],
                                    c["t0"] + cols)
        else:
            hist[:nb] += HK.pos_hist_plain(c["vals"][r:r + step],
                                           min(step, rows - r),
                                           c["nsym"]).reshape(-1)


class HistPlainCheck:
    """While entered, every K5 launch (hist_kernels._launch) in this
    process is held to its plain version on the same inputs, exactly: the
    plain version adds into a copy of the caller's histogram
    (hist_plain_into, CHUNK elements at a time, so that the paths' peak
    device memory grows by at most about 100 MB), the launch adds into the
    histogram itself, and the two must be equal.  The launch is the main
    path's own, counted once as without the check; the check launches
    nothing.  `checked` counts the checked launches by form and bins; a
    difference raises in the launching thread and is kept in `failures`."""
    CHUNK = 1 << 24

    def __init__(self):
        self.checked, self.failures = {}, []
        self._lock = threading.Lock()

    def total(self) -> int:
        return sum(self.checked.values())

    def __enter__(self):
        from dsrc_tpu_torch.ops import hist_kernels as HK
        self._launch = launch = HK._launch

        def checked(form, hist, vals, ld, t0, rows, cols, hi_kind, nsym,
                    nctx, nbins, ctx=None, mask=None, lengths=None):
            want = hist.clone()
            hist_plain_into(_hist_call(form, vals, rows, cols, t0, nsym,
                                       nbins, ctx, mask, lengths), want,
                            self.CHUNK)
            launch(form, hist, vals, ld, t0, rows, cols, hi_kind, nsym,
                   nctx, nbins, ctx=ctx, mask=mask, lengths=lengths)
            if rows * cols == 0:
                return                      # _launch launched nothing
            e = _err(hist[:nbins], want[:nbins])
            key = f"{form}/{nbins}"
            with self._lock:
                self.checked[key] = self.checked.get(key, 0) + 1
                if e:
                    self.failures.append(f"{key} ({rows} x {cols}): max "
                                         f"abs err {e}")
            if e:
                raise AssertionError(f"K5 differs from its plain version "
                                     f"on a main path: {form}, {rows} x "
                                     f"{cols} into {nbins} bins, max abs "
                                     f"err {e}")
        HK._launch = checked
        return self

    def __exit__(self, *exc):
        from dsrc_tpu_torch.ops import hist_kernels as HK
        HK._launch = self._launch


def _hist_fn(c, hist, plain: bool):
    """A call of the recorded K5 call c, or of its plain version, adding
    into hist [nbins + 1] (the positional form returns its own)."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    if c["form"] == "hist_count":
        fn = HK.hist_count_plain if plain else HK.hist_count
        return lambda: fn(hist, c["vals"], c["mask"])
    if c["form"] == "hist_count_ctx":
        fn = HK.hist_count_ctx_plain if plain else HK.hist_count_ctx
        return lambda: fn(hist, c["ctx"], c["vals"], c["nsym"],
                          c["lengths"], c["t0"], c["t0"] + c["cols"])
    fn = HK.pos_hist_plain if plain else HK.pos_hist
    return lambda: fn(c["vals"], c["rows"], c["nsym"])


def _hist_counts(c, plain: bool):
    import torch
    hist = torch.zeros(c["nbins"] + 1, dtype=torch.int64,
                       device=c["vals"].device)
    out = _hist_fn(c, hist, plain)()
    return (hist[:-1] if out is None else out.reshape(-1)).clone()


def _library_fns(c, hist):
    """The library calls that count the same bins: today's index_add_ of
    the plain version's int32 ids (the dropped ones sent to the scratch
    bin) and torch.bincount of the same ids; for the positional form,
    today's bincount of the plain version's int64 keys (twice).  The ids
    are made once, outside the timed calls."""
    import torch
    from dsrc_tpu_torch.ops import hist_kernels as HK
    nb = c["nbins"]
    if c["form"] == "pos_hist":
        keys = HK.pos_bin_keys(c["vals"], c["rows"], c["nsym"]).reshape(-1)
        fn = lambda: torch.bincount(keys, minlength=nb)  # noqa: E731
        return fn, fn
    if c["form"] == "hist_count":
        ids = HK.flat_bin_ids(c["vals"], nb, c["mask"])
    else:
        ids = HK.ctx_bin_ids(c["ctx"], c["vals"], c["nsym"], c["lengths"],
                             c["t0"], c["t0"] + c["cols"], nb)
    ids = ids.reshape(-1).contiguous()
    ones = torch.ones(1, dtype=torch.int64, device=ids.device) \
        .expand(ids.numel())
    return (lambda: hist.index_add_(0, ids, ones),
            lambda: torch.bincount(ids, minlength=nb + 1))


def hist_bound(c, touched: int):
    """K5's bound inputs for one call: bytes (each input element read once:
    value, mask, context; the lengths; the bins the data touch read and
    written, where the positional form writes every bin of its new
    histogram) and integer operations (HIST_OPS_PER_ELEM an element)."""
    n = c["rows"] * c["cols"]
    nbytes = n * c["vals"].element_size()
    nbytes += n if c["mask"] is not None else 0
    nbytes += 4 * n if c["ctx"] is not None else 0
    nbytes += 4 * c["rows"] if c["lengths"] is not None else 0
    nbytes += 8 * c["nbins"] if c["form"] == "pos_hist" else 16 * touched
    return nbytes, HIST_OPS_PER_ELEM * n


def _sum(a, b):
    return None if a is None or b is None else a + b


def _on_route(route, fn):
    """fn() with every K5 launch on `route` (hist_kernels._ROUTE; None:
    hist_route's choice)."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    HK._ROUTE = route
    try:
        return fn()
    finally:
        HK._ROUTE = None


def _route_device_ms(fn, route: str, reps: int):
    """time_device_ms of fn with every K5 launch on `route`."""
    return _on_route(route, lambda: time_device_ms(fn, reps))


def k5_routes(nbins: int) -> list:
    """The routes of hist_kernels that can hold nbins bins."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    return [r for r in HK.ROUTES if HK.route_holds(r, nbins)]


def hist_checks(device, name: str, calls: list, reps: int = 10,
                routes=k5_routes) -> dict:
    """Each recorded call: K5 against its plain version on the card from
    an empty histogram, exact, on hist_route's route and on each of
    routes(nbins); then K5's time as the host issues the calls (`ms`) and
    on the device alone (`device_ms`), the plain version's, the library
    calls' and the bound (summed over the calls: each call's larger of
    its bytes and operations times); the device time on each of
    routes(nbins) (`shared_device_ms`, `global_device_ms`).  Prints one
    line per (form, bins, route) group and one for all calls; returns the
    sums."""
    import torch
    groups = {}
    for c in calls:
        want = _hist_counts(c, True)
        for route in [None] + routes(c["nbins"]):
            got = _on_route(route, lambda: _hist_counts(c, False))
            e = _err(got, want)
            if got.shape != want.shape or e:
                raise AssertionError(
                    f"K5 differs from its plain version on {name} "
                    f"{c['form']} ({c['rows']} x {c['cols']} into "
                    f"{c['nbins']} bins, route {route or c['route']}): max "
                    f"abs err {e}")
        nbytes, nops = hist_bound(c, int((want != 0).sum()))
        hist = torch.zeros(c["nbins"] + 1, dtype=torch.int64, device=device)
        k5 = _hist_fn(c, hist, False)
        index_add, bincount = _library_fns(c, hist)
        rec = dict(calls=1, elements=c["rows"] * c["cols"],
                   counted=int(want.sum()), max_abs_err=e,
                   ms=time_ms(k5, reps), device_ms=time_device_ms(k5, reps),
                   plain_ms=time_ms(_hist_fn(c, hist, True), 1),
                   library_ms=time_ms(index_add, reps),
                   bincount_ms=time_ms(bincount, reps),
                   bound_ms=bound(nbytes, nops)[0], bytes=nbytes, ops=nops)
        times = {f"{r}_device_ms": _route_device_ms(k5, r, reps)
                 for r in routes(c["nbins"])}
        del hist, index_add, bincount
        for key, extra in (((c["form"], c["nbins"], c["route"]), times),
                           (("all", 0, ""), {})):
            g = groups.setdefault(key, dict.fromkeys({**rec, **extra}, 0))
            for k, v in {**rec, **extra}.items():
                g[k] = max(g[k], v) if k == "max_abs_err" else _sum(g[k], v)
    for (form, nbins, route), g in sorted(groups.items()):
        emit({"phase": "kernels", "stream": f"{name}_hist", "form": form,
              "bins": nbins, "route": route, **g,
              "bound_by": bound(g["bytes"], g["ops"])[1]})
    total = groups[("all", 0, "")]
    total["bound_by"] = bound(total["bytes"], total["ops"])[1]
    return total


# the route sweep: (bins, elements a bin, routes).  The -m1 bands'
# 4,096 and the SEMI positional 100 x 64 up to 64 a bin; the mode-0
# titles' 32,768 and the shared route's widest up to 512
_DENSE = (1, 2, 4, 8, 16, 32, 64)
HIST_SWEEP = (
    [(b, k, ("shared", "global")) for b in (4096, 6400) for k in _DENSE]
    + [(b, k, ("shared", "global")) for b in (32768, 58112)
       for k in _DENSE + (128, 256, 512)])


def _crossovers(rows, a: str, b: str) -> dict:
    """For each (bins, ids) pair that timed routes a and b: the least
    density from which a is no slower than b at every density measured
    (None: never)."""
    out = {}
    for key in dict.fromkeys((r["bins"], r["ids"]) for r in rows):
        rs = [r for r in rows if (r["bins"], r["ids"]) == key
              and r.get(f"{a}_device_ms") and r.get(f"{b}_device_ms")]
        if not rs:
            continue
        wins = [r[f"{a}_device_ms"] <= r[f"{b}_device_ms"] for r in rs]
        at = [r["per_bin"] for i, r in enumerate(rs) if all(wins[i:])]
        out[f"{key[0]}_{key[1]}"] = at[0] if at else None
    return out


def hist_route_sweep(device, reps: int = 10, sweep=HIST_SWEEP,
                     pairs=(("shared", "global"),)) -> dict:
    """K5's device time on each route of `sweep`, flat form, at each
    width and density (elements a bin), for uniform ids and skewed ones
    (geometric, mean nbins / 16), drawn on the card from a seed; int32
    ids, uint8 at 32 bins and int16 at 256.  Each route's counts are held
    to the plain version's first, exactly.  With each (width, ids)
    pair's crossovers for each (a, b) of `pairs`: the least density from
    which route a is no slower than b at every density measured.  Sets no
    route: hist_route's thresholds are read from it."""
    import torch
    from dsrc_tpu_torch.ops import hist_kernels as HK
    gen = torch.Generator(device=device)
    gen.manual_seed(57)
    rows = []
    hist = None
    for nbins, k, routes in sweep:
        if hist is None or hist.numel() != nbins + 1:
            hist = torch.zeros(nbins + 1, dtype=torch.int64, device=device)
        dt = {32: torch.uint8, 256: torch.int16}.get(nbins, torch.int32)
        for dist in ("uniform", "skewed"):
            n = int(k * nbins)
            if dist == "uniform":
                ids = torch.randint(0, nbins, (n,), generator=gen,
                                    device=device, dtype=dt)
            else:
                ids = torch.empty(n, device=device).geometric_(
                    16 / nbins, generator=gen).sub_(1) \
                    .clamp_(max=nbins - 1).to(dt)
            want = torch.zeros_like(hist)
            HK.hist_count_plain(want, ids)
            for r in routes:
                got = torch.zeros_like(hist)
                _on_route(r, lambda: HK.hist_count(got, ids))
                e = _err(got[:-1], want[:-1])
                if e:
                    raise AssertionError(f"K5 on route {r}, {nbins} bins, "
                                         f"{n} {dist} ids: max abs err {e}")
            del want, got
            fn = lambda: HK.hist_count(hist, ids)  # noqa: E731
            rows.append({"bins": nbins, "ids": dist, "per_bin": k,
                         "elements": n, "route": HK.hist_route(nbins, n),
                         **{f"{r}_device_ms": _route_device_ms(fn, r, reps)
                            for r in routes}})
            del ids
    del hist
    cross = {f"{a}_vs_{b}": _crossovers(rows, a, b) for a, b in pairs}
    out = {"phase": "kernels", "stream": "hist_route_sweep",
           "shared_min_per_bin": HK.SHARED_MIN_PER_BIN,
           "crossover_per_bin": cross, "rows": rows}
    emit(out)
    return out


def hist_edge_checks(device) -> int:
    """K5 against its plain version on the card, exact, at the edges, on
    every route that can hold the bins: no element, 1, 15, 17 and 33; the
    shared route's boundary; every value type; one bin taking every
    element, and the last bin; a mask that drops everything; a base one
    element past an aligned address (with the mask's address agreeing and
    disagreeing); the quality contexts' widths at 0.125 and 16 a bin; a
    context band at an odd first column and one read by quads; positional
    P = 1, 4, 37, 100, 4,099 with a row stride past P; a 2^24-bin
    histogram (order-7 DNA, CTX8).  Returns the largest error."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.ops import hist_kernels as HK
    rng = np.random.default_rng(55)
    worst = 0

    def check(got, want, what):
        nonlocal worst
        e = _err(got, want)
        if e:
            raise AssertionError(f"K5 edge case {what}: max abs err {e}")
        worst = max(worst, e)

    def flat(ids, mask, nbins, what, cut=(0, 0)):
        """ids[cut[0]:], mask[cut[1]:] of equal lengths, each route."""
        ids = torch.from_numpy(np.ascontiguousarray(ids)).to(device)
        m = None if mask is None else torch.from_numpy(mask).to(device)
        n = ids.numel() - cut[0]
        ids = ids[cut[0]:]
        m = None if m is None else m[cut[1]:cut[1] + n]
        want = torch.zeros(nbins + 1, dtype=torch.int64, device=device)
        HK.hist_count_plain(want, ids, m)
        for route in k5_routes(nbins):
            got = torch.zeros_like(want)
            _on_route(route, lambda: HK.hist_count(got, ids, m))
            check(got[:-1], want[:-1], f"{what} {route}")

    budget = HK.HIST_SMEM_BUDGET // 4
    for n in (0, 1, 15, 17, 33):
        flat(rng.integers(0, 300, n), rng.random(n) < 0.5, 300, f"n={n}")
    for nbins in (budget, budget + 1):
        flat(np.minimum(rng.geometric(1e-4, 1 << 20) - 1, nbins + 5),
             None, nbins, f"{nbins} bins")
    for dt in (np.uint8, np.int16, np.int32, np.int64):
        for nbins in (200, 30_000):
            lo, hi = (0, 250) if dt == np.uint8 else (-50, nbins + 100)
            flat(rng.integers(lo, hi, 3_000_001).astype(dt),
                 rng.random(3_000_001) < 0.8, nbins,
                 f"{np.dtype(dt).name} {nbins} bins")
        # one element past an aligned base: the mask agreeing, disagreeing
        for cut in ((1, 1), (1, 0)):
            flat(rng.integers(0, 256, 1_000_017).astype(dt),
                 rng.random(1_000_017) < 0.7, 256,
                 f"{np.dtype(dt).name} cut {cut}", cut=cut)
    for nbins in (256, 4096, 1 << 18):
        for b in (nbins // 3, nbins - 1):
            flat(np.full(2_000_000, b, np.int32), None, nbins,
                 f"one bin {b} of {nbins}")
        flat(rng.integers(0, nbins, 1_000_000).astype(np.int32),
             np.zeros(1_000_000, bool), nbins, f"all masked {nbins}")
    for nbins in (58_113, 131_072, 1 << 18):
        for k in (0.125, 16):
            n = int(k * nbins)
            flat(np.minimum(rng.geometric(16 / nbins, n) - 1, nbins + 3),
                 rng.random(n) < 0.9, nbins, f"{nbins} bins {k} a bin")
    lanes = 2048
    # T = 301: no band read by quads; T = 304: an aligned band read so
    for (num_ctx, nsym), (t_steps, t0, t1) in itertools.product(
            ((4, 64), (4096, 64), (3059, 19)), ((301, 37, 294),
                                                (304, 64, 288))):
        nbins = num_ctx * nsym
        octx = torch.from_numpy(np.minimum(rng.geometric(
            0.01, (lanes, t_steps)) - 3, num_ctx + 2).astype(np.int32)) \
            .to(device)
        osym = torch.from_numpy(rng.integers(-1, nsym + 1, (lanes, t_steps))
                                .astype(np.int32)).to(device)
        lens = torch.from_numpy(rng.integers(0, t_steps + 1, lanes)
                                .astype(np.int32)).to(device)
        want = torch.zeros(nbins + 1, dtype=torch.int64, device=device)
        HK.hist_count_ctx_plain(want, octx, osym, nsym, lens, t0, t1)
        for route in k5_routes(nbins):
            got = torch.zeros_like(want)
            _on_route(route, lambda: HK.hist_count_ctx(
                got, octx, osym, nsym, lens, t0, t1))
            check(got[:-1], want[:-1],
                  f"context {nbins} T={t_steps} {route}")
    for p, nsym, dt in ((37, 64, np.uint8), (100, 64, np.int32),
                        (1, 19, np.int16), (4, 64, np.int64),
                        (4099, 64, np.uint8)):
        wide = torch.from_numpy(np.minimum(rng.geometric(
            0.1, (33_537, p + 3)) - 1, nsym - 1).astype(dt)).to(device)
        mat = wide[:, :p]
        want = HK.pos_hist_plain(mat, 33_411, nsym)
        for route in k5_routes(p * nsym):
            check(_on_route(route, lambda: HK.pos_hist(mat, 33_411, nsym)),
                  want,
                  f"positional P={p} {route}")
    flat(np.minimum(rng.geometric(1e-6, 1 << 22) - 1, (1 << 24) + 9),
         rng.random(1 << 22) < 0.9, 1 << 24, "2^24 bins")
    return worst


def hist_phase(device, m1_block: bytes, semi_block: bytes,
               mode0_block: bytes) -> dict:
    """K5 on the recorded calls of one round trip each of a 64 MB -m1
    block, an 8 MB SEMI block and an 8 MB mode-0 block (hist_checks: the
    times, and the route comparison), the route sweep, then the edge
    cases.  Returns {block: sums}, the sweep and the edges' error."""
    import torch
    out = {}
    for name, data, params in (("m1_64MB", m1_block, m1_params(64 * MB)),
                               ("semi_8MB", semi_block, None),
                               ("semi_mode0_8MB", mode0_block, None)):
        calls = hist_capture(device, f"hist_{name}", data, params)
        out[name] = hist_checks(device, name, calls)
        del calls
        torch.cuda.empty_cache()
    out["route_sweep"] = hist_route_sweep(device)["crossover_per_bin"]
    out["edge_max_abs_err"] = hist_edge_checks(device)
    return out


# --------------------------------------------------------------------------
# Phases 4-6: the main path through DsrcModule
# --------------------------------------------------------------------------

def round_trip(device, name: str, data: bytes, params=None,
               kernels=("rans_encode", "rans_decode", "hist"),
               keep_archive: bool = False) -> dict:
    """Compress and decompress `data` through DsrcModule on `device`, with
    the launch counts set to 0 just before and read just after; fails
    unless each of `kernels` was launched.  The archive is returned for
    inputs of up to one 8 MB block, or when keep_archive."""
    import torch
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.ops import rans_kernels as RK
    mod = DsrcModule(params, device=device)
    arch = io.BytesIO()
    out = io.BytesIO()
    RK.reset_launch_counts()
    t0 = time.perf_counter()
    info = mod.compress(io.BytesIO(data), arch)
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
    for k in kernels:
        if counts[k] == 0:
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
            "launches": counts, "schemes": info.schemes,
            "archive": arch.getvalue()
            if keep_archive or len(data) <= 8 * MB + 4096 else None}


def fastq_of_size(nbytes: int, seed: int, fixed_width: bool) -> bytes:
    """Synthetic Illumina FASTQ (read length 100) cut at the last whole
    record within nbytes."""
    import numpy as np
    from dsrc_tpu_torch.utils.synth import make_fastq_fast
    data = make_fastq_fast(nbytes // 240, 100, seed=seed,
                           fixed_width=fixed_width)
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4]
    return data[:int(ends[np.searchsorted(ends, nbytes) - 1]) + 1]


# each kernel's __global__ functions in csrc/ (each in an unnamed
# namespace), by its launch count's name; a profiler event names a
# template with its return type ("void (anonymous namespace)::f<...>(")
# and a plain function without ("(anonymous namespace)::f(")
KERNEL_FUNCTIONS = {
    "rans_encode": ("rans_encode_kernel",),
    "rans_decode": ("rans_decode_kernel",),
    "ctx_decode": ("ctx_decode_kernel",),
    "hist": ("shared_kernel", "global_kernel")}


def profile_round_trip(device, name: str, data: bytes, params=None,
                       kernels=("rans_encode", "rans_decode", "hist")
                       ) -> dict:
    """One round trip under torch.profiler: the device's busy time (union
    of its kernel and copy intervals) as a share of the wall time, and
    device time by kernel name.  `index_and_bincount_ms` splits PyTorch's
    index_add_ and bincount kernels by their whole names (template
    arguments included): the parser's int8 edge marks (ops/parser.py)
    from any histogram.  The profiler's own cost inflates the wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        launches = round_trip(device, name, data, params, kernels)["launches"]
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no work on the device")
    busy_us, end = 0.0, float("-inf")
    by_name, index_us = {}, {}
    for e in sorted(dev, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (t - s)
        if "indexFunc" in e.name or "istogram" in e.name \
                or "bincount" in e.name:
            index_us[e.name[:160]] = index_us.get(e.name[:160], 0.0) + t - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = {k: sum(v for n, v in by_name.items() if re.match(
        r"(void )?\(anonymous namespace\)::(%s)[<(]" % "|".join(gs), n))
        / 1e3 for k, gs in KERNEL_FUNCTIONS.items()}
    return {"phase": "profile", "path": name, "launches": launches,
            "wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "device_events": len(dev),
            "top_device_ms": {k: v / 1e3 for k, v in top},
            "index_and_bincount_ms": {k: v / 1e3 for k, v in index_us.items()},
            "kernel_device_ms": ours,
            "kernel_share_of_busy": {k: v / (busy_us / 1e3)
                                     for k, v in ours.items()}}


def golden(device) -> dict:
    """Golden archives decode byte-exactly; their inputs compress to the
    golden bytes (the settings tools/make_golden.py used)."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    out = {"phase": "golden"}
    for name, kw in (("golden_uniform", {}), ("golden_semi", {}),
                     ("golden_generic", dict(dna_compression_level=2,
                                             quality_compression_level=2)),
                     ("golden_lossy", dict(lossy_quality=True,
                                           quality_compression_level=1))):
        fq = open(os.path.join(DATA, name + ".fastq"), "rb").read()
        xz = open(os.path.join(DATA, name + ".xfqz"), "rb").read()
        dec = io.BytesIO()
        DsrcModule(device=device).decompress(io.BytesIO(xz), dec)
        if dec.getvalue() != fq:
            raise AssertionError(f"{name}.xfqz does not decode byte-exactly")
        arch = io.BytesIO()
        DsrcModule(InputParameters(fastq_block_size_bytes=1 << 17, **kw),
                   device=device).compress(io.BytesIO(fq), arch)
        if arch.getvalue() != xz:
            raise AssertionError(f"{name}: compressing its input does not "
                                 f"write the golden archive's bytes")
        out[name] = "decode and encode byte-exact"
    return out


# --------------------------------------------------------------------------
# SEMI title mode 0, colour space, the record API
# --------------------------------------------------------------------------

def cut_records(data: bytes, nbytes: int) -> bytes:
    """data cut at the last whole record within nbytes."""
    import numpy as np
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4]
    return data[:int(ends[np.searchsorted(ends, nbytes) - 1]) + 1]


def umi_fastq_of_size(nbytes: int, seed: int) -> bytes:
    """make_fastq_fast's Illumina reads (read length 100) with an 8-base UMI
    appended to each read name, as UMI-tools' extract writes it
    ("@SIM001.<i>_<UMI> INSTR:..."), cut at the last whole record within
    nbytes.  The UMI is a free-text field: every block takes SEMI title
    mode 0."""
    import numpy as np
    from dsrc_tpu_torch.utils.synth import make_fastq_fast
    n = nbytes // 240
    arr = np.frombuffer(make_fastq_fast(n, 100, seed=seed), np.uint8)
    ends = np.flatnonzero(arr == 10)[3::4]
    starts = np.concatenate([[0], ends[:-1] + 1])
    ndig = np.floor(np.log10(np.arange(1, n + 1))).astype(np.int64) + 1
    at = starts + len("@SIM001.") + ndig            # the name's first space
    rng = np.random.default_rng(seed)
    umi = np.concatenate([np.full((n, 1), ord("_"), np.uint8),
                          np.frombuffer(b"ACGT", np.uint8)[
                              rng.integers(0, 4, (n, 8))]], axis=1)
    out = np.insert(arr, np.repeat(at, 9), umi.ravel()).tobytes()
    return cut_records(out, nbytes)


def semi_title_modes(archive: bytes):
    """The title mode byte of each SEMI block of an archive (None for a
    block of another class)."""
    from dsrc_tpu_torch.io.archive import ArchiveReader
    from dsrc_tpu_torch.models import block as B
    from dsrc_tpu_torch.utils.bitio import BitReader
    rd = ArchiveReader(io.BytesIO(archive))
    modes = []
    for i in range(rd.num_blocks):
        blob = rd.read_block(i)
        if blob[0] != B.BLOCK_SEMI:
            modes.append(None)
            continue
        r = BitReader(blob[1:])
        _n, rpad, _rl = (r.get_varint() for _ in range(3))
        B._get_wire(r, rpad)
        r.get_byte()                                # quality mode
        modes.append(r.get_byte())
    return modes


def semi_mode0_phase(device, data: bytes):
    """-m0 on free-text titles: the whole file on the card (every block
    title mode 0, byte-exact), and one 8 MB block's archive on the card
    equal to the port's archive of it on the CPU."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.io.chunker import FastqChunker
    kern = ("rans_encode", "rans_decode", "ctx_decode", "hist")
    res = round_trip(device, "semi_mode0", data, None, kern,
                     keep_archive=True)
    archive = res.pop("archive")
    modes = semi_title_modes(archive)
    if modes != [0] * len(modes):
        raise AssertionError(f"semi_mode0: title modes {modes}, not all 0")
    res["title_modes"] = modes
    emit(res)
    block0 = FastqChunker(io.BytesIO(data), 8 * MB).next_block().tobytes()
    r8 = round_trip(device, "semi_mode0_8MB_block", block0, None, kern)
    cpu = io.BytesIO()
    DsrcModule(device="cpu").compress(io.BytesIO(block0), cpu)
    if cpu.getvalue() != r8.pop("archive"):
        raise AssertionError("the 8 MB mode-0 archive on the card differs "
                             "from the port's archive on the CPU")
    r8["equals_cpu_archive"] = True
    emit(r8)
    return [res, r8], block0, archive


def solid_of_size(nbytes: int, seed: int) -> bytes:
    """SOLiD reads (a primer, 50 colours, '.' where a call failed) cut at
    the last whole record within nbytes."""
    from dsrc_tpu_torch.utils.synth import make_fastq
    return cut_records(make_fastq(nbytes // 150, 50, color_space=True,
                                  seed=seed), nbytes)


def colour_dna_stream(device, block: bytes, params):
    """The DNA stream of one colour-space GENERIC block as models/dna.py
    codes it at these settings: CTX8P (colour pairs, 64 symbols) or CTX8
    (8 symbols), for ctx_checks."""
    import numpy as np
    from dsrc_tpu_torch.api import analyze_first_block
    from dsrc_tpu_torch.models import block as B
    from dsrc_tpu_torch.models import dna as DNA
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    arr = np.frombuffer(block, np.uint8)
    shape = B.BlockShape.for_block_size(params.fastq_block_size_bytes)
    settings = params.to_settings()
    ds = analyze_first_block(arr, shape, device=device)
    if not ds.color_space:
        raise AssertionError("the colour block is not detected as SOLiD")
    g = B.BlockCodec(shape, settings, ds, device).stage_generic(arr)
    cap, n = shape.cap, g.dna_total
    nz = np.flatnonzero(DNA.dna_stats(g.dna, n, cap).cpu().numpy()[:19])
    if len(nz) != 5:
        raise AssertionError(f"colour symbols {nz.tolist()}, not 0123.")
    dense = DNA._dense(g.dna, nz)
    npairs = (n + 1) // 2
    if settings.dna_order >= 4 and n >= (1 << 16):
        ncp = C.stream_cap(cap // 2, npairs)
        lanes = C.pick_num_lanes(ncp)
        order = DNA._order8p_eff(settings.dna_order, npairs)
        return ctx_stream("dna_ctx8p", CK.CtxMode(
            CK.MODE_HISTORY, sbits=6, cmask=(1 << (6 * order)) - 1),
            1 << (6 * order), 64, C.band_edges(ncp // lanes),
            DNA._to_pairs(dense, n, cap, 8)[:ncp], npairs, ctx=(order, 6),
            lanes_n=lanes)
    nc = C.stream_cap(cap, n)
    lanes = C.pick_num_lanes(nc)
    order = DNA._order8_eff(settings.dna_order, n)
    return ctx_stream("dna_ctx8", CK.CtxMode(
        CK.MODE_HISTORY, sbits=3, cmask=(1 << (3 * order)) - 1),
        1 << (3 * order), 8, C.band_edges(nc // lanes), dense[:nc], n,
        ctx=(order, 3), lanes_n=lanes)


def colour_phase(device, big: bytes):
    """Colour space on the card: the 64 MB -m1 file (one block), and 8 MB
    at -m1 (its archive equal to the port's CPU archive, K3 held against
    its plain version on every band of its DNA stream), -d0 -q0, -l (on
    its lossy fixed point) and -c."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    kern = ("rans_encode", "ctx_decode", "hist")
    runs = []
    res = round_trip(device, "colour_m1_64MB", big, m1_params(64 * MB),
                     kern)
    res.pop("archive")
    runs.append(res)
    small = cut_records(big, 8 * MB - 1024)
    p8 = m1_params(8 * MB)
    r8 = round_trip(device, "colour_m1_8MB", small, p8, kern)
    cpu = io.BytesIO()
    DsrcModule(p8, device="cpu").compress(io.BytesIO(small), cpu)
    if cpu.getvalue() != r8.pop("archive"):
        raise AssertionError("the 8 MB colour-space archive on the card "
                             "differs from the port's archive on the CPU")
    r8["equals_cpu_archive"] = True
    runs.append(r8)
    lossy = InputParameters(fastq_block_size_mb=8, lossy_quality=True)
    for name, data, params in (
            ("colour_d0q0_8MB", small, InputParameters(fastq_block_size_mb=8)),
            ("colour_lossy_8MB",
             lossy_fixed_point(device, small, lossy, blank=b"."), lossy),
            ("colour_crc_8MB", small,
             InputParameters(fastq_block_size_mb=8, calculate_crc32=True))):
        r = round_trip(device, name, data, params, kern)
        r.pop("archive")
        runs.append(r)
    for r in runs:
        if any(d not in ("CTX8", "CTX8P") for d, _ in r["schemes"]):
            raise AssertionError(f"{r['phase']}: DNA schemes {r['schemes']}")
        emit(r)
    recs = ctx_checks(device, [colour_dna_stream(device, small, p8)],
                      "8MB_colour", timed=False, check_plain=True)
    return runs, recs


def record_api_phase(device, m1_data: bytes, m1_archive: bytes,
                     n_records: int = 200_000):
    """The record API on the card: n_records records written through
    DsrcArchive and read back in order; then records [N - 500, N + 500)
    of the 128 MB -m1 archive, N its first block's record count, through
    DsrcArchive.read_records and through CLI -r, each against the input's
    records."""
    import numpy as np
    from dsrc_tpu_torch import cli
    from dsrc_tpu_torch.archive_api import DsrcArchive, iter_fastq_text
    from dsrc_tpu_torch.io.archive import ArchiveReader
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.utils.synth import make_fastq_fast
    out = {"phase": "record_api"}
    recs = list(iter_fastq_text(make_fastq_fast(n_records, 100, seed=95)))
    arch = io.BytesIO()
    RK.reset_launch_counts()
    t0 = time.perf_counter()
    with DsrcArchive(device=device) as a:
        a.start_compress(arch)
        for r in recs:
            a.write_next_record(r)
    t1 = time.perf_counter()
    arch.seek(0)
    got = []
    with DsrcArchive(device=device) as b:
        b.start_decompress(arch)
        while (r := b.read_next_record()) is not None:
            got.append(r)
    t2 = time.perf_counter()
    out["launches"] = RK.launch_counts()
    if got != recs:
        raise AssertionError("record API: records read back differ")
    if not (out["launches"]["rans_encode"] and out["launches"]["rans_decode"]
            and out["launches"]["hist"]):
        raise AssertionError("record API: K1, K2 or K5 was not launched")
    out.update(records=len(recs), write_s=t1 - t0, read_s=t2 - t1,
               archive_bytes=len(arch.getvalue()))

    n0 = ArchiveReader(io.BytesIO(m1_archive)).block_records[0]
    lo, hi = n0 - 500, n0 + 500
    ends = np.flatnonzero(np.frombuffer(m1_data, np.uint8) == 10)[3::4]
    want = m1_data[int(ends[lo - 1]) + 1:int(ends[hi - 1]) + 1]
    RK.reset_launch_counts()
    t0 = time.perf_counter()
    with DsrcArchive(device=device) as a:
        a.start_decompress(io.BytesIO(m1_archive))
        got = b"".join(r.to_bytes() for r in a.read_records(lo, hi))
    t1 = time.perf_counter()
    range_launches = RK.launch_counts()
    if got != want or not (range_launches["ctx_decode"]
                           and range_launches["hist"]):
        raise AssertionError("read_records across the block boundary "
                             "differs from the input's records")
    tmp = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(tmp, exist_ok=True)
    src, dst = os.path.join(tmp, "m1.xfqz"), os.path.join(tmp, "range.fastq")
    with open(src, "wb") as f:
        f.write(m1_archive)
    t2 = time.perf_counter()
    rc = cli.main(["d", f"-r{lo}:{hi}", src, dst], device=device)
    t3 = time.perf_counter()
    with open(dst, "rb") as f:
        cli_out = f.read()
    for path in (src, dst):
        os.remove(path)
    if rc != 0 or cli_out != want:
        raise AssertionError(f"CLI -r{lo}:{hi} (rc {rc}) differs from the "
                             f"input's records")
    out.update(range=[lo, hi], block_boundary=n0,
               read_records_s=t1 - t0, cli_r_s=t3 - t2,
               range_launches=range_launches)
    emit(out)
    return out


# --------------------------------------------------------------------------
# The mesh and distributed compression
# --------------------------------------------------------------------------

class count_calls:
    """Counts the calls of obj.<name> inside a with block: `as n` gives a
    one-element list."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.n = obj, name, [0]

    def __enter__(self):
        real = self.real = getattr(self.obj, self.name)
        n = self.n

        def counted(*a, **k):
            n[0] += 1
            return real(*a, **k)
        setattr(self.obj, self.name, counted)
        return n

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


class mesh_of:
    """Inside a with block, DsrcModule takes `devices` as its mesh (None:
    the one-device path) in place of api.local_device_mesh's answer."""

    def __init__(self, devices):
        self.devices = devices

    def __enter__(self):
        from dsrc_tpu_torch import api as A
        self.real = A.local_device_mesh
        A.local_device_mesh = lambda device: self.devices

    def __exit__(self, *exc):
        from dsrc_tpu_torch import api as A
        A.local_device_mesh = self.real


def _module_round_trip(device, devices, data: bytes):
    """data through DsrcModule(device=device).compress and decompress with
    `devices` as the mesh; (archive, decoded text, compress s, decompress
    s, counts of mesh paths, mesh batches and tag-section decodes)."""
    import torch
    from dsrc_tpu_torch import api as A
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.models import tag as TAG
    from dsrc_tpu_torch.parallel import mesh as M
    mod = DsrcModule(device=device)
    arch, back = io.BytesIO(), io.BytesIO()
    counts = {}
    with mesh_of(devices):
        with count_calls(A, "_mesh_compress_results") as path, \
                count_calls(M.MeshUniformCodec, "compress_blocks") as nu, \
                count_calls(M.MeshSemiCodec, "compress_blocks") as ns:
            t0 = time.perf_counter()
            mod.compress(io.BytesIO(data), arch)
            comp_s = time.perf_counter() - t0
        counts.update(compress_mesh_path=path[0],
                      compress_batches=nu[0] + ns[0])
        arch.seek(0)
        with count_calls(A, "_mesh_decompress_results") as path, \
                count_calls(M.MeshUniformCodec, "decompress_blocks") as nu, \
                count_calls(M.MeshSemiCodec, "decompress_blocks") as ns, \
                count_calls(TAG, "decode_tags") as tags:
            t0 = time.perf_counter()
            mod.decompress(arch, back)
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t0
        counts.update(decompress_mesh_path=path[0],
                      decompress_batches=nu[0] + ns[0],
                      tag_section_decodes=tags[0])
    return arch.getvalue(), back.getvalue(), comp_s, dec_s, counts


def _mesh_run(device, devices, name: str, data: bytes, one_archive: bytes,
              kernels) -> dict:
    """Compress and decompress data through DsrcModule with `devices` as
    its mesh, launch counts set to 0 just before and read just after; the
    archive must equal the one-device card archive and the decode be
    byte-exact.  Also counts the mesh batches and the tag-section decodes
    (title mode 0)."""
    from dsrc_tpu_torch.ops import rans_kernels as RK
    RK.reset_launch_counts()
    arch, text, comp_s, dec_s, counts = _module_round_trip(device, devices,
                                                           data)
    launches = RK.launch_counts()
    if arch != one_archive:
        raise AssertionError(f"{name}: the mesh archive differs from the "
                             f"one-device card archive")
    if text != data:
        raise AssertionError(f"{name}: the mesh round trip is not "
                             f"byte-exact")
    for k in kernels:
        if launches[k] == 0:
            raise AssertionError(f"{name}: kernel {k} was not launched on "
                                 f"the mesh path")
    modes = semi_title_modes(arch)
    mb = len(data) / MB
    return {"phase": "mesh", "path": name,
            "devices": [str(d) for d in devices],
            "input_bytes": len(data), "archive_bytes": len(arch),
            "equals_one_device_archive": True, "blocks": len(modes),
            "title_modes": modes, **counts,
            "compress_s": comp_s, "decompress_s": dec_s,
            "compress_MBps": mb / comp_s, "decompress_MBps": mb / dec_s,
            "launches": launches}


def _all_cards(device, semi: bytes, semi_archive: bytes) -> dict:
    """The SEMI file through DsrcModule(device="cuda"), which takes every
    visible card as its mesh, beside the one-device path on the same
    cards in the same call, in the order mesh, one, one, mesh."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.parallel import mesh as M
    cards = M.local_device_mesh("cuda")
    mb = len(semi) / MB
    rates = {"mesh": [], "one_device": []}
    RK.reset_launch_counts()
    for path in ("mesh", "one_device", "one_device", "mesh"):
        arch, back = io.BytesIO(), io.BytesIO()
        mod = DsrcModule(device="cuda")
        with mesh_of(cards if path == "mesh" else None):
            t0 = time.perf_counter()
            mod.compress(io.BytesIO(semi), arch)
            t1 = time.perf_counter()
            arch.seek(0)
            mod.decompress(arch, back)
            t2 = time.perf_counter()
        if arch.getvalue() != semi_archive or back.getvalue() != semi:
            raise AssertionError(f"mesh: DsrcModule over all cards ({path})"
                                 f" differs from the one-device archive")
        rates[path].append({"compress_MBps": mb / (t1 - t0),
                            "decompress_MBps": mb / (t2 - t1)})
    return {"devices": [str(d) for d in cards], **rates,
            "launches": RK.launch_counts()}


def mesh_phase(device, semi: bytes, semi_archive: bytes, umi: bytes,
               umi_archive: bytes):
    """The mesh over [cuda:0, cuda:0] (one host thread an entry): dryrun,
    then DsrcModule with that mesh on the 64 MB SEMI mode-2 file (four
    batches of two 8 MB blocks) and on the 64 MB mode-0 (UMI) file (block
    0 is not a mesh class, so compress takes the one-device path; the
    decode takes the mesh and parses each mode-0 blob once).  With two or
    more cards, the SEMI file through DsrcModule(device="cuda") over all of
    them, beside the one-device path."""
    import torch
    from dsrc_tpu_torch.parallel import mesh as M
    devices = [device, device]
    t0 = time.perf_counter()
    M.dryrun(devices)
    out = {"phase": "mesh", "nvidia_smi": card_info(),
           "dryrun_s": time.perf_counter() - t0}
    runs = [_mesh_run(device, devices, "semi_64MB", semi, semi_archive,
                      ("rans_encode", "rans_decode", "hist"))]
    if runs[0]["compress_batches"] != 4 or \
            runs[0]["decompress_batches"] != 4:
        raise AssertionError(f"mesh: the SEMI file took "
                             f"{runs[0]['compress_batches']} batches, not 4")
    runs.append(_mesh_run(device, devices, "semi_mode0_64MB", umi,
                          umi_archive, ("rans_encode", "rans_decode",
                                        "ctx_decode", "hist")))
    if runs[1]["decompress_mesh_path"] != 1 or \
            runs[1]["tag_section_decodes"] != runs[1]["title_modes"].count(0):
        raise AssertionError("mesh: a mode-0 blob's tag section was decoded "
                             "more than once, or not through the mesh")
    out["multi_card"] = torch.cuda.device_count() >= 2
    if out["multi_card"]:
        out["all_cards"] = _all_cards(device, semi, semi_archive)
    out["runs"] = runs
    emit(out)
    return out


def _distributed_child(argv) -> int:
    """One process of the distributed phase: chip_smoke.py
    --distributed-child RANK WORLD PORT IN OUT PRESET BLOCK_BYTES BACKEND
    (gloo: every process on cuda:0; nccl: process r on cuda:r)."""
    import torch
    import torch.distributed as dist
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.ops import rans_kernels as RK
    rank, world, port, src, dst, preset, block, backend = argv
    card = torch.device("cuda", int(rank) if backend == "nccl" else 0)
    torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    params = InputParameters.preset(int(preset)) if int(preset) else \
        InputParameters()
    params.fastq_block_size_bytes = int(block)
    RK.reset_launch_counts()
    t0 = time.perf_counter()
    with HistPlainCheck() as hist_check:
        DsrcModule(params, device=card).compress(src, dst, distributed=True)
        torch.cuda.synchronize()
    emit({"rank": int(rank), "compress_s": time.perf_counter() - t0,
          "launches": RK.launch_counts(),
          "hist_checked": hist_check.total()})
    dist.destroy_process_group()
    return 0


def distributed_run(device, name: str, data: bytes, one_archive: bytes,
                    preset: int, block: int, world: int = 2,
                    backend: str = "gloo", timeout: int = 300) -> dict:
    """`world` processes, each DsrcModule(device=its card).compress(in,
    out, distributed=True): under gloo all on cuda:0, under nccl one card
    a process.  The archive must equal the single-process card archive
    and decompress on the card to the input.  A child that fails or
    outlives the timeout fails the phase."""
    import socket
    import torch
    from dsrc_tpu_torch.api import DsrcModule
    tmp = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(tmp, exist_ok=True)
    src, dst = os.path.join(tmp, name + ".fastq"), \
        os.path.join(tmp, name + ".xfqz")
    with open(src, "wb") as f:
        f.write(data)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--distributed-child",
         str(r), str(world), str(port), src, dst, str(preset), str(block),
         backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(
                    1, timeout - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed {name}: rank {r} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    children = [json.loads([line for line in o.splitlines()
                            if line.startswith('{"rank"')][-1])
                for o in outs]
    with open(dst, "rb") as f:
        arch = f.read()
    for path in (src, dst):
        os.remove(path)
    if arch != one_archive:
        raise AssertionError(f"distributed {name}: the archive differs from "
                             f"the single-process card archive")
    back = io.BytesIO()
    t1 = time.perf_counter()
    DsrcModule(device=device).decompress(io.BytesIO(arch), back)
    torch.cuda.synchronize()
    if back.getvalue() != data:
        raise AssertionError(f"distributed {name}: the archive does not "
                             f"decompress to the input")
    launches = {k: sum(c["launches"][k] for c in children)
                for k in children[0]["launches"]}
    hist_checked = sum(c["hist_checked"] for c in children)
    if hist_checked != launches["hist"]:
        raise AssertionError(f"distributed {name}: {hist_checked} of "
                             f"{launches['hist']} K5 launches held to the "
                             f"plain version")
    for k in ("rans_encode", "hist"):
        if launches[k] == 0:
            raise AssertionError(f"distributed {name}: kernel {k} was not "
                                 f"launched")
    return {"path": name, "backend": backend, "processes": world,
            "input_bytes": len(data),
            "equals_single_process_archive": True, "wall_s": wall,
            "MBps": len(data) / MB / wall,
            "child_compress_s": [c["compress_s"] for c in children],
            "decompress_s": time.perf_counter() - t1, "launches": launches,
            "hist_checked": hist_checked}


def distributed_phase(device, semi: bytes, semi_archive: bytes, big: bytes,
                      big_archive: bytes) -> dict:
    """Two gloo processes on the one card: the 64 MB SEMI file (8 MB
    blocks) and the 128 MB -m1 file (64 MB blocks, one block a process).
    With two or more cards, also the SEMI file under nccl, one process a
    card."""
    import torch
    runs = [distributed_run(device, "semi_64MB", semi, semi_archive, 0,
                            8 * MB),
            distributed_run(device, "generic_m1_128MB", big, big_archive, 1,
                            64 * MB)]
    n = torch.cuda.device_count()
    if n >= 2:
        runs.append(distributed_run(device, "semi_64MB", semi, semi_archive,
                                    0, 8 * MB, world=n, backend="nccl"))
    out = {"phase": "distributed", "nvidia_smi": card_info(), "runs": runs}
    emit(out)
    return out


# --------------------------------------------------------------------------
# -m2 at its real block size, through the CLI on files
# --------------------------------------------------------------------------

def m2_input(big: bytes) -> bytes:
    """A realistic file of two full 256 MB blocks and the 128 MB -m1 file
    after them (a short block, padded to the full capacity).  Block 0 runs
    on the calling thread, then blocks 1 and 2 are on the card at once,
    one on each of DsrcModule's two workers."""
    return (realistic_of_size(256 * MB, seed=97)
            + realistic_of_size(256 * MB, seed=98) + big)


class cli_modules:
    """Inside a with block, the CLI builds its DsrcModule from a subclass
    that keeps each module it makes (`as mods`) and what its compress
    returned (`.info`)."""

    def __enter__(self):
        from dsrc_tpu_torch import api as A
        real = self.real = A.DsrcModule
        mods = []

        class Kept(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                mods.append(self)

            def compress(self, *a, **k):
                self.info = super().compress(*a, **k)
                return self.info
        A.DsrcModule = Kept
        return mods

    def __exit__(self, *exc):
        from dsrc_tpu_torch import api as A
        A.DsrcModule = self.real


class codec_intervals:
    """Inside a with block, every BlockCodec.compress and decompress call
    appends (op, block number, start, end) on the host clock to the list
    the block gives (`as spans`); decompress calls are numbered in the
    order they start.  Blocks whose spans overlap were on the card at
    once."""

    def __enter__(self):
        from dsrc_tpu_torch.models import block as B
        self.real = (B.BlockCodec.compress, B.BlockCodec.decompress)
        spans, started, lock = [], itertools.count(), threading.Lock()

        def timed(fn):
            def run(codec, arg, *rest):
                k = (rest[0] if rest else None) if fn is self.real[0] \
                    else next(started)
                t0 = time.perf_counter()
                try:
                    return fn(codec, arg, *rest)
                finally:
                    with lock:
                        spans.append((fn.__name__, k, t0,
                                      time.perf_counter()))
            return run
        B.BlockCodec.compress, B.BlockCodec.decompress = map(timed,
                                                             self.real)
        return spans

    def __exit__(self, *exc):
        from dsrc_tpu_torch.models import block as B
        B.BlockCodec.compress, B.BlockCodec.decompress = self.real


def cli_round_trip(device, name: str, data: bytes, opts) -> dict:
    """data through the CLI on files under build/chip_smoke/:
    `c <opts> in out`, then `d out back`, with the launch counts set to 0
    just before and read just after, and the device's peak memory of each
    (max_memory_allocated and max_memory_reserved after
    reset_peak_memory_stats), and each block codec call's span
    (codec_intervals).  The decoded file must equal the input; the archive
    is returned for inspection and the files are removed."""
    import torch
    from dsrc_tpu_torch import cli
    from dsrc_tpu_torch.ops import rans_kernels as RK
    tmp = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(tmp, exist_ok=True)
    src, arc, back = (os.path.join(tmp, name + ext)
                      for ext in (".fastq", ".xfqz", ".back.fastq"))
    with open(src, "wb") as f:
        f.write(data)
    torch.cuda.init()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    try:
        RK.reset_launch_counts()
        secs, peaks, reserved, rcs = [], [], [], []
        with cli_modules() as mods, codec_intervals() as spans:
            t_run = time.perf_counter()
            for argv in (["c", *opts, src, arc], ["d", arc, back]):
                torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                rcs.append(cli.main(argv, device=device))
                torch.cuda.synchronize(device)
                secs.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated(device))
                reserved.append(torch.cuda.max_memory_reserved(device))
        launches = RK.launch_counts()
        if rcs != [0, 0]:
            raise AssertionError(f"{name}: the CLI exited {rcs}")
        with open(back, "rb") as f:
            if f.read() != data:
                raise AssertionError(f"{name}: the CLI round trip is not "
                                     f"byte-exact")
        with open(arc, "rb") as f:
            archive = f.read()
    finally:
        for path in (src, arc, back):
            if os.path.exists(path):
                os.remove(path)
    mb = len(data) / MB
    return {"path": name, "cli": " ".join(opts), "input_bytes": len(data),
            "archive_bytes": len(archive),
            "ratio": len(data) / len(archive),
            "compress_s": secs[0], "decompress_s": secs[1],
            "compress_MBps": mb / secs[0], "decompress_MBps": mb / secs[1],
            "device_bytes_before": base,
            "peak_device_bytes_compress": peaks[0],
            "peak_device_bytes_decompress": peaks[1],
            "peak_reserved_bytes_compress": reserved[0],
            "peak_reserved_bytes_decompress": reserved[1],
            # seconds from the start of the compress, per block codec call
            "codec_spans": [(op, k, round(a - t_run, 3), round(b - t_run, 3))
                            for op, k, a, b in sorted(spans,
                                                      key=lambda x: x[2])],
            # host-clock seconds per stage, summed over the worker threads
            "compress_stage_s": dict(mods[0].last_stage_times.seconds),
            "decompress_stage_s": dict(mods[1].last_stage_times.seconds),
            "schemes": mods[0].info.schemes, "launches": launches,
            "archive": archive}


def m2_phase(device, data: bytes, m1=None) -> dict:
    """The -m2 preset at its real size: data (m2_input) through CLI
    `c -m2` and `d` on files (cli_round_trip), in at least three blocks
    (two in flight after block 0), the first a full one; K1 and K3
    launched; the card's block 0 equal to what
    DsrcModule(InputParameters.preset(2), device="cpu") writes for block
    0's text.  Each block's ratio is given, and m1 = (text, ratio of its
    -m1 archive) names the block whose text that is."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.io.archive import ArchiveReader
    from dsrc_tpu_torch.io.chunker import FastqChunker
    res = cli_round_trip(device, "m2", data, ["-m2"])
    archive = res.pop("archive")
    for k in ("rans_encode", "ctx_decode", "hist"):
        if res["launches"][k] == 0:
            raise AssertionError(f"m2: kernel {k} was not launched on the "
                                 f"-m2 path")
    params = InputParameters.preset(2)
    block_bytes = params.fastq_block_size_mb << 20
    card = ArchiveReader(io.BytesIO(archive))
    texts = list(FastqChunker(io.BytesIO(data), block_bytes))
    block0 = texts[0]
    res["block_ratios"] = [len(t) / n for t, n in zip(texts,
                                                      card.block_sizes)]
    if m1 is not None:
        res["m1_ratio_of_block"] = {
            i: m1[1] for i, t in enumerate(texts)
            if len(t) == len(m1[0]) and t.tobytes() == m1[0]}
    del texts
    if card.num_blocks < 3 or len(block0) < block_bytes - 1024:
        raise AssertionError(f"m2: {card.num_blocks} blocks, block 0 of "
                             f"{len(block0)} bytes: not a full block and "
                             f"two more")
    t0 = time.perf_counter()
    cpu = io.BytesIO()
    DsrcModule(params, device="cpu").compress(io.BytesIO(block0.tobytes()),
                                              cpu)
    cpu_s = time.perf_counter() - t0
    if ArchiveReader(io.BytesIO(cpu.getvalue())).read_block(0) != \
            card.read_block(0):
        raise AssertionError("m2: block 0 of the card's archive differs "
                             "from the port's CPU bytes")
    res.update(phase="m2", nvidia_smi=card_info(), blocks=card.num_blocks,
               block_bytes=block_bytes, block0_bytes=len(block0),
               block_records=card.block_records,
               block0_equals_cpu=True, cpu_block0_compress_s=cpu_s)
    emit(res)
    return res


# --------------------------------------------------------------------------
# -b1024: GENERIC blocks of the largest capacity the CLI accepts
# --------------------------------------------------------------------------

B1024_MB = 1024
B1024_BYTES_PER_CAP = 24     # two blocks in flight inside the card's 80 GB


def repeated_records(data: bytes, nbytes: int) -> bytes:
    """data repeated and cut at the last whole record within nbytes (made
    from the m2 phase's realistic records: fast, where making 2 GB of new
    records would take minutes)."""
    return cut_records(data * -(-nbytes // len(data)), nbytes)


def b1024_block(device, block: bytes) -> dict:
    """One GENERIC -d2 -q2 block of the -b1024 capacity through
    analyze_first_block and BlockCodec on the card: each stage's peak
    device memory (max_memory_allocated and max_memory_reserved after
    reset_peak_memory_stats, less what earlier phases left allocated
    and reserved), per byte of capacity; the decoded block equal to the
    input, K1 and K3 launched."""
    import numpy as np
    import torch
    from dsrc_tpu_torch.api import analyze_first_block
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.models.block import BlockCodec, BlockShape
    from dsrc_tpu_torch.ops import rans_kernels as RK
    params = InputParameters(dna_compression_level=2,
                             quality_compression_level=2,
                             fastq_block_size_mb=B1024_MB)
    shape = BlockShape.for_block_size(B1024_MB << 20)
    arr = np.frombuffer(block, np.uint8)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    base_reserved = torch.cuda.memory_reserved(device)
    out = {"phase": "b1024", "path": "one_block", "cli": "-b1024 -d2 -q2",
           "capacity": shape.cap, "block_bytes": len(block),
           "device_bytes_before": base, "reserved_bytes_before": base_reserved}

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        alloc = torch.cuda.max_memory_allocated(device) - base
        res_b = torch.cuda.max_memory_reserved(device) - base_reserved
        out.update({f"{name}_s": time.perf_counter() - t0,
                    f"{name}_peak_allocated_bytes": alloc,
                    f"{name}_peak_reserved_bytes": res_b,
                    f"{name}_allocated_per_cap": alloc / shape.cap,
                    f"{name}_reserved_per_cap": res_b / shape.cap})
        return res

    RK.reset_launch_counts()
    ds = stage("analyze", lambda: analyze_first_block(arr, shape,
                                                      device=device))
    codec = BlockCodec(shape, params.to_settings(), ds, device)
    blob, info = stage("compress", lambda: codec.compress(arr))
    text = stage("decompress", lambda: codec.decompress(blob))
    out["launches"] = RK.launch_counts()
    if text.tobytes() != block:
        raise AssertionError("b1024: the block's round trip is not "
                             "byte-exact")
    for k in ("rans_encode", "ctx_decode", "hist"):
        if out["launches"][k] == 0:
            raise AssertionError(f"b1024: kernel {k} was not launched")
    out.update(archive_bytes=len(blob), ratio=len(block) / len(blob),
               schemes=info.schemes,
               compress_MBps=len(block) / MB / out["compress_s"],
               decompress_MBps=len(block) / MB / out["decompress_s"])
    return out


def b1024_input(m2_data: bytes):
    """(one full -b1024 block, a file of two full -b1024 blocks and a
    100 MB third), from the m2 phase's records."""
    return (repeated_records(m2_data, B1024_MB << 20),
            repeated_records(m2_data, 2 * (B1024_MB << 20) + 100 * MB))


def b1024_phase(device, m2_data: bytes) -> dict:
    """The largest block size the CLI accepts (-b1024, capacity
    1,073,758,208 bytes) at -d2 -q2: one block alone (b1024_block), then
    CLI `c -b1024 -d2 -q2` and `d` on a file of two full 1 GB blocks and a
    short third (cli_round_trip): byte-exact, K1 and K3 launched, the
    peaks, and blocks 1 and 2 on the card at once (their compress spans
    overlap: block 0 runs on the calling thread, then the two workers).
    Returns the CLI run's line, with the block's line under "one_block"."""
    block, data = b1024_input(m2_data)
    one = b1024_block(device, block)
    del block
    one["nvidia_smi"] = card_info()
    emit(one)
    for name in ("analyze", "compress", "decompress"):
        if one[f"{name}_allocated_per_cap"] > B1024_BYTES_PER_CAP:
            raise AssertionError(
                f"b1024: {name} peaked at "
                f"{one[f'{name}_allocated_per_cap']:.2f} bytes of device "
                f"memory a byte of capacity, over {B1024_BYTES_PER_CAP}")
    res = cli_round_trip(device, "b1024", data, ["-b1024", "-d2", "-q2"])
    del res["archive"], data
    for k in ("rans_encode", "ctx_decode", "hist"):
        if res["launches"][k] == 0:
            raise AssertionError(f"b1024: kernel {k} was not launched on "
                                 f"the CLI path")
    spans = {k: (a, b) for op, k, a, b in res["codec_spans"]
             if op == "compress"}
    if len(spans) < 3:
        raise AssertionError(f"b1024: {len(spans)} blocks, not 3")
    overlap = min(spans[1][1], spans[2][1]) - max(spans[1][0], spans[2][0])
    if overlap <= 0:
        raise AssertionError("b1024: blocks 1 and 2 were not compressed at "
                             "the same time")
    cap = one["capacity"]
    res.update(phase="b1024", nvidia_smi=card_info(), capacity=cap,
               blocks_1_2_overlap_s=overlap,
               **{f"{k}_per_cap": res[k] / cap for k in (
                   "peak_device_bytes_compress",
                   "peak_device_bytes_decompress",
                   "peak_reserved_bytes_compress",
                   "peak_reserved_bytes_decompress")})
    emit(res)
    res["one_block"] = one
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from dsrc_tpu_torch.ops import cuda_build
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = card_info()
    from dsrc_tpu_torch.utils import native
    # whether native/libdsrc_host.so (built by `make -C native`, not here)
    # or its numpy fallbacks serve the host's stages in this run
    emit({"phase": "card", "nvidia_smi": smi, "torch_name": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "native_host_library": native.available()})

    t0 = time.perf_counter()
    import k4_variants
    least_build = k4_variants.build_least(os.path.join(ROOT, "build",
                                                       "chip_smoke"))
    try:
        cuda_build.load_all()
    finally:
        least_log = least_build.communicate()[0].decode(errors="replace")
    if least_build.returncode != 0:
        raise AssertionError(f"k4_variants' least step does not build:\n"
                             f"{least_log}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(cuda_build.SOURCES),
          "ptxas": cuda_build.build_usage()})

    streams = block_streams(device, (8 * MB) // 250, (8 * MB) // 250)
    records = kernel_checks(device, streams, reps=50)
    records["rans_encode"]["max_abs_err"] = max(
        records["rans_encode"]["max_abs_err"], all_freq_check(device))
    records["rans_decode"]["max_abs_err"] = max(
        records["rans_decode"]["max_abs_err"], oversized_table_check(device))

    # GENERIC: the context-model streams of an 8 MB -m1 block (K1 and K3
    # against their plain versions, every band), K4 on A19 streams, then
    # K3's and K1's times at the 64 MB block's shapes
    m1_8mb = realistic_of_size(8 * MB - 1024, seed=82)
    recs8 = ctx_checks(device, ctx_streams(device, m1_8mb, m1_params(8 * MB)),
                       "8MB", timed=False, check_plain=True)
    # K4 at n = 3.3 M (against its plain version too) and at the DNA
    # stream shapes of a 64 MB -m1 and a 256 MB -m2 block
    least = a19_least_step(device)
    emit(dict(phase="kernels", stream="a19_least_step", **least))
    a19 = {name: a19_check(device, n, name, least, plain=name == "a19")
           for n, name in A19_SHAPES}
    torch.cuda.empty_cache()
    from dsrc_tpu_torch.io.chunker import FastqChunker
    big = realistic_of_size(128 * MB - 4096, seed=81)
    block64 = FastqChunker(io.BytesIO(big), 64 * MB).next_block().tobytes()
    recs64 = ctx_checks(device, ctx_streams(device, block64,
                                            m1_params(64 * MB)),
                        "64MB", timed=True, check_plain=False)
    k3_plain = k3_plain_ms(recs64["quality"])
    recs256 = ctx_checks(device, m2_streams(device), "256MB_m2", timed=True,
                         check_plain=False)
    m2_lines = {k: {f: r[f] for f in (
        "route", "k1_device_ms", "k1_bound_ms", "k1_bound_by",
        "k3_device_ms", "k3_stream_bound_ms", "k3_stream_bound_by",
        "k3_chain_floor_ms")} for k, r in recs256.items()}
    del recs256
    torch.cuda.empty_cache()
    records["rans_encode"]["max_abs_err"] = max(
        [records["rans_encode"]["max_abs_err"]]
        + [r["k1_max_abs_err"] for r in recs8.values()])

    launches = {"rans_encode": 0, "rans_decode": 0, "ctx_decode": 0,
                "hist": 0, "a19_decode": 0}
    # phases 4-13 run with every K5 launch held to its plain version on its
    # own inputs (the distributed children hold their own)
    hist_check = HistPlainCheck().__enter__()
    # a little under 8 and 2 whole 8 MB blocks: the chunker cuts each block
    # at a record boundary
    semi = fastq_of_size(64 * MB - 4096, seed=7, fixed_width=False)
    res = round_trip(device, "semi", semi, keep_archive=True)
    semi_archive = res.pop("archive")
    emit(res)
    uni = fastq_of_size(16 * MB - 1024, seed=8, fixed_width=True)
    res_u = round_trip(device, "uniform", uni)
    res_u.pop("archive")
    emit(res_u)
    runs, big_archive = generic_phase(device, big, m1_8mb, block64)
    umi = umi_fastq_of_size(64 * MB - 4096, seed=93)
    mode0_runs, mode0_block, umi_archive = semi_mode0_phase(device, umi)
    colour_runs, colour_recs = colour_phase(
        device, solid_of_size(64 * MB - 4096, seed=94))
    rec_api = record_api_phase(device, big, big_archive)
    mesh = mesh_phase(device, semi, semi_archive, umi, umi_archive)
    dist_runs = distributed_phase(device, semi, semi_archive, big,
                                  big_archive)["runs"]
    del big_archive, semi_archive, umi_archive, umi
    m2_data = m2_input(big)
    m2 = m2_phase(device, m2_data, m1=(big, runs[0]["ratio"]))
    b1024 = b1024_phase(device, m2_data)
    del m2_data
    hist_check.__exit__(None, None, None)
    if hist_check.failures:
        raise AssertionError(f"K5 differs from its plain version on the "
                             f"main paths: {hist_check.failures[:5]}")
    torch.cuda.empty_cache()
    hist = hist_phase(device, block64, FastqChunker(
        io.BytesIO(semi), 8 * MB).next_block().tobytes(), mode0_block)
    for r in ([res, res_u] + runs + mode0_runs + colour_runs + [rec_api]
              + mesh["runs"] + dist_runs + [mesh.get("all_cards"), m2,
                                            b1024, b1024["one_block"]]):
        for k, n in (r or {"launches": {}})["launches"].items():
            launches[k] += n
    for k, n in rec_api["range_launches"].items():
        launches[k] += n
    # every counted K5 launch was checked; the check also saw the card's
    # uncounted ones (the distributed archives' decompress)
    hist_checked = hist_check.total() + sum(r["hist_checked"]
                                            for r in dist_runs)
    if hist_checked < launches["hist"]:
        raise AssertionError(f"{hist_checked} K5 launches held to the plain "
                             f"version, fewer than the {launches['hist']} "
                             f"counted")
    emit({"phase": "kernels", "stream": "hist_main_paths",
          "launches": launches["hist"], "checked": hist_checked,
          "checked_by_form_and_bins": hist_check.checked,
          "max_abs_err": 0})
    emit(golden(device))
    emit(profile_round_trip(device, "semi", semi))
    emit(profile_round_trip(device, "semi_mode0_8MB_block", mode0_block,
                            None, ("rans_encode", "rans_decode",
                                   "ctx_decode", "hist")))
    emit(profile_round_trip(device, "generic_m1_64MB_block", block64,
                            m1_params(64 * MB),
                            ("rans_encode", "ctx_decode", "hist")))

    records["rans_encode"]["max_abs_err"] = max(
        [records["rans_encode"]["max_abs_err"]]
        + [r["k1_max_abs_err"] for r in colour_recs.values()])
    q64 = recs64["quality"]
    records["ctx_decode"] = dict(
        max_abs_err=max(r["k3_max_abs_err"] for r in
                        list(recs8.values()) + list(colour_recs.values())),
        ms=q64["k3_ms"], plain_ms=k3_plain, bound_ms=q64["k3_stream_bound_ms"],
        bound_by=q64["k3_stream_bound_by"],
        # where each stream's table rows live, and the serial chain's floor
        # (the warp of lane 0 alone) beside the bytes bound, which a serial
        # decode cannot reach
        route={f"{size}_{k}": r["route"] for size, recs in
               (("8MB", recs8), ("64MB", recs64), ("8MB_colour", colour_recs))
               for k, r in recs.items()},
        chain_floor_ms=q64["k3_chain_floor_ms"], m2_shapes=m2_lines)
    m1h = hist["m1_64MB"]
    hist_blocks = ("m1_64MB", "semi_8MB", "semi_mode0_8MB")
    records["hist"] = dict(
        max_abs_err=max([hist["edge_max_abs_err"]]
                        + [hist[k]["max_abs_err"] for k in hist_blocks]),
        ms=m1h["ms"], plain_ms=m1h["plain_ms"], bound_ms=m1h["bound_ms"],
        bound_by=m1h["bound_by"], library_ms=m1h["library_ms"])
    a19_main = a19["a19"]
    records["a19_decode"] = dict(
        max_abs_err=max([a19_main["max_abs_err"]]
                        + [r["k2_max_abs_err"] for r in a19.values()]),
        ms=a19_main["ms"], plain_ms=a19_main["plain_ms"],
        bound_ms=a19_main["bound_ms"], bound_by=a19_main["bound_by"])
    replaces = {"rans_encode": "dsrc_tpu/ops/rans_pallas.py:73",
                "rans_decode": "dsrc_tpu/ops/rans_pallas.py:250",
                "ctx_decode": "dsrc_tpu/ops/ctx.py:160",
                "a19_decode": "dsrc_tpu/ops/rans.py:305",
                "hist": "dsrc_tpu/ops/ctx.py:134 (_hist_mxu) and "
                        "dsrc_tpu/parallel/uniform_pipeline.py:183 "
                        "(_pos_hist)"}
    sources = {"rans_encode": "dsrc_tpu_torch/csrc/rans_enc.cu",
               "rans_decode": "dsrc_tpu_torch/csrc/rans_dec.cu",
               "ctx_decode": "dsrc_tpu_torch/csrc/ctx_dec.cu",
               "a19_decode": "dsrc_tpu_torch/csrc/a19_dec.cu",
               "hist": "dsrc_tpu_torch/csrc/hist.cu"}
    kernels = [dict(name=k, route="cuda", source=sources[k],
                    replaces=replaces[k], launches=launches[k],
                    max_abs_err=records[k]["max_abs_err"],
                    ms=records[k]["ms"], plain_ms=records[k]["plain_ms"],
                    bound_ms=records[k]["bound_ms"],
                    bound_by=records[k]["bound_by"],
                    library_ms=records[k].get("library_ms"))
               for k in ("rans_encode", "rans_decode", "ctx_decode",
                         "a19_decode", "hist")]
    # K5: the sums over the calls of one 64 MB -m1 block's round trip;
    # device_ms with the host left out, bincount beside index_add_; the
    # main paths' launches held to the plain version (all of them)
    kernels[4].update(device_ms=m1h["device_ms"],
                      bincount_ms=m1h["bincount_ms"], calls=m1h["calls"],
                      per_block={k: {f: hist[k][f] for f in (
                          "calls", "elements", "ms", "device_ms", "plain_ms",
                          "library_ms", "bincount_ms", "bound_ms")}
                          for k in hist_blocks},
                      plain_checked_launches=hist_checked,
                      route_crossover_per_bin=hist["route_sweep"])
    # K4: device time, K2's route, both bounds and the chain floor at each
    # shape (n = 3.3 M first)
    kernels[3].update(shapes={name: {f: r[f] for f in (
        "n", "T", "L", "ms", "device_ms", "k2_ms", "k2_device_ms",
        "bound_ms", "bound_by", "chain_bound_ms", "chain_floor_ms",
        "k2_chain_floor_ms")} for name, r in a19.items()},
        least_step_ns=least["ns"])
    kernels[2].update(table_routes=records["ctx_decode"]["route"],
                      chain_floor_ms=records["ctx_decode"]["chain_floor_ms"],
                      m2_shapes=records["ctx_decode"]["m2_shapes"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-child"]:
        sys.exit(_distributed_child(sys.argv[2:]))
    sys.exit(main())
