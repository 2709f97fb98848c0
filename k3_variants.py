#!/usr/bin/env python3
"""Time variants of K3 (dsrc_tpu_torch/csrc/ctx_dec.cu) side by side on
one NVIDIA card, and measure what one step of a lane costs.

    python3 k3_variants.py --baseline OLD_ctx_dec.cu [--reps 5] [--out F]

Streams: the quality (mode 2), DNA-pair (mode 0) and title-text (mode 1)
context-model streams of one 8 MB and one 64 MB -m1 block of
make_fastq_realistic, encoded by K1.  A stream's decode is its band loop
(one launch a band) with the band tables precomputed from the encoder's
side, so that only K3 is timed (and three [L] state resets a call).

Variants, each decoding every stream to its encoded symbols:
  committed       the committed kernel, the route and row layout that
                  ctx_route and row_layout pick
  route_<r>       the committed kernel forced onto route r (where the card
                  grants its shared memory)
  lanes_<n>       the committed kernel at n lanes a warp (32/n threads a
                  lane), where the kernel has that layout for the alphabet
  holder_update   the committed source with kCandidateEntries = 0: the
                  holder of s shuffles (cum[s], cum[s+1]) and the lane then
                  updates x, at every row layout
  candidates_all  the committed source with kCandidateEntries = 8: each
                  thread forms the next x of its symbols and the holder's
                  x is shuffled, at every row layout
  baseline        the kernel at --baseline with its own C interface (the
                  int32 table, shared memory up to 48 KB, else device
                  memory), e.g. an earlier commit's source:
                  git show <commit>:dsrc_tpu_torch/csrc/ctx_dec.cu > F
All are built in parallel (nvcc, the port's flags, into
build/k3_variants/).  Times are the device's work per stream decode
(chip_smoke.time_device_ms over `reps` calls), taken with the variants in
order and again in reverse order.

The probe (the committed source built with -DK3_PROBE) reads clock64 on
the threads of lane 0 between the parts of each fast step (row load
issued, row arrived, the symbol's count, the shuffles of the holder's x,
the word pointer's update, next context) over the last band of each stream, once with every lane
running and once with the warp of lane 0 alone (its 32/t lanes): the
latter is the chain floor.  The committed kernel's time with that warp
alone is given beside it.  Prints one
JSON line per variant and per probe, then the card's name and power limit;
needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import io
import json
import os
import subprocess
import sys

import chip_smoke as CS

BUILD = os.path.join(CS.ROOT, "build", "k3_variants")
_CANDIDATES = "constexpr int kCandidateEntries = 1;"
# C interface of the baseline (dsrc_ctx_decode as b98c517 wrote it)
_P, _I = ctypes.c_void_p, ctypes.c_int
_BASE_ARGS = (_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I,
              _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P)
_BASE_SMEM = 48 * 1024
# the instantiations of the -m1 streams (mode, threads a lane, entries a
# thread, route): quality, DNA pairs, title text
_MAIN = ("ctx_decode_kernel<2,16,4,1>", "ctx_decode_kernel<0,16,1,0>",
         "ctx_decode_kernel<1,32,8,1>")
# the kernel's (threads a lane, entries a thread) pairs
_LAYOUTS = ((8, 1), (8, 2), (16, 1), (16, 2), (16, 4), (32, 1), (32, 2),
            (32, 4), (32, 8))


def build_all(baseline: str) -> dict:
    """Build every library in parallel: {name: (library, ptxas usage)}."""
    from dsrc_tpu_torch.ops import cuda_build
    src = open(os.path.join(cuda_build.CSRC, "ctx_dec.cu")).read()
    if src.count(_CANDIDATES) != 1:
        raise AssertionError("kCandidateEntries no longer matches "
                             "ctx_dec.cu")
    sources = {"committed": (src, ()),
               "holder_update": (src.replace(
                   _CANDIDATES, "constexpr int kCandidateEntries = 0;"), ()),
               "candidates_all": (src.replace(
                   _CANDIDATES, "constexpr int kCandidateEntries = 8;"), ()),
               "probe": (src, ("-DK3_PROBE",)),
               "baseline": (open(baseline).read(), ())}
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, (text, flags) in sources.items():
        cu = os.path.join(BUILD, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(BUILD, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC,
             *flags, "-o", lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise AssertionError(f"{name} does not build:\n{log[-4000:]}")
        out[name] = (lib, cuda_build.ptxas_usage(log))
    return out


class Stream:
    """One encoded context-model stream and its band tables."""

    def __init__(self, name, st):
        import torch
        from dsrc_tpu_torch.ops import ctx as C
        from dsrc_tpu_torch.ops import rans_kernels as RK
        from dsrc_tpu_torch.ops.rans import cum_from_freqs, quantize_counts
        self.name, self.st = name, st
        lanes, active, nsym = st["lanes"], st["active"], st["nsym"]
        self.t_steps, self.l = lanes.shape
        freq, cum = C.ctx_models(lanes, active, st["ctx"], st["num_ctx"],
                                 nsym, st["edges"])
        enc = RK.rans_encode_from_freqs(freq, cum, active)
        self.payload = CS._left_aligned(*enc).contiguous()
        self.states = enc[2]
        self.want = lanes.to(torch.int32)
        # band tables from the encoder's (ctx, sym): the decoder rebuilds
        # the same ones from its output
        nbins = st["num_ctx"] * nsym
        hist = torch.zeros(nbins, dtype=torch.int64, device=lanes.device)
        self.tables = []
        edges = st["edges"]
        for b in range(len(edges) - 1):
            t0, t1 = edges[b], edges[b + 1]
            self.tables.append(cum_from_freqs(quantize_counts(
                hist.view(st["num_ctx"], nsym))).contiguous())
            hist += C.hist_update(st["ctx"][t0:t1].to(torch.int64) * nsym
                                  + lanes[t0:t1].to(torch.int64),
                                  active[t0:t1], nbins)
        dev = lanes.device
        self.x = torch.empty(self.l, dtype=torch.int32, device=dev)
        self.wptr = torch.empty_like(self.x)
        self.carry = torch.empty_like(self.x)
        self.osym = torch.empty((self.l, self.t_steps), dtype=torch.int32,
                                device=dev)
        self.octx = torch.empty_like(self.osym)
        self.start = None           # (x, wptr, carry) a call starts from

    def reset(self):
        if self.start is None:
            self.x.copy_(self.states)
            self.wptr.zero_()
            self.carry.zero_()
        else:
            for v, w in zip((self.x, self.wptr, self.carry), self.start):
                v.copy_(w)

    def enter_last_band(self, lib: str, lanes):
        """Decode all bands but the last and start later calls there."""
        import torch
        self.start = None
        nb = len(self.st["edges"]) - 1
        committed_call(lib, self, route_of(self), lanes=lanes,
                       bands=range(nb - 1))()
        torch.cuda.synchronize()
        self.start = tuple(v.clone() for v in (self.x, self.wptr,
                                                self.carry))

    def check(self, who: str):
        import torch
        got = torch.where(self.st["active"], self.osym.T, 0)
        if not torch.equal(got, self.want):
            raise AssertionError(f"{who} does not decode {self.name}")


def committed_call(lib: str, s: Stream, route: str, lanes=None,
                   bands=None, layout=None):
    """A call that decodes the stream s (bands: which bands, default all)
    with the committed C interface of `lib` on `route` (layout: threads a
    lane and entries a thread, default row_layout's)."""
    import torch
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    fn = getattr(ctypes.CDLL(lib), "dsrc_ctx_decode")
    fn.argtypes = RK._SIGNATURES["dsrc_ctx_decode"][1]
    fn.restype = ctypes.c_int
    st, m = s.st, s.st["mode"]
    lags = sum(c << (8 * k) for k, c in enumerate(m.lags))
    nsym = st["nsym"]
    edges = st["edges"]
    bands = range(len(edges) - 1) if bands is None else bands
    threads, entries = layout or CK.row_layout(nsym)
    rows = [CK.rows_packed(t, threads * entries) if route == "global"
            else None for t in s.tables]
    dev = s.payload.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    aux = st["aux"]

    def call():
        s.reset()
        for b in bands:
            rc = fn(s.payload.data_ptr(), s.payload.shape[1], s.x.data_ptr(),
                    s.wptr.data_ptr(), s.carry.data_ptr(),
                    st["lengths"].data_ptr(), s.tables[b].data_ptr(),
                    None if rows[b] is None else rows[b].data_ptr(),
                    st["num_ctx"], nsym,
                    None if aux is None else aux.data_ptr(), edges[b],
                    edges[b + 1], s.t_steps, s.l if lanes is None else lanes,
                    m.kind, m.sbits, m.cmask, m.hb,
                    m.sbits if m.kind == CK.MODE_QUALITY else 0,
                    len(m.lags), lags, threads, entries,
                    CK.ROUTES.index(route), s.osym.data_ptr(),
                    s.octx.data_ptr(), dev.index or 0, stream)
            if rc != 0:
                raise AssertionError(f"{lib} on {s.name}: CUDA error {rc}")
    return call


def baseline_call(lib: str, s: Stream):
    import torch
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    fn = getattr(ctypes.CDLL(lib), "dsrc_ctx_decode")
    fn.argtypes = _BASE_ARGS
    fn.restype = ctypes.c_int
    st, m = s.st, s.st["mode"]
    lags = sum(c << (8 * k) for k, c in enumerate(m.lags))
    edges = st["edges"]
    dev = s.payload.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    aux = st["aux"]
    shared = int(s.tables[0].numel() * 4 <= _BASE_SMEM)

    def call():
        s.reset()
        for b in range(len(edges) - 1):
            rc = fn(s.payload.data_ptr(), s.payload.shape[1], s.x.data_ptr(),
                    s.wptr.data_ptr(), s.carry.data_ptr(),
                    st["lengths"].data_ptr(), s.tables[b].data_ptr(),
                    st["num_ctx"], st["nsym"],
                    None if aux is None else aux.data_ptr(), edges[b],
                    edges[b + 1], s.t_steps, s.l, m.kind, m.sbits, m.cmask,
                    m.hb, m.sbits if m.kind == CK.MODE_QUALITY else 0,
                    len(m.lags), lags, _groups32(st["nsym"]), shared,
                    s.osym.data_ptr(), s.octx.data_ptr(), dev.index or 0,
                    stream)
            if rc != 0:
                raise AssertionError(f"baseline on {s.name}: CUDA error {rc}")
    return call


def _groups32(nsym: int) -> int:
    g = -(-nsym // 32)
    return 1 << (g - 1).bit_length()


def layout_for(lanes_a_warp: int, nsym: int):
    """(threads, entries) at lanes_a_warp lanes a warp, or None where the
    kernel has no such layout."""
    threads = 32 // lanes_a_warp
    g = -(-nsym // threads)
    entries = 1 << (g - 1).bit_length()
    return (threads, entries) if (threads, entries) in _LAYOUTS else None


def route_of(s: Stream) -> str:
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    return CK.ctx_route(s.st["num_ctx"], s.st["nsym"])


def probe(lib: str, s: Stream, lanes) -> dict:
    """The probe's per-step parts on the last band of s (every lane
    running, or the first `lanes` lanes alone)."""
    import torch
    read = getattr(ctypes.CDLL(lib), "dsrc_k3_probe")
    read.argtypes = (ctypes.c_void_p,)
    read.restype = ctypes.c_int
    acc = (ctypes.c_ulonglong * 9)()
    nb = len(s.st["edges"]) - 1
    # run up to the last band, zero the sums, run the last band
    s.enter_last_band(lib, lanes)
    if read(ctypes.cast(acc, ctypes.c_void_p)) != 0:
        raise AssertionError("dsrc_k3_probe failed")
    committed_call(lib, s, route_of(s), lanes=lanes, bands=[nb - 1])()
    torch.cuda.synchronize()
    s.start = None
    if read(ctypes.cast(acc, ctypes.c_void_p)) != 0:
        raise AssertionError("dsrc_k3_probe failed")
    steps = max(1, acc[6])
    parts = ("issue", "row_load", "symbol", "x_shuffle", "word_pointer",
             "next_ctx")
    out = {f"{p}_cycles": acc[i] / steps for i, p in enumerate(parts)}
    out["marked_cycles"] = sum(acc[i] for i in range(6)) / steps
    out["lane_cycles_per_step"] = acc[7] / steps
    out["lane_ns_per_step"] = acc[8] / steps
    out["sm_ghz"] = acc[7] / acc[8] if acc[8] else None
    out["steps"] = acc[6]
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier ctx_dec.cu to time beside the "
                         "committed kernel")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write the lines to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    from dsrc_tpu_torch.io.chunker import FastqChunker
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    device = torch.device("cuda", 0)
    libs = build_all(args.baseline)
    streams = []
    big = CS.realistic_of_size(64 * CS.MB + 4096, seed=81)
    block64 = FastqChunker(io.BytesIO(big), 64 * CS.MB).next_block().tobytes()
    for size, block, params in (
            ("8MB", CS.realistic_of_size(8 * CS.MB - 1024, seed=82),
             CS.m1_params(8 * CS.MB)),
            ("64MB", block64, CS.m1_params(64 * CS.MB))):
        for st in CS.ctx_streams(device, block, params):
            streams.append(Stream(f"{size}_{st['name']}", st))
    committed = libs["committed"][0]
    calls = {}                                  # (variant, stream) -> call
    for s in streams:
        c, a = s.st["num_ctx"], s.st["nsym"]
        calls["committed", s.name] = committed_call(committed, s,
                                                    CK.ctx_route(c, a))
        for r in CK.ROUTES:
            if CK.route_smem_bytes(r, c, a) <= 227 * 1024:
                calls[f"route_{r}", s.name] = committed_call(committed, s, r)
        for n in (1, 2, 4):
            lay = layout_for(n, a)
            if lay is not None and lay != CK.row_layout(a):
                width = 4 * lay[0] * lay[1]
                route = "shared" if c * width <= CK.CTX_SMEM_BUDGET \
                    else "global"
                calls[f"lanes_{n}", s.name] = committed_call(
                    committed, s, route, layout=lay)
        for v in ("holder_update", "candidates_all"):
            calls[v, s.name] = committed_call(libs[v][0], s,
                                              CK.ctx_route(c, a))
        calls["baseline", s.name] = baseline_call(libs["baseline"][0], s)
    for (v, name), call in calls.items():
        s = next(x for x in streams if x.name == name)
        call()
        torch.cuda.synchronize()
        s.check(v)
    order = list(dict.fromkeys(v for v, _ in calls))
    ms = {key: [] for key in calls}
    for names in (order, order[::-1]):
        for v in names:
            for s in streams:
                if (v, s.name) in calls:
                    ms[v, s.name].append(
                        CS.time_device_ms(calls[v, s.name], args.reps))
    lines = []
    for v in order:
        line = {"variant": v, "decodes_every_stream": True}
        lib = libs.get(v, libs["committed"])
        line["ptxas"] = {k: u for k, u in lib[1].items()
                         if u["spill_stores"] or u["spill_loads"]} or \
            "no spills"
        line["registers"] = {k: u["registers"] for k, u in lib[1].items()
                             if k in _MAIN}
        for s in streams:
            if (v, s.name) in ms:
                t = ms[v, s.name]
                line[f"{s.name}_ms"] = t
                line[f"{s.name}_ns_per_step"] = (
                    None if None in t else sum(t) / len(t) * 1e6 / s.t_steps)
        lines.append(line)
        CS.emit(line)
    for s in streams:
        if not s.name.startswith("64MB"):
            continue
        line = {"probe": s.name, "route": route_of(s),
                "band": list(s.st["edges"][-2:])}
        line["all_lanes"] = probe(libs["probe"][0], s, None)
        one_warp = 32 // CK.row_layout(s.st["nsym"])[0]
        line["one_warp_alone"] = probe(libs["probe"][0], s, one_warp)
        nb = len(s.st["edges"]) - 1
        s.enter_last_band(committed, one_warp)
        t = CS.time_device_ms(committed_call(committed, s, route_of(s),
                                             lanes=one_warp, bands=[nb - 1]),
                              args.reps)
        s.start = None
        line["committed_one_warp_alone_ns_per_step"] = (
            None if t is None else
            t * 1e6 / (s.st["edges"][-1] - s.st["edges"][-2]))
        lines.append(line)
        CS.emit(line)
    info = {"card": CS.card_info(), "reps": args.reps}
    lines.append(info)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    print(info["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
