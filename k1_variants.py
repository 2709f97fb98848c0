#!/usr/bin/env python3
"""Time variants of K1 (dsrc_tpu_torch/csrc/rans_enc.cu) side by side on
one NVIDIA card: the design choices of the committed kernel against the
alternatives it was chosen over.

    python3 k1_variants.py [--reps 200] [--out FILE.json]

Each variant is the committed source with one change made by text
substitution; a substitution that no longer matches the source raises, so
the list has to follow the kernel.  All variants are built in parallel
(nvcc, the port's flags, into build/k1_variants/) and launched through the
C entry point on preallocated outputs at the shapes of chip_smoke.py's
three 8 MB-block streams.  Each must write the payload, word counts and
states of rans_encode_plain.  Times are the device's work per launch
(chip_smoke.time_device_ms over `reps` launches), taken once with the
variants in order and once in reverse order.  Prints one JSON line per
variant, then the card's name and power limit; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as CS

BUILD = os.path.join(CS.ROOT, "build", "k1_variants")

_PRODUCERS = "constexpr int kProducers = 8;"
_CHUNK = "constexpr int kChunk = 32;"
_BLOCKS = "  const int blocks = (lanes + 31) / 32;\n"
_SUCCESSORS = """\
        const uint32_t x0 = step(x, e.y, sh, cm, e.w);
        const uint32_t x1 = step(x >> 16, e.y, sh, cm, e.w);
        x = emit ? x1 : x0;
"""
# name -> (what differs from the committed kernel, substitutions)
VARIANTS = {
    "committed": ("8 producer warps, 32-step chunks", []),
    "producers_2": ("2 producer warps", [
        (_PRODUCERS, "constexpr int kProducers = 2;")]),
    "producers_4": ("4 producer warps", [
        (_PRODUCERS, "constexpr int kProducers = 4;")]),
    "producers_16": ("16 producer warps", [
        (_PRODUCERS, "constexpr int kProducers = 16;")]),
    "chunk_16": ("16-step chunks", [(_CHUNK, "constexpr int kChunk = 16;")]),
    "chunk_64": ("64-step chunks (a 64 KB ring, opted in above 48 KB)", [
        (_CHUNK, "constexpr int kChunk = 64;"),
        ('static_assert(kRingBytes <= 48 * 1024, "the ring fits the default '
         'budget");', ""),
        (_BLOCKS, "  cudaFuncSetAttribute(rans_encode_kernel, "
                  "cudaFuncAttributeMaxDynamicSharedMemorySize, "
                  "static_cast<int>(kRingBytes));\n" + _BLOCKS)]),
    "magic_by_divide": ("m computed by a u64 divide when staging, no table", [
        ("const uint32_t m = __ldg(&kMagic.m[min(f, kM)]);",
         "const uint32_t m = static_cast<uint32_t>("
         "(((1ull << l) - f) << 32) / f + 1);")]),
    "branch_store": ("the pair store under an if, not predicated", [
        ("store_if(put, dst, acc);", "if (put) *dst = acc;")]),
    "one_successor": ("one successor of x, from a selected x", [
        (_SUCCESSORS, "        x = step(emit ? x >> 16 : x, e.y, sh, cm, "
                      "e.w);\n")]),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise AssertionError(f"substitution no longer matches "
                                 f"rans_enc.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    """Build every variant in parallel: {name: (library path, ptxas usage
    of rans_encode_kernel)}."""
    from dsrc_tpu_torch.ops import cuda_build
    src = open(os.path.join(cuda_build.CSRC, "rans_enc.cu")).read()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, (_what, subs) in VARIANTS.items():
        cu = os.path.join(BUILD, name + ".cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, subs))
        lib = os.path.join(BUILD, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC,
             "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise AssertionError(f"variant {name} does not build:\n{log}")
        out[name] = (lib, cuda_build.ptxas_usage(log)["rans_encode_kernel"])
    return out


def launcher(lib: str, freq, cum, active):
    """A call that launches the variant in `lib` on the given inputs into
    outputs allocated once; returns (call, outputs)."""
    import torch
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import payload_pairs
    fn = ctypes.CDLL(lib).dsrc_rans_encode
    fn.argtypes = RK._SIGNATURES["dsrc_rans_encode"][1]
    fn.restype = ctypes.c_int
    t_steps, lanes = freq.shape
    wp = payload_pairs(t_steps)
    dev = freq.device
    outs = (torch.empty((lanes, wp), dtype=torch.int32, device=dev),
            torch.empty(lanes, dtype=torch.int32, device=dev),
            torch.empty(lanes, dtype=torch.int32, device=dev))
    args = (freq.data_ptr(), cum.data_ptr(), active.data_ptr(), t_steps,
            lanes, wp, *(o.data_ptr() for o in outs), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise AssertionError(f"{lib}: launch failed, CUDA error {rc}")
    return call, outs


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=None,
                    help="also write the variant lines to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    device = torch.device("cuda", 0)
    libs = build_all()
    streams = []
    for name, syms, num_rec, nsym, group in CS.block_streams(
            device, (8 * CS.MB) // 250, (8 * CS.MB) // 250):
        freq, cum, active, _ = UP.positional_models(syms, num_rec, nsym,
                                                    group)
        streams.append((name, freq.shape[0], (freq, cum, active),
                        RK.rans_encode_plain(freq, cum, active)))
    calls = {}
    for v, (lib, _usage) in libs.items():
        for s, _t, inputs, ref in streams:
            call, outs = launcher(lib, *inputs)
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                raise AssertionError(f"variant {v} differs from "
                                     f"rans_encode_plain on {s}")
            calls[v, s] = call
    order = list(VARIANTS)
    ms = {key: [] for key in calls}
    for names in (order, order[::-1]):
        for v in names:
            for s, *_ in streams:
                ms[v, s].append(CS.time_device_ms(calls[v, s], args.reps))
    lines = []
    for v in order:
        usage = libs[v][1]
        line = {"variant": v, "differs": VARIANTS[v][0], "bit_equal": True,
                "registers": usage["registers"],
                "spill_bytes": usage["spill_stores"] + usage["spill_loads"]}
        for s, t_steps, *_ in streams:
            line[f"{s}_ms"] = ms[v, s]
            line[f"{s}_ns_per_step"] = (
                None if None in ms[v, s]
                else sum(ms[v, s]) / 2 * 1e6 / t_steps)
        lines.append(line)
        CS.emit(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    print(CS.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
