"""Whole-file API demo of the port — counterpart of examples/example1.py
and the reference's examples/py/example1.py: compress a FASTQ file to an
archive and decompress it back, with a few configuration knobs.

Usage: python -m dsrc_tpu_torch.examples.example1 [--device cuda|cpu]
           in.fastq out.xfqz roundtrip.fastq
"""
import argparse
import sys

from dsrc_tpu_torch import DsrcModule, InputParameters


def main(argv):
    ap = argparse.ArgumentParser(
        description="compress a FASTQ file and decompress it back")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain '
                         'PyTorch versions)')
    ap.add_argument("fastq_in")
    ap.add_argument("archive")
    ap.add_argument("fastq_out")
    args = ap.parse_args(argv)

    module = DsrcModule(InputParameters(
        dna_compression_level=2,        # -d2
        quality_compression_level=2,    # -q2
        fastq_block_size_mb=8,          # -b8
        calculate_crc32=True,           # -c (per-block self-verification)
    ), device=args.device)
    info = module.compress(args.fastq_in, args.archive)
    for stream in ("tag", "dna", "quality"):
        print(f"{stream:8s} raw {info.raw[stream]:>12d} "
              f"compressed {info.comp[stream]:>12d}")

    module.decompress(args.archive, args.fastq_out)
    print("done; compare with e.g.  cmp", args.fastq_in, args.fastq_out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
