"""Record-at-a-time API demo of the port — counterpart of
examples/example2.py and the reference's examples/py/example2.py
(DsrcArchive + FastqFile): write records one by one into an archive, read
them back as records, and read one record by its index.

Usage: python -m dsrc_tpu_torch.examples.example2 [--device cuda|cpu]
           out.xfqz
"""
import argparse
import sys

from dsrc_tpu_torch import DsrcArchive, FastqRecord
from dsrc_tpu_torch.config import FieldMask, InputParameters


def main(argv):
    ap = argparse.ArgumentParser(
        description="write records into an archive and read them back")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain '
                         'PyTorch versions)')
    ap.add_argument("archive")
    args = ap.parse_args(argv)

    # ---- write: records produced here (they could also come from
    # FastqFile("reads.fastq"), which reads and writes FASTQ records)
    params = InputParameters(dna_compression_level=1,
                             quality_compression_level=1)
    writer = DsrcArchive(params, device=args.device)
    writer.start_compress(args.archive)
    for i in range(1000):
        writer.write_next_record(FastqRecord(
            tag=f"READ.{i + 1} lane:{i % 8}",
            sequence="ACGTACGTAAGGCCTT" * 4,
            quality="IIIIHHHHGGGGFFFF" * 4))
    writer.finish_compress()

    # ---- read back, record by record, then one record by its index
    reader = DsrcArchive(device=args.device)
    reader.start_decompress(args.archive)
    count = 0
    first = None
    while (rec := reader.read_next_record()) is not None:
        first = first or rec
        count += 1
    print(f"read {count} records; first: @{first.tag} "
          f"({len(first.sequence)} bp); record 500: "
          f"@{reader.read_record(500).tag}")
    reader.finish_decompress()

    # ---- lossy ID filtering: FieldMask selects 1-based title fields
    mask = FieldMask.only(1)      # keep only the "READ.<n>" field
    params2 = InputParameters(tag_preserve_mask=mask.mask)
    print("field-filter mask:", hex(params2.tag_preserve_mask))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
