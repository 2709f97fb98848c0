"""syncs_per_MiB.<op>: the program's count of reads of device values by the
host (its codec.sync spans: ops/streams.py to_numpy and item), a FASTQ MiB
(layer: the block codec's device work)."""
from yardstick import program


def read(run, part):
    return program.syncs_per_mib(run, part)
