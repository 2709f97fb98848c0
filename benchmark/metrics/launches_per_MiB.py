"""launches_per_MiB.<op>: the device's kernels, copies and sets in the
trace, a FASTQ MiB: the cost of issuing work from Python (layer: the block
codec's device work)."""
from yardstick import record


def read(run, part):
    return record.launches_per_mib(run, part)
