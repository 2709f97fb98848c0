"""device_busy_ms_per_MiB.<op>: the union of the device's kernel and copy
intervals in the trace, in ms a FASTQ MiB (layer: the device)."""
from yardstick import record


def read(run, part):
    return record.device_busy_ms_per_mib(run, part)
