"""codec_ms_per_MiB.<op>: the benchmark's BlockCodec spans, summed, in ms
a FASTQ MiB (layer: models.block, the block codec on host and device)."""
from yardstick import record


def read(run, part):
    return record.codec_ms_per_mib(run, part)
