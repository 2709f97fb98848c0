"""codec_overlap.<op>: the benchmark's BlockCodec spans' seconds over the
operations' wall seconds: how many blocks are in the codec at once, on
average (layer: api, the whole-file pipeline)."""
from yardstick import record


def read(run, part):
    return record.codec_overlap(run, part)
