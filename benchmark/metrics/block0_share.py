"""block0_share.<op>: the seconds of block 0's block span (run inline on
the calling thread before the workers start) over the operations' wall
seconds (layer: api, DsrcModule and the worker pipeline)."""
from yardstick import program


def read(run, part):
    return program.block0_share(run, part)
