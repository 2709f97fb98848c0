"""k1_roofline.<op>: K1's share of its roofline, in %: the least time of
the work its algorithm needs (yardstick/work.py) over its device time in
the trace (layer: the kernels)."""
from yardstick import record, work

KERNEL = work.K1


def read(run, part):
    share = record.roofline_share(run, KERNEL, part)
    return None if share is None else share[0]
