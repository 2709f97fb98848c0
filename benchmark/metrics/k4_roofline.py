"""k4_roofline.<op>: K4's share of its roofline, in %: the least time of
the work its algorithm needs over its device time in the trace (layer: the
kernels).  K4 is the static order-0 rANS decode of DNA scheme A19
(dsrc_tpu_torch/ops/a19_kernels.py, csrc/a19_dec.cu); its count follows
yardstick/work.py's rules and lives here, beside its reader."""
from yardstick import record, work


def k4_count(args, kwargs, result):
    """a19_decode(payload, states, wptr, freqs, n, t) -> [L*t] uint8: the
    u16 words the lanes hold (from each lane's start word), each lane's
    state and start word, the table's fields read (a table entry each);
    the stream's n symbols written, a byte each.  Nothing is charged for
    the slot table the kernel builds from the fields."""
    payload = work._arg(args, kwargs, 0, "payload")
    wptr = work._arg(args, kwargs, 2, "wptr")
    freqs = work._arg(args, kwargs, 3, "freqs")
    n = int(work._arg(args, kwargs, 4, "n"))
    t = int(work._arg(args, kwargs, 5, "t"))
    lanes = payload.shape[0]
    return [(work.lane_words(payload, wptr), 2, 0),
            (lanes * 8 + len(freqs) * work.TABLE_BYTES, 1, 0),
            (max(0, min(n, lanes * t)), 1, work.DEC_OPS_PER_SYM)]


KERNEL = work.Kernel("k4", (("dsrc_tpu_torch.models.dna", "a19_decode"),),
                     ("a19_decode_kernel",), k4_count)


def read(run, part):
    share = record.roofline_share(run, KERNEL, part)
    return None if share is None else share[0]
