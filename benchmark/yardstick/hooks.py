"""The benchmark's own spans and kernel counts, patched onto the program
from outside for a traced run (nothing of this runs in an untraced one).

  Spans      every BlockCodec.compress and .decompress call: (kind, the
             window's operation, start, end) on the host clock (the
             pattern of chip_smoke.codec_intervals)
  KernelCalls  every call of a kernel's Python entry point, wrapped where
             its callers look it up (the pattern of chip_smoke.count_calls):
             the work its algorithm needs (yardstick/work.py).  On a card,
             a data-dependent count is computed on a side stream, after
             the call's work, and read once the window has closed.

The operation a span or call belongs to is `Current.op`, which the loop
sets before each operation of the window (operations run one at a time;
the program's worker threads run inside one).
"""
from __future__ import annotations

import importlib
import threading
import time
from typing import List, Optional, Sequence

from . import work
from .record import Call, Span


class Current:
    """The index of the window's operation in progress (None outside)."""
    op: Optional[int] = None


class Spans:
    """`with Spans() as spans:` records every BlockCodec call."""

    def __enter__(self) -> List[Span]:
        from dsrc_tpu_torch.models import block as B
        self.cls = B.BlockCodec
        self.real = (B.BlockCodec.compress, B.BlockCodec.decompress)
        spans: List[Span] = []
        lock = threading.Lock()

        def timed(fn, kind):
            def run(codec, *a, **k):
                op = Current.op
                t0 = time.perf_counter()
                try:
                    return fn(codec, *a, **k)
                finally:
                    t1 = time.perf_counter()
                    if op is not None:
                        with lock:
                            spans.append(Span(kind, op, t0, t1))
            return run
        self.cls.compress = timed(self.real[0], "compress")
        self.cls.decompress = timed(self.real[1], "decompress")
        return spans

    def __exit__(self, *exc):
        self.cls.compress, self.cls.decompress = self.real
        return False


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


class KernelCalls:
    """`with KernelCalls(kernels, side) as kc:` wraps each kernel's entry
    point at its call sites; kc.calls() gives the resolved Calls once the
    block has ended.  side: a CUDA stream for the counts, or None (the
    CPU: counted in line)."""

    def __init__(self, kernels: Sequence[work.Kernel], side=None):
        self.kernels = kernels
        self.side = side
        self.raw = []            # (op, kernel name, terms)
        self.patched = []        # (module, attribute, original)

    def _wrap(self, kernel: work.Kernel, real):
        import torch
        raw, side = self.raw, self.side

        def wrapped(*a, **k):
            out = real(*a, **k)
            op = Current.op
            if op is None:
                return out
            if side is None:
                terms = kernel.count(a, k, out)
            else:
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    terms = kernel.count(a, k, out)
                for t in _tensors((a, tuple(k.values()), out)):
                    if t.is_cuda:
                        t.record_stream(side)
            raw.append((op, kernel.name, terms))
            return out
        return wrapped

    def __enter__(self):
        for kernel in self.kernels:
            for mod_name, attr in kernel.sites:
                mod = importlib.import_module(mod_name)
                real = getattr(mod, attr, None)
                if real is None:
                    continue
                self.patched.append((mod, attr, real))
                setattr(mod, attr, self._wrap(kernel, real))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self.patched):
            setattr(mod, attr, real)
        self.patched = []
        return False

    def calls(self) -> List[Call]:
        if self.side is not None:
            self.side.synchronize()
        out = []
        for op, name, terms in self.raw:
            nbytes, nops = work.totals(terms)
            out.append(Call(op, name, nbytes, nops))
        return out
