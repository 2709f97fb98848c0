"""The device trace of a traced run: torch.profiler over the window, read
back from its Chrome trace.

Every operation of the window runs inside a record_function range named
"bench.op.<index>", which gives its window in the trace's clock; the
trace's baseTimeNanoseconds is kept, to put the program's own spans on that
clock (yardstick/program.py).  The device events are the kernels, copies
and sets on the card, but those on the benchmark's own side stream, where
the kernel wrappers count the work of a call (yardstick/hooks.py): that
stream is found by the spin kernel that the session launches on it first.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Optional

from .record import Trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
OP_MARK = "bench.op."
_OP_RE = re.compile(r"^bench\.op\.(\d+)$")
SIDE_MARK = "spin_kernel"


class Session:
    """torch.profiler over the window (`with Session(side) as s:`), with
    s.op(index) around each operation; s.trace holds the result once the
    block has ended.  side: the benchmark's side stream (None on the
    CPU)."""

    def __init__(self, side=None):
        self.side = side
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.side is not None:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.side is not None:
            with torch.cuda.stream(self.side):
                torch.cuda._sleep(1000)
        return self

    def op(self, index: int):
        import torch
        return torch.profiler.record_function(f"{OP_MARK}{index}")

    def __exit__(self, *exc):
        import torch
        if self.side is not None:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = parse(json.load(f))
        finally:
            os.remove(path)
        return False


def parse(chrome: dict) -> Trace:
    """A Trace from a Chrome trace's events (torch.profiler's export)."""
    events = chrome.get("traceEvents", chrome) if isinstance(chrome, dict) \
        else chrome
    base = chrome.get("baseTimeNanoseconds") if isinstance(chrome, dict) \
        else None
    side = {(e.get("pid"), e.get("tid")) for e in events
            if e.get("cat") == "kernel" and SIDE_MARK in e.get("name", "")}
    device, host, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        name = e.get("name", "")
        if cat in DEVICE_CATS:
            if (e.get("pid"), e.get("tid")) not in side:
                device.append((s, t, name))
        elif cat in HOST_CATS:
            m = _OP_RE.match(name)
            if m:
                ops[int(m.group(1))] = (s, t)
            else:
                host.append((s, t, name))
    device.sort()
    host.sort()
    return Trace(device, ops, host, None if base is None else int(base))
