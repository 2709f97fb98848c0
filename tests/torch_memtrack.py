"""Live tensor bytes of the port's CPU runs, as the card would hold them.

`LiveBytes` is a TorchDispatchMode: every storage that an op reads or
writes is counted once, from the first op that sees it, and a
weakref.finalize on the storage takes its bytes off again when it is
freed.  The peak of the count is what the device would have held at the
worst moment of the run, with two corrections for the CPU:

- the plain versions of the kernels (K1, K2, K3) run Python loops whose
  temporaries the kernels do not allocate; they run outside the mode, and
  what a plain version returns is counted when it returns (on the card
  the wrapper allocates exactly those outputs);
- a tensor that the card would copy from the host (`.to(device)` of a
  numpy array) is counted from its first op, as its device copy would be.

Imported by tests/test_torch_memory.py; pytest puts tests/ on the path.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from dsrc_tpu_torch.ops import ctx_kernels, rans_kernels

_PLAINS = ((rans_kernels, "rans_encode_plain"),
           (rans_kernels, "rans_decode_plain"),
           (ctx_kernels, "ctx_decode_band_plain"))


class LiveBytes(TorchDispatchMode):
    """Peak bytes of live tensor storages while the mode is active, and
    the number of tensor operations run (a plain kernel's loop counts
    none)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._seen = {}

    def _free(self, key, nbytes):
        if self._seen.pop(key, None) is not None:
            self.live -= nbytes

    def count(self, tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[key] = nbytes
            weakref.finalize(st, self._free, key, nbytes)
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        self.count(tree_flatten((args, kwargs))[0])
        self.count(tree_flatten(out)[0])
        return out

    @contextlib.contextmanager
    def plain_kernels_as_card(self):
        """Count a plain kernel's outputs, not its loop's temporaries."""
        saved = [(m, n, getattr(m, n)) for m, n in _PLAINS]

        def wrap(fn):
            def run(*args, **kw):
                with _disable_current_modes():
                    out = fn(*args, **kw)
                self.count(tree_flatten(out)[0])
                return out
            return run

        for m, n, fn in saved:
            setattr(m, n, wrap(fn))
        try:
            yield self
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)


def peak_bytes(fn):
    """(fn's result, LiveBytes of its run)."""
    mode = LiveBytes()
    with mode, mode.plain_kernels_as_card():
        out = fn()
    return out, mode


# --------------------------------------------------------------------------
# A per-stage table: PYTHONPATH=. python tests/torch_memtrack.py
# --------------------------------------------------------------------------

STAGES = (
    ("analysis", "api.py", "analyze_first_block"),
    ("analysis: parse", "ops/parser.py", "parse_block"),
    ("compress: stream gathers", "ops/parser.py", "gather_stream"),
    ("compress: forward transform", "models/block.py", "_forward_transform"),
    ("compress: quality encode", "models/quality.py", "encode_quality"),
    ("compress: quality CTX encode", "models/quality.py", "_encode_ctxq"),
    ("compress: DNA encode", "models/dna.py", "encode_dna"),
    ("decompress: quality decode", "models/quality.py", "decode_quality"),
    ("decompress: DNA decode", "models/dna.py", "decode_dna"),
    ("decompress: backward transform", "models/block.py",
     "_backward_transform"),
)


class StageBytes(LiveBytes):
    """LiveBytes that also keeps, for each function of STAGES, the peak
    while it is on the stack (the stack is read at each count)."""

    def __init__(self):
        super().__init__()
        self.stage_peak = {}

    def count(self, tensors) -> None:
        import sys
        super().count(tensors)
        f = sys._getframe(1)
        while f is not None:
            code = f.f_code
            for name, path, fn in STAGES:
                if code.co_name == fn and code.co_filename.endswith(path):
                    self.stage_peak[name] = max(
                        self.stage_peak.get(name, 0), self.live)
            f = f.f_back


def main() -> None:
    """Peak live bytes a byte of capacity, by stage, and the tensor
    operations, of one GENERIC -d2 -q2 block of
    make_fastq_realistic(16777) (capacity 4,374,528 bytes) and, for
    comparison, one -d0 -q0 block of the same reads (SEMI)."""
    import numpy as np
    from dsrc_tpu_torch.api import analyze_first_block
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.models.block import BlockCodec, BlockShape
    from dsrc_tpu_torch.utils.synth import make_fastq_realistic
    torch.set_num_threads(1)
    for kw in (dict(dna_compression_level=2, quality_compression_level=2),
               dict()):
        data = make_fastq_realistic(16777, read_len=100)
        shape = BlockShape.for_block_size(len(data))
        block = np.frombuffer(data, np.uint8)
        peaks = {}
        mode = StageBytes()
        with mode, mode.plain_kernels_as_card():
            ds = analyze_first_block(block, shape, device="cpu")
        peaks.update(mode.stage_peak)
        codec = BlockCodec(shape, InputParameters(**kw).to_settings(), ds,
                           device="cpu")
        out, ops = {}, {}
        for op, fn in (("compress", lambda: codec.compress(block)[0]),
                       ("decompress", lambda: codec.decompress(blob))):
            mode = StageBytes()
            with mode, mode.plain_kernels_as_card():
                res = fn()
            if op == "compress":
                blob = res
            else:
                assert res.tobytes() == data
            out[op] = mode.peak
            ops[op] = mode.ops
            peaks.update(mode.stage_peak)
        print(f"settings {kw or '-d0 -q0'}, capacity {shape.cap}, tensor "
              f"operations {ops}")
        for name, nbytes in list(out.items()) + [
                (n, peaks[n]) for n, _, _ in STAGES if n in peaks]:
            print(f"  {nbytes / shape.cap:7.2f}  {name}")


if __name__ == "__main__":
    main()
