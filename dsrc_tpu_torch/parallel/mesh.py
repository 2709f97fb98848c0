"""Block-parallel compression over several devices: the port of
dsrc_tpu/parallel/mesh.py.

A batch of D blocks runs one block per entry of a device list.  Each block
goes through the port's one-device codec (UP.compress_uniform,
UP.compress_semi_tok and their decodes) on its own device, on a host thread
of its own, so that the cards overlap and so does the host work between
their kernels.  Payload bytes never move between devices; only each block's
size comes back, and the ordered merge of the reference's writer thread
becomes offset arithmetic on the host (cumsum(sizes) - sizes).

The device list is a plain list of torch.device and may name one device
more than once: [cpu] * 4 drives the batch logic on the CPU (in order on
one thread, see on_devices), [cuda:0] * 2 on one card.  DsrcModule takes
its list from local_device_mesh only (api.py).  A device that fails
raises; nothing falls back to one card.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.block import (BLOCK_SEMI, BLOCK_UNIFORM, StreamsInfo,
                            _rpad_bucket, decode_parsed_semi,
                            read_uniform_block, serialize_semi_tok_block,
                            serialize_uniform_block)
from ..ops.streams import to_numpy
from ..parallel import uniform_pipeline as UP
from ..utils.bitio import BitReader


def local_device_mesh(device) -> Optional[List[torch.device]]:
    """Every visible card (cuda:0 ... cuda:n-1) when `device` is a CUDA
    device and at least two cards are visible; else None."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def on_cards(devices: Sequence[torch.device]) -> bool:
    """Whether a device of the list is a card, so that its work takes host
    threads.  On the CPU the kernels' plain versions run small torch ops
    that take the GIL back after each op, so threads there only contend
    (four CPU entries took 5x as long on threads as in order)."""
    return any(torch.device(d).type == "cuda" for d in devices)


def on_devices(devices: Sequence[torch.device], fn: Callable,
               items: Sequence) -> list:
    """[fn(device, item) for each pair].  When a device is a card, one host
    thread a pair, and the first exception is raised after every thread has
    ended.  Otherwise the pairs run in order on the calling thread
    (on_cards)."""
    if not on_cards(devices):
        return [fn(d, x) for d, x in zip(devices, items)]
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(fn, d, x) for d, x in zip(devices, items)]
        return [f.result() for f in futures]


def _offsets(sizes: Sequence[int]) -> np.ndarray:
    s = np.asarray(sizes, np.int64)
    return np.cumsum(s) - s


class MeshUniformCodec:
    """Batch codec of UNIFORM (fixed-layout) blocks, one block a device."""

    def __init__(self, devices: Sequence[torch.device], spec: UP.UniformSpec,
                 rpad: int, wire: UP.Wire = UP.WIRE_DEFAULT):
        self.devices = [torch.device(d) for d in devices]
        self.spec = spec
        self.rpad = rpad
        self.wire = wire
        self.n_devices = len(self.devices)

    def _compress_one(self, device, item):
        mat, num_rec = item
        matd = torch.from_numpy(mat).to(device)
        if not UP.check_uniform(matd, self.spec, num_rec):
            return None
        comp = UP.compress_uniform(matd, num_rec, self.spec, self.rpad,
                                   wire=self.wire)
        return serialize_uniform_block(comp, self.spec, num_rec, self.rpad,
                                       wire=self.wire)

    def compress_blocks(self, mats: np.ndarray, num_recs: Sequence[int]
                        ) -> Tuple[List[Optional[Tuple[bytes, StreamsInfo]]],
                                   np.ndarray]:
        """mats: [D, rpad, rec_bytes] uint8, one block a device.  Returns
        ([D] of (blob, info), None where a block failed the uniformity
        check and must go through the one-device codec, and the blocks'
        offsets in the batch)."""
        assert len(mats) == self.n_devices, "one block per device"
        results = on_devices(self.devices, self._compress_one,
                             list(zip(mats, (int(n) for n in num_recs))))
        return results, _offsets([len(r[0]) if r else 0 for r in results])

    def matches(self, comp_np, spec, rpad, wire=None) -> bool:
        return (spec == self.spec and rpad == self.rpad
                and (wire is None or wire == self.wire))

    def _decompress_one(self, device, item):
        from ..convert import comp_from_numpy
        comp_np, num_rec = item
        mat = UP.decompress_uniform(comp_from_numpy(comp_np, device),
                                    self.spec, self.rpad, left=True,
                                    wire=self.wire)
        return to_numpy(mat[:num_rec]).reshape(-1)

    def decompress_blocks(self, comps: Sequence[dict],
                          num_recs: Sequence[int]) -> List[np.ndarray]:
        """comps: [D] numpy comp dicts from read_uniform_block.  Returns
        [D] decoded FASTQ text arrays."""
        assert len(comps) == self.n_devices
        return on_devices(self.devices, self._decompress_one,
                          list(zip(comps, (int(n) for n in num_recs))))


class MeshSemiCodec:
    """Batch codec of SEMI blocks with title mode 2 (fixed read length,
    tokenized numeric titles: the layout of real Illumina runs), one block
    a device."""

    def __init__(self, devices: Sequence[torch.device], read_len: int,
                 rpad: int, pcs: tuple, wire: UP.Wire = UP.WIRE_DEFAULT):
        self.devices = [torch.device(d) for d in devices]
        self.read_len = read_len
        self.rpad = rpad
        self.pcs = tuple(pcs)
        self.wire = wire
        self.n_devices = len(self.devices)

    def matches(self, read_len: int, rpad: int, pcs, wire) -> bool:
        return (read_len == self.read_len and rpad == self.rpad
                and tuple(pcs) == self.pcs and wire == self.wire)

    def _compress_one(self, device, s: dict):
        def dev(a):
            return torch.from_numpy(a).to(device)
        comp = UP.compress_semi_tok(dev(s["vmat"]), dev(s["v0"]),
                                    dev(s["qm"]), dev(s["sm"]), s["num_rec"],
                                    self.pcs, self.read_len, self.rpad,
                                    wire=self.wire)
        return serialize_semi_tok_block(
            comp, s["num_rec"], self.rpad, self.read_len, self.pcs, s["v0"],
            s["tok_meta"], s["tag_len"], wire=self.wire)

    def compress_blocks(self, staged: Sequence[dict]
                        ) -> Tuple[List[Tuple[bytes, StreamsInfo]],
                                   np.ndarray]:
        """staged: [D] dicts of BlockCodec.stage_semi_tok_for_mesh (vmat
        [rpad, F], v0 [F], qm/sm [rpad, read_len], num_rec, tok_meta,
        tag_len).  Returns ([D] of (blob, info), offsets in the batch)."""
        assert len(staged) == self.n_devices, "one block per device"
        results = on_devices(self.devices, self._compress_one, staged)
        return results, _offsets([len(r[0]) for r in results])

    def decompress_blocks(self, parsed: Sequence[dict]) -> List[np.ndarray]:
        """parsed: [D] mode-2 dicts of models.block.parse_semi_block.
        Returns [D] decoded FASTQ text arrays."""
        assert len(parsed) == self.n_devices
        return on_devices(self.devices,
                          lambda device, p: decode_parsed_semi(p, device),
                          parsed)


def dryrun(devices: Sequence[torch.device], records_per_block: int = 64,
           read_len: int = 40) -> None:
    """Round trip through the mesh codecs over `devices`: two batches of
    UNIFORM blocks and one of SEMI title mode 2 blocks, compressed,
    serialized, parsed back, decoded through the mesh and compared byte for
    byte with their inputs (the port's analogue of
    __graft_entry__.dryrun_multichip)."""
    from ..models import tag as TAG
    from ..models.block import parse_semi_block, semi_tok_planes, \
        stage_semi_raw
    from ..utils.synth import make_fastq_fast

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    spec = UP.detect_spec(make_fastq_fast(1, read_len, fixed_width=True))
    assert spec is not None
    rpad = _rpad_bucket(records_per_block)
    codec = MeshUniformCodec(devices, spec, rpad)

    blobs: List[bytes] = []
    originals: List[bytes] = []
    for batch in range(2):
        mats = np.zeros((n, rpad, spec.rec_bytes), np.uint8)
        for i in range(n):
            data = make_fastq_fast(records_per_block, read_len,
                                   seed=batch * n + i, fixed_width=True)
            originals.append(data)
            mats[i, :records_per_block] = np.frombuffer(
                data, np.uint8).reshape(records_per_block, spec.rec_bytes)
        results, offsets = codec.compress_blocks(
            mats, [records_per_block] * n)
        assert all(r is not None for r in results), "uniformity check failed"
        assert (np.diff(offsets) >= 0).all()
        blobs.extend(r[0] for r in results)

    for batch in range(2):
        comps, nrecs = [], []
        for blob in blobs[batch * n:(batch + 1) * n]:
            r = BitReader(blob)
            assert r.get_byte() == BLOCK_UNIFORM
            comp_np, spec2, nrec, rpad2, wire2 = read_uniform_block(r)
            assert codec.matches(comp_np, spec2, rpad2, wire2)
            comps.append(comp_np)
            nrecs.append(nrec)
        for i, text in enumerate(codec.decompress_blocks(comps, nrecs)):
            assert text.tobytes() == originals[batch * n + i], \
                f"mesh UNIFORM round trip differs on block {i}"

    semi_data: List[bytes] = []
    staged: List[dict] = []
    pcs_hint: dict = {}
    for i in range(n):
        data = make_fastq_fast(records_per_block, read_len, seed=100 + i,
                               fixed_width=False)
        semi_data.append(data)
        st = stage_semi_raw(np.frombuffer(data, np.uint8))
        assert st is not None
        rl2, num_rec, qm, sm, tstream, tl = st
        tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                       np.asarray(tl))
        assert tok is not None
        vmat, meta = tok
        v0, _ = semi_tok_planes(vmat, num_rec, pcs_hint)
        vpad = np.zeros((rpad, vmat.shape[1]), np.int32)
        vpad[:num_rec] = vmat
        staged.append(dict(vmat=vpad, v0=v0,
                           qm=np.ascontiguousarray(qm[:rpad]),
                           sm=np.ascontiguousarray(sm[:rpad]),
                           num_rec=num_rec, tok_meta=meta,
                           tag_len=len(tstream)))
    pcs = tuple(pcs_hint[f] for f in range(len(pcs_hint)))
    scodec = MeshSemiCodec(devices, rl2, rpad, pcs)
    sresults, soffsets = scodec.compress_blocks(staged)
    assert (np.diff(soffsets) >= 0).all()
    parsed = []
    for blob, _info in sresults:
        r = BitReader(blob)
        assert r.get_byte() == BLOCK_SEMI
        p = parse_semi_block(r, 1 << 22, devices[0])
        assert p["mode"] == 2
        assert scodec.matches(p["read_len"], p["rpad"], p["pcs"], p["wire"])
        parsed.append(p)
    for i, text in enumerate(scodec.decompress_blocks(parsed)):
        assert text.tobytes() == semi_data[i], \
            f"mesh SEMI round trip differs on block {i}"
