"""Whole-file library API of the port — the counterpart of dsrc_tpu/api.py
and of the reference's `dsrc::lib::DsrcModule` (DsrcModule.h:22).

`DsrcModule(device=...).compress/decompress` drive the pipeline: chunker ->
first-block dataset analysis -> BlockCodec -> archive, with block 0 run
inline while a reader thread reads the blocks after it, and the rest on
worker threads (parallel/pipeline.py).  The device defaults to "cuda";
"cpu" runs the plain PyTorch versions of the kernels.  Where two or more
cards are visible, UNIFORM and title mode 2 SEMI blocks run in batches of
one block a card (parallel/mesh.py); `compress(..., distributed=True)`
splits the blocks among the processes of a torch.distributed group
(parallel/distributed.py).  Every path writes the one-device bytes.
"""
from __future__ import annotations

import itertools
from typing import BinaryIO, Dict, Optional, Union

import numpy as np
import torch

from .config import (AUTO_QUALITY_OFFSET, DatasetType, DsrcException,
                     FieldMask, InputParameters)
from .io.archive import ArchiveReader, ArchiveWriter
from .io.chunker import FastqChunker
from .models.block import (BLOCK_SEMI, BLOCK_UNIFORM, BlockCodec,
                           BlockShape, StreamsInfo, host_stage_uniform,
                           parse_semi_block, read_uniform_block)
from .ops import parser as P
from .ops.streams import item
from .parallel import uniform_pipeline as UP
from .parallel.mesh import (MeshSemiCodec, MeshUniformCodec,
                            local_device_mesh, on_cards)
from .parallel.pipeline import ordered_parallel_map
from .utils import trace
from .utils.bitio import BitReader
from .utils.device import DEFAULT_DEVICE, resolve_device

#: the spans DsrcModule.last_stage_times reads
STAGES = ("api.read", "block", "api.write")


def analyze_first_block(block: np.ndarray, shape: BlockShape,
                        forced_offset: int = AUTO_QUALITY_OFFSET,
                        device=DEFAULT_DEVICE) -> DatasetType:
    """Dataset-type detection from the first chunk (reference
    FastqReader::AnalyzeFirstChunk, FastqIo.cpp:26-44)."""
    dev = resolve_device(device)
    # the block's own bytes (one zero byte when it is empty): the parse
    # and the analysis read nothing past them
    data = np.zeros(max(len(block), 1), np.uint8)
    data[:len(block)] = block
    data = torch.from_numpy(data).to(dev)
    parsed = P.parse_block(data, len(block), shape.rcap)
    if not item(parsed.valid):
        raise DsrcException("Error analyzing FASTQ dataset")
    d = P.analyze_block(data, parsed)
    if not item(d["plus_consistent"]):
        raise DsrcException("Error analyzing FASTQ dataset "
                            "(inconsistent '+' lines)")
    offset = forced_offset if forced_offset != AUTO_QUALITY_OFFSET \
        else item(d["quality_offset"])
    return DatasetType(quality_offset=offset,
                       plus_repetition=item(d["plus_repetition"]),
                       color_space=item(d["color_space"]))


class DsrcModule:
    """Whole-file compress/decompress with reference-equivalent knobs, on
    one device (default "cuda")."""

    def __init__(self, params: Optional[InputParameters] = None,
                 device=DEFAULT_DEVICE):
        self.params = params or InputParameters()
        self.device = resolve_device(device)
        self._last_op: Optional[int] = None

    @property
    def last_stage_times(self) -> Optional[Dict[str, trace.Total]]:
        """The recorder's totals (utils/trace.py) of api.read, block and
        api.write for the most recent compress or decompress call, by span
        name: seconds summed over threads, count and bytes.  None when the
        recorder was off for that call or has started a session since."""
        if self._last_op is None:
            return None
        by = trace.totals(self._last_op)
        return {k: by[k] for k in STAGES if k in by} or None

    # ---- Configurable-style properties (Configurable.h:45-90)
    @property
    def dna_compression_level(self) -> int:
        return self.params.dna_compression_level

    @dna_compression_level.setter
    def dna_compression_level(self, v: int) -> None:
        self.params.dna_compression_level = v
        self.params.validate()

    @property
    def quality_compression_level(self) -> int:
        return self.params.quality_compression_level

    @quality_compression_level.setter
    def quality_compression_level(self, v: int) -> None:
        self.params.quality_compression_level = v
        self.params.validate()

    @property
    def lossy_quality(self) -> bool:
        return self.params.lossy_quality

    @lossy_quality.setter
    def lossy_quality(self, v: bool) -> None:
        self.params.lossy_quality = bool(v)

    @property
    def fastq_buffer_size_mb(self) -> int:
        return self.params.fastq_block_size_mb

    @fastq_buffer_size_mb.setter
    def fastq_buffer_size_mb(self, v: int) -> None:
        self.params.fastq_block_size_mb = int(v)
        self.params.validate()

    @property
    def crc32_checking(self) -> bool:
        return self.params.calculate_crc32

    @crc32_checking.setter
    def crc32_checking(self, v: bool) -> None:
        self.params.calculate_crc32 = bool(v)

    @property
    def tag_field_filter_mask(self) -> int:
        return self.params.tag_preserve_mask

    @tag_field_filter_mask.setter
    def tag_field_filter_mask(self, mask: Union[int, FieldMask]) -> None:
        self.params.tag_preserve_mask = (
            mask.mask if isinstance(mask, FieldMask) else int(mask))

    @property
    def quality_offset(self) -> int:
        return self.params.quality_offset

    @quality_offset.setter
    def quality_offset(self, v: int) -> None:
        self.params.quality_offset = int(v)
        self.params.validate()

    # ---- whole-file operations
    def compress(self, fastq_path: Union[str, BinaryIO],
                 dsrc_path: Union[str, BinaryIO],
                 distributed: bool = False) -> StreamsInfo:
        with trace.op("compress") as root:
            self._last_op = root and root.op
            return self._compress(fastq_path, dsrc_path, distributed, root)

    def _compress(self, fastq_path, dsrc_path, distributed: bool,
                  root) -> StreamsInfo:
        """compress(); root: its op.compress span (None while the recorder
        is off), which the spans of other threads run under."""
        if distributed:
            # every process of the torch.distributed group compresses its
            # share of the blocks and writes them at computed offsets: the
            # single-process archive's bytes
            from .parallel.distributed import compress_distributed
            if not (isinstance(fastq_path, str)
                    and isinstance(dsrc_path, str)):
                raise DsrcException(
                    "distributed compression requires file paths on a "
                    "shared filesystem")
            compress_distributed(fastq_path, dsrc_path, self.params,
                                 self.device)
            return StreamsInfo()
        params = self.params
        settings = params.to_settings()
        block_size = params.fastq_block_size_bytes or \
            (params.fastq_block_size_mb << 20)
        shape = BlockShape.for_block_size(block_size)
        own_in = isinstance(fastq_path, str)
        src = open(fastq_path, "rb") if own_in else fastq_path
        info_total = StreamsInfo()
        try:
            chunker = FastqChunker(src, block_size)
            nrecs = []              # the chunker's record counts, in order

            def read():
                got = _read(chunker.next_with_count, root,
                            lambda got: len(got[0]))
                if got is None:
                    return None
                nrecs.append(got[1])
                return got[0]

            first = read()
            if first is None:
                raise DsrcException("empty FASTQ input")
            with trace.span("api.analyze", len(first)):
                dataset = analyze_first_block(first, shape,
                                              params.quality_offset,
                                              self.device)
            codec = BlockCodec(shape, settings, dataset, self.device)
            writer = ArchiveWriter(dsrc_path, settings, dataset, block_size)

            def check(block):
                if len(block) > shape.cap:
                    raise DsrcException(
                        "FASTQ record larger than the block size; "
                        "increase the block size (-b)")
                return block

            def rest():
                while True:
                    block = read()
                    if block is None:
                        return
                    yield check(block)

            def job(indexed):
                index, block = indexed
                with trace.span("block", len(block), index, under=root):
                    blob, info = codec.compress(block, index)
                    if settings.calculate_crc32 and \
                            not codec.verify_checksum(blob):
                        raise DsrcException("CRC32 verification failed "
                                            "while compressing")
                    return blob, nrecs[index], info

            all_blocks = enumerate(itertools.chain([check(first)], rest()))
            # the mesh only when the first block is a mesh class (UNIFORM or
            # title mode 2 SEMI); otherwise the worker threads
            mesh = local_device_mesh(self.device)
            if mesh is not None and codec._uniform_eligible() and (
                    host_stage_uniform(first, shape.cap) is not None
                    or codec.stage_semi_tok_for_mesh(first) is not None):
                results = _mesh_compress_results(all_blocks, codec, job, mesh)
            else:
                # block 0 runs inline while the reader reads the blocks
                # after it: when it is a semi block it seeds the semi hints
                # before worker threads start; a later block that seeds one
                # waits for the blocks before it (BlockCodec.seed_order)
                results = ordered_parallel_map(
                    all_blocks, job, params.num_workers or 2,
                    on_error=codec.seed_order.cancel, head=True)
            for blob, nrec, info in results:
                with trace.span("api.write", len(blob)):
                    writer.write_block(blob, nrec)
                info_total.add(info)
            with trace.span("api.write"):
                writer.finish()
        finally:
            if own_in:
                src.close()
        return info_total

    def decompress(self, dsrc_path: Union[str, BinaryIO],
                   fastq_path: Union[str, BinaryIO]) -> None:
        with trace.op("decompress") as root:
            self._last_op = root and root.op
            self._decompress(dsrc_path, fastq_path, root)

    def _decompress(self, dsrc_path, fastq_path, root) -> None:
        """decompress(); root as in _compress."""
        reader = ArchiveReader(dsrc_path)
        shape = BlockShape.for_block_size(reader.block_size_bytes)
        codec = BlockCodec(shape, reader.settings, reader.dataset,
                           self.device)
        own_out = isinstance(fastq_path, str)
        dst = open(fastq_path, "wb") if own_out else fastq_path
        try:
            def read_blobs():
                for i in range(reader.num_blocks):
                    yield _read(lambda: reader.read_block(i), root)

            def decode(indexed):
                index, blob = indexed
                with trace.span("block", block=index, under=root) as sp:
                    text = codec.decompress(blob)
                    if sp is not None:
                        sp.nbytes = text.nbytes
                    return text

            blobs = read_blobs()
            head_blob = next(blobs, None)
            if head_blob is not None:
                blobs = itertools.chain([head_blob], blobs)
            mesh = local_device_mesh(self.device)
            if mesh is not None and head_blob is not None and \
                    head_blob[0] in (BLOCK_UNIFORM, BLOCK_SEMI):
                texts = _mesh_decompress_results(blobs, codec, mesh)
            else:
                texts = ordered_parallel_map(
                    enumerate(blobs), decode, self.params.num_workers or 2,
                    head=True)
            for text in texts:
                with trace.span("api.write", text.nbytes):
                    dst.write(text.tobytes())
        finally:
            if own_out:
                dst.close()
            reader.close()


def _read(next_item, root, nbytes=len):
    """next_item() in an api.read span (on the reader thread, under the
    call's root span), with the bytes it read: nbytes of what it
    returned."""
    with trace.span("api.read", under=root) as sp:
        got = next_item()
        if sp is not None and got is not None:
            sp.nbytes = nbytes(got)
        return got


def _count_records(block: np.ndarray) -> int:
    """The records of a block of whole records, by its newlines (the
    chunker counts them as it cuts a block: FastqChunker.next_with_count)."""
    return int(np.count_nonzero(block == 10)) // 4


# --------------------------------------------------------------------------
# The mesh: UNIFORM and title mode 2 SEMI blocks in batches of one block a
# device (parallel/mesh.py); blocks of other classes, and batches shorter
# than the device list, go through the one-device codec in file order.
# --------------------------------------------------------------------------

_IN_ORDER = object()    # the SEMI staging is left to the consumer


def _mesh_compress_results(items, codec: BlockCodec, job, devices):
    """Generator of (blob, nrec, info) in file order, over (index, block)
    items: UNIFORM and title mode 2 SEMI blocks in batches of one block a
    device of `devices`.  A block of another class, a block that fails the
    device's uniformity check and a batch shorter than the device list go
    through job((index, block)), the one-device codec.

    The semi hints are seeded in file order, as on one device: until they
    are seeded, blocks are staged one at a time on this thread, and a
    pending UNIFORM batch is flushed before a later block is staged as SEMI
    (a pending block may fail the uniformity check and seed the hints
    itself).  Once they are seeded, staging is a pure function of the
    block, and it runs ahead of the batches on one host thread a device
    when the devices are cards (mesh.on_cards), as do the one-device
    codec's blocks of other classes.  Every block the mesh takes is marked
    decided in the codec's SeedOrder, so that a fallback block never waits
    for it."""
    n_dev = len(devices)
    order = codec.seed_order
    cap = codec.shape.cap

    def stage(item):
        """(index, block, UNIFORM host staging, SEMI staging, the
        one-device codec's result for a block of another class)."""
        index, block = item
        u = host_stage_uniform(block, cap)
        if u is not None:
            return index, block, u, None, None
        s = codec.stage_semi_tok_for_mesh(block)
        if s is not None:
            return index, block, None, s, None
        return index, block, None, None, job(item)

    def staged():
        it = iter(items)
        for index, block in it:
            if codec.semi_hints_seeded():
                rest = itertools.chain([(index, block)], it)
                yield from (ordered_parallel_map(rest, stage, n_dev)
                            if on_cards(devices) else map(stage, rest))
                return
            yield (index, block, host_stage_uniform(block, cap), _IN_ORDER,
                   None)

    def gen():
        ucodec = scodec = None
        pending = []           # [(payload, index, block)], one batch class
        kind = None            # the pending batch's class: "u" | "s"

        def flush():
            nonlocal pending
            batch, pending = pending, []
            if len(batch) < n_dev:
                for _, index, block in batch:
                    yield job((index, block))
                return
            if kind == "u":
                results, _ = ucodec.compress_blocks(
                    np.stack([m for (m, _), _, _ in batch]),
                    [n for (_, n), _, _ in batch])
                for ((_, n), index, block), res in zip(batch, results):
                    if res is None:      # failed the uniformity check
                        yield job((index, block))
                    else:
                        order.decided(index)
                        yield res[0], n, res[1]
            else:
                results, _ = scodec.compress_blocks([p for p, _, _ in batch])
                for (p, _, _), (blob, info) in zip(batch, results):
                    yield blob, p["num_rec"], info

        for index, block, u, semi, done in staged():
            if u is not None:
                mat, num_rec, spec, rpad = u
                if kind != "u" or not ucodec.matches(None, spec, rpad):
                    yield from flush()
                    kind = "u"
                    ucodec = MeshUniformCodec(devices, spec, rpad)
                pending.append(((mat, num_rec), index, block))
                if len(pending) == n_dev:
                    yield from flush()
                continue
            if kind == "u":
                yield from flush()
                kind = None
            if semi is _IN_ORDER:
                semi = codec.stage_semi_tok_for_mesh(block)
            if semi is not None:
                order.decided(index)
                sdict, read_len, rpad, pcs = semi
                if kind != "s" or not scodec.matches(read_len, rpad, pcs,
                                                     UP.WIRE_DEFAULT):
                    yield from flush()
                    kind = "s"
                    scodec = MeshSemiCodec(devices, read_len, rpad, pcs)
                pending.append((sdict, index, block))
                if len(pending) == n_dev:
                    yield from flush()
                continue
            yield from flush()
            kind = None
            yield done if done is not None else job((index, block))
        yield from flush()

    return gen()


def _mesh_decompress_results(blobs, codec: BlockCodec, devices):
    """Generator of decoded FASTQ text arrays in archive order: UNIFORM and
    title mode 2 SEMI blobs in batches of one block a device of
    `devices`.  Other blobs and short batches are decoded by the codec on
    its device; a title mode 0 SEMI blob is parsed once, and its parse is
    what is decoded."""
    n_dev = len(devices)

    def gen():
        ucodec = scodec = None
        pending = []           # [(payload, blob)], one batch class
        kind = None

        def flush():
            nonlocal pending
            batch, pending = pending, []
            if len(batch) < n_dev:
                for payload, blob in batch:
                    yield codec.decompress_parsed_semi(payload) \
                        if kind == "s" else codec.decompress(blob)
                return
            if kind == "u":
                yield from ucodec.decompress_blocks(
                    [c for (c, _), _ in batch], [n for (_, n), _ in batch])
            else:
                yield from scodec.decompress_blocks([p for p, _ in batch])

        for blob in blobs:
            if blob[0] == BLOCK_UNIFORM:
                r = BitReader(blob)
                r.get_byte()
                try:
                    comp_np, spec, num_rec, rpad, wire = \
                        read_uniform_block(r)
                except Exception:
                    yield from flush()
                    kind = None
                    yield codec.decompress(blob)
                    continue
                if kind != "u" or not ucodec.matches(comp_np, spec, rpad,
                                                     wire):
                    yield from flush()
                    kind = "u"
                    ucodec = MeshUniformCodec(devices, spec, rpad, wire)
                pending.append(((comp_np, num_rec), blob))
                if len(pending) == n_dev:
                    yield from flush()
                continue
            if blob[0] == BLOCK_SEMI:
                r = BitReader(blob)
                r.get_byte()
                try:
                    p = parse_semi_block(r, codec.shape.cap, codec.device)
                except Exception:
                    yield from flush()
                    kind = None
                    yield codec.decompress(blob)
                    continue
                if p["mode"] == 2:
                    if kind != "s" or not scodec.matches(
                            p["read_len"], p["rpad"], p["pcs"], p["wire"]):
                        yield from flush()
                        kind = "s"
                        scodec = MeshSemiCodec(devices, p["read_len"],
                                               p["rpad"], p["pcs"],
                                               p["wire"])
                    pending.append((p, blob))
                    if len(pending) == n_dev:
                        yield from flush()
                    continue
                yield from flush()
                kind = None
                yield codec.decompress_parsed_semi(p)
                continue
            yield from flush()
            kind = None
            yield codec.decompress(blob)
        yield from flush()

    return gen()


def compress(fastq_path, dsrc_path, device=DEFAULT_DEVICE,
             **kwargs) -> StreamsInfo:
    """One-shot: dsrc_tpu_torch.compress("in.fastq", "out.xfqz")."""
    return DsrcModule(InputParameters(**kwargs), device).compress(
        fastq_path, dsrc_path)


def decompress(dsrc_path, fastq_path, device=DEFAULT_DEVICE) -> None:
    """One-shot: dsrc_tpu_torch.decompress("in.xfqz", "out.fastq")."""
    DsrcModule(device=device).decompress(dsrc_path, fastq_path)
