"""Whole-file compression across the processes of a torch.distributed
group: the port of dsrc_tpu/parallel/distributed.py.

Every process runs the same record-aligned chunk scan as a single-process
run, so the block boundaries are that run's.  Block i belongs to rank
i % world_size, and each process compresses its blocks on its own device.

The semi hints (lane bucket, plane counts) are seeded before any block is
compressed, by the blocks that seed them in a one-process run: the first
semi-layout block and the first title mode 2 block.  Each process looks
for them among its own blocks only, in file order
(BlockCodec.semi_hint_seeds), and a first all-gather gives every process
the lowest such block of the file.  So the archive is byte-identical to
DsrcModule.compress, and no process stages another's blocks.  A second
all-gather, of the per-block size vector, gives every process its blocks'
offsets in the shared output file; rank 0 then writes the footer and the
header (the reference's ordered writer thread as offset arithmetic).

The caller has called torch.distributed.init_process_group (gloo: the size
vector is a CPU tensor; nccl: it lies on the process's card), and the
output path lies on a filesystem that every process shares.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DsrcException, InputParameters
from ..io.archive import HEADER_SIZE, finalize_archive
from ..io.chunker import FastqChunker
from ..models.block import BlockCodec, BlockShape
from ..parallel.pipeline import ordered_parallel_map
from ..utils import trace
from ..utils.device import DEFAULT_DEVICE, resolve_device


_NONE = 1 << 62             # no block of this process seeds the hint
_MAX_FIELDS = 16            # title mode 2 takes at most 16 numeric fields


def own_hint_seeds(codec: BlockCodec, own: dict) -> np.ndarray:
    """Over this process's blocks ({index: block}) in file order: [index of
    the first that would seed the lane bucket, that bucket, index of the
    first that would seed the plane counts, its field count, its plane
    counts (zero-padded to 16)]; an index is _NONE where no block would."""
    seeds = np.zeros(4 + _MAX_FIELDS, np.int64)
    seeds[0] = seeds[2] = _NONE
    for i in sorted(own):
        rpad, pcs = codec.semi_hint_seeds(own[i])
        if rpad and seeds[0] == _NONE:
            seeds[:2] = i, rpad
        if pcs is not None:          # a mode-2 block is semi layout too
            seeds[2:4] = i, len(pcs)
            seeds[4:4 + len(pcs)] = pcs
            break
    return seeds


def file_hint_seeds(per_rank: np.ndarray) -> Tuple[int, Optional[tuple]]:
    """[world, 20] of own_hint_seeds -> (lane bucket, plane counts) of the
    lowest seeding block of the file, for BlockCodec.set_semi_hints."""
    r = per_rank[np.argmin(per_rank[:, 0])]
    p = per_rank[np.argmin(per_rank[:, 2])]
    rpad = int(r[1]) if r[0] != _NONE else 0
    pcs = tuple(int(c) for c in p[4:4 + p[3]]) if p[2] != _NONE else None
    return rpad, pcs


def compress_distributed(fastq_path: str, dsrc_path: str,
                         params: Optional[InputParameters] = None,
                         device=DEFAULT_DEVICE) -> None:
    """Compress `fastq_path` into `dsrc_path` across every process of the
    default torch.distributed group, each on `device` (for example
    cuda:{local_rank % device_count}).  Byte-identical to the
    single-process archive."""
    import torch.distributed as dist
    from ..api import analyze_first_block
    if not (dist.is_available() and dist.is_initialized()):
        raise DsrcException(
            "distributed compression needs a torch.distributed process "
            "group: call torch.distributed.init_process_group first")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    params = params or InputParameters()
    settings = params.to_settings()
    block_size = params.fastq_block_size_bytes or \
        (params.fastq_block_size_mb << 20)
    shape = BlockShape.for_block_size(block_size)

    mine = {}
    nrecs = []
    with open(fastq_path, "rb") as src:
        chunker = FastqChunker(src, block_size)
        first = chunker.next_with_count()
        if first is None:
            raise DsrcException("empty FASTQ input")
        dataset = analyze_first_block(first[0], shape, params.quality_offset,
                                      dev)
        codec = BlockCodec(shape, settings, dataset, dev)
        blocks = itertools.chain([first], iter(chunker.next_with_count, None))
        for i, (block, nrec) in enumerate(blocks):
            if len(block) > shape.cap:
                raise DsrcException(
                    "FASTQ record larger than the block size; "
                    "increase the block size (-b)")
            nrecs.append(nrec)
            if i % world == rank:
                mine[i] = block         # a view of a buffer of its own
    nblocks = len(nrecs)

    nccl = dist.get_backend() == "nccl"

    def all_gather(vec: np.ndarray) -> np.ndarray:
        """[world, n] int64: every process's vec (a CPU tensor under gloo,
        one on the process's card under NCCL)."""
        t = torch.from_numpy(vec).to(dev if nccl else "cpu")
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy()

    codec.set_semi_hints(*file_hint_seeds(
        all_gather(own_hint_seeds(codec, mine))))

    root = trace.current()

    def job(block):
        with trace.span("block", len(block), under=root):
            blob, _info = codec.compress(block)
            if settings.calculate_crc32 and \
                    not codec.verify_checksum(blob):
                raise DsrcException("CRC32 verification failed while "
                                    "compressing")
            return blob

    # the hints are seeded: no block waits for another, in any order
    own = sorted(mine)
    workers = params.num_workers or 2
    blobs = dict(zip(own, ordered_parallel_map(
        (mine.pop(i) for i in own), job, workers)))

    # the ordered merge: one all-gather of disjoint size vectors gives
    # every process every block's offset
    sizes = np.zeros(nblocks, np.int64)
    for i, blob in blobs.items():
        sizes[i] = len(blob)
    all_sizes = all_gather(sizes).sum(0)
    offsets = HEADER_SIZE + np.cumsum(all_sizes) - all_sizes
    end = HEADER_SIZE + int(all_sizes.sum())

    def barrier():
        dist.barrier(device_ids=[dev.index]) if nccl else dist.barrier()

    if rank == 0:
        with open(dsrc_path, "wb") as f:
            f.truncate(end)
    barrier()
    with open(dsrc_path, "r+b") as f:
        for i, blob in blobs.items():
            f.seek(int(offsets[i]))
            f.write(blob)
    barrier()
    if rank == 0:
        with open(dsrc_path, "r+b") as f:
            f.seek(end)
            finalize_archive(f, settings, dataset, block_size,
                             list(zip(all_sizes.tolist(), nrecs)))
    barrier()
