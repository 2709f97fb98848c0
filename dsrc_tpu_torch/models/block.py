"""Block codec of the port: the UNIFORM, SEMI and GENERIC classes of
dsrc_tpu/models/block.py, byte-identical blobs.

  UNIFORM / SEMI: host staging (numpy) -> device tensors -> uniform_pipeline
              (positional rANS through kernels K1/K2) -> host serialization;
              SEMI titles are numeric value planes on the device (title
              mode 2) or go through the tag coder (mode 0, free text)
  GENERIC:    device parse and stream gathers -> record transforms (folding
              or lossy binning; colour-space digits for SOLiD reads) -> tag /
              quality / DNA sections, each stream coded by the context-model
              codec (ops/ctx.py: K1 to encode, K3 to decode; DNA scheme A19
              decodes through K4)
  decompress: exact mirror; FASTQ text is laid out on the host
              (utils/native.layout_records)
"""
from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CompressionSettings, DatasetType, DsrcException
from ..ops import parser as P
from ..ops import transform as T
from ..ops.rans import PROB_BITS, payload_pairs
from ..ops.streams import (deserialize_rans, item, pack_ints,
                           serialize_rans, to_numpy, unpack_ints)
from ..parallel import uniform_pipeline as UP
from ..utils import native, trace
from ..utils.bitio import BitReader, BitWriter
from ..utils.crc32 import crc32
from ..utils.device import resolve_device
from ..utils.npbits import np_pack_fixed, np_unpack_fixed
from . import dna as DNA
from . import quality as Q
from . import tag as TAG

FLAG_CRC = 1
FLAG_COLOR_SPACE = 2
FLAG_PLUS_REP = 4

BLOCK_GENERIC = 0   # per-stream scheme-selected sections
BLOCK_UNIFORM = 1   # fixed-layout records
BLOCK_SEMI = 2      # fixed read length, variable titles (real Illumina)

HASH_CHAR = ord("#")   # truncation symbol (reference RecordsProcessor.h:76)


def _rpad_bucket(num_rec: int) -> int:
    """Record-count bucket: a multiple of 256 (encoder and decoder derive it
    from the same transmitted num_rec)."""
    return max(4, -(-num_rec // 256) * 256)


@dataclasses.dataclass(frozen=True)
class BlockShape:
    """Capacities shared by every block of one file."""
    cap: int           # max block text bytes (padded)
    rcap: int          # max records per block

    def __post_init__(self):
        # the GENERIC path keeps stream positions and sums of record
        # lengths in int32
        if not 0 < self.cap < 2**31:
            raise DsrcException(f"block capacity {self.cap} out of range")

    @staticmethod
    def for_block_size(block_bytes: int) -> "BlockShape":
        cap = -(-block_bytes // 16384) * 16384 + 16384
        rcap = max(1024, cap // 16)
        return BlockShape(cap=cap, rcap=rcap)


@dataclasses.dataclass
class StreamsInfo:
    """Per-stream raw/compressed byte accounting (reference Common.h:82-105),
    and the (DNA, quality) scheme names of each GENERIC block."""
    raw: dict = dataclasses.field(
        default_factory=lambda: dict(meta=0, tag=0, dna=0, quality=0))
    comp: dict = dataclasses.field(
        default_factory=lambda: dict(meta=0, tag=0, dna=0, quality=0))
    schemes: list = dataclasses.field(default_factory=list)

    def add(self, other: "StreamsInfo") -> None:
        for k in self.raw:
            self.raw[k] += other.raw[k]
            self.comp[k] += other.comp[k]
        self.schemes.extend(other.schemes)


# --------------------------------------------------------------------------
# Uniform-block staging / (de)serialization
# --------------------------------------------------------------------------

def host_stage_uniform(block: np.ndarray, cap: int):
    """The host half of stage_uniform_block: (mat [rpad, rec_bytes] uint8
    numpy, num_rec, spec, rpad), or None when the block's layout facts rule
    out a uniform block.  The mesh checks uniformity on the block's device
    (parallel/mesh.MeshUniformCodec)."""
    spec = UP.detect_spec(bytes(block[:4096]))
    if spec is None or len(block) % spec.rec_bytes:
        return None
    num_rec = len(block) // spec.rec_bytes
    rpad = _rpad_bucket(max(num_rec, cap // spec.rec_bytes))
    mat = np.zeros((rpad, spec.rec_bytes), np.uint8)
    mat[:num_rec] = np.asarray(block).reshape(num_rec, spec.rec_bytes)
    return mat, num_rec, spec, rpad


def stage_uniform_block(block: np.ndarray, cap: int, device: torch.device):
    """Text block -> (mat [rpad, rec_bytes] uint8 on device, num_rec, spec,
    rpad), or None when the block is not a fixed-layout uniform block.  cap
    pins one file-wide lane bucket (rpad is transmitted)."""
    staged = host_stage_uniform(block, cap)
    if staged is None:
        return None
    mat, num_rec, spec, rpad = staged
    matd = torch.from_numpy(mat).to(device)
    if not UP.check_uniform(matd, spec, num_rec):
        return None
    return matd, num_rec, spec, rpad


def _uniform_wp(p: int, group: int) -> int:
    """Canonical pair capacity of a positional stream with P positions."""
    return payload_pairs(group * p)


def _put_pos_stream(w: BitWriter, n_syms: int, tup) -> None:
    """One positional rANS stream + its transmitted PROB_BITS-wide table."""
    payload, nwords, states, tab = tup
    serialize_rans(w, n_syms, payload, nwords, states)
    w.put_bytes(np_pack_fixed(
        to_numpy(tab).ravel().astype(np.uint64), PROB_BITS))


def _put_dna(w: BitWriter, packed, exc_bits, num_rec: int,
             read_len: int) -> None:
    """2-bit packed DNA + gap-coded exception-position list."""
    ndna = (num_rec * read_len + 3) // 4
    w.put_varint(ndna)
    w.put_bytes(to_numpy(packed[:ndna]).tobytes())
    bits = to_numpy(exc_bits).astype(np.int32).view(np.uint32)
    rr, wc = bits.shape
    expand = (bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    expand = expand.reshape(rr, wc * 32)[:, :read_len]
    rpos, cpos = np.nonzero(expand)
    flat = (rpos * read_len + cpos).astype(np.int64)
    w.put_varint(len(flat))
    if len(flat):
        w.put_varint(int(flat[0]))
        pack_ints(w, np.diff(flat))


def _put_wire(w: BitWriter, wire) -> None:
    """Wire-format layout parameters of uniform/semi block headers."""
    w.put_byte(PROB_BITS)
    for v in wire:
        w.put_varint(v)


def _get_wire(r: BitReader, rpad: int):
    pb = r.get_byte()
    if pb != PROB_BITS:
        raise DsrcException(
            f"archive coded with PROB_BITS={pb}; this build decodes "
            f"PROB_BITS={PROB_BITS} only")
    wire = UP.Wire(*(r.get_varint() for _ in range(len(UP.Wire._fields))))
    try:
        wire.validate(rpad)
    except ValueError as e:
        raise DsrcException(f"bad block wire parameters: {e}")
    return wire


def serialize_uniform_block(comp, spec, num_rec: int, rpad: int,
                            wire=None):
    """compress_uniform output -> (blob, StreamsInfo)."""
    wire = wire or UP.WIRE_DEFAULT
    packed, exc_bits, _ = comp["dna"]
    w = BitWriter()
    w.put_byte(BLOCK_UNIFORM)
    w.put_varint(num_rec)
    w.put_varint(rpad)
    w.put_varint(spec.title_len)
    w.put_varint(spec.read_len)
    _put_wire(w, wire)
    w.put_byte(item(comp["qual_mode"]))  # 0 direct / 1 horizontal delta
    meta_end = w.byte_position
    _put_pos_stream(w, num_rec * spec.title_len, comp["title"])
    t_end = w.byte_position
    _put_pos_stream(w, num_rec * spec.read_len, comp["qual"])
    q_end = w.byte_position
    _put_dna(w, packed, exc_bits, num_rec, spec.read_len)
    blob = w.getvalue()
    info = StreamsInfo()
    info.raw.update(tag=num_rec * spec.title_len,
                    dna=num_rec * spec.read_len,
                    quality=num_rec * spec.read_len)
    info.comp.update(meta=meta_end, tag=t_end - meta_end,
                     quality=q_end - t_end, dna=len(blob) - q_end)
    return blob, info


def _get_pos_stream(r: BitReader, expect_n: int, p: int, tab_cols: int,
                    ll: int, group: int):
    """One positional stream as numpy (payload LEFT-aligned at its compact
    width; K2 reads words past a row's end as 0, so no canonical padding is
    needed), rows padded to ll lanes."""
    try:
        n, payload, states, nwords = deserialize_rans(r)
    except ValueError as e:
        raise DsrcException(str(e))
    if n != expect_n:
        raise DsrcException("uniform block stream length mismatch")
    if payload.shape[1] > _uniform_wp(p, group) or payload.shape[0] > ll:
        raise DsrcException("uniform block payload too wide")
    payload = np.pad(payload, ((0, ll - payload.shape[0]), (0, 0)))
    states = np.pad(states, (0, ll - len(states)))
    nwords = np.pad(nwords, (0, ll - len(nwords)))
    nvals = p * tab_cols
    raw = r.get_bytes((nvals * PROB_BITS + 7) // 8)
    tab = np_unpack_fixed(np.frombuffer(raw, np.uint8), nvals, PROB_BITS) \
        .astype(np.int32).reshape(p, tab_cols)
    return (payload, nwords.astype(np.int32), states, tab)


def _get_dna(r: BitReader, rpad: int, read_len: int):
    ndna = r.get_varint()
    packed_np = np.frombuffer(r.get_bytes(ndna), np.uint8)
    dcap = rpad * read_len // 4 + 1
    if ndna > dcap:
        raise DsrcException("dna section larger than its block")
    packed = np.pad(packed_np, (0, dcap - ndna))
    n_exc = r.get_varint()
    if n_exc:
        first = r.get_varint()
        gaps = unpack_ints(r).astype(np.int64)
        if len(gaps) != n_exc - 1 or (gaps < 0).any():
            raise DsrcException("dna exception gaps malformed")
        exc_np = first + np.concatenate([[0], np.cumsum(gaps)])
        if exc_np[-1] >= rpad * read_len:
            raise DsrcException("dna exception position out of range")
    else:
        exc_np = np.zeros(0, np.int64)
    wcnt = -(-read_len // 32)
    exc_bits = np.zeros((rpad, wcnt), np.uint32)
    if len(exc_np):
        rpos, cpos = exc_np // read_len, exc_np % read_len
        np.bitwise_or.at(exc_bits, (rpos, cpos // 32),
                         np.uint32(1) << (cpos % 32).astype(np.uint32))
    return (packed, exc_bits, np.int32(len(exc_np)))


def read_uniform_block(r: BitReader):
    """Blob reader (after the scheme byte) -> (comp dict of NUMPY arrays,
    spec, num_rec, rpad, wire); convert.comp_from_numpy moves it to a
    device."""
    num_rec = r.get_varint()
    rpad = r.get_varint()
    title_len = r.get_varint()
    read_len = r.get_varint()
    spec = UP.UniformSpec(
        rec_bytes=1 + title_len + 1 + read_len + 3 + read_len + 1,
        title_len=title_len, read_len=read_len)
    if (rpad < max(1, num_rec) or rpad % 256
            or rpad * max(1, spec.rec_bytes) > (1 << 31)):
        raise DsrcException("uniform block: bad transmitted lane bucket")
    wire = _get_wire(r, rpad)
    qual_mode = r.get_byte()
    title = _get_pos_stream(
        r, num_rec * title_len, title_len, wire.title_a,
        rpad // wire.title_code_group, wire.title_code_group)
    qual = _get_pos_stream(r, num_rec * read_len, read_len, wire.qual_a,
                           rpad // wire.qual_group, wire.qual_group)
    comp = dict(num_rec=np.int32(num_rec), qual_mode=np.int32(qual_mode),
                title=title, qual=qual, dna=_get_dna(r, rpad, read_len))
    return comp, spec, num_rec, rpad, wire


# --------------------------------------------------------------------------
# Semi-block staging / (de)serialization
# --------------------------------------------------------------------------

def stage_semi_raw(block: np.ndarray, rpad_hint: int = 0):
    """Host staging for the semi path: probe read_len, one scan into
    matrices.  Returns (read_len, num_rec, qm, sm, tstream, tl) or None when
    the block is not semi-layout."""
    b = np.asarray(block, np.uint8)
    head = bytes(b[:16896])
    try:
        e0 = head.index(b"\n")
        e1 = head.index(b"\n", e0 + 1)
    except ValueError:
        return None
    read_len = e1 - e0 - 1
    if not (0 < read_len <= 8192):
        return None
    nmax = len(b) // (2 * read_len + 6) + 1
    rpad_alloc = max(_rpad_bucket(nmax) + 256, rpad_hint)
    staged = native.stage_semi(b, read_len, rpad_alloc)
    if staged is None:
        return None
    qm_a, sm_a, tstream, tl, num_rec = staged
    return read_len, num_rec, qm_a, sm_a, tstream, tl


def semi_tok_planes(vmat: np.ndarray, num_rec: int,
                    pcs_hint: Optional[dict] = None):
    """(v0 [F] int32, pcs tuple): transmitted base values + per-field
    byte-plane counts from the actual zigzag deltas.  pcs_hint (grow-only,
    mutated) keeps every block of a file on one plane layout."""
    nf = vmat.shape[1]
    v0 = (vmat[0] if num_rec else np.zeros(nf, np.int32)) \
        .astype(np.int32)
    d = np.diff(vmat.astype(np.int64), axis=0,
                prepend=v0[None, :].astype(np.int64))
    z = np.where(d < 0, -2 * d - 1, 2 * d)
    hint = pcs_hint if pcs_hint is not None else {}
    pcs = tuple(
        max(max(1, (int(z[:, f].max()).bit_length() + 7) // 8),
            hint.get(f, 1)) for f in range(nf))
    for f, pc in enumerate(pcs):
        hint[f] = pc
    return v0, pcs


def _put_semi_header(w: BitWriter, comp, num_rec: int, rpad: int,
                     read_len: int, wire, title_mode: int) -> None:
    w.put_byte(BLOCK_SEMI)
    w.put_varint(num_rec)
    w.put_varint(rpad)
    w.put_varint(read_len)
    _put_wire(w, wire)
    w.put_byte(item(comp["qual_mode"]))
    w.put_byte(title_mode)


def _finish_semi(w: BitWriter, comp, num_rec: int, read_len: int,
                 meta_end: int, raw_tag_len: int):
    """Quality and DNA sections after the title section -> (blob,
    StreamsInfo)."""
    t_end = w.byte_position
    _put_pos_stream(w, num_rec * read_len, comp["qual"])
    q_end = w.byte_position
    packed, exc_bits, _ = comp["dna"]
    _put_dna(w, packed, exc_bits, num_rec, read_len)
    blob = w.getvalue()
    info = StreamsInfo()
    info.raw.update(tag=raw_tag_len, dna=num_rec * read_len,
                    quality=num_rec * read_len)
    info.comp.update(meta=meta_end, tag=t_end - meta_end,
                     quality=q_end - t_end, dna=len(blob) - q_end)
    return blob, info


def serialize_semi_tok_block(comp, num_rec: int, rpad: int, read_len: int,
                             pcs, v0, tok_meta, raw_tag_len: int,
                             wire=None):
    """compress_semi_tok output -> (blob, StreamsInfo) of a title mode 2
    block."""
    k, seps, fields = tok_meta
    w = BitWriter()
    _put_semi_header(w, comp, num_rec, rpad, read_len,
                     wire or UP.WIRE_DEFAULT, 2)
    w.put_varint(k)
    w.put_bytes(seps)
    fi = 0
    for sch, arg in fields:
        w.put_byte(sch)
        if sch == TAG.TOKF_CONST:
            w.put_varint(len(arg))
            w.put_bytes(arg)
        else:
            if sch == TAG.TOKF_NUM_PAD:
                w.put_byte(arg)
            w.put_byte(pcs[fi])
            w.put_varint(int(v0[fi]))
            fi += 1
    meta_end = w.byte_position
    if sum(pcs):
        _put_pos_stream(w, num_rec * sum(pcs), comp["title"])
    return _finish_semi(w, comp, num_rec, read_len, meta_end, raw_tag_len)


def serialize_semi0_block(comp, num_rec: int, rpad: int, read_len: int,
                          tstream: np.ndarray, tl: np.ndarray,
                          preserve_mask: int, cap: int, device):
    """compress_semi output and the block's titles -> (blob, StreamsInfo) of
    a title mode 0 block: the titles go through the tag coder, its byte
    streams coded on `device`."""
    with trace.span("codec.serialize"):
        w = BitWriter()
        _put_semi_header(w, comp, num_rec, rpad, read_len, UP.WIRE_DEFAULT,
                         0)
        meta_end = w.byte_position
    with trace.span("codec.tag"):
        TAG.encode_tags(w, tstream, tl, preserve_mask, cap, device)
    with trace.span("codec.serialize"):
        return _finish_semi(w, comp, num_rec, read_len, meta_end,
                            len(tstream))


def parse_semi_block(r: BitReader, tag_cap: int, device) -> dict:
    """Blob reader (after the scheme byte) -> dict describing a semi block:
    num_rec/rpad/read_len/wire/mode/qual_mode and the qual and dna numpy
    stream tuples; mode 2 adds tok_meta/pcs/v0 and the title stream (when
    sum(pcs) > 0); mode 0 decodes its tag section here, on `device`
    (titles_np, title_len_np)."""
    with trace.span("codec.stage"):
        num_rec = r.get_varint()
        rpad = r.get_varint()
        read_len = r.get_varint()
        if rpad < max(1, num_rec) or rpad % 256 or rpad > (1 << 26):
            raise DsrcException("semi block: bad transmitted lane bucket")
        wire = _get_wire(r, rpad)
        qual_mode = r.get_byte()
        title_mode = r.get_byte()
        if title_mode not in (0, 2):
            raise DsrcException(
                f"semi block: unknown title mode {title_mode}")
        out = dict(num_rec=num_rec, rpad=rpad, read_len=read_len,
                   wire=wire, mode=title_mode, qual_mode=qual_mode)
    if title_mode == 0:
        with trace.span("codec.tag"):
            titles_np, title_len_np = TAG.decode_tags(r, num_rec, tag_cap,
                                                      device)
        out.update(titles_np=titles_np, title_len_np=title_len_np)
    with trace.span("codec.stage"):
        if title_mode == 2:
            _parse_value_titles(r, out)
        out["qual"] = _get_pos_stream(
            r, num_rec * read_len, read_len, wire.qual_a,
            rpad // wire.qual_group, wire.qual_group)
        out["dna"] = _get_dna(r, rpad, read_len)
    return out


def _parse_value_titles(r: BitReader, out: dict) -> None:
    """The title section of a mode-2 semi block into `out`: tok_meta, pcs,
    v0 and the value-plane stream (when sum(pcs) > 0)."""
    num_rec, rpad, wire = out["num_rec"], out["rpad"], out["wire"]
    k = r.get_varint()
    if not 0 < k <= TAG.MAX_FIELDS:
        raise DsrcException("semi block: bad title field count")
    seps = r.get_bytes(k - 1)
    fields = []
    pcs: tuple = ()
    v0 = []
    for _ in range(k):
        sch = r.get_byte()
        if sch == TAG.TOKF_CONST:
            fields.append((sch, r.get_bytes(r.get_varint())))
            continue
        if sch == TAG.TOKF_NUM_PAD:
            fields.append((sch, r.get_byte()))
        elif sch == TAG.TOKF_NUM:
            fields.append((sch, None))
        else:
            raise DsrcException("semi block: bad title field scheme")
        pc = r.get_byte()
        if not 1 <= pc <= 4:
            raise DsrcException("semi block: bad plane count")
        pcs = pcs + (pc,)
        v0.append(r.get_varint())
    out.update(tok_meta=(k, seps, fields), pcs=pcs,
               v0=np.asarray(v0, np.int32))
    if sum(pcs):
        out["title"] = _get_pos_stream(
            r, num_rec * sum(pcs), sum(pcs), UP.VAL_A,
            rpad // wire.val_group, wire.val_group)


def semi_tok_comp_device(d: dict, device) -> dict:
    """parse_semi_block dict -> the comp dict of tensors on `device` that
    UP.decompress_semi / decompress_semi_tok take.  Payloads keep their
    compact width: K2 reads words past a row's end as 0."""
    from ..convert import comp_from_numpy
    return comp_from_numpy(
        {k: d[k] for k in ("num_rec", "qual_mode", "title", "qual", "dna")
         if k in d}, device)


def decode_parsed_semi(d: dict, device, color_space: bool = False,
                       plus_repetition: bool = False) -> np.ndarray:
    """FASTQ text of a semi block that parse_semi_block has parsed (a mode-0
    dict carries its decoded titles), decoded on `device`."""
    dev = resolve_device(device)
    num_rec, read_len, rpad = d["num_rec"], d["read_len"], d["rpad"]
    with trace.span("codec.stage"):
        comp = semi_tok_comp_device(d, dev)
        if d["mode"] == 2:
            v0 = torch.from_numpy(d["v0"]).to(dev)
    with trace.span("codec.model"):
        if d["mode"] == 0:
            qual_m, seq_m = UP.decompress_semi(comp, read_len, rpad,
                                               left=True, wire=d["wire"])
        else:
            vmat, qual_m, seq_m = UP.decompress_semi_tok(
                comp, v0, d["pcs"], read_len, rpad, left=True,
                wire=d["wire"])
    if d["mode"] == 0:
        titles_np, title_len_np = d["titles_np"], d["title_len_np"]
    else:
        with trace.span("codec.tag"):
            titles_np, title_len_np = TAG.render_value_titles(
                to_numpy(vmat[:num_rec]), d["tok_meta"], num_rec)
    with trace.span("codec.serialize"):
        return native.layout_records(
            num_rec, titles_np, title_len_np,
            to_numpy(seq_m[:num_rec]).reshape(-1),
            to_numpy(qual_m[:num_rec]).reshape(-1),
            np.full(num_rec, read_len, np.int64), None, color_space,
            plus_repetition)


# --------------------------------------------------------------------------
# Block codec
# --------------------------------------------------------------------------

class GenericStreams(NamedTuple):
    """A GENERIC block parsed and transformed, before its sections are
    coded.  The raw byte streams are gone by then: the titles are on the
    host, and the sequence and quality bytes live on only as the CRC32s
    (when asked for), the dense DNA symbols left after folding (uint8
    [cap]; colour space: the digits after each primer) and the quality
    values (int16 [cap])."""
    num_rec: int
    qual_len: np.ndarray            # int64 [num_rec]
    qual_len_d: torch.Tensor        # int32 [rcap] on the device
    title_len: np.ndarray           # [num_rec]
    titles: np.ndarray              # uint8 [>= t_total], host
    t_total: int
    s_total: int
    q_total: int
    offset: int
    dna: torch.Tensor
    dna_total: int
    qvals: torch.Tensor
    primers: Optional[np.ndarray]   # colour space: each read's primer base
    crcs: Optional[tuple]           # CRC32 of the title, sequence, quality
                                    # streams when the settings ask


class SeedOrder:
    """Block order for the semi hints.  A block about to seed a hint first
    waits until every earlier block has decided whether it seeds one, so
    the hints are seeded by the same block as in a one-worker run, whatever
    the worker scheduling.  Blocks are numbered from 0 in file order; the
    block without a number (None) never waits."""

    def __init__(self):
        self._cv = threading.Condition()
        self._done: set = set()
        self._low = 0              # every block below this one has decided
        self._cancelled = False

    def wait_for_earlier(self, index: Optional[int]) -> None:
        if index is None:
            return
        with self._cv:
            self._cv.wait_for(lambda: self._low >= index or self._cancelled)
            if self._cancelled:
                raise DsrcException("compression cancelled")

    def decided(self, index: Optional[int]) -> None:
        if index is None:
            return
        with self._cv:
            if index >= self._low:
                self._done.add(index)
            while self._low in self._done:
                self._done.discard(self._low)
                self._low += 1
            self._cv.notify_all()

    def cancel(self) -> None:
        """Release every waiting block (another block or the reader
        failed)."""
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()


class BlockCodec:
    """Per-block compress/decompress bound to one BlockShape and device.

    Thread-safe.  The semi hints (lane bucket, plane counts) are seeded by
    the first semi (resp. first title mode 2) block in file order and then
    frozen; with block numbers passed to compress (api.py does), a block
    that would seed one waits for the earlier blocks (SeedOrder), so the
    compressed bytes never depend on worker scheduling."""

    def __init__(self, shape: BlockShape, settings: CompressionSettings,
                 dataset: DatasetType, device="cuda"):
        if dataset.quality_offset == 0:
            raise DsrcException("dataset quality offset must be resolved")
        self.shape = shape
        self.settings = settings
        self.dataset = dataset
        self.device = resolve_device(device)
        self._rpad_hint = 0
        self._pcs_hint: dict = {}   # semi mode-2 per-field plane counts
        self._hints_frozen = False
        self.seed_order = SeedOrder()

    # -------------------------------------------------- compress
    def compress(self, block: np.ndarray, index: Optional[int] = None
                 ) -> Tuple[bytes, StreamsInfo]:
        """Compress one block.  index: the block's number in the file, for
        SeedOrder; None when blocks are compressed one at a time, in
        order."""
        with trace.span("codec.compress"):
            try:
                if len(block) > self.shape.cap:
                    raise DsrcException("block larger than codec capacity")
                if self._uniform_eligible():
                    out = self._compress_uniform(block)
                    if out is None:
                        out = self._compress_semi(block, index)
                    if out is not None:
                        return out
                return self._compress_generic(block)
            finally:
                self.seed_order.decided(index)

    def _uniform_eligible(self) -> bool:
        st, ds = self.settings, self.dataset
        return (st.dna_order == 0 and st.quality_order == 0
                and not st.lossy_quality and not st.calculate_crc32
                and not st.tag_fields_filtered
                and not ds.color_space and not ds.plus_repetition)

    def _compress_uniform(self, block: np.ndarray):
        with trace.span("codec.stage"):
            staged = stage_uniform_block(block, self.shape.cap, self.device)
        if staged is None:
            return None
        matd, num_rec, spec, rpad = staged
        with trace.span("codec.model"):
            comp = UP.compress_uniform(matd, num_rec, spec, rpad)
        with trace.span("codec.serialize"):
            return serialize_uniform_block(comp, spec, num_rec, rpad)

    def _semi_rpad(self, num_rec: int) -> int:
        """File-wide semi lane bucket: seeded (with one bucket of headroom)
        by the first semi block, then frozen.  A later block that outgrows
        it uses its own larger bucket (a pure function of that block)."""
        rpad = max(_rpad_bucket(num_rec), self._rpad_hint)
        if self._rpad_hint == 0:
            rpad += 256
            self._rpad_hint = rpad
        return rpad

    def _semi_pcs_hint(self) -> dict:
        """Plane-count hints: mutable for the first semi block, a private
        copy afterwards (same determinism rule as _semi_rpad)."""
        if self._hints_frozen:
            return dict(self._pcs_hint)
        self._hints_frozen = True
        return self._pcs_hint

    def semi_hints_seeded(self) -> bool:
        """True once no later block can seed a semi hint: from then on a
        block's staging does not depend on the blocks before it."""
        return bool(self._rpad_hint and self._hints_frozen)

    def stage_semi_tok_for_mesh(self, block: np.ndarray):
        """Host staging of one title mode 2 block for the mesh codec
        (parallel/mesh.MeshSemiCodec): (staged dict of numpy arrays,
        read_len, rpad, pcs), or None when the block is not a mode-2 semi
        block.  It takes and seeds the same hints as compress, so a block
        that falls back to compress gets the same bytes.  The caller stages
        blocks in file order until semi_hints_seeded()."""
        staged = stage_semi_raw(block, self._rpad_hint)
        if staged is None:
            return None
        read_len, num_rec, qm_a, sm_a, tstream, tl = staged
        tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                       np.asarray(tl))
        if tok is None or tok[0].shape[1] > 16:
            return None
        rpad = self._semi_rpad(num_rec)
        vmat, tok_meta = tok
        v0, pcs = semi_tok_planes(vmat, num_rec, self._semi_pcs_hint())
        vpad = np.zeros((rpad, vmat.shape[1]), np.int32)
        vpad[:num_rec] = vmat
        return (dict(vmat=vpad, v0=v0,
                     qm=np.ascontiguousarray(qm_a[:rpad]),
                     sm=np.ascontiguousarray(sm_a[:rpad]), num_rec=num_rec,
                     tok_meta=tok_meta, tag_len=len(tstream)),
                read_len, rpad, pcs)

    def semi_hint_seeds(self, block: np.ndarray
                        ) -> Tuple[int, Optional[tuple]]:
        """What `block` would seed, as compress would, were it the first
        semi block of its file: (the lane bucket, 0 when the block is not
        semi layout; the plane counts, None when its titles are not title
        mode 2).  Seeds nothing."""
        if not self._uniform_eligible() or stage_uniform_block(
                block, self.shape.cap, self.device) is not None:
            return 0, None
        staged = stage_semi_raw(block)
        if staged is None:
            return 0, None
        _read_len, num_rec, _qm, _sm, tstream, tl = staged
        rpad = _rpad_bucket(num_rec) + 256          # as _semi_rpad seeds it
        tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                       np.asarray(tl))
        if tok is None or tok[0].shape[1] > 16:
            return rpad, None
        return rpad, semi_tok_planes(tok[0], num_rec)[1]

    def set_semi_hints(self, rpad: int, pcs: Optional[tuple]) -> None:
        """Seed the hints with what semi_hint_seeds gave for the blocks
        that seed them in a one-worker run (the first semi-layout block,
        the first title mode 2 block), before any block is compressed, so
        that blocks compressed afterwards in any order and on any process
        get that run's bytes."""
        if rpad:
            self._rpad_hint = rpad
        if pcs is not None:
            self._pcs_hint = dict(enumerate(pcs))
            self._hints_frozen = True

    def _compress_semi(self, block: np.ndarray, index: Optional[int]):
        """Fixed read length, variable titles.  None = not semi-layout.
        Titles whose fields are all constant or numeric (at most 16
        numeric) take title mode 2, the others mode 0 (the tag coder)."""
        order = self.seed_order
        if self._rpad_hint == 0:
            order.wait_for_earlier(index)
        with trace.span("codec.stage"):
            staged = stage_semi_raw(block, self._rpad_hint)
        if staged is None:
            order.decided(index)
            return None
        read_len, num_rec, qm_a, sm_a, tstream, tl = staged
        rpad = self._semi_rpad(num_rec)
        with trace.span("codec.tag"):
            tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                           np.asarray(tl))
        dev = self.device
        with trace.span("codec.stage"):
            qm = torch.from_numpy(np.ascontiguousarray(qm_a[:rpad])).to(dev)
            sm = torch.from_numpy(np.ascontiguousarray(sm_a[:rpad])).to(dev)
        if tok is None or tok[0].shape[1] > 16:
            order.decided(index)
            with trace.span("codec.model"):
                comp = UP.compress_semi(qm, sm, num_rec, read_len)
            return serialize_semi0_block(
                comp, num_rec, rpad, read_len, tstream, tl,
                self.settings.tag_preserve_mask, self.shape.cap, dev)
        vmat, tok_meta = tok
        if not self._hints_frozen:
            order.wait_for_earlier(index)
        with trace.span("codec.tag"):
            v0, pcs = semi_tok_planes(vmat, num_rec, self._semi_pcs_hint())
        order.decided(index)
        with trace.span("codec.stage"):
            vpad = np.zeros((rpad, vmat.shape[1]), np.int32)
            vpad[:num_rec] = vmat
            vpad_d = torch.from_numpy(vpad).to(dev)
            v0_d = torch.from_numpy(v0).to(dev)
        with trace.span("codec.model"):
            comp = UP.compress_semi_tok(vpad_d, v0_d, qm, sm, num_rec, pcs,
                                        read_len, rpad)
        with trace.span("codec.serialize"):
            return serialize_semi_tok_block(comp, num_rec, rpad, read_len,
                                            pcs, v0, tok_meta, len(tstream))

    # -------------------------------------------------- decompress
    def decompress(self, blob: bytes) -> np.ndarray:
        with trace.span("codec.decompress"):
            r = BitReader(blob)
            scheme = r.get_byte()
            if scheme == BLOCK_UNIFORM:
                return self._decompress_uniform(r)
            if scheme == BLOCK_SEMI:
                return self._decompress_semi(r)
            if scheme == BLOCK_GENERIC:
                return self._decompress_generic(r)
            raise DsrcException(f"bad block scheme {scheme}")

    def _decompress_uniform(self, r: BitReader) -> np.ndarray:
        from ..convert import comp_from_numpy
        with trace.span("codec.stage"):
            comp_np, spec, num_rec, rpad, wire = read_uniform_block(r)
            comp = comp_from_numpy(comp_np, self.device)
        with trace.span("codec.model"):
            mat = UP.decompress_uniform(comp, spec, rpad, left=True,
                                        wire=wire)
        return to_numpy(mat[:num_rec]).reshape(-1)

    def _decompress_semi(self, r: BitReader) -> np.ndarray:
        return self.decompress_parsed_semi(
            parse_semi_block(r, self.shape.cap, self.device))

    def decompress_parsed_semi(self, d: dict) -> np.ndarray:
        """A semi block already parsed by parse_semi_block, decoded on the
        codec's device (a mode-0 block's titles are not decoded again)."""
        return decode_parsed_semi(d, self.device, self.dataset.color_space,
                                  self.dataset.plus_repetition)

    # -------------------------------------------------- GENERIC class
    def stage_generic(self, block: np.ndarray) -> GenericStreams:
        """Parse a block on the device and transform its streams (the part
        of the GENERIC compress before the sections are coded).  Each
        device stream is dropped once its last reader has run."""
        sh, st, ds = self.shape, self.settings, self.dataset
        dev = self.device
        with trace.span("codec.stage"):
            nbytes = len(block)
            block = np.asarray(block, np.uint8)
            data = torch.from_numpy(block if block.flags.writeable
                                    else block.copy()).to(dev)
            parsed = P.parse_block(data, nbytes, sh.rcap)
            if not item(parsed.valid):
                raise DsrcException(
                    "Error parsing FASTQ block (bad structure)")
            num_rec = item(parsed.num_records)
            seq_len_np = to_numpy(parsed.seq_len)[:num_rec]
            qual_len_np = to_numpy(parsed.qual_len)[:num_rec] \
                .astype(np.int64)
            seq_start, seq_len = parsed.seq_start, parsed.seq_len
            primers = None
            if ds.color_space:
                # a primer base, then one colour digit per quality value
                if not (seq_len_np == qual_len_np + 1).all():
                    raise DsrcException("color-space length mismatch")
                primers = to_numpy(T.take_clip(data, seq_start))[:num_rec]
                seq_start = seq_start + 1
                seq_len = (seq_len - 1).clamp_(min=0)
            elif not (seq_len_np == qual_len_np).all():
                raise DsrcException("sequence/quality length mismatch")
            titles, t_total, _ = P.gather_stream(data, parsed.title_start,
                                                 parsed.title_len, sh.cap)
            titles = to_numpy(titles[:max(t_total, 1)], copy=True)
            seqs, s_total, _ = P.gather_stream(data, seq_start, seq_len,
                                               sh.cap)
            quals, q_total, _ = P.gather_stream(data, parsed.qual_start,
                                                parsed.qual_len, sh.cap)
            del data, seq_start, seq_len
            crcs = None
            if st.calculate_crc32:
                # colour space: the sequence stream holds no primer
                crcs = (crc32(titles[:t_total]),
                        crc32(to_numpy(seqs[:s_total])),
                        crc32(to_numpy(quals[:q_total])))

            # Per-block quality offset: a block with a quality byte below
            # the dataset offset (from the first block) falls back to offset
            # 33 and transmits it, so every block stays exactly reversible
            # (dsrc_tpu/models/block.py:813-833).
            offset = ds.quality_offset
            if q_total:
                qmin = item(quals[:q_total].min())
                qmax = item(quals[:q_total].max())
                if qmin < offset:
                    offset = 33
                if qmin < offset or qmax - offset >= T.FOLD_BASE:
                    raise DsrcException(
                        f"quality bytes span [{qmin}, {qmax}] — outside "
                        f"the reversible range for any FASTQ offset")
            title_len_np = to_numpy(parsed.title_len)[:num_rec]
        forward = _forward_transform_cs if ds.color_space \
            else _forward_transform
        with trace.span("codec.model"):
            dna, dna_total, qvals = forward(seqs, quals, s_total, offset,
                                            sh.cap, st.lossy_quality)
        return GenericStreams(
            num_rec, qual_len_np, parsed.qual_len, title_len_np, titles,
            t_total, s_total, q_total, offset, dna, dna_total, qvals,
            primers, crcs)

    def _compress_generic(self, block: np.ndarray
                          ) -> Tuple[bytes, StreamsInfo]:
        sh, st, ds = self.shape, self.settings, self.dataset
        g = self.stage_generic(block)
        num_rec, offset = g.num_rec, g.offset
        dev = self.device
        with trace.span("codec.serialize"):
            w = BitWriter()
            w.put_byte(BLOCK_GENERIC)
            flags = (FLAG_CRC if st.calculate_crc32 else 0) | \
                (FLAG_COLOR_SPACE if ds.color_space else 0) | \
                (FLAG_PLUS_REP if ds.plus_repetition else 0)
            w.put_varint(num_rec)
            w.put_byte(flags)
            w.put_byte(offset)
            pack_ints(w, g.qual_len)
            if ds.color_space:
                pack_ints(w, g.primers.astype(np.int64))
            if g.crcs is not None:
                for c in g.crcs:
                    w.put_uint32(c)
            meta_end = w.byte_position
        with trace.span("codec.tag"):
            TAG.encode_tags(w, g.titles, g.title_len, st.tag_preserve_mask,
                            sh.cap, dev)
        tag_end = w.byte_position
        hash_val = (HASH_CHAR - offset) if (
            not st.lossy_quality and 0 <= HASH_CHAR - offset < 256) else -1
        with trace.span("codec.model"):
            q_scheme = Q.encode_quality(w, g.qvals, g.q_total, g.qual_len_d,
                                        num_rec, st.quality_order, hash_val)
            qual_end = w.byte_position
            hist = to_numpy(DNA.dna_stats(g.dna, g.dna_total, sh.cap))
            d_scheme = DNA.encode_dna(w, g.dna, g.dna_total, st.dna_order,
                                      hist)
        blob = w.getvalue()
        info = StreamsInfo()
        info.raw.update(tag=g.t_total, dna=g.s_total, quality=g.q_total)
        info.comp.update(meta=meta_end, tag=tag_end - meta_end,
                         quality=qual_end - tag_end, dna=len(blob) - qual_end)
        info.schemes.append((d_scheme, q_scheme))
        return blob, info

    def _decompress_generic(self, r: BitReader) -> np.ndarray:
        sh, st, ds = self.shape, self.settings, self.dataset
        dev = self.device
        with trace.span("codec.stage"):
            num_rec = r.get_varint()
            flags = r.get_byte()
            offset = r.get_byte()
            qual_len_np = unpack_ints(r).astype(np.int64)
            if num_rec > sh.rcap or len(qual_len_np) != num_rec:
                raise DsrcException("generic block: bad record count")
            primers = None
            if flags & FLAG_COLOR_SPACE:
                primers = unpack_ints(r).astype(np.uint8)
                if len(primers) != num_rec:
                    raise DsrcException("generic block: bad primer count")
            elif ds.color_space:
                raise DsrcException(
                    "colour-space archive block without primers")
            crcs = None
            if flags & FLAG_CRC:
                crcs = (r.get_uint32(), r.get_uint32(), r.get_uint32())
            qlen_pad = torch.from_numpy(np.pad(
                qual_len_np, (0, sh.rcap - num_rec)).astype(np.int32)).to(dev)
        with trace.span("codec.tag"):
            titles_np, title_len_np = TAG.decode_tags(r, num_rec, sh.cap,
                                                      dev)
        hash_val = (HASH_CHAR - offset) if (
            not st.lossy_quality and 0 <= HASH_CHAR - offset < 256) else -1
        backward = _backward_transform_cs if ds.color_space \
            else _backward_transform
        with trace.span("codec.model"):
            qvals, q_total = Q.decode_quality(r, sh.cap, qlen_pad, num_rec,
                                              st.quality_order, hash_val)
            dna, _ = DNA.decode_dna(r, sh.cap, st.dna_order, dev)
            seq, qual = backward(dna, qvals, q_total, offset,
                                 st.lossy_quality)
            del dna, qvals
        with trace.span("codec.serialize"):
            text = native.layout_records(
                num_rec, titles_np, title_len_np, to_numpy(seq),
                to_numpy(qual), qual_len_np, primers, ds.color_space,
                ds.plus_repetition)
        if crcs is not None:
            got = _stream_crcs_from_text(text, ds)
            if got != crcs:
                raise DsrcException(
                    "CRC32 mismatch on block self-verification "
                    f"(stored {crcs}, decoded {got})")
        return text

    # -------------------------------------------------- verification
    def verify_checksum(self, blob: bytes) -> bool:
        """Decode-after-encode self check (reference BlockCompressor::
        VerifyChecksum, BlockCompressor.cpp:576-594): decompress() compares
        the decoded streams' CRC32s with the stored ones and raises on a
        mismatch."""
        try:
            self.decompress(blob)
            return True
        except DsrcException:
            return False


def _quality_values(quals: torch.Tensor, n: int,
                    offset: int) -> torch.Tensor:
    """The n live quality bytes -> int16 values clipped into [0, 255]."""
    return quals[:n].to(torch.int16).sub_(offset).clamp_(0, 255)


def _forward_transform(seqs: torch.Tensor, quals: torch.Tensor,
                       s_total: int, offset: int, cap: int, lossy: bool):
    """Byte streams -> (dna dense syms uint8 [cap], dna_total, quality
    values int16 [cap]; lossy: their bins), both zero past their totals.
    The transforms run on the s_total live positions."""
    seq_sym = T.dna_remap(seqs[:s_total])
    qv = _quality_values(quals, s_total, offset)
    if lossy:
        dna, dna_total, qv = T.forward_lossy(seq_sym, qv, cap)
    else:
        dna, dna_total, qv = T.forward_lossless(seq_sym, qv, cap)
    return dna, dna_total, T.pad_to(qv, cap)


def _backward_transform(dna: torch.Tensor, qual_vals: torch.Tensor, n: int,
                        offset: int, lossy: bool):
    """Inverse: (dna syms, coded qual values, whose first n are consumed)
    -> (seq bytes [n], qual bytes [n])."""
    qv = qual_vals[:n].to(torch.int16)
    if lossy:
        seq_sym, qv = T.backward_lossy(dna, qv)
    else:
        seq_sym, qv = T.backward_lossless(dna, qv)
    seq = T.dna_unmap(seq_sym)
    del seq_sym
    return seq, qv.add_(offset).to(torch.uint8)


def _forward_transform_cs(seqs: torch.Tensor, quals: torch.Tensor,
                          s_total: int, offset: int, cap: int, lossy: bool):
    """Colour space: seqs are the digit streams (primers stripped) ->
    (colour indices uint8 [cap] (INVALID_SYM past s_total, as the zero
    bytes there map), dna_total, qual values or lossy bins int16 [cap]).
    Nothing folds; under lossy coding a colour above 3 forces bin 0."""
    col = T.color_remap(seqs)
    qv = _quality_values(quals, s_total, offset)
    if lossy:
        qv = T.quality_bin(qv).masked_fill_(col[:s_total] > 3, 0)
    return col, s_total, T.pad_to(qv, cap)


def _backward_transform_cs(col: torch.Tensor, qual_vals: torch.Tensor,
                           n: int, offset: int, lossy: bool):
    """Inverse of _forward_transform_cs; under lossy coding bin 0 decodes as
    '.'."""
    col = col[:n]
    qv = qual_vals[:n]
    if lossy:
        col = col.masked_fill(qv == 0, 4)
        qv = T.quality_unbin(qv)
    else:
        qv = qv.to(torch.int16)
    return T.color_unmap(col), qv.add_(offset).to(torch.uint8)


def _stream_crcs_from_text(text: np.ndarray, ds):
    """CRC32 of the tag / sequence / quality streams of decoded FASTQ text
    (the streams compress hashed; a colour-space dataset `ds` hashes no
    primer base)."""
    nl_mask = text == 10
    line_id = np.cumsum(nl_mask) - nl_mask
    lmod = line_id % 4
    is_start = np.concatenate([[True], nl_mask[:-1]])
    t_mask = (lmod == 0) & ~nl_mask & ~is_start          # skip '@'
    s_mask = (lmod == 1) & ~nl_mask
    if ds.color_space:
        s_mask &= ~is_start                              # skip primer base
    q_mask = (lmod == 3) & ~nl_mask
    return (crc32(text[t_mask]), crc32(text[s_mask]), crc32(text[q_mask]))
