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

import numpy as np
import torch

from ..config import CompressionSettings, DatasetType, DsrcException
from ..ops import transform as T
from ..ops.rans import PROB_BITS, payload_pairs
from ..ops.streams import deserialize_rans, to_numpy, unpack_ints
from ..parallel import uniform_pipeline as UP
from ..utils import native
from ..utils.bitio import BitReader
from ..utils.crc32 import crc32
from ..utils.device import resolve_device
from ..utils.npbits import np_unpack_fixed
from . import dna as DNA
from . import quality as Q
from . import tag as TAG

FLAG_CRC = 1
FLAG_COLOR_SPACE = 2

BLOCK_GENERIC = 0   # per-stream scheme-selected sections
BLOCK_UNIFORM = 1   # fixed-layout records
BLOCK_SEMI = 2      # fixed read length, variable titles (real Illumina)

HASH_CHAR = ord("#")   # truncation symbol (reference RecordsProcessor.h:76)


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


# --------------------------------------------------------------------------
# Uniform-block staging / (de)serialization
# --------------------------------------------------------------------------


def _uniform_wp(p: int, group: int) -> int:
    """Canonical pair capacity of a positional stream with P positions."""
    return payload_pairs(group * p)


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


def parse_semi_block(r: BitReader, tag_cap: int, device) -> dict:
    """Blob reader (after the scheme byte) -> dict describing a semi block:
    num_rec/rpad/read_len/wire/mode/qual_mode and the qual and dna numpy
    stream tuples; mode 2 adds tok_meta/pcs/v0 and the title stream (when
    sum(pcs) > 0); mode 0 decodes its tag section here, on `device`
    (titles_np, title_len_np)."""
    num_rec = r.get_varint()
    rpad = r.get_varint()
    read_len = r.get_varint()
    if rpad < max(1, num_rec) or rpad % 256 or rpad > (1 << 26):
        raise DsrcException("semi block: bad transmitted lane bucket")
    wire = _get_wire(r, rpad)
    qual_mode = r.get_byte()
    title_mode = r.get_byte()
    if title_mode not in (0, 2):
        raise DsrcException(f"semi block: unknown title mode {title_mode}")
    out = dict(num_rec=num_rec, rpad=rpad, read_len=read_len, wire=wire,
               mode=title_mode, qual_mode=qual_mode)
    if title_mode == 0:
        titles_np, title_len_np = TAG.decode_tags(r, num_rec, tag_cap,
                                                  device)
        out.update(titles_np=titles_np, title_len_np=title_len_np)
    else:
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
    comp = semi_tok_comp_device(d, dev)
    if d["mode"] == 0:
        titles_np, title_len_np = d["titles_np"], d["title_len_np"]
        qual_m, seq_m = UP.decompress_semi(comp, read_len, rpad, left=True,
                                           wire=d["wire"])
    else:
        vmat, qual_m, seq_m = UP.decompress_semi_tok(
            comp, torch.from_numpy(d["v0"]).to(dev), d["pcs"], read_len,
            rpad, left=True, wire=d["wire"])
        titles_np, title_len_np = TAG.render_value_titles(
            to_numpy(vmat[:num_rec]), d["tok_meta"], num_rec)
    return native.layout_records(
        num_rec, titles_np, title_len_np,
        to_numpy(seq_m[:num_rec]).reshape(-1),
        to_numpy(qual_m[:num_rec]).reshape(-1),
        np.full(num_rec, read_len, np.int64), None, color_space,
        plus_repetition)


# --------------------------------------------------------------------------
# Block codec
# --------------------------------------------------------------------------

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


    # -------------------------------------------------- decompress
    def decompress(self, blob: bytes) -> np.ndarray:
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
        comp_np, spec, num_rec, rpad, wire = read_uniform_block(r)
        comp = comp_from_numpy(comp_np, self.device)
        mat = UP.decompress_uniform(comp, spec, rpad, left=True, wire=wire)
        return to_numpy(mat[:num_rec]).reshape(-1)

    def _decompress_semi(self, r: BitReader) -> np.ndarray:
        return self.decompress_parsed_semi(
            parse_semi_block(r, self.shape.cap, self.device))

    def decompress_parsed_semi(self, d: dict) -> np.ndarray:
        """A semi block already parsed by parse_semi_block, decoded on the
        codec's device (a mode-0 block's titles are not decoded again)."""
        return decode_parsed_semi(d, self.device, self.dataset.color_space,
                                  self.dataset.plus_repetition)

    def _decompress_generic(self, r: BitReader) -> np.ndarray:
        sh, st, ds = self.shape, self.settings, self.dataset
        dev = self.device
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
            raise DsrcException("colour-space archive block without primers")
        crcs = None
        if flags & FLAG_CRC:
            crcs = (r.get_uint32(), r.get_uint32(), r.get_uint32())
        titles_np, title_len_np = TAG.decode_tags(r, num_rec, sh.cap, dev)
        hash_val = (HASH_CHAR - offset) if (
            not st.lossy_quality and 0 <= HASH_CHAR - offset < 256) else -1
        qlen_pad = torch.from_numpy(np.pad(
            qual_len_np, (0, sh.rcap - num_rec)).astype(np.int32)).to(dev)
        qvals, q_total = Q.decode_quality(r, sh.cap, qlen_pad, num_rec,
                                          st.quality_order, hash_val)
        dna, _ = DNA.decode_dna(r, sh.cap, st.dna_order, dev)
        backward = _backward_transform_cs if ds.color_space \
            else _backward_transform
        seq, qual = backward(dna, qvals, q_total, offset, st.lossy_quality)
        del dna, qvals
        text = native.layout_records(
            num_rec, titles_np, title_len_np, to_numpy(seq), to_numpy(qual),
            qual_len_np, primers, ds.color_space, ds.plus_repetition)
        if crcs is not None:
            got = _stream_crcs_from_text(text, ds)
            if got != crcs:
                raise DsrcException(
                    "CRC32 mismatch on block self-verification "
                    f"(stored {crcs}, decoded {got})")
        return text


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
