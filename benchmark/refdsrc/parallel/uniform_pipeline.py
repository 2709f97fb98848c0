"""Device math of the UNIFORM and SEMI block classes: the port of
dsrc_tpu/parallel/uniform_pipeline.py.

Uniform blocks (every record the same byte length) become reshapes of
[R, rec_bytes]; semi blocks (fixed read length, titles of varying length)
arrive as host-staged [rpad, read_len] quality/DNA matrices plus a title
value matrix.  Each symbol matrix [rpad, P] is coded by shared-row
positional rANS: lanes are groups of G consecutive records, step t = g*P + p
of every lane codes record g of its group at position p with the
transmitted table row p, so every lane reads the same model row at each
step.  The encode loop is kernel K1 and the decode loop kernel K2
(ops/rans_kernels.py); the rest is bulk integer tensor work on the block's
device: histograms, table quantization, delta and zigzag transforms, 2-bit
DNA packing with an exception bitmap.

Integer exactness: torch.cumsum and sums of int32 promote to int64, so the
transforms either stay below 2^31 or wrap back to int32 explicitly, as the
reference's int32 arithmetic does; modular reductions use floor `%` or `&`.
No value goes through a float product.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.rans import cum_from_freqs
from ..ops.rans_kernels import rans_decode

QUAL_A = 64
TITLE_A = 128


class UniformSpec(NamedTuple):
    rec_bytes: int
    title_len: int   # without '@'
    read_len: int

    @property
    def layout_ok(self) -> bool:
        # @<title>\n<seq>\n+\n<qual>\n
        return self.rec_bytes == (1 + self.title_len + 1 + self.read_len
                                  + 1 + 2 + self.read_len + 1)


# --------------------------------------------------------------------------
# Shared-row positional rANS
# --------------------------------------------------------------------------


def qual_delta_inv(mat: torch.Tensor, nsym: int) -> torch.Tensor:
    return (torch.cumsum(mat, dim=1) % nsym).to(torch.int32)


def decode_positional(payload: torch.Tensor, states: torch.Tensor,
                      nwords: torch.Tensor, table: torch.Tensor,
                      num_rec: int, p: int, rpad: int, nsym: int,
                      group: int, left: bool = False) -> torch.Tensor:
    """Mirror of encode_positional.  Returns mat [Rpad, P] int32.

    left=True: words are left-aligned in each payload row (deserialized
    blocks); otherwise right-aligned, as the encoder writes them."""
    ll = rpad // group
    if payload.shape[0] != ll or table.shape != (p, nsym):
        raise ValueError("positional stream shape mismatch")
    return rans_decode(payload.contiguous(), states.contiguous(),
                       start_words(payload, nwords, left),
                       cum_from_freqs(table).contiguous(), num_rec, group)


def start_words(payload: torch.Tensor, nwords: torch.Tensor,
                left: bool) -> torch.Tensor:
    """K2's per-lane start word: 0 for left-aligned rows, 2*W - nwords for
    the right-aligned rows the encoder writes."""
    if left:
        return torch.zeros(payload.shape[0], dtype=torch.int32,
                           device=payload.device)
    return (2 * payload.shape[1] - nwords).to(torch.int32).contiguous()


def invert_title_delta(mat: torch.Tensor, group: int,
                       nsym: int = TITLE_A) -> torch.Tensor:
    """Inverse of title_delta: a modular cumsum within each `group` of
    consecutive records."""
    r, p = mat.shape
    m = mat.reshape(r // group, group, p)
    return (torch.cumsum(m, dim=1) % nsym).reshape(r, p).to(torch.int32)


# --------------------------------------------------------------------------
# DNA: 2-bit pack + exception bitmap
# --------------------------------------------------------------------------


def unpack_dna(packed: torch.Tensor, exc_bits: torch.Tensor, rpad: int,
               p: int) -> torch.Tensor:
    """Inverse of pack_dna -> seq [Rpad, P] uint8 (needs
    len(packed) >= ceil(Rpad*P/4))."""
    dev = packed.device
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=dev)
    flat = ((packed.to(torch.int32)[:, None] >> shifts) & 3).reshape(-1)
    flat2 = flat[: rpad * p].reshape(rpad, p)
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    seq = lut[flat2.to(torch.int64)]
    col = torch.arange(p, device=dev)
    nmask = (exc_bits[:, col // 32] >> (col % 32).to(torch.int32)) & 1
    return torch.where(nmask == 1, ord("N"), seq).to(torch.uint8)


# --------------------------------------------------------------------------
# Whole-block uniform compress / decompress
# --------------------------------------------------------------------------

TITLE_GROUP = 16       # title vertical-delta group: literal fraction 1/16
TITLE_CODE_GROUP = 8   # rANS lane group of the (delta-transformed) titles
QUAL_GROUP = 8


class Wire(NamedTuple):
    """Per-block wire-format layout parameters, transmitted in the block
    header; decoders follow the header, never these defaults."""
    title_a: int = TITLE_A
    qual_a: int = QUAL_A
    title_group: int = TITLE_GROUP            # title vertical-delta group
    title_code_group: int = TITLE_CODE_GROUP  # title rANS lane group
    qual_group: int = QUAL_GROUP              # quality rANS lane group
    val_group: int = 64   # rANS lane group of the semi mode-2 value planes

    def validate(self, rpad: int) -> None:
        for a in (self.title_a, self.qual_a):
            if not (8 <= a <= 512 and a % 8 == 0):
                raise ValueError(f"bad wire alphabet {a}")
        if self.title_a & (self.title_a - 1):
            raise ValueError("title alphabet must be a power of two")
        for g in (self.title_group, self.title_code_group, self.qual_group,
                  self.val_group):
            if not (1 <= g <= 256 and rpad % g == 0):
                raise ValueError(f"bad wire lane group {g} for rpad {rpad}")


WIRE_DEFAULT = Wire()


def _decode_qual(comp: dict, read_len: int, rpad: int, wr: Wire,
                 left: bool) -> torch.Tensor:
    qp, qn, qs, qtab = comp["qual"]
    qdec = decode_positional(qp, qs, qn, qtab, int(comp["num_rec"]),
                             read_len, rpad, wr.qual_a, wr.qual_group,
                             left=left)
    if int(comp["qual_mode"]) > 0:
        qdec = qual_delta_inv(qdec, wr.qual_a)
    return qdec + 33


def decompress_uniform(comp: dict, spec: UniformSpec, rpad: int,
                       left: bool = False,
                       wire: Wire = WIRE_DEFAULT) -> torch.Tensor:
    """Mirror of compress_uniform -> [Rpad, rec_bytes] uint8 (rows past
    num_rec zero)."""
    s, wr = spec, wire
    num_rec = int(comp["num_rec"])
    tp, tn, ts, ttab = comp["title"]
    tdel = decode_positional(tp, ts, tn, ttab, num_rec, s.title_len, rpad,
                             wr.title_a, wr.title_code_group, left=left)
    title = invert_title_delta(tdel, wr.title_group, wr.title_a) + 32
    qual = _decode_qual(comp, s.read_len, rpad, wr, left)
    packed, exc_bits, _ = comp["dna"]
    seq = unpack_dna(packed, exc_bits, rpad, s.read_len)
    dev = seq.device

    def const(ch):
        return torch.full((rpad, 1), ch, dtype=torch.uint8, device=dev)

    mat = torch.cat([const(ord("@")), title.to(torch.uint8), const(10), seq,
                     const(10), const(ord("+")), const(10),
                     qual.to(torch.uint8), const(10)], dim=1)
    mat[num_rec:] = 0
    return mat


# --------------------------------------------------------------------------
# Semi blocks, title mode 0: quality and DNA as in mode 2; the titles go
# through the host tag coder (models/tag.py), not through this module.
# --------------------------------------------------------------------------


def decompress_semi(comp: dict, read_len: int, rpad: int, left: bool = False,
                    wire: Wire = WIRE_DEFAULT):
    """Mirror of compress_semi.  Returns (qual_m, seq_m [rpad, read_len]
    uint8), rows past num_rec zero."""
    num_rec = int(comp["num_rec"])
    qual = _decode_qual(comp, read_len, rpad, wire, left).to(torch.uint8)
    packed, exc_bits, _ = comp["dna"]
    seq = unpack_dna(packed, exc_bits, rpad, read_len)
    for m in (qual, seq):
        m[num_rec:] = 0
    return qual, seq


# --------------------------------------------------------------------------
# Semi blocks, title mode 2: titles tokenized on the host
# (models/tag.analyze_value_fields) into constant fields and an [rpad, F]
# int32 numeric VALUE matrix, coded on the device by vertical delta ->
# zigzag -> per-field byte planes -> positional rANS.
# --------------------------------------------------------------------------

VAL_A = 256     # byte-plane alphabet


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the reference's int32 wraparound)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _planes_to_values(planes: torch.Tensor, v0: torch.Tensor,
                      pcs: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of _value_planes: [rpad, sum(pcs)] -> [rpad, F] int32, the
    running sum wrapped to int32 as the reference's int32 cumsum."""
    off = 0
    zs = []
    for pc in pcs:
        z = planes[:, off].to(torch.int64)
        for b in range(1, pc):
            z = z | (planes[:, off + b].to(torch.int64) << (8 * b))
        zs.append(z)
        off += pc
    z = _wrap_i32(torch.stack(zs, dim=1))
    d = (z >> 1) ^ -(z & 1)                        # un-zigzag, int32
    # running sum down each column, taken along the innermost axis of the
    # transpose: PyTorch scans a column of this narrow matrix with a single
    # CUDA block (5.7 ms per 8 MB block on an H100)
    run = torch.cumsum(d.t().to(torch.int64).contiguous(), dim=1).t()
    return _wrap_i32(run + v0[None, :].to(torch.int64)).contiguous()


def decompress_semi_tok(comp: dict, v0: torch.Tensor, pcs: Tuple[int, ...],
                        read_len: int, rpad: int, left: bool = False,
                        wire: Wire = WIRE_DEFAULT):
    """Mirror of compress_semi_tok.  Returns (vmat [rpad, F] int32,
    qual_m, seq_m [rpad, read_len] uint8), rows past num_rec zero."""
    wr = wire
    num_rec = int(comp["num_rec"])
    dev = comp["qual"][0].device
    if sum(pcs):
        tp, tn, ts, ttab = comp["title"]
        planes = decode_positional(tp, ts, tn, ttab, num_rec, sum(pcs),
                                   rpad, VAL_A, wr.val_group, left=left)
        vmat = _planes_to_values(planes, v0, pcs)
    else:
        vmat = torch.zeros((rpad, len(pcs)), dtype=torch.int32, device=dev)
    vmat[num_rec:] = 0
    qual, seq = decompress_semi(comp, read_len, rpad, left, wr)
    return vmat, qual, seq
