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

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.hist_kernels import pos_hist
from ..ops.rans import cum_from_freqs, quantize_counts
from ..ops.rans_kernels import rans_decode, rans_encode_from_freqs
from ..ops.streams import item

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


def detect_spec(head: bytes) -> Optional[UniformSpec]:
    """Infer the uniform record layout from the first record (host)."""
    try:
        e1 = head.index(b"\n")
        e2 = head.index(b"\n", e1 + 1)
        e3 = head.index(b"\n", e2 + 1)
        e4 = head.index(b"\n", e3 + 1)
    except ValueError:
        return None
    if head[:1] != b"@" or head[e2 + 1:e3] != b"+":
        return None
    spec = UniformSpec(rec_bytes=e4 + 1, title_len=e1 - 1,
                       read_len=e2 - e1 - 1)
    return spec if spec.layout_ok and e3 - e2 - 1 == 1 and \
        (e4 - e3 - 1) == spec.read_len else None


def check_uniform(mat: torch.Tensor, spec: UniformSpec, num_rec: int) -> bool:
    """mat: [Rpad, rec_bytes] uint8 (rows >= num_rec are padding).  True when
    every record matches the layout, all DNA is in ACGTN and quality in
    [33, 97)."""
    s = spec
    t1 = 1 + s.title_len
    s0 = t1 + 1
    s1 = s0 + s.read_len
    p0, p1 = s1 + 1, s1 + 2
    q0 = p1 + 1
    q1 = q0 + s.read_len
    m = mat[:num_rec]
    ok = (m[:, 0] == ord("@")).all()
    for col, ch in ((t1, 10), (s1, 10), (p0, ord("+")), (p1, 10), (q1, 10)):
        ok &= (m[:, col] == ch).all()
    title = m[:, 1:t1]
    ok &= ((title >= 32) & (title < 32 + TITLE_A)).all()
    seq = m[:, s0:s1]
    ok &= ((seq == ord("A")) | (seq == ord("C")) | (seq == ord("G"))
           | (seq == ord("T")) | (seq == ord("N"))).all()
    qual = m[:, q0:q1]
    ok &= ((qual >= 33) & (qual < 33 + QUAL_A)).all()
    return bool(item(ok))


# --------------------------------------------------------------------------
# Shared-row positional rANS
# --------------------------------------------------------------------------

def _group_lanes(mat: torch.Tensor, g: int) -> torch.Tensor:
    """[R, P] -> lanes [T=G*P, L=R//G]: lanes[gp*P+p, l] = mat[l*G+gp, p]."""
    rr, p = mat.shape
    return mat.reshape(rr // g, g, p).permute(1, 2, 0).reshape(g * p, rr // g)


def _lookup_packed(mat: torch.Tensor, table: torch.Tensor,
                   cumfull: torch.Tensor, nsym: int) -> torch.Tensor:
    """Packed (cum << 15 | freq) of every symbol of mat [Rpad, P] (all in
    [0, nsym)) under its position's table row: one gather."""
    packed_tab = (cumfull[:, :nsym] << 15) | table                 # [P, A]
    return torch.gather(packed_tab, 1, mat.t().to(torch.int64)).t()


def qual_delta(mat: torch.Tensor, nsym: int) -> torch.Tensor:
    """Horizontal within-read delta: sym[:, i] = (q[:, i] - q[:, i-1]) mod
    nsym (column 0 literal; floor modulo)."""
    prev = torch.cat([torch.zeros_like(mat[:, :1]), mat[:, :-1]], dim=1)
    return (mat - prev) % nsym


def qual_delta_inv(mat: torch.Tensor, nsym: int) -> torch.Tensor:
    return (torch.cumsum(mat, dim=1) % nsym).to(torch.int32)


def _pos_entropy_bits(hist: torch.Tensor) -> torch.Tensor:
    """Code length estimate (bits, float32) of per-position histograms
    [P, A] — used only to CHOOSE a transform; the choice is transmitted, so
    float rounding cannot desync encoder and decoder."""
    h = hist.to(torch.float32)
    tot = h.sum(dim=1, keepdim=True)
    p = h / torch.clamp(tot, min=1.0)
    return -torch.sum(torch.where(
        h > 0, h * torch.log2(torch.clamp(p, min=1e-12)),
        torch.zeros((), dtype=torch.float32, device=h.device)))


def positional_models(mat: torch.Tensor, num_rec: int, nsym: int,
                      group: int):
    """Front end of encode_positional: the quantized table [P, A] of mat
    [Rpad, P] and, in the lane layout of K1, every symbol's model: freq,
    cum [T, L] int32 and active [T, L] bool, T = group*P, L = Rpad/group."""
    rpad, p = mat.shape
    ll = rpad // group
    t_steps = group * p
    dev = mat.device
    table = quantize_counts(pos_hist(mat, num_rec, nsym))
    cumfull = cum_from_freqs(table)
    rows = torch.arange(rpad, dtype=torch.int64, device=dev)
    live = torch.where((rows < num_rec)[:, None], mat,
                       torch.zeros((), dtype=mat.dtype, device=dev))
    lanes = _group_lanes(_lookup_packed(live, table, cumfull, nsym), group)
    rec_idx = (torch.arange(ll, dtype=torch.int64, device=dev) * group)[
        None, :] + (torch.arange(t_steps, dtype=torch.int64, device=dev)
                    // max(p, 1))[:, None]
    return ((lanes & 0x7FFF).contiguous(), (lanes >> 15).contiguous(),
            (rec_idx < num_rec).contiguous(), table)


def encode_positional(mat: torch.Tensor, num_rec: int, nsym: int,
                      group: int):
    """mat: [Rpad, P] int32 symbols in [0, nsym) (rows >= num_rec are
    padding).  Returns (payload [L, Wp] int32 pairs, nwords [L], states [L]
    int32 (u32 bits), table [P, A] int32 quantized freqs — transmitted, like
    the reference's per-position Huffman trees)."""
    freq, cum, active, table = positional_models(mat, num_rec, nsym, group)
    payload, nwords, states = rans_encode_from_freqs(freq, cum, active)
    return payload, nwords, states, table


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


def title_delta(mat: torch.Tensor, group: int,
                nsym: int = TITLE_A) -> torch.Tensor:
    """Vertical byte-delta for fixed-format titles: symbol = (char -
    prev_record_char) mod nsym within a group of records; the group's first
    record is coded literally.  nsym must be a power of two."""
    rpad = mat.shape[0]
    prev = torch.cat([torch.zeros_like(mat[:1]), mat[:-1]], dim=0)
    first = ((torch.arange(rpad, device=mat.device) % group) == 0)[:, None]
    prev = torch.where(first, torch.zeros_like(prev), prev)
    return (mat - prev) & (nsym - 1)


# --------------------------------------------------------------------------
# DNA: 2-bit pack + exception bitmap
# --------------------------------------------------------------------------

def _exc_words(p: int) -> int:
    return -(-p // 32)


def pack_dna(seq: torch.Tensor, num_rec: int, read_len: int):
    """seq: [Rpad, P] uint8 ACGTN.  Returns (packed 2-bit bytes uint8
    [ceil(Rpad*P/4)], record-major, 4 bases per byte low bits first;
    exc_bits [Rpad, ceil(P/32)] int32 bitmap (u32 bits) of non-ACGT bases
    of live records; exc_count).  Integer shifts only.  Rows pack
    back-to-back, so a read length that is not a multiple of 4 packs across
    row boundaries."""
    rpad, p = seq.shape
    dev = seq.device
    code = torch.zeros(seq.shape, dtype=torch.int32, device=dev)
    for i, ch in enumerate(b"CGT", start=1):
        code = torch.where(seq == ch, i, code)
    is_exc = ~((seq == ord("A")) | (seq == ord("C")) | (seq == ord("G"))
               | (seq == ord("T")))
    is_exc &= (torch.arange(rpad, device=dev) < num_rec)[:, None]
    flat = code.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.shape[0]) % 4)])
    q = flat.reshape(-1, 4)
    packed = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)) \
        .to(torch.uint8)
    wcnt = _exc_words(p)
    bits = torch.cat([is_exc, is_exc.new_zeros((rpad, wcnt * 32 - p))], 1) \
        .reshape(rpad, wcnt, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << \
        torch.arange(32, dtype=torch.int64, device=dev)
    words = (bits * weights).sum(-1)                      # distinct bits: OR
    exc_bits = (words - ((words >> 31) << 32)).to(torch.int32)
    return packed, exc_bits, is_exc.sum()


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


def _choose_qual_syms(qual: torch.Tensor, num_rec: int, wr: Wire):
    """Per-block choice between direct and horizontal-delta quality
    symbols by estimated positional code length (float32, as the
    reference); the winning mode is transmitted (qual_mode byte).  Returns
    (symbols [Rpad, P] int32, qual_mode 0-dim int32 tensor)."""
    qsym = torch.clamp(qual, 0, wr.qual_a - 1)
    qd = qual_delta(qsym, wr.qual_a)
    bits_direct = _pos_entropy_bits(pos_hist(qsym, num_rec, wr.qual_a))
    bits_delta = _pos_entropy_bits(pos_hist(qd, num_rec, wr.qual_a))
    use_delta = bits_delta < bits_direct
    return torch.where(use_delta, qd, qsym), use_delta.to(torch.int32)


def compress_uniform(mat: torch.Tensor, num_rec: int, spec: UniformSpec,
                     rpad: int, wire: Wire = WIRE_DEFAULT) -> dict:
    """mat: [Rpad, rec_bytes] uint8 on the block's device (rows past num_rec
    zero).  Compressed tensors stay on the device."""
    s, wr = spec, wire
    t1 = 1 + s.title_len
    s0 = t1 + 1
    s1 = s0 + s.read_len
    q0 = s1 + 3
    title = mat[:, 1:t1].to(torch.int32) - 32
    seq = mat[:, s0:s1]
    qual = mat[:, q0:q0 + s.read_len].to(torch.int32) - 33
    tsyms = title_delta(torch.clamp(title, 0, wr.title_a - 1),
                        wr.title_group, wr.title_a)
    tup_t = encode_positional(tsyms, num_rec, wr.title_a,
                              wr.title_code_group)
    qenc, qual_mode = _choose_qual_syms(qual, num_rec, wr)
    tup_q = encode_positional(qenc, num_rec, wr.qual_a, wr.qual_group)
    return dict(num_rec=num_rec, qual_mode=qual_mode, title=tup_t,
                qual=tup_q, dna=pack_dna(seq, num_rec, s.read_len))


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

def compress_semi(qual_m: torch.Tensor, seq_m: torch.Tensor, num_rec: int,
                  read_len: int, wire: Wire = WIRE_DEFAULT) -> dict:
    """qual_m/seq_m: [rpad, read_len] uint8 on the block's device (rows
    past num_rec zero).  Compressed tensors stay on the device."""
    wr = wire
    qenc, qual_mode = _choose_qual_syms(qual_m.to(torch.int32) - 33,
                                        num_rec, wr)
    return dict(num_rec=num_rec, qual_mode=qual_mode,
                qual=encode_positional(qenc, num_rec, wr.qual_a,
                                       wr.qual_group),
                dna=pack_dna(seq_m, num_rec, read_len))


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


def _value_planes(vmat: torch.Tensor, v0: torch.Tensor,
                  pcs: Tuple[int, ...]) -> torch.Tensor:
    """[rpad, F] int32 values -> [rpad, sum(pcs)] int32 byte-plane symbols:
    full-column vertical delta (record 0 against the transmitted v0),
    zigzag, then pcs[f] little-endian byte planes of field f.  All int32."""
    prev = torch.cat([v0[None, :].to(torch.int32), vmat[:-1]], dim=0)
    d = vmat - prev
    z = (d << 1) ^ (d >> 31)
    cols = [(z[:, f] >> (8 * b)) & 255
            for f, pc in enumerate(pcs) for b in range(pc)]
    return torch.stack(cols, dim=1)


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


def compress_semi_tok(vmat: torch.Tensor, v0: torch.Tensor,
                      qual_m: torch.Tensor, seq_m: torch.Tensor,
                      num_rec: int, pcs: Tuple[int, ...], read_len: int,
                      rpad: int, wire: Wire = WIRE_DEFAULT) -> dict:
    """vmat: [rpad, F] int32 field values (rows past num_rec 0); v0: [F]
    int32 transmitted base values; qual_m/seq_m: [rpad, read_len] uint8.
    All on the block's device."""
    out = compress_semi(qual_m, seq_m, num_rec, read_len, wire)
    if sum(pcs):
        planes = _value_planes(vmat, v0, pcs)
        out["title"] = encode_positional(planes, num_rec, VAL_A,
                                         wire.val_group)
    return out


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
