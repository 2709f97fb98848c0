"""The benchmark's FASTQ generators: its own copies, so that a change to the
program's generators (dsrc_tpu_torch/utils/synth.py) or to chip_smoke.py
does not change the yardstick.

make_fastq_fast and make_fastq_realistic are copies of
dsrc_tpu_torch/utils/synth.py (make_fastq_realistic with its model fixed
across seeds); fastq_of_size, realistic_of_size,
umi_fastq_of_size, cut_records and with_iupac are copies of chip_smoke.py.
make_input is the one general generator that a traffic mix's "data"
parameters drive.
"""
from __future__ import annotations

import numpy as np

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _fast_dna(rng: np.random.Generator, n: int) -> np.ndarray:
    """Skewed iid DNA (fast path for large benchmark files)."""
    p = np.array([0.30, 0.21, 0.20, 0.29])
    u = rng.random(n, dtype=np.float32)
    return np.minimum(np.searchsorted(np.cumsum(p), u), 3).astype(np.int64)


def make_fastq_fast(num_records: int, read_len: int, *,
                    quality_offset: int = 33, seed: int = 0,
                    fixed_width: bool = False) -> bytes:
    """Fully vectorized Illumina-style reads: skewed iid DNA, positional
    quality decay with Gaussian noise, titles
    "@SIM001.<i> INSTR:<a>:<b>:<x>:<y> length=<L>" (fixed_width zero-pads
    the numeric fields, so every record has the same length)."""
    rng = np.random.default_rng(seed)
    total = num_records * read_len
    seq = _DNA[_fast_dna(rng, total)].reshape(num_records, read_len)
    pos = np.arange(read_len)
    qmean = 38.0 - 14.0 * (pos / read_len) ** 2
    qual = np.clip(qmean[None, :] + rng.normal(0, 3.0, (num_records,
                                                        read_len)),
                   0, 41).astype(np.uint8)
    qual = qual + quality_offset
    i = np.arange(1, num_records + 1)

    def num(x, width):
        s = x.astype(f"U{width}")
        return np.char.zfill(s, width) if fixed_width else s

    cols = [np.char.add("@SIM001.", num(i, 9)),
            np.char.add(" INSTR:", num(1 + i % 4, 2)),
            np.char.add(":", num(i % 100, 3)),
            np.char.add(":", num(1000 + i * 7 % 9000, 5)),
            np.char.add(":", num(2000 + i * 13 % 9000, 5)),
            np.full(num_records, f" length={read_len}", dtype="U12")]
    titles = cols[0]
    for c in cols[1:]:
        titles = np.char.add(titles, c)
    return _layout(titles, seq, qual)


def make_fastq_realistic(num_records: int, read_len: int = 100, *,
                         platform: str = "hiseq", seed: int = 0) -> bytes:
    """Illumina-style reads with measured-realism statistics: quality as a
    per-cycle mean decay with AR(1) noise (rho 0.6), a per-read shift (4%
    of reads globally bad) and decaying error dips ('novaseq' bins to the
    RTA3 levels 2, 12, 23, 37); DNA an order-2 Markov chain with GC and
    homopolymer bias, about 0.2% N at quality 2, one bad cycle, 1% adapter
    read-through; titles in the 7-field Illumina grammar, tile-sorted with
    jittered coordinates (digit counts vary).

    Unlike the program's synth.py, the run's model (the Markov chain's
    transition matrix and the bad cycle) is the same for every seed, drawn
    from seed 0: the seed draws the reads, not how compressible they are."""
    model = np.random.default_rng(0)
    rng = np.random.default_rng(seed)
    R, L = num_records, read_len

    pos = np.arange(L)
    qmean = 37.5 - 3.0 * (pos / L) ** 1.5 - 9.0 * (pos / L) ** 6
    read_shift = np.where(rng.random(R) < 0.04,
                          rng.normal(-12.0, 4.0, R),
                          rng.normal(0.0, 1.5, R))
    rho, sig = 0.6, 2.8
    # the recurrences along a read run over cycles, on [L, R] copies
    # (contiguous rows); the values are those of synth.py's [R, L] loops
    eps = np.ascontiguousarray(rng.normal(0.0, sig, (R, L)).T)
    ar = np.empty((L, R), np.float32)
    ar[0] = eps[0]
    for j in range(1, L):
        ar[j] = rho * ar[j - 1] + eps[j]
    spikes = np.ascontiguousarray(((rng.random((R, L)) < 0.004)
                                   * rng.normal(-20.0, 5.0, (R, L))).T)
    for j in range(1, L):
        np.minimum(spikes[j], 0.7 * spikes[j - 1], out=spikes[j])
    q = qmean[None, :] + read_shift[:, None] + ar.T + spikes.T
    qual = np.clip(q, 2, 41).astype(np.uint8)
    if platform == "novaseq":
        lv = np.array([2, 12, 23, 37], np.uint8)
        qual = lv[np.maximum(np.searchsorted(lv, qual, side="right") - 1,
                             0)]

    trans = model.dirichlet(np.full(4, 0.8), size=16).astype(np.float32)
    trans = 0.8 * trans + 0.2 * np.array([0.3, 0.2, 0.2, 0.3],
                                         np.float32)[None, :]
    for c in range(16):
        trans[c, c & 3] += 0.15
    trans /= trans.sum(1, keepdims=True)
    cumt = np.cumsum(trans, axis=1)
    base = np.empty((L, R), np.int64)
    state = rng.integers(0, 16, R)
    u = np.ascontiguousarray(rng.random((R, L), dtype=np.float32).T)
    for j in range(L):
        # the count of the state's cumulative probabilities at or below u
        b = sum((u[j] >= cumt[state, k]).astype(np.int64) for k in range(4))
        base[j] = np.minimum(b, 3)
        state = ((state << 2) | base[j]) & 15
    seq = _DNA[base.T]
    adapter = np.frombuffer(b"AGATCGGAAGAGC", np.uint8)
    n_ad = max(1, R // 100)
    ad_rows = rng.choice(R, n_ad, replace=False)
    ad_start = rng.integers(max(1, L - 40), max(2, L - 5), n_ad)
    for r, s in zip(ad_rows, ad_start):
        k = min(len(adapter), L - s)
        seq[r, s:s + k] = adapter[:k]
    nm = rng.random((R, L)) < 0.002
    bad_cycle = int(model.integers(L // 3, L))
    nm[rng.random(R) < 0.3, bad_cycle] = True
    seq[nm] = ord("N")
    qual[nm] = 2

    instr = "A00953"
    run, fc = 417, "HJCMKDSX7"
    lanes = 1 + (np.arange(R) * 4) // R
    tiles = 1101 + ((np.arange(R) * 96) // R) % 96
    x = np.sort(rng.integers(1000, 32000, R)) \
        if R else np.zeros(0, np.int64)
    x = x + rng.integers(-50, 50, R)
    y = rng.integers(1000, 37000, R)
    idx7 = "TTAGGCAT"
    titles = np.char.add(
        np.char.add(
            np.char.add(f"@{instr}:{run}:{fc}:",
                        np.char.add(lanes.astype("U1"), ":")),
            np.char.add(tiles.astype("U4"), ":")),
        np.char.add(np.char.add(x.astype("U5"), ":"),
                    np.char.add(y.astype("U5"),
                                f" 1:N:0:{idx7}")))
    return _layout(titles, seq, qual + 33)


def _layout(titles: np.ndarray, seq: np.ndarray, qual: np.ndarray) -> bytes:
    """FASTQ text of R records from titles [R] (str, with '@'), bases and
    quality characters [R, L] uint8."""
    n, read_len = seq.shape
    tl = np.char.str_len(titles).astype(np.int64)
    maxw = int(tl.max())
    tmat = titles.astype(f"U{maxw}").view(np.uint32).reshape(
        n, maxw).astype(np.uint8)
    rec_len = tl + 1 + read_len + 1 + 1 + 1 + read_len + 1
    starts = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    out = np.zeros(int(rec_len.sum()), np.uint8)
    reps = np.repeat(np.arange(n), tl)
    offs = np.concatenate([[0], np.cumsum(tl)[:-1]])
    within = np.arange(int(tl.sum())) - offs[reps]
    out[starts[reps] + within] = tmat[reps, within]
    nl1 = starts + tl
    out[nl1] = 10
    sq = nl1 + 1
    cols = np.arange(read_len)
    out[(sq[:, None] + cols[None, :]).ravel()] = seq.ravel()
    nl2 = sq + read_len
    out[nl2] = 10
    out[nl2 + 1] = ord("+")
    out[nl2 + 2] = 10
    qd = nl2 + 3
    out[(qd[:, None] + cols[None, :]).ravel()] = qual.ravel()
    out[qd + read_len] = 10
    return out.tobytes()


def cut_records(data: bytes, nbytes: int) -> bytes:
    """data cut at the last whole record within nbytes."""
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4]
    return data[:int(ends[np.searchsorted(ends, nbytes) - 1]) + 1]


def fastq_of_size(nbytes: int, seed: int, read_len: int = 100,
                  fixed_width: bool = False) -> bytes:
    """make_fastq_fast reads cut at the last whole record within nbytes."""
    return cut_records(make_fastq_fast(nbytes // (2 * read_len + 40) + 1,
                                       read_len, seed=seed,
                                       fixed_width=fixed_width), nbytes)


def realistic_of_size(nbytes: int, seed: int, read_len: int = 100,
                      platform: str = "hiseq") -> bytes:
    """make_fastq_realistic reads cut at the last whole record within
    nbytes."""
    return cut_records(make_fastq_realistic(
        nbytes // (2 * read_len + 50) + 1, read_len, platform=platform,
        seed=seed), nbytes)


def umi_fastq_of_size(nbytes: int, seed: int, read_len: int = 100) -> bytes:
    """make_fastq_fast's reads with an 8-base UMI appended to each read
    name, as UMI-tools' extract writes it ("@SIM001.<i>_<UMI> INSTR:..."),
    cut at the last whole record within nbytes.  The UMI is a free-text
    field, so every block takes SEMI title mode 0."""
    n = nbytes // (2 * read_len + 40) + 1
    arr = np.frombuffer(make_fastq_fast(n, read_len, seed=seed), np.uint8)
    ends = np.flatnonzero(arr == 10)[3::4]
    starts = np.concatenate([[0], ends[:-1] + 1])
    ndig = np.floor(np.log10(np.arange(1, n + 1))).astype(np.int64) + 1
    at = starts + len("@SIM001.") + ndig            # the name's first space
    rng = np.random.default_rng(seed)
    umi = np.concatenate([np.full((n, 1), ord("_"), np.uint8),
                          np.frombuffer(b"ACGT", np.uint8)[
                              rng.integers(0, 4, (n, 8))]], axis=1)
    out = np.insert(arr, np.repeat(at, 9), umi.ravel()).tobytes()
    return cut_records(out, nbytes)


def with_iupac(data: bytes, share: float, seed: int) -> bytes:
    """Replace about `share` of the bases whose quality is at least 20 by
    IUPAC codes, so that the DNA keeps more than 8 distinct symbols."""
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(data, np.uint8).copy()
    nl = np.flatnonzero(arr == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    ends = np.append(nl, len(arr))
    seq = np.arange(1, len(starts) - 1, 4)
    lens = ends[seq] - starts[seq]
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    pos = np.repeat(starts[seq], lens) + within
    qpos = np.repeat(starts[seq + 2], lens) + within
    pick = (rng.random(len(pos)) < share) & (arr[qpos] >= 33 + 20)
    codes = np.frombuffer(b"RWSKMDVHBY", np.uint8)
    arr[pos[pick]] = codes[rng.integers(0, len(codes), int(pick.sum()))]
    return arr.tobytes()


GENERATORS = ("fast", "realistic", "umi")


def data_seed(seed: int) -> int:
    """A run's --seed as the generators' seed: any whole number, negative
    or above 2^63 too, maps to one in [0, 2^63)."""
    return int(seed) % (1 << 63)


def make_input(spec: dict, seed: int) -> bytes:
    """The FASTQ bytes of a traffic mix's "data" parameters, from the seed:

      generator    "fast" (make_fastq_fast), "realistic"
                   (make_fastq_realistic) or "umi" (fast reads with a UMI
                   in each read name)
      bytes        the file is cut at the last whole record within this
      read_len     bases a read (default 100)
      titles       "variable" (default) or "fixed" digit counts ("fast")
      platform     "hiseq" (default) or "novaseq" ("realistic")
      iupac_share  share of bases at quality >= 20 replaced by IUPAC
                   codes (default 0)
    """
    s = data_seed(seed)
    kind, nbytes = spec["generator"], int(spec["bytes"])
    read_len = int(spec.get("read_len", 100))
    if kind == "fast":
        titles = spec.get("titles", "variable")
        if titles not in ("variable", "fixed"):
            raise ValueError(f"unknown titles {titles!r}")
        data = fastq_of_size(nbytes, s, read_len, titles == "fixed")
    elif kind == "realistic":
        data = realistic_of_size(nbytes, s, read_len,
                                 spec.get("platform", "hiseq"))
    elif kind == "umi":
        data = umi_fastq_of_size(nbytes, s, read_len)
    else:
        raise ValueError(f"unknown generator {kind!r} (one of "
                         f"{', '.join(GENERATORS)})")
    share = float(spec.get("iupac_share", 0.0))
    return with_iupac(data, share, s) if share else data
