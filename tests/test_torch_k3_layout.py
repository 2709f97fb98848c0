"""K3's row layout, symbol search and route choice (ops/ctx_kernels.py,
csrc/ctx_dec.cu), and the colour-space CRC of decoded GENERIC text
(models/block.py), on the CPU.

The kernel reads a table as rows of packed words (rows_packed): entry j
holds cum[j] | cum[j+1] << 16.  The t threads of a lane (row_layout) hold
e entries each, thread k entries e*k .. e*k+e-1; the symbol s is the count
of entries below (slot+1) << 16, one ballot per entry index, at most A-1,
and one shuffle from thread s // e returns its entry s % e.  A numpy
mirror of that search must give the symbol, cum[s] and freq of
ctx_decode_band_plain for every slot.
"""
import zlib

import numpy as np
import pytest
import torch

from dsrc_tpu.config import DatasetType as JDatasetType
from dsrc_tpu.models import block as JB
from dsrc_tpu_torch.config import DatasetType, DsrcException
from dsrc_tpu_torch.models import block as TB
from dsrc_tpu_torch.models.tag import TEXT_NUM_CTX
from dsrc_tpu_torch.ops import ctx_kernels as CK
from dsrc_tpu_torch.ops.rans import M, cum_from_freqs, quantize_counts
from dsrc_tpu_torch.utils.synth import make_fastq
from torch_threads import one_torch_thread  # noqa: F401

SLOTS = np.arange(M, dtype=np.int64)


def mirror_search(row: np.ndarray, nsym: int, slots: np.ndarray):
    """The kernel's search over one packed row for many slots: (s, cum[s],
    freq), each [len(slots)]."""
    threads, entries = CK.row_layout(nsym)
    e = (row.astype(np.int64) & 0xFFFFFFFF).reshape(threads, entries)
    lim = (slots + 1) << 16
    # one ballot per entry index i over the lane's threads, summed
    cnt = sum((e[None, :, i] < lim[:, None]).sum(1) for i in range(entries))
    s = np.minimum(cnt, nsym - 1)
    w = e[s // entries, s % entries]          # shuffle from thread s // e
    return s, w & 0xFFFF, (w >> 16) - (w & 0xFFFF)


def plain_search(cum_row: torch.Tensor):
    """(s, cum[s], freq) of ctx_decode_band_plain for every slot: one step
    of 2^14 lanes from x = slot and x = slot + 2^14, a zero payload."""
    nsym = cum_row.shape[0] - 1
    cum = cum_row[None, :].contiguous()
    out = []
    for hi in (0, 1):
        x = torch.from_numpy(SLOTS + (hi << 14)).to(torch.int32)
        wptr = torch.zeros(M, dtype=torch.int32)
        osym = torch.zeros((M, 1), dtype=torch.int32)
        CK.ctx_decode_band_plain(
            torch.zeros((M, 1), dtype=torch.int32), x, wptr,
            torch.zeros_like(wptr), torch.ones_like(wptr), cum,
            torch.zeros((M, 1), dtype=torch.int32), osym,
            torch.zeros_like(osym), 0, 1, CK.CtxMode(CK.MODE_PRECOMPUTED))
        assert int(wptr.min()) == 1                # x < 2^16: shifted in
        out.append((x.numpy().astype(np.int64) & 0xFFFFFFFF) >> 16)
        s = osym[:, 0].numpy().astype(np.int64)
    x0, x1 = out                                    # slot - c, f + slot - c
    assert nsym >= 2
    return s, SLOTS - x0, x1 - x0


def _rows(case: str):
    """[C, A+1] int32 cum tables of one case, and A."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case.startswith("random"):
        nsym = int(case.split("_")[1])
        counts = rng.geometric(0.02, (3, nsym)) - 1
        counts[0, rng.random(nsym) < 0.5] = 0          # unseen symbols
        return cum_from_freqs(quantize_counts(torch.from_numpy(counts))), nsym
    if case == "one_dominant":
        counts = np.zeros((2, 64), np.int64)
        counts[0, 0] = 10**6
        counts[1, 63] = 10**6
        return cum_from_freqs(quantize_counts(torch.from_numpy(counts))), 64
    # rows whose last entry is below 2^14, some freqs 0 (the card test
    # test_k3_word_pointer_at_the_payload_end builds such tables)
    table = rng.integers(1, 4000, (3, 64)).astype(np.int64)
    table[:, [5, 40, 63]] = 1                      # freqs 0 once scaled
    table = (table * M // table.sum(1, keepdims=True)).astype(np.int32)
    cum = cum_from_freqs(torch.from_numpy(table))
    assert int(cum[:, -1].max()) < M and int((table == 0).sum()) > 0
    return cum, 64


@pytest.mark.parametrize("case", ["random_4", "random_16", "random_64",
                                  "random_256", "one_dominant",
                                  "last_below_2_14"])
def test_packed_row_search_equals_plain_for_every_slot(case):
    cum, nsym = _rows(case)
    threads, entries = CK.row_layout(nsym)
    rows = CK.rows_packed(cum, threads * entries).numpy()
    assert int(cum.max()) <= M and bool((cum[:, 1:] >= cum[:, :-1]).all())
    assert bool((cum[:, 0] == 0).all())
    for r in range(cum.shape[0]):
        got = mirror_search(rows[r], nsym, SLOTS)
        want = plain_search(cum[r])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nsym", [2, 4, 8, 9, 16, 33, 64, 200, 256])
def test_row_layout_and_packed_rows(nsym):
    threads, entries = CK.row_layout(nsym)
    assert threads in (8, 16, 32) and entries in (1, 2, 4, 8)
    assert threads * entries >= nsym
    assert entries == 1 or threads * entries // 2 < nsym
    counts = torch.from_numpy(np.random.default_rng(nsym).integers(
        0, 50, (5, nsym)))
    cum = cum_from_freqs(quantize_counts(counts))
    rows = CK.rows_packed(cum, threads * entries)
    assert rows.dtype == torch.int32
    assert rows.shape == (5, threads * entries)
    u = rows.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(u[:, :nsym] & 0xFFFF, cum[:, :-1].to(torch.int64))
    assert torch.equal(u[:, :nsym] >> 16, cum[:, 1:].to(torch.int64))
    assert bool((u[:, nsym:] == 0xFFFFFFFF).all())


@pytest.mark.parametrize("nctx,nsym,route", [
    (256, 16, "shared"),                # DNA pairs, order 2: 16 KB
    (4096, 64, "global"),               # -m1 / -m2 quality: 1 MB
    (TEXT_NUM_CTX, 256, "global"),      # tag text: 128 KB
    (96, 256, "shared"),
    (1 << 18, 16, "global"),
    (1, 2, "shared")])
def test_ctx_route(nctx, nsym, route):
    assert CK.ctx_route(nctx, nsym) == route
    threads, entries = CK.row_layout(nsym)
    smem = CK.route_smem_bytes("shared", nctx, nsym)
    assert smem == nctx * 4 * threads * entries
    assert (smem <= CK.CTX_SMEM_BUDGET) == (route == "shared")
    assert CK.route_smem_bytes("global", nctx, nsym) == 0


def test_unknown_route_raises():
    z = torch.zeros(4, dtype=torch.int32)
    out = torch.zeros((4, 2), dtype=torch.int32)
    cum = cum_from_freqs(quantize_counts(torch.ones((3, 4),
                                                    dtype=torch.int64)))
    with pytest.raises(DsrcException, match="route"):
        CK.ctx_decode_band(torch.zeros((4, 64), dtype=torch.int32), z,
                           z.clone(), z.clone(), z.clone(), cum, None, out,
                           out.clone(), 0, 2,
                           CK.CtxMode(CK.MODE_HISTORY, sbits=2, cmask=0),
                           route="texture")


@pytest.mark.parametrize("color_space", [False, True])
@pytest.mark.parametrize("variable_length", [False, True])
def test_stream_crcs_equal_reference(color_space, variable_length):
    """The decoded-text CRCs of a GENERIC block: the port's function equals
    the reference's, which skips the primer base of colour-space reads."""
    text = np.frombuffer(make_fastq(300, 50, seed=23, color_space=color_space,
                                    variable_length=variable_length),
                         np.uint8)
    got = TB._stream_crcs_from_text(text, DatasetType(color_space=color_space))
    want = JB._stream_crcs_from_text(text,
                                     JDatasetType(color_space=color_space))
    assert got == want
    other = TB._stream_crcs_from_text(
        text, DatasetType(color_space=not color_space))
    assert other[1] != got[1] and other[0::2] == got[0::2]
