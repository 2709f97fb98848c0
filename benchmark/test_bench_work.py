"""Each kernel's work count on a small shape worked by hand, with nothing
charged for the search of a table; and the calls a traced run records."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from yardstick import work


def _totals(terms):
    return work.totals(terms)


def test_k1_by_hand():
    # T = 3 steps, L = 2 lanes; 3 active steps; lanes emit 2 and 1 words
    freq = torch.ones(3, 2, dtype=torch.int32)
    active = torch.tensor([[1, 1], [1, 0], [0, 0]], dtype=torch.bool)
    out = (None, torch.tensor([2, 1], dtype=torch.int32), None)
    nbytes, nops = _totals(work.k1_count((freq, freq, active), {}, out))
    # flags 6, freq + cum of 3 active steps at 2 bytes each 12, 3 u16
    # words 6, 2 lanes' word count and state 16; 8 operations a symbol
    assert (nbytes, nops) == (6 + 12 + 6 + 16, 3 * 8)


def _rows(*lanes):
    """payload [L, W] int32 whose row l holds the u16 words lanes[l]
    (padded with zero words), as the kernels read it."""
    w = max(len(r) for r in lanes) + 3
    w += w % 2
    u16 = torch.zeros(len(lanes), w, dtype=torch.int16)
    for i, r in enumerate(lanes):
        u16[i, :len(r)] = torch.tensor(r, dtype=torch.int16)
    return u16.view(torch.int32)


def test_lane_words():
    # lane 0 holds 3 words from word 0 (a zero word inside counts), lane 1
    # one; the padding of the rows is not charged
    payload = _rows([5, 0, 7], [9])
    assert int(work.lane_words(payload)) == 4
    # right-aligned: from each lane's start word to its last word
    payload = _rows([0, 0, 4, 1], [0, 0, 0, 3])
    start = torch.tensor([2, 3], dtype=torch.int32)
    assert int(work.lane_words(payload, start)) == 3
    assert work.value_bytes(4) == 1 and work.value_bytes(256) == 1
    assert work.value_bytes(257) == 2 and work.TABLE_BYTES == 2
    assert work.value_bytes(1 << 18) == 3


@pytest.mark.parametrize("nsym", [4, 200])
def test_k2_by_hand_no_search_charge(nsym):
    payload = _rows([1, 2, 3], [4, 5])                  # L = 2, 5 words
    lanes = torch.zeros(2, dtype=torch.int32)
    cum = torch.zeros(4, nsym + 1, dtype=torch.int32)   # P = 4
    args = (payload, lanes, lanes, cum, 3, 2)           # 3 records of 4
    nbytes, nops = _totals(work.k2_count(args, {}, None))
    # 5 u16 words 10, states and start words 16, table entries of 2
    # bytes, 12 symbols of a byte; 7 operations a symbol, whatever the
    # alphabet
    assert nbytes == 10 + 16 + cum.numel() * 2 + 12
    assert nops == 12 * 7


@pytest.mark.parametrize("uses_aux", [False, True])
def test_k3_by_hand(uses_aux):
    payload = _rows([1, 2, 3, 4], [5, 6, 7])             # 7 words
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    cum = torch.zeros(3, 5, dtype=torch.int32)          # C = 3, A = 4
    mode = SimpleNamespace(uses_aux=uses_aux)
    lane = torch.zeros(2, dtype=torch.int32)
    # a symbol and a context id written, a byte each; aux a byte
    per = 3 if uses_aux else 2

    def band(t0, t1):
        args = (payload, lane, lane, lane, lengths, cum, None, None, None,
                t0, t1, mode)
        return _totals(work.k3_count(args, {}, None))
    # band [0, 4): active 4 + 2; lane state 2 x 28, table 15 entries of
    # 2 bytes, the 7 words 14
    assert band(0, 4) == (56 + 30 + 14 + 6 * per, 6 * 11)
    # band [4, 8): active 1 + 0; the payload is not counted again
    assert band(4, 8) == (56 + 30 + 1 * per, 1 * 11)
    # a larger alphabet adds table bytes, never operations
    cum = torch.zeros(3, 257, dtype=torch.int32)
    assert band(4, 8)[1] == 11


def test_keywords_and_names():
    freq = torch.ones(2, 2, dtype=torch.int32)
    kw = dict(freq=freq, cum=freq, active=torch.ones(2, 2, dtype=torch.bool))
    out = (None, torch.tensor([1, 1], dtype=torch.int32), None)
    assert _totals(work.k1_count((), kw, out)) == (4 + 16 + 4 + 16, 32)
    assert work.K1.matches("void (anonymous namespace)::rans_encode_kernel"
                           "<2>(int const*, int)")
    assert not work.K1.matches("rans_encode_kernel_v2")
    assert work.K3.matches("(anonymous namespace)::ctx_decode_kernel(int)")


def test_roofline():
    peaks = work.Peaks.of_card(132, 1980.0)
    assert peaks.int32_ops_per_s == pytest.approx(132 * 64 * 1.98e9)
    # one call bound by its bytes, one by its operations
    calls = [(3_350_000, 0), (0, int(peaks.int32_ops_per_s * 1e-6))]
    share, bound = work.roofline(calls, 4e-6, peaks)
    assert share == pytest.approx(50.0)
    assert work.roofline([], 1.0, peaks) is None
    assert work.roofline(calls, 0.0, peaks) is None


def test_traced_run_records_kernel_calls(tiny_root):
    from yardstick import cell as C
    from yardstick import spec
    root, bench = tiny_root
    c = spec.load_cell("tiny-m1-generic-rt", root, bench)
    out = C.run_window(c, 3, 0.0, True, torch.device("cpu"),
                       time.perf_counter())
    kinds = {(out.run.ops[k.op].kind, k.kernel) for k in out.run.calls}
    assert ("compress", "k1") in kinds and ("decompress", "k3") in kinds
    assert all(k.nbytes > 0 and k.nops >= 0 for k in out.run.calls)
    assert {s.kind for s in out.run.spans} == {"compress", "decompress"}
    # the patches are gone once the window has closed
    from dsrc_tpu_torch.ops import ctx
    from dsrc_tpu_torch.ops import ctx_kernels, rans_kernels
    assert ctx.ctx_decode_band is ctx_kernels.ctx_decode_band
    assert ctx.rans_encode_from_freqs is rans_kernels.rans_encode_from_freqs
