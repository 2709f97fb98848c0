"""Kernels K1 (rANS encode), K2 (rANS decode), K3 (context-model band
decode), K4 (A19's order-0 decode) and K5 (histogram) against their plain
PyTorch versions, on an NVIDIA card.  Marked `cuda`: they skip where torch sees no CUDA device.
On the card, chip_smoke.py runs the same checks at the main path's
shapes; run these with

    python -m pytest tests/test_torch_cuda.py -q
"""
import io
import os

import numpy as np
import pytest
import torch

from torch_enc_inputs import M, enc_models, every_freq_models

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("nsym,group", [(64, 8), (128, 8), (256, 64),
                                        (512, 8)])
def test_kernels_equal_plain_versions(cuda, nsym, group):
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    rpad, p, num_rec = 1024, 13, 1000
    rng = np.random.default_rng(nsym)
    mat = np.minimum(rng.geometric(0.1, (rpad, p)) - 1, nsym - 1)
    mat = torch.from_numpy(mat.astype(np.int32)).to(cuda)
    freq, cum, active, table = UP.positional_models(mat, num_rec, nsym, group)
    enc = RK.rans_encode_from_freqs(freq, cum, active)
    plain = RK.rans_encode_plain(freq, cum, active)
    for a, b in zip(enc, plain):
        assert torch.equal(a, b)
    cumrow = cum_from_freqs(table).contiguous()
    for left in (False, True):
        payload = enc[0]
        if left:
            from dsrc_tpu_torch.ops.streams import (deserialize_rans,
                                                    serialize_rans)
            from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
            w = BitWriter()
            serialize_rans(w, 1, *enc)
            payload = torch.from_numpy(
                deserialize_rans(BitReader(w.getvalue()))[1]).to(cuda)
        wptr = UP.start_words(payload, enc[1], left)
        args = (payload, enc[2], wptr, cumrow, num_rec, group)
        dec = RK.rans_decode(*args)
        assert torch.equal(dec, RK.rans_decode_plain(*args))
        assert torch.equal(dec[:num_rec], mat[:num_rec])


def test_random_models_and_corrupt_streams(cuda):
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    freq, cum, active = (t.to(cuda) for t in enc_models(3, 300, 700))
    for a, b in zip(RK.rans_encode_from_freqs(freq, cum, active),
                    RK.rans_encode_plain(freq, cum, active)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(4)
    ll, p, nsym, group = 64, 9, 128, 8
    payload = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (ll, 5)).astype(np.int32)).to(cuda)
    states = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, ll).astype(np.int32)).to(cuda)
    wptr = torch.from_numpy(rng.integers(-20, 20, ll).astype(np.int32)) \
        .to(cuda)
    for table in (np.zeros((p, nsym), np.int32),
                  rng.integers(0, 1 << 14, (p, nsym)).astype(np.int32)):
        cumrow = cum_from_freqs(torch.from_numpy(table).to(cuda))
        args = (payload, states, wptr, cumrow, ll * group, group)
        out = RK.rans_decode(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, RK.rans_decode_plain(*args))


def _encode_equals_plain(dev, freq, cum, active):
    from dsrc_tpu_torch.ops import rans_kernels as RK
    freq, cum, active = (t.to(dev) for t in (freq, cum, active))
    got = RK.rans_encode_from_freqs(freq, cum, active)
    torch.cuda.synchronize()
    ref = RK.rans_encode_plain(freq, cum, active)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("t_steps", [1, 45, 800])
@pytest.mark.parametrize("lanes", [1, 33, 532, 4256])
def test_encode_shapes(cuda, t_steps, lanes):
    """T = 1, T not a multiple of K1's chunk, and the quality stream's T;
    one lane, a partial block, the value planes' and the quality lanes."""
    _, nwords, _ = _encode_equals_plain(
        cuda, *enc_models(t_steps * 7 + lanes, t_steps, lanes, max_freq=M))
    if lanes > 3:
        assert int(nwords[1]) == 0 and int(nwords[2]) == 0


def test_encode_every_freq(cuda):
    """Every freq in [1, 2^14) on an active step (shuffled over 640 steps
    of 33 lanes), with cum up to 2^14 - f."""
    _encode_equals_plain(cuda, *every_freq_models(21))


def _stream(dev, rpad, p, nsym, group, num_rec, seed):
    """A valid K1-encoded positional stream: (symbols, payload, nwords,
    states, cum rows)."""
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    rng = np.random.default_rng(seed)
    mat = np.minimum(rng.geometric(0.1, (rpad, p)) - 1, nsym - 1)
    mat[num_rec:] = 0
    mat = torch.from_numpy(mat.astype(np.int32)).to(dev)
    freq, cum, active, table = UP.positional_models(mat, num_rec, nsym, group)
    payload, nwords, states = RK.rans_encode_from_freqs(freq, cum, active)
    return mat, payload, nwords, states, cum_from_freqs(table).contiguous()


def _left(payload, nwords, states):
    from dsrc_tpu_torch.ops.streams import deserialize_rans, serialize_rans
    from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
    w = BitWriter()
    serialize_rans(w, 1, payload, nwords, states)
    return torch.from_numpy(
        deserialize_rans(BitReader(w.getvalue()))[1]).to(payload.device)


def _decode_equals_plain_and_symbols(dev, rpad, p, nsym, group, num_rec,
                                     seed=0):
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    mat, payload, nwords, states, cumrow = _stream(dev, rpad, p, nsym, group,
                                                   num_rec, seed)
    for left in (False, True):
        pl = _left(payload, nwords, states) if left else payload
        args = (pl, states, UP.start_words(pl, nwords, left), cumrow,
                num_rec, group)
        dec = RK.rans_decode(*args)
        assert torch.equal(dec, RK.rans_decode_plain(*args))
        assert torch.equal(dec[:num_rec], mat[:num_rec])


def test_table_larger_than_the_shared_memory_budget(cuda):
    """P = 2048 rows of 513 ints (4.2 MB): the kernel walks position tiles."""
    from dsrc_tpu_torch.ops import rans_kernels as RK
    assert RK.dec_layout(512, 2048)[2] < 2048
    _decode_equals_plain_and_symbols(cuda, 40, 2048, 512, 1, 37)


@pytest.mark.parametrize("rpad,p,nsym,group,num_rec", [
    (64, 11, 1, 8, 60),                    # one symbol: no search
    (64, 11, 2, 8, 64),
    (33 * 8, 13, 64, 8, 33 * 8),           # 33 lanes: a partial block
    (532 * 8, 7, 256, 8, 532 * 8 - 3),     # the value planes' lane count
    (64 * 20, 9, 128, 64, 64 * 13 + 17),   # num_rec ends inside lane 13
])
def test_decode_shapes(cuda, rpad, p, nsym, group, num_rec):
    _decode_equals_plain_and_symbols(cuda, rpad, p, nsym, group, num_rec,
                                     seed=rpad + nsym)


def test_start_words_odd_negative_and_past_the_row(cuda):
    """Random payloads and states (most steps renormalize, so a lane
    crosses several 64-word windows) from start words around and outside
    the row."""
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    rng = np.random.default_rng(5)
    w = 40                                  # pairs: 80 words a row
    starts = np.array([0, 1, 2, 63, 64, 65, 79, 80, 81, 200, -1, -2, -63,
                       -64, -65, -130, 2**31 - 3, -2**31, 7, 31, 33],
                      np.int64)
    ll, p, nsym, group = starts.size, 9, 64, 40
    payload = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (ll, w)).astype(np.int32)).to(cuda)
    states = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, ll).astype(np.int32)).to(cuda)
    wptr = torch.from_numpy(starts.astype(np.int32)).to(cuda)
    table = rng.integers(1, 600, (p, nsym)).astype(np.int32)
    cumrow = cum_from_freqs(torch.from_numpy(table).to(cuda))
    args = (payload, states, wptr, cumrow, ll * group, group)
    out = RK.rans_decode(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, RK.rans_decode_plain(*args))


def test_main_path_on_the_card_counts_launches(cuda):
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.ops import rans_kernels as RK
    data = open(os.path.join(DATA, "golden_semi.fastq"), "rb").read()
    RK.reset_launch_counts()
    out = io.BytesIO()
    DsrcModule(device=cuda).decompress(os.path.join(DATA, "golden_semi.xfqz"),
                                       out)
    assert out.getvalue() == data
    assert RK.launch_counts()["rans_decode"] == 6


# --------------------------------------------------------------------------
# K3 (context-model band decode), and A19's decode against K2
# --------------------------------------------------------------------------

def _ctx_case(device, mode_kind, lanes, t_steps, nsym, seed, wide=False):
    """A stream of `lanes` lanes of t_steps steps coded by the port's own
    encoder in one of K3's modes: (payload left-aligned, states, lengths,
    num_ctx, CtxMode, aux [L, T] or None, edges, symbols [T, L], active).
    wide: mode 0 at an 8-bit history (256 x 16 at A = 16), mode 2 at the
    -m1 block's sampling budget (4,096 x 64, lags (6, 2), at A = 64)."""
    from dsrc_tpu_torch.models import quality as Q
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops.rans import lane_active
    from dsrc_tpu_torch.ops.streams import deserialize_rans, serialize_rans
    from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(nsym, 0.4))
    syms = torch.from_numpy(rng.choice(nsym, (t_steps, lanes), p=p)
                            .astype(np.int64))
    lengths = torch.from_numpy(rng.integers(0, t_steps + 1, lanes)
                               .astype(np.int32))
    lengths[0] = t_steps
    active = lane_active(t_steps, lengths)
    syms = torch.where(active, syms, 0)
    edges = C.band_edges(t_steps)
    sbits = max(1, (nsym - 1).bit_length())
    aux = None
    if mode_kind == CK.MODE_HISTORY:
        order = max(1, (8 if wide else 12) // sbits)
        mode = CK.CtxMode(CK.MODE_HISTORY, sbits=sbits,
                          cmask=(1 << (order * sbits)) - 1)
        num_ctx = 1 << (order * sbits)
        ctx = C.history_ctx_lanes(syms, order, sbits)
    elif mode_kind == CK.MODE_PRECOMPUTED:
        mode, num_ctx = CK.CtxMode(CK.MODE_PRECOMPUTED), 37
        ctx = torch.from_numpy(rng.integers(0, num_ctx, (t_steps, lanes)))
        ctx = torch.where(active, ctx, 0)
        aux = ctx.T
    else:
        # records that start at lane starts and mid-lane; orders 3 and 6
        # give lags wider than qbits when qbits <= 2
        lens = torch.from_numpy(rng.integers(1, 40, t_steps * lanes)
                                .astype(np.int32))
        num_ctx, mode, reset, bucket = Q.ctxq_model(
            lens, t_steps * lanes, 6 if nsym <= 4 else 2, nsym, lanes,
            1 << (22 if wide else 20))
        ctx = Q.ctxq_contexts(syms, reset, bucket, mode)
        aux = Q.ctxq_aux(reset, bucket)
    payload, nwords, states = C.encode_ctx_lanes(
        syms, active, torch.where(active, ctx, 0), num_ctx, nsym, edges)
    w = BitWriter()
    serialize_rans(w, 1, payload, nwords, states)
    _n, pl, st, _nw = deserialize_rans(BitReader(w.getvalue()))
    to = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return (to(pl), to(st.view(np.int32)), lengths.to(device), num_ctx, mode,
            None if aux is None else aux.to(torch.int32).contiguous()
            .to(device), edges, syms, active)


# the most shared memory a block of the card can ask for
SMEM_BLOCK_MAX = 227 * 1024


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("mode_kind", [0, 1, 2])
@pytest.mark.parametrize("lanes,t_steps,nsym,wide", [
    (1, 1, 4, False), (33, 17, 64, False), (2048, 40, 256, False),
    (33, 300, 4, False), (64, 300, 16, True), (64, 300, 64, True)])
def test_k3_equals_plain_in_each_mode(cuda, mode_kind, lanes, t_steps,
                                      nsym, wide, route):
    """K3 on each route against its plain version band by band (T = 1 and
    17; bands 0-16, 16-32, 32-40 across edges; L = 1, 33, 64, 2048; A = 4,
    16, 64, 256; lanes of length 0; mode 2 at 4,096 x 64 and with lags
    wider than qbits at A = 4; mode 0 at 256 x 16), and the whole decode
    against the encoded symbols.  A route whose shared memory the card
    cannot grant raises."""
    from dsrc_tpu_torch.config import DsrcException
    from dsrc_tpu_torch.ops import ctx as C
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs, quantize_counts
    pl, st, lengths, num_ctx, mode, aux, edges, syms, active = _ctx_case(
        cuda, mode_kind, lanes, t_steps, nsym, 40 + mode_kind, wide)
    x, w = st.clone(), torch.zeros(lanes, dtype=torch.int32, device=cuda)
    c = torch.zeros_like(w)
    osym = torch.zeros((lanes, t_steps), dtype=torch.int32, device=cuda)
    octx = torch.zeros_like(osym)
    steps = torch.arange(t_steps, device=cuda)
    hist = torch.zeros(num_ctx * nsym, dtype=torch.int64, device=cuda)
    for t0, t1 in zip(edges[:-1], edges[1:]):
        cum = cum_from_freqs(quantize_counts(hist.view(num_ctx, nsym))) \
            .contiguous()
        ref = [v.clone() for v in (x, w, c, osym, octx)]
        CK.ctx_decode_band_plain(pl, *ref[:3], lengths, cum, aux, *ref[3:],
                                 t0, t1, mode)
        if CK.route_smem_bytes(route, num_ctx, nsym) > SMEM_BLOCK_MAX:
            with pytest.raises(DsrcException, match="launch failed"):
                CK.ctx_decode_band(pl, x, w, c, lengths, cum, aux, osym,
                                   octx, t0, t1, mode, route)
            return
        CK.ctx_decode_band(pl, x, w, c, lengths, cum, aux, osym, octx, t0,
                           t1, mode, route)
        torch.cuda.synchronize()
        for got, want in zip((x, w, c, osym, octx), ref):
            assert torch.equal(got, want)
        act = steps[None, t0:t1] < lengths[:, None]
        hist += C.hist_update(octx[:, t0:t1].to(torch.int64) * nsym
                              + osym[:, t0:t1], act, num_ctx * nsym)
    assert torch.equal(torch.where(active.to(cuda), osym.T, 0),
                       syms.to(torch.int32).to(cuda))


@pytest.mark.parametrize("route", ["shared", "global"])
def test_k3_word_pointer_at_the_payload_end(cuda, route):
    """A lane whose word pointer starts at and past the payload's end (words
    there read 0), with random states and tables: K3 equals its plain
    version, and reads nothing outside its buffers."""
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    rng = np.random.default_rng(5)
    lanes, w, t_steps, nsym, nctx = 40, 3, 64, 64, 9
    pl = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (lanes, w))
                          .astype(np.int32)).to(cuda)
    x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, lanes)
                         .astype(np.int32)).to(cuda)
    wptr = torch.from_numpy(np.array([2 * w, 2 * w - 1, 2 * w + 5, 0] * 10,
                                     np.int32)).to(cuda)
    table = rng.integers(1, 400, (nctx, nsym)).astype(np.int64)
    table = (table * (1 << 14) // table.sum(1, keepdims=True)).astype(np.int32)
    cum = cum_from_freqs(torch.from_numpy(table)).to(cuda).contiguous()
    lengths = torch.full((lanes,), t_steps, dtype=torch.int32, device=cuda)
    aux = torch.from_numpy(rng.integers(-3, nctx + 3, (lanes, t_steps))
                           .astype(np.int32)).to(cuda)
    mode = CK.CtxMode(CK.MODE_PRECOMPUTED)
    osym = torch.zeros((lanes, t_steps), dtype=torch.int32, device=cuda)
    args = [x, wptr, torch.zeros_like(x), lengths, cum, aux, osym,
            torch.zeros_like(osym)]
    ref = [a.clone() for a in args]
    CK.ctx_decode_band(pl, *args, 0, t_steps, mode, route)
    CK.ctx_decode_band_plain(pl, *ref, 0, t_steps, mode)
    torch.cuda.synchronize()
    for got, want in zip(args, ref):
        assert torch.equal(got, want)


def test_a19_through_k2_on_19_symbols(cuda):
    """A19's decode through K4 equals K2 at P = 1 (the route that served
    it before K4) and the encoded symbols, on K1's right-aligned payload."""
    from dsrc_tpu_torch.models import dna as DNA
    from dsrc_tpu_torch.ops import a19_kernels as AK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    rng = np.random.default_rng(19)
    cap, lanes = 1 << 16, 16
    n = cap - 777
    syms = np.zeros(cap, np.int32)
    syms[:n] = rng.choice(19, n, p=rng.dirichlet(np.full(19, 0.6)))
    syms = torch.from_numpy(syms).to(cuda)
    payload, nwords, states, freqs = DNA._a19_encode(syms, n, 19, lanes, cap)
    # K1's payload is right-aligned: lane j starts at word 2*Wp - nwords[j]
    wptr = (2 * payload.shape[1] - nwords).to(torch.int32)
    args = (payload, states, wptr,
            cum_from_freqs(freqs)[None, :].contiguous(), n, cap // lanes)
    k2 = RK.rans_decode(*args)
    got = AK.a19_decode(payload, states, wptr, freqs, n, cap // lanes)
    torch.cuda.synchronize()
    assert torch.equal(k2, RK.rans_decode_plain(*args))
    assert torch.equal(got.to(torch.int32), k2.reshape(-1))
    assert torch.equal(got[:n].to(torch.int32), syms[:n])


# --------------------------------------------------------------------------
# K4 (A19's order-0 decode)
# --------------------------------------------------------------------------

def _k4_fields(name):
    """Tables of 19 fields in [0, 2^14): quantized like the encoder's, and
    the edges an archive's fields can carry."""
    rng = np.random.default_rng(len(name))
    if name == "quantized":
        from dsrc_tpu_torch.ops.rans import quantize_counts
        return quantize_counts(torch.from_numpy(
            rng.integers(0, 5000, 19))).tolist()
    return {"zero_fields": [4000, 0, 0, 8000] + [0] * 14 + [4384],
            "sum_below": [100] * 19, "sum_above": [(1 << 14) - 1] * 19,
            "all_zero": [0] * 19, "last_only": [0] * 18 + [77]}[name]


@pytest.mark.parametrize("name", ["quantized", "zero_fields", "sum_below",
                                  "sum_above", "all_zero", "last_only"])
@pytest.mark.parametrize("lanes,w,t,lanes_per_block", [
    (13, 40, 150, 32),        # T not a multiple of 16: a byte a step
    (40, 64, 160, 32),        # 16-byte stores, two blocks
    (33, 7, 33, 16),          # lanes past a block, a short row
    (300, 130, 2048, 128)])   # rows read past several ring refills
def test_k4_equals_plain(cuda, monkeypatch, name, lanes, w, t,
                         lanes_per_block):
    """Random payloads and states (most steps take a word) from start
    words inside, around and outside the rows; the last lanes idle."""
    from dsrc_tpu_torch.ops import a19_kernels as AK
    monkeypatch.setattr(AK, "LANES_PER_BLOCK", lanes_per_block)
    freqs = _k4_fields(name)
    rng = np.random.default_rng(lanes * t)
    payload = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (lanes, w)).astype(np.int32))
    states = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, lanes).astype(np.int32))
    wptr = torch.from_numpy(rng.integers(-9, 2 * w + 9, lanes)
                            .astype(np.int32))
    n = lanes * t - t // 2 - 3 * t
    args = [v.to(cuda) for v in (payload, states, wptr)]
    before = AK.LAUNCHES["a19_decode"].count
    got = AK.a19_decode(*args, freqs, n, t)
    torch.cuda.synchronize()
    assert AK.LAUNCHES["a19_decode"].count == before + 1
    want = AK.a19_decode_plain(payload, states, wptr, freqs, n, t)
    assert got.dtype == torch.uint8
    assert torch.equal(got.cpu(), want)


def test_k4_equals_k2_at_the_m1_block_shape(cuda):
    """T = 16,384 (the DNA stream of a 64 MB -m1 block), 2,048 lanes: K4
    equals K2 at P = 1 and the encoded symbols."""
    import chip_smoke as CS
    from dsrc_tpu_torch.ops import a19_kernels as AK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    st = CS.a19_stream(cuda, 25_000_000)
    assert st["t"] == 16384 and st["lanes"] == 2048
    got = AK.a19_decode(st["payload"], st["states"], st["wptr"],
                        st["fields"], st["n"], st["t"])
    k2 = RK.rans_decode(st["payload"], st["states"], st["wptr"],
                        cum_from_freqs(st["freqs"])[None, :].contiguous(),
                        st["n"], st["t"])
    assert torch.equal(got.to(torch.int32), k2.reshape(-1))
    assert torch.equal(got[:st["n"]].to(torch.int32), st["syms"][:st["n"]])


def test_k4_stays_bounded_on_a_corrupt_payload(cuda):
    """A valid stream with its payload and states overwritten at random:
    no fault, every symbol in [0, 19), equal to the plain version."""
    import chip_smoke as CS
    from dsrc_tpu_torch.ops import a19_kernels as AK
    st = CS.a19_stream(cuda, 400_000)
    rng = np.random.default_rng(13)
    pl = st["payload"].clone()
    flat = pl.view(-1)
    hit = torch.from_numpy(rng.integers(0, flat.numel(), flat.numel() // 50))
    flat[hit.to(cuda)] = torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, hit.numel()).astype(np.int32)).to(cuda)
    states = st["states"].clone()
    states[::3] = torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, states[::3].numel()).astype(np.int32)).to(cuda)
    args = (pl, states, st["wptr"], st["fields"], st["n"], st["t"])
    got = AK.a19_decode(*args)
    torch.cuda.synchronize()
    assert int(got.max()) < 19
    assert torch.equal(got, AK.a19_decode_plain(*args))


def test_m1_block_with_iupac_codes_launches_k4(cuda):
    """An -m1 block whose DNA holds IUPAC codes takes scheme A19 and
    decodes through K4, one launch a block, byte-exactly, with the port's
    CPU archive."""
    import chip_smoke as CS
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.utils.synth import make_fastq_realistic
    data = CS.with_iupac(make_fastq_realistic(3000, 100, seed=86), 86)
    params = InputParameters(dna_compression_level=2,
                             quality_compression_level=2,
                             fastq_block_size_bytes=1 << 20)
    RK.reset_launch_counts()
    arch, out = io.BytesIO(), io.BytesIO()
    info = DsrcModule(params, device=cuda).compress(io.BytesIO(data), arch)
    arch.seek(0)
    DsrcModule(params, device=cuda).decompress(arch, out)
    assert out.getvalue() == data
    a19_blocks = sum(d == "A19" for d, _ in info.schemes)
    assert a19_blocks >= 1
    assert RK.launch_counts()["a19_decode"] == a19_blocks
    cpu_arch = io.BytesIO()
    DsrcModule(params, device="cpu").compress(io.BytesIO(data), cpu_arch)
    assert cpu_arch.getvalue() == arch.getvalue()


def test_one_m1_block_round_trip(cuda):
    """One -m1 (-d2 -q2) block on the card: byte-exact, through K1 and
    K3, and the same archive as the port writes on the CPU."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.utils.synth import make_fastq_realistic
    data = make_fastq_realistic(3000, 100, seed=91)
    params = InputParameters(dna_compression_level=2,
                             quality_compression_level=2,
                             fastq_block_size_bytes=1 << 20)
    RK.reset_launch_counts()
    arch, out = io.BytesIO(), io.BytesIO()
    DsrcModule(params, device=cuda).compress(io.BytesIO(data), arch)
    arch.seek(0)
    DsrcModule(params, device=cuda).decompress(arch, out)
    assert out.getvalue() == data
    counts = RK.launch_counts()
    assert counts["rans_encode"] > 0 and counts["ctx_decode"] > 0
    cpu_arch = io.BytesIO()
    DsrcModule(params, device="cpu").compress(io.BytesIO(data), cpu_arch)
    assert cpu_arch.getvalue() == arch.getvalue()


def _card_equals_cpu(cuda, data, params, kernels):
    """data round-trips on the card through `kernels`, and the card's
    archive equals the port's archive on the CPU."""
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.ops import rans_kernels as RK
    RK.reset_launch_counts()
    arch, out = io.BytesIO(), io.BytesIO()
    DsrcModule(params, device=cuda).compress(io.BytesIO(data), arch)
    arch.seek(0)
    DsrcModule(params, device=cuda).decompress(arch, out)
    assert out.getvalue() == data
    counts = RK.launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts
    cpu_arch = io.BytesIO()
    DsrcModule(params, device="cpu").compress(io.BytesIO(data), cpu_arch)
    assert cpu_arch.getvalue() == arch.getvalue()
    return arch.getvalue()


def test_one_mode0_semi_block_card_equals_cpu(cuda):
    """A SEMI block whose titles carry a free-text field (title mode 0):
    quality through K1/K2, titles through the tag coder (K1, K3)."""
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.io.archive import ArchiveReader
    data = "".join(f"@x{'ab'[i % 2]}q.{i} z{i % 3}w UMI_{i * 7 % 997}x\n"
                   f"ACGTACGTACNNACGTACGT\n+\nIIIIHHHHGG5555IIIIII\n"
                   for i in range(3000)).encode()
    arch = _card_equals_cpu(
        cuda, data, InputParameters(fastq_block_size_bytes=1 << 20),
        ("rans_encode", "rans_decode", "ctx_decode"))
    assert ArchiveReader(io.BytesIO(arch)).read_block(0)[0] == 2  # SEMI


def test_one_64mb_block_at_m2_settings_card_equals_cpu(cuda):
    """One 62 MB block at the -m2 settings (-d3 -q2, a 64 MB block size):
    byte-exact on the card through K1 and K3, and the port's CPU
    archive.  chip_smoke.py's `m2` phase runs the 256 MB blocks."""
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.io.archive import ArchiveReader
    from dsrc_tpu_torch.utils.synth import make_fastq_realistic
    data = make_fastq_realistic(250_000, 100, seed=98)
    params = InputParameters.preset(2)
    params.fastq_block_size_bytes = 64 << 20
    assert (60 << 20) < len(data) < (64 << 20)
    arch = _card_equals_cpu(cuda, data, params,
                            ("rans_encode", "ctx_decode"))
    assert ArchiveReader(io.BytesIO(arch)).num_blocks == 1


def test_one_colour_space_block_card_equals_cpu(cuda):
    """SOLiD reads ('.' present) at -d2 -q2: K1 and K3 on the colour
    stream."""
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.utils.synth import make_fastq
    data = make_fastq(3000, 50, color_space=True, n_base_prob=0.01, seed=96)
    _card_equals_cpu(cuda, data, InputParameters(
        dna_compression_level=2, quality_compression_level=2,
        fastq_block_size_bytes=1 << 20), ("rans_encode", "ctx_decode"))


# --------------------------------------------------------------------------
# The mesh and launches on more than one card
# --------------------------------------------------------------------------

def test_mesh_on_one_card_twice_equals_one_device(cuda, monkeypatch):
    """The mesh over [cuda:0, cuda:0]: dryrun, and a SEMI file through
    DsrcModule with api.local_device_mesh giving that list, in batches of
    two blocks, each on its own host thread: the one-device archive,
    decoded byte-exactly, through K1 and K2."""
    from dsrc_tpu_torch import api as TAPI
    from dsrc_tpu_torch.api import DsrcModule
    from dsrc_tpu_torch.config import InputParameters
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.parallel import mesh as TM
    from dsrc_tpu_torch.utils.synth import make_fastq_fast
    devices = [cuda, cuda]
    TM.dryrun(devices)
    data = make_fastq_fast(16000, 60, seed=5, fixed_width=False)
    mod = DsrcModule(InputParameters(fastq_block_size_bytes=1 << 18),
                     device=cuda)
    one = io.BytesIO()
    mod.compress(io.BytesIO(data), one)
    batches = []
    real = TM.MeshSemiCodec.compress_blocks
    monkeypatch.setattr(TM.MeshSemiCodec, "compress_blocks",
                        lambda self, *a: batches.append(1) or real(self, *a))
    monkeypatch.setattr(TAPI, "local_device_mesh", lambda device: devices)
    RK.reset_launch_counts()
    arch, out = io.BytesIO(), io.BytesIO()
    mod.compress(io.BytesIO(data), arch)
    assert arch.getvalue() == one.getvalue()
    assert batches
    arch.seek(0)
    mod.decompress(arch, out)
    assert out.getvalue() == data
    counts = RK.launch_counts()
    assert counts["rans_encode"] > 0 and counts["rans_decode"] > 0
    assert torch.cuda.current_device() == 0


def test_launches_on_a_second_card_keep_the_thread_device():
    """K1, K2, K3 and K4 launched on cuda:1 from a worker thread whose
    current device is cuda:0 equal their plain versions, and the thread's
    current device is still cuda:0 afterwards."""
    import threading
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from dsrc_tpu_torch.ops import ctx_kernels as CK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    from dsrc_tpu_torch.parallel import uniform_pipeline as UP
    card1 = torch.device("cuda", 1)
    result = {}

    def work():
        torch.cuda.set_device(0)
        rng = np.random.default_rng(7)
        mat = torch.from_numpy(np.minimum(rng.geometric(0.1, (1024, 13)) - 1,
                                          63).astype(np.int32))
        freq, cum, active, table = UP.positional_models(mat, 1000, 64, 8)
        enc = RK.rans_encode_from_freqs(freq.to(card1), cum.to(card1),
                                        active.to(card1))
        plain = RK.rans_encode_plain(freq, cum, active)
        result["k1"] = all(torch.equal(a.cpu(), b)
                           for a, b in zip(enc, plain))
        after_k1 = torch.cuda.current_device()
        wptr = UP.start_words(enc[0], enc[1], False)
        cumrow = cum_from_freqs(table).contiguous()
        args = (enc[0], enc[2], wptr, cumrow.to(card1), 1000, 8)
        dec = RK.rans_decode(*args)
        result["k2"] = torch.equal(dec.cpu(), RK.rans_decode_plain(
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))
        after_k2 = torch.cuda.current_device()
        pl, st, lengths, num_ctx, mode, aux, edges, _, _ = _ctx_case(
            card1, 0, 33, 40, 16, 8)
        cum3 = cum_from_freqs(torch.from_numpy(rng.integers(
            1, 50, (num_ctx, 16)).astype(np.int32))).to(card1).contiguous()
        state = [st.clone(), torch.zeros(33, dtype=torch.int32, device=card1),
                 torch.zeros(33, dtype=torch.int32, device=card1),
                 torch.zeros((33, 40), dtype=torch.int32, device=card1),
                 torch.zeros((33, 40), dtype=torch.int32, device=card1)]
        ref = [v.cpu() for v in state]
        CK.ctx_decode_band(pl, *state[:3], lengths, cum3, aux, *state[3:],
                           0, edges[1], mode)
        CK.ctx_decode_band_plain(pl.cpu(), *ref[:3], lengths.cpu(),
                                 cum3.cpu(), aux, *ref[3:], 0, edges[1],
                                 mode)
        result["k3"] = all(torch.equal(a.cpu(), b)
                           for a, b in zip(state, ref))
        after_k3 = torch.cuda.current_device()
        from dsrc_tpu_torch.ops import a19_kernels as AK
        k4_args = (enc[0], enc[2], wptr, [862] * 19, 1000, 8)
        result["k4"] = torch.equal(AK.a19_decode(*k4_args).cpu(),
                                   AK.a19_decode_plain(*(
                                       a.cpu() if isinstance(a, torch.Tensor)
                                       else a for a in k4_args)))
        result["devices"] = (after_k1, after_k2, after_k3,
                             torch.cuda.current_device())

    def run():
        try:
            work()
        except BaseException as e:     # noqa: BLE001 — raised below
            result["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in result:
        raise result["error"]
    assert result["k1"] and result["k2"] and result["k3"] and result["k4"]
    assert result["devices"] == (0, 0, 0, 0)


# --------------------------------------------------------------------------
# K5 (histogram)
# --------------------------------------------------------------------------

@pytest.fixture
def k5_route(monkeypatch):
    """Sets the route of every K5 launch (None: hist_route's choice)."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    return lambda route: monkeypatch.setattr(HK, "_ROUTE", route)


def _k5_flat(dev, ids, mask, nbins, cut=(0, 0), counted=True):
    """K5's flat form against its plain version on the same card tensors,
    both added into one histogram that starts non-zero; cut: the ids and
    the mask start that many elements past their aligned bases (the
    arrays hold one more element, and the call takes as many ids);
    counted: the launch adds one to LAUNCHES["hist"] (k5_variants.py's
    launches add none)."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
    mask = None if mask is None else torch.from_numpy(mask).to(dev)
    if cut != (0, 0):
        n = ids.numel() - 1
        ids = ids[cut[0]:cut[0] + n]
        mask = None if mask is None else mask[cut[1]:cut[1] + n]
    start = torch.arange(nbins + 1, dtype=torch.int64, device=dev) % 7
    got, want = start.clone(), start.clone()
    before = RK.launch_counts()["hist"]
    HK.hist_count(got, ids, mask)
    torch.cuda.synchronize()
    HK.hist_count_plain(want, ids, mask)
    assert torch.equal(got[:-1], want[:-1])
    assert got[-1] == start[-1]              # the kernel leaves scratch be
    assert RK.launch_counts()["hist"] == before + (counted
                                                   and ids.numel() > 0)


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.int64])
def test_k5_flat_every_value_type(cuda, k5_route, route, dtype):
    """Masked and not, from an aligned base and from one element past it
    (the mask's address agreeing: vector reads after a scalar head;
    disagreeing: element by element); on the global route also at a
    width too wide for the shared one."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    n = 1_000_003
    k5_route(route)
    for nbins in (200, 8_500) + ((100_000,) if route == "global" else ()):
        lo, hi = (0, 256) if dtype == np.uint8 else (-40, nbins + 500)
        ids = rng.integers(lo, hi, n + 1).astype(dtype)
        keep = rng.random(n + 1) < 0.75
        _k5_flat(cuda, ids[:n], keep[:n], nbins)
        _k5_flat(cuda, ids[:n], None, nbins)
        for cut in ((1, 1), (1, 0), (0, 1)):
            _k5_flat(cuda, ids, keep, nbins, cut)


@pytest.mark.parametrize("extra", [0, 1])
def test_k5_route_boundary(cuda, extra):
    """HIST_SMEM_BUDGET / 4 bins take the shared route, one more the
    global one; the default route at each."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    nbins = HK.HIST_SMEM_BUDGET // 4 + extra
    assert HK.hist_route(nbins) == ("shared", "global")[extra]
    rng = np.random.default_rng(extra)
    ids = np.minimum(rng.geometric(2e-5, 1 << 22) - 1, nbins + 3)
    assert HK.hist_route(nbins, ids.size) == HK.hist_route(nbins)
    _k5_flat(cuda, ids.astype(np.int32), rng.random(ids.size) < 0.9, nbins)


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("n", [0, 1, 15, 17, 31, 33])
def test_k5_few_elements(cuda, k5_route, route, n):
    rng = np.random.default_rng(n)
    k5_route(route)
    _k5_flat(cuda, rng.integers(0, 300, n).astype(np.int32),
             rng.random(n) < 0.5, 300)
    _k5_flat(cuda, rng.integers(0, 32, n).astype(np.uint8), None, 32)


@pytest.mark.parametrize("route", ["shared", "global"])
def test_k5_one_bin_takes_every_element(cuda, k5_route, route):
    """Every element in one bin (the first, a middle one, the last), and
    a mask that drops every element."""
    k5_route(route)
    _k5_flat(cuda, np.zeros(3_000_000, np.uint8), None, 5)
    for nbins in (32, 256, 4096) + ((1 << 18,) if route == "global"
                                    else ()):
        for b in (nbins // 3, nbins - 1):
            _k5_flat(cuda, np.full(3_000_000, b, np.int32), None, nbins)
        _k5_flat(cuda, np.full(2_000_001, nbins - 1, np.uint8 if nbins <= 256
                               else np.int32), np.zeros(2_000_001, bool),
                 nbins)


def test_k5_order7_dna_bins(cuda):
    """2^24 bins, CTX8 at order 7 (models/dna.py): the global route."""
    rng = np.random.default_rng(24)
    ids = np.minimum(rng.geometric(1e-6, 1 << 22) - 1, (1 << 24) + 9)
    _k5_flat(cuda, ids.astype(np.int32), rng.random(ids.size) < 0.9,
             1 << 24)


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("p,nsym,dtype", [(100, 64, np.uint8),
                                          (37, 64, np.int32),
                                          (1, 19, np.int16),
                                          (13, 19, np.int64),
                                          (4, 64, np.uint8)])
def test_k5_positional(cuda, k5_route, route, p, nsym, dtype):
    """P that does not divide the grid's stride (37, 13), P = 1, an
    alphabet that is no multiple of 8, a view with a row stride past P."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    rng = np.random.default_rng(p)
    wide = np.minimum(rng.geometric(0.1, (33_537, p + 3)) - 1,
                      nsym - 1).astype(dtype)
    mat = torch.from_numpy(wide).to(cuda)[:, :p]
    k5_route(route)
    for num_rec in (0, 1, 33_411, 33_537):
        got = HK.pos_hist(mat, num_rec, nsym)
        torch.cuda.synchronize()
        assert torch.equal(got, HK.pos_hist_plain(mat, num_rec, nsym))
    # a mat of another column stride: K5 counts a copy of its rows
    cols = mat.T.contiguous().T
    got = HK.pos_hist(cols, 33_411, nsym)
    torch.cuda.synchronize()
    assert torch.equal(got, HK.pos_hist_plain(mat, 33_411, nsym))


@pytest.mark.parametrize("t_steps", [700, 301])
@pytest.mark.parametrize("num_ctx,nsym,route", [
    (64, 64, "shared"), (64, 64, "global"), (4096, 64, "global"),
    (256, 256, "global"), (40, 19, "shared"), (3059, 19, "global")])
def test_k5_context_form(cuda, k5_route, num_ctx, nsym, route, t_steps):
    """The decode's band form: contexts clamped, symbols outside [0, A)
    and steps past a lane's length dropped, at an odd first column and
    band by band (with T = 700 the shared route reads the bands 4 steps
    at a time; with T = 301 it cannot)."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    from dsrc_tpu_torch.ops.ctx import band_edges
    nbins = num_ctx * nsym
    rng = np.random.default_rng(num_ctx + nsym)
    lanes = 2048
    octx = torch.from_numpy(np.minimum(rng.geometric(
        0.01, (lanes, t_steps)) - 3, num_ctx + 2).astype(np.int32)).to(cuda)
    osym = torch.from_numpy(np.minimum(rng.geometric(
        0.2, (lanes, t_steps)) - 2, nsym).astype(np.int32)).to(cuda)
    lens = torch.from_numpy(rng.integers(0, t_steps + 1, lanes)
                            .astype(np.int32)).to(cuda)
    got = torch.zeros(nbins + 1, dtype=torch.int64, device=cuda)
    want = got.clone()
    edges = band_edges(t_steps)
    k5_route(route)
    for t0, t1 in [(37, 294)] + list(zip(edges[:-1], edges[1:])):
        HK.hist_count_ctx(got, octx, osym, nsym, lens, t0, t1)
        HK.hist_count_ctx_plain(want, octx, osym, nsym, lens, t0, t1)
        torch.cuda.synchronize()
        assert torch.equal(got[:-1], want[:-1]), (t0, t1)


@pytest.mark.parametrize("nbins", [58_113, 131_072, 262_144])
@pytest.mark.parametrize("per_bin", [0.125, 16])
def test_k5_quality_context_widths(cuda, k5_route, nbins, per_bin):
    """The quality contexts' widths, sparse and dense, skewed ids (some
    out of range), on the global route and on hist_route's choice."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    assert HK.hist_route(nbins, int(per_bin * nbins)) == "global"
    rng = np.random.default_rng(nbins + int(per_bin * 8))
    n = int(per_bin * nbins)
    ids = np.minimum(rng.geometric(16 / nbins, n) - 1, nbins + 3)
    keep = rng.random(n) < 0.9
    for route in ("global", None):
        k5_route(route)
        _k5_flat(cuda, ids.astype(np.int32), keep, nbins)


@pytest.mark.parametrize("variant", ["narrow", "cluster"])
def test_k5_variants_equal_plain(cuda, k5_route, variant):
    """k5_variants.py's alternatives, built from hist.cu, count what the
    plain version counts: flat at an aligned base and one past it, few
    elements, one bin, a context band at an odd first column and by
    quads, positional rows; the cluster at the quality contexts'
    2^18 bins.  A width the variant cannot hold raises before any
    launch."""
    import k5_variants as KV
    from dsrc_tpu_torch.ops import hist_kernels as HK
    out = os.path.join(KV.ROOT, "build", "k5_variants")
    proc = KV.build(out)
    log = proc.communicate()[0].decode(errors="replace")
    assert proc.returncode == 0, log
    monkey = pytest.MonkeyPatch()
    monkey.setattr(HK, "_launch", KV.variant_launch(
        os.path.join(out, "libk5_variants.so"), HK._launch))
    try:
        k5_route(variant)
        rng = np.random.default_rng(len(variant))
        widths = (32, 256) + ((1 << 18,) if variant == "cluster" else ())
        for nbins in widths:
            ids = rng.integers(-3, nbins + 3, 1_000_018).astype(np.int32)
            keep = rng.random(1_000_018) < 0.8
            _k5_flat(cuda, ids[:-1], keep[:-1], nbins, counted=False)
            _k5_flat(cuda, ids, keep, nbins, (1, 1), counted=False)
            _k5_flat(cuda, ids[:17], None, nbins, counted=False)
            _k5_flat(cuda, np.full(2_000_000, nbins - 1, np.int32), None,
                     nbins, counted=False)
        num_ctx, nsym = (4096, 64) if variant == "cluster" else (4, 8)
        octx = torch.from_numpy(rng.integers(-2, num_ctx + 2, (2048, 304))
                                .astype(np.int32)).to(cuda)
        osym = torch.from_numpy(rng.integers(-1, nsym + 1, (2048, 304))
                                .astype(np.int32)).to(cuda)
        lens = torch.from_numpy(rng.integers(0, 305, 2048)
                                .astype(np.int32)).to(cuda)
        for t0, t1 in ((37, 294), (64, 128)):
            got = torch.zeros(num_ctx * nsym + 1, dtype=torch.int64,
                              device=cuda)
            want = got.clone()
            HK.hist_count_ctx(got, octx, osym, nsym, lens, t0, t1)
            HK.hist_count_ctx_plain(want, octx, osym, nsym, lens, t0, t1)
            torch.cuda.synchronize()
            assert torch.equal(got[:-1], want[:-1]), (t0, t1)
        mat = torch.from_numpy(rng.integers(0, 19, (33_537, 40))
                               .astype(np.int16)).to(cuda)[:, :37]
        assert torch.equal(HK.pos_hist(mat, 33_411, 19),
                           HK.pos_hist_plain(mat, 33_411, 19))
        wide = 1 + (KV.CLUSTER_MAX << 15 if variant == "cluster"
                    else HK.HIST_SMEM_BUDGET // 4 // KV.NARROW_COPIES)
        with pytest.raises(ValueError):
            HK.hist_count(torch.zeros(wide + 1, dtype=torch.int64,
                                      device=cuda),
                          torch.zeros(100, dtype=torch.int32, device=cuda))
    finally:
        monkey.undo()


def test_k5_forced_route_that_cannot_hold_raises(cuda, k5_route):
    """A route forced past what it holds, or one K5 does not have (the
    names of k5_variants.py's alternatives), raises before any launch."""
    from dsrc_tpu_torch.config import DsrcException
    from dsrc_tpu_torch.ops import hist_kernels as HK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    ids = torch.zeros(1000, dtype=torch.int32, device=cuda)
    before = RK.launch_counts()["hist"]
    for route, nbins in (("narrow", 100), ("shared", 60_000),
                         ("cluster", 100)):
        k5_route(route)
        hist = torch.zeros(nbins + 1, dtype=torch.int64, device=cuda)
        with pytest.raises(DsrcException):
            HK.hist_count(hist, ids)
    assert RK.launch_counts()["hist"] == before


def test_k5_launches_from_many_threads(cuda):
    """The C entry point keeps what it asks of the card (SM count,
    occupancy a kernel and shared-memory size) under a lock: 12 threads
    launching at once on widths no launch has used yet, each on its own
    stream, count what the plain version counts, and every launch is
    counted once."""
    import sys
    import threading
    from dsrc_tpu_torch.ops import hist_kernels as HK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    rng = np.random.default_rng(12)
    widths = [3_000 + 37 * k for k in range(12)]   # shared, 20 a bin
    ids = [torch.from_numpy(rng.integers(-5, w + 5, 20 * w).astype(np.int32))
           .to(cuda) for w in widths]
    got = [torch.zeros(w + 1, dtype=torch.int64, device=cuda)
           for w in widths]
    errors, before = [], RK.launch_counts()["hist"]

    def work(k):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for _ in range(25):
                    HK.hist_count(got[k], ids[k])
                torch.cuda.current_stream(cuda).synchronize()
        except BaseException as e:     # noqa: BLE001 — raised below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(len(widths))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert RK.launch_counts()["hist"] == before + 25 * len(widths)
    for k, w in enumerate(widths):
        want = torch.zeros(w + 1, dtype=torch.int64, device=cuda)
        HK.hist_count_plain(want, ids[k])
        assert torch.equal(got[k][:-1], 25 * want[:-1]), w
