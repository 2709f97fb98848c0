"""Parity of the port's context-model codec (dsrc_tpu_torch/ops/ctx.py, K3's
plain version, the bulk quality history, A19 through K2) with dsrc_tpu.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port on the CPU, where the kernel wrappers run their
plain PyTorch versions.  Every comparison is exact equality.  Shapes are
small and shared between cases so that JAX compiles few executables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrc_tpu.models import dna as JDNA
from dsrc_tpu.models import quality as JQ
from dsrc_tpu.ops import ctx as JC
from dsrc_tpu_torch import convert
from dsrc_tpu_torch.models import dna as TDNA
from dsrc_tpu_torch.models import quality as TQ
from dsrc_tpu_torch.ops import ctx as TC
from dsrc_tpu_torch.ops import ctx_kernels as CK
from dsrc_tpu_torch.ops import rans_kernels as RK
from torch_threads import one_torch_thread  # noqa: F401


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


def u32(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64).astype(np.uint32)


# --------------------------------------------------------------------------
# geometry: pure functions of the transmitted n, equal to the bit
# --------------------------------------------------------------------------

def test_geometry_equals_jax():
    ns = [0, 1, 2, 17, 511, 512, 4095, 4096, 4097, 65535, 65536, 65537,
          (1 << 20) + 3, 25_800_000, 12_900_000, 1 << 27]
    caps = [4096, 147456, 1 << 24, 67_125_248, 268_451_840]
    for n in ns:
        for cap in caps:
            assert TC.stream_cap(cap, n) == JC.stream_cap(cap, n)
        for tpl in (512, 2048):
            assert TC.pick_num_lanes(n, tpl) == JC.pick_num_lanes(n, tpl)
        for order in range(10):
            assert TDNA._order4_eff(order, n) == JDNA._order4_eff(order, n)
            assert TDNA._order8_eff(order, n) == JDNA._order8_eff(order, n)
            assert TDNA._order4p_eff(order, n) == JDNA._order4p_eff(order, n)
            assert TDNA._order8p_eff(order, n) == JDNA._order8p_eff(order, n)
            for qbits in range(1, 9):
                assert TQ._coarse_bits(order, qbits, n) == \
                    JQ._coarse_bits(order, qbits, n)
        for a_pad in JQ.A_BUCKETS:
            assert TQ._pos_params(a_pad, n) == JQ._pos_params(a_pad, n)
    for t in [1, 15, 16, 17, 40, 512, 8192, 16384, 1 << 20]:
        assert TC.band_edges(t) == JC.band_edges(t)


def test_coarse_bits_lags_wider_than_qbits():
    """The CTX lags at qbits 1 and 2: wider than qbits only at the lossy
    orders 3 and 6 (a negative shift in the reference, 0 by its rule)."""
    big = 1 << 25
    assert TQ._coarse_bits(1, 2, big) == (2,)
    assert TQ._coarse_bits(2, 2, big) == (2, 2)
    assert TQ._coarse_bits(3, 2, big) == (2, 3, 1)
    assert TQ._coarse_bits(6, 2, big) == (2, 3, 2, 2)
    assert TQ._coarse_bits(3, 1, big) == (1, 2)
    assert TQ._coarse_bits(6, 1, big) == (1, 3, 2)


# --------------------------------------------------------------------------
# contexts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("order,sym_bits", [(1, 8), (3, 2), (5, 3), (2, 4),
                                            (2, 6), (0, 2)])
def test_history_ctx_lanes(order, sym_bits):
    rng = np.random.default_rng(order * 10 + sym_bits)
    lanes = rng.integers(0, 1 << sym_bits, (37, 9)).astype(np.int32)
    want = np.asarray(JC.history_ctx_lanes(jnp.asarray(lanes), order,
                                           sym_bits))
    got = TC.history_ctx_lanes(t32(lanes), order, sym_bits).numpy()
    np.testing.assert_array_equal(got, want)
    carry = rng.integers(0, 1 << (order * sym_bits), 9).astype(np.int32)
    sym = lanes[0]
    np.testing.assert_array_equal(
        TC.history_carry_update(t32(carry), t32(sym), order,
                                sym_bits).numpy(),
        np.asarray(JC.history_carry_update(jnp.asarray(carry),
                                           jnp.asarray(sym), order,
                                           sym_bits)))


@pytest.mark.parametrize("qbits,lags", [(2, (2, 3, 1)), (2, (2, 3, 2, 2)),
                                        (1, (1, 2)), (1, (1, 3, 2)),
                                        (6, (6, 3, 2, 2)), (3, (3,))])
def test_coarse_ctx(qbits, lags):
    rng = np.random.default_rng(qbits + len(lags))
    carry = rng.integers(0, 1 << (len(lags) * qbits), 500).astype(np.int32)
    want = np.asarray(JQ._coarse_ctx(jnp.asarray(carry), qbits, lags))
    got = CK.coarse_ctx(t32(carry).to(torch.int64), qbits, lags).numpy()
    np.testing.assert_array_equal(got, want)


def test_bulk_history_equals_the_scan():
    """ctxq_history against the reference's scan (quality.py:240-247, the
    same step written with lax.scan), resets at a lane's first step and
    records that start mid-lane included."""
    rng = np.random.default_rng(3)
    lanes_n, t = 8, 90
    n = lanes_n * t - 11
    lens = _record_lengths(rng, n, (3 * t, 6 * t))
    dense = rng.integers(0, 1 << 6, lanes_n * t).astype(np.int32)
    s = dense.reshape(lanes_n, t).T
    reset = np.zeros(lanes_n * t, np.int32)
    reset[np.concatenate([[0], np.cumsum(lens)[:-1]])] = 1
    reset = reset.reshape(lanes_n, t).T
    for qbits, nl in ((2, 3), (2, 4), (1, 2), (6, 4), (3, 1)):
        hmask = (1 << (nl * qbits)) - 1

        def step(h, inp):
            sv, rs = inp
            h_eff = jnp.where(rs > 0, 0, h)
            return ((h_eff << qbits) | sv) & hmask, h_eff

        s_q = s & ((1 << qbits) - 1)
        _, want = jax.lax.scan(step, jnp.zeros((lanes_n,), jnp.int32),
                               (jnp.asarray(s_q), jnp.asarray(reset)))
        got = TQ.ctxq_history(t32(s_q), t32(reset), qbits, nl).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------------------------------
# encode: payload, nwords and states of every caller's configuration
# --------------------------------------------------------------------------

# (order, sym_bits, nsym) of the callers: tag bytes, CTX4, CTX8, CTX4P,
# CTX8P (quality RLE symbols use (0|1, qbits, a_pad))
ORDERK = [(1, 8, 256), (4, 2, 4), (2, 3, 8), (2, 4, 16), (2, 6, 64)]


def _orderk_stream(order, sym_bits, nsym, n=3000):
    rng = np.random.default_rng(order * 100 + nsym)
    p = rng.dirichlet(np.full(nsym, 0.3))
    syms = rng.choice(nsym, size=n, p=p).astype(np.int32)
    return np.pad(syms, (0, 4096 - n)), n, 4096


@pytest.fixture(scope="module")
def jax_split():
    """dsrc_tpu's encoders with their rANS wavefront split off: under
    `stubbed()` ops/rans.py:rans_encode_from_freqs returns its inputs
    (freq, cum, active) in place of (payload, nwords, states), and
    `wavefront` is the real function, jitted once per [T, L] shape.  The
    two composed compute the encoder with one compile of the wavefront per
    shape instead of one per configuration.  JAX's caches, which then hold
    the stubbed traces, are cleared at the end of the module."""
    import contextlib
    from dsrc_tpu.ops import rans as JR
    wavefront = jax.jit(JR.rans_encode_from_freqs)

    @contextlib.contextmanager
    def stubbed():
        with pytest.MonkeyPatch.context() as mp:
            for mod in (JC, JR):
                mp.setattr(mod, "rans_encode_from_freqs",
                           lambda f, c, a: (f, c, a))
            yield

    def coded(m):
        payload, nwords, states = wavefront(m["payload"], m["nwords"],
                                            m["states"])
        return dict(payload=payload, nwords=nwords, states=states)

    yield stubbed, coded
    jax.clear_caches()


@pytest.fixture(scope="module")
def jax_encode_orderk(jax_split):
    """The reference's encode_orderk as its band loop (jitted per
    configuration, wavefront stubbed) and its wavefront."""
    stubbed, coded = jax_split
    band_loop = jax.jit(JC.encode_orderk.__wrapped__,
                        static_argnums=(2, 3, 4, 5, 6))

    def encode(syms, n, order, sym_bits, nsym, lanes, edges):
        with stubbed():
            m = band_loop(syms, n, order, sym_bits, nsym, lanes, edges)
        return coded(m)

    return encode


@pytest.mark.parametrize("order,sym_bits,nsym", ORDERK)
def test_encode_orderk_equals_jax(jax_encode_orderk, order, sym_bits, nsym):
    syms, n, nc = _orderk_stream(order, sym_bits, nsym)
    lanes = JC.pick_num_lanes(nc)
    edges = JC.band_edges(nc // lanes)
    want = jax_encode_orderk(jnp.asarray(syms), n, order, sym_bits, nsym,
                             lanes, edges)
    got = TC.encode_orderk(t32(syms), n, order, sym_bits, nsym, lanes,
                           edges)
    want = convert.coded_from_numpy(
        {k: np.asarray(v) for k, v in want.items()}, "cpu")
    for k in ("payload", "nwords", "states"):
        assert torch.equal(got[k], want[k]), k
    # and the port decodes what it encoded, through K3's plain version
    pl, st = _left_aligned(got)
    dec = TC.decode_orderk(pl, st, n, nc // lanes, order, sym_bits, nsym,
                           lanes, edges)
    np.testing.assert_array_equal(dec.numpy()[:n], syms[:n])


def _left_aligned(enc):
    from dsrc_tpu_torch.ops.streams import deserialize_rans, serialize_rans
    from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
    w = BitWriter()
    serialize_rans(w, 1, enc["payload"], enc["nwords"], enc["states"])
    _n, pl, st, _nw = deserialize_rans(BitReader(w.getvalue()))
    return t32(pl), t32(st.view(np.int32))


# --------------------------------------------------------------------------
# decode: K3's plain version against decode_ctx_lanes, in all three modes
# --------------------------------------------------------------------------

# a short stream with its own band schedule keeps the reference's
# band-unrolled scans few: L = 8 lanes of T = 48 steps, 2 bands (the second
# coded with the table rebuilt from the first)
L8, T48, EDGES = 8, 48, (0, 16, 48)


def _mode_case(mode, jax_split):
    """(JAX decode output, port decode output, source symbols, n) of one
    stream encoded by the reference in `mode`."""
    stubbed, coded = jax_split
    rng = np.random.default_rng(mode + 7)
    n = L8 * T48 - 13                      # the last lane ends early
    lengths = np.clip(n - np.arange(L8) * T48, 0, T48).astype(np.int32)
    if mode == CK.MODE_HISTORY:
        syms = rng.integers(0, 4, L8 * T48).astype(np.int32)
        syms[n:] = 0
        with stubbed():
            enc = coded(JC.encode_orderk(jnp.asarray(syms), n, 2, 2, 4, L8,
                                         EDGES))
        pl, st = _jax_left(enc)
        want = JC.decode_orderk(jnp.asarray(pl), jnp.asarray(st), n, T48, 2,
                                2, 4, L8, EDGES)
        got = TC.decode_orderk(t32(pl), t32(st.view(np.int32)), n, T48, 2,
                               2, 4, L8, EDGES)
        return np.asarray(want), got.numpy(), syms, n
    if mode == CK.MODE_PRECOMPUTED:
        syms = rng.integers(0, 16, L8 * T48).astype(np.int32)
        ctx = rng.integers(0, 5, L8 * T48).astype(np.int32)
        with stubbed():
            enc = coded(JQ._encode_ctxarr(jnp.asarray(syms), n,
                                          jnp.asarray(ctx), 5, 16, L8,
                                          EDGES))
        pl, st = _jax_left(enc)
        want = JQ._decode_ctxarr(jnp.asarray(pl), jnp.asarray(st), n,
                                 jnp.asarray(ctx), T48, 5, 16, L8, EDGES)
        got = TQ._decode_ctxarr(t32(pl), t32(st.view(np.int32)), n,
                                t32(ctx), T48, 5, 16, L8, EDGES)
        return np.asarray(want), got.numpy(), syms, n
    # quality coarse contexts, order 3 at qbits 2: lags (2, 3, 1) need
    # n_hint >= 2^15; the lag of width 3 takes the reference's negative
    # shift
    lens = _record_lengths(rng, n, (2 * T48, 5 * T48))
    syms = rng.integers(0, 4, L8 * T48).astype(np.int32)
    syms[n:] = 0
    n_hint = 1 << 15
    assert JQ._coarse_bits(3, 2, n_hint) == (2, 3, 1)
    with stubbed():
        enc = coded(JQ._encode_ctxq(jnp.asarray(syms), n, jnp.asarray(lens),
                                    L8 * T48, 3, 4, L8, EDGES, n_hint))
    got_enc = TQ._encode_ctxq(t32(syms), n, t32(lens), L8 * T48, 3, 4, L8,
                              EDGES, n_hint)
    for k in ("payload", "nwords"):
        np.testing.assert_array_equal(got_enc[k].numpy(),
                                      np.asarray(enc[k]))
    np.testing.assert_array_equal(u32(got_enc["states"]),
                                  u32(enc["states"]))
    pl, st = _jax_left(enc)
    want = JQ._decode_ctxq(jnp.asarray(pl), jnp.asarray(st), n,
                           jnp.asarray(lens), L8 * T48, T48, 3, 4, L8, EDGES,
                           n_hint)
    got = TQ._decode_ctxq(t32(pl), t32(st.view(np.int32)), n, t32(lens),
                          L8 * T48, T48, 3, 4, L8, EDGES, n_hint)
    assert int(lengths.sum()) == n
    return np.asarray(want), got.numpy(), syms, n


def _record_lengths(rng, n, boundaries):
    """Random record lengths summing to n, with records starting at the
    given stream positions (a lane's first step) and elsewhere mid-lane."""
    cuts = sorted(set(rng.integers(1, n, n // 12).tolist())
                  | set(boundaries))
    edges = np.array([0] + [c for c in cuts if c < n] + [n])
    return np.diff(edges).astype(np.int32)


def _jax_left(enc):
    from dsrc_tpu.ops.streams import deserialize_rans, serialize_rans
    from dsrc_tpu.utils.bitio import BitReader, BitWriter
    w = BitWriter()
    serialize_rans(w, 1, enc["payload"], enc["nwords"], enc["states"])
    _n, pl, st, _nw = deserialize_rans(BitReader(w.getvalue()))
    return pl, st


@pytest.mark.parametrize("mode", [CK.MODE_HISTORY, CK.MODE_PRECOMPUTED,
                                  CK.MODE_QUALITY])
def test_decode_plain_equals_decode_ctx_lanes(jax_split, mode):
    want, got, syms, n = _mode_case(mode, jax_split)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n], syms[:n])


def test_band_state_carries_across_calls():
    """Two half-bands give the same symbols, states, word pointers and
    carries as one call (the state the wrapper carries between launches)."""
    rng = np.random.default_rng(9)
    enc = TC.encode_orderk(t32(rng.integers(0, 4, 4096)), 4000, 3, 2, 4, 8,
                           TC.band_edges(512))
    pl, st = _left_aligned(enc)
    cum = torch.from_numpy(np.cumsum(np.concatenate(
        [np.zeros((64, 1), np.int32), np.full((64, 4), 4096, np.int32)], 1),
        1).astype(np.int32))
    lengths = t32(np.full(8, 500))
    mode = CK.CtxMode(CK.MODE_HISTORY, sbits=2, cmask=63)
    outs = []
    for cuts in ((0, 200), (0, 77, 200)):
        x, w, c = st.clone(), torch.zeros(8, dtype=torch.int32), \
            torch.zeros(8, dtype=torch.int32)
        osym = torch.zeros((8, 512), dtype=torch.int32)
        octx = torch.zeros((8, 512), dtype=torch.int32)
        for a, b in zip(cuts[:-1], cuts[1:]):
            CK.ctx_decode_band(pl, x, w, c, lengths, cum, None, osym, octx,
                               a, b, mode)
        outs.append((x, w, c, osym, octx))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# K4: A19 through K2 at P = 1
# --------------------------------------------------------------------------

def test_a19_through_k2_equals_the_reference(jax_split):
    stubbed, coded = jax_split
    rng = np.random.default_rng(19)
    cap, lanes = 4096, 8
    n = cap - 300                              # lanes past n are idle
    p = rng.dirichlet(np.full(19, 0.5))
    syms = np.zeros(cap, np.int32)
    syms[:n] = rng.choice(19, size=n, p=p)
    with stubbed():
        f, c, a, freqs = JDNA._a19_encode(jnp.asarray(syms), jnp.int32(n),
                                          19, lanes, cap)
    e = coded(dict(payload=f, nwords=c, states=a))
    j = (e["payload"], e["nwords"], e["states"], freqs)
    t = TDNA._a19_encode(t32(syms), n, 19, lanes, cap)
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(u32(t[2]), u32(j[2]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    pl, st = _jax_left(dict(payload=j[0], nwords=j[1], states=j[2]))
    want = np.asarray(JDNA._a19_decode(jnp.asarray(pl), jnp.asarray(st),
                                       j[3], jnp.int32(n), 19, lanes, cap))
    launches = RK.LAUNCHES["rans_decode"].count
    got = TDNA._a19_decode(t32(pl), t32(st.view(np.int32)), t[3], n, 19,
                           lanes, cap).numpy()
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[:n], syms[:n])
    assert RK.LAUNCHES["rans_decode"].count == launches   # CPU: plain


def test_hash_mul_is_not_ported():
    from dsrc_tpu_torch.config import DsrcException
    with pytest.raises(DsrcException):
        TC.history_ctx_lanes(t32(np.zeros((4, 2))), 2, 8, hash_mul=31)
