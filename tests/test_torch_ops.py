"""Op-level parity of the PyTorch port (dsrc_tpu_torch) with dsrc_tpu.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart on the CPU (where the port's kernel wrappers run their
plain PyTorch versions).  Every comparison is exact integer equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrc_tpu.ops import parser as JP
from dsrc_tpu.ops import rans as JR
from dsrc_tpu.ops import rans_pallas as RP
from dsrc_tpu.parallel import uniform_pipeline as JUP
from dsrc_tpu_torch import convert
from dsrc_tpu_torch.ops import parser as TPARSE
from dsrc_tpu_torch.ops import rans as TR
from dsrc_tpu_torch.ops import rans_kernels as RK
from dsrc_tpu_torch.parallel import uniform_pipeline as TUP
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


def bits32(a):
    """int32 / uint32 array or tensor -> uint32 numpy (same bits)."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a).astype(np.int64).astype(np.uint32)


# --------------------------------------------------------------------------
# quantize_counts / cum_from_freqs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "large", "sparse"])
def test_quantize_counts_matches_jax(case):
    rng = np.random.default_rng(1)
    a = 64
    if case == "random":
        counts = rng.integers(0, 5000, (20, a))
    elif case == "ties":
        # every row has several equal maxima: the deficit must go to the
        # FIRST one, as jnp.argmax picks
        counts = np.tile(rng.integers(0, 3, (1, a)), (6, 1))
        counts[:, [5, 17, 40]] = 900
        counts[1] = 0
        counts[2] = 7
    elif case == "large":
        # totals far above 2^16 (the rescaling shift), within the int32
        # range of the reference's arithmetic (8 * total < 2^31)
        counts = rng.integers(0, 1 << 20, (8, a))
    else:
        counts = np.zeros((8, a), np.int64)
        counts[np.arange(8), rng.integers(0, a, 8)] = rng.integers(1, 9, 8)
    counts = counts.astype(np.int32)
    ref = np.asarray(JR.quantize_counts(jnp.asarray(counts)))
    got = TR.quantize_counts(t32(counts)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(-1) == TR.M).all() and (got >= 1).all()
    np.testing.assert_array_equal(
        TR.cum_from_freqs(torch.from_numpy(got)).numpy(),
        np.asarray(JR.cum_from_freqs(jnp.asarray(ref))))


# --------------------------------------------------------------------------
# K1: rans_encode_from_freqs
# --------------------------------------------------------------------------

def _random_models(seed, t_steps, lanes):
    rng = np.random.default_rng(seed)
    freq = rng.integers(1, 4096, (t_steps, lanes)).astype(np.int32)
    # skew some symbols to tiny frequencies so lanes renormalize often
    freq[rng.random((t_steps, lanes)) < 0.3] = 1
    cum = (rng.random((t_steps, lanes)) * (TR.M - freq)).astype(np.int32)
    # inactive tails of different lengths per lane
    lengths = rng.integers(0, t_steps + 1, lanes)
    lengths[:3] = (t_steps, 0, 1)
    active = np.arange(t_steps)[:, None] < lengths[None, :]
    return freq, cum, active


def test_rans_encode_matches_jax_xla_and_pallas():
    t_steps, lanes = 70, 200
    freq, cum, active = _random_models(5, t_steps, lanes)
    got = RK.rans_encode_from_freqs(t32(freq), t32(cum),
                                    torch.from_numpy(active))
    wp = TR.payload_pairs(t_steps)
    assert got[0].shape == (lanes, wp)
    ref = jax.jit(JR.rans_encode_from_freqs)(
        jnp.asarray(freq), jnp.asarray(cum), jnp.asarray(active))
    pal = RP.rans_encode_from_freqs_tpu(
        jnp.asarray(freq), jnp.asarray(cum), jnp.asarray(active),
        wp_out=wp, interpret=True)
    for other in (ref, pal):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(other[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(other[1]))
        np.testing.assert_array_equal(bits32(got[2]), bits32(other[2]))


def test_kernel_wrappers_check_their_inputs():
    freq, cum, active = _random_models(2, 8, 4)
    with pytest.raises(Exception, match="freq"):
        RK.rans_encode_from_freqs(t32(freq).to(torch.int64), t32(cum),
                                  torch.from_numpy(active))
    with pytest.raises(Exception, match="contiguous"):
        RK.rans_encode_from_freqs(t32(freq).t(), t32(cum).t(),
                                  torch.from_numpy(active).t())
    with pytest.raises(Exception, match="shape"):
        RK.rans_encode_from_freqs(t32(freq), t32(cum[:4]),
                                  torch.from_numpy(active))


# --------------------------------------------------------------------------
# encode_positional / decode_positional (K1 + K2) and cross-decode
# --------------------------------------------------------------------------

def _symbols(seed, rpad, p, nsym):
    rng = np.random.default_rng(seed)
    geo = np.minimum(rng.geometric(0.2, (rpad, p)) - 1, nsym - 1)
    uni = rng.integers(0, nsym, (rpad, p))
    return np.where(rng.random((rpad, p)) < 0.8, geo, uni).astype(np.int32)


def _left_align(payload, nwords):
    """Right-aligned encoder rows -> the left-aligned deserialized layout."""
    payload = np.asarray(payload)
    nwords = np.asarray(nwords)
    u16 = np.ascontiguousarray(payload.astype("<i4")).view("<u2") \
        .reshape(payload.shape[0], -1)
    w = u16.shape[1]
    cols = np.arange(w)[None, :]
    out = np.zeros_like(u16)
    out[cols < nwords[:, None]] = u16[cols >= (w - nwords[:, None])]
    return out.view("<u4").view(np.int32)


def _as_comp(stream, num_rec):
    """A positional stream wrapped as dsrc_tpu's comp dict (dna empty)."""
    return dict(num_rec=np.int32(num_rec), qual_mode=np.int32(0),
                qual=tuple(np.asarray(v) for v in stream),
                dna=(np.zeros(4, np.uint8), np.zeros((4, 1), np.uint32),
                     np.int32(0)))


@pytest.mark.parametrize("nsym,group,left",
                         [(64, 8, False), (64, 8, True), (128, 8, True),
                          (256, 64, False), (256, 64, True)])
def test_positional_codec_matches_jax_and_cross_decodes(nsym, group, left):
    rpad, p, num_rec = 512, 6, 451
    mat = _symbols(nsym + group, rpad, p, nsym)
    mat[num_rec:] = 0
    ref = jax.jit(JUP.encode_positional, static_argnums=(2, 3))(
        jnp.asarray(mat), jnp.int32(num_rec), nsym, group)
    got = TUP.encode_positional(t32(mat), num_rec, nsym, group)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(bits32(got[2]), bits32(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))

    def jax_decode(payload, states, nwords, table):
        return np.asarray(jax.jit(
            JUP.decode_positional, static_argnums=(5, 6, 7, 8, 9))(
                jnp.asarray(payload), jnp.asarray(states),
                jnp.asarray(nwords), jnp.asarray(table), jnp.int32(num_rec),
                p, rpad, nsym, group, left))

    def port_decode(comp):
        payload, nwords, states, table = comp["qual"]
        return TUP.decode_positional(payload, states, nwords, table, num_rec,
                                     p, rpad, nsym, group,
                                     left=left).numpy()

    def aligned(stream):
        payload, nwords, states, table = (np.asarray(v) for v in stream)
        if left:
            payload = _left_align(payload, nwords)
        return payload, nwords, states, table

    # port decodes the JAX stream (JAX comp -> convert -> port)
    jax_stream = aligned(ref)
    port_comp = convert.comp_from_numpy(_as_comp(jax_stream, num_rec), CPU)
    dec_port = port_decode(port_comp)
    # JAX decodes the port stream (port comp -> convert -> JAX)
    port_np = convert.comp_to_numpy(dict(
        num_rec=num_rec, qual_mode=0, qual=got,
        dna=(torch.zeros(4, dtype=torch.uint8),
             torch.zeros((4, 1), dtype=torch.int32), 0)))
    pl, nw, st, tab = aligned(port_np["qual"])
    assert st.dtype == np.uint32
    dec_jax = jax_decode(pl, st, nw, tab)
    np.testing.assert_array_equal(dec_port[:num_rec], mat[:num_rec])
    # the whole [Rpad, P] output, inactive rows included, equals JAX's
    np.testing.assert_array_equal(dec_port, dec_jax)


def test_decode_guards_corrupt_streams():
    """K2's plain version on garbage: words past a row read as 0, symbols
    stay in [0, nsym), zero table rows terminate."""
    rpad, p, nsym, group = 256, 5, 64, 8
    rng = np.random.default_rng(9)
    ll = rpad // group
    payload = t32(rng.integers(-2**31, 2**31 - 1, (ll, 3)))
    states = t32(rng.integers(-2**31, 2**31 - 1, ll))
    for table in (np.zeros((p, nsym), np.int32),
                  rng.integers(0, 1 << 14, (p, nsym)).astype(np.int32)):
        wptr = t32(rng.integers(-10, 20, ll))
        out = RK.rans_decode(payload, states, wptr,
                             TR.cum_from_freqs(t32(table)), rpad, group)
        assert out.shape == (rpad, p)
        assert int(out.min()) >= 0 and int(out.max()) < nsym


# --------------------------------------------------------------------------
# DNA packing, transforms, histograms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("read_len", [60, 101])
def test_pack_dna_matches_jax(read_len):
    rpad, num_rec = 256, 203
    rng = np.random.default_rng(read_len)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                        (rpad, read_len))]
    seq = seq.copy()
    seq[rng.random((rpad, read_len)) < 0.02] = ord("N")
    seq[7, :] = ord("N")                                 # an all-N read
    seq[num_rec:] = 0
    ref = JUP.pack_dna(jnp.asarray(seq), jnp.int32(num_rec), read_len)
    got = TUP.pack_dna(torch.from_numpy(seq), num_rec, read_len)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(bits32(got[1]), bits32(ref[1]))
    assert int(got[2]) == int(ref[2])
    back = TUP.unpack_dna(t32(np.asarray(ref[0])).to(torch.uint8),
                          t32(bits32(ref[1]).view(np.int32)), rpad, read_len)
    ref_back = JUP.unpack_dna(ref[0], ref[1], ref[2], rpad, read_len)
    np.testing.assert_array_equal(back.numpy()[:num_rec],
                                  np.asarray(ref_back)[:num_rec])
    np.testing.assert_array_equal(back.numpy()[:num_rec], seq[:num_rec])


def test_pack_dna_exact_under_tf32():
    """Integer shifts only: enabling TF32 cannot change the packed bits."""
    rpad, p = 256, 64
    rng = np.random.default_rng(4)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (rpad, p))]
    want = TUP.pack_dna(torch.from_numpy(seq.copy()), rpad, p)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = TUP.pack_dna(torch.from_numpy(seq.copy()), rpad, p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)


def test_title_and_quality_transforms_match_jax():
    rng = np.random.default_rng(12)
    rpad, p = 256, 9
    title = rng.integers(0, JUP.TITLE_A, (rpad, p)).astype(np.int32)
    ref = np.asarray(JUP.title_delta(jnp.asarray(title), 16))
    got = TUP.title_delta(t32(title), 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        TUP.invert_title_delta(got, 16).numpy(),
        np.asarray(JUP.invert_title_delta(jnp.asarray(ref), 16)))
    np.testing.assert_array_equal(TUP.invert_title_delta(got, 16).numpy(),
                                  title)
    qual = rng.integers(0, JUP.QUAL_A, (rpad, p)).astype(np.int32)
    qd = np.asarray(JUP.qual_delta(jnp.asarray(qual), 64))
    got_qd = TUP.qual_delta(t32(qual), 64)
    np.testing.assert_array_equal(got_qd.numpy(), qd)
    assert (got_qd.numpy() >= 0).all()           # floor modulo, not fmod
    np.testing.assert_array_equal(TUP.qual_delta_inv(got_qd, 64).numpy(),
                                  np.asarray(JUP.qual_delta_inv(
                                      jnp.asarray(qd), 64)))
    np.testing.assert_array_equal(TUP.qual_delta_inv(got_qd, 64).numpy(),
                                  qual)


def test_value_planes_match_jax_with_int32_wrap():
    rng = np.random.default_rng(13)
    rpad, nf = 256, 4
    vmat = np.stack([
        np.arange(rpad) + 10**8,                          # +1 counter
        rng.integers(0, 10**9, rpad),                     # huge jumps
        rng.integers(-5, 5, rpad),                        # small signed
        np.where(np.arange(rpad) % 2, 2**31 - 1, -2**31),  # int32 wrap
    ], axis=1).astype(np.int32)
    v0 = vmat[0].copy()
    pcs = (1, 4, 1, 4)
    ref = np.asarray(JUP._value_planes(jnp.asarray(vmat), jnp.asarray(v0),
                                       pcs))
    got = TUP._value_planes(t32(vmat), t32(v0), pcs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    back_ref = np.asarray(JUP._planes_to_values(jnp.asarray(ref),
                                                jnp.asarray(v0), pcs))
    back = TUP._planes_to_values(got, t32(v0), pcs)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), back_ref)
    np.testing.assert_array_equal(back.numpy()[:, [1, 3]], vmat[:, [1, 3]])


def test_histograms_and_quality_mode_choice_match_jax():
    rng = np.random.default_rng(14)
    rpad, p, num_rec = 512, 20, 480
    # AR-correlated quality: the delta transform wins by a wide margin
    base = np.cumsum(rng.integers(-1, 2, (rpad, p)), axis=1) + 30
    qual = np.clip(base, 0, 63).astype(np.int32)
    h_ref = np.asarray(JUP._pos_hist(jnp.asarray(qual), num_rec, 64))
    h_got = TUP.pos_hist(t32(qual), num_rec, 64)
    np.testing.assert_array_equal(h_got.numpy(), h_ref)
    for q in (qual, rng.integers(0, 64, (rpad, p)).astype(np.int32)):
        qs = jnp.asarray(q)
        bits_direct = float(JUP._pos_entropy_bits(
            JUP._pos_hist(qs, num_rec, 64)))
        bits_delta = float(JUP._pos_entropy_bits(
            JUP._pos_hist(JUP.qual_delta(qs, 64), num_rec, 64)))
        # the float32 estimate only picks; these inputs are far from a tie
        assert abs(bits_direct - bits_delta) > 1e-3 * bits_direct
        ref_syms, ref_mode = JUP._choose_qual_syms(qs, num_rec, JUP.Wire())
        got_syms, got_mode = TUP._choose_qual_syms(t32(q), num_rec,
                                                   TUP.Wire())
        assert int(got_mode) == int(ref_mode)
        np.testing.assert_array_equal(got_syms.numpy(),
                                      np.asarray(ref_syms))
        np.testing.assert_allclose(
            float(TUP._pos_entropy_bits(TUP.pos_hist(t32(q), num_rec, 64))),
            bits_direct, rtol=1e-5)


def test_parse_and_analyze_match_jax():
    from dsrc_tpu_torch.utils.synth import make_fastq
    data = make_fastq(60, 40, seed=3, variable_length=True)
    cap, rcap = 16384, 1024
    buf = np.zeros(cap, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    ref = JP.parse_block(jnp.asarray(buf), jnp.int32(len(data)), rcap)
    got = TPARSE.parse_block(torch.from_numpy(buf), len(data), rcap)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    a_ref = JP.analyze_block(jnp.asarray(buf), ref)
    a_got = TPARSE.analyze_block(torch.from_numpy(buf), got)
    for k in a_ref:
        assert int(a_got[k]) == int(a_ref[k]), k
