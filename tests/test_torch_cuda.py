"""Kernels K1 (rANS encode) and K2 (rANS decode) against their plain
PyTorch versions, on an NVIDIA card.  Marked `cuda`: they skip where torch
sees no CUDA device.  On the card, chip_smoke.py runs the same checks at
the main path's shapes; run these with

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
