"""K1's pieces on the CPU: the reciprocal divide rule the kernel uses
(recip_divmod_plain) against floor division for every freq; the plain
version the kernel is held to on the card (rans_encode_plain) against the
JAX package's encoder on every lane kind and every freq; the wire path's
alphabets, which keep every freq K1 codes below 2^14; and the variants of
k1_variants.py, which must still apply to the kernel's source.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k1_variants
from dsrc_tpu.ops import rans as JR
from dsrc_tpu_torch.ops import cuda_build
from dsrc_tpu_torch.ops import rans_kernels as RK
from dsrc_tpu_torch.ops.rans import M, payload_pairs
from dsrc_tpu_torch.parallel import uniform_pipeline as UP

from torch_enc_inputs import enc_models, every_freq_models
from torch_threads import one_torch_thread  # noqa: F401

U32 = (1 << 32) - 1
FREQS = torch.arange(1, M + 1, dtype=torch.int64)       # [1, 2^14]


def _check_divmod(x, f):
    q, r = RK.recip_divmod_plain(x, f)
    assert torch.equal(q, torch.div(x, f, rounding_mode="floor"))
    assert torch.equal(r, torch.remainder(x, f))


@pytest.mark.parametrize("name", [
    "0", "1", "f-1", "f", "f+1", "(f<<18)-1", "f<<18", "2^32-1", "2^32-2",
    "2^31"])
def test_recip_divmod_edges_for_every_freq(name):
    f = FREQS
    x = {"0": torch.zeros_like(f), "1": torch.ones_like(f), "f-1": f - 1,
         "f": f, "f+1": f + 1, "(f<<18)-1": (f << 18) - 1,
         "f<<18": torch.clamp(f << 18, max=U32),
         "2^32-1": torch.full_like(f, U32), "2^32-2": torch.full_like(f, U32 - 1),
         "2^31": torch.full_like(f, 1 << 31)}[name]
    _check_divmod(x, f)


@pytest.mark.parametrize("k", [2, 3, 7, 1000, 65535, 65536, 262143, 262144])
def test_recip_divmod_multiples_for_every_freq(k):
    f = FREQS
    for x in (k * f - 1, k * f, k * f + 1):
        _check_divmod(torch.clamp(x, 0, U32), f)
    # the largest multiple below 2^32 and its neighbours
    top = (U32 // f) * f
    for x in (top - 1, top, torch.clamp(top + 1, max=U32)):
        _check_divmod(x, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recip_divmod_random_states_for_every_freq(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 1 << 32, (64, M), dtype=np.int64))
    _check_divmod(x, FREQS.expand(64, M))


def test_enc_recip_is_a_granlund_montgomery_magic_number():
    m, l = RK.enc_recip(FREQS)
    f = FREQS
    assert torch.equal(l, torch.ceil(torch.log2(f.double())).to(torch.int64))
    assert int(m.min()) >= 1 and int(m.max()) < 1 << 32
    # 2^(32+l) < (2^32 + m) f <= 2^(32+l) + 2^l: exact for every u32 x
    prod = [(1 << 32) + int(a) for a in m]
    for fi, li, p in zip(f.tolist(), l.tolist(), prod):
        assert 1 << (32 + li) < p * fi <= (1 << (32 + li)) + (1 << li)


def _plain_equals_jax(freq, cum, active):
    got = RK.rans_encode_plain(freq, cum, active)
    ref = jax.jit(JR.rans_encode_from_freqs)(
        jnp.asarray(freq.numpy()), jnp.asarray(cum.numpy()),
        jnp.asarray(active.numpy()))
    assert got[0].shape == (freq.shape[1], payload_pairs(freq.shape[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32),
                                  np.asarray(ref[2]).view(np.uint32))
    return got


@pytest.mark.parametrize("t_steps,lanes", [
    (1, 1), (1, 40), (31, 33), (32, 33), (33, 33), (45, 70), (96, 9),
    (200, 50)])
def test_rans_encode_plain_matches_jax(t_steps, lanes):
    """T of 1, below, at and above K1's 32-step chunk, and several chunks;
    all-inactive lanes, lanes with no emission and inactive tails."""
    nwords = _plain_equals_jax(*enc_models(t_steps * 1000 + lanes, t_steps,
                                           lanes))[1]
    if lanes > 3:
        assert int(nwords[1]) == 0 and int(nwords[2]) == 0
    if t_steps >= 32:
        # odd and even word counts both occur, so pairs and tails are held
        assert {0, 1} <= set((nwords % 2).tolist())


def test_rans_encode_plain_large_freqs_and_full_cum_match_jax():
    """Freqs up to 2^14 - 1 and cum = 2^14 - f: the largest states."""
    freq, cum, active = enc_models(9, 150, 40, max_freq=M)
    _plain_equals_jax(freq, torch.where(active, M - freq, cum), active)


def test_rans_encode_plain_every_freq_matches_jax():
    """The stream the card tests hold K1 to: every freq in [1, 2^14)."""
    freq, cum, active = every_freq_models(21)
    assert torch.unique(freq).numel() == M - 1
    _plain_equals_jax(freq, cum, active)


@pytest.mark.parametrize("nsym", [8, UP.QUAL_A, UP.TITLE_A, UP.VAL_A, 512])
def test_wire_path_freqs_stay_below_2_14(nsym):
    """At f = 2^14 the JAX encoder's u32 compare x >= f << 18 wraps and it
    emits on every step, while rans_encode_plain and K1 never emit.  The
    wire path never codes such a step: quantize_counts gives each of the
    A >= 8 symbols at least 1, so f <= 2^14 - A + 1, reached by a block
    whose every record holds one symbol (with enough records that the
    other symbols' smoothed counts quantize to 1)."""
    rpad, p, group = 4096, 2, 8
    mat = torch.full((rpad, p), nsym - 1, dtype=torch.int32)
    freq, _cum, active, table = UP.positional_models(mat, rpad - 6, nsym,
                                                     group)
    assert int(table.min()) >= 1
    assert int(freq[active].max()) == M - nsym + 1 < M


@pytest.mark.parametrize("field", ["qual_a", "title_a"])
@pytest.mark.parametrize("nsym", [1, 4])
def test_wire_rejects_alphabets_below_8(field, nsym):
    with pytest.raises(ValueError):
        UP.Wire(**{field: nsym}).validate(64)


@pytest.mark.parametrize("name", list(k1_variants.VARIANTS))
def test_k1_variants_apply_to_the_kernel_source(name):
    """Each variant's substitutions match rans_enc.cu exactly once, so the
    variant harness follows the committed kernel."""
    with open(os.path.join(cuda_build.CSRC, "rans_enc.cu")) as f:
        src = f.read()
    subs = k1_variants.VARIANTS[name][1]
    out = k1_variants.variant_source(src, subs)
    assert (out == src) == (not subs)
