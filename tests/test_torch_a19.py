"""K4, the port's decode of DNA scheme A19 (dsrc_tpu_torch/ops/a19_kernels.py),
on the CPU, where the wrapper runs its plain version.

- a19_decode_plain equals dsrc_tpu's _a19_decode on streams that the
  reference encodes (quantize_counts tables), at several (n, L, T);
- it equals K2's plain version at P = 1 (rans_decode_plain with the
  table's cum row and group T) on hand-made tables that no encoder writes
  but an archive's 14-bit fields can carry: zero fields, sums below and
  above 2^14;
- its slot table gives K2's symbol at every one of the 2^14 slots, and
  both of an entry's fields fit 14 bits;
- the wrapper refuses a field outside [0, 2^14);
- k4_variants.py's source edits still apply to the committed kernels.

Every comparison is exact equality.  The same kernel is held to this plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k4_variants
from dsrc_tpu.models import dna as JDNA
from dsrc_tpu_torch.config import DsrcException
from dsrc_tpu_torch.models import dna as TDNA
from dsrc_tpu_torch.ops import a19_kernels as AK
from dsrc_tpu_torch.ops import cuda_build
from dsrc_tpu_torch.ops import rans_kernels as RK
from dsrc_tpu_torch.ops.rans import M, cum_from_freqs
from torch_jax_split import jax_left, jax_split  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


# (cap, lanes, n, skew): T = cap / lanes; n not a multiple of T with the
# last lanes idle; one live lane; a stream of one symbol and a few others
REFERENCE_CASES = [
    (4096, 8, 4096 - 700, None),
    (4096, 8, 200, None),
    (4096, 8, 4096, 5),
    (2048, 16, 2048 - 77, None),
]


@pytest.mark.parametrize("cap,lanes,n,skew", REFERENCE_CASES)
def test_plain_equals_the_reference(jax_split, cap, lanes, n, skew):
    stubbed, coded = jax_split
    rng = np.random.default_rng(cap + n)
    if skew is None:
        p = rng.dirichlet(np.full(19, 0.5))
    else:
        p = np.full(19, 0.002)
        p[skew] = 1 - 0.002 * 18
    syms = np.zeros(cap, np.int32)
    syms[:n] = rng.choice(19, size=n, p=p)
    with stubbed():
        f, c, a, freqs = JDNA._a19_encode(jnp.asarray(syms), jnp.int32(n),
                                          19, lanes, cap)
    pl, st = jax_left(coded(dict(payload=f, nwords=c, states=a)))
    want = np.asarray(JDNA._a19_decode(jnp.asarray(pl), jnp.asarray(st),
                                       freqs, jnp.int32(n), 19, lanes, cap))
    t = cap // lanes
    got = AK.a19_decode_plain(t32(pl), t32(st.view(np.int32)),
                              torch.zeros(lanes, dtype=torch.int32),
                              np.asarray(freqs), n, t)
    assert got.dtype == torch.uint8 and got.shape == (lanes * t,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:n], syms[:n])
    # the block decoder's path: the same symbols, no launch on the CPU
    before = RK.LAUNCHES["a19_decode"].count
    dna = TDNA._a19_decode(t32(pl), t32(st.view(np.int32)),
                           np.asarray(freqs), n, 19, lanes, cap)
    assert torch.equal(dna, got)
    assert RK.LAUNCHES["a19_decode"].count == before


def _fields(*pairs, fill=0):
    """19 fields: `fill` everywhere but at the (index, value) pairs."""
    f = [fill] * 19
    for i, v in pairs:
        f[i] = v
    return f


# tables that no encoder writes (quantize_counts gives every field >= 1
# and the sum 2^14) but the archive's 14-bit fields can carry
EDGE_TABLES = {
    "zero_fields": _fields((0, 4000), (3, 8000), (7, 4384)),
    "sum_below": _fields(fill=100),
    "sum_above": _fields(fill=M - 1),
    "all_zero": _fields(),
    "last_only": _fields((18, 77)),
    "first_only_past_m": _fields((0, M - 1), (1, 5000)),
    "full_table": _fields((4, M - 18), fill=1),
}


@pytest.mark.parametrize("name", list(EDGE_TABLES))
def test_plain_equals_k2_at_p1(name):
    """Random payloads, states and start words (odd, negative, past the
    row), T = 97 (not a multiple of the kernel's 16-step stores), the last
    lanes idle."""
    freqs = EDGE_TABLES[name]
    rng = np.random.default_rng(sum(freqs) + 7)
    lanes, w, t = 11, 30, 97
    payload = t32(rng.integers(-2**31, 2**31 - 1, (lanes, w)))
    states = t32(rng.integers(-2**31, 2**31 - 1, lanes))
    wptr = t32([0, 1, 2, 7, 8, 59, 60, 61, -1, -9, 2**31 - 3])
    n = lanes * t - 250
    got = AK.a19_decode(payload, states, wptr, freqs, n, t)
    cum = cum_from_freqs(t32(freqs))[None, :].contiguous()
    want = RK.rans_decode_plain(payload, states, wptr, cum, n, t)
    assert torch.equal(got.to(torch.int32), want.reshape(-1))


@pytest.mark.parametrize("name", list(EDGE_TABLES))
def test_slot_table_is_k2s_rule_in_14_bit_fields(name):
    freqs = EDGE_TABLES[name]
    f, bias, sym = AK.slot_table(freqs)
    slots = torch.arange(M)
    cum = cum_from_freqs(t32(freqs)).to(torch.int64)
    assert torch.equal(sym, RK.count_search_plain(cum[None, :],
                                                  slots[:, None])[:, 0])
    assert torch.equal(f, cum[sym + 1] - cum[sym])
    assert torch.equal(bias, slots - cum[sym])
    # both fields in 14 bits: f << 14 | bias is one u32; the symbol (< 19)
    # takes its own byte
    for v in (f, bias):
        assert int(v.min()) >= 0 and int(v.max()) < M
    assert int(sym.min()) >= 0 and int(sym.max()) < 19


@pytest.mark.parametrize("freqs", [_fields((3, M)), _fields((0, -1)),
                                   [100] * 18, [100] * 20])
def test_wrapper_refuses_fields_the_wire_cannot_carry(freqs):
    args = (t32(np.zeros((2, 4))), t32([0, 0]), t32([0, 0]))
    with pytest.raises(DsrcException):
        AK.a19_decode(*args, freqs, 8, 4)


@pytest.mark.parametrize("source,edit", [
    ("rans_dec.cu", k4_variants.probe_source),
    ("a19_dec.cu", k4_variants.entry32_source)])
def test_k4_variants_apply_to_the_kernel_sources(source, edit):
    """k4_variants.py's probe of K2 and K4's 4-byte-entry variant are text
    edits of the committed sources; each anchor occurs exactly once."""
    with open(f"{cuda_build.CSRC}/{source}") as f:
        src = f.read()
    assert edit(src) != src
