"""dsrc_tpu's encoders with their rANS wavefront split off, for the port's
parity tests that encode and decode with the reference (the context-model
codec, A19).  A test module imports the fixture (pytest puts tests/ on the
path):

    from torch_jax_split import jax_left, jax_split  # noqa: F401
"""
import jax
import pytest

from dsrc_tpu.ops import ctx as JC


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


def jax_left(enc):
    """A reference-coded stream as a decoded block holds it: (payload [L, W]
    int32 with each lane's words left-aligned, states [L] u32)."""
    from dsrc_tpu.ops.streams import deserialize_rans, serialize_rans
    from dsrc_tpu.utils.bitio import BitReader, BitWriter
    w = BitWriter()
    serialize_rans(w, 1, enc["payload"], enc["nwords"], enc["states"])
    _n, pl, st, _nw = deserialize_rans(BitReader(w.getvalue()))
    return pl, st
