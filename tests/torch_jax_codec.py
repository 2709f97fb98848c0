"""The reference's encoders with their rANS wavefront jitted once per
shape, for the port's tests that compare archives with dsrc_tpu's.

A test module imports the fixture (pytest puts tests/ on the path):

    from torch_jax_codec import jax_codec  # noqa: F401

and compresses with dsrc_tpu under `with jax_codec():`.  The bytes are the
reference's: its encoders run unchanged up to their wavefront inputs, and
serialize_rans runs the real wavefront before writing.  The same functions
composed the same way, with far fewer compiles than the reference's own
trace of every encoder."""
import jax
import numpy as np
import pytest

from dsrc_tpu.models import block as JB
from dsrc_tpu.models import dna as JDNA
from dsrc_tpu.models import quality as JQ
from dsrc_tpu.models import tag as JTAG
from dsrc_tpu.ops import ctx as JC
from dsrc_tpu.ops import rans as JR
from dsrc_tpu.ops import streams as JS
# imported before any stub: the UNIFORM / SEMI positional streams bind the
# real encoder by name and stay as they are
from dsrc_tpu.parallel import uniform_pipeline  # noqa: F401


@pytest.fixture(scope="module")
def jax_codec():
    """A context manager under which dsrc_tpu's encoders return their
    wavefront inputs (freq, cum, active) in place of (payload, nwords,
    states), and its serialize_rans runs the real wavefront, jitted once
    per shape, before writing.  The result is the reference's bytes.  Its
    decode-after-encode CRC self check (-c), which writes nothing, is
    skipped.  JAX's caches, which now hold the stubbed traces, are cleared
    afterwards."""
    import contextlib
    real = JR.rans_encode_from_freqs
    wavefront = jax.jit(real)
    serialize = JS.serialize_rans

    def ser(w, n, payload, nwords, states):
        if np.asarray(states).dtype == bool:
            payload, nwords, states = wavefront(payload, nwords, states)
        serialize(w, n, payload, nwords, states)

    @contextlib.contextmanager
    def stubbed():
        with pytest.MonkeyPatch.context() as mp:
            for mod in (JC, JR):
                mp.setattr(mod, "rans_encode_from_freqs",
                           lambda f, c, a: (f, c, a))
            for mod in (JDNA, JQ, JTAG):
                mp.setattr(mod, "serialize_rans", ser)
            mp.setattr(JB.BlockCodec, "verify_checksum",
                       lambda self, blob: True)
            yield

    yield stubbed
    jax.clear_caches()
