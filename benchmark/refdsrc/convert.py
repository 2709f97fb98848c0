"""The state the two packages share: the compressed-block dict.

A compressor has no weights; what dsrc_tpu and this port must agree on is
the per-block `comp` dict between the device codec and serialization:

    num_rec, qual_mode                    scalars
    title, qual: (payload [L, W] int32 u16 pairs, nwords [L] int32,
                  states [L] u32, table [P, A] int32)    ("title" optional)
    dna: (packed [n] uint8, exc_bits [rpad, ceil(P/32)] u32, exc_count)

dsrc_tpu holds it as numpy (read_uniform_block / parse_semi_block) or as
jax arrays (compress_uniform / compress_semi_tok, np.asarray'd by the
caller).  The port keeps u32 fields as int32 tensors with the same bits.
With these two functions a stream encoded by one package goes through the
other's decode.

The GENERIC class shares no such dict: its sections are coded one stream
at a time, and a coded stream is the dict {payload [L, W] int32 u16 pairs,
nwords [L] int32, states [L] u32} of the reference's encoders
(ops/ctx.py encode_orderk, models/quality.py _encode_ctx*).
coded_from_numpy moves one to the port's tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device

_STREAMS = ("title", "qual")


def _i32(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, np.int32))     # a writable copy


def comp_from_numpy(comp: dict, device="cuda") -> dict:
    """dsrc_tpu comp dict (numpy arrays or anything np.asarray takes) ->
    the port's dict of tensors on `device`."""
    dev = resolve_device(device)
    out = {"num_rec": int(np.asarray(comp["num_rec"])),
           "qual_mode": int(np.asarray(comp["qual_mode"]))}
    for key in _STREAMS:
        if key in comp:
            payload, nwords, states, table = (np.asarray(v)
                                              for v in comp[key])
            out[key] = tuple(_i32(v).to(dev)
                             for v in (payload, nwords, states, table))
    packed, exc_bits, exc_count = (np.asarray(v) for v in comp["dna"])
    out["dna"] = (torch.from_numpy(np.array(packed, np.uint8)).to(dev),
                  _i32(exc_bits).to(dev), int(exc_count))
    return out


