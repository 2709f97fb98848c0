"""2-bit packing of DNA scheme PACK2 (port of the parts of
dsrc_tpu/ops/packbits.py that the codec uses): four symbols a byte,
little-endian within the byte (reference DnaModelerBasicB2.h:34-60)."""
from __future__ import annotations

import torch

from ..config import DsrcException


def pack2(syms: torch.Tensor) -> torch.Tensor:
    """[4n] symbols in [0, 4) -> [n] uint8."""
    if syms.shape[0] % 4:
        raise DsrcException("pack2: length must be a multiple of 4")
    s = syms.to(torch.int32).reshape(-1, 4)
    return (s[:, 0] | (s[:, 1] << 2) | (s[:, 2] << 4) | (s[:, 3] << 6)) \
        .to(torch.uint8)


def unpack2(packed: torch.Tensor) -> torch.Tensor:
    """[n] uint8 -> [4n] int32 symbols."""
    b = packed.to(torch.int32)[:, None]
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
                          device=packed.device)
    return ((b >> shifts) & 3).reshape(-1)
