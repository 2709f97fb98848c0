"""2-bit packing of DNA scheme PACK2 (port of the parts of
dsrc_tpu/ops/packbits.py that the codec uses): four symbols a byte,
little-endian within the byte (reference DnaModelerBasicB2.h:34-60)."""
from __future__ import annotations

import torch


def unpack2(packed: torch.Tensor) -> torch.Tensor:
    """[n] uint8 -> [4n] int32 symbols."""
    b = packed.to(torch.int32)[:, None]
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
                          device=packed.device)
    return ((b >> shifts) & 3).reshape(-1)
