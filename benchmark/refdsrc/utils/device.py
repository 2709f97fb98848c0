"""Device selection for the port's entry points.

Entry points take an explicit device.  "cuda" is the default and the only
device the kernels run on; the CPU runs the plain PyTorch versions of the
kernels and is taken only when the caller asks for it.  There is no silent
fallback: asking for CUDA on a machine without a card raises.
"""
from __future__ import annotations

from typing import Union

import torch

from ..config import DsrcException

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DsrcException(
                "CUDA device requested but torch.cuda.is_available() is "
                "false (pass device='cpu' to run the plain PyTorch path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DsrcException(f"unsupported device {dev}")
    return dev
