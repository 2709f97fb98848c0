"""No kernel library in the reference: its wrappers run their plain
PyTorch versions on the CPU, and a CUDA tensor that reached one raises."""
from __future__ import annotations

from ..config import DsrcException


def load(name: str):
    raise DsrcException(f"the reference decoder runs on the CPU only: no "
                        f"CUDA kernel ({name})")
