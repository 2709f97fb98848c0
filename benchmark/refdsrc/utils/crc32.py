"""CRC32 (poly 0xEDB88320, LSB-first, seed 0xFFFFFFFF), the reference's
Crc32Hasher (Crc32.h:24-76) convention, which zlib shares (port of
dsrc_tpu/utils/crc32.py)."""
from __future__ import annotations

import zlib

import numpy as np


def crc32(data, seed: int = 0) -> int:
    """CRC32 of bytes / a numpy uint8 array; chainable via ``seed``."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    return zlib.crc32(data, seed) & 0xFFFFFFFF
