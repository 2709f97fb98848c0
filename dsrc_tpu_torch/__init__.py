"""dsrc_tpu_torch — the PyTorch / CUDA port of dsrc_tpu, the FASTQ
compression engine.

Writes and reads the same `.xfqz` archives as dsrc_tpu: the fast mode
(-d0 -q0) on fixed-read-length Illumina blocks (the UNIFORM and SEMI
classes, numeric or free-text titles) and the GENERIC class (-d0..3,
-q0..2, lossy, CRC, field filtering, variable read lengths, colour space),
through the whole-file API (DsrcModule), the record API (DsrcArchive) and
the CLI.  Its rANS encode and decode run as hand-written CUDA kernels
(csrc/; ops/rans_kernels.py, ops/ctx_kernels.py).  Entry points run on
"cuda" unless the caller passes device="cpu".  It imports nothing of
dsrc_tpu and no JAX.
"""
__version__ = "0.1.0"

from .config import (  # noqa: F401
    AUTO_QUALITY_OFFSET,
    CompressionSettings,
    DatasetType,
    DsrcException,
    FieldMask,
    InputParameters,
)


def __getattr__(name):
    # lazy exports (keep `import dsrc_tpu_torch` light)
    if name in ("DsrcModule", "compress", "decompress"):
        from . import api
        return getattr(api, name)
    if name in ("DsrcArchive", "FastqFile", "FastqRecord"):
        from . import archive_api
        return getattr(archive_api, name)
    raise AttributeError(f"module 'dsrc_tpu_torch' has no attribute {name!r}")
