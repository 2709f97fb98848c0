"""Configuration of the PyTorch FASTQ compression engine (a copy of
dsrc_tpu/config.py: the port imports nothing of the JAX package).

Mirrors the user-visible knobs of the reference (DSRC 2.02) — see
src/Common.h:115-193 (CompressionSettings, InputParameters) and
include/dsrc/Globals.h — re-expressed as Python dataclasses.
The archive footer persists ``CompressionSettings`` + ``DatasetType`` so that
decompression needs no flags (reference: DsrcFile.cpp:133-170).
"""
from __future__ import annotations

import dataclasses


class DsrcException(Exception):
    """Engine error (reference: Globals.h:58)."""


# Quality-offset sentinel: auto-detect from the first chunk
# (reference: Common.h / FastqParser.cpp:111-135).
AUTO_QUALITY_OFFSET = 0

MIN_DNA_ORDER = 0
MAX_DNA_ORDER = 9          # reference: CompressionSettings::MaxDnaOrder (Common.h)
MIN_QUALITY_ORDER = 0
MAX_QUALITY_ORDER = 6      # reference: CompressionSettings::MaxQualityOrder


@dataclasses.dataclass(frozen=True)
class DatasetType:
    """Per-dataset properties detected from the first chunk.

    Reference: FastqDatasetType (Common.h:56-80).
    """
    quality_offset: int = AUTO_QUALITY_OFFSET  # 0 = auto; else 33/59/64
    plus_repetition: bool = False              # '+' line repeats the title
    color_space: bool = False                  # SOLiD color-space reads


@dataclasses.dataclass(frozen=True)
class CompressionSettings:
    """Codec-level settings, persisted in the archive footer.

    Reference: CompressionSettings (Common.h:115-147).  The reference's
    level->order mapping (DsrcOperator.h:74-90) lives in
    :func:`from_input_parameters`.
    """
    dna_order: int = 0                 # 0 = pack/static, 1..9 = context order
    quality_order: int = 0             # 0 = position modelers, 1..6 = context
    lossy_quality: bool = False        # Illumina 8-bin quantization
    tag_preserve_mask: int = 0xFFFFFFFFFFFFFFFF
    calculate_crc32: bool = False

    def __post_init__(self):
        if not MIN_DNA_ORDER <= self.dna_order <= MAX_DNA_ORDER:
            raise DsrcException(f"invalid dna_order: {self.dna_order}")
        if not MIN_QUALITY_ORDER <= self.quality_order <= MAX_QUALITY_ORDER:
            raise DsrcException(f"invalid quality_order: {self.quality_order}")

    @property
    def tag_fields_filtered(self) -> bool:
        return self.tag_preserve_mask != 0xFFFFFFFFFFFFFFFF


