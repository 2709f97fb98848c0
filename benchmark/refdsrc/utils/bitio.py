"""Host-side bit-granular serialization for headers and metadata.

Counterpart of the reference BitMemoryReader/Writer
(BitMemory.h:28-435).  Used only for *small* control structures (archive
headers, block section tables, model descriptors); bulk payloads are written
as raw byte blobs produced by device kernels.  Big-endian bit order within a
byte (MSB first), matching the reference's convention.
"""
from __future__ import annotations


from ..config import DsrcException


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self._data = data
        self._pos = pos
        self._acc = 0
        self._nbits = 0

    def get_bits(self, nbits: int) -> int:
        while self._nbits < nbits:
            if self._pos >= len(self._data):
                raise DsrcException("bit stream underflow")
            self._acc = (self._acc << 8) | self._data[self._pos]
            self._pos += 1
            self._nbits += 8
        self._nbits -= nbits
        v = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return v

    def get_byte(self) -> int:
        return self.get_bits(8)

    def get_uint32(self) -> int:
        return self.get_bits(32)

    def get_varint(self) -> int:
        self.align()
        v = 0
        shift = 0
        while True:
            if self._pos >= len(self._data):
                raise DsrcException("varint underflow")
            b = self._data[self._pos]
            self._pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def get_svarint(self) -> int:
        u = self.get_varint()
        return (u >> 1) ^ -(u & 1)

    def get_bytes(self, n: int) -> bytes:
        self.align()
        if self._pos + n > len(self._data):
            raise DsrcException("byte stream underflow")
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out

    def align(self) -> None:
        self._acc = 0
        self._nbits = 0

    @property
    def byte_position(self) -> int:
        return self._pos
