"""FHE blob framing and the polynomial codec (counterpart of
node_fhe_accelerate_tpu/core/serializer.py).

Header: magic, version, key type, key id, degree, modulus, data size,
checksum type, compression, CRC32/SHA256 checksum of the stored payload --
byte-compatible with the JAX package, so either side reads the other's
blobs.  Payloads are stored as they are, zlib-compressed, or in the LZ4
block format of the port's native codec (``native/``) behind an 8-byte
raw-size prefix.  ``serialize_polynomial`` bit-packs coefficients to
ceil(log2 q) bits when a modulus is given; ``quick_verify`` checks a blob's
header and checksum without decoding its payload.
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from .. import native

__all__ = [
    "Magic", "ChecksumType", "CompressionType", "SerializationHeader",
    "serialize_polynomial", "deserialize_polynomial",
    "serialize_blob", "deserialize_blob", "quick_verify",
    "SerializationError",
]

SERIALIZATION_VERSION = 1


class Magic(IntEnum):
    SECRET_KEY = 0x46484553    # "FHES"
    PUBLIC_KEY = 0x46484550    # "FHEP"
    EVAL_KEY = 0x46484545      # "FHEE"
    BOOTSTRAP_KEY = 0x46484542  # "FHEB"
    BALLOT = 0x46484556        # "FHEV"


class ChecksumType(IntEnum):
    NONE = 0
    CRC32 = 1
    SHA256 = 2


class CompressionType(IntEnum):
    NONE = 0
    ZLIB = 1
    LZ4 = 2  # native block-format codec (native/codec.cpp nfa_lz4_*)


class SerializationError(ValueError):
    pass


_HEADER_FMT = "<IIIQIQIBB7sI"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


@dataclass
class SerializationHeader:
    magic: int
    version: int = SERIALIZATION_VERSION
    key_type: int = 0
    key_id: int = 0
    poly_degree: int = 0
    modulus: int = 0
    data_size: int = 0
    checksum_type: int = ChecksumType.CRC32
    compression: int = CompressionType.NONE
    checksum: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT, self.magic, self.version, self.key_type,
            self.key_id, self.poly_degree, self.modulus, self.data_size,
            int(self.checksum_type), int(self.compression), b"\0" * 7,
            self.checksum)

    @classmethod
    def unpack(cls, raw: bytes) -> "SerializationHeader":
        if len(raw) < _HEADER_SIZE:
            raise SerializationError("truncated header")
        (magic, version, key_type, key_id, degree, modulus, size,
         ck, comp, _res, checksum) = struct.unpack(_HEADER_FMT,
                                                   raw[:_HEADER_SIZE])
        return cls(magic=magic, version=version, key_type=key_type,
                   key_id=key_id, poly_degree=degree, modulus=modulus,
                   data_size=size, checksum_type=ck, compression=comp,
                   checksum=checksum)


def _checksum(data: bytes, kind: int) -> int:
    if kind == ChecksumType.CRC32:
        return zlib.crc32(data) & 0xFFFFFFFF
    if kind == ChecksumType.SHA256:
        return int.from_bytes(hashlib.sha256(data).digest()[:4], "little")
    return 0


def serialize_blob(magic: Magic, payload: bytes, *, key_id=0, key_type=0,
                   poly_degree=0, modulus=0,
                   checksum_type=ChecksumType.CRC32,
                   compression=CompressionType.NONE) -> bytes:
    """Header + (optionally compressed) payload, checksummed."""
    if compression == CompressionType.ZLIB:
        payload = zlib.compress(payload, 6)
    elif compression == CompressionType.LZ4:
        # the block format has no length field: an 8-byte raw-size prefix
        payload = struct.pack("<Q", len(payload)) + \
            native.lz4_compress(payload)
    elif compression != CompressionType.NONE:
        raise SerializationError(f"unknown compression {compression}")
    hdr = SerializationHeader(
        magic=int(magic), key_type=key_type, key_id=key_id,
        poly_degree=poly_degree, modulus=modulus, data_size=len(payload),
        checksum_type=checksum_type, compression=compression,
        checksum=_checksum(payload, checksum_type))
    return hdr.pack() + payload


def _checked_payload(raw: bytes, expected_magic: Magic | None
                     ) -> tuple[SerializationHeader, bytes]:
    """The header and the stored payload, after the magic, version, size
    and checksum checks."""
    hdr = SerializationHeader.unpack(raw)
    if expected_magic is not None and hdr.magic != int(expected_magic):
        raise SerializationError(
            f"invalid magic bytes: {hdr.magic:#x} != {int(expected_magic):#x}")
    if hdr.version != SERIALIZATION_VERSION:
        raise SerializationError(f"unsupported version {hdr.version}")
    payload = raw[_HEADER_SIZE:_HEADER_SIZE + hdr.data_size]
    if len(payload) != hdr.data_size:
        raise SerializationError("truncated payload")
    # checksum_type comes from the untrusted header: NONE or an unknown
    # value would let a tampered blob disable its own corruption check.
    if hdr.checksum_type not in (ChecksumType.CRC32, ChecksumType.SHA256):
        raise SerializationError(
            f"unacceptable checksum type {hdr.checksum_type}")
    if _checksum(payload, hdr.checksum_type) != hdr.checksum:
        raise SerializationError("checksum mismatch")
    return hdr, payload


def deserialize_blob(raw: bytes, expected_magic: Magic
                     ) -> tuple[SerializationHeader, bytes]:
    hdr, payload = _checked_payload(raw, expected_magic)
    if hdr.compression == CompressionType.ZLIB:
        payload = zlib.decompress(payload)
    elif hdr.compression == CompressionType.LZ4:
        if len(payload) < 8:
            raise SerializationError("truncated LZ4 payload")
        (raw_size,) = struct.unpack("<Q", payload[:8])
        if raw_size > (1 << 40):
            raise SerializationError("implausible LZ4 raw size")
        try:
            payload = native.lz4_decompress(payload[8:], raw_size)
        except ValueError as exc:
            raise SerializationError(str(exc)) from exc
    elif hdr.compression != CompressionType.NONE:
        raise SerializationError(f"unknown compression {hdr.compression}")
    return hdr, payload


def quick_verify(raw: bytes, expected_magic: Magic | None = None
                 ) -> SerializationHeader:
    """Header-only integrity check: magic, version, size and the payload
    checksum, without decompressing or decoding the payload (the checksum
    covers the stored bytes).  Returns the parsed header; raises
    SerializationError on any mismatch."""
    return _checked_payload(raw, expected_magic)[0]


def serialize_polynomial(coeffs, magic: Magic, *, key_id=0, key_type=0,
                         modulus=0, compression=CompressionType.NONE,
                         checksum_type=ChecksumType.CRC32) -> bytes:
    """uint64 coefficients (..., N) as a blob.  With a modulus the
    coefficients are bit-packed to ceil(log2 q) bits by the native codec (a
    41-bit modulus stores 1.56x smaller than raw u64)."""
    c = np.ascontiguousarray(np.asarray(coeffs, dtype="<u8"))
    if modulus > 1:
        bits = max(1, (modulus - 1).bit_length())
        payload = native.pack_words(c.reshape(-1), bits)
    else:
        payload = c.tobytes()
    return serialize_blob(magic, payload, key_id=key_id,
                          key_type=key_type, poly_degree=c.shape[-1],
                          modulus=modulus, compression=compression,
                          checksum_type=checksum_type)


def deserialize_polynomial(raw: bytes, expected_magic: Magic
                           ) -> tuple[SerializationHeader, np.ndarray]:
    """The header and the coefficients, (N,) or (rows, N) uint64."""
    hdr, payload = deserialize_blob(raw, expected_magic)
    if hdr.modulus > 1:
        bits = max(1, (hdr.modulus - 1).bit_length())
        n = len(payload) * 8 // bits
        coeffs = native.unpack_words(payload, n, bits)
    else:
        coeffs = np.frombuffer(payload, dtype="<u8")
    if hdr.poly_degree:
        # drop the phantom words that the bit padding introduces
        usable = (coeffs.size // hdr.poly_degree) * hdr.poly_degree
        coeffs = coeffs[:usable].reshape(-1, hdr.poly_degree)
        if coeffs.shape[0] == 1:
            coeffs = coeffs[0]
    return hdr, coeffs
