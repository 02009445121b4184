"""FHE blob framing (counterpart of node_fhe_accelerate_tpu/core/serializer.py,
``serialize_blob``/``deserialize_blob`` only).

Header: magic, version, key type, key id, degree, modulus, data size,
checksum type, compression, CRC32/SHA256 checksum of the stored payload --
byte-compatible with the JAX package, so either side reads the other's
blobs.  The port handles uncompressed and zlib payloads; LZ4 needs the JAX
package's native codec and is refused.
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from dataclasses import dataclass
from enum import IntEnum

__all__ = [
    "Magic", "ChecksumType", "CompressionType", "SerializationHeader",
    "serialize_blob", "deserialize_blob", "SerializationError",
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
    LZ4 = 2


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
    """Header + (optionally zlib-compressed) payload, checksummed."""
    if compression == CompressionType.ZLIB:
        payload = zlib.compress(payload, 6)
    elif compression != CompressionType.NONE:
        raise SerializationError(f"compression {compression} is not "
                                 "supported by the port")
    hdr = SerializationHeader(
        magic=int(magic), key_type=key_type, key_id=key_id,
        poly_degree=poly_degree, modulus=modulus, data_size=len(payload),
        checksum_type=checksum_type, compression=compression,
        checksum=_checksum(payload, checksum_type))
    return hdr.pack() + payload


def deserialize_blob(raw: bytes, expected_magic: Magic
                     ) -> tuple[SerializationHeader, bytes]:
    hdr = SerializationHeader.unpack(raw)
    if hdr.magic != int(expected_magic):
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
    if hdr.compression == CompressionType.ZLIB:
        payload = zlib.decompress(payload)
    elif hdr.compression != CompressionType.NONE:
        raise SerializationError(f"compression {hdr.compression} is not "
                                 "supported by the port")
    return hdr, payload
