"""The port's native codec (native/codec.cpp through ctypes, and its
pure-Python fallback) and the polynomial codec of core/serializer.py
(serialize_polynomial, LZ4 payloads, quick_verify) against the JAX
package's, on the CPU.

Inputs come from numpy with a seed.  Tolerance: exact equality of every
byte, checksum and coefficient."""
import zlib

import numpy as np
import pytest

from node_fhe_accelerate_tpu import native as jnative
from node_fhe_accelerate_tpu.core import serializer as jser
from node_fhe_accelerate_tpu_torch import native
from node_fhe_accelerate_tpu_torch.core import serializer as ser

BITS = [1, 7, 13, 32, 41, 63, 64]


@pytest.fixture
def fallback(monkeypatch):
    """The pure-Python versions (as without a compiler)."""
    monkeypatch.setattr(native, "_lib", False)


def words_of(bits, n=257, seed=None):
    rng = np.random.default_rng(bits if seed is None else seed)
    mask = np.uint64((1 << bits) - 1) if bits < 64 \
        else np.uint64(0xFFFFFFFFFFFFFFFF)
    return rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 + 1 & mask


def test_library_builds_under_build_dir():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" \
        and path.parent.parent.name == "build"
    assert not list(native._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("use_fallback", [False, True],
                         ids=["native", "python"])
def test_crc32_matches_zlib_and_jax(request, use_fallback):
    if use_fallback:
        request.getfixturevalue("fallback")
    for data in [b"", b"a", b"hello world" * 100, bytes(range(256))]:
        for seed in (0, 12345):
            want = zlib.crc32(data, seed) & 0xFFFFFFFF
            assert native.crc32(data, seed) == want == \
                jnative.crc32(data, seed)


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_match_jax(bits):
    w = words_of(bits)
    packed = native.pack_words(w, bits)
    assert packed == jnative.pack_words(w, bits)
    assert len(packed) == (w.size * bits + 7) // 8
    np.testing.assert_array_equal(native.unpack_words(packed, w.size, bits),
                                  w)
    np.testing.assert_array_equal(jnative.unpack_words(packed, w.size, bits),
                                  w)


@pytest.mark.parametrize("bits", [7, 41, 64])
def test_fallback_pack_unpack_match_native(bits, fallback):
    w = words_of(bits, n=33)
    packed = native.pack_words(w, bits)
    assert packed == jnative.pack_words(w, bits)
    np.testing.assert_array_equal(native.unpack_words(packed, 33, bits), w)


def lz4_inputs():
    rng = np.random.default_rng(3)
    return [b"", b"x", b"abc" * 1000, bytes(range(256)) * 40,
            rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
            np.repeat(rng.integers(0, 4, 300, dtype=np.uint8), 17).tobytes()]


def test_lz4_blocks_cross_decode():
    """The same codec source: identical blocks, and each package decodes
    the other's."""
    for data in lz4_inputs():
        mine, theirs = native.lz4_compress(data), jnative.lz4_compress(data)
        assert mine == theirs
        assert native.lz4_decompress(theirs, len(data)) == data
        assert jnative.lz4_decompress(mine, len(data)) == data
    big = b"abc" * 1000
    assert len(native.lz4_compress(big)) < len(big) // 10


def test_lz4_fallback_round_trips(fallback):
    for data in lz4_inputs():
        block = native.lz4_compress(data)         # literal-only block
        assert native.lz4_decompress(block, len(data)) == data
        assert jnative.lz4_decompress(block, len(data)) == data
    packed = jnative.lz4_compress(b"abc" * 1000)  # a real match sequence
    assert native.lz4_decompress(packed, 3000) == b"abc" * 1000
    with pytest.raises(ValueError):
        native.lz4_decompress(b"\x10x\x00\x00", 10)


def test_lz4_refuses_malformed_blocks():
    with pytest.raises(ValueError):
        native.lz4_decompress(b"\x1fx\xff\xff", 100)


COMPRESSIONS = [ser.CompressionType.NONE, ser.CompressionType.ZLIB,
                ser.CompressionType.LZ4]


@pytest.mark.parametrize("compression", COMPRESSIONS,
                         ids=lambda c: c.name)
@pytest.mark.parametrize("modulus", [0, 7681, (1 << 40) - (1 << 32) + 1])
def test_polynomial_blobs_cross_decode(compression, modulus):
    rng = np.random.default_rng(modulus % 97)
    hi = modulus or (1 << 63)
    for shape in ((1024,), (3, 256)):
        c = rng.integers(0, hi, shape, dtype=np.uint64)
        kw = dict(key_id=3, key_type=2, modulus=modulus,
                  compression=int(compression))
        mine = ser.serialize_polynomial(c, ser.Magic.BALLOT, **kw)
        theirs = jser.serialize_polynomial(c, jser.Magic.BALLOT, **kw)
        assert mine == theirs
        hdr, back = ser.deserialize_polynomial(theirs, ser.Magic.BALLOT)
        np.testing.assert_array_equal(back, c)
        assert (hdr.modulus, hdr.key_id, hdr.poly_degree) == \
            (modulus, 3, shape[-1])
        _, jback = jser.deserialize_polynomial(mine, jser.Magic.BALLOT)
        np.testing.assert_array_equal(jback, c)
        assert ser.quick_verify(mine, ser.Magic.BALLOT).data_size == \
            jser.quick_verify(mine, jser.Magic.BALLOT).data_size


def test_packed_ballot_is_smaller():
    c = np.ones(1024, dtype=np.uint64)
    packed = ser.serialize_polynomial(c, ser.Magic.BALLOT,
                                      modulus=(1 << 40) - (1 << 32) + 1)
    raw = ser.serialize_polynomial(c, ser.Magic.BALLOT)
    assert len(packed) < 0.66 * len(raw)


def test_quick_verify_and_deserialize_refuse_tampering():
    c = np.arange(512, dtype=np.uint64)
    blob = ser.serialize_polynomial(c, ser.Magic.BALLOT, modulus=7681,
                                    compression=ser.CompressionType.LZ4)
    assert ser.quick_verify(blob).magic == ser.Magic.BALLOT
    flipped = bytearray(blob)
    flipped[-5] ^= 0x10
    for fn in (lambda b: ser.quick_verify(b),
               lambda b: jser.quick_verify(b),
               lambda b: ser.deserialize_polynomial(b, ser.Magic.BALLOT)):
        with pytest.raises(ValueError):
            fn(bytes(flipped))
    with pytest.raises(ser.SerializationError):
        ser.quick_verify(blob, ser.Magic.PUBLIC_KEY)
    with pytest.raises(ser.SerializationError):
        ser.quick_verify(blob[:40])
    hdr = ser.SerializationHeader.unpack(blob)
    hdr.checksum_type = ser.ChecksumType.NONE
    with pytest.raises(ser.SerializationError):
        ser.quick_verify(hdr.pack() + blob[len(hdr.pack()):])
    # an LZ4 payload whose block is corrupt but whose checksum matches
    bad = ser.serialize_blob(ser.Magic.BALLOT, b"\x00" * 8 + b"\x05\x00\x00",
                             compression=ser.CompressionType.NONE)
    hdr = ser.SerializationHeader.unpack(bad)
    hdr.compression = ser.CompressionType.LZ4
    with pytest.raises(ser.SerializationError):
        ser.deserialize_blob(hdr.pack() + bad[len(hdr.pack()):],
                             ser.Magic.BALLOT)
