"""Native host-side codec (C++ via ctypes) with a pure-Python fallback
(counterpart of node_fhe_accelerate_tpu/native/__init__.py).

``codec.cpp`` (the port's own copy) is built with ``g++`` at first use into
``build/native/codec_<tag>.so`` under the repository root (listed in
.gitignore), the tag hashing the source, so the package directory stays
clean and a changed source never loads a stale library.  Without a
compiler the pure-Python versions are used; both give the same bytes
(tests/test_torch_native.py holds them against each other and against the
JAX package).

Buffers passed to the native packer carry 8 bytes of slack: the C fast path
writes and reads whole u64 windows (see codec.cpp); the wrappers here own
that contract so callers never see it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import zlib
from pathlib import Path

import numpy as np

__all__ = ["crc32", "pack_words", "unpack_words", "native_available",
           "lz4_compress", "lz4_decompress", "library_path"]

_SRC = Path(__file__).resolve().parent / "codec.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None


def library_path() -> Path:
    """Where the shared library of the current ``codec.cpp`` is built."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"codec_{tag}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        so = library_path()
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                            str(_SRC)], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.nfa_crc32.restype = ctypes.c_uint32
        lib.nfa_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_uint32]
        lib.nfa_pack_words.restype = ctypes.c_size_t
        lib.nfa_pack_words.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)]
        lib.nfa_unpack_words.restype = None
        lib.nfa_unpack_words.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64)]
        lib.nfa_lz4_compress.restype = ctypes.c_size_t
        lib.nfa_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        lib.nfa_lz4_decompress.restype = ctypes.c_int
        lib.nfa_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        _lib = False
    return _lib


def native_available() -> bool:
    return bool(_load())


def crc32(data: bytes, seed: int = 0) -> int:
    lib = _load()
    if lib:
        return int(lib.nfa_crc32(data, len(data), seed))
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def pack_words(words: np.ndarray, bits: int) -> bytes:
    """Pack u64 words to ``bits`` bits each, little-endian bit order."""
    w = np.ascontiguousarray(words, dtype=np.uint64)
    n = w.size
    out_len = (n * bits + 7) // 8
    lib = _load()
    if lib:
        buf = (ctypes.c_uint8 * (out_len + 8))()
        lib.nfa_pack_words(
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, bits, buf)
        return bytes(buf[:out_len])
    acc = 0
    for i, v in enumerate(w.tolist()):
        acc |= (int(v) & ((1 << bits) - 1)) << (i * bits)
    return acc.to_bytes(out_len, "little")


def unpack_words(data: bytes, n: int, bits: int) -> np.ndarray:
    lib = _load()
    if lib:
        padded = (ctypes.c_uint8 * (len(data) + 8)).from_buffer_copy(
            data + b"\0" * 8)
        out = np.empty(n, dtype=np.uint64)
        lib.nfa_unpack_words(
            padded, n, bits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out
    acc = int.from_bytes(data, "little")
    mask = (1 << bits) - 1
    return np.array([(acc >> (i * bits)) & mask for i in range(n)],
                    dtype=np.uint64)


def _literal_block(data: bytes) -> bytes:
    """One valid LZ4 sequence holding all of ``data`` as literals."""
    out = bytearray()
    lit = len(data)
    if lit >= 15:
        out.append(15 << 4)
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    else:
        out.append(lit << 4)
    out += data
    return bytes(out)


def lz4_compress(data: bytes) -> bytes:
    """LZ4 block-format compression (native codec.cpp; the pure-Python
    fallback emits a valid literal-only block: stored, not compressed)."""
    lib = _load()
    if lib and data:
        cap = len(data) + len(data) // 255 + 32
        buf = (ctypes.c_uint8 * cap)()
        out_n = lib.nfa_lz4_compress(data, len(data), buf, cap)
        if out_n:
            return bytes(buf[:out_n])
    return _literal_block(data)


def _lz4_decompress_py(data: bytes, out_n: int) -> bytes:
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        token = data[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = data[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        out += data[ip:ip + lit]
        ip += lit
        if ip >= n:
            break
        offset = data[ip] | (data[ip + 1] << 8)
        ip += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = data[ip]
                ip += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        if offset == 0 or offset > len(out):
            raise ValueError("malformed LZ4 block")
        for _ in range(ml):
            out.append(out[-offset])
    if len(out) != out_n:
        raise ValueError("LZ4 size mismatch")
    return bytes(out)


def lz4_decompress(data: bytes, out_n: int) -> bytes:
    lib = _load()
    if lib:
        buf = (ctypes.c_uint8 * max(out_n, 1))()
        rc = lib.nfa_lz4_decompress(data, len(data), buf, out_n)
        if rc != 0:
            raise ValueError("malformed LZ4 block")
        return bytes(buf[:out_n])
    try:
        return _lz4_decompress_py(data, out_n)
    except IndexError as exc:
        raise ValueError("malformed LZ4 block") from exc
