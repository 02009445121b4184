"""Exact 64/128-bit unsigned arithmetic on uint32 limb planes (counterpart
of node_fhe_accelerate_tpu/ops/u64.py).

A value mod 2^64 is a pair of int32 tensors with uint32 bits, as in the
JAX package:

    u64  = (lo, hi)              # value = lo + hi * 2^32
    u128 = (w0, w1, w2, w3)      # value = sum wi * 2^(32 i)

torch has no uint64 arithmetic, its int64 ``>>`` is arithmetic, and a
32x32-bit product overflows int64.  So every public function here takes
and returns int32 planes, and computes on *lanes*: int64 tensors holding
one uint32 limb each, in [0, 2^32).  A lane sum of a few limbs and a
16x32-bit product stay far below 2^63, so nothing overflows and every
shift is on a non-negative value.  The ``_``-prefixed functions work on
lanes and let a caller (ops/modular.py, ops/ntt.py) convert once for a
whole chain; a lane operand may also be a Python int constant.

Every function is elementwise over any leading shape and is tested
against Python ints in tests/test_torch_ntt.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "u64_from_int", "u64_from_np", "u64_to_np", "u128_to_np",
    "addc32", "subb32", "mul32_wide",
    "u64_add", "u64_sub", "u64_lt", "u64_geq", "u64_eq", "u64_select",
    "u64_mul_lo", "u64_mul_wide", "u64_shl", "u64_shr", "u64_and_mask",
    "u64_or", "u64_zeros", "u128_add", "u128_shr", "u128_lo64",
    "u128_from_u64",
]

M32 = 0xFFFFFFFF
M16 = 0xFFFF


# ---------------------------------------------------------------------------
# int32 planes <-> int64 lanes
# ---------------------------------------------------------------------------

def to_lanes(x):
    """int32 plane (uint32 bits) -> int64 lane in [0, 2^32); tuples and
    lists map element by element, other values pass through."""
    if isinstance(x, (tuple, list)):
        return tuple(to_lanes(v) for v in x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32:
        return x.to(torch.int64) & M32
    return x


def to_planes(x):
    """int64 lane -> int32 plane with the same low 32 bits; tuples map
    element by element, bool tensors pass through."""
    if isinstance(x, tuple):
        return tuple(to_planes(v) for v in x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.int64:
        return x.to(torch.int32)
    return x


def _public(fn):
    """The int32-plane form of a lane function."""
    @functools.wraps(fn)
    def wrapper(*args):
        return to_planes(fn(*(to_lanes(a) for a in args)))
    wrapper.__doc__ = (fn.__doc__ or "") + \
        "\n\n    On int32 planes with uint32 bits."
    return wrapper


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def u64_from_int(value: int, shape=(), device=None):
    """Broadcast a Python int (< 2^64) to a u64 limb-plane pair."""
    lo = np.uint32(value & M32).view(np.int32)
    hi = np.uint32((value >> 32) & M32).view(np.int32)
    return (torch.full(tuple(shape), int(lo), dtype=torch.int32,
                       device=device),
            torch.full(tuple(shape), int(hi), dtype=torch.int32,
                       device=device))


def u64_from_np(arr, device=None) -> tuple:
    """numpy uint64 (or object/int) array -> limb planes on ``device``
    (default CPU)."""
    a = np.asarray(arr, dtype=np.uint64)
    lo = (a & np.uint64(M32)).astype(np.uint32).view(np.int32)
    hi = (a >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(lo)).to(device),
            torch.from_numpy(np.ascontiguousarray(hi)).to(device))


def u64_to_np(x) -> np.ndarray:
    """Limb planes -> numpy uint64 array."""
    lo, hi = (t.detach().cpu().contiguous().numpy().view(np.uint32)
              .astype(np.uint64) for t in x)
    return lo | (hi << np.uint64(32))


def u128_to_np(x) -> np.ndarray:
    """4-plane u128 -> numpy object array of Python ints."""
    planes = [t.detach().cpu().numpy().view(np.uint32).astype(np.uint64)
              for t in x]
    out = np.zeros(planes[0].shape, dtype=object)
    for i, p in enumerate(planes):
        out += p.astype(object) << (32 * i)
    return out


# ---------------------------------------------------------------------------
# Lane arithmetic (int64 tensors holding uint32 limbs)
# ---------------------------------------------------------------------------

def _addc(a, b, cin=None):
    """32-bit add with carry: (sum, carry in {0, 1, 2})."""
    s = a + b if cin is None else a + b + cin
    return s & M32, s >> 32


def _subb(a, b, bin_=None):
    """32-bit subtract with borrow: (difference, borrow in {0, 1})."""
    d = a - b if bin_ is None else a - b - bin_
    return d & M32, (d < 0).to(torch.int64)


def _mul_lo32(a, b):
    """(a * b) mod 2^32 through a 16-bit split of b: both partial products
    stay below 2^48."""
    return (a * (b & M16) + (((a * (b >> 16)) & M16) << 16)) & M32


def _mulw(a, b):
    """Exact 32x32 -> 64 multiply: (lo, hi).  b splits into 16-bit halves,
    so each partial product is below 2^48."""
    p0 = a * (b & M16)
    p1 = a * (b >> 16)
    low = p0 + ((p1 & M16) << 16)
    return low & M32, (p1 >> 16) + (low >> 32)


def _add64(a, b):
    lo, c = _addc(a[0], b[0])
    return lo, (a[1] + b[1] + c) & M32


def _sub64(a, b):
    lo, brw = _subb(a[0], b[0])
    return lo, (a[1] - b[1] - brw) & M32


def _lt64(a, b):
    return (a[1] < b[1]) | ((a[1] == b[1]) & (a[0] < b[0]))


def _geq64(a, b):
    return ~_lt64(a, b)


def _eq64(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def _select(pred, a, b):
    return tuple(torch.where(pred, x, y) for x, y in zip(a, b))


def _mul_lo64(a, b):
    """(a * b) mod 2^64."""
    lo, hi = _mulw(a[0], b[0])
    return lo, (hi + _mul_lo32(a[0], b[1]) + _mul_lo32(a[1], b[0])) & M32


def _mul_wide(a, b):
    """Exact 64x64 -> 128 multiply: 4 lanes."""
    p00 = _mulw(a[0], b[0])
    p01 = _mulw(a[0], b[1])
    p10 = _mulw(a[1], b[0])
    p11 = _mulw(a[1], b[1])
    s1 = p00[1] + p01[0] + p10[0]                 # < 3 * 2^32
    s2 = p01[1] + p10[1] + p11[0] + (s1 >> 32)
    return (p00[0], s1 & M32, s2 & M32, (p11[1] + (s2 >> 32)) & M32)


def _shl64(a, k: int):
    """(a << k) mod 2^64 for static k >= 0: zero from k = 64 on, as the
    JAX package's uint32 shifts give (a shift of an int64 lane by 64 or
    more is not defined in torch)."""
    if k == 0:
        return a
    if k >= 64:
        return torch.zeros_like(a[0]), torch.zeros_like(a[1])
    if k >= 32:
        return torch.zeros_like(a[0]), (a[0] << (k - 32)) & M32
    return ((a[0] << k) & M32,
            ((a[1] << k) | (a[0] >> (32 - k))) & M32)


def _shr64(a, k: int):
    """a >> k for static k >= 0: zero from k = 64 on, as the JAX package's
    uint32 shifts give (a shift of an int64 lane by 64 or more is not
    defined in torch)."""
    if k == 0:
        return a
    if k >= 64:
        return torch.zeros_like(a[0]), torch.zeros_like(a[1])
    if k >= 32:
        return a[1] >> (k - 32), torch.zeros_like(a[1])
    return ((a[0] >> k) | (a[1] << (32 - k))) & M32, a[1] >> k


def _and_mask64(a, mask: int):
    return a[0] & (mask & M32), a[1] & ((mask >> 32) & M32)


def _or64(a, b):
    return a[0] | b[0], a[1] | b[1]


def _add128(a, b):
    w0, c = _addc(a[0], b[0])
    w1, c = _addc(a[1], b[1], c)
    w2, c = _addc(a[2], b[2], c)
    return (w0, w1, w2, (a[3] + b[3] + c) & M32)


def _shr128(a, k: int):
    """a >> k for static 0 <= k < 128."""
    word, bit = divmod(k, 32)
    z = torch.zeros_like(a[0])
    shifted = list(a[word:]) + [z] * word
    if bit == 0:
        return tuple(shifted)
    out = []
    for i in range(4):
        hi = ((shifted[i + 1] << (32 - bit)) & M32) if i + 1 < 4 else 0
        out.append((shifted[i] >> bit) | hi)
    return tuple(out)


def _shl128(a, k: int):
    """(a << k) mod 2^128 for static 0 <= k < 128."""
    if k == 0:
        return a
    word, bit = divmod(k, 32)
    z = torch.zeros_like(a[0])
    planes = [z] * word + list(a[:4 - word])
    if bit == 0:
        return tuple(planes)
    out, prev = [], z
    for p in planes:
        out.append(((p << bit) & M32) | (prev >> (32 - bit)))
        prev = p
    return tuple(out)


def _sub128(a, b):
    w0, brw = _subb(a[0], b[0])
    w1, brw = _subb(a[1], b[1], brw)
    w2, brw = _subb(a[2], b[2], brw)
    return (w0, w1, w2, (a[3] - b[3] - brw) & M32)


def _and_mask128(a, mask: int):
    return tuple(a[i] & ((mask >> (32 * i)) & M32) for i in range(4))


# ---------------------------------------------------------------------------
# Public functions on int32 planes
# ---------------------------------------------------------------------------

addc32 = _public(_addc)
subb32 = _public(_subb)
mul32_wide = _public(_mulw)
u64_add = _public(_add64)
u64_sub = _public(_sub64)
u64_lt = _public(_lt64)
u64_geq = _public(_geq64)
u64_eq = _public(_eq64)
u64_mul_lo = _public(_mul_lo64)
u64_mul_wide = _public(_mul_wide)
u64_shl = _public(_shl64)
u64_shr = _public(_shr64)
u64_and_mask = _public(_and_mask64)
u64_or = _public(_or64)
u128_add = _public(_add128)
u128_shr = _public(_shr128)


def u64_select(pred, a, b):
    """where(pred, a, b) on limb planes; pred is bool, broadcastable."""
    return _select(pred, a, b)


def u64_zeros(shape=(), device=None):
    z = torch.zeros(tuple(shape), dtype=torch.int32, device=device)
    return (z, z)


def u128_lo64(a):
    return (a[0], a[1])


def u128_from_u64(a):
    z = torch.zeros_like(a[0])
    return (a[0], a[1], z, z)
