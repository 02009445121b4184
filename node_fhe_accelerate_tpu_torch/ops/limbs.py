"""Generic multi-limb big-integer arithmetic on uint32 limbs (counterpart
of node_fhe_accelerate_tpu/ops/limbs.py).

A value is an int32 tensor with uint32 bits and a trailing limb axis of
length L, little-endian: value = sum a[..., i] * 2^(32 i).  Batch axes lead.
torch has no uint32 arithmetic, so every function computes on int64 lanes
holding one limb each (``ops/u64.py``) and returns int32 planes; carries,
borrows and predicates come back as int32 / bool tensors.

Montgomery multiplication is CIOS (coarsely integrated operand scanning),
the algorithm of the JAX package's ``mont_mul``, with R = 2^(32L).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .u64 import M32, _addc, _mul_lo32, _mulw, _subb, to_lanes, to_planes

__all__ = [
    "limbs_from_int", "limbs_to_int", "limbs_from_ints", "limbs_to_ints",
    "add", "add_mod", "sub_mod", "neg_mod", "geq", "select", "is_zero",
    "mont_mul", "mont_constants",
]


# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------


def limbs_from_int(value: int, n_limbs: int, shape=(), device=None):
    """A Python int broadcast to (*shape, n_limbs) uint32 limbs (mod
    2^(32 n_limbs)), as an int32 tensor."""
    out = np.empty(tuple(shape) + (n_limbs,), dtype=np.uint32)
    for i in range(n_limbs):
        out[..., i] = (value >> (32 * i)) & M32
    return torch.from_numpy(out.view(np.int32)).to(resolve_device(device))


def limbs_to_int(arr) -> int:
    a = _u32(arr).astype(np.uint64)
    return sum(int(a[..., i]) << (32 * i) for i in range(a.shape[-1]))


def limbs_from_ints(values, n_limbs: int, device=None):
    """Array of Python ints -> (..., L) limbs (each value mod 2^(32L)):
    one ``int.to_bytes`` per value and a single ``frombuffer``."""
    values = np.asarray(values, dtype=object)
    nbytes = 4 * n_limbs
    mod = 1 << (32 * n_limbs)
    buf = b"".join((int(v) % mod).to_bytes(nbytes, "little")
                   for v in values.reshape(-1).tolist())
    arr = np.frombuffer(buf, dtype="<u4").reshape(
        values.shape + (n_limbs,)).view(np.int32).copy()
    return torch.from_numpy(arr).to(resolve_device(device))


def limbs_to_ints(arr) -> np.ndarray:
    a = _u32(arr).astype(np.uint64)
    out = np.zeros(a.shape[:-1], dtype=object)
    for i in range(a.shape[-1]):
        out += a[..., i].astype(object) << (32 * i)
    return out


def _u32(arr) -> np.ndarray:
    """int32 tensor (uint32 bits) or uint32 array-like -> numpy uint32."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(arr, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Multi-limb ops on lanes (static L from the trailing axis)
# ---------------------------------------------------------------------------


def _add_lanes(a, b):
    """(a + b) mod 2^(32L) on lanes: (limb list, carry lane)."""
    outs, c = [], None
    for i in range(a.shape[-1]):
        s, c = _addc(a[..., i], b[..., i], c)
        outs.append(s)
    return outs, c


def _sub_lanes(a, b):
    """(a - b) mod 2^(32L) on lanes: (limb list, borrow lane)."""
    outs, brw = [], None
    for i in range(a.shape[-1]):
        d, brw = _subb(a[..., i], b[..., i], brw)
        outs.append(d)
    return outs, brw


def _stack(limbs):
    return to_planes(torch.stack(limbs, dim=-1))


def add(a, b):
    """(a + b) mod 2^(32L); returns (sum, carry_out)."""
    s, c = _add_lanes(to_lanes(a), to_lanes(b))
    return _stack(s), c.to(torch.int32)


def geq(a, b):
    """a >= b elementwise over the limb axis."""
    _, brw = _sub_lanes(to_lanes(a), to_lanes(b))
    return brw == 0


def is_zero(a):
    return (a == 0).all(dim=-1)


def select(pred, a, b):
    return torch.where(pred[..., None], a, b)


def add_mod(a, b, q):
    """(a + b) mod q for a, b < q < 2^(32L - 1) (no carry out of L limbs)."""
    s, _ = _add_lanes(to_lanes(a), to_lanes(b))
    s = torch.stack(s, dim=-1)
    d, brw = _sub_lanes(s, to_lanes(q).expand_as(s))
    return to_planes(torch.where((brw == 0)[..., None],
                                 torch.stack(d, dim=-1), s))


def sub_mod(a, b, q):
    d, brw = _sub_lanes(to_lanes(a), to_lanes(b))
    d = torch.stack(d, dim=-1)
    dq, _ = _add_lanes(d, to_lanes(q).expand_as(d))
    return to_planes(torch.where((brw != 0)[..., None],
                                 torch.stack(dq, dim=-1), d))


def neg_mod(a, q):
    al = to_lanes(a)
    d, _ = _sub_lanes(to_lanes(q).expand_as(al), al)
    return torch.where(is_zero(a)[..., None], a, _stack(d))


# ---------------------------------------------------------------------------
# Montgomery multiplication (CIOS)
# ---------------------------------------------------------------------------


def mont_constants(q: int, n_limbs: int) -> dict:
    """Precompute R, R^2 mod q and -q^{-1} mod 2^32 for CIOS."""
    R = 1 << (32 * n_limbs)
    return {
        "q": q,
        "n_limbs": n_limbs,
        "r_mod_q": R % q,
        "r2_mod_q": (R * R) % q,
        "q_inv32": (-pow(q, -1, 1 << 32)) % (1 << 32),
    }


def mont_mul(a, b, q_limbs, q_inv32: int):
    """CIOS Montgomery product a*b*R^{-1} mod q on (..., L) limbs, the
    word-by-word interleaved reduction of the JAX package; t is held as
    L + 2 lanes."""
    a, b = torch.broadcast_tensors(to_lanes(a), to_lanes(b))
    ql = to_lanes(q_limbs)
    L = a.shape[-1]
    zeros = torch.zeros_like(a[..., 0])
    t = [zeros] * (L + 2)
    for i in range(L):
        ai = a[..., i]
        carry = zeros
        for j in range(L):                    # t += ai * b
            lo, hi = _mulw(ai, b[..., j])
            t[j], c1 = _addc(t[j], lo, carry)
            carry = hi + c1                   # < 2^32: hi <= 2^32 - 2
        t[L], c1 = _addc(t[L], carry)
        t[L + 1] = t[L + 1] + c1
        m = _mul_lo32(t[0], q_inv32)          # t0 * q' mod 2^32
        lo, hi = _mulw(m, ql[..., 0])         # t += m * q, shift one limb
        _, c1 = _addc(t[0], lo)
        carry = hi + c1
        for j in range(1, L):
            lo, hi = _mulw(m, ql[..., j])
            t[j - 1], c1 = _addc(t[j], lo, carry)
            carry = hi + c1
        t[L - 1], c1 = _addc(t[L], carry)
        t[L] = t[L + 1] + c1
        t[L + 1] = zeros
    res = torch.stack(t[:L], dim=-1)
    # conditional subtract: the result is in [0, 2q); t[L] holds overflow
    d, brw = _sub_lanes(res, ql.expand_as(res))
    need_sub = (t[L] != 0) | (brw == 0)
    return to_planes(torch.where(need_sub[..., None],
                                 torch.stack(d, dim=-1), res))
