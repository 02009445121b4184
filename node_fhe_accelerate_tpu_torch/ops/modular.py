"""Modular arithmetic over Z_q (q < 2^63) on uint32 limb planes
(counterpart of node_fhe_accelerate_tpu/ops/modular.py).

The same three reductions as the JAX package, chosen once per modulus:

* **Solinas**, q = 2^k - 2^m + 1: a 128-bit product folds with
  shift/multiply-by-(2^m-1)/add rounds (every NTT prime of the bootstrap:
  P1, P2, P_EXT);
* **Fermat**, q = 2^e + 1: alternating chunk sums;
* **Montgomery** with R = 2^64 for any other odd q, and as the plain
  product through two Montgomery passes.

Every result is the canonical residue in [0, q), so any exact reduction
gives the same bits: the CUDA kernels (csrc/ntt.cu) use native 64-bit
Montgomery arithmetic and still agree with this module bit for bit.

Public methods take and return int32 limb planes (uint32 bits); the
``_``-prefixed methods compute on int64 lanes (ops/u64.py) so that a chain
of operations converts once.
"""
from __future__ import annotations

import numpy as np
import torch

from .u64 import (
    M32, _add128, _add64, _and_mask128, _and_mask64, _geq64, _lt64,
    _mul_lo64, _mul_wide, _select, _shl128, _shl64, _shr128, _shr64,
    _sub128, _sub64, to_lanes, to_planes, u64_from_int,
    u64_from_np, u64_to_np,
)

__all__ = ["ModCtx", "solinas_form", "fermat_form", "mod_mul_np",
           "u64_from_int", "u64_from_np", "u64_to_np"]


def solinas_form(q: int):
    """Return (k, m) if q == 2^k - 2^m + 1 with 0 < m <= k - 8, else None.

    The k - m >= 8 guard keeps the reduction loop short (each round removes
    k - m bits); moduli that fail it fall back to Fermat or Montgomery."""
    for k in range(2, 64):
        rest = (1 << k) + 1 - q
        if rest <= 1:
            continue
        if rest & (rest - 1) == 0:  # power of two
            m = rest.bit_length() - 1
            if 0 < m <= k - 8 and (1 << k) - (1 << m) + 1 == q:
                return (k, m)
    return None


def fermat_form(q: int):
    """Return e if q == 2^e + 1 (so 2^e == -1 mod q), else None."""
    e = (q - 1).bit_length() - 1
    return e if (1 << e) + 1 == q else None


def _lanes_of(value: int):
    """A Python int < 2^64 as two Python-int lanes."""
    return (value & M32, (value >> 32) & M32)


class ModCtx:
    """Precomputed context for arithmetic mod a fixed odd q < 2^63; the
    reduction strategy is chosen once at construction."""

    def __init__(self, q: int):
        if q % 2 == 0 or not (2 < q < (1 << 63)):
            raise ValueError("q must be odd and in (2, 2^63)")
        self.q = q
        self.solinas = solinas_form(q)
        self.fermat = fermat_form(q)
        # Montgomery constants, R = 2^64
        self.r_mod_q = (1 << 64) % q
        self.r2_mod_q = pow(self.r_mod_q, 2, q)
        self.q_inv_neg = (-pow(q, -1, 1 << 64)) % (1 << 64)  # -q^-1 mod 2^64
        self._q = _lanes_of(q)

    @property
    def qp(self):
        """q as a pair of int32 planes (0-d, CPU)."""
        return u64_from_int(self.q)

    # -- lanes ---------------------------------------------------------------
    def _add(self, a, b):
        s = _add64(a, b)
        return _select(_geq64(s, self._q), _sub64(s, self._q), s)

    def _sub(self, a, b):
        d = _sub64(a, b)
        return _select(_lt64(a, b), _add64(d, self._q), d)

    def _neg(self, a):
        d = _sub64((torch.full_like(a[0], self._q[0]),
                    torch.full_like(a[1], self._q[1])), a)
        is_zero = (a[0] == 0) & (a[1] == 0)
        return _select(is_zero, (a[0], a[1]), d)

    def _reduce_128(self, t):
        if self.fermat is not None:
            return self._fermat_reduce(t)
        if self.solinas is not None:
            return self._solinas_reduce(t)
        return self._mont_plain_reduce(t)

    def _final(self, y):
        return _select(_geq64(y, self._q), _sub64(y, self._q), y)

    def _fermat_reduce(self, t):
        """Reduce mod q = 2^e + 1 using 2^e = -1: alternating chunk sums."""
        e, q = self.fermat, self.q
        mask = (1 << e) - 1
        n_chunks = (126 + e - 1) // e
        z = torch.zeros_like(t[0])
        pos = neg = (z, z)
        n_neg = 0
        for i in range(n_chunks):
            chunk = _shr128(t, e * i)[:2] if i else t[:2]
            chunk = _and_mask64(chunk, mask)
            if i % 2 == 0:
                pos = _add64(pos, chunk)
            else:
                neg = _add64(neg, chunk)
                n_neg += 1
        # acc = pos - neg + n_neg*q  (non-negative since q > 2^e > any chunk)
        y = _add64(_sub64(pos, neg), _lanes_of(n_neg * q))
        bound = ((n_chunks + 1) // 2) * mask + n_neg * q  # static bound
        assert bound < (1 << 64)
        # fold y = (y & mask) + k*q - (y >> e) until the bound is below 2q
        while bound >= 2 * q:
            k_mult = (bound >> e) // q + 1
            hi = _shr64(y, e)
            lo = _and_mask64(y, mask)
            y = _sub64(_add64(lo, _lanes_of(k_mult * q)), hi)
            new_bound = mask + k_mult * q
            assert new_bound < bound, "fermat fold must converge"
            bound = new_bound
        return self._final(y)

    def _solinas_reduce(self, t):
        k, m = self.solinas
        bound = 1 << 126      # a static upper bound: emit just enough rounds
        factor = (1 << m) - 1
        lo_mask = (1 << k) - 1
        x = t
        while bound >= (1 << 64):
            hi = _shr128(x, k)
            lo = _and_mask128(x, lo_mask)
            # x' = hi * (2^m - 1) + lo = (hi << m) - hi + lo
            x = _add128(_sub128(_shl128(hi, m), hi), lo)
            bound = (bound >> k) * factor + lo_mask + 1
        y = x[:2]             # the value now fits in 64 bits
        while bound > 2 * self.q:
            hi = _shr64(y, k)
            lo = _and_mask64(y, lo_mask)
            y = _add64(_sub64(_shl64(hi, m), hi), lo)
            bound = (bound >> k) * factor + lo_mask + 1
        return self._final(y)

    def _mont_reduce(self, t):
        """t * R^-1 mod q for t < q * 2^64."""
        m = _mul_lo64(t[:2], _lanes_of(self.q_inv_neg))
        s = _add128(t, _mul_wide(m, self._q))
        return self._final((s[2], s[3]))   # the low 64 bits are zero

    def _mont_plain_reduce(self, t):
        """t mod q for t < 2^126: mont(mont(t) * R^2)."""
        t1 = self._mont_reduce(t)
        return self._mont_reduce(_mul_wide(t1, _lanes_of(self.r2_mod_q)))

    def _mul(self, a, b):
        return self._reduce_128(_mul_wide(a, b))

    def _mont_mul(self, a, b):
        return self._mont_reduce(_mul_wide(a, b))

    # -- int32 planes ----------------------------------------------------------
    def add(self, a, b):
        """(a + b) mod q; inputs must be < q."""
        return to_planes(self._add(to_lanes(a), to_lanes(b)))

    def sub(self, a, b):
        """(a - b) mod q; inputs must be < q."""
        return to_planes(self._sub(to_lanes(a), to_lanes(b)))

    def neg(self, a):
        """(-a) mod q; input must be < q."""
        return to_planes(self._neg(to_lanes(a)))

    def reduce_128(self, t):
        """Reduce a 4-plane u128 (< 2^126) to its canonical residue."""
        return to_planes(self._reduce_128(to_lanes(t)))

    def mul(self, a, b):
        """Plain (a * b) mod q; inputs must be < q."""
        return to_planes(self._mul(to_lanes(a), to_lanes(b)))

    def mont_mul(self, a, b):
        """Montgomery product a * b * R^-1 mod q."""
        return to_planes(self._mont_mul(to_lanes(a), to_lanes(b)))

    def to_mont(self, a):
        return to_planes(self._mont_mul(to_lanes(a),
                                        _lanes_of(self.r2_mod_q)))

    def from_mont(self, a):
        a = to_lanes(a)
        z = torch.zeros_like(a[0])
        return to_planes(self._mont_reduce((a[0], a[1], z, z)))

    # -- host-side helpers -----------------------------------------------------
    def pow_host(self, base: int, exp: int) -> int:
        return pow(base, exp, self.q)

    def inv_host(self, a: int) -> int:
        return pow(a, -1, self.q)


def mod_mul_np(a, b, q: int):
    """Host oracle: elementwise (a*b) mod q on numpy uint64 via Python ints."""
    a = np.asarray(a, dtype=np.uint64).astype(object)
    b = np.asarray(b, dtype=np.uint64).astype(object)
    return ((a * b) % q).astype(np.uint64)
