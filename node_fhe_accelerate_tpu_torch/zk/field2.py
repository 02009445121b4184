"""Quadratic extension field Fq2 = Fq[u]/(u^2 + 1) on digit planes
(counterpart of node_fhe_accelerate_tpu/zk/field2.py).

An Fq2 element is the CONCATENATION of its two Fq components' digit planes
along the trailing axis, so shape-level code (batching, padding, gathers,
rolls in the Pippenger scan) is oblivious to the extension; only the
arithmetic knows.  Every op lifts componentwise (add/sub/neg/select/eq/
is_zero) or by Karatsuba over the base field (mul: 3 base muls since
u^2 = -1; square: 2), so on the card it reaches K10 through the base field.

Both supported towers use u^2 = -1 (BN254 and BLS12-381).
"""
from __future__ import annotations

import torch

from .field import Field, bls12_381_fq, bn254_fq

__all__ = ["Field2", "bn254_fq2", "bls12_381_fq2"]


class Field2:
    """Fq2 on 8-bit digit lanes; elements are (..., 2*L) int32 planes in
    componentwise Montgomery form (Montgomery scaling is Fq-linear, so the
    base reduction applies per component)."""

    def __init__(self, base: Field):
        self.base = base
        self.device = base.device
        self.q = base.q
        self.n_limbs = 2 * base.n_limbs
        self.one_mont = torch.cat([base.one_mont, base.zero])
        self.zero = torch.cat([base.zero, base.zero])

    # -- component plumbing ----------------------------------------------------
    def _split(self, a):
        L = self.base.n_limbs
        return a[..., :L], a[..., L:]

    def _join(self, c0, c1):
        return torch.cat([c0, c1], dim=-1)

    @staticmethod
    def _pair(v) -> tuple:
        """Accept ints, (a0, a1) tuples, or FQ2-like objects with .coeffs."""
        if isinstance(v, (tuple, list)):
            return int(v[0]), int(v[1])
        if hasattr(v, "coeffs"):
            return int(v.coeffs[0]), int(v.coeffs[1])
        return int(v), 0

    # -- host conversions -------------------------------------------------------
    def encode(self, values):
        pairs = [self._pair(v) for v in values]
        c0 = self.base.encode([p[0] for p in pairs])
        c1 = self.base.encode([p[1] for p in pairs])
        return self._join(c0, c1)

    def decode(self, arr):
        """Montgomery planes -> (c0_ints, c1_ints) object arrays."""
        a0, a1 = self._split(arr)
        return self.base.decode(a0), self.base.decode(a1)

    # -- ring ops ----------------------------------------------------------------
    def add(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        return self._join(self.base.add(a0, b0), self.base.add(a1, b1))

    def sub(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        return self._join(self.base.sub(a0, b0), self.base.sub(a1, b1))

    def neg(self, a):
        a0, a1 = self._split(a)
        return self._join(self.base.neg(a0), self.base.neg(a1))

    def mul(self, a, b):
        """(a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + ((a0+a1)(b0+b1)
        - a0 b0 - a1 b1) u -- Karatsuba, 3 base Montgomery muls."""
        f = self.base
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        v0 = f.mul(a0, b0)
        v1 = f.mul(a1, b1)
        c0 = f.sub(v0, v1)
        t = f.mul(f.add(a0, a1), f.add(b0, b1))
        c1 = f.sub(f.sub(t, v0), v1)
        return self._join(c0, c1)

    def square(self, a):
        """(a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u -- 2 base muls."""
        f = self.base
        a0, a1 = self._split(a)
        c0 = f.mul(f.add(a0, a1), f.sub(a0, a1))
        m = f.mul(a0, a1)
        return self._join(c0, f.add(m, m))

    def inv(self, a):
        """Conjugate over norm: (a0 - a1 u) / (a0^2 + a1^2)."""
        f = self.base
        a0, a1 = self._split(a)
        norm = f.add(f.square(a0), f.square(a1))
        ninv = f.inv(norm)
        return self._join(f.mul(a0, ninv), f.neg(f.mul(a1, ninv)))

    # -- predicates ----------------------------------------------------------------
    def is_zero(self, a):
        a0, a1 = self._split(a)
        return self.base.is_zero(a0) & self.base.is_zero(a1)

    def eq(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        return self.base.eq(a0, b0) & self.base.eq(a1, b1)

    def select(self, pred, a, b):
        return self.base.select(pred, a, b)


def bn254_fq2(device=None) -> Field2:
    return Field2(bn254_fq(device))


def bls12_381_fq2(device=None) -> Field2:
    return Field2(bls12_381_fq(device))
