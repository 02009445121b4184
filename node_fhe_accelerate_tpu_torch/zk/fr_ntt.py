"""Negacyclic NTT over a ZK scalar field (BN254/BLS12-381 Fr digit planes)
(counterpart of node_fhe_accelerate_tpu/zk/fr_ntt.py).

Polynomial interpolation, evaluation and multiplication over Fr for the
Groth16 and PLONK provers, on 8-bit digit-plane field elements
(zk/field.py), with the reshape-stage NTT of ops/ntt.py: each stage is one
``Field.mul`` of the odd half by its twiddles -- on a CUDA tensor one launch
of K10's product (``pallas_field_mul``) -- plus the digit adds and subtracts
of the butterflies.

Domain design: interpolate over the *negacyclic* points x_j = psi^(2j+1),
the roots of x^d + 1 (psi = primitive 2d-th root of unity; BN254 Fr has
2-adicity 28, so any d <= 2^27 works).  Then:

  - the vanishing polynomial is t(x) = x^d + 1 (free to evaluate),
  - Lagrange-at-tau has the closed form
        L_j(tau) = (tau^d + 1) * x_j * (-1/d) / (tau - x_j),
  - and the QAP quotient h = (A*B - C)/t is simply the UPPER HALF of the
    full 2d-wide product A*B:  A*B = t*h + (A*B mod t), and (A*B mod t)
    equals C identically whenever the witness satisfies the constraints.

The ``*_ints`` methods run the same algorithm on host big ints (numpy
object arrays), the twins the JAX package takes on its CPU backend.
"""
from __future__ import annotations

import numpy as np
import torch

from .field import Field

__all__ = ["FrNtt"]


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


class FrNtt:
    """Forward/inverse negacyclic NTT of size d over `field`, on digit
    planes of shape (..., d, L) on the field's device.  Natural-order
    coefficient <-> evaluation maps, with evaluations indexed by the point
    list `self.points` (points[j] = psi^(2j+1))."""

    def __init__(self, field: Field, d: int):
        if d & (d - 1) or d < 2:
            raise ValueError("d must be a power of two >= 2")
        r = field.q
        two_adicity = (r - 1 & -(r - 1)).bit_length() - 1
        if d > 1 << (two_adicity - 1):
            raise ValueError(f"domain size {d} exceeds field 2-adicity")
        self.f = field
        self.d = d
        self.logd = d.bit_length() - 1

        # primitive 2d-th root: g^((r-1)/2d) for a generator g of Fr*;
        # search a few small candidates and verify the order
        psi = None
        for g in (5, 7, 3, 10, 13, 17):
            cand = pow(g, (r - 1) // (2 * d), r)
            if pow(cand, d, r) == r - 1:
                psi = cand
                break
        if psi is None:
            raise ValueError("no primitive 2d-th root found")
        self.psi = psi
        self.psi_inv = pow(psi, -1, r)
        self.d_inv = pow(d, -1, r)
        self.points = [pow(psi, 2 * j + 1, r) for j in range(d)]

        # Longa-Naehrig bit-reversed twiddle tables, Montgomery-encoded
        logd = self.logd
        psis = [pow(psi, _bit_reverse(j, logd), r) for j in range(d)]
        ipsis = [pow(self.psi_inv, _bit_reverse(j, logd), r)
                 for j in range(d)]
        self._fwd_tw = [self._enc2(psis[1 << s: 2 << s])
                        for s in range(logd)]
        self._inv_tw = [self._enc2(ipsis[d >> (s + 1): d >> s])
                        for s in range(logd)]
        self._d_inv_c = field.encode([self.d_inv])[0]
        # natural <-> bit-reversed placement (an involution)
        self._brev_np = np.array([_bit_reverse(j, logd) for j in range(d)],
                                 np.int64)
        self._brev = torch.from_numpy(self._brev_np).to(field.device)
        # integer twiddles for the host big-int twins
        self._fwd_tw_int = [np.array(psis[1 << s: 2 << s], dtype=object)
                            for s in range(logd)]
        self._inv_tw_int = [
            np.array(ipsis[d >> (s + 1): d >> s], dtype=object)
            for s in range(logd)]

    def _enc2(self, vals):
        """(m,) ints -> (m, 1, L) Montgomery planes for broadcast over t."""
        return self.f.encode(list(vals))[:, None, :]

    # -- transforms (Field ops; one Field.mul a stage) ------------------------
    def forward(self, a):
        """(..., d, L) natural coeffs -> bit-reversed evaluations."""
        f, d = self.f, self.d
        batch = tuple(a.shape[:-2])
        L = a.shape[-1]
        for s in range(self.logd):
            m = 1 << s
            t = d >> (s + 1)
            r = a.reshape(batch + (m, 2, t, L))
            u, v = r[..., 0, :, :], r[..., 1, :, :]
            wv = f.mul(v, self._fwd_tw[s])
            a = torch.stack([f.add(u, wv), f.sub(u, wv)], dim=-3)
            a = a.reshape(batch + (d, L))
        return a

    def inverse(self, a):
        """bit-reversed evaluations -> natural coeffs (scaled by d^-1)."""
        f, d = self.f, self.d
        batch = tuple(a.shape[:-2])
        L = a.shape[-1]
        for s in range(self.logd):
            t = 1 << s
            m = d >> (s + 1)
            r = a.reshape(batch + (m, 2, t, L))
            u, v = r[..., 0, :, :], r[..., 1, :, :]
            top = f.add(u, v)
            bot = f.mul(f.sub(u, v), self._inv_tw[s])
            a = torch.stack([top, bot], dim=-3)
            a = a.reshape(batch + (d, L))
        return f.mul(a, self._d_inv_c)

    # -- natural-order helpers ----------------------------------------------
    def evaluate(self, coeffs):
        """coeffs (..., d, L) -> evals (..., d, L), evals[j] = p(points[j])."""
        return self.forward(coeffs).index_select(-2, self._brev)

    def interpolate(self, evals):
        """evals[j] = p(points[j]) -> coefficient form."""
        return self.inverse(evals.index_select(-2, self._brev))

    def negacyclic_mul(self, a, b):
        """a * b mod (x^d + 1), coefficient in/out."""
        fa = self.forward(a)
        fb = self.forward(b)
        return self.inverse(self.f.mul(fa, fb))

    # -- host big-int twins (same algorithm over numpy object arrays) --------
    def forward_ints(self, a):
        """(d,) object ints, natural coeffs -> bit-reversed evaluations."""
        q, d = self.f.q, self.d
        a = np.asarray(a, dtype=object)
        for s in range(self.logd):
            m = 1 << s
            t = d >> (s + 1)
            r = a.reshape(m, 2, t)
            u, v = r[:, 0, :], r[:, 1, :]
            wv = v * self._fwd_tw_int[s][:, None] % q
            a = np.stack([(u + wv) % q, (u - wv) % q], axis=1).reshape(d)
        return a

    def inverse_ints(self, a):
        """bit-reversed evaluations -> natural coeffs."""
        q, d = self.f.q, self.d
        a = np.asarray(a, dtype=object)
        for s in range(self.logd):
            t = 1 << s
            m = d >> (s + 1)
            r = a.reshape(m, 2, t)
            u, v = r[:, 0, :], r[:, 1, :]
            top = (u + v) % q
            bot = (u - v) * self._inv_tw_int[s][:, None] % q
            a = np.stack([top, bot], axis=1).reshape(d)
        return a * self.d_inv % q

    def evaluate_ints(self, coeffs):
        return self.forward_ints(coeffs)[self._brev_np]

    def interpolate_ints(self, evals):
        return self.inverse_ints(np.asarray(evals, object)[self._brev_np])

    def negacyclic_mul_ints(self, a, b):
        fa = self.forward_ints(a)
        fb = self.forward_ints(b)
        return self.inverse_ints(fa * fb % self.f.q)
