"""Negacyclic NTT/INTT over Z_q[X]/(X^N+1) on uint32 limb planes
(counterpart of node_fhe_accelerate_tpu/ops/ntt.py).

The merged-twiddle negacyclic transform of the JAX package: forward
Cooley-Tukey with psi^bitrev twiddles (natural order in, bit-reversed out),
inverse Gentleman-Sande (bit-reversed in, natural out) and the N^-1 scale,
so that

    inverse(forward(a) * forward(b)) == a * b  mod (X^N + 1, q)

bit for bit.  No bit-reversal permutation is ever applied: the CT/GS
pairing absorbs it.  Each stage is a reshape to (..., m, 2, t) and one
elementwise Montgomery product against twiddles pre-scaled by R = 2^64, so
values stay in the plain domain.

This is the plain PyTorch version of the kernels of ops/ntt_pallas.py
(csrc/ntt.cu), on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from .modular import ModCtx
from .u64 import to_lanes, to_planes, u64_from_np, u64_to_np

__all__ = ["NTTContext", "find_primitive_2n_root", "negacyclic_mul_np"]


def find_primitive_2n_root(degree: int, q: int) -> int:
    """psi = g^((q-1)/2N) with psi^N == -1 mod q, searched in the
    reference's order with primality validation and a bounded search
    (ops/primes.py)."""
    from .primes import find_generator_2n

    return find_generator_2n(degree, q)


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


class NTTContext:
    """Twiddle tables and the forward/inverse transforms for one (N, q).

    All transforms take limb-plane pairs (int32 lo, hi) of shape (..., N)
    on any device and return the same."""

    def __init__(self, degree: int, q: int, psi: int | None = None):
        if degree & (degree - 1) or degree < 4:
            raise ValueError("degree must be a power of two >= 4")
        self.n = degree
        self.logn = degree.bit_length() - 1
        self.q = q
        self.ctx = ModCtx(q)
        self.psi = psi if psi is not None else find_primitive_2n_root(degree, q)
        self.psi_inv = pow(self.psi, -1, q)
        self.n_inv = pow(degree, -1, q)

        # Longa-Naehrig tables: psis[j] = psi^bitrev(j), ipsis[j] = psi^-bitrev(j)
        n, logn = self.n, self.logn
        self.psis = np.empty(n, dtype=np.uint64)
        self.ipsis = np.empty(n, dtype=np.uint64)
        for j in range(n):
            br = _bit_reverse(j, logn)
            self.psis[j] = pow(self.psi, br, q)
            self.ipsis[j] = pow(self.psi_inv, br, q)
        # Montgomery-scaled (w * R mod q): mont_mul(a, w R) = a * w exactly.
        # Forward stage s uses psis[m : 2m] with m = 2^s; inverse stage s
        # (t = 2^s) uses ipsis[m : 2m] with m = N >> (s+1).
        self.fwd_mont = self._scaled(self.psis)
        self.inv_mont = self._scaled(self.ipsis)
        self.n_inv_mont = self.n_inv * self.ctx.r_mod_q % q
        self._tables = {}

    def _scaled(self, arr: np.ndarray) -> np.ndarray:
        r = self.ctx.r_mod_q
        return np.array([int(w) * r % self.q for w in arr], dtype=np.uint64)

    def _stage_tables(self, device):
        """Per-stage twiddles as lanes shaped (m, 1), on ``device``."""
        key = str(device)
        if key not in self._tables:
            n, logn = self.n, self.logn

            def lanes(arr):
                return to_lanes(u64_from_np(arr, device=device))

            fwd = [lanes(self.fwd_mont[1 << s: 2 << s].reshape(-1, 1))
                   for s in range(logn)]
            inv = [lanes(self.inv_mont[n >> (s + 1): n >> s].reshape(-1, 1))
                   for s in range(logn)]
            self._tables[key] = (fwd, inv)
        return self._tables[key]

    # -- transforms on lanes ---------------------------------------------------
    def _forward(self, x):
        ctx, n = self.ctx, self.n
        batch = x[0].shape[:-1]
        fwd, _ = self._stage_tables(x[0].device)
        for s in range(self.logn):
            m, t = 1 << s, n >> (s + 1)
            xr = tuple(p.reshape(batch + (m, 2, t)) for p in x)
            u = tuple(p[..., 0, :] for p in xr)
            wv = ctx._mont_mul(tuple(p[..., 1, :] for p in xr), fwd[s])
            top, bot = ctx._add(u, wv), ctx._sub(u, wv)
            x = tuple(torch.stack([a, b], dim=-2).reshape(batch + (n,))
                      for a, b in zip(top, bot))
        return x

    def _inverse(self, x):
        ctx, n = self.ctx, self.n
        batch = x[0].shape[:-1]
        _, inv = self._stage_tables(x[0].device)
        for s in range(self.logn):
            t, m = 1 << s, n >> (s + 1)
            xr = tuple(p.reshape(batch + (m, 2, t)) for p in x)
            u = tuple(p[..., 0, :] for p in xr)
            v = tuple(p[..., 1, :] for p in xr)
            top = ctx._add(u, v)
            bot = ctx._mont_mul(ctx._sub(u, v), inv[s])
            x = tuple(torch.stack([a, b], dim=-2).reshape(batch + (n,))
                      for a, b in zip(top, bot))
        c = self.n_inv_mont
        return ctx._mont_mul(x, (c & 0xFFFFFFFF, c >> 32))

    # -- transforms on int32 planes --------------------------------------------
    def forward(self, a):
        """Negacyclic forward NTT: (..., N) natural order -> bit-reversed.
        Stage s reshapes to (..., m, 2, t), m = 2^s, t = N/2m, and maps
        (U, V) -> (U + wV, U - wV) with w = psi^bitrev(m+i)."""
        return to_planes(self._forward(to_lanes(tuple(a))))

    def inverse(self, a):
        """Negacyclic inverse NTT: bit-reversed -> natural order, scaled by
        N^-1.  GS stages: (U, V) -> (U + V, (U - V) w), w = psi^-bitrev(m+i)."""
        return to_planes(self._inverse(to_lanes(tuple(a))))

    def pointwise_mul(self, a, b):
        """Elementwise product in the NTT domain."""
        return self.ctx.mul(a, b)

    def negacyclic_mul(self, a, b):
        """a * b mod (X^N + 1, q), both in coefficient form."""
        fa = self._forward(to_lanes(tuple(a)))
        fb = self._forward(to_lanes(tuple(b)))
        return to_planes(self._inverse(self.ctx._mul(fa, fb)))

    # -- host conversions --------------------------------------------------------
    def to_planes(self, coeffs, device=None) -> tuple:
        return u64_from_np(np.asarray(coeffs, dtype=np.uint64), device)

    def to_np(self, planes) -> np.ndarray:
        return u64_to_np(planes)


def negacyclic_mul_np(a, b, q: int) -> np.ndarray:
    """Exact host oracle for a*b mod (X^N+1, q) via Kronecker substitution:
    pack each polynomial into one big integer with slots wide enough that
    column sums never overflow, multiply once, unpack, and wrap
    c[k] - c[k+N]."""
    a = [int(x) for x in a]
    b = [int(x) for x in b]
    n = len(a)
    slot = 2 * q.bit_length() + n.bit_length() + 2
    pack_a = sum(c << (slot * i) for i, c in enumerate(a))
    pack_b = sum(c << (slot * i) for i, c in enumerate(b))
    prod = pack_a * pack_b
    mask = (1 << slot) - 1
    cols = [(prod >> (slot * i)) & mask for i in range(2 * n)]
    return np.array(
        [(cols[k] - cols[k + n]) % q for k in range(n)], dtype=np.uint64
    )
