"""Torus ring Z_{2^32}[X]/(X^N+1), main-path part (counterpart of
node_fhe_accelerate_tpu/core/torus.py:57-127).

Torus elements are int32 tensors with uint32 bits.  The reference's
general CRT/NTT multiply is not ported yet; ``multiply`` here is exact for
the products the bootstrap slice needs (a torus polynomial times a small
one, such as a binary secret), via one float64 matmul (ops/u32.py).
"""
from __future__ import annotations

import math

import torch

from ..ops.u32 import lshr, matmul_mod32

__all__ = ["TorusRing"]


class TorusRing:
    """Negacyclic ring over Z_{2^32} of power-of-two degree N."""

    def __init__(self, degree: int):
        if degree & (degree - 1):
            raise ValueError("degree must be a power of two")
        self.n = degree
        self.logn = degree.bit_length() - 1

    # -- basic ops (native wraparound) --------------------------------------
    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def neg(a):
        return 0 - a

    @staticmethod
    def _roll_neg(a, s: int):
        """Static negacyclic roll: X^s * a for s in [0, N)."""
        if s == 0:
            return a
        return torch.cat([0 - a[..., -s:], a[..., :-s]], dim=-1)

    def rotate(self, a: torch.Tensor, r) -> torch.Tensor:
        """X^r * a mod (X^N + 1) for int r of any sign (reduced mod 2N);
        r broadcasts against a.shape[:-1].

        A direct gather, out[i] = a~[(i - r) mod 2N] with a~ = [a, -a]: the
        reference's ladder of static rolls exists because gathers are slow
        on a TPU, which is not true of a GPU or CPU."""
        n = self.n
        r = torch.as_tensor(r, dtype=torch.int64, device=a.device)
        idx = torch.remainder(
            torch.arange(n, device=a.device) - r.unsqueeze(-1), 2 * n)
        idx = idx.expand(a.shape[:-1] + (n,))
        wrapped = idx >= n
        vals = torch.gather(a, -1, torch.where(wrapped, idx - n, idx))
        return torch.where(wrapped, 0 - vals, vals)

    # -- signed gadget decomposition ----------------------------------------
    def decompose(self, a: torch.Tensor, base_log: int, level: int):
        """Signed balanced digits of the top level*base_log bits: int32 of
        shape (level,) + a.shape, sum_l digits[l] * 2^(32-(l+1)B) ~ a,
        digits in [-B/2, B/2]."""
        b = base_log
        total = level * b
        if total > 32:
            raise ValueError("level * base_log exceeds 32 bits")
        rounding = (1 << (32 - total - 1)) if total < 32 else 0
        y = lshr(a + rounding, 32 - total)
        digits = []
        carry = torch.zeros_like(a)
        for _ in range(level):                # least-significant level first
            d = (y & ((1 << b) - 1)) + carry
            y = lshr(y, b)
            carry = (d >= (1 << (b - 1))).to(torch.int32)
            digits.append(d - (carry << b))
        digits.reverse()                      # index l: weight 2^(32-(l+1)B)
        return torch.stack(digits, dim=0)

    # -- exact product with a small polynomial ------------------------------
    def negacyclic_matrix(self, s: torch.Tensor) -> torch.Tensor:
        """T(s)[..., c, r] = (X^c s)_r for small s (..., N): a @ T(s) is the
        negacyclic product a * s."""
        n = self.n
        c = torch.arange(n, device=s.device)[:, None]
        r = torch.arange(n, device=s.device)[None, :]
        d = r - c
        vals = s[..., torch.remainder(d, n)]
        return torch.where(d < 0, 0 - vals, vals)

    def multiply(self, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """a * s mod (X^N + 1, 2^32) for a torus polynomial batch a (..., N)
        and ONE small polynomial s (N,) with |s_i| <= 1 (a binary secret).
        |sum| < N * 2^31 <= 2^41 for N <= 1024: exact in float64."""
        bound = math.log2(self.n) + 31
        return matmul_mod32(a, self.negacyclic_matrix(s), bound)
