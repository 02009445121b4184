"""Torus ring Z_{2^32}[X]/(X^N+1) (counterpart of
node_fhe_accelerate_tpu/core/torus.py).

Torus elements are int32 tensors with uint32 bits.  The negacyclic product
of two torus polynomials is computed exactly over the integers (centered
lift) by CRT on two Solinas NTT primes, P1 = 2^40-2^32+1 and
P2 = 2^37-2^17+1 (P1 P2 ~ 2^77 > 2 N 2^62 for N <= 2^13), then reduced
mod 2^32.  A product of small signed digits (|d| <= B/2) with a torus
polynomial fits one 54-bit prime, P_EXT, which halves the transforms of the
bootstrap's "ntt" external product.

Every transform goes through ops/ntt_pallas.py ``PallasNTT``: on the card
it launches the Hopper NTT kernels, which compute the same function as the
plain NTTContext the JAX package leaves to XLA; on the CPU it runs that
plain version.  The NTT contexts are built at first use, so a ring made
only to rotate or decompose costs nothing more.

Residues mod a prime below 2^63 are also handled here as int64 values:
``_value`` and ``_planes`` convert between those and limb planes.
"""
from __future__ import annotations

import functools

import torch

from ..ops.modular import _lanes_of
from ..ops.ntt import NTTContext
from ..ops.ntt_pallas import PallasNTT
from ..ops.u32 import lshr
from ..ops.u64 import M32, _add128, _mul_wide, to_lanes, to_planes

__all__ = ["TorusRing", "P1", "P2", "P_EXT"]

P1 = (1 << 40) - (1 << 32) + 1   # two-adicity 32
P2 = (1 << 37) - (1 << 17) + 1   # two-adicity 17
P_EXT = (1 << 54) - (1 << 24) + 1  # single-prime external-product modulus


def _value(planes) -> torch.Tensor:
    """(lo, hi) int32 planes of a value below 2^63 -> int64."""
    lo, hi = planes
    return (lo.to(torch.int64) & M32) | (hi.to(torch.int64) << 32)


def _planes(v: torch.Tensor):
    """int64 value in [0, 2^63) -> (lo, hi) int32 planes."""
    return v.to(torch.int32), (v >> 32).to(torch.int32)


class TorusRing:
    """Negacyclic ring over Z_{2^32}; CRT-NTT exact multiply."""

    def __init__(self, degree: int):
        if degree & (degree - 1):
            raise ValueError("degree must be a power of two")
        self.n = degree
        self.logn = degree.bit_length() - 1
        # CRT constants: t = (r2 - r1) * p1^{-1} mod p2; c = r1 + p1 * t
        self.p1_inv_mod_p2 = pow(P1, -1, P2)
        self.m_half = (P1 * P2) // 2
        self.p1p2_mod_2_32 = (P1 * P2) % (1 << 32)

    # -- NTT contexts, built at first use ------------------------------------
    @functools.cached_property
    def ntt1(self) -> NTTContext:
        return NTTContext(self.n, P1)

    @functools.cached_property
    def ntt2(self) -> NTTContext:
        return NTTContext(self.n, P2)

    @functools.cached_property
    def ntt_ext(self) -> NTTContext:
        return NTTContext(self.n, P_EXT)

    @functools.cached_property
    def pntt1(self) -> PallasNTT:
        return PallasNTT(self.ntt1)

    @functools.cached_property
    def pntt2(self) -> PallasNTT:
        return PallasNTT(self.ntt2)

    @functools.cached_property
    def pntt_ext(self) -> PallasNTT:
        return PallasNTT(self.ntt_ext)

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

    # -- exact product with a small polynomial, as a matrix -----------------
    def negacyclic_matrix(self, s: torch.Tensor) -> torch.Tensor:
        """T(s)[..., c, r] = (X^c s)_r for small s (..., N): a @ T(s) is the
        negacyclic product a * s (used by the engine's mask products)."""
        n = self.n
        c = torch.arange(n, device=s.device)[:, None]
        r = torch.arange(n, device=s.device)[None, :]
        d = r - c
        vals = s[..., torch.remainder(d, n)]
        return torch.where(d < 0, 0 - vals, vals)

    # -- CRT NTT multiply ---------------------------------------------------
    @staticmethod
    def _to_planes_centered(a: torch.Tensor, ntt: NTTContext):
        """Torus uint32 bits (centered: a - 2^32 when a >= 2^31) -> Z_p
        limb planes, for a prime p > 2^32."""
        v = a.to(torch.int64) & M32
        return _planes(torch.where(a < 0, v + (ntt.q - (1 << 32)), v))

    @staticmethod
    def _digits_to_planes(d: torch.Tensor, ntt: NTTContext):
        """Signed int32 digits -> Z_p limb planes."""
        v = d.to(torch.int64)
        return _planes(torch.where(d < 0, v + ntt.q, v))

    def _crt_to_torus(self, r1, r2) -> torch.Tensor:
        """Residues (planes mod P1, P2) -> the centered value mod 2^32."""
        ctx2 = self.ntt2.ctx
        # t = (r2 - r1 mod p2) * p1^{-1} mod p2, on lanes
        r1v = _value(r1)
        r1_mod_p2 = torch.remainder(r1v, P2)
        low = to_lanes(tuple(r2))
        t = ctx2._mul(ctx2._sub(low, (r1_mod_p2 & M32, r1_mod_p2 >> 32)),
                      _lanes_of(self.p1_inv_mod_p2))
        # rep = r1 + p1 * t (u128), canonical in [0, p1 p2)
        z = torch.zeros_like(r1v)
        rep = _add128(_mul_wide(t, _lanes_of(P1)),
                      (r1v & M32, r1v >> 32, z, z))
        # centered: subtract p1 p2 when rep >= M/2 (the value was negative)
        mh = self.m_half
        ge = torch.zeros_like(rep[0], dtype=torch.bool)
        eq = torch.ones_like(rep[0], dtype=torch.bool)
        for i in range(3, -1, -1):
            word = (mh >> (32 * i)) & M32
            ge = ge | (eq & (rep[i] > word))
            eq = eq & (rep[i] == word)
        ge = ge | eq
        out = torch.where(ge, rep[0] - self.p1p2_mod_2_32, rep[0])
        return out.to(torch.int32)          # the low 32 bits, mod 2^32

    def forward(self, a):
        """NTT forms of a torus polynomial in both CRT primes."""
        return (self.pntt1.forward(self._to_planes_centered(a, self.ntt1)),
                self.pntt2.forward(self._to_planes_centered(a, self.ntt2)))

    def forward_digits(self, d):
        """NTT forms of signed digit polynomials."""
        return (self.pntt1.forward(self._digits_to_planes(d, self.ntt1)),
                self.pntt2.forward(self._digits_to_planes(d, self.ntt2)))

    @staticmethod
    def _sum_products(ctx, a, b, dim: int, mont: bool = False):
        """sum over ``dim`` of (a * b mod q) -- or of the Montgomery
        products -- mod q, for limb planes a, b that broadcast.  Each term
        is canonical, so the int64 sum of the terms (fewer than 2^63 / q of
        them) reduces with one remainder to the residue that a chain of
        modular adds gives."""
        a, b = to_lanes(tuple(a)), to_lanes(tuple(b))
        prod = ctx._mont_mul(a, b) if mont else ctx._mul(a, b)
        terms = torch.broadcast_shapes(a[0].shape, b[0].shape)[dim]
        if terms * ctx.q >= (1 << 63):
            raise ValueError(f"{terms} terms mod a {ctx.q.bit_length()}-bit "
                             "prime overflow the int64 sum")
        total = (prod[0] | (prod[1] << 32)).sum(dim=dim)
        return _planes(torch.remainder(total, ctx.q))

    @staticmethod
    def _stack_pairs(pairs, which):
        """[(a, b), ...] of limb planes -> (a, b), each plane stacked over
        the pairs on a new leading axis, all broadcast to one shape."""
        flat = torch.broadcast_tensors(
            *[x for p in pairs for side in p for x in which(side)])
        return ((torch.stack(flat[0::4]), torch.stack(flat[1::4])),
                (torch.stack(flat[2::4]), torch.stack(flat[3::4])))

    def pointwise_acc(self, pairs):
        """Sum of pointwise products [(a_hat, b_hat), ...] in the NTT
        domain, per prime.  Returns (acc1, acc2)."""
        out = []
        for i, ctx in enumerate((self.ntt1.ctx, self.ntt2.ctx)):
            a, b = self._stack_pairs(pairs, lambda x, i=i: x[i])
            out.append(self._sum_products(ctx, a, b, 0))
        return tuple(out)

    def inverse(self, acc):
        """Inverse NTT per prime + CRT recombination to torus u32."""
        acc1, acc2 = acc
        return self._crt_to_torus(self.pntt1.inverse(acc1),
                                  self.pntt2.inverse(acc2))

    def multiply(self, a, b):
        """Exact negacyclic product of torus polynomials (centered lift);
        a and b broadcast.  Per prime one fused forward-product-inverse
        (PallasNTT.negacyclic_mul: one launch on the card, N <= 8192)."""
        a, b = (x.contiguous() for x in torch.broadcast_tensors(a, b))
        return self._crt_to_torus(*[
            pntt.negacyclic_mul(self._to_planes_centered(a, ntt),
                                self._to_planes_centered(b, ntt))
            for ntt, pntt in ((self.ntt1, self.pntt1),
                              (self.ntt2, self.pntt2))])

    def multiply_small(self, a_digits, b):
        """Product of a small (signed digit) polynomial with a torus one."""
        fa = self.forward_digits(a_digits)
        fb = self.forward(b)
        return self.inverse(self.pointwise_acc([(fa, fb)]))

    # ------------------------------------------------------------------
    # Single-prime path for small x torus products (external product):
    # centered coefficients of a signed-digit (|d| <= B/2) times torus
    # product are bounded by N (B/2) 2^31, which fits ONE 54-bit prime.
    # ------------------------------------------------------------------
    def ext_bound_ok(self, base_log: int, terms: int = 1) -> bool:
        """Can the single-prime path hold `terms` accumulated products?
        |sum| <= terms * N * (B/2) * 2^31 must stay below P_EXT / 2."""
        bound = terms * self.n * (1 << (base_log - 1)) * (1 << 31)
        return 2 * bound < P_EXT

    def forward_ext_mont(self, a):
        """Torus u32 -> centered mod P_EXT, scaled by R (Montgomery form),
        NTT'd.  Used once at keygen for the bootstrap key; pointwise
        mont_mul against these gives standard-domain products."""
        ctx = self.ntt_ext.ctx
        planes = to_lanes(self._to_planes_centered(a, self.ntt_ext))
        scaled = ctx._mul(planes, _lanes_of(ctx.r_mod_q))
        return self.pntt_ext.forward(to_planes(scaled))

    def forward_digits_ext(self, d):
        """Signed int32 digits -> NTT mod P_EXT (standard domain)."""
        return self.pntt_ext.forward(self._digits_to_planes(d, self.ntt_ext))

    def pointwise_acc_ext(self, pairs):
        """Sum of mont_mul(d_hat, g_mont) in the NTT domain mod P_EXT."""
        a, b = self._stack_pairs(pairs, lambda x: x)
        return self._sum_products(self.ntt_ext.ctx, a, b, 0, mont=True)

    def inverse_ext_to_torus(self, acc) -> torch.Tensor:
        """Inverse NTT mod P_EXT + centered reduction to torus u32."""
        r = _value(self.pntt_ext.inverse(acc))
        return torch.where(r > P_EXT // 2, r - P_EXT, r).to(torch.int32)
