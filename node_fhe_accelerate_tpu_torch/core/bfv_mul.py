"""The BFV tensor multiply with the t/q rescale (counterpart of
node_fhe_accelerate_tpu/core/bfv_mul.py).

Decryption is round(phase * t / q) mod t, so a product of two ciphertexts
needs d_i = round(t/q * (ct (x) ct')_i) computed over the integers:

1. lift the ciphertext polynomials to centered representatives and compute
   the negacyclic tensor products exactly over Z, by CRT on auxiliary
   ~59-bit NTT primes (|coeff| <= N (q/2)^2 2, so M = prod p_i > N q^2
   covers the centered range); the transforms are ``PallasNTT`` over each
   auxiliary prime (on the card K6/K7 in their Shoup form, four operands
   in one forward launch and the three products in one inverse launch per
   prime);
2. recombine the residues into base-256 digit planes (ops/digits.py
   ``conv_full`` and ``exact_norm``, whose carry lookahead is two
   ``cummax`` scans);
3. rescale: y = floor((t X + q/2) MU >> K) with MU = floor(2^K / q), a
   Barrett-style division whose off-by-one (probability ~2^-24) adds at
   most one unit of noise, which BFV absorbs;
4. reduce y mod q back to limb planes.

Every step is exact, so the result equals the JAX package's bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import digits as dg
from ..ops.modular import ModCtx, _lanes_of
from ..ops.ntt import NTTContext
from ..ops.ntt_pallas import PallasNTT
from ..ops.primes import find_ntt_prime
from ..ops.u64 import _lt64, _select, to_lanes, to_planes

__all__ = ["RescaleMultiplier", "RnsRescaleMultiplier", "aux_prime_chain"]


def aux_prime_chain(degree: int, min_product_bits: int,
                    exclude: tuple = ()) -> list:
    """Distinct ~59-bit NTT-friendly primes whose product exceeds
    2^min_product_bits (the auxiliary CRT basis of exact tensor
    products)."""
    primes = []
    below = None
    bits = 0
    while bits < min_product_bits:
        p = find_ntt_prime(59, degree, below=below)
        if p not in exclude:
            primes.append(p)
            bits += p.bit_length() - 1
        below = p
    return primes


def _conv(a, b, out_len: int):
    """dg.conv_full for unequal digit counts (zero-pad the shorter)."""
    d = max(a.shape[-1], b.shape[-1])
    a = F.pad(a, (0, d - a.shape[-1]))
    b = F.pad(b, (0, d - b.shape[-1]))
    return dg.conv_full(a, b, out_len=out_len)


def _u64_to_digits(planes, n_digits: int = 8):
    """u64 limb planes -> strict base-256 digits (int32, little-endian)."""
    lo, hi = planes
    out = [(lo >> (8 * i)) & 0xFF for i in range(min(4, n_digits))]
    out += [(hi >> (8 * (i - 4))) & 0xFF for i in range(4, n_digits)]
    return torch.stack(out, dim=-1)


def _digits_to_u128_lanes(digits):
    """Low 128 bits of a strict digit array -> 4 int64 lanes."""
    d = digits.to(torch.int64)
    nd = digits.shape[-1]
    lanes = []
    for w in range(4):
        acc = torch.zeros(digits.shape[:-1], dtype=torch.int64,
                          device=digits.device)
        for b in range(4):
            i = 4 * w + b
            if i < nd:
                acc = acc | (d[..., i] << (8 * b))
        lanes.append(acc)
    return tuple(lanes)


def _centered_digits(residues, ctxs, inv, mod_digits, mod_half_digits,
                     part_digits, d_out):
    """CRT of residues (planes per prime, with (M/p_i)^-1 mod p_i and M/p_i
    as digits) -> (|X| digits, X > M/2) for X in [0, M)."""
    cols = None
    for i, r in enumerate(residues):
        ti = ctxs[i].mul(r, _lanes_of(inv[i]))
        c = _conv(_u64_to_digits(ti, 8), part_digits[i], out_len=d_out)
        cols = c if cols is None else cols + c
    x, _ = dg.exact_norm(cols)
    # X < len(primes) * M: reduce by conditional subtraction
    for _ in range(len(residues) - 1):
        d, ge = dg.sub_digits(x, mod_digits)
        x = dg.select(ge, d, x)
    neg = ~dg.geq_digits(mod_half_digits, x)          # X > M/2
    m_minus_x, _ = dg.sub_digits(mod_digits, x)
    return dg.select(neg, m_minus_x, x), neg


def _rescaled(xd, t_digits, half_digits, mu_digits, d_z, d_mu, k_bits):
    """floor((t |X| + Q/2) MU >> K) as strict digits."""
    zc = _conv(xd, t_digits, out_len=d_z) + half_digits
    z, _ = dg.exact_norm(zc)
    y, _ = dg.exact_norm(_conv(z, mu_digits, out_len=d_z + d_mu))
    return y[..., k_bits // 8:]


class _AuxBasis:
    """The auxiliary CRT basis of a tensor product whose coefficients stay
    below 2^bound_bits in magnitude: primes, their NTT kernels, and the
    digit constants of the recombination."""

    def __init__(self, degree: int, bound_bits: int, device,
                 exclude: tuple = ()):
        self.primes = aux_prime_chain(degree, bound_bits, exclude=exclude)
        self.ntt = [PallasNTT(NTTContext(degree, p)) for p in self.primes]
        self.ctx = [n.ctx for n in self.ntt]
        M = math.prod(self.primes)
        self.M = M
        self.d_m = (M.bit_length() + 8) // 8 + 1       # digits for X < 3M
        self.m_digits = dg.digits_from_int(M, self.d_m, device)
        self.m_half_digits = dg.digits_from_int(M // 2, self.d_m, device)
        dmi = (max((M // p).bit_length() for p in self.primes) + 7) // 8
        self.mi_digits = [dg.digits_from_int(M // p, dmi, device)
                          for p in self.primes]
        self.inv_mi = [pow((M // p) % p, -1, p) for p in self.primes]
        self.d_mi = dmi

    def tensor_residues(self, lifted):
        """Per prime, the negacyclic tensor products (d0, d1, d2) of the
        lifted operands (a0, a1, b0, b1), each limb planes (..., N)."""
        out = []
        for i, ntt in enumerate(self.ntt):
            ctx = ntt.ctx
            ops = [lifted[k][i] for k in range(4)]
            f = ntt.forward((torch.stack([o[0] for o in ops]),
                             torch.stack([o[1] for o in ops])))
            fa0, fa1, fb0, fb1 = ((f[0][k], f[1][k]) for k in range(4))
            d1 = ctx.add(ctx.mul(fa0, fb1), ctx.mul(fa1, fb0))
            prods = [ctx.mul(fa0, fb0), d1, ctx.mul(fa1, fb1)]
            d = ntt.inverse((torch.stack([p[0] for p in prods]),
                             torch.stack([p[1] for p in prods])))
            out.append(tuple((d[0][k], d[1][k]) for k in range(3)))
        return out

    def centered(self, residues):
        return _centered_digits(residues, self.ctx, self.inv_mi,
                                self.m_digits, self.m_half_digits,
                                self.mi_digits, self.d_m)


class _RescaleConsts:
    """Digit constants of y = floor((t X + Q/2) MU >> K), MU = 2^K // Q."""

    def __init__(self, t: int, Q: int, bound_bits: int, d_m: int, device):
        z_bits = t.bit_length() + bound_bits + 1
        self.K = ((z_bits + 24) + 7) // 8 * 8           # >= 24 bits margin
        self.mu = (1 << self.K) // Q
        self.d_t = max(1, (t.bit_length() + 7) // 8)
        self.t_digits = dg.digits_from_int(t, self.d_t, device)
        self.d_z = d_m + self.d_t + 1
        self.half_digits = dg.digits_from_int(Q // 2, self.d_z, device)
        self.d_mu = (self.mu.bit_length() + 7) // 8
        self.mu_digits = dg.digits_from_int(self.mu, self.d_mu, device)

    def apply(self, xd):
        return _rescaled(xd, self.t_digits, self.half_digits,
                         self.mu_digits, self.d_z, self.d_mu, self.K)


class RescaleMultiplier:
    """BFV multiply-with-rescale over one ciphertext modulus q."""

    def __init__(self, degree: int, q: int, t: int, device=None):
        self.n = degree
        self.q = q
        self.t = t
        self.device = resolve_device(device)
        self.qctx = ModCtx(q)
        # auxiliary basis: M > 2 * bound, bound = N * q^2 / 2
        bound_bits = degree.bit_length() + 2 * q.bit_length() + 2
        self.aux = _AuxBasis(degree, bound_bits, self.device)
        self.aux_primes = self.aux.primes
        self.M = self.aux.M
        self.rescale = _RescaleConsts(t, q, bound_bits, self.aux.d_m,
                                      self.device)
        self.K, self.mu = self.rescale.K, self.rescale.mu

    def _lift_centered(self, planes, i: int):
        """Canonical [0, q) planes -> centered residue mod aux prime i: a
        value v > q/2 stands for v - q, whose residue is (v mod p) -
        (q mod p)."""
        ctx = self.aux.ctx[i]
        v = to_lanes(tuple(planes))
        z = torch.zeros_like(v[0])
        r = ctx._reduce_128((v[0], v[1], z, z))
        is_neg = _lt64(_lanes_of(self.q // 2), v)
        r_neg = ctx._sub(r, _lanes_of(self.q % self.aux.primes[i]))
        return to_planes(_select(is_neg, r_neg, r))

    def tensor_residues(self, a0, a1, b0, b1):
        """Per aux prime, the negacyclic tensor products (d0, d1, d2) of
        the centered lifts, each limb planes (..., N)."""
        lifted = [[self._lift_centered(x, i)
                   for i in range(len(self.aux.primes))]
                  for x in (a0, a1, b0, b1)]
        return self.aux.tensor_residues(lifted)

    def _rescale_digits(self, xd, neg):
        """round(t X / q) mod q from |X| digits and sign -> planes."""
        y = self.rescale.apply(xd)
        r = self.qctx._reduce_128(_digits_to_u128_lanes(y))
        return to_planes(_select(neg, self.qctx._neg(r), r))

    def multiply(self, a0, a1, b0, b1):
        """(d0, d1, d2) = round(t/q * (a (x) b)) mod q, each limb planes
        (..., N), from the planes of a = (a0, a1) and b = (b0, b1)."""
        residues = self.tensor_residues(a0, a1, b0, b1)
        out = []
        for comp in range(3):
            xd, neg = self.aux.centered([r[comp] for r in residues])
            out.append(self._rescale_digits(xd, neg))
        return tuple(out)


class _DigitsModP:
    """Reduce a strict base-256 digit array mod p: digits group into 24-bit
    chunks, then a dot against (2^24)^j mod p, ceil(D/3) modular
    products."""

    def __init__(self, ctx: ModCtx, max_digits: int):
        self.ctx = ctx
        n_chunks = (max_digits + 2) // 3
        self._pow = [pow(1 << 24, j, ctx.q) for j in range(n_chunks)]

    def __call__(self, digits):
        d = F.pad(digits, (0, (-digits.shape[-1]) % 3)).to(torch.int64)
        chunks = d[..., 0::3] + 256 * d[..., 1::3] + 65536 * d[..., 2::3]
        acc = None
        for j in range(chunks.shape[-1]):
            c = chunks[..., j]
            term = self.ctx._mul((c, torch.zeros_like(c)),
                                 _lanes_of(self._pow[j]))
            acc = term if acc is None else self.ctx._add(acc, term)
        return acc


class RnsRescaleMultiplier:
    """BFV multiply-with-rescale over an RNS chain Q = prod q_i; ciphertext
    polynomials come and go as residue lists (one limb-plane pair per q_i).

    1. exact CRT recombination of the input residues into centered digit
       representatives of X in (-Q/2, Q/2];
    2. the digits reduced mod each auxiliary prime (24-bit chunk dot);
    3. the negacyclic tensor products per auxiliary prime (exact over Z,
       M > N Q^2);
    4. recombination to |X| digits over the auxiliary basis, the Barrett
       rescale y = round(t X / Q), and y reduced mod each output prime.
    """

    def __init__(self, degree: int, moduli: list, t: int, device=None):
        self.n = degree
        self.moduli = list(moduli)
        self.t = t
        self.device = dev = resolve_device(device)
        Q = math.prod(self.moduli)
        self.Q = Q
        self.qctx = [ModCtx(q) for q in self.moduli]

        # input basis: the exact CRT lift of residues to digits
        self.d_q = (Q.bit_length() + 8) // 8 + 1        # digits for X < K*Q
        self._q_digits = dg.digits_from_int(Q, self.d_q, dev)
        self._q_half_digits = dg.digits_from_int(Q // 2, self.d_q, dev)
        self._inv_qi_star = [pow((Q // q) % q, -1, q) for q in self.moduli]
        dqi = (max((Q // q).bit_length() for q in self.moduli) + 7) // 8
        self._qi_star_digits = [dg.digits_from_int(Q // q, dqi, dev)
                                for q in self.moduli]
        self.d_qi = dqi

        # auxiliary basis: M > 2 * N * (Q/2)^2
        bound_bits = degree.bit_length() + 2 * Q.bit_length() + 2
        self.aux = _AuxBasis(degree, bound_bits, dev,
                             exclude=tuple(self.moduli))
        self.aux_primes = self.aux.primes
        self.M = self.aux.M
        self.rescale = _RescaleConsts(t, Q, bound_bits, self.aux.d_m, dev)
        self.K, self.mu = self.rescale.K, self.rescale.mu
        # digits of y < t N Q / 2
        self.d_y = self.rescale.d_z + self.rescale.d_mu - self.K // 8
        self._aux_red = [_DigitsModP(c, self.d_q) for c in self.aux.ctx]
        self._out_red = [_DigitsModP(c, self.d_y) for c in self.qctx]

    def _rns_to_centered_digits(self, rns_planes):
        """[(lo, hi)] per input prime -> (|X| digits, X > Q/2) with X the
        CRT of the residues."""
        return _centered_digits(rns_planes, self.qctx, self._inv_qi_star,
                                self._q_digits, self._q_half_digits,
                                self._qi_star_digits, self.d_q)

    def _signed_residues(self, digits, neg, reducers, ctxs):
        out = []
        for red, ctx in zip(reducers, ctxs):
            r = red(digits)
            out.append(to_planes(_select(neg, ctx._neg(r), r)))
        return out

    def _lift_to_aux(self, rns_planes):
        """RNS residues -> centered residue mod every aux prime."""
        xd, neg = self._rns_to_centered_digits(rns_planes)
        return self._signed_residues(xd, neg, self._aux_red, self.aux.ctx)

    def multiply(self, a0, a1, b0, b1):
        """Inputs: residue lists [(lo, hi)] per modulus; returns (d0, d1,
        d2), each a residue list."""
        lifted = [self._lift_to_aux(x) for x in (a0, a1, b0, b1)]
        residues = self.aux.tensor_residues(lifted)
        out = []
        for comp in range(3):
            xd, neg = self.aux.centered([r[comp] for r in residues])
            y = self.rescale.apply(xd)
            out.append(tuple(self._signed_residues(y, neg, self._out_red,
                                                   self.qctx)))
        return tuple(out)
