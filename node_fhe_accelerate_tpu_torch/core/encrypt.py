"""BFV-style RLWE encryption engine (counterpart of
node_fhe_accelerate_tpu/core/encrypt.py).

* encode: m -> m * Delta with Delta = floor(q / t), on the host;
* encrypt: c0 = pk.b*u + e1 + m, c1 = pk.a*u + e2;
* phase: c0 - c1*s; a degree-2 phase is c0 - c1*s + c2*s^2, the sign the
  tensor product of two ciphertexts decrypts with ((c0 - c1 s)(c0' - c1' s)
  = d0 - d1 s + d2 s^2; the reference subtracts, which contradicts its own
  multiply and relinearize);
* decode: round(coeff * t / q) mod t, with Python integers on the host;
* multiply: the exact BFV tensor product with the t/q rescale
  (core/bfv_mul.py), then relinearize against the relin key's digits;
* batch_add: a pairwise tree reduction mod q.

Ciphertext polynomials are (lo, hi) int32 limb planes on the ring's device;
products go through ``PolyRing`` (on the card K8, and K6/K7 for the
tensor product and relinearization).  ``encrypt`` and ``encrypt_symmetric``
split into their draws (a ``torch.Generator``) and ``*_from_draws``, which
take the draws as limb planes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .keys import PublicKey, RelinKey, SecretKey
from .params import ParameterSet
from .poly import PolyRing
from ..ops.u64 import u64_and_mask, u64_shr, u64_to_np

__all__ = ["Ciphertext", "Plaintext", "EncryptionEngine"]


@dataclass
class Ciphertext:
    """RLWE ciphertext; c2 present => degree 2."""
    c0: Any
    c1: Any
    c2: Optional[Any] = None
    noise_budget: float = 0.0
    key_id: int = 0
    is_ntt: bool = False

    @property
    def is_degree_2(self) -> bool:
        return self.c2 is not None


@dataclass
class Plaintext:
    """Plaintext value(s) mod t."""
    values: np.ndarray
    modulus: int

    @classmethod
    def scalar(cls, value: int, t: int) -> "Plaintext":
        return cls(values=np.array([value % t], dtype=np.uint64), modulus=t)

    def value(self) -> int:
        return int(self.values[0])


def _stack(polys):
    """Limb-plane polynomials of one shape -> one pair with a leading
    axis."""
    return (torch.stack([p[0] for p in polys]),
            torch.stack([p[1] for p in polys]))


def _row(planes, i):
    return planes[0][i], planes[1][i]


class EncryptionEngine:
    """BFV-style RLWE engine over a single modulus (for an RNS chain, its
    first prime, as the reference computes)."""

    def __init__(self, params: ParameterSet, ring: PolyRing | None = None,
                 noise_std: float | None = None, device=None):
        """``noise_std=None`` derives real encryption noise from the
        parameter set (``ParameterSet.noise_std_absolute``); an explicit
        value, 0.0 included, overrides it, for exactness tests only (zero
        noise makes ciphertexts deterministic in the secret)."""
        self.params = params
        self.ring = ring or PolyRing(params.poly_degree, params.moduli[0],
                                     device)
        self.device = self.ring.device
        self.q = self.ring.q
        self.t = params.plaintext_modulus if params.plaintext_modulus > 0 \
            else 4
        self.delta = self.q // self.t
        noise_std = (params.noise_std_absolute() if noise_std is None
                     else noise_std)
        self._noise_std = noise_std
        self.initial_noise_budget = math.log2(self.q) - math.log2(
            2.0 * max(noise_std, 1.0) * math.sqrt(params.poly_degree))
        self._rescaler = None

    # -- encode / decode (host <-> device edge) ---------------------------
    def encode(self, values):
        """m * Delta packed into coefficient slots."""
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        coeffs = np.zeros(self.ring.n, dtype=np.uint64)
        k = min(len(vals), self.ring.n)
        packed = (vals[:k].astype(object) * self.delta) % self.q
        coeffs[:k] = np.array(packed, dtype=np.uint64)
        return self.ring.from_np(coeffs)

    def decode(self, phase_planes, num_values: int = 1) -> np.ndarray:
        """round(coeff * t / q) mod t per slot, in exact integers on the
        host; any leading batch shape, slots on the last axis."""
        coeffs = u64_to_np(phase_planes)[..., :num_values].astype(object)
        vals = (coeffs * self.t + self.q // 2) // self.q % self.t
        return vals.astype(np.uint64)

    # -- encryption -------------------------------------------------------
    def encrypt(self, gen: torch.Generator, values,
                pk: PublicKey) -> Ciphertext:
        """c0 = pk.b*u + e1 + m, c1 = pk.a*u + e2."""
        ring = self.ring
        u = ring.sample_ternary(gen)
        e1 = ring.sample_gaussian(gen, self._noise_std)
        e2 = ring.sample_gaussian(gen, self._noise_std)
        return self.encrypt_from_draws(values, pk, u, e1, e2)

    def encrypt_from_draws(self, values, pk: PublicKey, u, e1,
                           e2) -> Ciphertext:
        ring = self.ring
        m = self.encode(values)
        # pk.b*u and pk.a*u in one product launch
        prod = ring.multiply(_stack([pk.b, pk.a]), _stack([u, u]))
        c0 = ring.add(ring.add(_row(prod, 0), e1), m)
        c1 = ring.add(_row(prod, 1), e2)
        return Ciphertext(c0=c0, c1=c1,
                          noise_budget=self.initial_noise_budget,
                          key_id=pk.key_id)

    def encrypt_symmetric(self, gen: torch.Generator, values,
                          sk: SecretKey) -> Ciphertext:
        """c = (a*s + e + m, a): the same phase convention c0 - c1*s."""
        a = self.ring.sample_uniform(gen)
        e = self.ring.sample_gaussian(gen, self._noise_std)
        return self.encrypt_symmetric_from_draws(values, sk, a, e)

    def encrypt_symmetric_from_draws(self, values, sk: SecretKey, a,
                                     e) -> Ciphertext:
        ring = self.ring
        m = self.encode(values)
        c0 = ring.add(ring.add(ring.multiply(a, sk.poly), e), m)
        return Ciphertext(c0=c0, c1=a,
                          noise_budget=self.initial_noise_budget,
                          key_id=sk.key_id)

    # -- decryption -------------------------------------------------------
    def phase(self, ct: Ciphertext, sk: SecretKey):
        """The noisy plaintext c0 - c1*s (+ c2*s^2 for degree 2)."""
        ring = self.ring
        p = ring.sub(ct.c0, ring.multiply(ct.c1, sk.poly))
        if ct.is_degree_2:
            s2 = ring.multiply(sk.poly, sk.poly)
            p = ring.add(p, ring.multiply(ct.c2, s2))
        return p

    def decrypt(self, ct: Ciphertext, sk: SecretKey, num_values: int = 1):
        """(values mod t, measured noise budget in bits)."""
        ph = self.phase(ct, sk)
        return self.decode(ph, num_values), self.noise_budget(ph)

    def noise_budget(self, phase_planes) -> float:
        """log2(q/t) - log2(2 * max noise)."""
        coeffs = u64_to_np(phase_planes).reshape(-1)
        max_noise = 0
        for c in coeffs.tolist():
            c = int(c)
            rounded = (c * self.t + self.q // 2) // self.q
            recon = (rounded * self.delta) % self.q
            d = abs(c - recon)
            d = min(d, self.q - d)
            max_noise = max(max_noise, d)
        if max_noise == 0:
            return math.log2(self.q / self.t)
        return math.log2(self.q / self.t) - math.log2(2.0 * max_noise)

    # -- homomorphic ops --------------------------------------------------
    def _degree2_pair(self, a: Ciphertext, b: Ciphertext, op):
        if not (a.is_degree_2 or b.is_degree_2):
            return None
        za = a.c2 if a.is_degree_2 else self.ring.zeros()
        zb = b.c2 if b.is_degree_2 else self.ring.zeros()
        return op(za, zb)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        ring = self.ring
        return Ciphertext(c0=ring.add(a.c0, b.c0), c1=ring.add(a.c1, b.c1),
                          c2=self._degree2_pair(a, b, ring.add),
                          noise_budget=min(a.noise_budget,
                                           b.noise_budget) - 0.5,
                          key_id=a.key_id, is_ntt=a.is_ntt)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        ring = self.ring
        return Ciphertext(c0=ring.sub(a.c0, b.c0), c1=ring.sub(a.c1, b.c1),
                          c2=self._degree2_pair(a, b, ring.sub),
                          noise_budget=min(a.noise_budget,
                                           b.noise_budget) - 0.5,
                          key_id=a.key_id, is_ntt=a.is_ntt)

    def negate(self, a: Ciphertext) -> Ciphertext:
        ring = self.ring
        return Ciphertext(
            c0=ring.neg(a.c0), c1=ring.neg(a.c1),
            c2=ring.neg(a.c2) if a.is_degree_2 else None,
            noise_budget=a.noise_budget, key_id=a.key_id, is_ntt=a.is_ntt)

    def add_plain(self, a: Ciphertext, values) -> Ciphertext:
        return Ciphertext(c0=self.ring.add(a.c0, self.encode(values)),
                          c1=a.c1, c2=a.c2,
                          noise_budget=a.noise_budget - 0.1,
                          key_id=a.key_id, is_ntt=a.is_ntt)

    def multiply_scalar(self, a: Ciphertext, scalar: int) -> Ciphertext:
        ring = self.ring
        return Ciphertext(c0=ring.scalar_mul(a.c0, scalar),
                          c1=ring.scalar_mul(a.c1, scalar),
                          noise_budget=a.noise_budget - 1.0,
                          key_id=a.key_id, is_ntt=a.is_ntt)

    def multiply_plain(self, a: Ciphertext, values) -> Ciphertext:
        """Multiply by an unscaled plaintext polynomial (coefficients m_i,
        not m_i * Delta: two scaled operands would leave Delta^2)."""
        ring = self.ring
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        coeffs = np.zeros(ring.n, dtype=np.uint64)
        coeffs[: len(vals)] = vals % np.uint64(self.t)
        pt = ring.from_np(coeffs)
        prod = ring.multiply(_stack([a.c0, a.c1]), _stack([pt, pt]))
        return Ciphertext(c0=_row(prod, 0), c1=_row(prod, 1),
                          noise_budget=a.noise_budget - 2.0,
                          key_id=a.key_id, is_ntt=a.is_ntt)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """The BFV multiply with the t/q rescale (``multiply_rescale``):
        the composition ``decrypt`` round-trips with real noise."""
        return self.multiply_rescale(a, b)

    def multiply_raw(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """NTT tensor product -> degree 2 at scale Delta^2 (exact only
        without noise; for tests of the phase algebra)."""
        ring = self.ring
        if a.is_degree_2 or b.is_degree_2:
            raise ValueError("relinearize before multiplying degree-2")
        f = ring.to_ntt(_stack([a.c0, a.c1, b.c0, b.c1]))
        fa0, fa1, fb0, fb1 = (_row(f, i) for i in range(4))
        d1 = ring.add(ring.pointwise(fa0, fb1), ring.pointwise(fa1, fb0))
        d = ring.from_ntt(_stack([ring.pointwise(fa0, fb0), d1,
                                  ring.pointwise(fa1, fb1)]))
        nb = min(a.noise_budget, b.noise_budget) - (
            math.log2(self.params.poly_degree) + 5.0)
        return Ciphertext(c0=_row(d, 0), c1=_row(d, 1), c2=_row(d, 2),
                          noise_budget=nb, key_id=a.key_id)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.multiply_rescale(a, a)

    # -- BFV multiply (t/q rescale) ---------------------------------------
    @property
    def rescaler(self):
        """The exact CRT tensor multiplier (core/bfv_mul.py), built at
        first use."""
        if self._rescaler is None:
            from .bfv_mul import RescaleMultiplier
            self._rescaler = RescaleMultiplier(self.ring.n, self.q, self.t,
                                               self.device)
        return self._rescaler

    def multiply_rescale(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Fan-Vercauteren multiply: d_i = round(t/q * (a (x) b)_i), a
        degree-2 result at scale Delta."""
        if a.is_degree_2 or b.is_degree_2:
            raise ValueError("relinearize before multiplying degree-2")
        d0, d1, d2 = self.rescaler.multiply(a.c0, a.c1, b.c0, b.c1)
        nb = min(a.noise_budget, b.noise_budget) - (
            math.log2(self.t) + math.log2(self.params.poly_degree) + 3.0)
        return Ciphertext(c0=d0, c1=d1, c2=d2, noise_budget=nb,
                          key_id=a.key_id)

    def multiply_relin_rescale(self, a, b, rlk: RelinKey) -> Ciphertext:
        return self.relinearize(self.multiply_rescale(a, b), rlk)

    def multiply_relin(self, a, b, rlk: RelinKey) -> Ciphertext:
        return self.relinearize(self.multiply_rescale(a, b), rlk)

    def relinearize(self, ct: Ciphertext, rlk: RelinKey) -> Ciphertext:
        """c0' = d0 + sum_i digit_i * b_i, c1' = d1 + sum_i digit_i * a_i
        over the base-2^base_log digits of d2, so c0' - c1'*s = d0 - d1*s
        + d2*s^2 + noise.  The sums are taken in the NTT domain (mod q the
        same as the JAX package's sum of inverse transforms): one forward
        launch each for the digits, the b_i and the a_i, one inverse for
        both sums."""
        if not ct.is_degree_2:
            return ct
        ring = self.ring
        base_log = rlk.decomp_base_log
        mask = (1 << base_log) - 1
        levels = rlk.decomp_level
        digits = [u64_and_mask(u64_shr(tuple(ct.c2), lvl * base_log), mask)
                  for lvl in range(levels)]
        dn = ring.to_ntt(_stack(digits))
        kb = ring.to_ntt(_stack(rlk.b[:levels]))
        ka = ring.to_ntt(_stack(rlk.a[:levels]))
        acc_b = acc_a = None
        for lvl in range(levels):
            d = _row(dn, lvl)
            pb = ring.pointwise(d, _row(kb, lvl))
            pa = ring.pointwise(d, _row(ka, lvl))
            acc_b = pb if acc_b is None else ring.add(acc_b, pb)
            acc_a = pa if acc_a is None else ring.add(acc_a, pa)
        sums = ring.from_ntt(_stack([acc_b, acc_a]))
        return Ciphertext(c0=ring.add(ct.c0, _row(sums, 0)),
                          c1=ring.add(ct.c1, _row(sums, 1)),
                          noise_budget=ct.noise_budget - 1.0,
                          key_id=ct.key_id)

    # -- voting primitives ------------------------------------------------
    def tally_votes(self, ballots: list) -> Ciphertext:
        """Homomorphic tally of one-hot ballots."""
        return self.batch_add(ballots)

    def tally_weighted(self, ballots: list, weights: list) -> Ciphertext:
        """sum w_i * ballot_i."""
        if len(ballots) != len(weights):
            raise ValueError("weights must match ballots")
        return self.batch_add([self.multiply_scalar(b, w)
                               for b, w in zip(ballots, weights)])

    def tally_multi_candidate(self, ballots: list) -> Ciphertext:
        """Per-slot counts of packed one-hot ballots (coefficient slots
        carry the candidates)."""
        return self.batch_add(ballots)

    def update_tally(self, tally: Ciphertext, ballot: Ciphertext
                     ) -> Ciphertext:
        return self.add(tally, ballot)

    # -- batch reductions --------------------------------------------------
    def batch_add(self, cts: list) -> Ciphertext:
        """Stack the ciphertexts and reduce them pairwise mod q."""
        if not cts:
            raise ValueError("empty batch")
        ring = self.ring
        c0 = _tree_reduce_mod(ring, _stack([c.c0 for c in cts]))
        c1 = _tree_reduce_mod(ring, _stack([c.c1 for c in cts]))
        nb = min(c.noise_budget for c in cts) - \
            0.5 * math.log2(max(len(cts), 2))
        return Ciphertext(c0=c0, c1=c1, noise_budget=nb,
                          key_id=cts[0].key_id)


def _tree_reduce_mod(ring: PolyRing, planes):
    """Pairwise modular tree reduction along axis 0 (log2(B) adds)."""
    lo, hi = planes
    while lo.shape[0] > 1:
        n = lo.shape[0]
        half = n // 2
        s = ring.add((lo[:half], hi[:half]),
                     (lo[half: 2 * half], hi[half: 2 * half]))
        if n % 2:
            lo = torch.cat([s[0], lo[-1:]], dim=0)
            hi = torch.cat([s[1], hi[-1:]], dim=0)
        else:
            lo, hi = s
    return lo[0], hi[0]
