"""CKKS approximate arithmetic over the RNS modulus chain (counterpart of
node_fhe_accelerate_tpu/core/ckks.py).

* **Encoding** (host edge): the canonical embedding by FFT -- slots are
  the evaluations of m(X) at the odd 2N-th roots of unity; encode is
  conjugate-extend, FFT, twist by zeta^-k, round(scale * .), in numpy.
* **Homomorphic ops** (on the ring's device): the multiply is the per-prime
  NTT tensor product (the scale absorbs Delta^2), then the RNS keyswitch of
  core/rns.py (one key per level) and the exact RNS rescale
  c' = (c - [c]_{q_L}) q_L^-1, which drops the last prime.
* **Levels**: a ciphertext carries its chain length and its exact scale (a
  ``Fraction``: scales compose as Delta^2 / q_L).  ``mod_down`` drops
  residues without rescaling, to align operand levels.

``multiply_relin_rescale`` has a fused form with the operations of the
JAX package's single-dispatch program in its order (the keyswitch summed
in the NTT domain, two inverse transforms per prime), bit-identical to
multiply -> relinearize -> rescale; on the card it is the default, and its
launches are stacked per prime (four operands in one forward, the level's
gadget components in one forward, the two sums in one inverse).  The relin
key's NTT form is cached on the key per chain (degree, moduli, device and
the rings' transform layout), so one key used under engines with different
chains or rings gets each its own form.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .keys import PublicKey, SecretKey
from .params import ParameterSet
from .poly import PolyRing
from .rns import (RnsKeySet, RnsPolyRing, RnsRelinKey, gadget_components,
                  lift, row, rns_keyswitch, stack)

__all__ = ["CkksEncoder", "CkksCiphertext", "CkksEngine"]


class CkksEncoder:
    """Canonical-embedding encoder (host edge, FFT-based).

    Slots: z in C^(N/2).  m(zeta^(2j+1)) for j < N/2 carry z; the
    conjugate roots carry conj(z), which forces real coefficients."""

    def __init__(self, degree: int):
        self.n = degree
        k = np.arange(degree)
        self._twist = np.exp(1j * np.pi * k / degree)        # zeta^k
        self._untwist = np.conj(self._twist)

    def encode(self, values, scale: int | float) -> np.ndarray:
        """Complex or real slots (up to N/2) -> signed integer coefficients
        (object dtype) at the given scale."""
        z = np.asarray(values, dtype=np.complex128).reshape(-1)
        if len(z) > self.n // 2:
            raise ValueError(f"at most N/2 = {self.n // 2} slots")
        full = np.zeros(self.n // 2, dtype=np.complex128)
        full[: len(z)] = z
        # conjugate-symmetric evaluation vector v[N-1-j] = conj(v[j]);
        # evaluation at zeta^(2j+1) is the positive-sign DFT kernel, so the
        # coefficients are fft(v)/N untwisted
        v = np.concatenate([full, np.conj(full[::-1])])
        c = np.fft.fft(v) / self.n * self._untwist
        coeffs = np.round(np.real(c) * float(scale)).astype(object)
        return np.array([int(x) for x in coeffs], dtype=object)

    def decode(self, coeffs, scale: Fraction, num_slots: int | None = None
               ) -> np.ndarray:
        """Signed integer coefficients -> complex slots at the exact
        scale."""
        c = np.array([float(Fraction(int(x)) / scale) for x in coeffs])
        v = np.fft.ifft(c * self._twist) * self.n
        slots = v[: self.n // 2]
        return slots[:num_slots] if num_slots else slots


@dataclass
class CkksCiphertext:
    c0: Any                  # residue tuples, length = level
    c1: Any
    c2: Any = None
    level: int = 0           # number of live moduli
    scale: Fraction = Fraction(1)
    key_id: str = "ckks"

    @property
    def is_degree_2(self):
        return self.c2 is not None


class CkksEngine:
    """Leveled CKKS over params.moduli (every prime of the chain)."""

    def __init__(self, params: ParameterSet, scale: int | None = None,
                 device=None, ring_factory=None):
        """``ring_factory(degree, q)`` makes the ring of each prime (default
        a ``PolyRing`` on ``device``): pass a DistPolyRing factory to run
        leveled CKKS over the 4-step sharded ring (parallel/dist_ring.py).
        The levels share one ring a prime."""
        self.params = params
        self.K = len(params.moduli)
        # one ring per prime, shared by the levels
        if ring_factory is None:
            self.device = resolve_device(device)
            per_prime = [PolyRing(params.poly_degree, q, self.device)
                         for q in params.moduli]
        else:
            per_prime = [ring_factory(params.poly_degree, q)
                         for q in params.moduli]
            self.device = resolve_device(
                per_prime[0].device if device is None else device)
        self._ring_factory = ring_factory
        # ring per level: level L computes over moduli[:L]
        self.rings = [RnsPolyRing(params.poly_degree, params.moduli[:L],
                                  self.device, rings=per_prime[:L])
                      for L in range(1, self.K + 1)]
        self.ring = self.rings[-1]
        self.encoder = CkksEncoder(params.poly_degree)
        # default scale: the second modulus's size (Delta ~ q_i of the
        # dropped levels keeps rescaled scales near the original)
        self.scale = int(scale if scale is not None
                         else getattr(params, "ckks_scale", 0)
                         or 1 << (params.moduli[1].bit_length() - 1
                                  if self.K > 1 else 40))
        self._noise_std = params.noise_std_absolute()
        self.keyset = RnsKeySet(self.ring, self._noise_std)

    # -- keys --------------------------------------------------------------
    def generate_secret_key(self, gen: torch.Generator) -> SecretKey:
        return self.keyset.generate_secret_key(gen)

    def generate_public_key(self, gen: torch.Generator,
                            sk: SecretKey) -> PublicKey:
        return self.keyset.generate_public_key(gen, sk)

    def level_keyset(self, level: int) -> RnsKeySet:
        return RnsKeySet(self.rings[level - 1], self._noise_std)

    def generate_relin_keys(self, gen: torch.Generator,
                            sk: SecretKey) -> list:
        """One RNS keyswitch key per level L in [2, K] (the gadget factors
        Q_L/q_j depend on the live chain); levels 0 and 1 hold None."""
        keys = [None, None]
        for L in range(2, self.K + 1):
            sk_l = SecretKey(poly=tuple(sk.poly[:L]), key_id=sk.key_id)
            keys.append(self.level_keyset(L).generate_relin_key(gen, sk_l))
        return keys

    # -- encode / encrypt ---------------------------------------------------
    def encode(self, values, level: int | None = None):
        L = level or self.K
        ring = self.rings[L - 1]
        coeffs = self.encoder.encode(values, self.scale)
        return ring.from_int_coeffs(
            np.array([int(c) % ring.Q for c in coeffs], dtype=object))

    def encrypt(self, gen: torch.Generator, values,
                pk: PublicKey) -> CkksCiphertext:
        ring = self.ring
        u = ring.sample_ternary(gen)
        e1 = ring.sample_gaussian(gen, self._noise_std)
        e2 = ring.sample_gaussian(gen, self._noise_std)
        return self.encrypt_from_draws(values, pk, u, e1, e2)

    def encrypt_from_draws(self, values, pk: PublicKey, u, e1,
                           e2) -> CkksCiphertext:
        ring = self.ring
        m = self.encode(values)
        prod = ring.multiply(stack([pk.b, pk.a]), stack([u, u]))
        c0 = ring.add(ring.add(row(prod, 0), e1), m)
        c1 = ring.add(row(prod, 1), e2)
        return CkksCiphertext(c0=c0, c1=c1, level=self.K,
                              scale=Fraction(self.scale), key_id=pk.key_id)

    # -- decrypt / decode ---------------------------------------------------
    def phase(self, ct: CkksCiphertext, sk: SecretKey):
        ring = self.rings[ct.level - 1]
        s = tuple(sk.poly[: ct.level])
        p = ring.sub(ct.c0, ring.multiply(ct.c1, s))
        if ct.is_degree_2:
            s2 = ring.multiply(s, s)
            p = ring.add(p, ring.multiply(ct.c2, s2))
        return p

    def decrypt(self, ct: CkksCiphertext, sk: SecretKey,
                num_slots: int | None = None) -> np.ndarray:
        ring = self.rings[ct.level - 1]
        x = ring.to_int_coeffs(self.phase(ct, sk))
        # centered lift: the coefficients are small signed integers * scale
        half = ring.Q // 2
        signed = np.array([int(v) - ring.Q if int(v) > half else int(v)
                           for v in x.reshape(-1)], dtype=object)
        return self.encoder.decode(signed, ct.scale, num_slots)

    # -- level alignment ----------------------------------------------------
    def mod_down(self, ct: CkksCiphertext, level: int) -> CkksCiphertext:
        """Drop residues to a lower level without rescaling (|m + e| << Q',
        so the plaintext and the scale are unchanged)."""
        if level > ct.level:
            raise ValueError("cannot mod_down to a higher level")

        def take(poly):
            return tuple(poly[:level])

        return CkksCiphertext(
            c0=take(ct.c0), c1=take(ct.c1),
            c2=take(ct.c2) if ct.is_degree_2 else None,
            level=level, scale=ct.scale, key_id=ct.key_id)

    def _align(self, a: CkksCiphertext, b: CkksCiphertext):
        L = min(a.level, b.level)
        return self.mod_down(a, L), self.mod_down(b, L)

    # -- homomorphic ops ----------------------------------------------------
    def add(self, a: CkksCiphertext, b: CkksCiphertext) -> CkksCiphertext:
        a, b = self._align(a, b)
        if a.scale != b.scale:
            raise ValueError(f"scale mismatch: {a.scale} vs {b.scale}")
        ring = self.rings[a.level - 1]
        return CkksCiphertext(c0=ring.add(a.c0, b.c0),
                              c1=ring.add(a.c1, b.c1),
                              level=a.level, scale=a.scale, key_id=a.key_id)

    def sub(self, a: CkksCiphertext, b: CkksCiphertext) -> CkksCiphertext:
        a, b = self._align(a, b)
        if a.scale != b.scale:
            raise ValueError(f"scale mismatch: {a.scale} vs {b.scale}")
        ring = self.rings[a.level - 1]
        return CkksCiphertext(c0=ring.sub(a.c0, b.c0),
                              c1=ring.sub(a.c1, b.c1),
                              level=a.level, scale=a.scale, key_id=a.key_id)

    def add_plain(self, a: CkksCiphertext, values) -> CkksCiphertext:
        ring = self.rings[a.level - 1]
        if a.scale != Fraction(self.scale):
            raise ValueError("add_plain requires the fresh encoding scale; "
                             "rescale or re-encode first")
        m = self.encode(values, level=a.level)
        return CkksCiphertext(c0=ring.add(a.c0, m), c1=a.c1, level=a.level,
                              scale=a.scale, key_id=a.key_id)

    def _operands_ntt(self, ring: RnsPolyRing, a, b):
        """(fa0, fa1, fb0, fb1): the four operands' forward transforms, one
        launch per prime."""
        f = ring.to_ntt(stack([a.c0, a.c1, b.c0, b.c1]))
        return tuple(row(f, k) for k in range(4))

    def multiply(self, a: CkksCiphertext, b: CkksCiphertext
                 ) -> CkksCiphertext:
        """Tensor product per prime (NTT products mod the live chain; the
        scales multiply)."""
        if a.is_degree_2 or b.is_degree_2:
            raise ValueError("relinearize before multiplying degree-2")
        a, b = self._align(a, b)
        ring = self.rings[a.level - 1]
        fa0, fa1, fb0, fb1 = self._operands_ntt(ring, a, b)
        pw, add = ring.pointwise, ring.add
        d = ring.from_ntt(stack([pw(fa0, fb0),
                                 add(pw(fa0, fb1), pw(fa1, fb0)),
                                 pw(fa1, fb1)]))
        return CkksCiphertext(c0=row(d, 0), c1=row(d, 1), c2=row(d, 2),
                              level=a.level, scale=a.scale * b.scale,
                              key_id=a.key_id)

    def relinearize(self, ct: CkksCiphertext, relin_keys: list
                    ) -> CkksCiphertext:
        """RNS keyswitch at the ciphertext's level (core/rns.py gadget)."""
        if not ct.is_degree_2:
            return ct
        rlk: RnsRelinKey = relin_keys[ct.level]
        c0, c1 = rns_keyswitch(self.rings[ct.level - 1], ct.c0, ct.c1,
                               ct.c2, rlk.a, rlk.b)
        return CkksCiphertext(c0=c0, c1=c1, level=ct.level,
                              scale=ct.scale, key_id=ct.key_id)

    def _drop_last(self, ring: RnsPolyRing, poly):
        """(c_i - [c]_{q_L}) q_L^-1 mod q_i for i < L - 1."""
        L = ring.K
        q_last = ring.moduli[L - 1]
        out = []
        for i in range(L - 1):
            ri = ring.rings[i]
            c_last = lift(ring, poly[L - 1], L - 1, i)
            out.append(ri.scalar_mul(ri.sub(poly[i], c_last),
                                     pow(q_last % ri.q, -1, ri.q)))
        return tuple(out)

    def rescale(self, ct: CkksCiphertext) -> CkksCiphertext:
        """Exact RNS rescale: divide by the last live prime and drop it
        (the floor-division identity; the < 1 rounding error lands in the
        noise).  New scale = scale / q_L, exact."""
        if ct.level < 2:
            raise ValueError("no modulus left to rescale into")
        L = ct.level
        ring = self.rings[L - 1]
        q_last = ring.moduli[L - 1]
        return CkksCiphertext(
            c0=self._drop_last(ring, ct.c0), c1=self._drop_last(ring, ct.c1),
            c2=self._drop_last(ring, ct.c2) if ct.is_degree_2 else None,
            level=L - 1, scale=ct.scale / q_last, key_id=ct.key_id)

    # -- fused multiply + relinearize + rescale ----------------------------
    def _relin_key_ntt(self, rlk: RnsRelinKey, L: int):
        """The NTT form (ka, kb) of the level-L relin key (residue tuples a
        gadget component), computed once per chain and cached on the key
        under (N, moduli, device, the rings' transform layout): one forward
        launch a prime."""
        ring = self.rings[L - 1]
        # the layout of the transform domain is part of the key: a
        # DistPolyRing's NTT form is not a PolyRing's
        tag = (ring.n, tuple(ring.moduli), str(self.device),
               tuple(getattr(r, "ntt_layout", None) for r in ring.rings))
        if tag not in rlk.ntt_forms:
            f = ring.to_ntt(stack(list(rlk.a) + list(rlk.b)))
            rlk.ntt_forms[tag] = ([row(f, j) for j in range(L)],
                                  [row(f, L + j) for j in range(L)])
        return rlk.ntt_forms[tag]

    def _fused_mrr(self, L: int, a, b, ka_ntt, kb_ntt):
        """The JAX package's single-dispatch program (``_build_fused_mrr``)
        in its order of operations: NTT tensor product, the keyswitch
        accumulated in the NTT domain, two inverse transforms, the
        last-prime rescale."""
        ring = self.rings[L - 1]
        fa0, fa1, fb0, fb1 = self._operands_ntt(ring, a, b)
        acc0 = ring.pointwise(fa0, fb0)
        acc1 = ring.add(ring.pointwise(fa0, fb1), ring.pointwise(fa1, fb0))
        d2 = ring.from_ntt(ring.pointwise(fa1, fb1))
        tn = ring.to_ntt(stack(gadget_components(ring, d2)))
        for j in range(L):
            acc0 = ring.add(acc0, ring.pointwise(row(tn, j), kb_ntt[j]))
            acc1 = ring.add(acc1, ring.pointwise(row(tn, j), ka_ntt[j]))
        c = ring.from_ntt(stack([acc0, acc1]))
        return (self._drop_last(ring, row(c, 0)),
                self._drop_last(ring, row(c, 1)))

    def multiply_relin_rescale(self, a, b, relin_keys: list,
                               fused: bool | None = None) -> CkksCiphertext:
        """Leveled multiply.  ``fused=None`` takes the fused form on the
        card with the default rings, the eager three steps elsewhere and
        over a ``ring_factory``'s rings (as the JAX package does)."""
        if fused is None:
            fused = self.device.type == "cuda" and self._ring_factory is None
        if not fused:
            return self.rescale(self.relinearize(self.multiply(a, b),
                                                 relin_keys))
        if a.is_degree_2 or b.is_degree_2:
            raise ValueError("relinearize before multiplying degree-2")
        a, b = self._align(a, b)
        L = a.level
        if L < 2:
            raise ValueError("no modulus left to rescale into")
        ka_ntt, kb_ntt = self._relin_key_ntt(relin_keys[L], L)
        c0, c1 = self._fused_mrr(L, a, b, ka_ntt, kb_ntt)
        q_last = self.rings[L - 1].moduli[L - 1]
        return CkksCiphertext(c0=c0, c1=c1, level=L - 1,
                              scale=a.scale * b.scale / q_last,
                              key_id=a.key_id)
