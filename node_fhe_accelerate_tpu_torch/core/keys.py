"""Key generation: secret, public and relinearization keys (counterpart of
node_fhe_accelerate_tpu/core/keys.py).

* secret key: a ternary polynomial (gaussian, binary and uniform also
  offered);
* public key: RLWE(0) = (a, b = a*s + e);
* relinearization key: per level an encryption of s^2 * base^i; on an
  RNS ring (core/rns.py) the RNS gadget's key, one encryption of
  (Q/q_j) s^2 per prime.

Each generator splits into its draws (``torch.Generator``, on the
generator's device) and an arithmetic half that takes the draws as limb
planes (``public_key_from_draws``, ``relin_key_from_draws``), so the tests
feed the JAX package's own draws to the arithmetic and compare the keys bit
for bit.  Threshold sharing is core/threshold.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any

import torch

from ..ops.sampling import binary_planes
from .params import ParameterSet
from .poly import PolyRing

__all__ = ["SecretKey", "PublicKey", "RelinKey", "KeyManager",
           "SecretKeyDistribution"]


class SecretKeyDistribution(Enum):
    TERNARY = "ternary"
    GAUSSIAN = "gaussian"
    BINARY = "binary"
    UNIFORM = "uniform"


@dataclass
class SecretKey:
    poly: Any          # limb planes (N,)
    key_id: int = 0


@dataclass
class PublicKey:
    a: Any
    b: Any             # b = a*s + e
    key_id: int = 0


@dataclass
class RelinKey:
    """keys[i] = (a_i, b_i) with b_i = a_i*s + e_i + s^2 * base^i."""
    a: list
    b: list
    decomp_base_log: int
    decomp_level: int
    key_id: int = 0


class KeyManager:
    """Generates key material for a parameter set on the ring's device."""

    def __init__(self, params: ParameterSet, ring: PolyRing | None = None,
                 noise_std: float | None = None, device=None):
        """``noise_std=None`` derives real key noise from the parameter set
        (``ParameterSet.noise_std_absolute``); an explicit value, 0.0
        included, overrides it, for exactness tests only (a noiseless
        public key b = a*s gives the secret away)."""
        self.params = params
        self.ring = ring or PolyRing(params.poly_degree, params.moduli[0],
                                     device)
        self._noise_override = noise_std

    def _noise_std(self) -> float:
        if self._noise_override is not None:
            return self._noise_override
        return self.params.noise_std_absolute()

    def generate_secret_key(
            self, gen: torch.Generator,
            distribution=SecretKeyDistribution.TERNARY,
            key_id: int = 0) -> SecretKey:
        ring = self.ring
        if distribution == SecretKeyDistribution.TERNARY:
            p = ring.sample_ternary(gen)
        elif distribution == SecretKeyDistribution.GAUSSIAN:
            p = ring.sample_gaussian(gen, self._noise_std())
        elif distribution == SecretKeyDistribution.BINARY:
            p = (ring.sample_binary(gen) if hasattr(ring, "sample_binary")
                 else binary_planes(gen, (ring.n,), ring.device))
        else:
            p = ring.sample_uniform(gen)
        return SecretKey(poly=p, key_id=key_id)

    # -- public key -------------------------------------------------------
    def generate_public_key(self, gen: torch.Generator,
                            sk: SecretKey) -> PublicKey:
        """pk = (a, b = a*s + e), an RLWE encryption of zero."""
        a = self.ring.sample_uniform(gen)
        e = self.ring.sample_gaussian(gen, self._noise_std())
        return self.public_key_from_draws(sk, a, e)

    def public_key_from_draws(self, sk: SecretKey, a, e) -> PublicKey:
        ring = self.ring
        b = ring.add(ring.multiply(a, sk.poly), e)
        return PublicKey(a=a, b=b, key_id=sk.key_id)

    # -- relinearization key ---------------------------------------------
    def relin_levels(self, decomp_base_log: int = 0,
                     decomp_level: int = 0) -> tuple[int, int]:
        """(base_log, levels): the level count is raised to
        ceil(bits(q) / base_log), so the digits cover the whole of c2 mod
        q (uncovered top bits would turn into noise of 2^uncovered
        ||s^2||)."""
        base_log = decomp_base_log or self.params.decomp_base_log
        levels = decomp_level or self.params.decomp_level
        q_bits = int(self.ring.q).bit_length()
        return base_log, max(levels, -(-q_bits // base_log))

    def generate_relin_key(self, gen: torch.Generator, sk: SecretKey,
                           decomp_base_log: int = 0,
                           decomp_level: int = 0) -> RelinKey:
        """Encrypt s^2 * base^i per level: draws (a_i, e_i) level by
        level.  On an RNS ring, the RNS gadget's key
        (``RnsKeySet.generate_relin_key``; the digit arguments are
        ignored)."""
        if getattr(self.ring, "rings", None) is not None:
            from .rns import RnsKeySet
            return RnsKeySet(self.ring, self._noise_std()).generate_relin_key(
                gen, sk)
        base_log, levels = self.relin_levels(decomp_base_log, decomp_level)
        a_list, e_list = [], []
        for _ in range(levels):
            a_list.append(self.ring.sample_uniform(gen))
            e_list.append(self.ring.sample_gaussian(gen, self._noise_std()))
        return self.relin_key_from_draws(sk, a_list, e_list, base_log)

    def relin_key_from_draws(self, sk: SecretKey, a_list, e_list,
                             base_log: int) -> RelinKey:
        ring = self.ring
        s2 = ring.multiply(sk.poly, sk.poly)
        b_list = []
        power = 1
        for a, e in zip(a_list, e_list):
            b = ring.add(ring.multiply(a, sk.poly), e)
            b_list.append(ring.add(b, ring.scalar_mul(s2, power)))
            power = (power * (1 << base_log)) % ring.q
        return RelinKey(a=list(a_list), b=b_list, decomp_base_log=base_log,
                        decomp_level=len(a_list), key_id=sk.key_id)
