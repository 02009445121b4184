"""Threshold (M-of-N) key sharing and distributed decryption (counterpart
of node_fhe_accelerate_tpu/core/threshold.py).

* a Shamir sharing polynomial over Z_q, applied coefficient by coefficient
  to the secret key; share_i = sum_j coeff_j * i^j at the points 1..N;
* partial decryption p_i = c1 * share_i (a ring product: K8 on the card);
* combination: phase = c0 - sum_i lambda_i * p_i with the Lagrange weights
  at 0.

``generate_threshold_keys`` draws the secret and the coefficients from a
``torch.Generator``; ``threshold_keys_from_draws`` is its arithmetic half.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .keys import SecretKey
from .poly import PolyRing

__all__ = ["SecretKeyShare", "PartialDecryption", "ThresholdKeys",
           "generate_threshold_keys", "threshold_keys_from_draws",
           "partial_decrypt", "combine_partial_decryptions",
           "lagrange_coefficient"]


@dataclass
class SecretKeyShare:
    share_id: int          # evaluation point (1-based)
    share_poly: Any        # limb planes (N,)


@dataclass
class PartialDecryption:
    share_id: int
    partial: Any           # limb planes (N,)


@dataclass
class ThresholdKeys:
    threshold: int
    total_shares: int
    shares: list           # of SecretKeyShare
    master_sk: SecretKey   # kept for tests; a deployment would discard it


def lagrange_coefficient(i: int, indices: list, q: int) -> int:
    """lambda_i = prod_{j != i} x_j / (x_j - x_i) mod q, at 0."""
    num, den = 1, 1
    for j in indices:
        if j == i:
            continue
        num = num * j % q
        den = den * ((j - i) % q) % q
    return num * pow(den, -1, q) % q


def generate_threshold_keys(gen: torch.Generator, ring: PolyRing,
                            threshold: int,
                            total_shares: int) -> ThresholdKeys:
    """Shamir-share a fresh ternary secret key coefficient-wise: draws the
    key, then threshold - 1 uniform coefficient polynomials."""
    if threshold == 0 or threshold > total_shares:
        raise ValueError("invalid threshold parameters")
    sk_poly = ring.sample_ternary(gen)
    coeffs = [ring.sample_uniform(gen) for _ in range(1, threshold)]
    return threshold_keys_from_draws(ring, threshold, total_shares,
                                     sk_poly, coeffs)


def threshold_keys_from_draws(ring: PolyRing, threshold: int,
                              total_shares: int, sk_poly,
                              coeffs: list) -> ThresholdKeys:
    if threshold == 0 or threshold > total_shares \
            or len(coeffs) != threshold - 1:
        raise ValueError("invalid threshold parameters")
    polys = [sk_poly] + list(coeffs)
    shares = []
    for i in range(1, total_shares + 1):
        acc = None
        power = 1
        for c in polys:
            term = ring.scalar_mul(c, power)
            acc = term if acc is None else ring.add(acc, term)
            power = power * i % ring.q
        shares.append(SecretKeyShare(share_id=i, share_poly=acc))
    return ThresholdKeys(threshold=threshold, total_shares=total_shares,
                         shares=shares,
                         master_sk=SecretKey(poly=sk_poly, key_id=0))


def partial_decrypt(ring: PolyRing, c1, share: SecretKeyShare
                    ) -> PartialDecryption:
    """p_i = c1 * share_i."""
    return PartialDecryption(share_id=share.share_id,
                             partial=ring.multiply(c1, share.share_poly))


def combine_partial_decryptions(ring: PolyRing, c0, partials: list,
                                threshold: int):
    """phase = c0 - sum lambda_i * p_i: with >= threshold shares, sum
    lambda_i * share_i = sk, so this equals c0 - c1*sk."""
    if len(partials) < threshold:
        raise ValueError(
            f"not enough partial decryptions: {len(partials)} < {threshold}")
    use = partials[:threshold]
    indices = [p.share_id for p in use]
    acc = None
    for p in use:
        lam = lagrange_coefficient(p.share_id, indices, ring.q)
        term = ring.scalar_mul(p.partial, lam)
        acc = term if acc is None else ring.add(acc, term)
    return ring.sub(c0, acc)
