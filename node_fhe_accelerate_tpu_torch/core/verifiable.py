"""Verifiable encryption: sigma-protocol proofs of correct RLWE encryption
and of threshold partial decryptions (counterpart of
node_fhe_accelerate_tpu/core/verifiable.py).

A commitment to fresh randomness, a Fiat-Shamir challenge from the hashed
commitments, and a linear response checked over the ring:

    a * z_u + z_e == w + gamma * c     (per ciphertext component)

``_hash_polys`` hashes the same bytes as the JAX package's (each
polynomial's uint64 coefficients, little-endian), so a proof made from the
same draws is equal field for field.  Each prover splits into its draws (a
``torch.Generator``) and a ``*_from_draws`` arithmetic half.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from .encrypt import Ciphertext, EncryptionEngine
from .keys import PublicKey
from .poly import PolyRing
from ..ops.u64 import u64_to_np

__all__ = ["EncryptionProof", "VerifiableEncryption", "VoterReceipt",
           "ShareCommitment", "DecryptionProof", "VerifiableDecryption"]


def _hash_polys(*polys, q: int) -> int:
    h = hashlib.sha256()
    for p in polys:
        h.update(np.ascontiguousarray(u64_to_np(p)).tobytes())
    # a small challenge space, like the reference's hashed commitments
    return int.from_bytes(h.digest(), "little") % (1 << 32)


def _equal(x, y) -> bool:
    return np.array_equal(u64_to_np(x), u64_to_np(y))


@dataclass
class EncryptionProof:
    w0: tuple                 # commitment for the c0 relation
    w1: tuple                 # commitment for the c1 relation
    z_u: tuple                # response: r_u + gamma * u
    z_e0: tuple               # r_e0 + gamma * (e1 + m)
    z_e1: tuple               # r_e1 + gamma * e2
    gamma: int


class VerifiableEncryption:
    def __init__(self, engine: EncryptionEngine):
        self.engine = engine
        self.ring: PolyRing = engine.ring

    def encrypt_with_proof(self, gen: torch.Generator, value: int,
                           pk: PublicKey) -> tuple:
        """(ciphertext, proof of well-formedness).  Draws u, e1, e2 (the
        encryption's randomness) and r_u, r_e0, r_e1 (the commitments')."""
        ring = self.ring
        std = self.engine._noise_std
        u = ring.sample_ternary(gen)
        e1 = ring.sample_gaussian(gen, std)
        e2 = ring.sample_gaussian(gen, std)
        r_u = ring.sample_uniform(gen)
        r_e0 = ring.sample_uniform(gen)
        r_e1 = ring.sample_uniform(gen)
        return self.encrypt_with_proof_from_draws(value, pk, u, e1, e2, r_u,
                                                  r_e0, r_e1)

    def encrypt_with_proof_from_draws(self, value: int, pk: PublicKey, u,
                                      e1, e2, r_u, r_e0, r_e1) -> tuple:
        """The relation holds exactly: c0 = pk.b * u + (e1 + m),
        c1 = pk.a * u + e2."""
        ring = self.ring
        eng = self.engine
        m = eng.encode(value)
        ct = eng.encrypt_from_draws(value, pk, u, e1, e2)
        w0 = ring.add(ring.multiply(pk.b, r_u), r_e0)
        w1 = ring.add(ring.multiply(pk.a, r_u), r_e1)
        gamma = _hash_polys(pk.a, pk.b, ct.c0, ct.c1, w0, w1, q=ring.q)
        z_u = ring.add(r_u, ring.scalar_mul(u, gamma))
        z_e0 = ring.add(r_e0, ring.scalar_mul(ring.add(e1, m), gamma))
        z_e1 = ring.add(r_e1, ring.scalar_mul(e2, gamma))
        return ct, EncryptionProof(w0=w0, w1=w1, z_u=z_u, z_e0=z_e0,
                                   z_e1=z_e1, gamma=gamma)

    def verify(self, ct: Ciphertext, proof: EncryptionProof,
               pk: PublicKey) -> bool:
        """Both linear relations and the Fiat-Shamir challenge."""
        ring = self.ring
        gamma = _hash_polys(pk.a, pk.b, ct.c0, ct.c1, proof.w0, proof.w1,
                            q=ring.q)
        if gamma != proof.gamma:
            return False
        # pk.b * z_u + z_e0 == w0 + gamma * c0
        lhs0 = ring.add(ring.multiply(pk.b, proof.z_u), proof.z_e0)
        rhs0 = ring.add(proof.w0, ring.scalar_mul(ct.c0, gamma))
        # pk.a * z_u + z_e1 == w1 + gamma * c1
        lhs1 = ring.add(ring.multiply(pk.a, proof.z_u), proof.z_e1)
        rhs1 = ring.add(proof.w1, ring.scalar_mul(ct.c1, gamma))
        return _equal(lhs0, rhs0) and _equal(lhs1, rhs1)


# ---------------------------------------------------------------------------
# Decryption proofs
# ---------------------------------------------------------------------------


@dataclass
class ShareCommitment:
    """Public commitment to a threshold key share, (a, b = a*s_i + e),
    published at the key ceremony so partial decryptions are
    verifiable."""
    share_id: int
    a: tuple
    b: tuple


@dataclass
class DecryptionProof:
    """Proof that a partial decryption p = c1 * s_i used the same s_i as
    the published share commitment:

        a * z_s + z_e == w_a + gamma * b        (knowledge of s_i, e)
        c1 * z_s      == w_c + gamma * p        (the same s_i decrypted)
    """
    share_id: int
    w_a: tuple
    w_c: tuple
    z_s: tuple
    z_e: tuple
    gamma: int


class VerifiableDecryption:
    """Prover and verifier of threshold partial decryptions (the partial
    decryption itself is core/threshold.py ``partial_decrypt``)."""

    def __init__(self, ring: PolyRing):
        self.ring = ring

    def commit_share(self, gen: torch.Generator, share) -> tuple:
        """(ShareCommitment, e_noise); the official keeps e_noise secret
        beside the share and publishes the commitment."""
        a = self.ring.sample_uniform(gen)
        e = self.ring.sample_gaussian(gen, 3.2)
        return self.commit_share_from_draws(share, a, e)

    def commit_share_from_draws(self, share, a, e) -> tuple:
        b = self.ring.add(self.ring.multiply(a, share.share_poly), e)
        return ShareCommitment(share_id=share.share_id, a=a, b=b), e

    def prove(self, gen: torch.Generator, share, e_noise,
              commitment: ShareCommitment, c1, partial) -> DecryptionProof:
        r_s = self.ring.sample_uniform(gen)
        r_e = self.ring.sample_uniform(gen)
        return self.prove_from_draws(share, e_noise, commitment, c1, partial,
                                     r_s, r_e)

    def prove_from_draws(self, share, e_noise, commitment: ShareCommitment,
                         c1, partial, r_s, r_e) -> DecryptionProof:
        ring = self.ring
        w_a = ring.add(ring.multiply(commitment.a, r_s), r_e)
        w_c = ring.multiply(c1, r_s)
        gamma = _hash_polys(commitment.a, commitment.b, c1, partial.partial,
                            w_a, w_c, q=ring.q)
        z_s = ring.add(r_s, ring.scalar_mul(share.share_poly, gamma))
        z_e = ring.add(r_e, ring.scalar_mul(e_noise, gamma))
        return DecryptionProof(share_id=share.share_id, w_a=w_a, w_c=w_c,
                               z_s=z_s, z_e=z_e, gamma=gamma)

    def verify(self, commitment: ShareCommitment, c1, partial,
               proof: DecryptionProof) -> bool:
        ring = self.ring
        if proof.share_id != commitment.share_id:
            return False
        gamma = _hash_polys(commitment.a, commitment.b, c1, partial.partial,
                            proof.w_a, proof.w_c, q=ring.q)
        if gamma != proof.gamma:
            return False
        lhs_a = ring.add(ring.multiply(commitment.a, proof.z_s), proof.z_e)
        rhs_a = ring.add(proof.w_a, ring.scalar_mul(commitment.b, gamma))
        lhs_c = ring.multiply(c1, proof.z_s)
        rhs_c = ring.add(proof.w_c, ring.scalar_mul(partial.partial, gamma))
        return _equal(lhs_a, rhs_a) and _equal(lhs_c, rhs_c)


@dataclass
class VoterReceipt:
    """Hash receipt binding a ballot to its proof."""
    ballot_hash: str
    proof_hash: str

    @classmethod
    def create(cls, ct: Ciphertext, proof: EncryptionProof) -> "VoterReceipt":
        bh = hashlib.sha256(
            np.ascontiguousarray(u64_to_np(ct.c0)).tobytes()
            + np.ascontiguousarray(u64_to_np(ct.c1)).tobytes()).hexdigest()
        ph = hashlib.sha256(
            np.ascontiguousarray(u64_to_np(proof.w0)).tobytes()
            + proof.gamma.to_bytes(8, "little")).hexdigest()
        return cls(ballot_hash=bh, proof_hash=ph)

    def matches(self, ct: Ciphertext, proof: EncryptionProof) -> bool:
        fresh = VoterReceipt.create(ct, proof)
        return (fresh.ballot_hash == self.ballot_hash
                and fresh.proof_hash == self.proof_hash)
