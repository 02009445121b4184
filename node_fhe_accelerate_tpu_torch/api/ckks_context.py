"""CkksContext, a key-owning wrapper for approximate (CKKS) arithmetic
(counterpart of node_fhe_accelerate_tpu/api/ckks_context.py).

It wraps the leveled CKKS of core/ckks.py over the whole chain: encrypt
real or complex vectors, add and multiply with the relinearize and rescale
built in, decrypt back to floats.  Keys and encryptions draw from one
``torch.Generator`` on the context's device, seeded from ``rng_seed``: the
secret key, the public key and the relin keys in that order, then one
encryption after another.
"""
from __future__ import annotations

from fractions import Fraction

import torch

from ..core.ckks import CkksCiphertext, CkksEngine
from ..core.params import ParameterSet, create_parameter_set

__all__ = ["CkksContext"]


class CkksContext:
    def __init__(self, params: ParameterSet | str = "CKKS_128_ML",
                 scale: int | None = None, rng_seed: int = 0, device=None):
        if isinstance(params, str):
            params = create_parameter_set(params)
        self.engine = CkksEngine(params, scale=scale, device=device)
        self.gen = torch.Generator(
            device=self.engine.device).manual_seed(rng_seed)
        self.sk = self.engine.generate_secret_key(self.gen)
        self.pk = self.engine.generate_public_key(self.gen, self.sk)
        self.relin_keys = self.engine.generate_relin_keys(self.gen, self.sk)

    # -- one-call ops --------------------------------------------------------
    def encrypt(self, values):
        """Real or complex vector (up to N/2 slots) -> ciphertext."""
        return self.engine.encrypt(self.gen, values, self.pk)

    def decrypt(self, ct, num_slots: int | None = None):
        return self.engine.decrypt(ct, self.sk, num_slots)

    def add(self, a, b):
        return self.engine.add(a, b)

    def subtract(self, a, b):
        return self.engine.sub(a, b)

    def multiply(self, a, b):
        """Full multiply: tensor, relinearize, rescale (drops one level)."""
        return self.engine.multiply_relin_rescale(a, b, self.relin_keys)

    def add_plain(self, a, values):
        return self.engine.add_plain(a, values)

    @property
    def levels_remaining(self):
        return self.engine.K

    def dot(self, cts: list, weights: list):
        """Encrypted weighted sum sum_i w_i ct_i: the plaintext weights ride
        the encoder, one rescale at the end keeps the scales aligned."""
        if len(cts) != len(weights):
            raise ValueError("weights must match ciphertexts")
        acc = None
        n_slots = self.engine.params.poly_degree // 2
        for ct, w in zip(cts, weights):
            # the weight in every slot (a slotwise product zeroes the rest)
            m = self.engine.encode([complex(w)] * n_slots, level=ct.level)
            ring = self.engine.rings[ct.level - 1]
            term_c0 = ring.multiply(ct.c0, m)
            term_c1 = ring.multiply(ct.c1, m)
            term = CkksCiphertext(
                c0=term_c0, c1=term_c1, level=ct.level,
                scale=ct.scale * Fraction(self.engine.scale),
                key_id=ct.key_id)
            acc = term if acc is None else self.engine.add(acc, term)
        return self.engine.rescale(acc)
