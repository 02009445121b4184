"""Cryptographic randomness for ZK provers (counterpart of
node_fhe_accelerate_tpu/zk/rand.py).

Every prover draws scalars through `ScalarRng`, which defaults to the OS
CSPRNG (`secrets.randbelow` -- rejection sampling, uniform and
unpredictable).  A seeded mode exists strictly for reproducible tests and is
clearly marked insecure; it draws the JAX package's numbers from the same
seed.
"""
from __future__ import annotations

import secrets

import numpy as np

__all__ = ["ScalarRng"]


class ScalarRng:
    """Uniform scalars in [0, order).

    * ``seed=None`` (default): OS CSPRNG via ``secrets.randbelow`` -- use for
      all real blinding factors, setup toxic waste, and prover randomness.
    * ``seed=<int>``: deterministic numpy PRNG -- **tests only**; predictable
      blindings break hiding/zero-knowledge entirely.
    """

    def __init__(self, order: int, seed: int | None = None):
        if order <= 1:
            raise ValueError("order must be > 1")
        self.order = order
        self._rng = None if seed is None else np.random.default_rng(seed)

    @property
    def deterministic(self) -> bool:
        return self._rng is not None

    def scalar(self) -> int:
        if self._rng is None:
            return secrets.randbelow(self.order)
        # 40 bytes >> 32-byte orders: modulo bias < 2^-64 (test mode only).
        return int.from_bytes(self._rng.bytes(40), "little") % self.order

    def scalars(self, n: int) -> list:
        return [self.scalar() for _ in range(n)]
