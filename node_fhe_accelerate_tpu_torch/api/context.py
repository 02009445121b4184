"""FHEContext, a key-owning wrapper with the preset factories
(counterpart of node_fhe_accelerate_tpu/api/context.py).

It bundles an engine with its generated keys (secret, public, relin and,
when asked, threshold shares) and offers one-call encrypt, decrypt and
ops; the factories mirror the reference's createFast/Balanced/Secure/SIMD/
ML/Voting contexts (fhe-context.ts:300-364).  ``**kw`` of a factory goes to
``FHEEngine`` (``tfhe_params``, ``rng_seed``, ``device``).
"""
from __future__ import annotations

from typing import Optional

from ..core import threshold as th
from .engine import FHEEngine, create_fhe_engine

__all__ = ["FHEContext"]


class FHEContext:
    def __init__(self, engine: FHEEngine, threshold_config=None):
        self.engine = engine
        self.sk = engine.generate_secret_key()
        self.pk = engine.generate_public_key(self.sk)
        self.rlk = engine.generate_eval_key(self.sk)
        self.threshold_keys: Optional[th.ThresholdKeys] = None
        if threshold_config is not None:
            t, n = threshold_config
            self.threshold_keys = engine.generate_threshold_keys(t, n)

    # -- factories (fhe-context.ts:300-364) ---------------------------------
    @classmethod
    def create(cls, preset: str = "TFHE_128_FAST", threshold=None,
               **kw) -> "FHEContext":
        return cls(create_fhe_engine(preset, **kw), threshold_config=threshold)

    @classmethod
    def create_fast(cls, **kw):
        return cls.create("TFHE_128_FAST", **kw)

    @classmethod
    def create_balanced(cls, **kw):
        return cls.create("TFHE_128_BALANCED", **kw)

    @classmethod
    def create_secure(cls, **kw):
        return cls.create("TFHE_256_SECURE", **kw)

    @classmethod
    def create_simd(cls, **kw):
        return cls.create("BFV_128_SIMD", **kw)

    @classmethod
    def create_ml(cls, **kw):
        return cls.create("CKKS_128_ML", **kw)

    @classmethod
    def create_voting(cls, threshold=(3, 5), **kw):
        """3-of-5 threshold voting context (fhe-context.ts:356)."""
        return cls.create("TFHE_128_VOTING", threshold=threshold, **kw)

    # -- one-call ops --------------------------------------------------------
    def encrypt(self, value):
        return self.engine.encrypt_value(value, self.pk) \
            if isinstance(value, int) \
            else self.engine.encrypt_packed(value, self.pk)

    def decrypt(self, ct) -> int:
        return self.engine.decrypt_value(ct, self.sk)

    def decrypt_packed(self, ct, n: int):
        return self.engine.decrypt_packed(ct, self.sk, n)

    def add(self, a, b):
        return self.engine.add(a, b)

    def subtract(self, a, b):
        return self.engine.subtract(a, b)

    def multiply(self, a, b):
        return self.engine.multiply_relin(a, b, self.rlk)

    def noise_budget(self, ct) -> float:
        return self.engine.get_noise_budget(ct, self.sk)
