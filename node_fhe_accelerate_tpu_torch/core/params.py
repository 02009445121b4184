"""Parameter sets and the NTT-prime table (counterpart of
node_fhe_accelerate_tpu/core/params.py; pure Python, so the port keeps its
own copy).

The reference's ``ParameterSet`` and presets with the values copied
exactly, so parameter-dependent behavior (noise budgets, decomposition
shapes, preset selection) matches the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum

__all__ = ["FHEScheme", "SecurityLevel", "Primes", "ParameterSet",
           "TFHE_128_FAST", "TFHE_128_BALANCED", "TFHE_256_SECURE",
           "BFV_128_SIMD", "CKKS_128_ML", "TFHE_128_VOTING", "PRESETS",
           "create_parameter_set"]


class FHEScheme(Enum):
    TFHE = "TFHE"
    BFV = "BFV"
    CKKS = "CKKS"


class SecurityLevel(Enum):
    BITS_128 = 128
    BITS_192 = 192
    BITS_256 = 256


class Primes:
    """NTT-friendly primes, q == 1 (mod 2N), under the reference's names.

    Four values of the reference's table are composite (Q_40_1 = 2^40+1 =
    257 * 4278255361, Q_40_2, Q_50_2, Q_30_2; see ops/primes.py); each is
    replaced by a genuine prime of the same bit width, as in the JAX
    package."""

    Q_60_1 = 1152921504606584833  # 2^60 - 2^18 + 1
    Q_60_2 = 1152921504598720513
    Q_60_3 = 1152921504597016577
    Q_50_1 = 1125899906826241     # 2^50 - 2^14 + 1
    Q_50_2 = 1125625028935681     # 2^50 - 2^38 + 1 (reference value composite)
    Q_50_3 = 1125899904679937     # 2^16 | q-1
    Q_40_1 = 1095216660481        # 2^40 - 2^32 + 1 (reference value composite)
    Q_40_2 = 1099510054913        # 2^19 | q-1 (reference value composite)
    Q_30_1 = 1073479681           # 2^30 - 2^18 + 1
    Q_30_2 = 1072496641           # c*2^16+1 (reference value composite)
    Q_TFHE_BOOT = 1 << 32         # power-of-two torus modulus


@dataclass
class ParameterSet:
    """FHE parameter set (parameter_set.h:70-244)."""

    scheme: FHEScheme = FHEScheme.TFHE
    security: SecurityLevel = SecurityLevel.BITS_128
    poly_degree: int = 1024
    moduli: list = field(default_factory=lambda: [Primes.Q_40_1])
    lwe_dimension: int = 742
    lwe_noise_std: float = 3.2e-11
    glwe_dimension: int = 1
    decomp_base_log: int = 23
    decomp_level: int = 1
    plaintext_modulus: int = 4
    # Derived (calculate_derived_parameters, parameter_set.cpp:44-78)
    noise_budget: float = 0.0
    max_mult_depth: int = 0

    def __post_init__(self):
        self.calculate_derived_parameters()

    @property
    def q(self) -> int:
        """Primary (first) modulus."""
        return self.moduli[0]

    @property
    def q_total(self) -> int:
        """Full RNS composite modulus."""
        out = 1
        for m in self.moduli:
            out *= m
        return out

    def get_log_modulus(self) -> float:
        return math.log2(float(self.q_total))

    def noise_std_absolute(self) -> float:
        """Encryption noise std in absolute integer units.

        The reference stores TFHE noise as a *fraction of the modulus*
        (sigma = 3.2e-11, parameter_set.cpp:108-137) but feeds it unscaled
        into an absolute-unit gaussian sampler (key_manager.cpp:85-110), so
        every preset's error rounds to zero and LWE security collapses
        (anyone can solve b = a*s exactly).  Here fractional stds (< 0.5)
        are scaled by q, and the result is clamped to >= 3.2 absolute — the
        standard minimum for discrete-gaussian LWE error.
        """
        s = self.lwe_noise_std
        if s < 0.5:
            # Scale by the FIRST modulus, not the composite Q: the
            # fraction-of-modulus convention is per-prime (torus-2^32
            # artifact).  Scaling by Q would explode sigma past the primes
            # themselves for RNS chains (|e| must stay < min q_i for the
            # int32 discrete-gaussian sampler, ops/sampling.py), and RLWE
            # security needs only absolute sigma >= ~3.2 (SEAL uses 3.19)
            # regardless of how many moduli the chain carries.
            s = s * float(self.moduli[0])
        return max(s, 3.2)

    def calculate_derived_parameters(self) -> None:
        log_q = self.get_log_modulus()
        # CKKS has no plaintext modulus (t=0): budget is scale-denominated
        # (one ~scale-sized modulus per multiplication level).
        log_t = math.log2(float(self.plaintext_modulus)) \
            if self.plaintext_modulus > 0 else 40.0
        if self.scheme == FHEScheme.TFHE:
            noise_term = math.log2(self.lwe_noise_std * math.sqrt(
                float(max(self.lwe_dimension, 1))))
            self.noise_budget = log_q - noise_term - 10.0
        else:
            self.noise_budget = log_q - log_t - 20.0
        self.noise_budget = max(self.noise_budget, 0.0)
        self.max_mult_depth = int(self.noise_budget / 10.0)
        if self.scheme == FHEScheme.TFHE and self.decomp_level > 0:
            self.max_mult_depth = 1000

    def __str__(self) -> str:
        return (
            f"ParameterSet(scheme={self.scheme.value}, "
            f"security={self.security.value}, N={self.poly_degree}, "
            f"moduli={self.moduli}, log2(q)={self.get_log_modulus():.1f}, "
            f"n_lwe={self.lwe_dimension}, k={self.glwe_dimension}, "
            f"baseLog={self.decomp_base_log}, level={self.decomp_level}, "
            f"t={self.plaintext_modulus})"
        )


# ---------------------------------------------------------------------------
# Presets (parameter_set.cpp:108-287)
# ---------------------------------------------------------------------------


def TFHE_128_FAST() -> ParameterSet:
    return ParameterSet(
        scheme=FHEScheme.TFHE, security=SecurityLevel.BITS_128,
        poly_degree=1024, moduli=[Primes.Q_40_1],
        lwe_dimension=742, lwe_noise_std=3.2e-11, glwe_dimension=1,
        decomp_base_log=23, decomp_level=1, plaintext_modulus=4,
    )


def TFHE_128_BALANCED() -> ParameterSet:
    return ParameterSet(
        scheme=FHEScheme.TFHE, security=SecurityLevel.BITS_128,
        poly_degree=2048, moduli=[Primes.Q_50_1],
        lwe_dimension=830, lwe_noise_std=2.9e-11, glwe_dimension=1,
        decomp_base_log=15, decomp_level=2, plaintext_modulus=8,
    )


def TFHE_256_SECURE() -> ParameterSet:
    return ParameterSet(
        scheme=FHEScheme.TFHE, security=SecurityLevel.BITS_256,
        poly_degree=4096, moduli=[Primes.Q_60_1],
        lwe_dimension=1024, lwe_noise_std=2.0e-12, glwe_dimension=1,
        decomp_base_log=10, decomp_level=3, plaintext_modulus=16,
    )


def BFV_128_SIMD() -> ParameterSet:
    return ParameterSet(
        scheme=FHEScheme.BFV, security=SecurityLevel.BITS_128,
        poly_degree=8192, moduli=[Primes.Q_60_1, Primes.Q_60_2, Primes.Q_60_3],
        lwe_dimension=0, lwe_noise_std=3.2, glwe_dimension=1,
        decomp_base_log=60, decomp_level=3, plaintext_modulus=65537,
    )


def CKKS_128_ML() -> ParameterSet:
    # Reference chain (parameter_set.cpp:226-259) uses Q_50_1 at N=16384,
    # but 2^15 does not divide Q_50_1 - 1 — Q_50_3 substituted (NTT-valid).
    return ParameterSet(
        scheme=FHEScheme.CKKS, security=SecurityLevel.BITS_128,
        poly_degree=16384,
        moduli=[Primes.Q_60_1, Primes.Q_50_3, Primes.Q_50_2,
                Primes.Q_40_1, Primes.Q_40_2],
        lwe_dimension=0, lwe_noise_std=3.2, glwe_dimension=1,
        decomp_base_log=40, decomp_level=5, plaintext_modulus=1 << 40,
    )


def TFHE_128_VOTING() -> ParameterSet:
    return ParameterSet(
        scheme=FHEScheme.TFHE, security=SecurityLevel.BITS_128,
        poly_degree=1024, moduli=[Primes.Q_40_1],
        lwe_dimension=742, lwe_noise_std=3.2e-11, glwe_dimension=1,
        decomp_base_log=23, decomp_level=1, plaintext_modulus=16,
    )


PRESETS = {
    "TFHE_128_FAST": TFHE_128_FAST,
    "TFHE_128_BALANCED": TFHE_128_BALANCED,
    "TFHE_256_SECURE": TFHE_256_SECURE,
    "BFV_128_SIMD": BFV_128_SIMD,
    "CKKS_128_ML": CKKS_128_ML,
    "TFHE_128_VOTING": TFHE_128_VOTING,
}


def create_parameter_set(name: str) -> ParameterSet:
    """Factory by preset name (parameter_set.cpp create_parameter_set)."""
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
