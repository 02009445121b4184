"""Security validation of FHE parameter sets (counterpart of
node_fhe_accelerate_tpu/core/security.py; pure Python, the port's own copy
over its ``ops/primes.is_prime``).

Twin of the reference's `SecurityValidator` (cpp/src/security_validator.cpp,
cpp/include/security_validator.h:85) and its richer TS implementation
(src/parameters/security-validator.ts:212-662): min degree / LWE dimension per
security level, max log q per degree (homomorphicencryption.org-style table),
NTT-friendliness, and RLWE/TFHE security-bit estimation with the same
interpolation scheme.  Adds primality validation of every modulus — the
reference ships composite "NTT primes" (see ops/primes.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum

from .params import ParameterSet, FHEScheme, SecurityLevel
from ..ops.primes import is_prime

__all__ = [
    "SecurityViolation", "ValidationResult", "SecurityValidator",
    "estimate_rlwe_security_bits", "estimate_tfhe_security_bits",
]


class SecurityViolation(Enum):
    POLY_DEGREE_NOT_POWER_OF_TWO = "POLY_DEGREE_NOT_POWER_OF_TWO"
    POLY_DEGREE_TOO_SMALL = "POLY_DEGREE_TOO_SMALL"
    MODULUS_TOO_LARGE = "MODULUS_TOO_LARGE"
    MODULUS_NOT_NTT_FRIENDLY = "MODULUS_NOT_NTT_FRIENDLY"
    MODULUS_COMPOSITE = "MODULUS_COMPOSITE"
    LWE_DIMENSION_TOO_SMALL = "LWE_DIMENSION_TOO_SMALL"
    NOISE_TOO_SMALL = "NOISE_TOO_SMALL"


@dataclass
class ValidationResult:
    is_secure: bool = True
    estimated_bits: float = 0.0
    violations: list = field(default_factory=list)

    def add(self, code: SecurityViolation, message: str):
        self.is_secure = False
        self.violations.append((code, message))


# security-validator.ts:270-277 (homomorphicencryption.org standard)
_MAX_LOG_Q = {
    1024: {128: 27, 192: 19, 256: 14},
    2048: {128: 54, 192: 37, 256: 29},
    4096: {128: 109, 192: 75, 256: 58},
    8192: {128: 218, 192: 152, 256: 118},
    16384: {128: 438, 192: 305, 256: 237},
    32768: {128: 881, 192: 611, 256: 476},
}
_MIN_DEGREE = {128: 1024, 192: 2048, 256: 4096}
_MIN_LWE_DIM = {128: 630, 192: 880, 256: 1024}


def estimate_rlwe_security_bits(poly_degree: int, log_q: float) -> float:
    """security-validator.ts:estimateRlweSecurityBits (:264-310)."""
    degrees = sorted(_MAX_LOG_Q)
    closest = degrees[0]
    for d in degrees:
        if d <= poly_degree:
            closest = d
    b = _MAX_LOG_Q[closest]
    if log_q <= b[256]:
        return 256.0
    if log_q <= b[192]:
        ratio = (log_q - b[256]) / (b[192] - b[256])
        return 256 - ratio * 64
    if log_q <= b[128]:
        ratio = (log_q - b[192]) / (b[128] - b[192])
        return 192 - ratio * 64
    return max(0.0, 128 * b[128] / log_q)


def estimate_tfhe_security_bits(lwe_dim: int, poly_degree: int,
                                log_q: float) -> float:
    """security-validator.ts:estimateTfheSecurityBits (:323-380)."""
    n = lwe_dim
    if n >= 1024:
        lwe = 256.0
    elif n >= 880:
        lwe = 192 + (n - 880) * 64 / 144
    elif n >= 630:
        lwe = 128 + (n - 630) * 64 / 250
    elif n >= 450:
        lwe = 80 + (n - 450) * 48 / 180
    else:
        lwe = max(0.0, n * 80 / 450)

    N = poly_degree
    if N >= 4096:
        glwe = 256.0
    elif N >= 2048:
        glwe = 192.0
    elif N >= 1024:
        glwe = 128.0
    elif N >= 512:
        glwe = 80.0
    else:
        glwe = max(0.0, N * 80 / 512)
    if log_q > 64:
        glwe = max(0.0, glwe - (log_q - 64) * 2)
    return min(lwe, glwe)


class SecurityValidator:
    """Parameter-set validation (security_validator.h:85)."""

    def validate(self, params: ParameterSet) -> ValidationResult:
        res = ValidationResult()
        N = params.poly_degree
        sec = params.security.value
        log_q = params.get_log_modulus()

        if N & (N - 1):
            res.add(SecurityViolation.POLY_DEGREE_NOT_POWER_OF_TWO,
                    f"poly_degree {N} is not a power of two")
        if N < _MIN_DEGREE.get(sec, 1024):
            res.add(SecurityViolation.POLY_DEGREE_TOO_SMALL,
                    f"poly_degree {N} < {_MIN_DEGREE[sec]} for {sec}-bit")

        for q in params.moduli:
            if not is_prime(q):
                res.add(SecurityViolation.MODULUS_COMPOSITE,
                        f"modulus {q} is composite")
            elif (q - 1) % (2 * N) != 0:
                res.add(SecurityViolation.MODULUS_NOT_NTT_FRIENDLY,
                        f"modulus {q} != 1 mod 2N for N={N}")

        # Effective noise in absolute integer units must not round to zero:
        # the reference's presets feed fractional stds (3.2e-11) into an
        # absolute-unit sampler, silently producing error-free LWE
        # (key_manager.cpp:85-110) — broken regardless of dimensions.
        eff = params.lwe_noise_std
        if eff < 0.5:
            # per-prime convention, matching ParameterSet.noise_std_absolute
            # (scaling by the composite Q would overestimate RNS noise and
            # mask degenerate configurations)
            eff = eff * float(params.moduli[0])
        if eff < 3.2:
            res.add(SecurityViolation.NOISE_TOO_SMALL,
                    f"effective noise std {eff:.3g} (absolute units) < 3.2; "
                    "LWE samples would be (nearly) error-free")

        if params.scheme == FHEScheme.TFHE:
            if params.lwe_dimension < _MIN_LWE_DIM.get(sec, 630):
                res.add(SecurityViolation.LWE_DIMENSION_TOO_SMALL,
                        f"n_lwe {params.lwe_dimension} < "
                        f"{_MIN_LWE_DIM[sec]} for {sec}-bit")
            res.estimated_bits = estimate_tfhe_security_bits(
                params.lwe_dimension, N, log_q)
        else:
            if log_q > _MAX_LOG_Q.get(N, _MAX_LOG_Q[32768])[sec]:
                res.add(SecurityViolation.MODULUS_TOO_LARGE,
                        f"log q {log_q:.1f} exceeds max for N={N}, {sec}-bit")
            res.estimated_bits = estimate_rlwe_security_bits(N, log_q)

        if res.estimated_bits < sec and res.is_secure:
            res.is_secure = False
            res.violations.append((
                SecurityViolation.MODULUS_TOO_LARGE,
                f"estimated {res.estimated_bits:.0f} bits < target {sec}"))
        return res
