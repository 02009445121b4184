"""NTT-friendly prime table (counterpart of the ``Primes`` class of
node_fhe_accelerate_tpu/core/params.py).  The ``ParameterSet`` presets come
with the port of the RLWE stack."""
from __future__ import annotations

__all__ = ["Primes"]


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
