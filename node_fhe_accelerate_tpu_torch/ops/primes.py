"""Host-side prime utilities for NTT-friendly modulus selection (a copy of
node_fhe_accelerate_tpu/ops/primes.py: pure Python, so the port keeps its
own).

The reference ships a table of "NTT primes" (cpp/src/parameter_set.cpp:22-42)
of which four are **composite** (verified by Miller-Rabin):

    Q_40_1 = 1099511627777  = 2^40 + 1 = 257 * 4278255361   (comment claims
             "2^40 - 2^13 + 1"; the claimed value is divisible by 5)
    Q_40_2 = 1099511562241, Q_50_2 = 1125899906793473, Q_30_2 = 1073217537

Q_40_1 is the modulus of every TFHE preset at N=1024 — and since
257 - 1 = 256 < 2N, *no* psi with psi^N = -1 exists mod it, so the
reference's own primitive-root search (ntt_processor.cpp:110-126, an O(q)
loop) can never have completed on its TFHE parameters.  The TS executable
spec's table (ntt-round-trip.prop.test.ts:30-43) has composite entries at
degrees >= 2048 as well.

This build therefore (a) validates moduli before use and fails fast, and
(b) substitutes same-bit-width genuine NTT primes in the presets
(core/params.py documents each substitution).
"""
from __future__ import annotations

__all__ = [
    "is_prime",
    "two_adicity",
    "is_ntt_friendly",
    "find_ntt_prime",
    "find_generator_2n",
]

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all u64)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def two_adicity(n: int) -> int:
    """Largest e with 2^e | n."""
    if n == 0:
        return 0
    return ((n & -n).bit_length()) - 1


def is_ntt_friendly(q: int, degree: int) -> bool:
    """q prime and q == 1 (mod 2N) — the negacyclic-NTT requirement."""
    return (q - 1) % (2 * degree) == 0 and is_prime(q)


def find_ntt_prime(bits: int, degree: int, below: int | None = None) -> int:
    """Largest prime q with q.bit_length() == bits and 2N | q - 1.

    Prefers Solinas forms 2^bits - 2^m + 1 (cheapest reduction on limb
    planes); falls back to a descending scan of q = c * 2^a + 1.
    """
    two_n = 2 * degree
    a = max(two_adicity(two_n), two_n.bit_length() - 1)
    # Solinas first: q = 2^bits - 2^m + 1, need 2N | 2^m so m >= log2(2N)
    for m in range(two_n.bit_length() - 1, bits - 1):
        q = (1 << bits) - (1 << m) + 1
        if (below is None or q < below) and is_prime(q):
            return q
    step = 1 << (two_n.bit_length() - 1)
    start = ((1 << bits) - 2) // step
    if below is not None:
        start = min(start, (below - 2) // step)
    for c in range(start, 0, -1):
        q = c * step + 1
        if q.bit_length() != bits:
            break
        if is_prime(q):
            return q
    raise ValueError(f"no {bits}-bit NTT prime for degree {degree}")


def find_generator_2n(degree: int, q: int, max_tries: int = 4096) -> int:
    """Find psi with psi^N == -1, psi^2N == 1 mod q.  Validates q first and
    bounds the search — unlike the reference's O(q) loop
    (ntt_processor.cpp:110-126) this fails fast on bad moduli."""
    two_n = 2 * degree
    if (q - 1) % two_n != 0:
        raise ValueError(f"q={q}: 2N={two_n} does not divide q-1")
    if not is_prime(q):
        raise ValueError(
            f"q={q} is composite — no valid NTT modulus (the reference's "
            "table contains such values; see ops/primes.py docstring)"
        )
    exponent = (q - 1) // two_n
    for g in range(2, 2 + max_tries):
        psi = pow(g, exponent, q)
        if pow(psi, degree, q) == q - 1:
            return psi
    raise ValueError(f"no generator found for q={q} in {max_tries} tries")
