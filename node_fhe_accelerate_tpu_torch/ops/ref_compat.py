"""Reference-compatibility transforms: the reference's EXACT NTT semantics
(a copy of node_fhe_accelerate_tpu/ops/ref_compat.py: pure Python, so the
port keeps its own).

The reference's NTT (cpp/src/ntt_processor.cpp:262-380 and the TS executable
spec, ntt-round-trip.prop.test.ts:150-240) applies bit-reversal + CT
butterflies with twiddle base psi (an order-2N root) at cyclic-DFT indices
`j*(N/group_size)`.  That transform round-trips (each butterfly is
invertible) but is NOT multiplicative — its pointwise product equals
neither the cyclic nor the negacyclic convolution (verified by direct
simulation; see ops/ntt.py).  The framework's own NTT is the corrected
negacyclic transform.

This module reproduces the reference's exact forward/inverse — bit-for-bit,
host big-int — so Property 1 of the executable spec (round-trip
consistency, the property the reference actually tests) can be validated
against OUR primitive-root search and twiddle generation.  Anything
convolution-related must use ops/ntt.py.
"""
from __future__ import annotations

from .primes import find_generator_2n

__all__ = ["ref_forward_ntt", "ref_inverse_ntt", "ref_round_trip_ok"]


def _bit_reverse_permute(a: list, n: int) -> list:
    bits = n.bit_length() - 1
    out = list(a)
    for i in range(n):
        j = int(format(i, f"0{bits}b")[::-1], 2)
        if i < j:
            out[i], out[j] = out[j], out[i]
    return out


def ref_forward_ntt(coeffs, q: int, psi: int | None = None) -> list:
    """forward_ntt (ntt_processor.cpp:262-311), exact semantics."""
    a = [int(x) % q for x in coeffs]
    n = len(a)
    if psi is None:
        psi = find_generator_2n(n, q)
    fw = [pow(psi, i, q) for i in range(n)]
    a = _bit_reverse_permute(a, n)
    m = 1
    while m < n:
        gs = 2 * m
        for k in range(0, n, gs):
            for j in range(m):
                w = fw[j * (n // gs)]
                x, y = a[k + j], a[k + j + m]
                wy = w * y % q
                a[k + j] = (x + wy) % q
                a[k + j + m] = (x - wy) % q
        m *= 2
    return a


def ref_inverse_ntt(coeffs, q: int, psi: int | None = None) -> list:
    """inverse_ntt (ntt_processor.cpp:325-380), exact semantics."""
    a = [int(x) % q for x in coeffs]
    n = len(a)
    if psi is None:
        psi = find_generator_2n(n, q)
    ipsi = pow(psi, -1, q)
    iw = [pow(ipsi, i, q) for i in range(n)]
    m = n // 2
    while m >= 1:
        gs = 2 * m
        for k in range(0, n, gs):
            for j in range(m):
                w = iw[j * (n // gs)]
                x, y = a[k + j], a[k + j + m]
                a[k + j] = (x + y) % q
                a[k + j + m] = (x - y) * w % q
        m //= 2
    a = _bit_reverse_permute(a, n)
    n_inv = pow(n, -1, q)
    return [x * n_inv % q for x in a]


def ref_round_trip_ok(coeffs, q: int) -> bool:
    """Property 1 of the executable spec (round-trip consistency)."""
    n = len(coeffs)
    psi = find_generator_2n(n, q)
    back = ref_inverse_ntt(ref_forward_ntt(coeffs, q, psi), q, psi)
    return back == [int(x) % q for x in coeffs]
