"""ZK proof-system fields: BN254 and BLS12-381 base/scalar fields
(counterpart of node_fhe_accelerate_tpu/zk/field.py).

Elements are strict 8-bit digit planes (..., D) int32 in Montgomery form,
R = 2^(8D); everything batches over leading axes.  All stored elements are
canonical ([0, q), strict digits), so equality and zero tests are plain
digit comparisons.

On a CUDA tensor, ``mul`` and ``square`` launch the Montgomery-product
kernel K10 (``ops/digits_pallas.py`` ``pallas_field_mul``, ``csrc/digits.cu``)
in the same (B, D) layout; the digit algebra (``mul_plain``: a digit
convolution and ``_reduce``) is its plain version and serves CPU tensors.
Every op maps canonical digits to canonical digits, so the two give the
same bits.  (The JAX package leaves ``Field.mul`` to XLA; on the card there
is no XLA, and a kernel's plain version does not run on the main path.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import digits as dg
from ..ops import digits_pallas as dp

__all__ = ["Field", "BN254_FQ", "BN254_FR", "BLS12_381_FQ", "BLS12_381_FR",
           "bn254_fq", "bn254_fr", "bls12_381_fq", "bls12_381_fr"]

BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BLS12_381_FQ = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BLS12_381_FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


class Field:
    """Fixed odd prime field on 8-bit digit lanes, Montgomery domain, with
    its constants on ``device`` (``cuda`` unless the caller asks for
    another)."""

    def __init__(self, q: int, n_digits: int, device=None):
        if q % 2 == 0 or (q >> (8 * n_digits)) or \
                2 * q >= 1 << (8 * n_digits):
            raise ValueError("need odd q with 2q < 2^(8*n_digits)")
        self.device = resolve_device(device)
        self.q = q
        self.n_limbs = n_digits          # trailing-axis width (digit count)
        R = 1 << (8 * n_digits)
        self.r_mod_q = R % q
        self.r2_mod_q = R * R % q
        self.r_inv_mod_q = pow(self.r_mod_q, -1, q)
        qp = (-pow(q, -1, R)) % R
        self._q_digits_np = np.array(
            [(q >> (8 * i)) & 0xFF for i in range(n_digits)], np.int32)
        self._np_digits_np = np.array(
            [(qp >> (8 * i)) & 0xFF for i in range(n_digits)], np.int32)
        self.q_digits = torch.from_numpy(self._q_digits_np).to(self.device)
        self.np_digits = torch.from_numpy(self._np_digits_np).to(self.device)
        self.one_mont = dg.digits_from_int(self.r_mod_q, n_digits,
                                           self.device)
        self.zero = dg.digits_from_int(0, n_digits, self.device)
        # R - q as digit columns (255 - q_i, plus 1 at digit 0): adding it
        # gives x - q + R, whose top carry is [x >= q]
        neg_q = 255 - self._q_digits_np
        neg_q[0] += 1
        self._neg_q = torch.from_numpy(neg_q).to(self.device)
        self._neg_q_hi = torch.cat([torch.zeros_like(self._neg_q),
                                    self._neg_q])

    # -- host conversions ----------------------------------------------------
    def encode(self, values):
        """Ints -> Montgomery-form digit array on the field's device."""
        vals = np.asarray(values, dtype=object)
        scaled = (vals % self.q) * self.r_mod_q % self.q
        return dg.digits_from_ints(scaled, self.n_limbs, self.device)

    def decode(self, arr) -> np.ndarray:
        """Montgomery-form digit array -> object array of ints (the
        un-scaling runs on the host)."""
        return dg.digits_to_ints(arr) * self.r_inv_mod_q % self.q

    def to_mont_host(self, x: int):
        return dg.digits_from_int(x % self.q * self.r_mod_q % self.q,
                                  self.n_limbs, self.device)

    def from_mont_int(self, arr) -> int:
        return int(dg.digits_to_ints(arr) * self.r_inv_mod_q % self.q)

    # -- ring ops ------------------------------------------------------------
    # add, sub and the end of _reduce resolve both candidates of the
    # conditional subtraction in ONE carry resolution (a stacked pair of
    # digit columns <= 766), where the JAX package runs two in sequence
    # (add_digits, then sub_digits): the same canonical result in half the
    # tensor ops, which pace the narrow point ops on every device.
    def add(self, a, b):
        s = a + b
        d, c = dg.exact_norm(torch.stack([s, s + self._neg_q]), rounds=1)
        return dg.select(c[1] != 0, d[1], d[0])       # a + b >= q

    def sub(self, a, b):
        s = a + (255 - b)
        x = torch.stack([s, s + self.q_digits])
        x[..., 0] += 1                                 # a - b (+ q) + R
        d, c = dg.exact_norm(x, rounds=1)
        return dg.select(c[0] != 0, d[0], d[1])       # a >= b

    def neg(self, a):
        z = torch.zeros_like(a)
        return dg.select(dg.is_zero_digits(a), z, self.sub(z, a))

    def mul(self, a, b):
        """Montgomery product a*b*R^-1: K10 on a CUDA tensor, the digit
        algebra on a CPU tensor.  Operands broadcast."""
        if a.device.type == "cuda" or b.device.type == "cuda":
            a, b = torch.broadcast_tensors(a, b)
            return dp.pallas_field_mul(self, a, b)
        return self.mul_plain(a, b)

    def square(self, a):
        if a.device.type == "cuda":
            return dp.pallas_field_mul(self, a, a)
        return self.mul_plain(a, a)

    def mul_plain(self, a, b):
        """The digit algebra of ``mul`` on any device: one digit convolution,
        then T = a*b; m = (T mod R) * q' mod R; t = (T + m*q) / R < 2q; one
        conditional subtract -> canonical."""
        return self._reduce(dg.conv_full(a, b, 2 * self.n_limbs))

    def _reduce(self, t_cols):
        """Montgomery-reduce full product columns to a canonical element."""
        D = self.n_limbs
        T, _ = dg.exact_norm(t_cols)
        m_cols = dg.conv_const(T[..., :D], self._np_digits_np, D)
        m, _ = dg.exact_norm(m_cols)
        u_cols = dg.conv_const(m, self._q_digits_np, 2 * D)
        U, _ = dg.exact_norm(u_cols)
        # t = (T + U) / R < 2q: the low D digits of T + U are exactly zero;
        # the second candidate adds R - q in the high half
        s = T + U
        d, c = dg.exact_norm(torch.stack([s, s + self._neg_q_hi]), rounds=1)
        return dg.select(c[1] != 0, d[1][..., D:], d[0][..., D:])

    def from_mont(self, a):
        one = torch.zeros_like(a)
        one[..., 0] = 1
        return self.mul(a, one)

    def to_mont(self, a):
        r2 = dg.digits_from_int(self.r2_mod_q, self.n_limbs, a.device)
        return self.mul(a, r2.expand(a.shape))

    # -- exponentiation ------------------------------------------------------
    def inv(self, a):
        """a^{-1} via Fermat (a^(q-2))."""
        return self.pow_const(a, self.q - 2)

    def pow_const(self, a, e: int):
        """a^e for a static e: square-and-multiply over the bits of e, low
        bit first, as the JAX package's loop (a skipped multiply leaves the
        same value as its masked-out product)."""
        result = self.one_mont.to(a.device).expand(a.shape)
        if e == 0:
            return result
        base = a
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                result = self.mul(result, base)
            if i + 1 < e.bit_length():
                base = self.square(base)
        return result

    def sqrt(self, a):
        """Square root for q == 3 mod 4: a^((q+1)/4); caller checks
        validity."""
        if self.q % 4 != 3:
            raise NotImplementedError("sqrt only for q = 3 mod 4")
        return self.pow_const(a, (self.q + 1) // 4)

    # -- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return dg.is_zero_digits(a)

    def eq(self, a, b):
        return dg.eq_digits(a, b)

    def select(self, pred, a, b):
        return dg.select(pred, a, b)


def bn254_fq(device=None) -> Field:
    return Field(BN254_FQ, 32, device)


def bn254_fr(device=None) -> Field:
    return Field(BN254_FR, 32, device)


def bls12_381_fq(device=None) -> Field:
    return Field(BLS12_381_FQ, 48, device)


def bls12_381_fr(device=None) -> Field:
    return Field(BLS12_381_FR, 32, device)
