"""BLS12-381 optimal-ate pairing, host-side, verifier-only (a copy of
node_fhe_accelerate_tpu/zk/pairing_bls.py, which imports nothing of JAX;
the port keeps its own so that it imports nothing of the JAX package).

Same structure as zk/pairing.py (BN254) -- generic polynomial extension
tower, affine Miller loop with line functions, final exponentiation --
parameterized for BLS12-381:

* p, r: the standard BLS12-381 field/subgroup moduli;
* Fq2 = Fq[i]/(i^2+1); Fq12 = Fq[w]/(w^12 - 2 w^6 + 2) (the standard
  flattening of the 2-3-2 tower, as in py_ecc);
* G2: y^2 = x^3 + 4(1+i); twist into E(Fq12) divides out (1+i) and scales
  by w^2/w^3; the G2 generator is derived at import;
* Miller loop over |x| = 0xd201000000010000 (the BLS parameter; x < 0, so
  without the conjugation step this computes the INVERSE of the canonical
  ate pairing -- still bilinear and nondegenerate, identical for product
  checks, which is all a verifier evaluates).

Attribution: the algorithmic shape (linefunc over Fq12, twist, final
exponentiation by (p^12-1)/r) follows the public py_ecc bls12_381
implementation (github.com/ethereum/py_ecc, MIT); constants are the
universal BLS12-381 parameters.
"""
from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

X_ABS = 0xD201000000010000          # |x|; x = -0xd201000000010000

FQ12_MODULUS_COEFFS = [2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0]

__all__ = ["FQ2", "FQ12", "pairing", "pairing_check", "G2_GENERATOR",
           "g2_add", "g2_double", "g2_mul", "g2_neg", "is_on_g2"]


class _Poly:
    """Element of Fq[x]/(modulus); subclasses fix degree + modulus."""

    degree = 0
    modulus_coeffs: list = []

    def __init__(self, coeffs):
        if len(coeffs) != self.degree:
            raise ValueError(f"need {self.degree} coeffs")
        self.coeffs = [c % P for c in coeffs]

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        d = self.degree
        tmp = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(other.coeffs):
                    tmp[i + j] += a * b
        for i in range(2 * d - 2, d - 1, -1):
            top = tmp[i] % P
            if top:
                tmp[i] = 0
                for j, mc in enumerate(self.modulus_coeffs):
                    tmp[i - d + j] -= top * mc
        return type(self)([c % P for c in tmp[:d]])

    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        lm, hm = [1] + [0] * self.degree, [0] * (self.degree + 1)
        low = self.coeffs + [0]
        high = self.modulus_coeffs + [1]
        while _deg(low):
            r_ = _poly_rounded_div(high, low)
            r_ = r_ + [0] * (self.degree + 1 - len(r_))
            nm = list(hm)
            new = list(high)
            for i in range(self.degree + 1):
                for j in range(self.degree + 1 - i):
                    nm[i + j] -= lm[i] * r_[j]
                    new[i + j] -= low[i] * r_[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = pow(low[0], -1, P)
        return type(self)([c * inv_low0 % P for c in lm[: self.degree]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * pow(other, -1, P)
        return self * other.inv()

    def __eq__(self, other):
        return self.coeffs == other.coeffs

    def __ne__(self, other):
        return not self == other

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def __repr__(self):
        return f"{type(self).__name__}({self.coeffs})"


def _deg(p):
    d = len(p) - 1
    while d and p[d] % P == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * len(a)
    binv = pow(b[degb], -1, P)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % P
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % P
    return [x % P for x in out[: dega - degb + 1]]


class FQ2(_Poly):
    degree = 2
    modulus_coeffs = [1, 0]  # i^2 = -1


class FQ12(_Poly):
    degree = 12
    modulus_coeffs = FQ12_MODULUS_COEFFS


# b2 = 4 * (1 + i)
_B2 = FQ2([4, 4])

# G2 cofactor: h2 = (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13) / 9
# (the standard BLS12 family formula, x = -0xd201000000010000).  Verified
# at import: the derived generator below is checked to have exact order r.
_X = -X_ABS
G2_COFACTOR = (_X ** 8 - 4 * _X ** 7 + 5 * _X ** 6 - 4 * _X ** 4
               + 6 * _X ** 3 - 4 * _X ** 2 - 4 * _X + 13) // 9


def _fq_sqrt(a: int):
    """sqrt in Fq (p = 3 mod 4): a^((p+1)/4); None if a is a non-residue."""
    r_ = pow(a, (P + 1) // 4, P)
    return r_ if r_ * r_ % P == a % P else None


def _fq2_sqrt(a: FQ2):
    """sqrt in Fq2 = Fq[i]/(i^2+1) via the norm trick; None if none."""
    a0, a1 = a.coeffs
    if a1 == 0:
        s = _fq_sqrt(a0)
        if s is not None:
            return FQ2([s, 0])
        s = _fq_sqrt((-a0) % P)          # sqrt(a0) = sqrt(-a0) * i
        return None if s is None else FQ2([0, s])
    n = _fq_sqrt((a0 * a0 + a1 * a1) % P)
    if n is None:
        return None
    inv2 = pow(2, -1, P)
    for sign in (1, -1):
        x0sq = (a0 + sign * n) * inv2 % P
        x0 = _fq_sqrt(x0sq)
        if x0 is not None and x0 != 0:
            x1 = a1 * pow(2 * x0, -1, P) % P
            cand = FQ2([x0, x1])
            if cand * cand == a:
                return cand
    return None


def _derive_g2_generator():
    """An order-r point on E'(Fq2): y^2 = x^3 + 4(1+i).

    Try-and-increment over small x, clear the cofactor, verify the order
    EXACTLY ([r]Q = infinity, Q != infinity).  This is a valid generator
    for every protocol in this package (they build their own SRS from it);
    it is NOT the ceremony-standard generator of the BLS12-381 spec — byte
    interop with external BLS artifacts would need those coordinates.
    """
    for x0 in range(1, 64):
        x = FQ2([x0, 1])
        rhs = x * x * x + _B2
        y = _fq2_sqrt(rhs)
        if y is None:
            continue
        q = g2_mul_unchecked((x, y), G2_COFACTOR)
        if q is None:
            continue
        if g2_mul_unchecked(q, R) is None:
            return q
    raise RuntimeError("no G2 generator found (cofactor wrong?)")


def g2_mul_unchecked(pt, k: int):
    """Scalar mul WITHOUT reducing k mod r (cofactor clearing needs the
    full integer)."""
    acc = None
    base = pt
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_double(base)
        k >>= 1
    return acc


def is_on_g2(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == _B2


def g2_neg(pt):
    return None if pt is None else (pt[0], -pt[1])


def g2_double(pt):
    x, y = pt
    lam = (3 * (x * x)) / (2 * y)
    x3 = lam * lam - x - x
    return (x3, lam * (x - x3) - y)


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return g2_double(p1)
    if x1 == x2:
        return None
    lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def g2_mul(pt, k: int):
    acc = None
    base = pt
    k %= R
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_double(base)
        k >>= 1
    return acc


# Derived at import (a few Fq2 scalar muls, ~ms); see _derive_g2_generator.
G2_GENERATOR = _derive_g2_generator()


# ---------------------------------------------------------------------------
# Twist into E(Fq12) and the Miller loop
# ---------------------------------------------------------------------------

_W = FQ12([0, 1] + [0] * 10)
_W2 = _W * _W
_W3 = _W2 * _W


def _twist(pt):
    """G2 (Fq2 coords) -> E(Fq12).

    Embedding: w^6 = 1 + i in this tower ((w^6 - 1)^2 = -1), so
    a0 + a1*i = (a0 - a1) + a1*w^6.  BLS12-381's twist is an M-twist
    (b' = b * (1+i)), so the untwist DIVIDES by w^2 / w^3:
    (y/w^3)^2 = (x/w^2)^3 + 4 iff y^2 = x^3 + 4*w^6 = 4(1+i) — the twist
    equation.  (BN254 is a D-twist, b' = b/(9+i), hence the * there.)"""
    if pt is None:
        return None
    x, y = pt
    xc = [x.coeffs[0] - x.coeffs[1], x.coeffs[1]]
    yc = [y.coeffs[0] - y.coeffs[1], y.coeffs[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx / _W2, ny / _W3)


def _cast_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = 3 * (x1 * x1) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _ec_double(pt):
    x, y = pt
    m = 3 * (x * x) / (2 * y)
    nx = m * m - x - x
    return (nx, m * (x - nx) - y)


def _ec_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _ec_double(p1)
    m = (y2 - y1) / (x2 - x1)
    nx = m * m - x1 - x2
    return (nx, m * (x1 - nx) - y1)


def _miller_loop(q, p):
    """f_{|x|}(Q, P), final-exponentiated.  BLS12 curves need no Frobenius
    correction lines (the BN-specific 6u+2 trick does); x < 0 makes this
    the inverse of the canonical ate pairing — equally bilinear."""
    if q is None or p is None:
        return FQ12.one()
    r_pt = q
    f = FQ12.one()
    for i in range(X_ABS.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(r_pt, r_pt, p)
        r_pt = _ec_double(r_pt)
        if X_ABS & (1 << i):
            f = f * _linefunc(r_pt, q, p)
            r_pt = _ec_add(r_pt, q)
    return f ** ((P ** 12 - 1) // R)


def pairing(q_g2, p_g1) -> FQ12:
    """e(P, Q) for P in G1 (affine ints or None), Q in G2 (FQ2 affine)."""
    if p_g1 is None or q_g2 is None:
        return FQ12.one()
    return _miller_loop(_twist(q_g2), _cast_g1(p_g1))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for [(p_g1, q_g2), ...]."""
    acc = FQ12.one()
    for p_g1, q_g2 in pairs:
        acc = acc * pairing(q_g2, p_g1)
    return acc == FQ12.one()
