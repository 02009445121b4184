"""Montgomery field-multiply kernels for Hopper on 8-bit digit planes, and
the point ops built on them (counterpart of
node_fhe_accelerate_tpu/ops/digits_pallas.py).

``csrc/digits.cu`` (built at first use, see ``_build.py``) holds the
Montgomery product a*b*R^-1 mod q with R = 2^(8D), on canonical strict
8-bit digits in and out, D = 32 (BN254 Fq/Fr, BLS12-381 Fr) or 48
(BLS12-381 Fq), in two layouts, and the point kernel built on it:

* K9, digit-major (D, B): ``_mul_t_raw`` and ``pallas_field_mul_t``; every
  multiply of ``pallas_jadd_t``/``pallas_jdbl_t``, which evaluate
  ``zk/curve.py``'s ``jadd_formula``/``jdbl_formula`` over ``_TField``
  (``_TField2`` for Fq2) -- the wide point ops of the MSM;
* K10, row-major (B, D), the JAX package's ``_point_call``: the single
  product ``pallas_field_mul``, which
  ``zk/field.py`` ``Field.mul``/``square`` launch on a CUDA tensor; and
  the point kernel, a whole Jacobian add or double in one launch
  (``pallas_jadd``/``pallas_jdbl``), which ``Curve.add``/``double`` take
  on the card below 2048 points.

A CUDA tensor launches the kernel or the call raises; only a CPU tensor
takes the plain version: ``Field.mul_plain`` (the digit convolution and
Montgomery reduce of ``ops/digits.py``) in the respective layout
(``mul_t_reference``, ``field_mul_reference``), and for the point kernel
the level-stacked formulas over it (``jadd_reference``,
``jdbl_reference``).  Each entry counts its launches: ``_mul_t_raw.launches``
(K9), ``pallas_field_mul.launches``, ``pallas_jadd.launches`` and
``pallas_jdbl.launches`` (K10).  The kernels take any batch B >= 1; the
TPU's tile padding does not apply.

Around K9 the cheap glue (digit add/sub/select and the carry resolution)
stays plain torch between kernel calls, as it stays XLA in the JAX package.
Every field op maps canonical digits to canonical digits, so results are
bit-identical to the plain path per op, not just per formula.
"""
from __future__ import annotations

import ctypes

import torch

from . import digits as dg
from ._build import KernelLibrary, launch

__all__ = ["pallas_field_mul", "pallas_field_mul_t",
           "pallas_jadd", "pallas_jdbl", "pallas_jadd_t", "pallas_jdbl_t",
           "mul_t_reference", "field_mul_reference", "jadd_reference",
           "jdbl_reference", "DIGITS_LIB"]

_PTR, _INT, _I64, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_uint32)
DIGITS_LIB = KernelLibrary("digits.cu", {
    "nfa_digits_mont_mul": [_PTR, _PTR, _PTR, _I64, _INT, _INT, _PTR, _U32,
                            _PTR],
    "nfa_digits_point": [_INT] + [_PTR] * 9 + [_I64, _INT, _PTR, _U32, _PTR],
})
KERNEL_DIGITS = (32, 48)          # the instantiations of csrc/digits.cu


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------

_consts_cache: dict = {}


def _kernel_consts(field):
    """(q as 32-bit limbs in a ctypes array, -q^-1 mod 2^32) of a field."""
    key = (field.q, field.n_limbs)
    c = _consts_cache.get(key)
    if c is None:
        n = field.n_limbs // 4
        limbs = (ctypes.c_uint32 * n)(
            *[(field.q >> (32 * i)) & 0xFFFFFFFF for i in range(n)])
        c = _consts_cache[key] = (limbs, (-pow(field.q, -1, 1 << 32))
                                  % (1 << 32))
    return c


def _check(field, a, b, digit_axis: int, name: str):
    """Raise on what the kernels do not take: a digit count other than 32
    or 48 (or other than the field's), operands that are not int32 of one
    shape on one device, or a modulus with 2q >= R (the one conditional
    subtraction needs t < 2q < R)."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError(f"{name}: operands must be tensors")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"{name}: digit planes must be int32, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.shape != b.shape:
        raise ValueError(f"{name}: operand shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    D = a.shape[digit_axis] if a.dim() else 0
    if D not in KERNEL_DIGITS or D != field.n_limbs:
        raise ValueError(f"{name}: {D} digits; the kernel takes "
                         f"{KERNEL_DIGITS} equal to the field's "
                         f"{field.n_limbs}")
    if 2 * field.q >= 1 << (8 * D):
        raise ValueError(f"{name}: 2q >= R = 2^{8 * D}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {a.device}")


def _launch(field, a, b, digit_major: bool, name: str):
    """One launch of the kernel on contiguous (D, B) or (B, D) operands
    (none for B = 0)."""
    a, b = _aligned(a), _aligned(b)
    out = torch.empty_like(a)
    n = a.shape[1] if digit_major else a.shape[0]
    if n:
        limbs, qinv = _kernel_consts(field)
        launch(DIGITS_LIB.load().nfa_digits_mont_mul, name, a.device,
               a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
               field.n_limbs // 4, int(digit_major), limbs, qinv)
    return out


def _aligned(x):
    """Contiguous, with a 16-byte-aligned start (the row-major kernel reads
    whole 16-byte limbs)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mul_t_reference(field, aT, bT):
    """K9's plain version: ``Field.mul_plain`` on (D, B) digit-major
    planes."""
    return field.mul_plain(aT.T, bT.T).T


def field_mul_reference(field, a, b):
    """K10's plain version: ``Field.mul_plain`` on (..., D) planes."""
    return field.mul_plain(a, b)


def _mul_t_raw(field, aT, bT):
    """Montgomery multiply on (D, B) digit-MAJOR planes (K9); callers keep
    the whole computation in this layout."""
    if aT.dim() != 2:
        raise ValueError(f"_mul_t_raw: expected (D, B), got {tuple(aT.shape)}")
    _check(field, aT, bT, 0, "_mul_t_raw")
    if aT.device.type == "cpu":
        return mul_t_reference(field, aT, bT)
    out = _launch(field, aT, bT, True, "digits mul_t")
    _mul_t_raw.launches += bool(out.numel())
    return out


_mul_t_raw.launches = 0


def pallas_field_mul_t(field, a, b):
    """Digit-major Montgomery multiply of (..., D) planes: the operands are
    flattened and transposed to (D, B), multiplied by K9, and the result
    transposed back."""
    batch, D = a.shape[:-1], a.shape[-1]
    out = _mul_t_raw(field, a.reshape(-1, D).T, b.reshape(-1, D).T)
    return out.T.reshape(batch + (D,))


def pallas_field_mul(field, a, b):
    """Montgomery field multiply of (..., D) planes (K10)."""
    _check(field, a, b, -1, "pallas_field_mul")
    if a.device.type == "cpu":
        return field_mul_reference(field, a, b)
    D = a.shape[-1]
    out = _launch(field, a.reshape(-1, D), b.reshape(-1, D), False,
                  "digits mul")
    pallas_field_mul.launches += bool(out.numel())
    return out.reshape(a.shape)


pallas_field_mul.launches = 0


def _mul_pairs(mul, field, pairs):
    """k independent products as one call of ``mul``: the (a_i, b_i) pairs
    (identical shapes) row-stacked, multiplied, and split back -- the
    batching unit of the level-stacked point ops."""
    a0 = pairs[0][0]
    batch, D = a0.shape[:-1], a0.shape[-1]
    A = torch.cat([a.reshape(-1, D) for a, _ in pairs])
    Bc = torch.cat([b.reshape(-1, D) for _, b in pairs])
    out = mul(field, A, Bc)
    B = A.shape[0] // len(pairs)
    return tuple(out[i * B:(i + 1) * B].reshape(batch + (D,))
                 for i in range(len(pairs)))



# ---------------------------------------------------------------------------
# The digit-major field: K9 for products, plain torch glue along axis 0
# ---------------------------------------------------------------------------


class _TField:
    """Digit-MAJOR ((D, ...lanes) layout) twin of zk/field.py Field.

    mul/square run as K9 (``_mul_t_raw``); the glue (add/sub/select and
    predicates, exact carry resolution) is plain torch along axis 0,
    mirroring ops/digits.py.  Evaluating zk/curve.py's
    ``jadd_formula``/``jdbl_formula`` with this field object IS the
    digit-major point op."""

    def __init__(self, field):
        self.f = field
        self.D = int(field.n_limbs)
        self._cols: dict = {}

    def _col(self, name, device):
        """``field.q_digits`` / ``field._neg_q`` as a (D, 1) column."""
        key = (name, str(device))
        if key not in self._cols:
            self._cols[key] = getattr(self.f, name).reshape(
                self.D, 1).to(device)
        return self._cols[key]

    def _norm1(self, s):
        """exact_norm(rounds=1) along axis 0: (strict digits, carry out)."""
        return dg.exact_norm(s, rounds=1, dim=-2)

    # -- Field interface (both candidates in one carry resolution, as
    #    zk/field.py Field.add/sub) -----------------------------------------
    def add(self, a, b):
        s = a + b
        d, c = self._norm1(torch.stack([s, s + self._col("_neg_q",
                                                         s.device)]))
        return self.select(c[1] != 0, d[1], d[0])

    def sub(self, a, b):
        s = a + (255 - b)
        x = torch.stack([s, s + self._col("q_digits", s.device)])
        x[:, 0] += 1
        d, c = self._norm1(x)
        return self.select(c[0] != 0, d[0], d[1])

    def neg(self, a):
        z = torch.zeros_like(a)
        return self.select(self.is_zero(a), z, self.sub(z, a))

    def mul(self, a, b):
        return _mul_t_raw(self.f, a, b)

    def square(self, a):
        return _mul_t_raw(self.f, a, a)

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, pred, a, b):
        return torch.where(pred[None], a, b)


class _TField2:
    """Digit-major twin of zk/field2.py Field2: an Fq2 element is the
    row-concatenation (2L, ...lanes) of its components; arithmetic is the
    same Karatsuba/componentwise algebra over _TField."""

    def __init__(self, field2):
        self.f2 = field2
        self.bt = _TField(field2.base)
        self.L = int(field2.base.n_limbs)

    def _split(self, a):
        return a[:self.L], a[self.L:]

    def _join(self, c0, c1):
        return torch.cat([c0, c1])

    def add(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        return self._join(self.bt.add(a0, b0), self.bt.add(a1, b1))

    def sub(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        return self._join(self.bt.sub(a0, b0), self.bt.sub(a1, b1))

    def neg(self, a):
        a0, a1 = self._split(a)
        return self._join(self.bt.neg(a0), self.bt.neg(a1))

    def mul(self, a, b):
        f = self.bt
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        v0 = f.mul(a0, b0)
        v1 = f.mul(a1, b1)
        c0 = f.sub(v0, v1)
        t = f.mul(f.add(a0, a1), f.add(b0, b1))
        c1 = f.sub(f.sub(t, v0), v1)
        return self._join(c0, c1)

    def square(self, a):
        f = self.bt
        a0, a1 = self._split(a)
        c0 = f.mul(f.add(a0, a1), f.sub(a0, a1))
        m = f.mul(a0, a1)
        return self._join(c0, f.add(m, m))

    def is_zero(self, a):
        a0, a1 = self._split(a)
        return self.bt.is_zero(a0) & self.bt.is_zero(a1)

    def eq(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        return self.bt.eq(a0, b0) & self.bt.eq(a1, b1)

    def select(self, pred, a, b):
        return torch.where(pred[None], a, b)


_tfield_cache: dict = {}


def _tfield(field):
    """The digit-major twin of ``field``, one per (modulus, width, device):
    its constants live on the field's device."""
    key = (field.q, field.n_limbs, str(field.device))
    tf = _tfield_cache.get(key)
    if tf is None:
        tf = _TField2(field) if hasattr(field, "base") else _TField(field)
        _tfield_cache[key] = tf
    return tf


def _to_t(arrs):
    batch, D = arrs[0].shape[:-1], arrs[0].shape[-1]
    return [x.reshape(-1, D).T for x in arrs], batch, D


def _from_t(arrs, batch, D):
    return tuple(x.T.reshape(batch + (D,)) for x in arrs)


def pallas_jadd_t(field, p, q):
    """Branchless Jacobian add in the digit-major domain: transpose the six
    coordinate planes once, evaluate zk/curve.py's ``jadd_formula``
    verbatim over the _TField (products = K9, glue = torch), transpose the
    result back."""
    from ..zk.curve import jadd_formula
    tf = _tfield(field)
    flat, batch, D = _to_t(list(p) + list(q))
    out = jadd_formula(
        tf, tuple(flat[:3]), tuple(flat[3:]), select=tf.select,
        where_zero=lambda pred, a: torch.where(pred[None],
                                               torch.zeros_like(a), a))
    return _from_t(out, batch, D)


def pallas_jdbl_t(field, p):
    """Jacobian double in the digit-major domain (see pallas_jadd_t)."""
    from ..zk.curve import jdbl_formula
    tf = _tfield(field)
    flat, batch, D = _to_t(list(p))
    return _from_t(jdbl_formula(tf, tuple(flat)), batch, D)


# ---------------------------------------------------------------------------
# K10 as the point kernel: one launch a Jacobian add or double
# ---------------------------------------------------------------------------


def _point_planes(field, planes, name: str):
    """The coordinate planes broadcast to one shape, after the checks of
    ``_check`` (which raise on what the point kernel does not take)."""
    planes = torch.broadcast_tensors(*planes)
    for x in planes[1:]:
        _check(field, planes[0], x, -1, name)
    return planes


def _point_launch(field, planes, name: str):
    """One launch of the point kernel on (..., D) planes: 6 for an add, 3
    for a double; (X3, Y3, Z3) out (none launched for an empty batch)."""
    batch, D = planes[0].shape[:-1], planes[0].shape[-1]
    rows = [_aligned(x.reshape(-1, D)) for x in planes]
    out = [torch.empty_like(rows[0]) for _ in range(3)]
    n = rows[0].shape[0]
    if n:
        limbs, qinv = _kernel_consts(field)
        ptrs = [x.data_ptr() for x in rows] + [None] * (6 - len(rows))
        launch(DIGITS_LIB.load().nfa_digits_point, name, rows[0].device,
               int(len(rows) == 6), *ptrs, *[o.data_ptr() for o in out], n,
               D // 4, limbs, qinv)
    return tuple(o.reshape(batch + (D,)) for o in out), bool(n)


def pallas_jadd(field, p, q):
    """Branchless Jacobian add of (..., D) points (zk/curve.py
    ``jadd_formula``, the doubling and infinity cases included); operands
    broadcast.  On a CUDA tensor one launch of the point kernel
    (``point_kernel<L, true>``), counted in ``pallas_jadd.launches``; on a
    CPU tensor its plain version ``jadd_reference``."""
    planes = _point_planes(field, tuple(p) + tuple(q), "pallas_jadd")
    if planes[0].device.type == "cpu":
        return jadd_reference(field, planes[:3], planes[3:])
    out, launched = _point_launch(field, planes, "digits jadd")
    pallas_jadd.launches += launched
    return out


pallas_jadd.launches = 0


def pallas_jdbl(field, p):
    """Jacobian double of (..., D) points (zk/curve.py ``jdbl_formula``):
    one launch of the point kernel (``point_kernel<L, false>``) on a CUDA
    tensor, counted in ``pallas_jdbl.launches``; ``jdbl_reference`` on a
    CPU tensor."""
    planes = _point_planes(field, tuple(p), "pallas_jdbl")
    if planes[0].device.type == "cpu":
        return jdbl_reference(field, planes)
    out, launched = _point_launch(field, planes, "digits jdbl")
    pallas_jdbl.launches += launched
    return out


pallas_jdbl.launches = 0




def jadd_reference(field, p, q):
    """The point kernel's plain version for an add: the branchless Jacobian
    add (add-2007-bl + dbl/infinity masks, the exact algebra of zk/curve.py
    ``jadd_formula``) with its products stacked in 6 dataflow levels, each
    level one ``Field.mul_plain``:

      L1  Z1^2, Z2^2, X1^2, Y1^2, (Z1+Z2)^2, 2Y1*Z1      (add + dbl prep)
      L2  U1, U2, Z2*Z2Z2, Z1*Z1Z1, B^2, (X1+B)^2
      L3  S1, S2, E^2
      L4  (2H)^2, rr^2, E*(D-X3d)
      L5  H*I, U1*I, Z3
      L6  S1*J, rr*(V-X3)
    """
    f = field
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q

    def M(prs):
        return _mul_pairs(field_mul_reference, field, prs)

    Z1pZ2 = f.add(Z1, Z2)
    Y1x2 = f.add(Y1, Y1)
    Z1Z1, Z2Z2, A, B, SS, dZ3 = M([
        (Z1, Z1), (Z2, Z2), (X1, X1), (Y1, Y1), (Z1pZ2, Z1pZ2),
        (Y1x2, Z1)])
    X1B = f.add(X1, B)
    U1, U2, Za, Zb, C, tt = M([
        (X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1), (B, B),
        (X1B, X1B)])
    E = f.add(f.add(A, A), A)
    tAC = f.sub(f.sub(tt, A), C)
    Dd = f.add(tAC, tAC)
    S1, S2, F = M([(Y1, Za), (Y2, Zb), (E, E)])
    H = f.sub(U2, U1)
    S2mS1 = f.sub(S2, S1)
    rr = f.add(S2mS1, S2mS1)
    H2 = f.add(H, H)
    X3d = f.sub(F, f.add(Dd, Dd))
    DmX3 = f.sub(Dd, X3d)
    I, RR, EDX = M([(H2, H2), (rr, rr), (E, DmX3)])
    ZZm = f.sub(f.sub(SS, Z1Z1), Z2Z2)
    J, V, Z3 = M([(H, I), (U1, I), (ZZm, H)])
    X3 = f.sub(f.sub(RR, J), f.add(V, V))
    VmX3 = f.sub(V, X3)
    S1J, rV = M([(S1, J), (rr, VmX3)])
    Y3 = f.sub(rV, f.add(S1J, S1J))

    # doubling-path outputs (dbl-2009-l on p, same terms as jdbl_formula)
    eightC = f.add(f.add(f.add(C, C), f.add(C, C)),
                   f.add(f.add(C, C), f.add(C, C)))
    dY3 = f.sub(EDX, eightC)

    same_x = f.is_zero(H)
    same_y = f.is_zero(S2mS1)
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)
    use_dbl = same_x & same_y & ~p_inf & ~q_inf
    to_inf = same_x & ~same_y & ~p_inf & ~q_inf

    X3 = f.select(use_dbl, X3d, X3)
    Y3 = f.select(use_dbl, dY3, Y3)
    Z3 = f.select(use_dbl, dZ3, Z3)
    Z3 = f.select(to_inf, torch.zeros_like(Z3), Z3)
    X3 = f.select(p_inf, X2, X3)
    Y3 = f.select(p_inf, Y2, Y3)
    Z3 = f.select(p_inf, Z2, Z3)
    X3 = f.select(q_inf, X1, X3)
    Y3 = f.select(q_inf, Y1, Y3)
    Z3 = f.select(q_inf, Z1, Z3)
    return (X3, Y3, Z3)


def jdbl_reference(field, p):
    """The point kernel's plain version for a double (dbl-2009-l), its
    products in 4 stacked levels of ``Field.mul_plain``."""
    f = field
    X, Y, Z = p

    def M(prs):
        return _mul_pairs(field_mul_reference, field, prs)

    Yx2 = f.add(Y, Y)
    A, B, Z3 = M([(X, X), (Y, Y), (Yx2, Z)])
    XB = f.add(X, B)
    C, tt = M([(B, B), (XB, XB)])
    tAC = f.sub(f.sub(tt, A), C)
    Dd = f.add(tAC, tAC)
    E = f.add(f.add(A, A), A)
    (F,) = M([(E, E)])
    X3 = f.sub(F, f.add(Dd, Dd))
    (EDX,) = M([(E, f.sub(Dd, X3))])
    eightC = f.add(f.add(f.add(C, C), f.add(C, C)),
                   f.add(f.add(C, C), f.add(C, C)))
    Y3 = f.sub(EDX, eightC)
    return (X3, Y3, Z3)
