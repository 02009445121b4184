"""The port's multi-limb and digit-plane big-integer cores
(node_fhe_accelerate_tpu_torch/ops/limbs.py, ops/digits.py) against the
JAX package's, on the CPU.

Inputs are random from numpy with a seed plus edge values (0, 1, q-1,
all-ones limbs), at L = 8 / 12 limbs and D = 32 / 48 digits.  The JAX digit
functions run under ``jax.jit`` (one compile each, where eager dispatch
would compile every shifted slice on its own).  Tolerance: exact equality
-- every value is an integer."""
import functools

import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.ops import digits as jdg
from node_fhe_accelerate_tpu.ops import limbs as jlb
from node_fhe_accelerate_tpu.zk.field import BLS12_381_FQ, BN254_FQ
from node_fhe_accelerate_tpu_torch.ops import digits as dg
from node_fhe_accelerate_tpu_torch.ops import limbs as lb

CPU = "cpu"
MODULI = {8: BN254_FQ, 12: BLS12_381_FQ}       # limb count -> modulus


def _values(seed: int, bits: int, q: int, n: int = 12) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(bits // 8), "little") % q
            for _ in range(n)]
    return vals + [0, 1, q - 1, q - 2, 255, 256, (1 << 32) - 1]


def _u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _jit(fn, *args):
    """``fn(*arrays)`` of the JAX package under jit, with the trailing
    non-array arguments held static."""
    arrays = [a for a in args if not isinstance(a, (int, bool))]
    static = args[len(arrays):]
    return jax.jit(functools.partial(_apply, fn, static))(*arrays)


def _apply(fn, static, *arrays):
    return fn(*arrays, *static)


@pytest.mark.parametrize("L", [8, 12])
def test_limbs_match_jax(L):
    q = MODULI[L]
    xs = _values(L, 32 * L, q)
    ys = xs[::-1]
    a, b = lb.limbs_from_ints(xs, L, CPU), lb.limbs_from_ints(ys, L, CPU)
    ja, jb = jlb.limbs_from_ints(xs, L), jlb.limbs_from_ints(ys, L)
    np.testing.assert_array_equal(_u32(a), _np(ja))
    np.testing.assert_array_equal(lb.limbs_to_ints(a), jlb.limbs_to_ints(ja))
    assert lb.limbs_to_int(a[3]) == jlb.limbs_to_int(ja[3]) == xs[3]
    np.testing.assert_array_equal(
        _u32(lb.limbs_from_int(xs[2], L, (2, 3), CPU)),
        _np(jlb.limbs_from_int(xs[2], L, (2, 3))))
    qt, jq = lb.limbs_from_int(q, L, device=CPU), jlb.limbs_from_int(q, L)

    s, c = lb.add(a, b)
    js, jc = jlb.add(ja, jb)
    np.testing.assert_array_equal(_u32(s), _np(js))
    np.testing.assert_array_equal(c.numpy(), _np(jc))
    # the wrap and carry of the all-ones value
    ones = lb.limbs_from_int((1 << (32 * L)) - 1, L, (1,), CPU)
    s1, c1 = lb.add(ones, lb.limbs_from_int(1, L, (1,), CPU))
    assert lb.limbs_to_int(s1[0]) == 0 and int(c1[0]) == 1
    for name in ("add_mod", "sub_mod"):
        np.testing.assert_array_equal(
            _u32(getattr(lb, name)(a, b, qt)),
            _np(getattr(jlb, name)(ja, jb, jq)), err_msg=name)
    np.testing.assert_array_equal(_u32(lb.neg_mod(a, qt)),
                                  _np(jlb.neg_mod(ja, jq)))
    np.testing.assert_array_equal(lb.geq(a, b).numpy(), _np(jlb.geq(ja, jb)))
    np.testing.assert_array_equal(lb.is_zero(a).numpy(),
                                  _np(jlb.is_zero(ja)))
    pred = lb.geq(a, b)
    np.testing.assert_array_equal(
        _u32(lb.select(pred, a, b)),
        _np(jlb.select(jlb.geq(ja, jb), ja, jb)))
    consts = lb.mont_constants(q, L)
    assert consts == jlb.mont_constants(q, L)
    got = lb.mont_mul(a, b, qt, consts["q_inv32"])
    np.testing.assert_array_equal(
        _u32(got), _np(jlb.mont_mul(ja, jb, jq, consts["q_inv32"])))
    rinv = pow(1 << (32 * L), -1, q)
    assert [int(v) for v in lb.limbs_to_ints(got)] == \
        [x * y * rinv % q for x, y in zip(xs, ys)]


@pytest.mark.parametrize("D", [32, 48])
def test_digit_conversions_match_jax(D):
    q = MODULI[D // 4]
    xs = _values(D + 1, 8 * D, q)
    a = dg.digits_from_ints(xs, D, CPU)
    np.testing.assert_array_equal(a.numpy(), _np(jdg.digits_from_ints(xs, D)))
    np.testing.assert_array_equal(dg.digits_to_ints(a), xs)
    np.testing.assert_array_equal(dg.digits_from_int(xs[0], D, CPU).numpy(),
                                  _np(jdg.digits_from_int(xs[0], D)))
    with pytest.raises(ValueError):
        dg.digits_from_int(1 << (8 * D), D, CPU)


@pytest.mark.parametrize("D", [32, 48])
def test_digit_ops_match_jax(D):
    q = MODULI[D // 4]
    xs = _values(D + 2, 8 * D, q)
    ys = xs[::-1]
    a, b = dg.digits_from_ints(xs, D, CPU), dg.digits_from_ints(ys, D, CPU)
    ja, jb = jdg.digits_from_ints(xs, D), jdg.digits_from_ints(ys, D)

    def same(got, want, what):
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                same(g, w, what)
            return
        np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=what)

    for out_len in (2 * D, D + 5):
        same(dg.conv_full(a, b, out_len),
             _jit(jdg.conv_full, ja, jb, out_len), f"conv_full {out_len}")
        same(dg.conv_square(a, out_len), _jit(jdg.conv_square, ja, out_len),
             f"conv_square {out_len}")
    # broadcasting: one constant row against the batch
    same(dg.conv_full(a[0], b), _jit(jdg.conv_full, ja[0], jb), "broadcast")
    qp = (-pow(q, -1, 1 << (8 * D))) % (1 << (8 * D))
    qd = np.array([(qp >> (8 * i)) & 255 for i in range(D)], np.int32)
    for out_len in (D, 2 * D):
        same(dg.conv_const(a, qd, out_len),
             jax.jit(lambda x: jdg.conv_const(x, qd, out_len))(ja),
             f"conv_const {out_len}")
    cols = dg.conv_full(a, b)
    jcols = _jit(jdg.conv_full, ja, jb)
    same(dg.exact_norm(cols), _jit(jdg.exact_norm, jcols), "exact_norm")
    # columns with a carry out of the top digit
    big = torch.full((3, D), (1 << 22) - 1, dtype=torch.int32)
    same(dg.exact_norm(big), _jit(jdg.exact_norm, big.numpy()),
         "exact_norm carry out")
    # the same normalisation along another axis
    same(dg.exact_norm(cols.T.contiguous(), dim=0)[0].T,
         _jit(jdg.exact_norm, jcols)[0], "exact_norm dim=0")
    lo = torch.from_numpy(np.random.default_rng(D).integers(
        0, 256, (6, D)).astype(np.int32))
    cin = torch.from_numpy(np.random.default_rng(D + 9).integers(
        0, 2, (6, D)).astype(np.int32))
    lo[0] = 255                              # a carry rippling the length
    cin[0] = 0
    cin[0, 0] = 1
    same(dg._ks_add(lo, cin), _jit(jdg._ks_add, lo.numpy(), cin.numpy()),
         "_ks_add")
    for plus_one in (False, True):
        same(dg.add_digits(a, b, plus_one),
             _jit(jdg.add_digits, ja, jb, plus_one), f"add_digits {plus_one}")
    same(dg.sub_digits(a, b), _jit(jdg.sub_digits, ja, jb), "sub_digits")
    jge = _jit(jdg.geq_digits, ja, jb)
    same(dg.geq_digits(a, b), jge, "geq_digits")
    same(dg.is_zero_digits(a), jdg.is_zero_digits(ja), "is_zero_digits")
    same(dg.eq_digits(a, a.flip(0)), jdg.eq_digits(ja, ja[::-1]),
         "eq_digits")
    same(dg.select(dg.geq_digits(a, b), a, b),
         jdg.select(jge, ja, jb), "select")
    same(dg.comp255(a), jdg.comp255(ja), "comp255")
