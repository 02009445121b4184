"""The port's digit-plane Montgomery kernels' plain versions and the point
ops built on them (node_fhe_accelerate_tpu_torch/ops/digits_pallas.py)
against the JAX package, on the CPU.

On a CPU tensor K9 (``_mul_t_raw``, digit-major) and K10
(``pallas_field_mul``, row-major) take their plain versions, so these tests
hold the plain versions equal to the JAX ``Field.mul`` --
tests/test_digits_pallas.py holds the JAX Pallas kernels equal to it in
interpret mode.  The kernels themselves are held against the plain versions
on the card (tests/test_torch_kernel_cuda.py, chip_smoke.py).

The Jacobian add/double of the edge-point set of tests/test_digits_pallas.py
(an infinity, a doubling row, an inverse pair) is compared two ways.  The
default tier holds the port against the JAX package's outputs committed in
tests/torch_point_vectors.json (every coordinate plane, row by row, as the
little-endian integer of its digits): for G1

    jax.jit(lambda p, q: jadd_formula(f, p, q, select=f.select,
        where_zero=...))(P, Q)      and   jax.jit(jdbl_formula)(f, P)

with f = bn254_g1().fq, and for G2 the same formulas evaluated eagerly
over bn254_g2().fq on P = bn254_g2().generator((8,)) and
Q = jdbl(jdbl(P)) with the edge rows set as in
tests/test_digits_pallas.py:136-156.  For BLS12-381 G1 (D=48) the vectors
are the JAX package's Pallas point kernels ``pallas_jadd(f, P, Q)`` and
``pallas_jdbl(f, P)`` (interpret mode, as tests/test_digits_pallas.py:47-83
runs them) over ``bls12_381_g1().fq`` on the same edge-point set, made by
the port's host fixed-base path.  The ``slow`` tier runs those JAX calls
live (~30 s of compile and eager dispatch on the CPU for the formulas,
~60 s for the Pallas kernels at D=32 and D=48) and holds both the port and
the committed vectors equal to them, plane for plane.
Tolerance: exact equality."""
import json
import pathlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.ops import digits_pallas as jdp
from node_fhe_accelerate_tpu.zk import field as jfield
from node_fhe_accelerate_tpu.zk.curve import bn254_g1 as jax_bn254_g1
from node_fhe_accelerate_tpu.zk.curve_g2 import bn254_g2 as jax_bn254_g2
from node_fhe_accelerate_tpu_torch.convert import points_from_numpy
from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
from node_fhe_accelerate_tpu_torch.zk import field as tfield
from node_fhe_accelerate_tpu_torch.zk.curve import (bls12_381_g1, bn254_g1,
                                                    jadd_formula,
                                                    jdbl_formula)
from node_fhe_accelerate_tpu_torch.zk.field2 import bn254_fq2

VECTORS = json.loads((pathlib.Path(__file__).parent
                      / "torch_point_vectors.json").read_text())


def _rows(pt) -> list:
    """Points -> per coordinate, the rows' digits as little-endian ints."""
    out = []
    for c in pt:
        c = np.asarray(c)
        assert c.min() >= 0 and c.max() <= 255
        out.append([int.from_bytes(r.astype(np.uint8).tobytes(), "little")
                    for r in c])
    return out


def _want(curve: str, op: str) -> list:
    return [[int(v, 16) for v in plane] for plane in VECTORS[curve][op]]


def _assert_planes(got, want, label):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{label} coordinate {i}")


def _values(q: int, seed: int, n: int = 13) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % q for _ in range(n)]
    return vals + [0, 1, 2, q - 1, q - 2, 255, 256, (1 << 254) % q,
                   q // 2, 0xFF00FF00FF00FF00]


@pytest.mark.parametrize("name", ["bn254_fq", "bls12_381_fq"])
def test_plain_kernels_match_jax_field_mul(name):
    jf, tf = getattr(jfield, name)(), getattr(tfield, name)(device="cpu")
    xs = _values(tf.q, len(name))
    ys = xs[::-1]
    a, b = tf.encode(xs), tf.encode(ys)
    want = np.asarray(jax.jit(jf.mul)(jf.encode(xs), jf.encode(ys)))
    np.testing.assert_array_equal(dp._mul_t_raw(tf, a.T, b.T).T.numpy(),
                                  want)
    np.testing.assert_array_equal(dp.pallas_field_mul_t(tf, a, b).numpy(),
                                  want)
    np.testing.assert_array_equal(dp.pallas_field_mul(tf, a, b).numpy(),
                                  want)
    half = len(xs) // 2
    got = dp._mul_pairs(dp.field_mul_reference, tf,
                        [(a[:half], b[:half]),
                         (a[half:2 * half], b[half:2 * half])])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want[:2 * half])
    # the plain path counts no launch
    assert dp._mul_t_raw.launches == 0 and dp.pallas_field_mul.launches == 0


def test_tfield_glue_matches_jax():
    """The digit-major glue (add/sub/neg/select/predicates along axis 0)
    == the JAX package's _tfield, including the top-carry cases."""
    jf, tf = jfield.bn254_fq(), tfield.bn254_fq(device="cpu")
    xs = _values(tf.q, 5) + [0, 1, tf.q - 1]
    ys = xs[::-1][:-3] + [tf.q - 1, 0, 1]
    a, b = tf.encode(xs).T, tf.encode(ys).T
    jt, tt = jdp._tfield(jf), dp._tfield(tf)

    def ops(t, x, y):
        return (t.add(x, y), t.sub(x, y), t.neg(x), t.is_zero(x),
                t.eq(x, y), t.select(t.is_zero(y), x, y))

    want = jax.jit(lambda x, y: ops(jt, x, y))(jf.encode(xs).T,
                                               jf.encode(ys).T)
    for g, w in zip(ops(tt, a, b), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert type(dp._tfield(bn254_fq2(device="cpu"))) is dp._TField2


def _g1_edge_points():
    """tests/test_digits_pallas.py:53-63, made by the JAX package's host
    fixed-base path and carried over."""
    curve = jax_bn254_g1()
    ks = [3, 7, 11, 19, 23, 5, 3, 12]
    P = curve.fixed_base_mul(ks, backend="host")
    Q = curve.fixed_base_mul(ks[::-1], backend="host")
    Pz = P[2].at[5].set(0)
    Q = (Q[0].at[6].set(P[0][6]).at[7].set(P[0][7]),
         Q[1].at[6].set(P[1][6]).at[7].set(curve.fq.neg(P[1][7])),
         Q[2].at[6].set(P[2][6]).at[7].set(P[2][7]))
    P = (P[0], P[1], Pz)
    tc = bn254_g1(device="cpu")
    return (tc, points_from_numpy(tc, [np.asarray(c) for c in P]),
            points_from_numpy(tc, [np.asarray(c) for c in Q]), (curve, P, Q))


def _g1_ops(tc, P, Q):
    """Every port route of the G1 add and double on (P, Q)."""
    f = tc.fq
    add = jadd_formula(f, P, Q, select=f.select,
                       where_zero=lambda pr, a: f.select(
                           pr, torch.zeros_like(a), a))
    return ({"jadd_formula": add, "pallas_jadd": dp.pallas_jadd(f, P, Q),
             "pallas_jadd_t": dp.pallas_jadd_t(f, P, Q),
             "Curve.add": tc.add(P, Q)},
            {"jdbl_formula": jdbl_formula(f, P),
             "pallas_jdbl": dp.pallas_jdbl(f, P),
             "pallas_jdbl_t": dp.pallas_jdbl_t(f, P),
             "Curve.double": tc.double(P)})


def test_g1_point_ops_match_jax():
    tc, P, Q, _ = _g1_edge_points()
    adds, dbls = _g1_ops(tc, P, Q)
    for name, got in adds.items():
        assert _rows(got) == _want("g1", "add"), name
    for name, got in dbls.items():
        assert _rows(got) == _want("g1", "dbl"), name


@pytest.mark.slow
def test_g1_point_ops_match_jax_live():
    """The same, against the JAX formulas run now under jax.jit."""
    import jax.numpy as jnp
    from node_fhe_accelerate_tpu.zk.curve import (
        jadd_formula as jax_jadd, jdbl_formula as jax_jdbl)
    tc, P, Q, (jc, jP, jQ) = _g1_edge_points()
    f = jc.fq
    want_add = jax.jit(lambda p, q: jax_jadd(
        f, p, q, select=f.select,
        where_zero=lambda pr, a: f.select(pr, jnp.zeros_like(a), a)))(jP, jQ)
    want_dbl = jax.jit(lambda p: jax_jdbl(f, p))(jP)
    adds, dbls = _g1_ops(tc, P, Q)
    for ops, want, op in ((adds, want_add, "add"), (dbls, want_dbl, "dbl")):
        for name, got in ops.items():
            _assert_planes(got, want, name)
        assert _rows(want) == _want("g1", op)


def _bls_edge_points():
    """The edge-point set of tests/test_digits_pallas.py:53-63 on
    BLS12-381 G1 (D=48), made by the port's host fixed-base path."""
    tc = bls12_381_g1(device="cpu")
    ks = [3, 7, 11, 19, 23, 5, 3, 12]
    P = [x.clone() for x in tc.fixed_base_mul(ks, backend="host")]
    Q = [x.clone() for x in tc.fixed_base_mul(ks[::-1], backend="host")]
    P[2][5] = 0
    for c_q, c_p in zip(Q, P):
        c_q[6:8] = c_p[6:8]
    Q[1][7] = tc.fq.neg(P[1][7])
    return tc, tuple(P), tuple(Q)


def test_bls_point_ops_match_jax_pallas():
    """D=48: the point kernel's plain version (``pallas_jadd``/
    ``pallas_jdbl`` on the CPU, ``jadd_reference``/``jdbl_reference``) and
    every other route == the JAX package's Pallas point kernels."""
    tc, P, Q = _bls_edge_points()
    adds, dbls = _g1_ops(tc, P, Q)
    adds["jadd_reference"] = dp.jadd_reference(tc.fq, P, Q)
    dbls["jdbl_reference"] = dp.jdbl_reference(tc.fq, P)
    for name, got in adds.items():
        assert _rows(got) == _want("bls_g1", "add"), name
    for name, got in dbls.items():
        assert _rows(got) == _want("bls_g1", "dbl"), name


@pytest.mark.slow
@pytest.mark.parametrize("curve", ["g1", "bls_g1"])
def test_point_kernel_plain_matches_jax_pallas_live(curve):
    """The JAX package's ``pallas_jadd``/``pallas_jdbl`` (its K10 point
    ops, interpret mode) run now at D=32 and D=48, against the port's
    plain point kernel and the committed vectors."""
    import jax.numpy as jnp
    from node_fhe_accelerate_tpu.zk.curve import bls12_381_g1 as jax_bls
    if curve == "g1":
        tc, P, Q, (jc, jP, jQ) = _g1_edge_points()
    else:
        tc, P, Q = _bls_edge_points()
        jc = jax_bls()
        jP, jQ = (tuple(jnp.asarray(c.numpy()) for c in pt)
                  for pt in (P, Q))
    want_add = jdp.pallas_jadd(jc.fq, jP, jQ)
    want_dbl = jdp.pallas_jdbl(jc.fq, jP)
    _assert_planes(dp.pallas_jadd(tc.fq, P, Q), want_add, "pallas_jadd")
    _assert_planes(dp.pallas_jdbl(tc.fq, P), want_dbl, "pallas_jdbl")
    assert _rows(want_add) == _want(curve, "add")
    assert _rows(want_dbl) == _want(curve, "dbl")


def _g2_edge_points(f, P, dbl, neg):
    """tests/test_digits_pallas.py:136-156: Q = 4P, then P[5] = infinity,
    (P[6], Q[6]) equal and (P[7], Q[7]) inverses."""
    Q = [np.array(c) for c in dbl(f, dbl(f, P))]
    P = [np.array(c) for c in P]
    P[2][5] = 0
    for c_q, c_p in zip(Q, P):
        c_q[6:8] = c_p[6:8]
    Q[1][7] = np.asarray(neg(P[1][7]))
    return P, Q


def _g2_port_points():
    f = bn254_fq2(device="cpu")
    P = points_from_numpy(SimpleNamespace(device=torch.device("cpu")),
                          [np.asarray(c)
                           for c in jax_bn254_g2().generator((8,))])
    P, Q = _g2_edge_points(f, P, jdbl_formula,
                           lambda y: f.neg(torch.from_numpy(y)))
    cpu = SimpleNamespace(device=torch.device("cpu"))
    return f, points_from_numpy(cpu, P), points_from_numpy(cpu, Q)


def test_g2_point_ops_through_tfield2_match_jax():
    """G2 over Fq2 through _TField2 (Karatsuba over K9's plain version) on
    inputs made with the JAX bn254_g2."""
    f, P, Q = _g2_port_points()
    assert _rows(Q) == _want("g2", "Q")
    assert _rows(dp.pallas_jadd_t(f, P, Q)) == _want("g2", "add")
    assert _rows(dp.pallas_jdbl_t(f, P)) == _want("g2", "dbl")


@pytest.mark.slow
def test_g2_point_ops_through_tfield2_match_jax_live():
    """The same, against the JAX Field2 formulas evaluated now, eagerly."""
    import jax.numpy as jnp
    from node_fhe_accelerate_tpu.zk.curve import (
        jadd_formula as jax_jadd, jdbl_formula as jax_jdbl)
    jc = jax_bn254_g2()
    jf = jc.fq
    jP, jQ = _g2_edge_points(jf, jc.generator((8,)), jax_jdbl, jf.neg)
    jP, jQ = tuple(map(jnp.asarray, jP)), tuple(map(jnp.asarray, jQ))
    want_add = jax_jadd(jf, jP, jQ, select=jf.select,
                        where_zero=lambda pr, a: jf.select(
                            pr, jnp.zeros_like(a), a))
    want_dbl = jax_jdbl(jf, jP)
    f, P, Q = _g2_port_points()
    _assert_planes(Q, jQ, "Q")
    _assert_planes(dp.pallas_jadd_t(f, P, Q), want_add, "pallas_jadd_t")
    _assert_planes(dp.pallas_jdbl_t(f, P), want_dbl, "pallas_jdbl_t")
    for got, op in ((jQ, "Q"), (want_add, "add"), (want_dbl, "dbl")):
        assert _rows(got) == _want("g2", op)


def test_kernel_wrappers_refuse_what_they_cannot_do():
    f = tfield.bn254_fq(device="cpu")
    a = f.encode([1, 2, 3])
    for bad in (a.long(), a[:2], a.to("meta")):
        with pytest.raises(ValueError):
            dp.pallas_field_mul(f, a, bad)
        with pytest.raises(ValueError):
            dp._mul_t_raw(f, a.T, bad.T)
    with pytest.raises(TypeError):
        dp.pallas_field_mul(f, a, 3)
    # a digit count other than 32 or 48, and other than the field's
    f36 = tfield.Field(f.q, 36, device="cpu")
    a36 = f36.encode([1, 2, 3])
    with pytest.raises(ValueError, match="digits"):
        dp.pallas_field_mul(f36, a36, a36)
    with pytest.raises(ValueError, match="digits"):
        dp._mul_t_raw(f36, a36.T, a36.T)
    with pytest.raises(ValueError, match="digits"):
        dp.pallas_field_mul(tfield.bls12_381_fq(device="cpu"), a, a)
    # a modulus with 2q >= R (Field itself refuses one)
    big = SimpleNamespace(q=(1 << 256) - 189, n_limbs=32)
    with pytest.raises(ValueError, match="2q"):
        dp.pallas_field_mul(big, a, a)
    with pytest.raises(ValueError, match=r"\(D, B\)"):
        dp._mul_t_raw(f, a.T[None], a.T[None])
