"""The port's host pairings (node_fhe_accelerate_tpu_torch/zk/pairing.py,
pairing_bls.py) against the JAX package's (node_fhe_accelerate_tpu/zk/
pairing.py, pairing_bls.py), on the CPU: the G2 group law, the host G2 MSM,
the pairing value itself (all twelve Fq12 coefficients) and
``pairing_check``, on points that are multiples of the generators by
scalars drawn from numpy with a seed.  Tolerance: exact equality."""
import numpy as np
import pytest

from node_fhe_accelerate_tpu.zk import pairing as jpr
from node_fhe_accelerate_tpu.zk import pairing_bls as jprb
from node_fhe_accelerate_tpu_torch.zk import pairing as tpr
from node_fhe_accelerate_tpu_torch.zk import pairing_bls as tprb
from node_fhe_accelerate_tpu_torch.zk.curve import bls12_381_g1, bn254_g1

TOWERS = {"bn254": (jpr, tpr, bn254_g1), "bls12_381": (jprb, tprb,
                                                       bls12_381_g1)}


def scalars(r, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]


def g1_affine(make, ks):
    """[k]G1 as affine int pairs (the port's host fixed-base table)."""
    curve = make("cpu")
    xs, ys, inf = curve.to_affine_ints(curve.fixed_base_mul(ks,
                                                            backend="host"))
    return [None if i else (int(x), int(y)) for x, y, i in zip(xs, ys, inf)]


def coeffs(p):
    return None if p is None else [list(c.coeffs) for c in p]


def to_jax(jm, p):
    return None if p is None else tuple(jm.FQ2(list(c.coeffs)) for c in p)


@pytest.mark.parametrize("name", list(TOWERS))
def test_g2_group_law_matches_jax(name):
    jm, tm, _ = TOWERS[name]
    assert coeffs(tm.G2_GENERATOR) == coeffs(jm.G2_GENERATOR)
    assert list(tm._B2.coeffs) == list(jm._B2.coeffs)
    k1, k2 = scalars(tm.R, 2, 1)
    p = tm.g2_mul(tm.G2_GENERATOR, k1)
    q = tm.g2_mul(tm.G2_GENERATOR, k2)
    assert coeffs(p) == coeffs(jm.g2_mul(jm.G2_GENERATOR, k1))
    assert coeffs(tm.g2_add(p, q)) == coeffs(
        jm.g2_add(to_jax(jm, p), to_jax(jm, q)))
    assert coeffs(tm.g2_double(p)) == coeffs(jm.g2_double(to_jax(jm, p)))
    assert coeffs(tm.g2_neg(p)) == coeffs(jm.g2_neg(to_jax(jm, p)))
    assert tm.is_on_g2(p) and tm.g2_mul(tm.G2_GENERATOR, tm.R) is None


def test_bn254_g2_msm_matches_jax():
    ks = scalars(tpr.R, 6, 2)
    pts = [tpr.g2_mul(tpr.G2_GENERATOR, k) for k in scalars(tpr.R, 6, 3)]
    pts[2] = None                                 # infinity is skipped
    got = tpr.g2_msm(pts, ks)
    assert coeffs(got) == coeffs(jpr.g2_msm([to_jax(jpr, p) for p in pts],
                                            ks))
    want = None
    for p, k in zip(pts, ks):
        if p is not None:
            want = tpr.g2_add(want, tpr.g2_mul(p, k))
    assert coeffs(got) == coeffs(want)


@pytest.mark.parametrize("name", list(TOWERS))
def test_pairing_value_matches_jax(name):
    jm, tm, make = TOWERS[name]
    a, b = scalars(tm.R, 2, 4)
    (p1,) = g1_affine(make, [a])
    q2 = tm.g2_mul(tm.G2_GENERATOR, b)
    e = tm.pairing(q2, p1)
    assert list(e.coeffs) == list(jm.pairing(to_jax(jm, q2), p1).coeffs)
    # bilinear: e([b]G2, [a]G1) == e(G2, [a b]G1)
    (p_ab,) = g1_affine(make, [a * b % tm.R])
    assert e == tm.pairing(tm.G2_GENERATOR, p_ab)
    assert e != tm.FQ12.one()


@pytest.mark.parametrize("name", list(TOWERS))
def test_pairing_check_matches_jax(name):
    """e([a]G1, [b]G2) * e(-[a b]G1, G2) == 1, and a wrong product is
    refused, by both packages."""
    jm, tm, make = TOWERS[name]
    a, b = scalars(tm.R, 2, 5)
    p_a, p_ab, p_wrong = g1_affine(make, [a, a * b % tm.R, a * b + 1])
    q = make("cpu").fq.q
    neg = (p_ab[0], (-p_ab[1]) % q)
    neg_wrong = (p_wrong[0], (-p_wrong[1]) % q)
    q_b = tm.g2_mul(tm.G2_GENERATOR, b)
    for pairs, want in (([(p_a, q_b), (neg, tm.G2_GENERATOR)], True),
                        ([(p_a, q_b), (neg_wrong, tm.G2_GENERATOR)], False),
                        ([(None, q_b), (p_a, None)], True)):
        assert tm.pairing_check(pairs) is want
        assert jm.pairing_check([(p, to_jax(jm, g)) for p, g in pairs]) \
            is want


def test_bn254_prepared_lines_cached_per_point():
    """G2Prepared's cache is keyed by the point's coefficients: one entry
    per distinct point, and a cached point checks the same as a fresh
    one."""
    q2 = tpr.g2_mul(tpr.G2_GENERATOR, 7)
    first = tpr._prepare_cached(q2)
    again = tpr._prepare_cached(tpr.g2_mul(tpr.G2_GENERATOR, 7))
    assert first is again
    (p1,) = g1_affine(bn254_g1, [11])
    assert tpr.final_exponentiation(first.miller_loop(p1)) == \
        tpr.final_exponentiation(tpr.miller_loop_raw(q2, p1))
