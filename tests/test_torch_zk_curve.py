"""The port's G1 curves (node_fhe_accelerate_tpu_torch/zk/curve.py) against
the JAX package and the host big-int oracle, on the CPU.

Inputs are made from numpy with a seed or by the JAX package's host
fixed-base path.  Tolerance: exact equality -- points are compared as affine
ints, digit planes bit for bit."""
import numpy as np
import pytest

from node_fhe_accelerate_tpu.zk import curve as jcurve
from node_fhe_accelerate_tpu_torch.convert import (points_from_numpy,
                                                    points_to_numpy)
from node_fhe_accelerate_tpu_torch.ops import limbs as lb
from node_fhe_accelerate_tpu_torch.zk import curve as tcurve

CURVES = ["bn254_g1", "bls12_381_g1"]


def _affine(curve, p):
    x, y, inf = curve.to_affine_ints(p)
    return [int(v) for v in np.atleast_1d(x)], \
        [int(v) for v in np.atleast_1d(y)], list(np.atleast_1d(inf))


@pytest.fixture(scope="module", params=CURVES)
def curves(request):
    return (getattr(jcurve, request.param)(),
            getattr(tcurve, request.param)(device="cpu"))


def test_host_paths_match_jax(curves):
    jc, tc = curves
    ks = [3, 7, 11, 19, 23, 5, 3, 12, 0, tc.order - 1]
    got = tc.fixed_base_mul(ks)                 # "host" on a CPU curve
    want = jc.fixed_base_mul(ks, backend="host")
    for g, w in zip(points_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(tc.generator((2,)), jc.generator((2,))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tc.infinity((2,)), jc.infinity((2,))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tc.is_on_curve_affine(*tc.gen_affine)
    x, y, inf = _affine(tc, got)
    assert inf == [False] * 8 + [True, False]
    assert all(tc.is_on_curve_affine(a, b) for a, b in zip(x[:8], y[:8]))
    one = tc.to_affine_ints(tuple(c[0] for c in got))
    assert one[0].shape == () and int(one[0]) == x[0]


def test_group_law(curves):
    jc, tc = curves
    ks = [3, 7, 11, 19, 5, 6]
    P = tc.fixed_base_mul(ks)
    Q = tc.fixed_base_mul(ks[::-1])
    want = _affine(tc, tc.fixed_base_mul([a + b for a, b in
                                          zip(ks, ks[::-1])]))
    assert _affine(tc, tc.add(P, Q)) == want
    assert _affine(tc, tc.double(P)) == \
        _affine(tc, tc.fixed_base_mul([2 * k for k in ks]))
    # P + P doubles, P + (-P) is infinity, infinity is the identity
    assert _affine(tc, tc.add(P, P)) == _affine(tc, tc.double(P))
    assert _affine(tc, tc.add(P, tc.negate(P)))[2] == [True] * len(ks)
    inf = tc.infinity((len(ks),))
    assert _affine(tc, tc.add(inf, P)) == _affine(tc, P)
    assert _affine(tc, tc.add(P, inf)) == _affine(tc, P)
    assert tc.is_infinity(tc.double(inf)).all()
    assert bool(tc.eq(tc.add(P, Q), tc.add(Q, P)).all())
    assert not bool(tc.eq(P, Q)[0])
    # the same points as the JAX package's (Montgomery digit planes)
    jP = jc.fixed_base_mul(ks, backend="host")
    for g, w in zip(points_to_numpy(tc.negate(P)), jc.negate(jP)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_scalar_mul_matches_oracle(curves):
    """A 1-limb windowed ladder (8 windows of 4 bits) at width 4."""
    jc, tc = curves
    ks = [0, 1, 0xDEADBEEF, (1 << 32) - 1]
    G = tc.generator()
    got = tc.scalar_mul(lb.limbs_from_ints(ks, 1, "cpu"), G)
    assert _affine(tc, got) == _affine(tc, tc.fixed_base_mul(ks))


def test_device_pippenger_matches_jax_host_pippenger():
    """The device-backend Pippenger (sort, prefix scans, bucket gathers,
    Horner) at n=16 with an infinity point and a zero scalar, on 62-bit
    scalars held in 2 limbs (8 windows)."""
    jc, tc = jcurve.bn254_g1(), tcurve.bn254_g1(device="cpu")
    sc = [int(v) for v in np.random.default_rng(7).integers(1, 2 ** 62, 16)]
    sc[3] = 0
    jpts = jc.fixed_base_mul(list(range(1, 17)), backend="host")
    jpts = (jpts[0], jpts[1], jpts[2].at[5].set(0))
    want = jc.msm(jcurve.lb.limbs_from_ints(sc, 2), jpts, backend="host")
    pts = points_from_numpy(tc, [np.asarray(c) for c in jpts])
    got = tc._msm_pippenger_impl(lb.limbs_from_ints(sc, 2, "cpu"), pts)
    assert _affine(tc, got) == _affine(tc, points_from_numpy(
        tc, [np.asarray(c) for c in want]))


def test_msm_backend_defaults_to_host_on_cpu():
    tc = tcurve.bn254_g1(device="cpu")
    sc = [5, 0, 7]
    pts = tc.fixed_base_mul([1, 2, 3])
    got = tc.msm(lb.limbs_from_ints(sc, 8, "cpu"), pts)
    assert _affine(tc, got) == _affine(tc, tc.fixed_base_mul([5 + 21]))


@pytest.mark.parametrize("n,max_chunk", [
    (0, 16384), (1000, 16384), (1024, 16384), (4096, 16384), (5000, 4096),
    (40000, 16384), (16384 + 1023, 16384), (3 * 1024 + 7, 1024)])
def test_msm_chunk_spans_match_jax(n, max_chunk):
    got = tcurve.msm_chunk_spans(n, max_chunk)
    assert got == jcurve.msm_chunk_spans(n, max_chunk)
    assert sum(s for _, s in got) == n


@pytest.mark.slow
@pytest.mark.parametrize("name", CURVES)
def test_device_msm_paths_match_host(name):
    """msm(backend="device") through the padded Pippenger (n=100 -> 256)
    and the ladder (min_pippenger above n_pad), and
    fixed_base_mul(backend="device"), against the host."""
    tc = getattr(tcurve, name)(device="cpu")
    rng = np.random.default_rng(11)
    for n, kw in ((100, {}), (4, {"min_pippenger": 1024})):
        sc = [int(v) for v in rng.integers(0, 2 ** 62, n)]
        pts = tc.fixed_base_mul([int(v) for v in
                                 rng.integers(1, 2 ** 20, n)])
        L = lb.limbs_from_ints(sc, 8, "cpu")
        assert _affine(tc, tc.msm(L, pts, backend="device", **kw)) == \
            _affine(tc, tc.msm(L, pts, backend="host")), n
    ks = [9, 2 ** 200 + 3]
    assert _affine(tc, tc.fixed_base_mul(ks, backend="device")) == \
        _affine(tc, tc.fixed_base_mul(ks, backend="host"))


@pytest.mark.parametrize("device_type,plain_field,k9_points,path", [
    ("cuda", True, 0, "kernel"), ("cuda", True, 2048, "k9"),
    ("cuda", False, 0, "formula"), ("cuda", False, 4096, "k9"),
    ("cpu", True, 0, "formula"), ("cpu", True, 8192, "k9")])
def test_point_op_path(device_type, plain_field, k9_points, path):
    """Curve.add/double's routing: the digit-major K9 ops wherever
    _pallas_geometry counts the points, the point kernel on the card over a
    plain Field below that, else the formulas over the field object."""
    assert tcurve.point_op_path(device_type, plain_field, k9_points) == path


def test_curve_routes_by_point_count_on_the_cpu():
    c = tcurve.bn254_g1(device="cpu")
    p = c.infinity((8,))
    assert c._path(p) == "formula"
    assert c._path(c.infinity((2048,))) == "k9"
    assert c._path(p, c.infinity((1,))) == "formula"
