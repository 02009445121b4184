"""The port's G2 (node_fhe_accelerate_tpu_torch/zk/curve_g2.py) against the
JAX package's host G2 (node_fhe_accelerate_tpu/zk/pairing.py ``g2_mul``,
``g2_add``, ``g2_msm``), on the CPU.

Both of the port's backends are held to it: the host one (the default for
a curve on the CPU) and the device one, the code the card runs (the
Jacobian formulas over Field2 below 2048 points, the digit-major route of
K9 over ``_TField2`` from 2048), here on CPU tensors with the kernels'
plain versions.  Scalars come from numpy with a seed.  Tolerance: exact
equality of affine points."""
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.zk import pairing as jpr
from node_fhe_accelerate_tpu.zk import pairing_bls as jprb
from node_fhe_accelerate_tpu.zk.curve_g2 import bn254_g2 as jax_bn254_g2
from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
from node_fhe_accelerate_tpu_torch.ops.limbs import limbs_from_ints
from node_fhe_accelerate_tpu_torch.zk import pairing as tpr
from node_fhe_accelerate_tpu_torch.zk.curve import jadd_formula
from node_fhe_accelerate_tpu_torch.zk.curve_g2 import bls12_381_g2, bn254_g2


@pytest.fixture(scope="module")
def g2():
    return bn254_g2("cpu")


def scalars(n, seed, r=tpr.R):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]


def coeffs(p):
    return None if p is None else [list(c.coeffs) for c in p]


def jax_pt(p):
    return None if p is None else tuple(jpr.FQ2(list(c.coeffs)) for c in p)


def test_constants_match_jax(g2):
    jg = jax_bn254_g2()
    assert (g2.b, g2.gen_affine, g2.order) == (jg.b, jg.gen_affine, jg.order)
    assert g2.is_on_curve_affine(*g2.gen_affine)
    (gen,) = g2.to_affine_pairs(g2.generator((1,)))
    assert coeffs(gen) == coeffs(jpr.G2_GENERATOR)


def test_host_fixed_base_matches_jax_g2_mul(g2):
    ks = scalars(6, 1) + [0, 1, tpr.R, tpr.R - 1]
    got = g2.fixed_base_affine_host(ks)
    assert [coeffs(p) for p in got] == [
        coeffs(jpr.g2_mul(jpr.G2_GENERATOR, k)) for k in ks]
    # through the curve's points, and from another base
    base = tpr.g2_mul(tpr.G2_GENERATOR, 5)
    base_aff = tuple(tuple(c.coeffs) for c in base)
    pts = g2.fixed_base_mul(ks[:3], base_affine=base_aff, backend="host")
    assert [coeffs(p) for p in g2.to_affine_pairs(pts)] == [
        coeffs(jpr.g2_mul(jax_pt(base), k)) for k in ks[:3]]


def test_host_msm_matches_jax_g2_msm(g2):
    ks = scalars(5, 2)
    aff = [tpr.g2_mul(tpr.G2_GENERATOR, k) for k in scalars(5, 3)]
    aff[1] = None
    pts = g2.from_affine_pairs(aff)
    out = g2.msm(limbs_from_ints(ks, 8, "cpu"), pts, backend="host")
    got = g2.to_affine_pairs(tuple(c[None] for c in out))[0]
    assert coeffs(got) == coeffs(jpr.g2_msm([jax_pt(p) for p in aff], ks))


def test_device_ladder_msm_matches_host(g2):
    """The device backend on CPU tensors: the windowed ladder (scalar_mul,
    formulas over Field2) and its tree of adds, ``_msm_ladder``, equal the
    host g2_msm.  32-bit scalars (one limb: 8 windows) keep it to seconds
    on the CPU; the full-width ladder is the ``slow`` test below."""
    aff = g2.fixed_base_affine_host(scalars(3, 4))
    ws = [k % (1 << 32) for k in scalars(3, 5)]
    out = g2._msm_ladder(limbs_from_ints(ws, 1, "cpu"),
                         g2.from_affine_pairs(aff))
    got = g2.to_affine_pairs(tuple(c[None] for c in out))[0]
    assert coeffs(got) == coeffs(jpr.g2_msm([jax_pt(p) for p in aff], ws))


def edge_batch(g2, n):
    """n points P_i = [i+1]G2 and Q with the edge rows of the group law
    first (Q = P, Q = -P, P at infinity, Q at infinity)."""
    p_aff = g2.fixed_base_affine_host(list(range(1, n + 1)))
    q_aff = g2.fixed_base_affine_host(list(range(n + 7, 2 * n + 7)))
    q_aff[0] = p_aff[0]
    q_aff[1] = tpr.g2_neg(p_aff[1])
    p_aff[2] = None
    q_aff[3] = None
    return p_aff, q_aff


@pytest.mark.parametrize("n", [2048, 40])
def test_add_double_both_sides_of_k9_width(g2, n):
    """At 2048 points ``G2Curve.add``/``double`` take the K9 route over
    _TField2 (``point_op_path`` "k9"), below it the formulas over Field2;
    both equal the host G2 on the edge rows and sampled rows."""
    p_aff, q_aff = edge_batch(g2, n)
    P, Q = g2.from_affine_pairs(p_aff), g2.from_affine_pairs(q_aff)
    assert g2._path(P, Q) == ("k9" if n >= 2048 else "formula")
    s = g2.to_affine_pairs(g2.add(P, Q))
    d = g2.to_affine_pairs(g2.double(P))
    rows = list(range(6)) + list(range(n - 3, n))
    for i in rows:
        assert coeffs(s[i]) == coeffs(tpr.g2_add(p_aff[i], q_aff[i])), i
        want_d = None if p_aff[i] is None else tpr.g2_double(p_aff[i])
        assert coeffs(d[i]) == coeffs(want_d), i
    if n >= 2048:
        # the K9 route and the formulas give the same Jacobian planes
        f = g2.fq
        ref = jadd_formula(
            f, P, Q, select=f.select,
            where_zero=lambda pred, a: f.select(pred, torch.zeros_like(a),
                                                a))
        via = dp.pallas_jadd_t(f, P, Q)
        assert all(torch.equal(x, y) for x, y in zip(ref, via))


def test_bls12_381_g2_host_and_device_match():
    """BLS12-381 G2 (48-digit base field): the device ladder on the CPU
    (32-bit scalars) and the host fold equal the JAX tower's g2_mul."""
    g = bls12_381_g2("cpu")
    ks = [k % (1 << 32) for k in scalars(2, 6, g.order)]
    base = g.generator()
    dev = g.scalar_mul(limbs_from_ints(ks, 1, "cpu"), base)
    host = g.fixed_base_mul(ks, backend="host")
    want = [coeffs(jprb.g2_mul(jprb.G2_GENERATOR, k)) for k in ks]
    assert [coeffs(p) for p in g.to_affine_pairs(dev)] == want
    assert [coeffs(p) for p in g.to_affine_pairs(host)] == want


@pytest.mark.slow
@pytest.mark.parametrize("make", [bn254_g2, bls12_381_g2])
def test_device_fixed_base_full_width_matches_host(make):
    """The device fixed-base ladder at full scalar width (as the Groth16
    setup runs it on the card), on CPU tensors."""
    g = make("cpu")
    ks = scalars(2, 9, g.order)
    dev = g.fixed_base_mul(ks, backend="device")
    host = g.fixed_base_mul(ks, backend="host")
    assert [coeffs(p) for p in g.to_affine_pairs(dev)] == \
        [coeffs(p) for p in g.to_affine_pairs(host)]


@pytest.mark.slow
def test_device_pippenger_msm_matches_host(g2):
    """The device Pippenger over Fq2 (the card's MSM above the band) on CPU
    tensors, at n=16 padded to 256: equal to the host g2_msm."""
    ks = scalars(16, 7)
    aff = g2.fixed_base_affine_host(scalars(16, 8))
    out = g2._msm_pippenger_impl(
        limbs_from_ints(ks + [0] * 240, 8, "cpu"),
        g2.from_affine_pairs(aff + [None] * 240))
    got = g2.to_affine_pairs(tuple(c[None] for c in out))[0]
    assert coeffs(got) == coeffs(tpr.g2_msm(aff, ks))


def test_digit_major_twin_is_kept_per_device():
    """``digits_pallas._tfield`` keeps one digit-major twin per (modulus,
    width, device): a field on another device of the same modulus gets its
    own, whose products use that field's constants (a twin made for the
    card once served the CPU field of the same modulus, and its products
    mixed devices)."""
    other = dp._tfield(bn254_g2("meta").fq)
    mine = dp._tfield(bn254_g2("cpu").fq)
    assert mine is not other
    assert mine.f2.device.type == "cpu" and other.f2.device.type == "meta"
    assert mine.bt.f.device.type == "cpu"
