"""The port's distributed NTT and ring (node_fhe_accelerate_tpu_torch/
parallel/dist_ntt.py, dist_ring.py) and the ``ring_factory`` of its RNS
ring and CKKS engine, against the JAX package on the CPU.

The port's meshes have 4 positions on the CPU; the JAX twins run under
``shard_map`` on a 4-device JAX mesh (conftest's 8 virtual CPU devices).
Shapes: N=64, n1=8 over q=7681 (tests/test_dist_ntt.py's) for the
transforms, N=256 over Q_40_1 for the ring, N=64 over a 30/30/29-bit chain
for CKKS.  The ``slow`` tests run the JAX DistPolyRing at N=8192, the
sharded MSM at full 254-bit scalars, and CKKS_128_ML over the distributed
ring.  Inputs are random from numpy (or a torch.Generator) with a seed.
Tolerance: exact equality of every residue."""
import numpy as np
import pytest
import torch
import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from node_fhe_accelerate_tpu.core.params import Primes
from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jax_from_np,
                                             u64_to_np as jax_to_np)
from node_fhe_accelerate_tpu.parallel import dist_ntt as jdn
from node_fhe_accelerate_tpu.parallel.dist_ring import (
    DistPolyRing as JaxDistRing)
from node_fhe_accelerate_tpu.parallel.mesh import make_mesh as jax_mesh
from node_fhe_accelerate_tpu_torch.core import ckks, params
from node_fhe_accelerate_tpu_torch.core.encrypt import EncryptionEngine
from node_fhe_accelerate_tpu_torch.core.keys import KeyManager
from node_fhe_accelerate_tpu_torch.core.poly import PolyRing
from node_fhe_accelerate_tpu_torch.core.rns import RnsPolyRing
from node_fhe_accelerate_tpu_torch.ops.modular import ModCtx
from node_fhe_accelerate_tpu_torch.ops.primes import (find_generator_2n,
                                                      find_ntt_prime)
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np, u64_to_np
from node_fhe_accelerate_tpu_torch.parallel import dist_ntt as tdn
from node_fhe_accelerate_tpu_torch.parallel import collectives
from node_fhe_accelerate_tpu_torch.parallel.dist_ring import DistPolyRing
from node_fhe_accelerate_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

Q = 7681
N, N1 = 64, 8
Q40 = Primes.Q_40_1


def cpu_mesh(n=4):
    return make_mesh(n, data=n, devices=["cpu"] * n)


def split_cols(planes, p=4):
    """(lo, hi) (..., n1, n2) -> the p column blocks, one a position."""
    parts = [torch.chunk(x, p, dim=-1) for x in planes]
    return [(lo.contiguous(), hi.contiguous()) for lo, hi in zip(*parts)]


def join_cols(shards):
    return tuple(torch.cat([s[i] for s in shards], dim=-1) for i in (0, 1))


def jax_sharded(fn, nargs=1):
    """``fn`` under shard_map on a 4-device JAX mesh, the grid's last axis
    split."""
    spec = (P(None, None, "data"), P(None, None, "data"))
    return jax.jit(shard_map(fn, mesh=jax_mesh(4, data=4),
                             in_specs=(spec,) * nargs, out_specs=spec))


# -- the transforms ------------------------------------------------------------

@pytest.mark.parametrize("m,q,omega", [
    (16, Q, pow(17, (Q - 1) // 16, Q)),
    (64, Q40, pow(find_generator_2n(64, Q40), 2, Q40))])
def test_cyclic_ntt_matches_jax(m, q, omega):
    a = np.random.default_rng(m).integers(0, q, (5, m), dtype=np.uint64)
    jc, tc = jdn.CyclicNTT(m, q, omega), tdn.CyclicNTT(m, q, omega)
    fwd = tc.forward(u64_from_np(a))
    jf, ji = jax.jit(lambda x: (jc.forward(x), jc.inverse(x)))(
        jax_from_np(a))
    np.testing.assert_array_equal(u64_to_np(fwd), jax_to_np(jf))
    np.testing.assert_array_equal(u64_to_np(tc.inverse(u64_from_np(a))),
                                  jax_to_np(ji))
    np.testing.assert_array_equal(u64_to_np(tc.inverse(fwd)), a)


@pytest.mark.parametrize("inverse", [False, True])
def test_matrix_cyclic_ntt_matches_jax(inverse):
    omega = pow(17, (Q - 1) // 8, Q)
    a = np.random.default_rng(2).integers(0, Q, (8, 3), dtype=np.uint64)
    got = tdn.matrix_cyclic_ntt(ModCtx(Q), omega, 8, u64_from_np(a), inverse)
    want = jdn.matrix_cyclic_ntt(jdn.ModCtx(Q), omega, 8, jax_from_np(a),
                                 inverse)
    np.testing.assert_array_equal(u64_to_np(got), jax_to_np(want))


def test_reference_and_4step_match_jax():
    jd, td = jdn.DistNTT(N, Q, n1=N1), tdn.DistNTT(N, Q, n1=N1)
    a = np.random.default_rng(0).integers(0, Q, (3, N), dtype=np.uint64)
    ref = td.reference_forward(a[0])
    np.testing.assert_array_equal(ref, jd.reference_forward(a[0]))
    got = u64_to_np(td.forward_4step(u64_from_np(a)))
    np.testing.assert_array_equal(
        got, jax_to_np(jax.jit(jd.forward_4step)(jax_from_np(a))))
    np.testing.assert_array_equal(got[0], ref)


@pytest.mark.parametrize("name", ["forward_local", "forward_sharded"])
def test_sharded_forward_matches_jax(name):
    jd, td = jdn.DistNTT(N, Q, n1=N1), tdn.DistNTT(N, Q, n1=N1)
    a = np.random.default_rng(1).integers(0, Q, (3, N), dtype=np.uint64)
    want = jax_to_np(jax_sharded(getattr(jd, name))(
        tuple(p.reshape(3, N1, N // N1) for p in jax_from_np(a))))
    grid = tuple(p.reshape(3, N1, N // N1) for p in u64_from_np(a))
    collectives.traffic.reset()
    out = getattr(td, name)(split_cols(grid))
    np.testing.assert_array_equal(u64_to_np(join_cols(out)), want)
    # one all-to-all: each position keeps 1 of its 4 blocks
    assert collectives.traffic.bytes == 3 * N * 8 * 3 // 4


def test_inverse_and_multiply_match_jax():
    jd, td = jdn.DistNTT(N, Q, n1=N1), tdn.DistNTT(N, Q, n1=N1)
    rng = np.random.default_rng(6)
    a = rng.integers(0, Q, (2, N), dtype=np.uint64)
    b = rng.integers(0, Q, (2, N), dtype=np.uint64)

    def grids(x):
        return (tuple(p.reshape(2, N1, N // N1) for p in jax_from_np(x)),
                split_cols(tuple(p.reshape(2, N1, N // N1)
                                 for p in u64_from_np(x))))

    (ja, ta), (jb, tb) = grids(a), grids(b)
    inv = td.inverse_local(td.forward_local(ta))
    np.testing.assert_array_equal(
        u64_to_np(join_cols(inv)).reshape(2, N), a)
    got = u64_to_np(join_cols(td.negacyclic_mul_local(ta, tb)))
    want = jax_to_np(jax_sharded(jd.negacyclic_mul_local, 2)(ja, jb))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].reshape(N), PolyRing(N, Q, "cpu").multiply_np(a[i], b[i]))


# -- the ring -------------------------------------------------------------------

@pytest.fixture(scope="module")
def rings():
    n = 256
    return (JaxDistRing(n, Q40, mesh=jax_mesh(4, data=4)),
            DistPolyRing(n, Q40, mesh=cpu_mesh()), n)


def test_dist_ring_matches_jax(rings):
    jr, tr, n = rings
    assert (tr.n1, tr.n2) == (jr.n1, jr.n2)
    rng = np.random.default_rng(7)
    a = rng.integers(0, Q40, (2, n), dtype=np.uint64)
    b = rng.integers(0, Q40, (2, n), dtype=np.uint64)
    ja, jb = jr.from_np(a), jr.from_np(b)
    ta, tb = tr.from_np(a), tr.from_np(b)
    fa, fb = tr.to_ntt(ta), tr.to_ntt(tb)
    jfa, jfb = jr.to_ntt(ja), jr.to_ntt(jb)
    np.testing.assert_array_equal(u64_to_np(fa), jax_to_np(jfa))
    pw = tr.pointwise(fa, fb)
    np.testing.assert_array_equal(u64_to_np(pw),
                                  jax_to_np(jr.pointwise(jfa, jfb)))
    np.testing.assert_array_equal(u64_to_np(tr.from_ntt(pw)),
                                  jax_to_np(jr.from_ntt(jr.pointwise(jfa,
                                                                     jfb))))
    # JAX's multiply is from_ntt(pointwise(to_ntt, to_ntt)) in one program
    prod = u64_to_np(tr.multiply(ta, tb))
    np.testing.assert_array_equal(prod, u64_to_np(tr.from_ntt(pw)))
    single = PolyRing(n, Q40, "cpu")
    np.testing.assert_array_equal(prod, u64_to_np(single.multiply(
        single.from_np(a), single.from_np(b))))


def test_dist_ring_split_rules_match_jax():
    m8 = make_mesh(8, data=8, devices=["cpu"] * 8)
    for n in (64, 256, 1024):
        assert DistPolyRing(n, Q40, mesh=m8).n1 == JaxDistRing(
            n, Q40, mesh=jax_mesh(8, data=8)).n1
    with pytest.raises(ValueError, match="too small"):
        DistPolyRing(16, Q, mesh=m8)
    with pytest.raises(ValueError, match="divisible"):
        DistPolyRing(64, Q, mesh=m8, n1=4)


def test_encryption_engine_over_dist_ring(rings):
    """keygen, encrypt, a tally and decrypt over the distributed ring, as
    tests/test_dist_ntt.py does at N=8192, here at N=256; the tally
    equals the single-device ring's on the same keys and draws."""
    _, tr, n = rings
    prm = params.ParameterSet(
        scheme=params.FHEScheme.BFV, poly_degree=n, moduli=[Q40],
        lwe_dimension=64, lwe_noise_std=3.2e-11, glwe_dimension=1,
        decomp_base_log=8, decomp_level=5, plaintext_modulus=64)
    out = {}
    for name, ring in (("dist", tr), ("single", PolyRing(n, Q40, "cpu"))):
        eng = EncryptionEngine(prm, ring=ring)
        km = KeyManager(prm, ring)
        g = torch.Generator().manual_seed(0)
        sk = km.generate_secret_key(g)
        pk = km.generate_public_key(g, sk)
        cts = [eng.encrypt(g, [1, i], pk) for i in range(3)]
        total = eng.batch_add(cts)
        vals, budget = eng.decrypt(total, sk, 2)
        assert vals.tolist() == [3, 3] and budget > 5
        out[name] = u64_to_np(total.c0)
    np.testing.assert_array_equal(out["dist"], out["single"])


# -- ring_factory ---------------------------------------------------------------

CN = 64
CQ1 = find_ntt_prime(30, CN)
CQ2 = find_ntt_prime(30, CN, below=CQ1)
CQ3 = find_ntt_prime(29, CN)


def ckks_params():
    return params.ParameterSet(
        scheme=params.FHEScheme.CKKS, poly_degree=CN,
        moduli=[CQ1, CQ2, CQ3], lwe_dimension=64, lwe_noise_std=3.2,
        glwe_dimension=1, decomp_base_log=8, decomp_level=4,
        plaintext_modulus=0)


def test_rns_ring_takes_a_ring_factory():
    m = cpu_mesh()
    ring = RnsPolyRing(CN, [CQ1, CQ2], ring_factory=lambda n, q:
                       DistPolyRing(n, q, mesh=m))
    assert all(isinstance(r, DistPolyRing) for r in ring.rings)
    assert ring.device == torch.device("cpu")
    rng = np.random.default_rng(9)
    a = rng.integers(0, CQ2, (2, CN), dtype=np.uint64)
    b = rng.integers(0, CQ2, (2, CN), dtype=np.uint64)
    single = RnsPolyRing(CN, [CQ1, CQ2], device="cpu")
    got = ring.multiply(ring.from_np(a), ring.from_np(b))
    want = single.multiply(single.from_np(a), single.from_np(b))
    np.testing.assert_array_equal(ring.to_np(got), single.to_np(want))


def test_ckks_multiply_over_dist_ring_matches_single_ring():
    """One multiply-relinearize-rescale over the distributed rings is
    bit-equal to the single-ring engine's on the same ciphertexts and keys
    (the keys made over the distributed rings), and decodes.  The fused
    form over the distributed rings gives the same bits; the relin key's
    NTT form is kept apart per ring layout."""
    prm = ckks_params()
    m = cpu_mesh()
    dist = ckks.CkksEngine(prm, scale=1 << 26, ring_factory=lambda n, q:
                           DistPolyRing(n, q, mesh=m))
    single = ckks.CkksEngine(prm, scale=1 << 26, device="cpu")
    assert dist.device == torch.device("cpu")
    g = torch.Generator().manual_seed(5)
    sk = dist.generate_secret_key(g)
    pk = dist.generate_public_key(g, sk)
    rlk = dist.generate_relin_keys(g, sk)
    va, vb = [1.5, -2.0, 0.25], [2.0, 0.5, -1.0]
    ca, cb = dist.encrypt(g, va, pk), dist.encrypt(g, vb, pk)
    out = dist.multiply_relin_rescale(ca, cb, rlk)
    ref = single.multiply_relin_rescale(ca, cb, rlk)
    for x, y in zip(out.c0 + out.c1, ref.c0 + ref.c1):
        np.testing.assert_array_equal(u64_to_np(x), u64_to_np(y))
    got = dist.decrypt(out, sk, 3)
    assert np.max(np.abs(np.real(got) - np.multiply(va, vb))) < 1e-3
    fused = single.multiply_relin_rescale(ca, cb, rlk, fused=True)
    fused_d = dist.multiply_relin_rescale(ca, cb, rlk, fused=True)
    for x, y in zip(fused.c0 + fused.c1, fused_d.c0 + fused_d.c1):
        np.testing.assert_array_equal(u64_to_np(x), u64_to_np(y))
    assert len(rlk[3].ntt_forms) == 2


# -- slow: production sizes --------------------------------------------------------

@pytest.mark.slow
def test_dist_ring_matches_jax_at_n8192():
    n = 8192
    jr = JaxDistRing(n, Q40, mesh=jax_mesh(4, data=4))
    tr = DistPolyRing(n, Q40, mesh=cpu_mesh())
    rng = np.random.default_rng(7)
    a = rng.integers(0, Q40, (2, n), dtype=np.uint64)
    b = rng.integers(0, Q40, (2, n), dtype=np.uint64)
    np.testing.assert_array_equal(
        u64_to_np(tr.to_ntt(tr.from_np(a))), jax_to_np(jr.to_ntt(
            jr.from_np(a))))
    np.testing.assert_array_equal(
        u64_to_np(tr.multiply(tr.from_np(a), tr.from_np(b))),
        jax_to_np(jr.multiply(jr.from_np(a), jr.from_np(b))))


@pytest.mark.slow
def test_sharded_msm_full_scalars_matches_host():
    """tests/test_parallel.py's sharded MSM: 50 points (padded to 52),
    full 254-bit scalars, c=8, 4 positions, Jacobian inputs from scalar
    multiples of the generator; equal to the host MSM by Curve.eq."""
    from node_fhe_accelerate_tpu_torch.ops import limbs as lb
    from node_fhe_accelerate_tpu_torch.parallel.msm import sharded_msm
    from node_fhe_accelerate_tpu_torch.zk.curve import bn254_g1
    curve = bn254_g1("cpu")
    rng = np.random.default_rng(11)
    n = 50
    base = curve.generator((1,))
    ks = [int(rng.integers(1, 1 << 16)) for _ in range(n)]
    pts = curve.scalar_mul(lb.limbs_from_ints(ks, 8, "cpu"),
                           (base[0][0], base[1][0], base[2][0]))
    ss = [int.from_bytes(rng.bytes(32), "little") % curve.order
          for _ in range(n)]
    s_limbs = lb.limbs_from_ints(ss, 8, "cpu")
    got = sharded_msm(curve, s_limbs, pts, cpu_mesh())
    want = curve.msm(s_limbs, pts, backend="host")
    assert bool(curve.eq(got, want))


@pytest.mark.slow
def test_ckks_128_ml_over_dist_ring():
    """One leveled multiply at CKKS_128_ML (N=16384, five primes) with every
    prime's ring distributed over 4 positions: decodes within 1e-3 and its
    c0 is bit-equal to the single-ring engine's on the same ciphertexts and
    keys."""
    prm = params.CKKS_128_ML()
    m = cpu_mesh()
    dist = ckks.CkksEngine(prm, ring_factory=lambda n, q:
                           DistPolyRing(n, q, mesh=m))
    single = ckks.CkksEngine(prm, device="cpu")
    g = torch.Generator().manual_seed(0)
    sk = dist.generate_secret_key(g)
    pk = dist.generate_public_key(g, sk)
    rlk = dist.generate_relin_keys(g, sk)
    rng = np.random.default_rng(5)
    va, vb = rng.uniform(-1, 1, 64), rng.uniform(-1, 1, 64)
    ca, cb = dist.encrypt(g, va, pk), dist.encrypt(g, vb, pk)
    out = dist.multiply_relin_rescale(ca, cb, rlk)
    got = dist.decrypt(out, sk, 64)
    assert np.max(np.abs(np.real(got) - va * vb)) < 1e-3
    ref = single.multiply_relin_rescale(ca, cb, rlk)
    for x, y in zip(out.c0, ref.c0):
        np.testing.assert_array_equal(u64_to_np(x), u64_to_np(y))
