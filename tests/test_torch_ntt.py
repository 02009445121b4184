"""PyTorch port vs the JAX package and Python ints: the modular/NTT core.

u64 limb-plane helpers and ModCtx against Python big ints at the boundary
values; the prime utilities, NTTContext's psi and tables against the JAX
package; the port's PallasNTT (its plain path on the CPU) against the JAX
PallasNTT in interpret mode, as tests/test_ntt_pallas.py runs it; the
reference-compatible NTT.  Inputs come from numpy with fixed seeds.
Tolerance: exact equality -- every value is an integer mod q or 2^64."""
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.core.params import Primes as JaxPrimes
from node_fhe_accelerate_tpu.core.torus import P1, P2, P_EXT
from node_fhe_accelerate_tpu.ops import primes as jax_primes
from node_fhe_accelerate_tpu.ops import ref_compat as jax_ref
from node_fhe_accelerate_tpu.ops.ntt import NTTContext as JaxNTT
from node_fhe_accelerate_tpu.ops.ntt_pallas import PallasNTT as JaxPallasNTT
from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jax_from_np,
                                             u64_to_np as jax_to_np)
from node_fhe_accelerate_tpu_torch.core.params import Primes
from node_fhe_accelerate_tpu_torch.ops import primes, ref_compat, u64
from node_fhe_accelerate_tpu_torch.ops.modular import (ModCtx, fermat_form,
                                                       mod_mul_np,
                                                       solinas_form)
from node_fhe_accelerate_tpu_torch.ops.ntt import (NTTContext,
                                                   negacyclic_mul_np)
from node_fhe_accelerate_tpu_torch.ops.ntt_pallas import PallasNTT

torch.set_num_threads(2)

M64 = (1 << 64) - 1
EDGES_64 = [0, 1, 2, 0xFFFFFFFF, 1 << 32, (1 << 32) + 1, P1 - 1, P_EXT - 1,
            (1 << 63) - 1, 1 << 63, M64 - 1, M64]
EDGES_32 = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
            0xFFFFFFFF]


def planes(values):
    """Python ints < 2^64 -> int32 limb planes."""
    return u64.u64_from_np(np.array(values, dtype=object).astype(np.uint64))


def ints(p):
    """u64 planes -> list of Python ints."""
    return [int(v) for v in u64.u64_to_np(p).ravel()]


def ints128(p):
    return [int(v) for v in u64.u128_to_np(p)]


def pairs64(rng, k=40):
    """Every pair of edge values, plus random pairs."""
    a = [x for x in EDGES_64 for _ in EDGES_64]
    b = [y for _ in EDGES_64 for y in EDGES_64]
    a += [int(v) for v in rng.integers(0, M64, k, dtype=np.uint64)]
    b += [int(v) for v in rng.integers(0, M64, k, dtype=np.uint64)]
    return a, b


def lane32(values):
    return torch.from_numpy(np.array(values, dtype=np.uint32).view(np.int32))


def u32s(t):
    return [int(v) for v in t.numpy().view(np.uint32)]


# ---------------------------------------------------------------------------
# u64 / u128 helpers against Python ints
# ---------------------------------------------------------------------------

U64_BINARY = {
    "u64_add": lambda x, y: (x + y) & M64,
    "u64_sub": lambda x, y: (x - y) & M64,
    "u64_mul_lo": lambda x, y: (x * y) & M64,
    "u64_or": lambda x, y: x | y,
}


@pytest.mark.parametrize("name", sorted(U64_BINARY))
def test_u64_binary_ops_match_python_ints(name):
    a, b = pairs64(np.random.default_rng(1))
    got = getattr(u64, name)(planes(a), planes(b))
    assert ints(got) == [U64_BINARY[name](x, y) for x, y in zip(a, b)]


def test_u64_compare_and_select_match_python_ints():
    a, b = pairs64(np.random.default_rng(2))
    pa, pb = planes(a), planes(b)
    assert u64.u64_lt(pa, pb).tolist() == [x < y for x, y in zip(a, b)]
    assert u64.u64_geq(pa, pb).tolist() == [x >= y for x, y in zip(a, b)]
    assert u64.u64_eq(pa, pb).tolist() == [x == y for x, y in zip(a, b)]
    pred = u64.u64_lt(pa, pb)
    assert ints(u64.u64_select(pred, pa, pb)) == [min(x, y)
                                                  for x, y in zip(a, b)]


def test_u64_mul_wide_matches_python_ints():
    a, b = pairs64(np.random.default_rng(3))
    got = u64.u64_mul_wide(planes(a), planes(b))
    assert ints128(got) == [x * y for x, y in zip(a, b)]


@pytest.mark.parametrize("k", [0, 1, 17, 31, 32, 33, 54, 63])
def test_u64_shifts_and_mask_match_python_ints(k):
    a, _ = pairs64(np.random.default_rng(4))
    pa = planes(a)
    assert ints(u64.u64_shl(pa, k)) == [(x << k) & M64 for x in a]
    assert ints(u64.u64_shr(pa, k)) == [x >> k for x in a]
    mask = (1 << (k + 1)) - 1
    assert ints(u64.u64_and_mask(pa, mask)) == [x & mask for x in a]


@pytest.mark.parametrize("k", [0, 1, 31, 32, 40, 64, 77, 96, 127])
def test_u128_helpers_match_python_ints(k):
    a, b = pairs64(np.random.default_rng(5))
    wa = u64.u64_mul_wide(planes(a), planes(b))           # full 128 bits
    wb = u64.u128_from_u64(planes(b))
    va = [x * y for x, y in zip(a, b)]
    assert ints128(u64.u128_shr(wa, k)) == [v >> k for v in va]
    assert ints128(u64.u128_add(wa, wb)) == [(v + y) % (1 << 128)
                                             for v, y in zip(va, b)]
    assert ints(u64.u128_lo64(wa)) == [v & M64 for v in va]


def test_u32_primitives_match_python_ints():
    a = [x for x in EDGES_32 for _ in EDGES_32]
    b = [y for _ in EDGES_32 for y in EDGES_32]
    s, c = u64.addc32(lane32(a), lane32(b), lane32([1] * len(a)))
    assert [x + (y << 32) for x, y in zip(u32s(s), u32s(c))] == \
        [x + y + 1 for x, y in zip(a, b)]
    d, br = u64.subb32(lane32(a), lane32(b))
    assert u32s(d) == [(x - y) % (1 << 32) for x, y in zip(a, b)]
    assert u32s(br) == [int(x < y) for x, y in zip(a, b)]
    lo, hi = u64.mul32_wide(lane32(a), lane32(b))
    assert [x + (y << 32) for x, y in zip(u32s(lo), u32s(hi))] == \
        [x * y for x, y in zip(a, b)]


def test_u64_conversions_round_trip():
    vals = np.array(EDGES_64, dtype=object).astype(np.uint64)
    p = u64.u64_from_np(vals)
    assert p[0].dtype == torch.int32
    np.testing.assert_array_equal(u64.u64_to_np(p), vals)
    lo, hi = u64.u64_from_int((1 << 63) + 5, (2, 3))
    assert ints((lo, hi)) == [(1 << 63) + 5] * 6
    z = u64.u64_zeros((4,))
    assert ints(z) == [0] * 4


# ---------------------------------------------------------------------------
# ModCtx against Python ints
# ---------------------------------------------------------------------------

MODULI = [Primes.Q_40_1, P1, P2, P_EXT, Primes.Q_60_1, 65537,
          (1 << 61) - 1, 1000003, (1 << 62) + 135]


@pytest.mark.parametrize("q", MODULI)
def test_modctx_matches_python_ints(q):
    ctx = ModCtx(q)
    rng = np.random.default_rng(q % 1000)
    edge = [0, 1, 2, q - 2, q - 1]
    a = [x for x in edge for _ in edge] + \
        [int(v) for v in rng.integers(0, q, 60, dtype=np.uint64)]
    b = [y for _ in edge for y in edge] + \
        [int(v) for v in rng.integers(0, q, 60, dtype=np.uint64)]
    pa, pb = planes(a), planes(b)
    r_inv = pow(1 << 64, -1, q)
    assert ints(ctx.add(pa, pb)) == [(x + y) % q for x, y in zip(a, b)]
    assert ints(ctx.sub(pa, pb)) == [(x - y) % q for x, y in zip(a, b)]
    assert ints(ctx.neg(pa)) == [(-x) % q for x in a]
    assert ints(ctx.mul(pa, pb)) == [x * y % q for x, y in zip(a, b)]
    assert ints(ctx.mont_mul(pa, pb)) == [x * y * r_inv % q
                                          for x, y in zip(a, b)]
    assert ints(ctx.to_mont(pa)) == [(x << 64) % q for x in a]
    assert ints(ctx.from_mont(pa)) == [x * r_inv % q for x in a]
    t = u64.u64_mul_wide(pa, pb)
    assert ints(ctx.reduce_128(t)) == [x * y % q for x, y in zip(a, b)]
    np.testing.assert_array_equal(
        mod_mul_np(np.array(a, dtype=np.uint64), np.array(b, np.uint64), q),
        np.array([x * y % q for x, y in zip(a, b)], dtype=np.uint64))


def test_modctx_picks_the_reference_reduction():
    assert solinas_form(P1) == (40, 32) and solinas_form(P_EXT) == (54, 24)
    assert fermat_form(65537) == 16 and solinas_form(1000003) is None
    for q in MODULI:
        assert ModCtx(q).solinas == solinas_form(q)
    with pytest.raises(ValueError):
        ModCtx(1 << 40)
    with pytest.raises(ValueError):
        ModCtx((1 << 63) + 1)


# ---------------------------------------------------------------------------
# Primes and NTT tables against the JAX package
# ---------------------------------------------------------------------------

def test_primes_table_and_utilities_match_jax():
    for name in vars(JaxPrimes):
        if name.startswith("Q_"):
            assert getattr(Primes, name) == getattr(JaxPrimes, name)
    for n in (0, 1, 2, 97, 2 ** 31 - 1, P1, P2, P_EXT, Primes.Q_60_1,
              1099511627777, 3 * 5 * 7 * 11):
        assert primes.is_prime(n) == jax_primes.is_prime(n)
        assert primes.two_adicity(n) == jax_primes.two_adicity(n)
        assert primes.is_ntt_friendly(n, 256) == \
            jax_primes.is_ntt_friendly(n, 256)
    for bits, deg in ((30, 1024), (40, 4096), (54, 256)):
        assert primes.find_ntt_prime(bits, deg) == \
            jax_primes.find_ntt_prime(bits, deg)
    with pytest.raises(ValueError, match="composite"):
        primes.find_generator_2n(256, 1099511627777)


@pytest.mark.parametrize("q", [Primes.Q_40_1, P1, P2, P_EXT])
@pytest.mark.parametrize("n", [256, 4096])
def test_ntt_tables_match_jax(q, n):
    mine, ref = NTTContext(n, q), JaxNTT(n, q)
    assert (mine.psi, mine.psi_inv, mine.n_inv) == \
        (ref.psi, ref.psi_inv, ref.n_inv)
    for s in range(mine.logn):
        np.testing.assert_array_equal(
            mine.fwd_mont[1 << s: 2 << s], jax_to_np(ref._fwd_tw[s])[:, 0])
        np.testing.assert_array_equal(
            mine.inv_mont[n >> (s + 1): n >> s],
            jax_to_np(ref._inv_tw[s])[:, 0])
    assert mine.n_inv_mont == int(jax_to_np(ref._n_inv_c)[0])


# ---------------------------------------------------------------------------
# PallasNTT (plain path) against the JAX PallasNTT in interpret mode
# ---------------------------------------------------------------------------

N, Q = 256, Primes.Q_40_1


@pytest.fixture(scope="module")
def ntt_setup():
    rng = np.random.default_rng(0)
    a = rng.integers(0, Q, (8, N), dtype=np.uint64)
    b = rng.integers(0, Q, (8, N), dtype=np.uint64)
    ref = JaxPallasNTT(JaxNTT(N, Q), rows=8, interpret=True)
    return dict(a=a, b=b, ref=ref, pk=PallasNTT(NTTContext(N, Q)))


def test_pallas_ntt_forward_matches_jax(ntt_setup):
    s = ntt_setup
    want = jax_to_np(s["ref"].forward(jax_from_np(s["a"])))
    got = u64.u64_to_np(s["pk"].forward(u64.u64_from_np(s["a"])))
    np.testing.assert_array_equal(got, want)


def test_pallas_ntt_inverse_matches_jax(ntt_setup):
    s = ntt_setup
    fa = u64.u64_to_np(s["pk"].ntt.forward(u64.u64_from_np(s["a"])))
    want = jax_to_np(s["ref"].inverse(jax_from_np(fa)))
    got = u64.u64_to_np(s["pk"].inverse(u64.u64_from_np(fa)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, s["a"])


def test_pallas_ntt_negacyclic_mul_matches_jax(ntt_setup):
    s = ntt_setup
    want = jax_to_np(s["ref"].negacyclic_mul(jax_from_np(s["a"]),
                                             jax_from_np(s["b"])))
    got = u64.u64_to_np(s["pk"].negacyclic_mul(u64.u64_from_np(s["a"]),
                                               u64.u64_from_np(s["b"])))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], negacyclic_mul_np(s["a"][i], s["b"][i], Q))


def test_pallas_ntt_ragged_batch_matches_jax():
    """B = 24 over a 16-row JAX tile (its _tile_rows picks 8); the port's
    entries take any batch and any leading shape."""
    c = np.random.default_rng(3).integers(0, Q, (24, N), dtype=np.uint64)
    ref = JaxPallasNTT(JaxNTT(N, Q), rows=16, interpret=True)
    want = jax_to_np(ref.forward(jax_from_np(c)))
    pk = PallasNTT(NTTContext(N, Q))
    got = pk.forward(u64.u64_from_np(c.reshape(2, 3, 4, N)))
    assert got[0].shape == (2, 3, 4, N)
    np.testing.assert_array_equal(u64.u64_to_np(got).reshape(24, N), want)


def test_pallas_ntt_checks_its_inputs_and_counts_no_cpu_launch():
    pk = PallasNTT(NTTContext(N, Q))
    before = dict(PallasNTT.launches)
    a = u64.u64_from_np(np.zeros((2, N), dtype=np.uint64))
    pk.forward(a)
    pk.negacyclic_mul(a, a)
    assert PallasNTT.launches == before       # the plain path launches none
    with pytest.raises(ValueError, match="N=256"):
        pk.forward(u64.u64_from_np(np.zeros((2, 128), dtype=np.uint64)))
    with pytest.raises(ValueError, match="int32"):
        pk.inverse((a[0].long(), a[1].long()))
    with pytest.raises(ValueError, match="shape"):
        pk.negacyclic_mul(a, (a[0][:1], a[1][:1]))


# ---------------------------------------------------------------------------
# Reference-compatible NTT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,q", [(8, 97), (64, Primes.Q_30_1), (256, P1)])
def test_ref_compat_round_trips_and_matches_jax(n, q):
    coeffs = [int(v) for v in
              np.random.default_rng(n).integers(0, q, n, dtype=np.uint64)]
    fwd = ref_compat.ref_forward_ntt(coeffs, q)
    assert fwd == jax_ref.ref_forward_ntt(coeffs, q)
    assert ref_compat.ref_inverse_ntt(fwd, q) == coeffs
    assert ref_compat.ref_inverse_ntt(fwd, q) == \
        jax_ref.ref_inverse_ntt(fwd, q)
    assert ref_compat.ref_round_trip_ok(coeffs, q)
