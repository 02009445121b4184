"""The port's BFV multiply with the t/q rescale (core/bfv_mul.py:
RescaleMultiplier, RnsRescaleMultiplier, aux_prime_chain) and the engine's
multiply_relin_rescale, against the JAX package on the CPU.

Inputs come from numpy with a seed.  The JAX package's multiply costs
~25-30 s of XLA compile on the CPU, so the default tier holds the port
against SHA-256 digests of the JAX package's outputs on the same inputs
(committed below; the live tests compute them); the ``slow`` tests
``*_live`` run the JAX package now, at these shapes and at the full ones
(N=1024 over Q_40_1, N=8192 over Q_60_1):

    pytest -m slow -k live -n 0 tests/test_torch_bfv_mul.py

Tolerance: exact equality (every output coefficient's bytes)."""
import hashlib

import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu_torch.core import bfv_mul
from node_fhe_accelerate_tpu_torch.core.encrypt import (Ciphertext,
                                                        EncryptionEngine)
from node_fhe_accelerate_tpu_torch.core.keys import KeyManager
from node_fhe_accelerate_tpu_torch.core.params import (FHEScheme,
                                                       ParameterSet, Primes)
from node_fhe_accelerate_tpu_torch.ops.primes import find_ntt_prime
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np, u64_to_np

torch.set_num_threads(2)

# (N, q, t) of the single-modulus cases; the last two are the full shapes
SINGLE = {"small": (256, 7681, 16), "ballot": (1024, Primes.Q_40_1, 64),
          "simd": (8192, Primes.Q_60_1, 65537)}
# (N, moduli, t) of the RNS case: two 30-bit NTT primes at N=64
RNS_N = 64
RNS_MODULI = [find_ntt_prime(30, RNS_N),
              find_ntt_prime(30, RNS_N, below=find_ntt_prime(30, RNS_N))]
RNS_T = 257
# SHA-256 of the JAX package's outputs on inputs(...) below
DIGESTS = {
    "small":
        "bb50ecaf00b373e8c96e6ee025ca28020034041a089198f7a40e004b1232d937",
    "rns":
        "70220f869b1c599e372b7432ed601073726a7032b76e843fd59e822b65b8d924",
    "relin":
        "463eee45a56bb081d4874cb80b0880f17ed0cb6fd49d820b65ac5cf80a9f720d",
}


def inputs(n, moduli, seed, batch=(2,)):
    """(a0, a1, b0, b1): per modulus uint64 residues (..., N) of random
    integers below the product of the moduli (the same integers for every
    modulus)."""
    rng = np.random.default_rng(seed)
    Q = int(np.prod([int(m) for m in moduli], dtype=object))
    out = []
    for _ in range(4):
        x = np.array([int.from_bytes(rng.bytes(32), "little") % Q
                      for _ in range(int(np.prod(batch)) * n)], dtype=object)
        out.append([np.array(x % m, dtype=np.uint64).reshape(batch + (n,))
                    for m in moduli])
    return out


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype="<u8").tobytes())
    return h.hexdigest()


def port_single(n, q, t, seed):
    ops = [u64_from_np(x[0]) for x in inputs(n, [q], seed)]
    rs = bfv_mul.RescaleMultiplier(n, q, t, device="cpu")
    return [u64_to_np(d) for d in rs.multiply(*ops)]


def port_rns(seed):
    ops = [[u64_from_np(r) for r in x]
           for x in inputs(RNS_N, RNS_MODULI, seed)]
    rs = bfv_mul.RnsRescaleMultiplier(RNS_N, RNS_MODULI, RNS_T, device="cpu")
    return [u64_to_np(r) for comp in rs.multiply(*ops) for r in comp]


def jax_outputs(kind, seed):
    """The JAX package's outputs on the same inputs (the live side)."""
    from node_fhe_accelerate_tpu.core import bfv_mul as jbfv
    from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jfrom,
                                                 u64_to_np as jto)
    if kind == "rns":
        ops = [[jfrom(r) for r in x]
               for x in inputs(RNS_N, RNS_MODULI, seed)]
        rs = jbfv.RnsRescaleMultiplier(RNS_N, RNS_MODULI, RNS_T)
        out = jax.jit(rs.multiply)(*ops)
        return [jto(r) for comp in out for r in comp]
    n, q, t = SINGLE[kind]
    ops = [jfrom(x[0]) for x in inputs(n, [q], seed)]
    rs = jbfv.RescaleMultiplier(n, q, t)
    return [jto(d) for d in jax.jit(rs.multiply)(*ops)]


def test_aux_prime_chain_matches_jax():
    from node_fhe_accelerate_tpu.core import bfv_mul as jbfv
    for n, bits, excl in ((256, 40, ()), (1024, 96, ()), (8192, 136, ()),
                          (64, 150, tuple(RNS_MODULI))):
        assert bfv_mul.aux_prime_chain(n, bits, excl) == \
            jbfv.aux_prime_chain(n, bits, excl)


def test_rescale_multiplier_constants_match_jax():
    from node_fhe_accelerate_tpu.core import bfv_mul as jbfv
    for n, q, t in SINGLE.values():
        got = bfv_mul.RescaleMultiplier(n, q, t, device="cpu")
        want = jbfv.RescaleMultiplier(n, q, t)
        assert (got.aux_primes, got.M, got.K, got.mu) == \
            (want.aux_primes, want.M, want.K, want.mu)
    got = bfv_mul.RnsRescaleMultiplier(RNS_N, RNS_MODULI, RNS_T,
                                       device="cpu")
    want = jbfv.RnsRescaleMultiplier(RNS_N, RNS_MODULI, RNS_T)
    assert (got.aux_primes, got.M, got.K, got.mu, got.d_y) == \
        (want.aux_primes, want.M, want.K, want.mu, want.d_y)


def test_rescale_multiplier_matches_jax_vectors():
    assert digest(port_single(*SINGLE["small"], seed=21)) == DIGESTS["small"]


def test_rns_rescale_multiplier_matches_jax_vectors():
    assert digest(port_rns(seed=22)) == DIGESTS["rns"]


def test_rescale_is_round_t_over_q_of_the_exact_product():
    """d_i = round(t/q * X_i) mod q with X the centered negacyclic tensor
    product over Z (Python integers), on every coefficient (the Barrett
    quotient's off-by-one, probability ~2^-24, does not occur here)."""
    n, q, t = SINGLE["small"]
    a0, a1, b0, b1 = (x[0][0] for x in inputs(n, [q], 21))
    got = port_single(n, q, t, seed=21)

    def centered(v):
        return [int(c) - q if int(c) > q // 2 else int(c) for c in v]

    def negacyclic(x, y):
        out = [0] * n
        for i, xi in enumerate(x):
            for j, yj in enumerate(y):
                k = i + j
                if k < n:
                    out[k] += xi * yj
                else:
                    out[k - n] -= xi * yj
        return out

    A0, A1, B0, B1 = (centered(v) for v in (a0, a1, b0, b1))
    X = [negacyclic(A0, B0),
         [u + v for u, v in zip(negacyclic(A0, B1), negacyclic(A1, B0))],
         negacyclic(A1, B1)]
    for comp in range(3):
        want = [((2 * t * x + q) // (2 * q)) % q for x in X[comp]]
        np.testing.assert_array_equal(got[comp][0], want)


def relin_setup(n, q, t, seed, noise=None):
    """Port engine, keys and two ciphertexts from a seeded generator."""
    p = ParameterSet(scheme=FHEScheme.BFV, poly_degree=n, moduli=[q],
                     lwe_dimension=0, lwe_noise_std=3.2, decomp_base_log=20,
                     decomp_level=3, plaintext_modulus=t)
    eng = EncryptionEngine(p, noise_std=noise, device="cpu")
    km = KeyManager(p, eng.ring, noise_std=noise)
    g = torch.Generator().manual_seed(seed)
    sk = km.generate_secret_key(g)
    pk = km.generate_public_key(g, sk)
    rlk = km.generate_relin_key(g, sk)
    rng = np.random.default_rng(seed)
    m1 = rng.integers(0, t, 4, dtype=np.uint64)
    m2 = rng.integers(0, t, 4, dtype=np.uint64)
    return eng, sk, rlk, eng.encrypt(g, m1, pk), eng.encrypt(g, m2, pk), \
        m1, m2


def negacyclic_mod_t(m1, m2, n, t):
    out = np.zeros(n, dtype=object)
    for i, x in enumerate(m1):
        for j, y in enumerate(m2):
            k = i + j
            out[k % n] += (-1 if k >= n else 1) * int(x) * int(y)
    return (out % t).astype(np.uint64)


def test_multiply_relin_rescale_decrypts_to_the_product():
    """The port's own draws at the ballot ring with real noise: the
    product of two packed messages decrypts to their negacyclic product
    mod t."""
    n, q, t = SINGLE["ballot"]
    eng, sk, rlk, c1, c2, m1, m2 = relin_setup(n, q, t, seed=5)
    prod = eng.multiply_relin_rescale(c1, c2, rlk)
    assert not prod.is_degree_2
    vals, budget = eng.decrypt(prod, sk, n)
    np.testing.assert_array_equal(vals, negacyclic_mod_t(m1, m2, n, t))
    assert budget > 0
    assert isinstance(eng.square(c1), Ciphertext)


def test_multiply_relin_rescale_matches_jax_vectors():
    """Zero-noise engine at N=256, q=7681 (the JAX package's own exact
    tests' ring; too small a q for the product to decrypt, which the ballot
    ring's test checks): multiply_relin_rescale of two ciphertexts made
    from the port's seeded draws."""
    n, q, t = SINGLE["small"]
    eng, _, rlk, c1, c2, _, _ = relin_setup(n, q, t, seed=6, noise=0.0)
    out = eng.multiply_relin_rescale(c1, c2, rlk)
    assert digest([u64_to_np(out.c0), u64_to_np(out.c1)]) == \
        DIGESTS["relin"]


def jax_relin_outputs(n, q, t, seed):
    """The JAX engine's multiply_relin_rescale on the port's ciphertexts
    and keys (carried over as numpy)."""
    from node_fhe_accelerate_tpu.core import params as jparams
    from node_fhe_accelerate_tpu.core.encrypt import (
        Ciphertext as JCt, EncryptionEngine as JEng)
    from node_fhe_accelerate_tpu.core.keys import RelinKey as JRlk
    from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jfrom,
                                                 u64_to_np as jto)
    eng, sk, rlk, c1, c2, _, _ = relin_setup(n, q, t, seed, noise=0.0)
    jp = jparams.ParameterSet(
        scheme=jparams.FHEScheme.BFV, poly_degree=n, moduli=[q],
        lwe_dimension=0, lwe_noise_std=3.2, decomp_base_log=20,
        decomp_level=3, plaintext_modulus=t)
    jeng = JEng(jp, noise_std=0.0)

    def jp_(x):
        return jfrom(u64_to_np(x))

    jc1 = JCt(c0=jp_(c1.c0), c1=jp_(c1.c1), noise_budget=c1.noise_budget)
    jc2 = JCt(c0=jp_(c2.c0), c1=jp_(c2.c1), noise_budget=c2.noise_budget)
    jrlk = JRlk(a=[jp_(x) for x in rlk.a], b=[jp_(x) for x in rlk.b],
                decomp_base_log=rlk.decomp_base_log,
                decomp_level=rlk.decomp_level)
    out = jeng.multiply_relin_rescale(jc1, jc2, jrlk)
    return [jto(out.c0), jto(out.c1)], eng.multiply_relin_rescale(c1, c2,
                                                                   rlk)


@pytest.mark.slow
def test_vectors_live():
    """The committed digests == the JAX package's outputs now."""
    assert digest(jax_outputs("small", 21)) == DIGESTS["small"]
    assert digest(jax_outputs("rns", 22)) == DIGESTS["rns"]
    want, _ = jax_relin_outputs(*SINGLE["small"], seed=6)
    assert digest(want) == DIGESTS["relin"]


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["ballot", "simd"])
def test_full_shapes_live(kind):
    """RescaleMultiplier and multiply_relin_rescale at the full shapes:
    port == JAX package, coefficient for coefficient."""
    n, q, t = SINGLE[kind]
    for g, w in zip(port_single(n, q, t, seed=23), jax_outputs(kind, 23)):
        np.testing.assert_array_equal(g, w)
    want, got = jax_relin_outputs(n, q, t, seed=24)
    np.testing.assert_array_equal(u64_to_np(got.c0), want[0])
    np.testing.assert_array_equal(u64_to_np(got.c1), want[1])
