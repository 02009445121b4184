"""The port's RNS ring and BFV engine over a whole moduli chain
(core/rns.py, and KeyManager's RNS branch in core/keys.py) against the JAX
package on the CPU.

Shapes: N=64 over the 30/30/29-bit chain of tests/test_rns.py, t=64, noise
from the parameter set (std 3.2).  Where the JAX package draws, the test
makes the same draws with jax.random and the JAX ring's samplers, in the
JAX package's order and split keys, and passes them to the port's
``*_from_draws`` (the signed ternary and gaussian samples as integers, so
that ``RnsPolyRing.from_signed`` maps them to every prime).  The JAX RNS
multiply compiles for ~95 s and its relinearize for ~25 s on the CPU, so
the default tier holds the port's products against SHA-256 digests of the
JAX package's outputs on the same inputs (committed below); the ``slow``
tests ``*_live`` compute them now:

    pytest -m slow -k live -n 0 tests/test_torch_rns.py

Tolerance: exact equality of every residue, decoded value and noise
budget."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.core import params as jparams
from node_fhe_accelerate_tpu.core import rns as jrns
from node_fhe_accelerate_tpu.ops.modular import ModCtx as JaxModCtx
from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jax_from_np,
                                             u64_shl as jax_shl,
                                             u64_to_np as jax_to_np)
from node_fhe_accelerate_tpu_torch.convert import (rns_poly_from_numpy,
                                                   rns_poly_to_numpy)
from node_fhe_accelerate_tpu_torch.core import params, rns
from node_fhe_accelerate_tpu_torch.core.encrypt import Ciphertext
from node_fhe_accelerate_tpu_torch.core.keys import KeyManager, SecretKey
from node_fhe_accelerate_tpu_torch.ops.primes import find_ntt_prime
from node_fhe_accelerate_tpu_torch.ops.u64 import (u64_from_np, u64_shl,
                                                   u64_to_np)

torch.set_num_threads(2)

N = 64
Q1 = find_ntt_prime(30, N)
Q2 = find_ntt_prime(30, N, below=Q1)
Q3 = find_ntt_prime(29, N)
MODULI = [Q1, Q2, Q3]
T = 64
# SHA-256 of the JAX package's outputs on the inputs of products() below
DIGESTS = {
    "multiply_rescale":
        "6b70df954ce1b98a664d99a9795d054387c22a91da7231a3e17177cb7bd4e6cc",
    "relinearize":
        "6d354d5f605e4ee738cf2b5c7b2555f68ca0a4e328a6e939547da4005aecf5ac",
    "square_relin":
        "4a7d55d0c375bc9c01b614051029de9b05aa2811c46d7f4f4fdbec80c2ec6a13",
    "depth_2":
        "5994116046047184dfc746d89967bbb2734eeac228f0c8efdce1cf9bf88d7c41",
}


def rns_kwargs(moduli=None):
    return dict(poly_degree=N, moduli=moduli or MODULI, lwe_dimension=16,
                lwe_noise_std=3.2e-11, glwe_dimension=1, decomp_base_log=8,
                decomp_level=4, plaintext_modulus=T)


def port(poly):
    """A JAX residue tuple on the port's CPU path."""
    return rns_poly_from_numpy(tuple(tuple(np.asarray(x) for x in r)
                                     for r in poly), "cpu")


def assert_rns(got, want):
    assert len(got) == len(want)
    for g, w in zip(rns_poly_to_numpy(got), want):
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))


def assert_ct(got, want):
    for g, w in zip((got.c0, got.c1, got.c2), (want.c0, want.c1, want.c2)):
        assert (g is None) == (w is None)
        if g is not None:
            assert_rns(g, w)
    assert got.noise_budget == want.noise_budget
    assert got.key_id == want.key_id


def digest(ct) -> str:
    """SHA-256 of a ciphertext's residues (uint64, little-endian) and its
    noise budget."""
    h = hashlib.sha256()
    for poly in (ct.c0, ct.c1, ct.c2):
        if poly is None:
            continue
        for r in poly:
            lo, hi = (np.asarray(x).view(np.uint32).astype(np.uint64)
                      if not isinstance(x, torch.Tensor)
                      else x.numpy().view(np.uint32).astype(np.uint64)
                      for x in r)
            h.update(np.ascontiguousarray(lo | (hi << np.uint64(32)),
                                          dtype="<u8").tobytes())
    h.update(repr(float(ct.noise_budget)).encode())
    return h.hexdigest()


# the JAX RnsPolyRing's draws (core/rns.py), as signed integers
def jax_ternary(key, shape=(N,)):
    return np.asarray(jax.random.randint(key, shape, 0, 3,
                                         dtype=jnp.int32) - 1)


def jax_gaussian(key, std, shape=(N,)):
    z = jax.random.normal(key, shape, dtype=jnp.float32)
    return np.asarray(jnp.round(z * std).astype(jnp.int32))


def signed(eng, s):
    return eng.ring.from_signed(torch.from_numpy(np.array(s)))


@pytest.fixture(scope="module")
def s():
    """The JAX engine and keys (tests/test_rns.py's), and the port's made
    from the same draws."""
    jp = jparams.ParameterSet(scheme=jparams.FHEScheme.BFV, **rns_kwargs())
    p = params.ParameterSet(scheme=params.FHEScheme.BFV, **rns_kwargs())
    jeng = jrns.RnsEncryptionEngine(jp)
    eng = rns.RnsEncryptionEngine(p, device="cpu")
    std = eng._noise_std
    jks = jeng.keyset
    jsk = jks.generate_secret_key(jax.random.PRNGKey(0))
    jpk = jks.generate_public_key(jax.random.PRNGKey(1), jsk)
    jrk = jks.generate_relin_key(jax.random.PRNGKey(2), jsk)
    sk = SecretKey(poly=signed(eng, jax_ternary(jax.random.PRNGKey(0))),
                   key_id="rns-sk")
    k_a, k_e = jax.random.split(jax.random.PRNGKey(1))
    pk = eng.keyset.public_key_from_draws(
        sk, port(jeng.ring.sample_uniform(k_a)),
        signed(eng, jax_gaussian(k_e, std)))
    a_list, e_list = [], []
    for j in range(len(MODULI)):
        k_a, k_e = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(2), j))
        a_list.append(port(jeng.ring.sample_uniform(k_a)))
        e_list.append(signed(eng, jax_gaussian(k_e, std)))
    rk = eng.keyset.relin_key_from_draws(sk, a_list, e_list)
    return dict(jeng=jeng, eng=eng, jsk=jsk, jpk=jpk, jrk=jrk, sk=sk, pk=pk,
                rk=rk)


def encrypt_both(s, key, values):
    """A JAX ciphertext and the port's from the same draws."""
    jct = s["jeng"].encrypt(key, values, s["jpk"])
    k_u, k_e1, k_e2 = jax.random.split(key, 3)
    eng, std = s["eng"], s["eng"]._noise_std
    ct = eng.encrypt_from_draws(values, s["pk"],
                                signed(eng, jax_ternary(k_u)),
                                signed(eng, jax_gaussian(k_e1, std)),
                                signed(eng, jax_gaussian(k_e2, std)))
    return jct, ct


def products(s, mul, relin):
    """The products of the digests, through the port's multiply and
    relinearize: (name, ciphertext) pairs."""
    _, a = encrypt_both(s, jax.random.PRNGKey(14), [7, 3])
    _, b = encrypt_both(s, jax.random.PRNGKey(15), 6)
    raw = mul(a, b)
    rel = relin(raw)
    sq = relin(mul(a, a))
    d2 = relin(mul(rel, b))
    return [("multiply_rescale", raw), ("relinearize", rel),
            ("square_relin", sq), ("depth_2", d2)]


# ---------------------------------------------------------------------------
# the ring: the signed-sample map, the cross-prime lift, the CRT
# ---------------------------------------------------------------------------

PRIMES_BY_BITS = {b: find_ntt_prime(b, 1024) for b in (30, 40, 50, 60)}


@pytest.mark.parametrize("bits", sorted(PRIMES_BY_BITS))
def test_signed_to_planes_matches_jax(bits):
    q = PRIMES_BY_BITS[bits]
    rng = np.random.default_rng(bits)
    v = rng.integers(-(1 << 31) + 1, 1 << 31, 256).astype(np.int32)
    v[:3] = [0, -1, 1]
    got = rns._signed_to_planes(torch.from_numpy(v), q)
    want = jrns._signed_to_planes(jnp.asarray(v), q)
    np.testing.assert_array_equal(u64_to_np(got), jax_to_np(want))


@pytest.mark.parametrize("src,dst", [(60, 30), (60, 40), (60, 50), (50, 60),
                                     (40, 30), (30, 60), (50, 40)])
def test_cross_prime_lift_matches_jax(src, dst):
    """A residue below q_j (up to 60 bits) reduced mod q_i through the
    128-bit reduction with zero high lanes, as relinearize and the CKKS
    rescale lift it."""
    qj, qi = PRIMES_BY_BITS[src], PRIMES_BY_BITS[dst]
    rng = np.random.default_rng(src * 100 + dst)
    w = np.array([int(x) % qj for x in rng.integers(0, 1 << 63, 512,
                                                    dtype=np.uint64)]
                 + [0, 1, qj - 1], dtype=np.uint64)
    ring = rns.RnsPolyRing(1024, [qj, qi], device="cpu")
    got = rns.lift(ring, u64_from_np(w), 0, 1)
    jw = jax_from_np(w)
    z = jnp.zeros_like(jw[0])
    want = JaxModCtx(qi).reduce_128((jw[0], jw[1], z, z))
    np.testing.assert_array_equal(u64_to_np(got), jax_to_np(want))
    np.testing.assert_array_equal(u64_to_np(got), w % np.uint64(qi))
    assert rns.lift(ring, u64_from_np(w), 0, 0)[0] is not None


@pytest.mark.parametrize("k", [64, 70, 96, 100, 120])
def test_u64_shl_by_64_and_more_matches_jax(k):
    """The shift that was undefined on int64 lanes for k >= 96; zero from
    k = 64 on, as the JAX package's uint32 shifts give."""
    x = np.random.default_rng(k).integers(0, 1 << 63, 64,
                                          dtype=np.uint64) * 2 + 1
    got = u64_to_np(u64_shl(u64_from_np(x), k))
    np.testing.assert_array_equal(got, jax_to_np(jax_shl(jax_from_np(x),
                                                         k)))
    assert not got.any()


def test_crt_and_host_edges_match_jax(s):
    ring, jring = s["eng"].ring, s["jeng"].ring
    rng = np.random.default_rng(0)
    coeffs = np.array([int.from_bytes(rng.bytes(12), "little") % ring.Q
                       for _ in range(N)], dtype=object)
    poly = ring.from_int_coeffs(coeffs)
    assert_rns(poly, jring.from_int_coeffs(coeffs))
    np.testing.assert_array_equal(ring.to_int_coeffs(poly), coeffs)
    np.testing.assert_array_equal(ring.to_np(poly),
                                  jring.to_np(jring.from_int_coeffs(coeffs)))
    assert_rns(ring.from_np(ring.to_np(poly).reshape(-1)),
               jring.from_np(ring.to_np(poly).reshape(-1)))
    assert (ring.Q, ring.q, ring.K) == (jring.Q, jring.q, jring.K)
    assert_rns(ring.zeros((2,)), jring.zeros((2,)))


def test_ring_ops_match_jax(s):
    ring, jring = s["eng"].ring, s["jeng"].ring
    rng = np.random.default_rng(1)
    x = [np.array([int(v) for v in rng.integers(0, 1 << 62, N)],
                  dtype=object) for _ in range(2)]
    a, b = (ring.from_int_coeffs(v) for v in x)
    ja, jb = (jring.from_int_coeffs(v) for v in x)
    for name in ("add", "sub", "multiply"):
        assert_rns(getattr(ring, name)(a, b), getattr(jring, name)(ja, jb))
    assert_rns(ring.neg(a), jring.neg(ja))
    assert_rns(ring.scalar_mul(a, 3 * ring.Q + 17),
               jring.scalar_mul(ja, 3 * ring.Q + 17))
    # the transforms and the pointwise product per prime (the JAX rings'
    # jitted transforms would compile for ~10 s more): the prime's ring
    for got, r, x, y in zip(ring.pointwise(ring.to_ntt(a), b), ring.rings,
                            a, b):
        want = r.pointwise(r.to_ntt(x), y)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert_rns(ring.from_ntt(ring.to_ntt(a)), ja)


def test_port_samplers_share_one_integer_sample():
    """The port's own draws: the same signed integer mod every prime (a
    small centered value after the CRT), one draw per coefficient."""
    p = params.ParameterSet(scheme=params.FHEScheme.BFV, **rns_kwargs())
    ring = rns.RnsEncryptionEngine(p, device="cpu").ring
    g = torch.Generator().manual_seed(5)
    for poly, bound in ((ring.sample_gaussian(g, 3.2), 64),
                        (ring.sample_ternary(g), 1),
                        (ring.sample_binary(g), 1)):
        for v in ring.to_int_coeffs(poly).tolist():
            assert min(v, ring.Q - v) <= bound
    state = g.get_state()
    u = ring.sample_uniform(g)
    g.set_state(state)
    assert_rns(u, rns_poly_to_numpy(tuple(r.sample_uniform(g)
                                          for r in ring.rings)))


# ---------------------------------------------------------------------------
# keys, encryption, decryption, homomorphic ops
# ---------------------------------------------------------------------------


def test_keygen_matches_jax(s):
    assert_rns(s["sk"].poly, s["jsk"].poly)
    assert_rns(s["pk"].a, s["jpk"].a)
    assert_rns(s["pk"].b, s["jpk"].b)
    assert (s["pk"].key_id, s["sk"].key_id) == (s["jpk"].key_id,
                                                 s["jsk"].key_id)
    for x, y in zip(s["rk"].a + s["rk"].b, s["jrk"].a + s["jrk"].b):
        assert_rns(x, y)
    assert s["rk"].key_id == s["jrk"].key_id


def test_keymanager_takes_the_rns_gadget_on_an_rns_ring(s):
    """KeyManager.generate_relin_key on an RNS ring gives RnsKeySet's key
    from the same generator state (the digit arguments are ignored)."""
    eng = s["eng"]
    state = torch.Generator().manual_seed(3).get_state()
    keys = []
    for make in (lambda g: KeyManager(eng.params, eng.ring).generate_relin_key(
                     g, s["sk"], 20, 3),
                 lambda g: eng.keyset.generate_relin_key(g, s["sk"])):
        g = torch.Generator()
        g.set_state(state)
        keys.append(make(g))
    assert isinstance(keys[0], rns.RnsRelinKey)
    for x, y in zip(keys[0].a + keys[0].b, keys[1].a + keys[1].b):
        assert_rns(x, rns_poly_to_numpy(y))


def test_encrypt_and_decrypt_match_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    for i, m in enumerate([0, 19, [7, 3, 63, 0], list(range(64))]):
        jct, ct = encrypt_both(s, jax.random.PRNGKey(40 + i), m)
        assert_ct(ct, jct)
        n = len(m) if isinstance(m, list) else 1
        vals, budget = eng.decrypt(ct, s["sk"], n)
        jvals, jbudget = jeng.decrypt(jct, s["jsk"], n)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(vals, np.atleast_1d(m))
        assert budget == jbudget > 40
    key = jax.random.PRNGKey(50)
    jct = jeng.encrypt_symmetric(key, 9, s["jsk"])
    k_a, k_e = jax.random.split(key)
    ct = eng.encrypt_symmetric_from_draws(
        9, s["sk"], port(jeng.ring.sample_uniform(k_a)),
        signed(eng, jax_gaussian(k_e, eng._noise_std)))
    assert_ct(ct, jct)
    assert eng.decrypt(ct, s["sk"])[0][0] == 9
    assert eng.initial_noise_budget == jeng.initial_noise_budget


def test_homomorphic_ops_match_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    ja, ca = encrypt_both(s, jax.random.PRNGKey(60), [11, 2])
    jb, cb = encrypt_both(s, jax.random.PRNGKey(61), [7, 9])
    pairs = [(eng.add(ca, cb), jeng.add(ja, jb)),
             (eng.sub(ca, cb), jeng.sub(ja, jb)),
             (eng.negate(ca), jeng.negate(ja)),
             (eng.add_plain(ca, [3, 4]), jeng.add_plain(ja, [3, 4])),
             (eng.multiply_scalar(ca, 5), jeng.multiply_scalar(ja, 5)),
             (eng.multiply_plain(ca, [2, 1]), jeng.multiply_plain(ja, [2, 1])),
             (eng.update_tally(ca, cb), jeng.update_tally(ja, jb))]
    for got, want in pairs:
        assert_ct(got, want)
    assert eng.decrypt(pairs[1][0], s["sk"], 2)[0].tolist() == [4, 57]
    assert eng.decrypt(pairs[5][0], s["sk"], 3)[0].tolist() == [22, 15, 2]


def test_tallies_match_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    both = [encrypt_both(s, jax.random.PRNGKey(80 + i), [i % 2, 1 - i % 2])
            for i in range(5)]
    js, cs = [b[0] for b in both], [b[1] for b in both]
    for name in ("batch_add", "tally_votes", "tally_multi_candidate"):
        assert_ct(getattr(eng, name)(cs), getattr(jeng, name)(js))
    assert_ct(eng.tally_weighted(cs, [1, 2, 3, 4, 5]),
              jeng.tally_weighted(js, [1, 2, 3, 4, 5]))
    assert eng.decrypt(eng.batch_add(cs), s["sk"], 2)[0].tolist() == [2, 3]
    with pytest.raises(ValueError):
        eng.batch_add([])
    with pytest.raises(ValueError):
        eng.tally_weighted(cs, [1])


def test_noise_budget_and_decode_match_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    rng = np.random.default_rng(9)
    coeffs = np.array([int.from_bytes(rng.bytes(12), "little") % eng.q
                       for _ in range(N)], dtype=object)
    ph, jph = eng.ring.from_int_coeffs(coeffs), \
        jeng.ring.from_int_coeffs(coeffs)
    np.testing.assert_array_equal(eng.decode(ph, 7), jeng.decode(jph, 7))
    assert eng.noise_budget(ph) == jeng.noise_budget(jph)
    assert_rns(eng.encode([1, 2, 63]), jeng.encode([1, 2, 63]))


# ---------------------------------------------------------------------------
# multiply (exact tensor product + t/Q rescale) and the RNS relinearize
# ---------------------------------------------------------------------------


def test_multiply_and_relinearize_match_jax_digests(s):
    eng = s["eng"]
    out = products(s, eng.multiply_rescale,
                   lambda ct: eng.relinearize(ct, s["rk"]))
    for name, ct in out:
        assert digest(ct) == DIGESTS[name], name
    got = dict(out)
    assert got["multiply_rescale"].is_degree_2
    assert not got["relinearize"].is_degree_2
    sk = s["sk"]
    assert eng.decrypt(got["multiply_rescale"], sk, 2)[0].tolist() == [42, 18]
    vals, budget = eng.decrypt(got["relinearize"], sk, 2)
    assert vals.tolist() == [42, 18] and budget > 10
    assert eng.decrypt(got["square_relin"], sk, 3)[0].tolist() == \
        [49, 42, 9]
    assert eng.decrypt(got["depth_2"], sk, 2)[0].tolist() == \
        [(42 * 6) % T, (18 * 6) % T]
    assert eng.relinearize(got["relinearize"], s["rk"]) is got["relinearize"]
    with pytest.raises(ValueError):
        eng.multiply_rescale(got["multiply_rescale"], got["relinearize"])


def test_multiply_relin_is_multiply_then_relinearize(s):
    eng = s["eng"]
    _, a = encrypt_both(s, jax.random.PRNGKey(14), [7, 3])
    _, b = encrypt_both(s, jax.random.PRNGKey(15), 6)
    got = eng.multiply_relin(a, b, s["rk"])
    want = eng.relinearize(eng.multiply_rescale(a, b), s["rk"])
    assert digest(got) == digest(want) == DIGESTS["relinearize"]
    assert digest(eng.multiply_relin_rescale(a, b, s["rk"])) == \
        DIGESTS["relinearize"]


@pytest.mark.slow
def test_multiply_and_relinearize_match_jax_live(s):
    jeng = s["jeng"]
    ja = jeng.encrypt(jax.random.PRNGKey(14), [7, 3], s["jpk"])
    jb = jeng.encrypt(jax.random.PRNGKey(15), 6, s["jpk"])
    raw = jeng.multiply_rescale(ja, jb)
    rel = jeng.relinearize(raw, s["jrk"])
    sq = jeng.relinearize(jeng.multiply_rescale(ja, ja), s["jrk"])
    d2 = jeng.relinearize(jeng.multiply_rescale(rel, jb), s["jrk"])
    jout = [("multiply_rescale", raw), ("relinearize", rel),
            ("square_relin", sq), ("depth_2", d2)]
    eng = s["eng"]
    out = products(s, eng.multiply_rescale,
                   lambda ct: eng.relinearize(ct, s["rk"]))
    for (name, got), (_, want) in zip(out, jout):
        assert_ct(got, want)
        assert digest(want) == DIGESTS[name], name


def test_generator_round_trip_over_the_chain():
    """The port's own draws end to end: keys, encryptions, a product
    relinearized, depth 2, decrypted."""
    p = params.ParameterSet(scheme=params.FHEScheme.BFV, **rns_kwargs())
    eng = rns.RnsEncryptionEngine(p, device="cpu")
    g = torch.Generator().manual_seed(7)
    sk = eng.keyset.generate_secret_key(g)
    pk = eng.keyset.generate_public_key(g, sk)
    rk = eng.keyset.generate_relin_key(g, sk)
    a = eng.encrypt(g, [7, 3], pk)
    b = eng.encrypt_symmetric(g, 6, sk)
    m = eng.multiply_relin(a, b, rk)
    assert eng.decrypt(m, sk, 2)[0].tolist() == [42, 18]
    m2 = eng.multiply_relin(m, b, rk)
    assert eng.decrypt(m2, sk, 2)[0].tolist() == [252 % T, 108 % T]
    ct = Ciphertext(c0=m.c0, c1=m.c1)
    assert eng.decrypt(ct, sk, 1)[0][0] == 42
