"""The port's RLWE (BFV) stack -- params, security, sampling, PolyRing, keys
and EncryptionEngine -- against the JAX package on the CPU.

Where the JAX package draws, the test makes the same draws with the JAX
package's own samplers and split keys and passes them, as numpy, to the
port's arithmetic half (``*_from_draws``).  Inputs otherwise come from
numpy with a seed.  Shapes: N=256, q=7681 (tests/test_encrypt.py's small
ring), zero noise where the phase algebra is under test.  Tolerance: exact
equality of every coefficient, value and float."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.core import params as jparams
from node_fhe_accelerate_tpu.core import security as jsecurity
from node_fhe_accelerate_tpu.core.encrypt import (
    EncryptionEngine as JaxEngine)
from node_fhe_accelerate_tpu.core.keys import KeyManager as JaxKeys
from node_fhe_accelerate_tpu.ops.u64 import (
    u64_and_mask as jax_and_mask, u64_from_np as jax_from_np,
    u64_shr as jax_shr, u64_to_np as jax_to_np)
from node_fhe_accelerate_tpu_torch.convert import (
    ciphertext_from_numpy, ciphertext_to_numpy, poly_from_numpy,
    secret_key_from_numpy)
from node_fhe_accelerate_tpu_torch.core import params, security
from node_fhe_accelerate_tpu_torch.core.encrypt import EncryptionEngine
from node_fhe_accelerate_tpu_torch.core.keys import (KeyManager,
                                                     SecretKeyDistribution)
from node_fhe_accelerate_tpu_torch.core.poly import PolyRing
from node_fhe_accelerate_tpu_torch.ops.u64 import (u64_and_mask, u64_from_np,
                                                   u64_shr, u64_to_np)

torch.set_num_threads(2)

N, Q, T = 256, 7681, 16


def small_kwargs():
    return dict(poly_degree=N, moduli=[Q], lwe_dimension=64,
                lwe_noise_std=3.2e-11, glwe_dimension=1, decomp_base_log=7,
                decomp_level=2, plaintext_modulus=T)


def np_planes(p):
    return tuple(np.asarray(x) for x in p)


def port(p):
    """A JAX limb-plane polynomial on the port's CPU path."""
    return poly_from_numpy(np_planes(p), "cpu")


def assert_poly(got, want):
    np.testing.assert_array_equal(u64_to_np(got), jax_to_np(want))


def assert_ct(got, want):
    for g, w in zip(ciphertext_to_numpy(got), (want.c0, want.c1, want.c2)):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g[0], np.asarray(w[0]))
            np.testing.assert_array_equal(g[1], np.asarray(w[1]))
    assert got.noise_budget == want.noise_budget
    assert (got.key_id, got.is_ntt) == (want.key_id, want.is_ntt)


@pytest.fixture(scope="module")
def s():
    """JAX engine and keys (zero noise, as tests/test_encrypt.py), and the
    port's from the same draws."""
    jp = jparams.ParameterSet(scheme=jparams.FHEScheme.TFHE, **small_kwargs())
    p = params.ParameterSet(scheme=params.FHEScheme.TFHE, **small_kwargs())
    jeng = JaxEngine(jp, noise_std=0.0)
    jkm = JaxKeys(jp, jeng.ring, noise_std=0.0)
    eng = EncryptionEngine(p, noise_std=0.0, device="cpu")
    km = KeyManager(p, eng.ring, noise_std=0.0)
    k_sk, k_pk, k_rlk = jax.random.split(jax.random.PRNGKey(0), 3)
    jsk = jkm.generate_secret_key(k_sk)
    jpk = jkm.generate_public_key(k_pk, jsk)
    jrlk = jkm.generate_relin_key(k_rlk, jsk)
    sk = secret_key_from_numpy(np_planes(jsk.poly), device="cpu")
    # the JAX generators' draws, in their order
    k_a, k_e = jax.random.split(k_pk)
    pk = km.public_key_from_draws(sk, port(jeng.ring.sample_uniform(k_a)),
                                  port(jeng.ring.sample_gaussian(k_e, 0.0)))
    base_log, levels = km.relin_levels()
    a_list, e_list, key = [], [], k_rlk
    for _ in range(levels):
        k_a, k_e, key = jax.random.split(key, 3)
        a_list.append(port(jeng.ring.sample_uniform(k_a)))
        e_list.append(port(jeng.ring.sample_gaussian(k_e, 0.0)))
    rlk = km.relin_key_from_draws(sk, a_list, e_list, base_log)
    return dict(jeng=jeng, jsk=jsk, jpk=jpk, jrlk=jrlk, eng=eng, km=km,
                sk=sk, pk=pk, rlk=rlk)


def encrypt_both(s, key, values):
    """A JAX ciphertext and the port's from the same draws."""
    jct = s["jeng"].encrypt(key, values, s["jpk"])
    ring = s["jeng"].ring
    k_u, k_e1, k_e2 = jax.random.split(key, 3)
    draws = (ring.sample_ternary(k_u), ring.sample_gaussian(k_e1, 0.0),
             ring.sample_gaussian(k_e2, 0.0))
    ct = s["eng"].encrypt_from_draws(values, s["pk"],
                                     *(port(d) for d in draws))
    return jct, ct


# ---------------------------------------------------------------------------
# params and security
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jparams.PRESETS))
def test_presets_match_jax(name):
    got, want = params.create_parameter_set(name), \
        jparams.create_parameter_set(name)
    gd, wd = dataclasses.asdict(got), dataclasses.asdict(want)
    assert gd.pop("scheme").value == wd.pop("scheme").value
    assert gd.pop("security").value == wd.pop("security").value
    assert gd == wd
    assert (got.q, got.q_total, got.get_log_modulus(),
            got.noise_std_absolute(), str(got)) == \
        (want.q, want.q_total, want.get_log_modulus(),
         want.noise_std_absolute(), str(want))
    with pytest.raises(ValueError):
        params.create_parameter_set("NOPE")


def test_primes_match_jax():
    names = [k for k in vars(jparams.Primes) if k.startswith("Q_")]
    assert names
    for k in names:
        assert getattr(params.Primes, k) == getattr(jparams.Primes, k)


SECURITY_CASES = [dict(poly_degree=1000), dict(poly_degree=512),
                  dict(moduli=[7681 * 12289]), dict(moduli=[7681]),
                  dict(lwe_noise_std=1e-20), dict(lwe_dimension=100),
                  dict(moduli=[params.Primes.Q_60_1] * 3, poly_degree=1024)]


@pytest.mark.parametrize("case", list(range(len(SECURITY_CASES)))
                         + sorted(jparams.PRESETS))
def test_security_validator_matches_jax(case):
    if isinstance(case, str):
        pairs = [(params.PRESETS[case](), jparams.PRESETS[case]())]
    else:
        kw = dict(small_kwargs(), poly_degree=1024,
                  moduli=[params.Primes.Q_40_1])
        kw.update(SECURITY_CASES[case])
        pairs = [(params.ParameterSet(scheme=params.FHEScheme(sch), **kw),
                  jparams.ParameterSet(scheme=jparams.FHEScheme(sch), **kw))
                 for sch in ("TFHE", "BFV")]
    for got_p, want_p in pairs:
        got = security.SecurityValidator().validate(got_p)
        want = jsecurity.SecurityValidator().validate(want_p)
        assert (got.is_secure, got.estimated_bits) == \
            (want.is_secure, want.estimated_bits)
        assert [(c.value, m) for c, m in got.violations] == \
            [(c.value, m) for c, m in want.violations]
    for n, lq in ((1024, 20.0), (4096, 100.0), (8192, 300.0)):
        assert security.estimate_rlwe_security_bits(n, lq) == \
            jsecurity.estimate_rlwe_security_bits(n, lq)
        assert security.estimate_tfhe_security_bits(700, n, lq) == \
            jsecurity.estimate_tfhe_security_bits(700, n, lq)


# ---------------------------------------------------------------------------
# sampling and PolyRing
# ---------------------------------------------------------------------------


def test_samplers_ranges_and_generator_state():
    ring = PolyRing(N, Q, device="cpu")
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    u = u64_to_np(ring.sample_uniform(g, (4,)))
    t = u64_to_np(ring.sample_ternary(g, (4,)))
    e = u64_to_np(ring.sample_gaussian(g, 3.2, (4,))).astype(np.int64)
    assert u.shape == t.shape == e.shape == (4, N)
    assert (u < Q).all() and len(np.unique(u)) > N
    assert set(np.unique(t)) == {0, 1, Q - 1}
    centered = np.where(e > Q // 2, e - Q, e)
    assert np.abs(centered).max() < 40 and 2.5 < centered.std() < 4.0
    g.set_state(state)
    assert (u64_to_np(ring.sample_uniform(g, (4,))) == u).all()
    big = PolyRing(8, params.Primes.Q_60_1, device="cpu")
    tb = u64_to_np(big.sample_ternary(g, (64,)))
    assert set(np.unique(tb)) <= {0, 1, params.Primes.Q_60_1 - 1}
    eb = u64_to_np(big.sample_gaussian(g, 3.2, (64,)))
    assert ((eb < 40) | (eb > params.Primes.Q_60_1 - 40)).all()


def test_polyring_ops_match_jax(s):
    """Elementwise ops on a batch, the transforms and the product on one
    polynomial each (the fixture's JAX ring, whose jitted transforms the
    other tests compile too)."""
    rng = np.random.default_rng(1)
    a_np = rng.integers(0, Q, (3, N), dtype=np.uint64)
    b_np = rng.integers(0, Q, (3, N), dtype=np.uint64)
    jr, r = s["jeng"].ring, s["eng"].ring
    ja, jb = jax_from_np(a_np), jax_from_np(b_np)
    a, b = u64_from_np(a_np), u64_from_np(b_np)
    assert_poly(r.add(a, b), jr.add(ja, jb))
    assert_poly(r.sub(a, b), jr.sub(ja, jb))
    assert_poly(r.neg(a), jr.neg(ja))
    assert_poly(r.scalar_mul(a, 12345678901), jr.scalar_mul(ja, 12345678901))
    assert_poly(r.pointwise(a, b), jr.pointwise(ja, jb))
    a0, b0 = u64_from_np(a_np[0]), u64_from_np(b_np[0])
    ja0, jb0 = jax_from_np(a_np[0]), jax_from_np(b_np[0])
    assert_poly(r.to_ntt(a0), jr.to_ntt(ja0))
    assert_poly(r.from_ntt(a0), jr.from_ntt(ja0))
    assert_poly(r.multiply(a0, b0), jr.multiply(ja0, jb0))
    assert_poly(r.constant(Q + 5), jr.constant(Q + 5))
    assert_poly(r.zeros((2,)), jr.zeros((2,)))
    want = r.multiply_np(a_np[0], b_np[0])
    np.testing.assert_array_equal(want, jr.multiply_np(a_np[0], b_np[0]))
    # batches: each row the row's product; a polynomial against a batch
    # broadcasts
    prod = u64_to_np(r.multiply(a, b))
    np.testing.assert_array_equal(prod[0], want)
    np.testing.assert_array_equal(prod[1], r.multiply_np(a_np[1], b_np[1]))
    np.testing.assert_array_equal(
        u64_to_np(r.multiply(a0, b))[2], r.multiply_np(a_np[0], b_np[2]))


@pytest.mark.parametrize("k", [0, 5, 32, 40, 60, 64, 96, 120])
def test_u64_shr_and_mask_match_jax(k):
    """Relinearization's digit extraction, shifts of 64 and more
    included (a 2^60 gadget at three levels shifts by 120)."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << 63, 64, dtype=np.uint64) * 2 + 1
    got = u64_and_mask(u64_shr(u64_from_np(x), k), (1 << 20) - 1)
    want = jax_and_mask(jax_shr(jax_from_np(x), k), (1 << 20) - 1)
    assert_poly(got, want)


# ---------------------------------------------------------------------------
# keys, encryption, decryption
# ---------------------------------------------------------------------------


def test_keygen_matches_jax(s):
    assert_poly(s["pk"].a, s["jpk"].a)
    assert_poly(s["pk"].b, s["jpk"].b)
    r, jr = s["rlk"], s["jrlk"]
    assert (r.decomp_base_log, r.decomp_level) == \
        (jr.decomp_base_log, jr.decomp_level)
    for x, y in zip(r.a + r.b, jr.a + jr.b):
        assert_poly(x, y)


def test_encrypt_and_decrypt_match_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    for i, m in enumerate([0, 1, 7, 15, list(range(16))]):
        jct, ct = encrypt_both(s, jax.random.PRNGKey(40 + i), m)
        assert_ct(ct, jct)
        n = 16 if isinstance(m, list) else 1
        vals, budget = eng.decrypt(ct, s["sk"], n)
        jvals, jbudget = jeng.decrypt(jct, s["jsk"], n)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(vals, np.atleast_1d(m))
        assert budget == jbudget > 0
    key = jax.random.PRNGKey(50)
    jct = jeng.encrypt_symmetric(key, 9, s["jsk"])
    k_a, k_e = jax.random.split(key)
    ct = eng.encrypt_symmetric_from_draws(
        9, s["sk"], port(jeng.ring.sample_uniform(k_a)),
        port(jeng.ring.sample_gaussian(k_e, 0.0)))
    assert_ct(ct, jct)
    assert eng.decrypt(ct, s["sk"])[0][0] == 9


def test_generator_round_trip_with_real_noise():
    """The port's own draws end to end at the ballot shape's ring (N=1024,
    Q_40_1, noise from the parameter set): keys, encryption and a sum
    decrypt."""
    p = params.ParameterSet(
        scheme=params.FHEScheme.TFHE, poly_degree=1024,
        moduli=[params.Primes.Q_40_1], lwe_dimension=630,
        lwe_noise_std=3.2e-11, decomp_base_log=23, decomp_level=1,
        plaintext_modulus=64)
    eng = EncryptionEngine(p, device="cpu")
    km = KeyManager(p, eng.ring)
    assert eng._noise_std == p.noise_std_absolute() > 3.2
    g = torch.Generator().manual_seed(7)
    sk = km.generate_secret_key(g)
    pk = km.generate_public_key(g, sk)
    c1 = eng.encrypt(g, [1, 0, 3], pk)
    c2 = eng.encrypt_symmetric(g, [2, 5, 60], sk)
    vals, budget = eng.decrypt(eng.add(c1, c2), sk, 3)
    np.testing.assert_array_equal(vals, [3, 5, 63])
    assert budget > 20
    for dist in SecretKeyDistribution:
        key = km.generate_secret_key(g, dist)
        assert u64_to_np(key.poly).shape == (1024,)


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
    assert eng.decrypt(pairs[1][0], s["sk"], 2)[0].tolist() == [4, 9]
    assert eng.decrypt(pairs[5][0], s["sk"], 2)[0].tolist() == [6, 15]


def test_multiply_raw_relinearize_match_jax(s):
    """The tensor product (degree 2, Delta^2), its degree-2 phase, adds of
    degree-2 ciphertexts, and relinearization against the relin key."""
    eng, jeng = s["eng"], s["jeng"]
    ja, ca = encrypt_both(s, jax.random.PRNGKey(70), 3)
    jb, cb = encrypt_both(s, jax.random.PRNGKey(71), 5)
    jraw, raw = jeng.multiply_raw(ja, jb), eng.multiply_raw(ca, cb)
    assert_ct(raw, jraw)
    assert_poly(eng.phase(raw, s["sk"]), jeng.phase(jraw, s["jsk"]))
    assert_ct(eng.add(raw, ca), jeng.add(jraw, ja))
    assert_ct(eng.sub(ca, raw), jeng.sub(ja, jraw))
    assert_ct(eng.negate(raw), jeng.negate(jraw))
    jrel = jeng.relinearize(jraw, s["jrlk"])
    rel = eng.relinearize(raw, s["rlk"])
    assert_ct(rel, jrel)
    assert_poly(eng.phase(rel, s["sk"]), jeng.phase(jrel, s["jsk"]))
    # Delta^2 * 15 decodes at Delta^2 (zero noise)
    coeff = int(u64_to_np(eng.phase(rel, s["sk"]))[0])
    assert coeff == (15 * eng.delta * eng.delta) % Q
    with pytest.raises(ValueError):
        eng.multiply_raw(raw, ca)
    assert eng.relinearize(ca, s["rlk"]) is ca


def test_batch_add_and_tallies_match_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    both = [encrypt_both(s, jax.random.PRNGKey(80 + i), [i % 2, 1 - i % 2])
            for i in range(5)]
    js, cs = [b[0] for b in both], [b[1] for b in both]
    for name in ("batch_add", "tally_votes", "tally_multi_candidate"):
        assert_ct(getattr(eng, name)(cs), getattr(jeng, name)(js))
    assert_ct(eng.tally_weighted(cs, [1, 2, 3, 4, 5]),
              jeng.tally_weighted(js, [1, 2, 3, 4, 5]))
    assert eng.decrypt(eng.batch_add(cs), s["sk"], 2)[0].tolist() == [2, 3]
    assert_ct(eng.batch_add(cs[:1]), jeng.batch_add(js[:1]))
    with pytest.raises(ValueError):
        eng.batch_add([])
    with pytest.raises(ValueError):
        eng.tally_weighted(cs, [1])


def test_noise_budget_and_decode_match_jax(s):
    rng = np.random.default_rng(9)
    ph = rng.integers(0, Q, (2, N), dtype=np.uint64)
    eng, jeng = s["eng"], s["jeng"]
    np.testing.assert_array_equal(eng.decode(u64_from_np(ph), 7),
                                  jeng.decode(jax_from_np(ph), 7))
    assert eng.noise_budget(u64_from_np(ph)) == \
        jeng.noise_budget(jax_from_np(ph))
    assert eng.initial_noise_budget == jeng.initial_noise_budget
    np.testing.assert_array_equal(u64_to_np(eng.encode([1, 2, 300])),
                                  jax_to_np(jeng.encode([1, 2, 300])))
