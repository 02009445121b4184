"""The port's CKKS (core/ckks.py: CkksEncoder, CkksCiphertext, CkksEngine)
against the JAX package on the CPU.

Shapes: N=64 over the 30/30/29-bit chain and scale 2^26 of
tests/test_ckks.py.  The encoder runs in numpy on both sides and is
compared live.  The engine draws as the JAX package does (the same
jax.random calls and split keys, passed to the port's ``*_from_draws``).
The JAX CKKS engine compiles for ~65 s on the CPU (keys ~24 s, the eager
multiply ~11 s, the fused program ~30 s), so the default tier holds the
port's keys, ciphertexts, products and decoded values against SHA-256
digests of the JAX package's outputs on the same draws (committed below),
and the ``slow`` test ``*_live`` computes them now:

    pytest -m slow -k live -n 0 tests/test_torch_ckks.py

Tolerance: exact equality of every residue, level, scale and decoded
float; the decoded values also lie within tests/test_ckks.py's tolerances
of the messages (atol 1e-4 fresh, 1e-3 after one multiply, 5e-3 after
two)."""
import dataclasses
import hashlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.core import ckks as jckks
from node_fhe_accelerate_tpu.core import params as jparams
from node_fhe_accelerate_tpu_torch.convert import (
    ckks_ciphertext_from_numpy, ckks_ciphertext_to_numpy,
    rns_poly_from_numpy, rns_relin_key_from_numpy, rns_relin_key_to_numpy)
from node_fhe_accelerate_tpu_torch.core import ckks, params
from node_fhe_accelerate_tpu_torch.core.keys import SecretKey
from node_fhe_accelerate_tpu_torch.ops.primes import find_ntt_prime

torch.set_num_threads(2)

N = 64
Q1 = find_ntt_prime(30, N)
Q2 = find_ntt_prime(30, N, below=Q1)
Q3 = find_ntt_prime(29, N)
SCALE = 1 << 26
MSG = {"a": [1.5, -2.0, 0.25 + 0.75j], "b": [2.0, 0.5, -1.0],
       "c": [0.5, 4.0, 1.0]}
# SHA-256 of the JAX package's outputs on the draws of fixture s
DIGESTS = {
    "keys":
        "a47928bc5a8581f284e93232a702be92f8b4394b4e1a0c92d9fef76462d8e18a",
    "encrypt":
        "e1b4f0e5a6136b4d2ba87d03a68e7a0c28cb0eab3b44c073a0ee6ea8d250983c",
    "add_sub_plain":
        "fdd9813ec49c356c139d70badaa04dcd0ca78635c726a43a43100d80e9275c15",
    "multiply":
        "05f9b611ceb770dd5d325475727f2da5b9aafa45d93a54d8ccc46d544075959e",
    "relinearize":
        "a3ba394621e9b2d5f308463b005c77be392e6751252ba4f9901dde7ec73071cb",
    "rescale":
        "78a3214029d5f3422a7ca518dadf420fcd2cd7b769fccd21d8ba07f75167622e",
    "depth_2":
        "6de02e1de29226eb8df9b3ec54e244fa7d2910574e7a0d9525eb1488e716e0e5",
    "decrypt":
        "65dbb989b361c7edf09e8ef3413c78e5acdc360679afd8134de7fc2ed80e5fc5",
}


def ckks_kwargs(moduli=None):
    return dict(poly_degree=N, moduli=moduli or [Q1, Q2, Q3],
                lwe_dimension=16, lwe_noise_std=3.2e-11, glwe_dimension=1,
                decomp_base_log=8, decomp_level=4, plaintext_modulus=0)


def np_rns(poly):
    return tuple(tuple(np.asarray(x) for x in r) for r in poly)


def port(poly):
    return rns_poly_from_numpy(np_rns(poly), "cpu")


def u64_bytes(planes) -> bytes:
    lo, hi = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in planes)
    lo, hi = (v.view(np.uint32).astype(np.uint64) for v in (lo, hi))
    return np.ascontiguousarray(lo | (hi << np.uint64(32)),
                                dtype="<u8").tobytes()


def feed(h, obj):
    """Hash residues, ciphertexts, keys, lists and decoded arrays in one
    order on both sides."""
    if obj is None:
        h.update(b"none")
    elif isinstance(obj, (list, tuple)) and len(obj) == 2 and \
            not isinstance(obj[0], (list, tuple)) and \
            hasattr(obj[0], "shape"):
        h.update(u64_bytes(obj))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            feed(h, x)
    elif isinstance(obj, np.ndarray):
        h.update(np.ascontiguousarray(obj, dtype=np.complex128).tobytes())
    elif hasattr(obj, "level"):
        for x in (obj.c0, obj.c1, obj.c2):
            feed(h, x)
        h.update(f"{obj.level} {obj.scale}".encode())
    elif hasattr(obj, "poly"):
        feed(h, obj.poly)
    elif hasattr(obj, "b") and hasattr(obj, "a"):
        feed(h, obj.a)
        feed(h, obj.b)
    else:
        raise TypeError(type(obj))


def digest(*objs) -> str:
    h = hashlib.sha256()
    for o in objs:
        feed(h, o)
    return h.hexdigest()


def jax_ternary(key):
    return np.array(jax.random.randint(key, (N,), 0, 3, dtype=jnp.int32)
                    - 1)


def jax_gaussian(key, std):
    z = jax.random.normal(key, (N,), dtype=jnp.float32)
    return np.array(jnp.round(z * std).astype(jnp.int32))


@pytest.fixture(scope="module")
def s():
    """The JAX engine (its rings compile lazily, at the first product) and
    the port's keys and fresh ciphertexts from the JAX package's draws
    (tests/test_ckks.py's keys: PRNGKey(0) folded with 0, 1, 2)."""
    jp = jparams.ParameterSet(scheme=jparams.FHEScheme.CKKS, **ckks_kwargs())
    p = params.ParameterSet(scheme=params.FHEScheme.CKKS, **ckks_kwargs())
    jeng = jckks.CkksEngine(jp, scale=SCALE)
    eng = ckks.CkksEngine(p, scale=SCALE, device="cpu")
    std = eng._noise_std
    key = jax.random.PRNGKey(0)

    def signed(ring, x):
        return ring.from_signed(torch.from_numpy(x))

    top = eng.ring
    sk = SecretKey(poly=signed(top, jax_ternary(jax.random.fold_in(key, 0))),
                   key_id="rns-sk")
    k_a, k_e = jax.random.split(jax.random.fold_in(key, 1))
    pk = eng.keyset.public_key_from_draws(
        sk, port(jeng.ring.sample_uniform(k_a)),
        signed(top, jax_gaussian(k_e, std)))
    rlks = [None, None]
    for L in range(2, eng.K + 1):
        k_l = jax.random.fold_in(jax.random.fold_in(key, 2), L)
        a_list, e_list = [], []
        for j in range(L):
            k_a, k_e = jax.random.split(jax.random.fold_in(k_l, j))
            a_list.append(port(jeng.rings[L - 1].sample_uniform(k_a)))
            e_list.append(signed(eng.rings[L - 1], jax_gaussian(k_e, std)))
        sk_l = SecretKey(poly=tuple(sk.poly[:L]), key_id=sk.key_id)
        rlks.append(eng.level_keyset(L).relin_key_from_draws(sk_l, a_list,
                                                             e_list))
    cts = {}
    for i, (name, msg) in enumerate(MSG.items()):
        k_u, k_e1, k_e2 = jax.random.split(jax.random.PRNGKey(20 + i), 3)
        cts[name] = eng.encrypt_from_draws(
            msg, pk, signed(top, jax_ternary(k_u)),
            signed(top, jax_gaussian(k_e1, std)),
            signed(top, jax_gaussian(k_e2, std)))
    return dict(jeng=jeng, eng=eng, sk=sk, pk=pk, rlks=rlks, cts=cts)


def jax_side():
    """The JAX package's keys and fresh ciphertexts (the live side)."""
    jeng = jckks.CkksEngine(jparams.ParameterSet(
        scheme=jparams.FHEScheme.CKKS, **ckks_kwargs()), scale=SCALE)
    key = jax.random.PRNGKey(0)
    sk = jeng.generate_secret_key(jax.random.fold_in(key, 0))
    pk = jeng.generate_public_key(jax.random.fold_in(key, 1), sk)
    rlks = jeng.generate_relin_keys(jax.random.fold_in(key, 2), sk)
    cts = {name: jeng.encrypt(jax.random.PRNGKey(20 + i), msg, pk)
           for i, (name, msg) in enumerate(MSG.items())}
    return dict(eng=jeng, sk=sk, pk=pk, rlks=rlks, cts=cts)


def outputs(side):
    """(name, objects) of the digests, through either package's engine."""
    eng, rlks, sk = side["eng"], side["rlks"], side["sk"]
    a, b, c = (side["cts"][k] for k in "abc")
    mult = eng.multiply(a, b)
    rel = eng.relinearize(mult, rlks)
    res = eng.rescale(rel)
    d2 = eng.multiply_relin_rescale(res, c, rlks, fused=False)
    dec = [eng.decrypt(x, sk, 3) for x in (a, res, d2)]
    return [("keys", (sk, side["pk"], rlks[2:])),
            ("encrypt", (a, b, c)),
            ("add_sub_plain", (eng.add(a, b), eng.sub(a, c),
                               eng.add_plain(a, [0.5, 1.0]),
                               eng.mod_down(b, 2))),
            ("multiply", mult), ("relinearize", rel), ("rescale", res),
            ("depth_2", d2), ("decrypt", dec)]


# ---------------------------------------------------------------------------
# the encoder (numpy on both sides)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_encoder_matches_jax(n):
    rng = np.random.default_rng(n)
    z = rng.normal(size=n // 2) + 1j * rng.normal(size=n // 2)
    enc, jenc = ckks.CkksEncoder(n), jckks.CkksEncoder(n)
    coeffs = enc.encode(z, SCALE)
    np.testing.assert_array_equal(coeffs, jenc.encode(z, SCALE))
    for scale in (Fraction(SCALE), Fraction(SCALE) ** 2 / Q3):
        got = enc.decode(coeffs, scale, 7)
        np.testing.assert_array_equal(got, jenc.decode(coeffs, scale, 7))
    np.testing.assert_allclose(enc.decode(coeffs, Fraction(SCALE)), z,
                               atol=1e-5)
    with pytest.raises(ValueError, match="slots"):
        enc.encode(np.ones(n), SCALE)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_shape_matches_jax(s):
    eng, jeng = s["eng"], s["jeng"]
    assert (eng.K, eng.scale, eng._noise_std) == \
        (jeng.K, jeng.scale, jeng._noise_std)
    assert [r.moduli for r in eng.rings] == [r.moduli for r in jeng.rings]
    # CKKS_128_ML's default scale: 2^(bits(q_2) - 1), q_2 = Q_50_3
    full = ckks.CkksEngine(params.CKKS_128_ML(), device="cpu")
    assert full.scale == 1 << (jparams.CKKS_128_ML().moduli[1].bit_length()
                               - 1) == 1 << 49
    assert [r.moduli for r in full.rings] == \
        [jparams.CKKS_128_ML().moduli[:L] for L in range(1, 6)]
    assert full.rings[2].rings[1] is full.rings[4].rings[1]


def test_port_matches_jax_digests(s):
    out = outputs(dict(eng=s["eng"], sk=s["sk"], pk=s["pk"],
                       rlks=s["rlks"], cts=s["cts"]))
    for name, objs in out:
        assert digest(objs) == DIGESTS[name], name
    got = dict(out)
    a_dec, res_dec, d2_dec = got["decrypt"]
    np.testing.assert_allclose(a_dec, MSG["a"], atol=1e-4)
    np.testing.assert_allclose(
        res_dec, np.multiply(MSG["a"], MSG["b"]), atol=1e-3)
    np.testing.assert_allclose(
        d2_dec, np.multiply(np.multiply(MSG["a"], MSG["b"]), MSG["c"]),
        atol=5e-3)
    res = got["rescale"]
    assert res.level == 2 and res.scale == Fraction(SCALE) ** 2 / Q3


@pytest.mark.slow
def test_port_matches_jax_live(s):
    port_out = outputs(dict(eng=s["eng"], sk=s["sk"], pk=s["pk"],
                            rlks=s["rlks"], cts=s["cts"]))
    jax_out = outputs(jax_side())
    for (name, got), (_, want) in zip(port_out, jax_out):
        assert digest(want) == DIGESTS[name], name
        assert digest(got) == digest(want), name


def test_fused_equals_eager(s):
    """The fused multiply_relin_rescale is bit-identical to multiply ->
    relinearize -> rescale, at every level and with operands at two
    levels (aligned by mod_down)."""
    eng, rlks, (a, b, c) = s["eng"], s["rlks"], (s["cts"][k] for k in "abc")
    ab = eng.multiply_relin_rescale(a, b, rlks, fused=False)
    for x, y in ((a, b), (a, a), (ab, c), (c, ab)):
        eager = eng.multiply_relin_rescale(x, y, rlks, fused=False)
        fused = eng.multiply_relin_rescale(x, y, rlks, fused=True)
        assert digest(fused) == digest(eager)
        assert (fused.level, fused.scale) == (eager.level, eager.scale)
    assert digest(eng.multiply_relin_rescale(a, b, rlks)) == digest(ab)


def test_guards(s):
    eng, rlks, (a, b, c) = s["eng"], s["rlks"], (s["cts"][k] for k in "abc")
    ab = eng.multiply_relin_rescale(a, b, rlks)
    low = eng.mod_down(c, ab.level)
    np.testing.assert_allclose(eng.decrypt(low, s["sk"], 3), MSG["c"],
                               atol=1e-4)
    with pytest.raises(ValueError, match="scale"):
        eng.add(ab, low)
    with pytest.raises(ValueError, match="rescale"):
        eng.rescale(eng.rescale(ab))
    with pytest.raises(ValueError, match="fresh"):
        eng.add_plain(ab, [1.0])
    with pytest.raises(ValueError, match="relinearize"):
        eng.multiply_relin_rescale(eng.multiply(a, b), c, rlks, fused=True)
    with pytest.raises(ValueError, match="higher"):
        eng.mod_down(ab, 3)
    assert eng.relinearize(a, rlks) is a


def test_relin_key_ntt_cache_is_keyed_by_the_chain(s):
    """One relin key under two engines whose chains differ: each gets the
    product a fresh copy of the key gives it (the JAX package caches one
    NTT form on the key object, whatever the chain)."""
    eng, rlks = s["eng"], s["rlks"]
    other = [find_ntt_prime(31, N)]
    for _ in range(2):
        other.append(find_ntt_prime(31, N, below=other[-1]))
    eng_b = ckks.CkksEngine(params.ParameterSet(
        scheme=params.FHEScheme.CKKS, **ckks_kwargs(other)), scale=SCALE,
        device="cpu")
    g = torch.Generator().manual_seed(3)
    pk_b = eng_b.generate_public_key(g, eng_b.generate_secret_key(g))
    x, y = (eng_b.encrypt(g, MSG[k], pk_b) for k in "ab")
    a, b = s["cts"]["a"], s["cts"]["b"]
    first = eng.multiply_relin_rescale(a, b, rlks, fused=True)
    got_b = eng_b.multiply_relin_rescale(x, y, rlks, fused=True)
    fresh = [k if k is None else dataclasses.replace(k) for k in rlks]
    assert not fresh[3].ntt_forms
    want_b = eng_b.multiply_relin_rescale(x, y, fresh, fused=True)
    assert digest(got_b) == digest(want_b)
    assert digest(got_b) == digest(eng_b.multiply_relin_rescale(
        x, y, rlks, fused=False))
    again = eng.multiply_relin_rescale(a, b, rlks, fused=True)
    assert digest(again) == digest(first)
    assert len(rlks[3].ntt_forms) == 2


def test_ckks_state_round_trips_through_numpy(s):
    ct = s["eng"].rescale(s["eng"].relinearize(s["eng"].multiply(
        s["cts"]["a"], s["cts"]["b"]), s["rlks"]))
    back = ckks_ciphertext_from_numpy(*ckks_ciphertext_to_numpy(ct),
                                      key_id=ct.key_id, device="cpu")
    assert digest(back) == digest(ct) and back.scale == ct.scale
    assert isinstance(back.scale, Fraction)
    rlk = s["rlks"][3]
    back_k = rns_relin_key_from_numpy(*rns_relin_key_to_numpy(rlk),
                                      device="cpu")
    assert digest(back_k) == digest(rlk) and back_k.key_id == rlk.key_id
