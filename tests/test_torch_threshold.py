"""The port's threshold decryption (core/threshold.py) and verifiable
encryption and decryption proofs (core/verifiable.py) against the JAX
package on the CPU.

The JAX package draws with split keys; the test makes the same draws with
its samplers and passes them to the port's ``*_from_draws`` halves.  Shapes:
N=256, q=7681 with zero noise (tests/test_encrypt.py's ring), t=16.
Tolerance: exact equality of every polynomial, challenge and hash."""
import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.core import params as jparams
from node_fhe_accelerate_tpu.core import threshold as jth
from node_fhe_accelerate_tpu.core import verifiable as jver
from node_fhe_accelerate_tpu.core.encrypt import (
    EncryptionEngine as JaxEngine)
from node_fhe_accelerate_tpu.core.keys import KeyManager as JaxKeys
from node_fhe_accelerate_tpu.ops.u64 import u64_to_np as jax_to_np
from node_fhe_accelerate_tpu_torch.convert import (poly_from_numpy,
                                                   public_key_from_numpy,
                                                   threshold_keys_from_numpy)
from node_fhe_accelerate_tpu_torch.core import params
from node_fhe_accelerate_tpu_torch.core import threshold as th
from node_fhe_accelerate_tpu_torch.core import verifiable as ver
from node_fhe_accelerate_tpu_torch.core.encrypt import EncryptionEngine
from node_fhe_accelerate_tpu_torch.core.keys import KeyManager
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_to_np

torch.set_num_threads(2)

KW = dict(poly_degree=256, moduli=[7681], lwe_dimension=64,
          lwe_noise_std=3.2e-11, glwe_dimension=1, decomp_base_log=7,
          decomp_level=2, plaintext_modulus=16)


def np_planes(p):
    return tuple(np.asarray(x) for x in p)


def port(p):
    return poly_from_numpy(np_planes(p), "cpu")


def assert_poly(got, want):
    np.testing.assert_array_equal(u64_to_np(got), jax_to_np(want))


@pytest.fixture(scope="module")
def s():
    """A JAX 3-of-5 key set, a public key of its master secret and a
    ciphertext under it; the port's from the same draws."""
    jp = jparams.ParameterSet(scheme=jparams.FHEScheme.TFHE, **KW)
    p = params.ParameterSet(scheme=params.FHEScheme.TFHE, **KW)
    jeng = JaxEngine(jp, noise_std=0.0)
    eng = EncryptionEngine(p, noise_std=0.0, device="cpu")
    jring, ring = jeng.ring, eng.ring
    key = jax.random.PRNGKey(11)
    jtk = jth.generate_threshold_keys(key, jring, 3, 5)
    # generate_threshold_keys' draws, in its order
    k_sk, k = jax.random.split(key)
    sk_poly = port(jring.sample_ternary(k_sk))
    coeffs = []
    for _ in range(1, 3):
        k_c, k = jax.random.split(k)
        coeffs.append(port(jring.sample_uniform(k_c)))
    tk = th.threshold_keys_from_draws(ring, 3, 5, sk_poly, coeffs)
    jpk = JaxKeys(jp, jring, noise_std=0.0).generate_public_key(
        jax.random.PRNGKey(99), jtk.master_sk)
    pk = public_key_from_numpy(np_planes(jpk.a), np_planes(jpk.b),
                               device="cpu")
    ct_key = jax.random.PRNGKey(12)
    jct = jeng.encrypt(ct_key, [5, 3], jpk)
    k_u, k_e1, k_e2 = jax.random.split(ct_key, 3)
    ct = eng.encrypt_from_draws(
        [5, 3], pk, port(jring.sample_ternary(k_u)),
        port(jring.sample_gaussian(k_e1, 0.0)),
        port(jring.sample_gaussian(k_e2, 0.0)))
    return dict(jeng=jeng, eng=eng, jring=jring, ring=ring, jtk=jtk, tk=tk,
                jpk=jpk, pk=pk, jct=jct, ct=ct)


def test_threshold_keys_match_jax(s):
    tk, jtk = s["tk"], s["jtk"]
    assert (tk.threshold, tk.total_shares) == (jtk.threshold,
                                               jtk.total_shares)
    assert_poly(tk.master_sk.poly, jtk.master_sk.poly)
    for a, b in zip(tk.shares, jtk.shares):
        assert a.share_id == b.share_id
        assert_poly(a.share_poly, b.share_poly)
    # the JAX key set carried over as numpy is the same
    carried = threshold_keys_from_numpy(
        3, 5, [(x.share_id, np_planes(x.share_poly)) for x in jtk.shares],
        np_planes(jtk.master_sk.poly), device="cpu")
    for a, b in zip(carried.shares, tk.shares):
        np.testing.assert_array_equal(u64_to_np(a.share_poly),
                                      u64_to_np(b.share_poly))
    with pytest.raises(ValueError):
        th.threshold_keys_from_draws(s["ring"], 4, 3, tk.master_sk.poly, [])


def test_lagrange_coefficients_match_jax():
    for i, idx, q in ((1, [1, 2, 3], 7681), (4, [2, 4, 5], 7681),
                      (3, [3, 1, 5, 2], params.Primes.Q_40_1)):
        assert th.lagrange_coefficient(i, idx, q) == \
            jth.lagrange_coefficient(i, idx, q)


@pytest.mark.parametrize("chosen", [(0, 1, 2), (4, 2, 0), (1, 3, 4, 0)])
def test_threshold_decryption_matches_jax(s, chosen):
    ring, jring, ct, jct = s["ring"], s["jring"], s["ct"], s["jct"]
    assert_poly(ct.c0, jct.c0)
    parts = [th.partial_decrypt(ring, ct.c1, s["tk"].shares[i])
             for i in chosen]
    jparts = [jth.partial_decrypt(jring, jct.c1, s["jtk"].shares[i])
              for i in chosen]
    for a, b in zip(parts, jparts):
        assert a.share_id == b.share_id
        assert_poly(a.partial, b.partial)
    phase = th.combine_partial_decryptions(ring, ct.c0, parts, 3)
    assert_poly(phase, jth.combine_partial_decryptions(jring, jct.c0,
                                                       jparts, 3))
    np.testing.assert_array_equal(s["eng"].decode(phase, 2), [5, 3])
    np.testing.assert_array_equal(
        u64_to_np(phase), u64_to_np(s["eng"].phase(ct, s["tk"].master_sk)))
    with pytest.raises(ValueError):
        th.combine_partial_decryptions(ring, ct.c0, parts[:2], 3)


def test_generator_threshold_keys_decrypt():
    """The port's own draws: 3-of-5 sharing, a public key of the master
    secret, and each 3-subset decrypting to the message."""
    p = params.ParameterSet(scheme=params.FHEScheme.TFHE, **KW)
    eng = EncryptionEngine(p, noise_std=0.0, device="cpu")
    g = torch.Generator().manual_seed(4)
    tk = th.generate_threshold_keys(g, eng.ring, 3, 5)
    pk = KeyManager(p, eng.ring, noise_std=0.0).generate_public_key(
        g, tk.master_sk)
    ct = eng.encrypt(g, [9, 1, 4], pk)
    for chosen in ((0, 1, 2), (2, 3, 4), (4, 0, 3)):
        parts = [th.partial_decrypt(eng.ring, ct.c1, tk.shares[i])
                 for i in chosen]
        ph = th.combine_partial_decryptions(eng.ring, ct.c0, parts, 3)
        np.testing.assert_array_equal(eng.decode(ph, 3), [9, 1, 4])
    with pytest.raises(ValueError):
        th.generate_threshold_keys(g, eng.ring, 0, 5)


def encryption_proof_draws(jring, key, std):
    k_u, k_e1, k_e2, k_r1, k_r2, k_r3 = jax.random.split(key, 6)
    return [port(x) for x in (
        jring.sample_ternary(k_u), jring.sample_gaussian(k_e1, std),
        jring.sample_gaussian(k_e2, std), jring.sample_uniform(k_r1),
        jring.sample_uniform(k_r2), jring.sample_uniform(k_r3))]


def test_encryption_proof_matches_jax(s):
    jve, ve = jver.VerifiableEncryption(s["jeng"]), \
        ver.VerifiableEncryption(s["eng"])
    key = jax.random.PRNGKey(5)
    jct, jproof = jve.encrypt_with_proof(key, 9, s["jpk"])
    ct, proof = ve.encrypt_with_proof_from_draws(
        9, s["pk"], *encryption_proof_draws(s["jring"], key, 0.0))
    assert_poly(ct.c0, jct.c0)
    assert_poly(ct.c1, jct.c1)
    assert proof.gamma == jproof.gamma
    for f in ("w0", "w1", "z_u", "z_e0", "z_e1"):
        assert_poly(getattr(proof, f), getattr(jproof, f))
    assert ve.verify(ct, proof, s["pk"])
    assert jve.verify(jct, jproof, s["jpk"])
    # a tampered ciphertext, and a tampered response, are refused
    assert not ve.verify(s["eng"].add_plain(ct, 1), proof, s["pk"])
    bad = ver.EncryptionProof(**{**proof.__dict__,
                                 "z_u": s["ring"].add(proof.z_u,
                                                      s["ring"].constant(1))})
    assert not ve.verify(ct, bad, s["pk"])
    rec, jrec = ver.VoterReceipt.create(ct, proof), \
        jver.VoterReceipt.create(jct, jproof)
    assert (rec.ballot_hash, rec.proof_hash) == (jrec.ballot_hash,
                                                 jrec.proof_hash)
    assert rec.matches(ct, proof)
    g = torch.Generator().manual_seed(1)
    ct2, proof2 = ve.encrypt_with_proof(g, 9, s["pk"])
    assert ve.verify(ct2, proof2, s["pk"])
    assert not rec.matches(ct2, proof2)
    assert s["eng"].decrypt(ct2, s["tk"].master_sk)[0][0] == 9


def test_decryption_proof_matches_jax(s):
    ring, jring = s["ring"], s["jring"]
    vd, jvd = ver.VerifiableDecryption(ring), \
        jver.VerifiableDecryption(jring)
    share, jshare = s["tk"].shares[1], s["jtk"].shares[1]
    k_com = jax.random.PRNGKey(13)
    jcom, je = jvd.commit_share(k_com, jshare)
    k_a, k_e = jax.random.split(k_com)
    com, e = vd.commit_share_from_draws(
        share, port(jring.sample_uniform(k_a)),
        port(jring.sample_gaussian(k_e, 3.2)))
    assert_poly(com.b, jcom.b)
    partial = th.partial_decrypt(ring, s["ct"].c1, share)
    jpartial = jth.partial_decrypt(jring, s["jct"].c1, jshare)
    k_prove = jax.random.PRNGKey(14)
    jproof = jvd.prove(k_prove, jshare, je, jcom, s["jct"].c1, jpartial)
    k_rs, k_re = jax.random.split(k_prove)
    proof = vd.prove_from_draws(share, e, com, s["ct"].c1, partial,
                                port(jring.sample_uniform(k_rs)),
                                port(jring.sample_uniform(k_re)))
    assert (proof.share_id, proof.gamma) == (jproof.share_id, jproof.gamma)
    for f in ("w_a", "w_c", "z_s", "z_e"):
        assert_poly(getattr(proof, f), getattr(jproof, f))
    assert vd.verify(com, s["ct"].c1, partial, proof)
    forged = th.PartialDecryption(
        share_id=share.share_id,
        partial=ring.add(partial.partial, s["eng"].encode([1])))
    assert not vd.verify(com, s["ct"].c1, forged, proof)
    g = torch.Generator().manual_seed(2)
    com2, _ = vd.commit_share(g, s["tk"].shares[2])
    com2.share_id = share.share_id
    assert not vd.verify(com2, s["ct"].c1, partial, proof)
    com3, e3 = vd.commit_share(g, share)
    proof3 = vd.prove(g, share, e3, com3, s["ct"].c1, partial)
    assert vd.verify(com3, s["ct"].c1, partial, proof3)
