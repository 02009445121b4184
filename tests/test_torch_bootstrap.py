"""The port's programmable bootstrap vs the JAX package on one shared key.

The key is made once per module with the port's keygen (seeded
torch.Generator) and carried to JAX as numpy arrays (convert.py); JAX
keygen is too slow for the default tier.  JAX runs its "pallas" backend in
interpret mode and its "mxu" backend; the port runs its per-step backend
("pallas", plain version on the CPU) and "mxu"; the fused backends are in
tests/test_torch_backends.py.  Tolerance: exact equality -- every value
is an integer mod 2^32 -- and decryption must return the messages."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from node_fhe_accelerate_tpu.core.bootstrap import (
    BootstrapKey as JaxKey, LweCiphertext as JaxLwe, TfheEngine as JaxEngine,
    TfheParams as JaxParams)
from node_fhe_accelerate_tpu_torch.convert import (
    bsk_to_numpy, lwe_from_numpy, lwe_to_numpy)
from node_fhe_accelerate_tpu_torch.core.bootstrap import (
    TFHE_BOOT_128_K4, TFHE_BOOT_128_K4T, TfheEngine, TfheParams)
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32, u32_to_tensor

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K4_BLOB = os.path.join(ROOT, ".keycache",
                       "7f5658596c1857e89c056b7e0b17cabf.fheb")


def params_256(**kw):
    d = dict(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
             pbs_level=3, ks_base_log=4, ks_level=8, lwe_noise_std=0.0,
             glwe_noise_std=0.0, plaintext_modulus=4)
    d.update(kw)
    return TfheParams(**d)


def jax_key(bsk, p):
    g, ka, kb = bsk_to_numpy(bsk)
    return JaxKey(ggsw_i8=jnp.asarray(g), ksk_a=jnp.asarray(ka),
                  ksk_b=jnp.asarray(kb),
                  params=JaxParams(**dataclasses.asdict(p)))


def make_setup(p, seed):
    eng = TfheEngine(p, ext_backend="pallas", device="cpu")
    gen = torch.Generator().manual_seed(seed)
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
    return dict(p=p, eng=eng, gen=gen, lwe_sk=lwe_sk, glwe_sk=glwe_sk,
                bsk=bsk, jbsk=jax_key(bsk, p),
                jsk=jnp.asarray(tensor_to_u32(lwe_sk)),
                jeng=JaxEngine(JaxParams(**dataclasses.asdict(p)),
                               ext_backend="mxu"))


@pytest.fixture(scope="module")
def setup():
    return make_setup(params_256(), 11)


def to_jax(ct):
    a, b = lwe_to_numpy(ct)
    return JaxLwe(a=jnp.asarray(a), b=jnp.asarray(b))


def assert_same(port_ct, jax_ct):
    a, b = lwe_to_numpy(port_ct)
    np.testing.assert_array_equal(a, np.asarray(jax_ct.a))
    np.testing.assert_array_equal(b, np.asarray(jax_ct.b))


def random_acc(p, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (batch, p.glwe_dim + 1, p.poly_degree),
                        dtype=np.uint64).astype(np.uint32)


def test_sample_extract_matches_jax(setup):
    s = setup
    acc = random_acc(s["p"], 5, 0)
    want = s["jeng"].sample_extract(jnp.asarray(acc))
    assert_same(s["eng"].sample_extract(u32_to_tensor(acc, "cpu")), want)


def test_sample_extract_at_matches_jax(setup):
    s = setup
    acc = random_acc(s["p"], 3, 1).reshape(3, 1, 2, -1)
    pos = np.array([0, 1, 7, 255])
    want = s["jeng"].sample_extract_at(jnp.asarray(acc), pos)
    assert_same(s["eng"].sample_extract_at(u32_to_tensor(acc, "cpu"), pos),
                want)


def test_key_switch_matches_jax(setup):
    s = setup
    rng = np.random.default_rng(2)
    kn = s["p"].glwe_dim * s["p"].poly_degree
    a = rng.integers(0, 1 << 32, (2, 3, kn), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (2, 3), dtype=np.uint64).astype(np.uint32)
    want = s["jeng"].key_switch(JaxLwe(a=jnp.asarray(a), b=jnp.asarray(b)),
                                s["jbsk"])
    got = s["eng"].key_switch(lwe_from_numpy(a, b, "cpu"), s["bsk"])
    assert_same(got, want)


def test_bootstrap_matches_jax_pallas_and_mxu(setup):
    """The slice as a whole: the port's kernel and mxu backends and the JAX
    pallas (interpret) and mxu backends give bit-equal LWE outputs on one
    key, and all decode to the messages in both packages."""
    s = setup
    msgs = np.arange(8) % 2
    ct = s["eng"].lwe_encrypt(s["gen"], torch.from_numpy(msgs), s["lwe_sk"])
    tp = s["eng"].default_test_poly()
    jtp = s["jeng"].default_test_poly()
    np.testing.assert_array_equal(tensor_to_u32(tp), np.asarray(jtp))

    got = s["eng"].bootstrap_with_test_poly(ct, s["bsk"], tp)
    got_mxu = TfheEngine(s["p"], ext_backend="mxu", device="cpu") \
        .bootstrap_with_test_poly(ct, s["bsk"], tp)
    jeng_p = JaxEngine(JaxParams(**dataclasses.asdict(s["p"])),
                       ext_backend="pallas")
    want = jeng_p.bootstrap_jit(to_jax(ct), s["jbsk"], jtp)
    want_mxu = s["jeng"].bootstrap_jit(to_jax(ct), s["jbsk"], jtp)
    assert_same(got, want)
    assert_same(got_mxu, want_mxu)
    assert_same(got, want_mxu)
    np.testing.assert_array_equal(
        s["eng"].lwe_decrypt(got, s["lwe_sk"]).numpy(), msgs)
    np.testing.assert_array_equal(
        np.asarray(s["jeng"].lwe_decrypt(want, s["jsk"])), msgs)


def test_bootstrap_many_lut_matches_jax(setup):
    s = setup
    funcs = [lambda v: v, lambda v: 1 - v]
    msgs = np.array([0, 1, 1, 0])
    ct = s["eng"].lwe_encrypt(s["gen"], torch.from_numpy(msgs), s["lwe_sk"])
    np.testing.assert_array_equal(
        tensor_to_u32(s["eng"].make_many_lut(funcs)),
        np.asarray(s["jeng"].make_many_lut(funcs)))
    got = s["eng"].bootstrap_many_lut(ct, s["bsk"], funcs)
    want = s["jeng"].bootstrap_many_lut(to_jax(ct), s["jbsk"], funcs)
    assert_same(got, want)
    dec = s["eng"].lwe_decrypt(got, s["lwe_sk"]).numpy()
    np.testing.assert_array_equal(dec, np.stack([msgs, 1 - msgs]))


def test_port_keys_roundtrip_in_both_packages(setup):
    """Port keygen + encrypt -> bootstrap -> decrypt returns the messages;
    JAX's lwe_decrypt reads the port's ciphertexts, and a JAX-encrypted
    ciphertext bootstraps in the port."""
    s = setup
    msgs = np.array([1, 0, 1, 1, 0, 0])
    ct = s["eng"].lwe_encrypt(s["gen"], torch.from_numpy(msgs), s["lwe_sk"],
                              noise_std=2.0 ** 12)
    np.testing.assert_array_equal(
        np.asarray(s["jeng"].lwe_decrypt(to_jax(ct), s["jsk"])), msgs)
    out = s["eng"].bootstrap(ct, s["bsk"])
    np.testing.assert_array_equal(
        s["eng"].lwe_decrypt(out, s["lwe_sk"]).numpy(), msgs)
    np.testing.assert_array_equal(
        np.asarray(s["jeng"].lwe_decrypt(to_jax(out), s["jsk"])), msgs)

    jct = s["jeng"].lwe_encrypt(jax.random.PRNGKey(5), jnp.asarray(msgs),
                                s["jsk"])
    out2 = s["eng"].bootstrap(
        lwe_from_numpy(np.asarray(jct.a), np.asarray(jct.b), "cpu"), s["bsk"])
    np.testing.assert_array_equal(
        s["eng"].lwe_decrypt(out2, s["lwe_sk"]).numpy(), msgs)


def test_glwe_encrypt_zero_has_zero_phase(setup):
    s = setup
    ct = s["eng"].glwe_encrypt_zero(s["gen"], s["glwe_sk"], batch=(3,))
    assert ct.data.shape == (3, 2, 256)
    assert not s["eng"].glwe_phase(ct, s["glwe_sk"]).any()


def test_k4_geometry_bootstrap_matches_jax():
    """K4 geometry (k=4, N=256, Bg=2^8, l=2) with n_lwe=4."""
    p = dataclasses.replace(TFHE_BOOT_128_K4(), n_lwe=4, lwe_noise_std=0.0,
                            glwe_noise_std=0.0)
    s = make_setup(p, 12)
    msgs = np.array([0, 1, 1, 0])
    ct = s["eng"].lwe_encrypt(s["gen"], torch.from_numpy(msgs), s["lwe_sk"])
    got = s["eng"].bootstrap(ct, s["bsk"])
    want = s["jeng"].bootstrap_jit(to_jax(ct), s["jbsk"],
                                   s["jeng"].default_test_poly())
    assert_same(got, want)
    np.testing.assert_array_equal(
        s["eng"].lwe_decrypt(got, s["lwe_sk"]).numpy(), msgs)


def test_engine_device_and_backend_rules():
    p = params_256()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TfheEngine(p)
    with pytest.raises(ValueError):
        TfheEngine(p, ext_backend="v1", device="cpu")
    for name, backend in (("pallas", "pallas"), ("kernel", "pallas"),
                          ("pallas_fused", "pallas_fused"),
                          ("mxu_fused", "mxu_fused"), ("mxu", "mxu")):
        assert TfheEngine(p, ext_backend=name,
                          device="cpu").backend == backend
    for name in ("pallas", "pallas_fused"):
        with pytest.raises(ValueError):
            TfheEngine(TFHE_BOOT_128_K4T(), ext_backend=name, device="cpu")
    # the default, "auto", pins a truncated key to "mxu"
    for name in (None, "mxu", "mxu_fused"):
        kw = {} if name is None else {"ext_backend": name}
        assert TfheEngine(TFHE_BOOT_128_K4T(), device="cpu",
                          **kw).backend == (name or "mxu")


@pytest.mark.slow
def test_k4_committed_blob_matches_jax():
    """Full-shape parity on the committed K4 key (630 steps, N=256, k=4):
    the port's kernel backend (plain on the CPU) vs the JAX mxu backend,
    with JAX's secret key derived the way its key cache derives it."""
    from node_fhe_accelerate_tpu.core.keycache import (
        deserialize_bootstrap_key as jax_deserialize)
    from node_fhe_accelerate_tpu_torch.core.keycache import (
        deserialize_bootstrap_key)
    with open(K4_BLOB, "rb") as f:
        raw = f.read()
    p = TFHE_BOOT_128_K4()
    bsk = deserialize_bootstrap_key(raw, p, device="cpu")
    jbsk = jax_deserialize(raw)
    jeng = JaxEngine(JaxParams(**dataclasses.asdict(p)), ext_backend="mxu")
    root = jax.random.PRNGKey(0)
    jsk = jeng.lwe_keygen(jax.random.fold_in(root, 0))
    msgs = jnp.arange(4, dtype=jnp.uint32) % 2
    jct = jeng.lwe_encrypt(jax.random.PRNGKey(100), msgs, jsk)
    want = jeng.bootstrap_jit(jct, jbsk, jeng.default_test_poly())
    eng = TfheEngine(p, ext_backend="pallas", device="cpu")
    got = eng.bootstrap(lwe_from_numpy(np.asarray(jct.a), np.asarray(jct.b),
                                       "cpu"), bsk)
    assert_same(got, want)
    np.testing.assert_array_equal(np.asarray(jeng.lwe_decrypt(want, jsk)),
                                  np.asarray(msgs))
