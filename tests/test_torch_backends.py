"""The port's bootstrap through every int8 backend name, and its PBS
comparisons, vs the JAX engine on one shared key.

The key is made once per module with the port's keygen (seeded
torch.Generator) and carried to JAX as numpy arrays; JAX runs its Pallas
backends in interpret mode, as tests/test_pallas_cmux.py does on the CPU.
On the CPU the port's backends take their plain versions.  Shapes of
tests/test_pallas_cmux.py (n_lwe=8, N=256, k=1, lvl=3, zero noise, batch 8)
with plaintext modulus 8, so the comparisons have a domain [0, 4) to work
in.  Tolerance: exact equality -- every value is an integer mod 2^32 -- and
decryption must return the expected messages."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from node_fhe_accelerate_tpu.core.bootstrap import (
    BootstrapKey as JaxKey, LweCiphertext as JaxLwe, TfheEngine as JaxEngine,
    TfheParams as JaxParams)
from node_fhe_accelerate_tpu_torch.convert import (
    bsk_from_numpy, bsk_to_numpy, lwe_to_numpy)
from node_fhe_accelerate_tpu_torch.core.bootstrap import TfheEngine, TfheParams
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32
from node_fhe_accelerate_tpu_torch.ops.cmux import build_all_step_slabs

torch.set_num_threads(2)


def params_256(**kw):
    d = dict(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
             pbs_level=3, ks_base_log=4, ks_level=8, lwe_noise_std=0.0,
             glwe_noise_std=0.0, plaintext_modulus=8)
    d.update(kw)
    return TfheParams(**d)


def jax_params(p):
    return JaxParams(**dataclasses.asdict(p))


def make_setup(p, seed):
    """Port keys from a seeded generator, the same key as a JAX key, and a
    batch of 8 encrypted messages in [0, 4)."""
    eng = TfheEngine(p, ext_backend="mxu", device="cpu")
    gen = torch.Generator().manual_seed(seed)
    lwe_sk = eng.lwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, lwe_sk, eng.glwe_keygen(gen))
    g, ka, kb = bsk_to_numpy(bsk)
    jbsk = JaxKey(ggsw_i8=jnp.asarray(g), ksk_a=jnp.asarray(ka),
                  ksk_b=jnp.asarray(kb), params=jax_params(p))
    msgs = np.arange(8) % 4
    ct = eng.lwe_encrypt(gen, torch.from_numpy(msgs), lwe_sk)
    return dict(p=p, eng=eng, gen=gen, lwe_sk=lwe_sk, bsk=bsk, jbsk=jbsk,
                jsk=jnp.asarray(tensor_to_u32(lwe_sk)), msgs=msgs, ct=ct,
                jeng=JaxEngine(jax_params(p), ext_backend="mxu"))


@pytest.fixture(scope="module")
def setup():
    s = make_setup(params_256(), 21)
    s["want"] = s["jeng"].bootstrap_jit(to_jax(s["ct"]), s["jbsk"],
                                        s["jeng"].default_test_poly())
    return s


def to_jax(ct):
    a, b = lwe_to_numpy(ct)
    return JaxLwe(a=jnp.asarray(a), b=jnp.asarray(b))


def assert_same(port_ct, jax_ct):
    a, b = lwe_to_numpy(port_ct)
    np.testing.assert_array_equal(a, np.asarray(jax_ct.a))
    np.testing.assert_array_equal(b, np.asarray(jax_ct.b))


@pytest.mark.parametrize("backend", ["mxu_fused", "pallas_fused", "pallas"])
def test_backend_bootstrap_matches_jax_backend(setup, backend):
    """The port's backend vs the JAX backend of the same name (interpret
    mode), each on the key its own ``prepare_bsk`` returns, and vs the JAX
    "mxu" backend; decode in both packages."""
    s = setup
    eng = TfheEngine(s["p"], ext_backend=backend, device="cpu")
    key = eng.prepare_bsk(s["bsk"])
    assert eng.prepare_bsk(key) is key
    got = eng.bootstrap_with_test_poly(s["ct"], key, eng.default_test_poly())
    jeng = JaxEngine(jax_params(s["p"]), ext_backend=backend)
    want = jeng.bootstrap_jit(to_jax(s["ct"]), jeng.prepare_bsk(s["jbsk"]),
                              jeng.default_test_poly())
    assert_same(got, want)
    assert_same(got, s["want"])
    np.testing.assert_array_equal(
        eng.lwe_decrypt(got, s["lwe_sk"]).numpy(), s["msgs"])
    np.testing.assert_array_equal(
        np.asarray(jeng.lwe_decrypt(want, s["jsk"])), s["msgs"])


def test_kernel_is_a_synonym_of_pallas(setup):
    s = setup
    eng = TfheEngine(s["p"], ext_backend="kernel", device="cpu")
    assert eng.backend == "pallas"
    assert_same(eng.bootstrap(s["ct"], s["bsk"]), s["want"])


def test_mxu_fused_truncated_key_matches_jax():
    """bsk_drop_planes=1 through "mxu_fused": the plane weights 256^(p+1)
    restored exactly as the JAX backend restores them."""
    s = make_setup(params_256(bsk_drop_planes=1), 22)
    assert s["bsk"].ggsw_i8.shape[-2] == 3
    eng = TfheEngine(s["p"], ext_backend="mxu_fused", device="cpu")
    got = eng.bootstrap(s["ct"], eng.prepare_bsk(s["bsk"]))
    jeng = JaxEngine(jax_params(s["p"]), ext_backend="mxu_fused")
    want = jeng.bootstrap_jit(to_jax(s["ct"]), jeng.prepare_bsk(s["jbsk"]),
                              jeng.default_test_poly())
    assert_same(got, want)
    mxu = s["eng"].bootstrap(s["ct"], s["bsk"])
    assert torch.equal(got.a, mxu.a) and torch.equal(got.b, mxu.b)
    full = dataclasses.replace(s["p"], bsk_drop_planes=0)
    with pytest.raises(ValueError):
        TfheEngine(full, ext_backend="mxu_fused", device="cpu") \
            .bootstrap(s["ct"], eng.prepare_bsk(s["bsk"]))


@pytest.mark.parametrize("form", ["slabs", "tiles"])
def test_prepared_jax_key_converts_field_by_field(setup, form):
    """A JAX key prepared by the JAX engine carries its tiles / slabs across;
    the tiles equal what the port prepares, the slabs equal the port's
    reference-layout builder, the port prepares its K-major form on such a
    key as on its own, and "mxu_fused" runs on both keys."""
    s = setup
    jkey = JaxEngine(jax_params(s["p"]), ext_backend="mxu_fused") \
        .prepare_bsk(s["jbsk"], form=form)
    key = bsk_from_numpy(
        np.asarray(jkey.ggsw_i8), np.asarray(jkey.ksk_a),
        np.asarray(jkey.ksk_b), s["p"], device="cpu",
        ggsw_tiles=None if jkey.ggsw_tiles is None
        else np.asarray(jkey.ggsw_tiles),
        ggsw_slabs=None if jkey.ggsw_slabs is None
        else np.asarray(jkey.ggsw_slabs))
    eng = TfheEngine(s["p"], ext_backend="mxu_fused", device="cpu")
    mine = eng.prepare_bsk(s["bsk"], form=form)
    if form == "tiles":
        assert torch.equal(key.ggsw_tiles, mine.ggsw_tiles)
        assert eng.prepare_bsk(key, form=form) is key
        return
    assert torch.equal(key.ggsw_slabs, build_all_step_slabs(s["bsk"].ggsw_i8))
    prepared = eng.prepare_bsk(key, form=form)
    assert torch.equal(prepared.ggsw_kslabs, mine.ggsw_kslabs)
    assert eng.prepare_bsk(prepared, form=form) is prepared
    assert_same(eng.bootstrap(s["ct"], key), s["want"])
    assert_same(eng.bootstrap(s["ct"], prepared), s["want"])


def test_unported_backends_say_which_slice_brings_them(setup):
    # every backend is ported: "auto" came with the dispatcher and, on the
    # CPU, resolves to "mxu" without a race, as in the JAX package
    assert TfheEngine(setup["p"], ext_backend="auto",
                      device="cpu").backend == "mxu"
    for backend in ("ntt", "crt"):              # ported with the NTT core
        assert TfheEngine(setup["p"], ext_backend=backend,
                          device="cpu").backend == backend
    with pytest.raises(ValueError):
        TfheEngine(setup["p"], ext_backend="v3", device="cpu")
    with pytest.raises(ValueError):
        TfheEngine(params_256(poly_degree=64), ext_backend="mxu_fused",
                   device="cpu")
    with pytest.raises(ValueError):
        TfheEngine(setup["p"], ext_backend="pallas",
                   device="cpu").prepare_bsk(setup["bsk"], form="rows")


COMPARISONS = {
    "lwe_is_zero": ((), lambda m: m == 0),
    "lwe_gt_threshold": ((2,), lambda m: m >= 2),
    "lwe_lt_threshold": ((3,), lambda m: m < 3),
    "lwe_in_range": ((1, 2), lambda m: (1 <= m) & (m <= 2)),
}


@pytest.mark.parametrize("name", sorted(COMPARISONS))
def test_comparison_matches_jax(setup, name):
    """One PBS comparison through the port's "mxu_fused" backend vs the JAX
    engine's entry of the same name on the same ciphertexts."""
    s = setup
    args, truth = COMPARISONS[name]
    eng = TfheEngine(s["p"], ext_backend="mxu_fused", device="cpu")
    got = getattr(eng, name)(s["ct"], *args, s["bsk"])
    want = getattr(s["jeng"], name)(to_jax(s["ct"]), *args, s["jbsk"])
    assert_same(got, want)
    np.testing.assert_array_equal(
        eng.lwe_decrypt(got, s["lwe_sk"]).numpy(), truth(s["msgs"]))


def test_lwe_eq_and_detect_duplicate_match_jax(setup):
    s = setup
    eng = TfheEngine(s["p"], ext_backend="mxu_fused", device="cpu")
    key = eng.prepare_bsk(s["bsk"])
    # at most one duplicate per ballot: the bit-sum stays inside [0, t/2)
    others = [np.array([0, 0, 3, 2, 1, 2, 3, 0]),
              np.array([1, 2, 3, 0, 3, 0, 1, 2]),
              np.array([2, 3, 0, 1, 2, 1, 0, 1])]
    cts = [eng.lwe_encrypt(s["gen"], torch.from_numpy(m), s["lwe_sk"])
           for m in others]
    got = eng.lwe_eq(s["ct"], cts[0], key)
    assert_same(got, s["jeng"].lwe_eq(to_jax(s["ct"]), to_jax(cts[0]),
                                      s["jbsk"]))
    np.testing.assert_array_equal(
        eng.lwe_decrypt(got, s["lwe_sk"]).numpy(), s["msgs"] == others[0])

    dup = eng.detect_duplicate(s["ct"], cts, key)
    assert_same(dup, s["jeng"].detect_duplicate(
        to_jax(s["ct"]), [to_jax(c) for c in cts], s["jbsk"]))
    np.testing.assert_array_equal(
        eng.lwe_decrypt(dup, s["lwe_sk"]).numpy(),
        np.any([s["msgs"] == m for m in others], axis=0))
    none = eng.detect_duplicate(s["ct"], [], key)
    assert not none.a.any() and not none.b.any()
