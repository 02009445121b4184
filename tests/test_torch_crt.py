"""PyTorch port vs the JAX package: the torus ring's CRT and P_EXT products,
the external products of the "ntt" and "crt" backends, and a whole "ntt"
bootstrap.

Inputs come from numpy with fixed seeds and go through both packages; the
JAX side runs eagerly where the shapes repeat (XLA's per-operation
executables are then reused) and under ``jax.jit`` for the ring product.
The "ntt" bootstrap runs on a key whose NTT form the JAX package computes,
carried to the port with convert.py, and on ciphertexts made with numpy.
Tolerance: exact equality -- every value is an integer mod 2^32 or mod a
prime -- and decryption must return the messages."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from node_fhe_accelerate_tpu.core.bootstrap import (
    BootstrapKey as JaxKey, LweCiphertext as JaxLwe, TfheEngine as JaxEngine,
    TfheParams as JaxParams)
from node_fhe_accelerate_tpu.core.torus import TorusRing as JaxRing
from node_fhe_accelerate_tpu.ops.u64 import u64_to_np as jax_to_np
from node_fhe_accelerate_tpu_torch.convert import (
    bsk_from_numpy, bsk_to_numpy, lwe_from_numpy, lwe_to_numpy)
from node_fhe_accelerate_tpu_torch.core.bootstrap import (TfheEngine,
                                                          TfheParams)
from node_fhe_accelerate_tpu_torch.core.torus import TorusRing
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32, u32_to_tensor
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_to_np

torch.set_num_threads(2)

N = 64
EXT_N = 16          # the external-product fixture: fewer NTT stages to trace


def tiny_params(**kw):
    """The JAX package's tiny bootstrap shape (tests/test_bootstrap.py)."""
    d = dict(n_lwe=8, poly_degree=N, glwe_dim=1, pbs_base_log=7,
             pbs_level=3, ks_base_log=4, ks_level=8, lwe_noise_std=0.0,
             glwe_noise_std=0.0, plaintext_modulus=4)
    d.update(kw)
    return TfheParams(**d)


def u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def t(x):
    return u32_to_tensor(x, "cpu")


def planes_np(p):
    """Limb planes of either package -> numpy uint64."""
    if isinstance(p[0], torch.Tensor):
        return u64_to_np(p)
    return jax_to_np(p)


# ---------------------------------------------------------------------------
# TorusRing.multiply: the exact CRT product on a random torus b
# ---------------------------------------------------------------------------

def test_multiply_matches_jax_on_random_torus():
    """Both operands random torus polynomials at N=256: every coefficient
    of the centered product matters (a float64 product that assumed a small
    b differed in all 1024 elements here)."""
    n = 256
    rng = np.random.default_rng(9)
    a, b = u32(rng, (4, n)), u32(rng, (n,))
    want = np.asarray(jax.jit(JaxRing(n).multiply)(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = tensor_to_u32(TorusRing(n).multiply(t(a), t(b)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The external products and the ring functions they are made of
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ext():
    """One key row in both NTT forms and a GLWE batch; the JAX external
    products first, so the ring functions below reuse their shapes."""
    rng = np.random.default_rng(5)
    p = tiny_params(poly_degree=EXT_N)
    jeng_n = JaxEngine(JaxParams(**dataclasses.asdict(p)), ext_backend="ntt")
    jeng_c = JaxEngine(JaxParams(**dataclasses.asdict(p)), ext_backend="crt")
    jr = jeng_n.ring
    g = u32(rng, (2, 3, 2, EXT_N))        # one row: (k+1, lvl, k+1, N)
    glwe = u32(rng, (3, 2, EXT_N))        # (batch, k+1, N)
    g_ext = jr.forward_ext_mont(jnp.asarray(g))
    g_crt = jr.forward(jnp.asarray(g))
    want_n = np.asarray(jeng_n.external_product(g_ext, jnp.asarray(glwe)))
    want_c = np.asarray(jeng_c.external_product_crt(g_crt,
                                                    jnp.asarray(glwe)))
    return dict(p=p, jr=jr, g=g, glwe=glwe, g_ext=g_ext, g_crt=g_crt,
                want_n=want_n, want_c=want_c, ring=TorusRing(EXT_N),
                digits=np.array(jr.decompose(jnp.asarray(glwe), 7, 3)))


def port_row(x):
    """A JAX NTT row (nested (lo, hi) uint32 arrays) -> int32 tensors."""
    if isinstance(x, tuple):
        return tuple(port_row(v) for v in x)
    return t(np.asarray(x))


def test_external_product_matches_jax(ext):
    eng = TfheEngine(ext["p"], ext_backend="ntt", device="cpu")
    got = eng.external_product(port_row(ext["g_ext"]), t(ext["glwe"]))
    np.testing.assert_array_equal(tensor_to_u32(got), ext["want_n"])


def test_external_product_crt_matches_jax(ext):
    eng = TfheEngine(ext["p"], ext_backend="crt", device="cpu")
    got = eng.external_product_crt(port_row(ext["g_crt"]), t(ext["glwe"]))
    np.testing.assert_array_equal(tensor_to_u32(got), ext["want_c"])


def test_forward_and_forward_ext_mont_match_jax(ext):
    ring = ext["ring"]
    got = ring.forward(t(ext["g"]))
    for i in range(2):
        np.testing.assert_array_equal(planes_np(got[i]),
                                      planes_np(ext["g_crt"][i]))
    np.testing.assert_array_equal(planes_np(ring.forward_ext_mont(
        t(ext["g"]))), planes_np(ext["g_ext"]))


def test_digit_transforms_and_accumulations_match_jax(ext):
    """forward_digits, pointwise_acc + inverse, forward_digits_ext,
    pointwise_acc_ext + inverse_ext_to_torus on the digits of the GLWE
    batch against one key row's polynomials."""
    ring, jr = ext["ring"], ext["jr"]
    d = ext["digits"]                               # (lvl, batch, k+1, N)
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    fd, jfd = ring.forward_digits(dt), jr.forward_digits(dj)
    for i in range(2):
        np.testing.assert_array_equal(planes_np(fd[i]), planes_np(jfd[i]))
    # two pairs: (digits[l=0, :, j=0], g row (0,0,0)), (digits[1, :, 1], ..)
    pick = [(0, 0, (0, 0, 0)), (1, 1, (1, 1, 1))]

    def crt_pairs(f, g):
        return [(tuple((f[i][0][l, :, j], f[i][1][l, :, j]) for i in range(2)),
                 tuple((g[i][0][r], g[i][1][r]) for i in range(2)))
                for l, j, r in pick]

    fg = ring.forward(t(ext["g"]))
    got = ring.inverse(ring.pointwise_acc(crt_pairs(fd, fg)))
    want = jr.inverse(jr.pointwise_acc(crt_pairs(jfd, ext["g_crt"])))
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))

    fe, jfe = ring.forward_digits_ext(dt), jr.forward_digits_ext(dj)
    np.testing.assert_array_equal(planes_np(fe), planes_np(jfe))
    ge = ring.forward_ext_mont(t(ext["g"]))

    def ext_pairs(f, g):
        return [((f[0][l, :, j], f[1][l, :, j]), (g[0][r], g[1][r]))
                for l, j, r in pick]

    got = ring.inverse_ext_to_torus(ring.pointwise_acc_ext(ext_pairs(fe, ge)))
    want = jr.inverse_ext_to_torus(jr.pointwise_acc_ext(
        ext_pairs(jfe, ext["g_ext"])))
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))


def test_multiply_small_matches_jax(ext):
    """Small digits times the key row's torus polynomials, at the row's
    shape (so the JAX side reuses the transforms compiled above)."""
    d = np.random.default_rng(6).integers(-64, 65, ext["g"].shape) \
        .astype(np.int32)
    want = ext["jr"].multiply_small(jnp.asarray(d), jnp.asarray(ext["g"]))
    got = ext["ring"].multiply_small(torch.from_numpy(d), t(ext["g"]))
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))


def test_ext_bound_and_centered_maps_match_jax(ext):
    ring, jr = ext["ring"], ext["jr"]
    for base_log, terms in ((7, 6), (8, 10), (10, 6), (12, 1)):
        assert ring.ext_bound_ok(base_log, terms) == \
            jr.ext_bound_ok(base_log, terms)
    edges = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                     dtype=np.uint32)
    for ntt, jntt in ((ring.ntt1, jr.ntt1), (ring.ntt_ext, jr.ntt_ext)):
        np.testing.assert_array_equal(
            planes_np(ring._to_planes_centered(t(edges), ntt)),
            planes_np(jr._to_planes_centered(jnp.asarray(edges), jntt)))
        d = np.array([-512, -1, 0, 1, 512], dtype=np.int32)
        np.testing.assert_array_equal(
            planes_np(ring._digits_to_planes(torch.from_numpy(d), ntt)),
            planes_np(jr._digits_to_planes(jnp.asarray(d), jntt)))


# ---------------------------------------------------------------------------
# Whole bootstraps and the backends' bounds
# ---------------------------------------------------------------------------

def numpy_lwe(rng, msgs, lwe_sk, p):
    """LWE encryptions made with numpy: uniform a, b = <a, s> + Delta m."""
    a = u32(rng, (len(msgs), p.n_lwe))
    delta = (1 << 32) // p.plaintext_modulus
    b = (a.astype(np.uint64) @ lwe_sk.astype(np.uint64)
         + np.asarray(msgs, dtype=np.uint64) * delta) % (1 << 32)
    return a, b.astype(np.uint32)


def jax_ntt_key(eng, p, seed):
    """(lwe_sk, glwe_sk, port key, JAX key): the GGSW rows drawn by the
    port, their NTT form computed by the JAX package, the key-switch key
    from the port's keygen; the JAX form carried across with convert."""
    gen = torch.Generator().manual_seed(seed)
    lwe_sk, glwe_sk = eng.lwe_keygen(gen), eng.glwe_keygen(gen)
    own = eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
    gen = torch.Generator().manual_seed(seed)
    eng.lwe_keygen(gen), eng.glwe_keygen(gen)
    rows = tensor_to_u32(eng.ggsw_rows(gen, lwe_sk, glwe_sk))
    jform = jax.jit(JaxRing(p.poly_degree).forward_ext_mont)(
        jnp.asarray(rows))
    _, ka, kb = bsk_to_numpy(own)
    jkey = JaxKey(ggsw_ext=jform, ksk_a=jnp.asarray(ka),
                  ksk_b=jnp.asarray(kb),
                  params=JaxParams(**dataclasses.asdict(p)))
    key = bsk_from_numpy(None, ka, kb, p, device="cpu",
                         ggsw_ext=tuple(np.asarray(x) for x in jform))
    return lwe_sk, glwe_sk, own, key, jkey


def test_ntt_bootstrap_matches_jax():
    """The slice as a whole: "ntt" bootstraps of the port and of the JAX
    package agree bit for bit on one key and decode to the messages; the
    port's own keygen gives the same NTT form as the JAX transform."""
    p = tiny_params()
    eng = TfheEngine(p, ext_backend="ntt", device="cpu")
    lwe_sk, _, own, key, jkey = jax_ntt_key(eng, p, 21)
    for mine, theirs in zip(own.ggsw_ext, key.ggsw_ext):
        assert torch.equal(mine, theirs)
    msgs = np.arange(8) % 2          # the negacyclic domain [0, t/2)
    sk = tensor_to_u32(lwe_sk)
    a, b = numpy_lwe(np.random.default_rng(4), msgs, sk, p)
    jeng = JaxEngine(JaxParams(**dataclasses.asdict(p)), ext_backend="ntt")
    tp = eng.default_test_poly()
    want = jeng.bootstrap_jit(JaxLwe(a=jnp.asarray(a), b=jnp.asarray(b)),
                              jkey, jnp.asarray(tensor_to_u32(tp)))
    got = eng.bootstrap_with_test_poly(lwe_from_numpy(a, b, "cpu"), key, tp)
    ga, gb = lwe_to_numpy(got)
    np.testing.assert_array_equal(ga, np.asarray(want.a))
    np.testing.assert_array_equal(gb, np.asarray(want.b))
    np.testing.assert_array_equal(eng.lwe_decrypt(got, lwe_sk).numpy(),
                                  msgs)


def tfhe256_gadget(**kw):
    return tiny_params(poly_degree=4096, pbs_base_log=10, pbs_level=3,
                       plaintext_modulus=16, **kw)


def test_backend_bounds_follow_jax():
    """"ntt" rejects the TFHE_256 gadget and names "crt", which takes it;
    "auto" resolves on the CPU as the JAX package's does."""
    p = tfhe256_gadget()
    with pytest.raises(ValueError, match="crt"):
        TfheEngine(p, ext_backend="ntt", device="cpu")
    assert TfheEngine(p, ext_backend="crt", device="cpu").backend == "crt"
    # N % 128 binds only the int8 kernel backends
    assert TfheEngine(tiny_params(), ext_backend="ntt",
                      device="cpu").backend == "ntt"
    for q in (p, tiny_params()):
        want = JaxEngine(JaxParams(**dataclasses.asdict(q)),
                         ext_backend="auto").backend
        assert TfheEngine(q, ext_backend="auto", device="cpu").backend == \
            want


def test_key_form_must_match_the_backend():
    p = tiny_params(n_lwe=2)
    gen = torch.Generator().manual_seed(1)
    e_n = TfheEngine(p, ext_backend="ntt", device="cpu")
    e_c = TfheEngine(p, ext_backend="crt", device="cpu")
    lsk, gsk = e_n.lwe_keygen(gen), e_n.glwe_keygen(gen)
    key = e_n.generate_bootstrap_key(gen, lsk, gsk)
    assert key.ggsw_i8 is None and key.ggsw_crt is None
    assert key.ggsw_ext[0].shape == (2, 2, 3, 2, N)
    assert e_n.prepare_bsk(key) is key
    ct = e_n.lwe_encrypt(gen, torch.zeros(2, dtype=torch.int32), lsk)
    with pytest.raises(ValueError, match="ggsw_crt"):
        e_c.bootstrap(ct, key)


@pytest.mark.slow
def test_crt_bootstrap_matches_jax_and_tfhe256_gadget_decodes():
    """Mirrors the JAX package's slow CRT test: the "crt" bootstrap equals
    the JAX "crt" bootstrap (JAX keygen from its own PRNG, key carried
    across), and the TFHE_256 gadget (Bg=2^10, l=3 at N=4096) decodes
    through "crt"."""
    p = tiny_params()
    jp_ = JaxParams(**dataclasses.asdict(p))
    jeng = JaxEngine(jp_, ext_backend="crt")
    k = jax.random.PRNGKey(31)
    jlsk = jeng.lwe_keygen(jax.random.fold_in(k, 0))
    jgsk = jeng.glwe_keygen(jax.random.fold_in(k, 1))
    jkey = jeng.generate_bootstrap_key(jax.random.fold_in(k, 2), jlsk, jgsk)
    key = bsk_from_numpy(None, np.asarray(jkey.ksk_a),
                         np.asarray(jkey.ksk_b), p, device="cpu",
                         ggsw_crt=tuple(tuple(np.asarray(x) for x in pr)
                                        for pr in jkey.ggsw_crt))
    msgs = np.arange(8) % 2
    a, b = numpy_lwe(np.random.default_rng(6), msgs, np.asarray(jlsk), p)
    eng = TfheEngine(p, ext_backend="crt", device="cpu")
    tp = eng.default_test_poly()
    want = jeng.bootstrap_jit(JaxLwe(a=jnp.asarray(a), b=jnp.asarray(b)),
                              jkey, jnp.asarray(tensor_to_u32(tp)))
    got = eng.bootstrap_with_test_poly(lwe_from_numpy(a, b, "cpu"), key, tp)
    ga, gb = lwe_to_numpy(got)
    np.testing.assert_array_equal(ga, np.asarray(want.a))
    np.testing.assert_array_equal(gb, np.asarray(want.b))

    p256 = tfhe256_gadget()
    e256 = TfheEngine(p256, ext_backend="crt", device="cpu")
    gen = torch.Generator().manual_seed(32)
    lsk, gsk = e256.lwe_keygen(gen), e256.glwe_keygen(gen)
    key256 = e256.generate_bootstrap_key(gen, lsk, gsk)
    m2 = torch.arange(4) % 16
    out = e256.bootstrap(e256.lwe_encrypt(gen, m2, lsk), key256)
    assert torch.equal(e256.lwe_decrypt(out, lsk), m2.to(torch.int32))
