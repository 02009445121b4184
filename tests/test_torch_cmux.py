"""The port's CMux step (ops/cmux.py) and external product vs the JAX
package's Pallas CMux kernel (interpret mode, as tests/test_pallas_cmux.py
runs it on the CPU) and its int8 MXU algebra.  On the CPU the port's
wrapper takes its plain version.  Inputs come from numpy or a seeded
torch.Generator and go through both packages.  Tolerance: exact equality --
every value is an integer mod 2^32.  The kernel-vs-plain tests are in
tests/test_torch_kernel_cuda.py, which imports no JAX so it also runs on a
machine with a card."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from node_fhe_accelerate_tpu.core.bootstrap import (
    TfheEngine as JaxEngine, TfheParams as JaxParams)
from node_fhe_accelerate_tpu.ops.pallas_cmux import (
    build_diag_tiles, cmux_step_pallas, cmux_step_tiles)
from node_fhe_accelerate_tpu_torch.core.bootstrap import TfheEngine, TfheParams
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32, u32_to_tensor
from node_fhe_accelerate_tpu_torch.ops.cmux import cmux_step

torch.set_num_threads(2)


def params_256(**kw):
    d = dict(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
             pbs_level=3, ks_base_log=4, ks_level=8, lwe_noise_std=0.0,
             glwe_noise_std=0.0, plaintext_modulus=4)
    d.update(kw)
    return TfheParams(**d)


def params_k4(**kw):
    return params_256(n_lwe=4, glwe_dim=4, pbs_base_log=8, pbs_level=2, **kw)


def jax_params(p):
    return JaxParams(**dataclasses.asdict(p))


def port_key(p, seed):
    eng = TfheEngine(p, ext_backend="pallas", device="cpu")
    gen = torch.Generator().manual_seed(seed)
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    return eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)


@pytest.fixture(scope="module")
def key256():
    p = params_256()
    return p, port_key(p, 3)


def random_acc_rot(p, batch, seed, edges=False):
    rng = np.random.default_rng(seed)
    n = p.poly_degree
    acc = rng.integers(0, 1 << 32, (batch, p.glwe_dim + 1, n),
                       dtype=np.uint64).astype(np.uint32)
    rot = rng.integers(-4 * n, 4 * n, batch).astype(np.int32)
    if edges:
        rot[:6] = [0, n, 2 * n - 1, -1, -n - 5, 9 * n + 3]
    return acc, rot


def port_step(acc, rot, g, base_log):
    out = cmux_step(u32_to_tensor(acc, "cpu"), torch.from_numpy(rot), g,
                    base_log)
    return tensor_to_u32(out)


@pytest.mark.parametrize("edges", [False, True])
def test_cmux_step_matches_pallas_v1(key256, edges):
    p, bsk = key256
    acc, rot = random_acc_rot(p, 8, 0, edges)
    g = bsk.ggsw_i8[3]
    ghat2 = jnp.asarray(torch.cat([g, g], dim=-1).numpy())
    want = cmux_step_pallas(jnp.asarray(acc), jnp.asarray(rot), ghat2,
                            p.pbs_base_log, interpret=True)
    np.testing.assert_array_equal(port_step(acc, rot, g, p.pbs_base_log),
                                  np.asarray(want))


def test_cmux_step_matches_pallas_tiles(key256):
    p, bsk = key256
    acc, rot = random_acc_rot(p, 8, 1, edges=True)
    g = bsk.ggsw_i8[0]
    tiles = build_diag_tiles(jnp.asarray(torch.cat([g, g], dim=-1).numpy()))
    want = cmux_step_tiles(jnp.asarray(acc), jnp.asarray(rot), tiles,
                           p.pbs_base_log, interpret=True)
    np.testing.assert_array_equal(port_step(acc, rot, g, p.pbs_base_log),
                                  np.asarray(want))


def test_cmux_step_k4_geometry_matches_jax_mxu():
    """K4 geometry (k=4, N=256, Bg=2^8, l=2): the port's step against the
    JAX engine's rotate + cmux on the same key row."""
    p = params_k4()
    bsk = port_key(p, 4)
    jeng = JaxEngine(jax_params(p), ext_backend="mxu")
    acc, rot = random_acc_rot(p, 6, 2, edges=True)
    g = bsk.ggsw_i8[1]
    jacc = jnp.asarray(acc)
    rotated = jeng.ring.rotate(jacc, jnp.asarray(rot)[:, None])
    want = jeng.cmux(jnp.asarray(g.numpy()), jacc, rotated)
    np.testing.assert_array_equal(port_step(acc, rot, g, p.pbs_base_log),
                                  np.asarray(want))


@pytest.mark.parametrize("drop", [0, 1])
def test_external_product_mxu_matches_jax(drop):
    p = params_k4(bsk_drop_planes=drop)
    eng = TfheEngine(p, ext_backend="mxu", device="cpu")
    jeng = JaxEngine(jax_params(p), ext_backend="mxu")
    rng = np.random.default_rng(10 + drop)
    g = rng.integers(-128, 128, (2, 5, 5, 4 - drop, 512)).astype(np.int8)
    glwe = rng.integers(0, 1 << 32, (3, 5, 256),
                        dtype=np.uint64).astype(np.uint32)
    want = jeng.external_product_mxu(jnp.asarray(g), jnp.asarray(glwe))
    got = eng.external_product_mxu(torch.from_numpy(g),
                                   u32_to_tensor(glwe, "cpu"))
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))
    with pytest.raises(ValueError):
        eng.external_product_mxu(torch.from_numpy(g[..., :1, :]),
                                 u32_to_tensor(glwe, "cpu"))


def test_cmux_step_rejects_bad_inputs(key256):
    p, bsk = key256
    acc, rot = random_acc_rot(p, 4, 3)
    a, r, g = u32_to_tensor(acc, "cpu"), torch.from_numpy(rot), bsk.ggsw_i8[0]
    with pytest.raises(ValueError):
        cmux_step(a.to(torch.int64), r, g, p.pbs_base_log)
    with pytest.raises(ValueError):
        cmux_step(a, r[:3], g, p.pbs_base_log)
    with pytest.raises(ValueError):
        cmux_step(a[:, :1], r, g, p.pbs_base_log)
    with pytest.raises(ValueError):
        cmux_step(a.transpose(1, 2).contiguous().transpose(1, 2), r, g,
                  p.pbs_base_log)
    with pytest.raises(ValueError):
        cmux_step(a, r, g, 9)
