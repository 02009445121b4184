"""The port's multi-device layer (node_fhe_accelerate_tpu_torch/parallel/:
mesh, collectives, pbs, msm, multihost) on the CPU.

Every mesh here has 4 positions on the CPU device (listed in ``devices=``).
The collectives are held against ``jax.lax`` under ``shard_map`` on a
4-device JAX mesh (conftest's 8 virtual CPU devices), on the same numpy
inputs; the sharded bootstrap against the port's unsharded one; the sharded
MSM against the JAX package's host Pippenger; the multi-process layer in
its one-process cases (tests/test_parallel.py's).  Inputs are random from
numpy with a seed.  Tolerance: exact equality."""
import numpy as np
import pytest
import torch
import jax
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from node_fhe_accelerate_tpu.parallel.mesh import make_mesh as jax_mesh
from node_fhe_accelerate_tpu.zk import curve as jcurve
from node_fhe_accelerate_tpu_torch.convert import points_from_numpy
from node_fhe_accelerate_tpu_torch.core.bootstrap import (TfheEngine,
                                                          TfheParams)
from node_fhe_accelerate_tpu_torch.ops import limbs as lb
from node_fhe_accelerate_tpu_torch.ops.modular import ModCtx
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np, u64_to_np
from node_fhe_accelerate_tpu_torch.parallel import collectives, mesh
from node_fhe_accelerate_tpu_torch.parallel.msm import sharded_msm
from node_fhe_accelerate_tpu_torch.parallel.multihost import (
    assemble_global, host_local_batch,
    initialize_distributed, make_host_mesh, process_info)
from node_fhe_accelerate_tpu_torch.parallel.pbs import (
    replicate_bsk, shard_lwe_batch, sharded_bootstrap_fn)
from node_fhe_accelerate_tpu_torch.zk import curve as tcurve

torch.set_num_threads(2)

Q = (1 << 40) - (1 << 32) + 1          # Q_40_1
CPU4 = ["cpu"] * 4


def cpu_mesh(n=4):
    return mesh.make_mesh(n, data=n, devices=["cpu"] * n)


def jax_shards(x):
    """numpy (4, ...) -> the 4 local shards (1, ...) the shard_map body
    sees, as torch tensors."""
    return [torch.from_numpy(np.ascontiguousarray(x[i:i + 1]))
            for i in range(4)]


def joined(shards):
    return np.concatenate([s.numpy() for s in shards])


# -- mesh --------------------------------------------------------------------

def test_mesh_shape_and_devices():
    m = mesh.make_mesh(4, data=2, model=2, devices=["cpu"] * 4)
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 2}
    assert m.devices.shape == (2, 2)
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    assert m.distinct_devices() == [torch.device("cpu")]


def test_mesh_needs_the_devices_listed():
    """More positions than devices raises: by default the visible CUDA
    devices (none here), or the devices the caller lists."""
    with pytest.raises(ValueError, match="positions"):
        mesh.make_mesh(4, data=4)
    with pytest.raises(ValueError, match="positions"):
        mesh.make_mesh(4, data=4, devices=["cpu"] * 3)
    assert cpu_mesh().shape["data"] == 4


def test_put_gather_round_trip():
    m = cpu_mesh()
    with pytest.raises(ValueError, match="split"):
        mesh.put(torch.zeros(8, 6), mesh.data_sharding(m, 2, batch_axis=1))
    y = torch.arange(8 * 4, dtype=torch.int32).reshape(8, 4)
    s = mesh.put(y, mesh.data_sharding(m, 2))
    assert isinstance(s, mesh.Sharded) and s.dim == 0
    assert [tuple(t.shape) for t in s.shards] == [(2, 4)] * 4
    assert s.global_shape == (8, 4)
    assert torch.equal(mesh.gather(s), y)
    r = mesh.put(y, mesh.replicated(m))
    assert list(r.copies) == ["cpu"] and r.on("cpu") is y


# -- collectives against jax.lax ---------------------------------------------

@pytest.mark.parametrize("shape,split,concat", [
    ((4, 4, 3, 5), 1, 3), ((4, 3, 4, 5), 2, 1), ((4, 4, 2), 1, 1),
    ((4, 2, 4, 6), 2, 2)])
def test_all_to_all_matches_lax(shape, split, concat):
    x = np.random.default_rng(sum(shape)).integers(
        0, 1 << 31, shape).astype(np.int32)
    f = shard_map(lambda y: lax.all_to_all(
        y, "data", split_axis=split, concat_axis=concat, tiled=False),
        mesh=jax_mesh(4, data=4), in_specs=P("data"), out_specs=P("data"))
    want = np.asarray(jax.jit(f)(x))
    collectives.traffic.reset()
    got = collectives.all_to_all(jax_shards(x), split, concat)
    np.testing.assert_array_equal(joined(got), want)
    # every position sends 3 of its 4 chunks to the others
    assert collectives.traffic.bytes == x.nbytes * 3 // 4
    assert collectives.traffic.values == 12


@pytest.mark.parametrize("perm", [
    [(0, 1), (1, 2), (2, 3), (3, 0)], [(0, 2), (2, 0)],
    [(1, 0), (0, 1), (3, 2), (2, 3)]])
def test_ppermute_matches_lax(perm):
    x = np.random.default_rng(len(perm)).integers(
        0, 1 << 31, (4, 3, 5)).astype(np.int32)
    f = shard_map(lambda y: lax.ppermute(y, "data", perm),
                  mesh=jax_mesh(4, data=4), in_specs=P("data"),
                  out_specs=P("data"))
    want = np.asarray(jax.jit(f)(x))
    got = collectives.ppermute(jax_shards(x), perm)
    np.testing.assert_array_equal(joined(got), want)


def test_psum_mod_matches_host():
    ctx = ModCtx(Q)
    vals = np.random.default_rng(0).integers(0, Q, (4, 128),
                                             dtype=np.uint64)
    shards = [u64_from_np(vals[i]) for i in range(4)]
    collectives.traffic.reset()
    got = collectives.psum_mod(ctx, shards)
    want = np.array(vals.astype(object).sum(axis=0) % Q, dtype=np.uint64)
    for g in got:               # every position holds the full sum
        np.testing.assert_array_equal(u64_to_np(g), want)
    # two doubling steps, each position sends its 128 x 8 bytes
    assert collectives.traffic.bytes == 2 * 4 * 128 * 8
    with pytest.raises(ValueError, match="power-of-two"):
        collectives.psum_mod(ctx, shards[:3])


# -- sharded bootstrap ----------------------------------------------------------

PBS_PARAMS = TfheParams(n_lwe=8, poly_degree=64, glwe_dim=1, pbs_base_log=7,
                        pbs_level=3, ks_base_log=4, ks_level=8,
                        lwe_noise_std=0.0, glwe_noise_std=0.0,
                        plaintext_modulus=4)


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for f in x.__dataclass_fields__
                for t in leaves(getattr(x, f))]
    return []


def test_sharded_pbs_matches_unsharded():
    """tests/test_parallel.py's params: the batch split over 4 positions is
    bit-equal to the unsharded bootstrap and decodes; the key is held once
    per distinct device (here the CPU: its own tensors, no copy)."""
    eng = TfheEngine(PBS_PARAMS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
    msgs = torch.arange(16) % 2
    ct = eng.lwe_encrypt(gen, msgs, lwe_sk)
    tp = eng.default_test_poly()
    ref = eng.bootstrap_with_test_poly(ct, bsk, tp)

    m = cpu_mesh()
    ct_sh = shard_lwe_batch(ct, m)
    bsk_r = replicate_bsk(bsk, m)
    assert list(bsk_r.copies) == ["cpu"]
    held = bsk_r.on("cpu")
    assert all(a is b for a, b in zip(leaves(held), leaves(bsk)))
    collectives.traffic.reset()
    f = sharded_bootstrap_fn(eng, m)
    out = f(ct_sh, bsk_r, tp)
    assert collectives.traffic.bytes == 0
    assert list(f.engines.values()) == [eng]
    assert [tuple(s.shape) for s in out.b.shards] == [(4,)] * 4
    full = mesh.gather(out)
    assert torch.equal(full.a, ref.a) and torch.equal(full.b, ref.b)
    assert torch.equal(eng.lwe_decrypt(full, lwe_sk), msgs.to(torch.int32))
    # whole inputs are placed on the way in
    again = mesh.gather(f(ct, bsk, tp))
    assert torch.equal(again.a, ref.a) and torch.equal(again.b, ref.b)


# -- sharded MSM --------------------------------------------------------------

def test_sharded_msm_matches_jax_host_pippenger():
    """64 points over 4 positions, c=4, 32-bit scalars (8 windows), a zero
    scalar and a point at infinity; equal to the JAX package's host
    Pippenger by projective equality.  The combine moves K - 1 = 3 partial
    points."""
    jc, tc = jcurve.bn254_g1(), tcurve.bn254_g1(device="cpu")
    rng = np.random.default_rng(11)
    n = 64
    ks = [int(k) for k in rng.integers(1, 1 << 16, n)]
    ss = [int(s) for s in rng.integers(1, 1 << 32, n)]
    ss[5] = 0
    jpts = jc.fixed_base_mul(ks, backend="host")
    jpts = (jpts[0], jpts[1], jpts[2].at[9].set(0))
    host = [tuple(int(v) for v in p) for p in jc._points_to_host(jpts)]
    want = jcurve._host_pippenger(jc.fq.q, ss, host)
    pts = points_from_numpy(tc, [np.asarray(c) for c in jpts])
    collectives.traffic.reset()
    got, moved = sharded_msm(tc, lb.limbs_from_ints(ss, 1, "cpu"), pts,
                             cpu_mesh(), c=4, _want_ici_bytes=True)
    want_pt = tc._points_from_host([want])
    assert bool(tc.eq(tuple(c[None] for c in got), want_pt)[0])
    point_bytes = 3 * tc.fq.n_limbs * 4
    assert moved == collectives.traffic.bytes == 3 * point_bytes
    assert collectives.traffic.values == 3


# -- multihost, one process (tests/test_parallel.py's cases) --------------------

def test_initialize_noop_and_process_info():
    info = initialize_distributed()     # no env, no args: joins nothing
    assert info == process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == info["local_devices"]


def test_host_mesh_layout():
    m = make_host_mesh(model=2, devices=["cpu"] * 8)
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (4, 2)
    with pytest.raises(ValueError, match="one host"):
        make_host_mesh(model=16, devices=["cpu"] * 8)


def test_host_local_batch_split():
    assert host_local_batch(64) == (64, 0)


def test_assemble_global_tally():
    """This process's shards over the host mesh, then the modular psum
    over the positions == the host oracle."""
    ctx = ModCtx(Q)
    m = make_host_mesh(model=1, devices=CPU4)
    vals = np.random.default_rng(3).integers(0, Q, (4, 32), dtype=np.uint64)
    lo_np, hi_np = (t.numpy() for t in u64_from_np(vals))
    lo, hi = assemble_global(m, lo_np), assemble_global(m, hi_np)
    assert lo.global_shape == (4, 32) and len(lo.shards) == 4
    got = collectives.psum_mod(ctx, [(a[0], b[0]) for a, b in
                                     zip(lo.shards, hi.shards)])
    want = np.array(vals.astype(object).sum(axis=0) % Q, dtype=np.uint64)
    for g in got:
        np.testing.assert_array_equal(u64_to_np(g), want)
