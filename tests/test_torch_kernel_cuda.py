"""The Hopper kernels (csrc/cmux_step.cu, cmux_step_slabs.cu,
ladder_tiles.cu, ladder_steps.cu, ntt.cu, digits.cu) vs their plain PyTorch
versions on the card.  Needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine with a card and no
JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernel_cuda.py

Inputs are random from a seeded torch.Generator (numpy with a seed for
the field elements).  Tolerance: exact
equality -- every value is an integer mod 2^32, mod the NTT prime or mod
a field prime."""
import dataclasses

import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu_torch.core.bootstrap import (
    TFHE_BOOT_128_K4, TFHE_BOOT_128_L2, TfheEngine, TfheParams)
from node_fhe_accelerate_tpu_torch.ops.cmux import (
    build_all_step_kslabs, build_diag_slabs, cmux_step, cmux_step_reference,
    cmux_step_slabs, cmux_step_slabs_reference)
from node_fhe_accelerate_tpu_torch.ops.ladder import (
    blind_rotate_fused, blind_rotate_fused_reference,
    blind_rotate_fused_steps, blind_rotate_fused_steps_reference)
from node_fhe_accelerate_tpu_torch.ops.ntt import (NTTContext,
                                                   negacyclic_mul_np)
from node_fhe_accelerate_tpu_torch.ops.ntt_pallas import PallasNTT
from node_fhe_accelerate_tpu_torch.ops import cmux as cmux_ops
from node_fhe_accelerate_tpu_torch.ops import digits, limbs
from node_fhe_accelerate_tpu_torch.ops.digits_pallas import (
    _mul_t_raw, pallas_field_mul)
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_to_np
from node_fhe_accelerate_tpu_torch.zk import curve as zk_curve
from node_fhe_accelerate_tpu_torch.zk import field as zk_field

torch.set_num_threads(2)

SMALL = TfheParams(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
                   pbs_level=3, ks_base_log=4, ks_level=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def random_ladder(p, batch, dev, seed, steps=1, drop=0):
    """acc (batch, k+1, N), rots (steps, batch) with edge values in the
    first row, and the int8 key rows (steps, lvl, k+1, k+1, P, 2N) of a
    freshly made key."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    eng = TfheEngine(dataclasses.replace(p, n_lwe=steps,
                                         bsk_drop_planes=drop),
                     ext_backend="mxu", device=dev)
    g = eng.generate_bootstrap_key(gen, eng.lwe_keygen(gen),
                                   eng.glwe_keygen(gen)).ggsw_i8
    n = p.poly_degree
    acc = torch.randint(-(1 << 31), 1 << 31,
                        (batch, p.glwe_dim + 1, n), generator=gen,
                        dtype=torch.int64, device=dev).to(torch.int32)
    rots = torch.randint(-4 * n, 4 * n, (steps, batch), generator=gen,
                         dtype=torch.int32, device=dev)
    edges = torch.tensor([0, n, 2 * n - 1, -1, -n - 5, 9 * n + 3])
    rots[0, :len(edges)] = edges[:batch]
    return acc, rots, g


def random_step(p, batch, dev, seed):
    acc, rots, g = random_ladder(p, batch, dev, seed)
    return acc, rots[0], g[0]


SHAPES = dict(argvalues=[(SMALL, 100), (TFHE_BOOT_128_K4(), 77),
                         (TFHE_BOOT_128_L2(), 40)],
              ids=["k1_l3_ragged", "k4_ragged", "l2_n1024"])


@pytest.mark.cuda
@pytest.mark.parametrize("p,batch", **SHAPES)
def test_kernel_matches_plain(cuda_device, p, batch):
    acc, rot, row = random_step(p, batch, cuda_device, 5)
    before = cmux_step.launches
    got = cmux_step(acc, rot, row, p.pbs_base_log)
    torch.cuda.synchronize()
    assert cmux_step.launches == before + 1
    assert torch.equal(got, cmux_step_reference(acc, rot, row,
                                                p.pbs_base_log))


@pytest.mark.cuda
def test_kernel_bootstrap_matches_mxu(cuda_device):
    p = dataclasses.replace(SMALL, lwe_noise_std=0.0, glwe_noise_std=0.0)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    eng = TfheEngine(p, device=cuda_device)
    sk = eng.lwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, sk, eng.glwe_keygen(gen))
    msgs = torch.arange(64, device=cuda_device) % 2
    ct = eng.lwe_encrypt(gen, msgs, sk)
    got = eng.bootstrap(ct, bsk)
    want = TfheEngine(p, ext_backend="mxu", device=cuda_device) \
        .bootstrap(ct, bsk)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v3", "v2"])
@pytest.mark.parametrize("p,batch", **SHAPES)
def test_slabs_kernel_matches_plain(cuda_device, p, batch, variant):
    acc, rot, row = random_step(p, batch, cuda_device, 7)
    slabs = build_diag_slabs(torch.cat([row, row], dim=-1))
    before = cmux_step_slabs.launches[variant]
    got = cmux_step_slabs(acc, rot, slabs, p.pbs_base_log, variant=variant)
    torch.cuda.synchronize()
    assert cmux_step_slabs.launches[variant] == before + 1
    assert torch.equal(got, cmux_step_slabs_reference(acc, rot, slabs,
                                                      p.pbs_base_log))
    assert torch.equal(got, cmux_step_reference(acc, rot, row,
                                                p.pbs_base_log))


@pytest.mark.cuda
@pytest.mark.parametrize("p,batch", **SHAPES)
def test_ladder_tiles_matches_plain(cuda_device, p, batch):
    acc, rots, g = random_ladder(p, batch, cuda_device, 8, steps=5)
    before = blind_rotate_fused.launches
    got = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    torch.cuda.synchronize()
    assert blind_rotate_fused.launches == before + 1
    assert torch.equal(got, blind_rotate_fused_reference(acc, rots, g,
                                                         p.pbs_base_log))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 127, 129])
def test_ladder_tiles_at_row_tile_edges(cuda_device, batch):
    """ladder_tiles at TFHE_BOOT_128_K4 on one row, on a partial 128-row
    tile, and on one row more than a tile (129 rows: two row tiles, the
    second of one row)."""
    p = TFHE_BOOT_128_K4()
    acc, rots, g = random_ladder(p, batch, cuda_device, 14, steps=3)
    before = blind_rotate_fused.launches
    got = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    torch.cuda.synchronize()
    assert blind_rotate_fused.launches == before + 1
    assert torch.equal(got, blind_rotate_fused_reference(acc, rots, g,
                                                         p.pbs_base_log))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1])
def test_ladder_tiles_at_zero_and_one_step(cuda_device, steps):
    """No step copies acc; one step is one CMux step."""
    p = TFHE_BOOT_128_K4()
    acc, rots, g = random_ladder(p, 300, cuda_device, 15, steps=1)
    rots, g = rots[:steps].contiguous(), g[:steps].contiguous()
    got = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    torch.cuda.synchronize()
    if steps == 0:
        assert torch.equal(got, acc)
    else:
        assert torch.equal(got, cmux_step_reference(acc, rots[0], g[0],
                                                    p.pbs_base_log))


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0, 1])
@pytest.mark.parametrize("p,batch", **SHAPES)
def test_ladder_steps_matches_plain(cuda_device, p, batch, drop):
    acc, rots, g = random_ladder(p, batch, cuda_device, 9, steps=5,
                                 drop=drop)
    slabs = build_all_step_kslabs(g)
    before = blind_rotate_fused_steps.launches
    got = blind_rotate_fused_steps(acc, rots, slabs, p.pbs_base_log,
                                   drop=drop)
    torch.cuda.synchronize()
    assert blind_rotate_fused_steps.launches == before + 1
    assert torch.equal(got, blind_rotate_fused_steps_reference(
        acc, rots, slabs, p.pbs_base_log, drop))
    if not drop:
        assert torch.equal(got, blind_rotate_fused_reference(
            acc, rots, g, p.pbs_base_log))


@pytest.mark.cuda
def test_ladders_take_more_tiles_than_blocks(cuda_device):
    """A batch of more tiles than the card has resident blocks (128-row x
    64-coefficient tiles of ladder_tiles, ladder_steps and cmux_step): the
    persistent kernels loop over tiles."""
    p = SMALL
    acc, rots, g = random_ladder(p, 32 * 300 + 5, cuda_device, 10, steps=3)
    want = blind_rotate_fused_reference(acc, rots, g, p.pbs_base_log)
    got = blind_rotate_fused_steps(acc, rots, build_all_step_kslabs(g),
                                   p.pbs_base_log)
    assert torch.equal(got, want)
    assert torch.equal(blind_rotate_fused(acc, rots, g, p.pbs_base_log),
                       want)
    assert torch.equal(cmux_step(acc, rots[0], g[0], p.pbs_base_log),
                       cmux_step_reference(acc, rots[0], g[0],
                                           p.pbs_base_log))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 17, 100, 4000, 4096 + 64])
def test_redesigned_kernels_at_ragged_batches(cuda_device, batch):
    """The wgmma kernels (cmux_step, ladder_steps) at TFHE_BOOT_128_K4 on
    batches that leave a partial 128-row tile, each launch counted."""
    p = TFHE_BOOT_128_K4()
    acc, rots, g = random_ladder(p, batch, cuda_device, 11, steps=2)
    before = (cmux_step.launches, blind_rotate_fused_steps.launches)
    got = cmux_step(acc, rots[0], g[0], p.pbs_base_log)
    got_l = blind_rotate_fused_steps(acc, rots, build_all_step_kslabs(g),
                                     p.pbs_base_log)
    torch.cuda.synchronize()
    assert (cmux_step.launches, blind_rotate_fused_steps.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, cmux_step_reference(acc, rots[0], g[0],
                                                p.pbs_base_log))
    assert torch.equal(got_l, blind_rotate_fused_reference(
        acc, rots, g, p.pbs_base_log))


@pytest.mark.cuda
def test_redesigned_kernels_split_batches_past_the_digit_limit(
        cuda_device, monkeypatch):
    """With the digit-buffer limit lowered to two 128-row tiles at
    TFHE_BOOT_128_K4, a batch of 600 runs as three launches of cmux_step,
    of ladder_tiles and of ladder_steps, equal to the plain versions."""
    p = TFHE_BOOT_128_K4()
    kdim = p.pbs_level * (p.glwe_dim + 1) * p.poly_degree
    monkeypatch.setattr(cmux_ops, "DIGIT_BYTES_LIMIT", 256 * kdim + 1)
    acc, rots, g = random_ladder(p, 600, cuda_device, 12, steps=2)
    before = (cmux_step.launches, blind_rotate_fused.launches,
              blind_rotate_fused_steps.launches)
    got = cmux_step(acc, rots[0], g[0], p.pbs_base_log)
    got_t = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    got_l = blind_rotate_fused_steps(acc, rots, build_all_step_kslabs(g),
                                     p.pbs_base_log)
    torch.cuda.synchronize()
    assert (cmux_step.launches, blind_rotate_fused.launches,
            blind_rotate_fused_steps.launches) == \
        (before[0] + 3, before[1] + 3, before[2] + 3)
    assert torch.equal(got, cmux_step_reference(acc, rots[0], g[0],
                                                p.pbs_base_log))
    want_l = blind_rotate_fused_reference(acc, rots, g, p.pbs_base_log)
    assert torch.equal(got_t, want_l)
    assert torch.equal(got_l, want_l)


@pytest.mark.cuda
def test_redesigned_kernels_at_the_digit_limit(cuda_device):
    """At TFHE_BOOT_128_K4 a batch just past the 2^31-byte digit buffer
    (838,784 rows a launch) runs as two launches; the rows at both ends and
    at the seam equal the plain versions, which run on those rows alone."""
    p = TFHE_BOOT_128_K4()
    kdim = p.pbs_level * (p.glwe_dim + 1) * p.poly_degree
    full = (cmux_ops.DIGIT_BYTES_LIMIT - 1) // kdim // 128 * 128
    batch = full + 300
    acc, rots, g = random_ladder(p, batch, cuda_device, 13, steps=2)
    before = (cmux_step.launches, blind_rotate_fused.launches,
              blind_rotate_fused_steps.launches)
    got = cmux_step(acc, rots[0], g[0], p.pbs_base_log)
    got_t = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    got_l = blind_rotate_fused_steps(acc, rots, build_all_step_kslabs(g),
                                     p.pbs_base_log)
    torch.cuda.synchronize()
    assert (cmux_step.launches, blind_rotate_fused.launches,
            blind_rotate_fused_steps.launches) == \
        (before[0] + 2, before[1] + 2, before[2] + 2)
    idx = torch.cat([torch.arange(0, 200), torch.arange(full - 200,
                                                        full + 100),
                     torch.arange(batch - 100, batch)]).to(cuda_device)
    assert torch.equal(got[idx], cmux_step_reference(
        acc[idx], rots[0, idx], g[0], p.pbs_base_log))
    want_l = blind_rotate_fused_reference(
        acc[idx], rots[:, idx].contiguous(), g, p.pbs_base_log)
    assert torch.equal(got_t[idx], want_l)
    assert torch.equal(got_l[idx], want_l)


@pytest.mark.cuda
def test_full_ladder_tiles_equals_steps_and_630_cmux_steps(cuda_device):
    """One whole TFHE_BOOT_128_K4 ladder (630 steps) at batch 4096:
    ladder_tiles == ladder_steps == 630 cmux_step launches, bit for bit."""
    p = TFHE_BOOT_128_K4()
    acc, rots, g = random_ladder(p, 4096, cuda_device, 16, steps=p.n_lwe)
    got_t = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    got_l = blind_rotate_fused_steps(acc, rots, build_all_step_kslabs(g),
                                     p.pbs_base_log)
    step = acc
    for s in range(p.n_lwe):
        step = cmux_step(step, rots[s], g[s], p.pbs_base_log)
    torch.cuda.synchronize()
    assert torch.equal(got_t, got_l)
    assert torch.equal(got_t, step)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["mxu_fused", "pallas_fused"])
def test_fused_bootstrap_matches_mxu(cuda_device, backend):
    p = dataclasses.replace(SMALL, lwe_noise_std=0.0, glwe_noise_std=0.0)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    eng = TfheEngine(p, ext_backend=backend, device=cuda_device)
    sk = eng.lwe_keygen(gen)
    bsk = eng.prepare_bsk(eng.generate_bootstrap_key(gen, sk,
                                                     eng.glwe_keygen(gen)))
    msgs = torch.arange(64, device=cuda_device) % 2
    ct = eng.lwe_encrypt(gen, msgs, sk)
    got = eng.bootstrap(ct, bsk)
    want = TfheEngine(p, ext_backend="mxu", device=cuda_device) \
        .bootstrap(ct, bsk)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))


P1 = (1 << 40) - (1 << 32) + 1
P_EXT = (1 << 54) - (1 << 24) + 1
Q_40_1 = 1095216660481
Q_60_1 = 1152921504606584833
NTT_SHAPES = dict(argvalues=[(256, 37, P_EXT), (4, 5, Q_40_1),
                             (1024, 3, Q_40_1), (4096, 24, P1),
                             (16384, 2, Q_60_1)],
                  ids=["n256_pext_ragged", "n4", "n1024", "n4096_p1",
                       "n16384_q60"])


def random_planes(n, batch, q, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randint(0, q, (batch, n), generator=gen, dtype=torch.int64,
                      device=dev)
    v[0, :3] = torch.tensor([0, 1, q - 1])
    return v.to(torch.int32), (v >> 32).to(torch.int32)


def same_planes(x, y):
    return all(torch.equal(a, b) for a, b in zip(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,q", **NTT_SHAPES)
def test_ntt_transforms_match_plain(cuda_device, n, batch, q):
    pk = PallasNTT(NTTContext(n, q))
    a = random_planes(n, batch, q, cuda_device, 11)
    before = dict(PallasNTT.launches)
    fa = pk.forward(a)
    back = pk.inverse(fa)
    torch.cuda.synchronize()
    assert PallasNTT.launches["forward"] == before["forward"] + 1
    assert PallasNTT.launches["inverse"] == before["inverse"] + 1
    assert same_planes(fa, pk.ntt.forward(a))
    assert same_planes(back, pk.ntt.inverse(fa))
    assert same_planes(back, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,q", [(256, 37, P_EXT), (1024, 3, Q_40_1),
                                       (8192, 2, Q_40_1)])
def test_ntt_negacyclic_mul_matches_plain(cuda_device, n, batch, q):
    pk = PallasNTT(NTTContext(n, q))
    a = random_planes(n, batch, q, cuda_device, 12)
    b = random_planes(n, batch, q, cuda_device, 13)
    got = pk.negacyclic_mul(a, b)
    torch.cuda.synchronize()
    assert same_planes(got, pk.ntt.negacyclic_mul(a, b))
    np.testing.assert_array_equal(
        u64_to_np(got)[1], negacyclic_mul_np(u64_to_np(a)[1],
                                             u64_to_np(b)[1], q))


@pytest.mark.cuda
def test_ntt_kernels_refuse_what_they_cannot_hold(cuda_device):
    big = PallasNTT(NTTContext(1 << 15, Q_40_1))
    a = random_planes(1 << 15, 1, Q_40_1, cuda_device, 1)
    with pytest.raises(ValueError, match="largest degree"):
        big.forward(a)
    mul = PallasNTT(NTTContext(1 << 14, Q_40_1))
    b = random_planes(1 << 14, 1, Q_40_1, cuda_device, 2)
    with pytest.raises(ValueError, match="largest degree"):
        mul.negacyclic_mul(b, b)
    assert mul.forward(b)[0].shape == (1, 1 << 14)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ntt", "crt"])
def test_ntt_backends_match_mxu(cuda_device, backend):
    """Keys from one generator state: the NTT backends' bootstraps equal
    the int8 backend's bit for bit and decode."""
    p = dataclasses.replace(SMALL, lwe_noise_std=0.0, glwe_noise_std=0.0)
    outs = {}
    for name in ("mxu", backend):
        eng = TfheEngine(p, ext_backend=name, device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        lsk, gsk = eng.lwe_keygen(gen), eng.glwe_keygen(gen)
        key = eng.generate_bootstrap_key(gen, lsk, gsk)
        msgs = torch.arange(6, device=cuda_device) % 2
        ct = eng.lwe_encrypt(gen, msgs, lsk)
        outs[name] = eng.bootstrap(ct, key)
        assert torch.equal(eng.lwe_decrypt(outs[name], lsk),
                           msgs.to(torch.int32))
    assert torch.equal(outs["mxu"].a, outs[backend].a)
    assert torch.equal(outs["mxu"].b, outs[backend].b)


def random_elements(f, batch, dev, seed):
    """Canonical random field elements (batch, D) with the edge values 0, 1
    and q-1 in the first rows."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(f.n_limbs), "little") % f.q
            for _ in range(batch)]
    vals[:3] = [0, 1, f.q - 1][:batch]
    return f.encode(vals).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("bn254_fq", 8160),
                                        ("bn254_fr", 1000),
                                        ("bls12_381_fq", 4096),
                                        ("bls12_381_fq", 1)])
def test_digit_kernels_match_plain(cuda_device, name, batch):
    """K9 (digit-major) and K10 (row-major) == the plain digit algebra, and
    a few rows == the big-integer oracle a*b*R^-1 mod q."""
    f = getattr(zk_field, name)(device=cuda_device)
    a = random_elements(f, batch, cuda_device, 14)
    b = random_elements(f, batch, cuda_device, 15)
    before = (_mul_t_raw.launches, pallas_field_mul.launches)
    k9 = _mul_t_raw(f, a.T.contiguous(), b.T.contiguous())
    k10 = pallas_field_mul(f, a, b)
    torch.cuda.synchronize()
    assert (_mul_t_raw.launches, pallas_field_mul.launches) == \
        (before[0] + 1, before[1] + 1)
    want = f.mul_plain(a, b)
    assert torch.equal(k9.T, want) and torch.equal(k10, want)
    assert torch.equal(f.mul(a, b), want) and torch.equal(f.square(a),
                                                          f.mul_plain(a, a))
    rinv = pow(1 << (8 * f.n_limbs), -1, f.q)
    xs, ys, zs = (digits.digits_to_ints(x[:4]) for x in (a, b, k10))
    for x, y, z in zip(xs, ys, zs):
        assert z == x * y * rinv % f.q


@pytest.mark.cuda
def test_device_msm_matches_host(cuda_device):
    """A device MSM at n=256 (the Pippenger: K9 wide adds, K10 narrow ops)
    == the host backend on the same inputs."""
    c = zk_curve.bn254_g1(device=cuda_device)
    rng = np.random.default_rng(16)
    pts = c.fixed_base_mul([int(v) for v in rng.integers(1, 2 ** 30, 256)])
    sc = limbs.limbs_from_ints([int(v) for v in
                                rng.integers(0, 2 ** 62, 256)], 8,
                               cuda_device)
    before = (_mul_t_raw.launches, pallas_field_mul.launches)
    got = c.msm(sc, pts)
    assert _mul_t_raw.launches > before[0]
    assert pallas_field_mul.launches > before[1]
    want = c.msm(sc, pts, backend="host")
    assert [int(v) for v in c.to_affine_ints(got)[:2]] == \
        [int(v) for v in c.to_affine_ints(want)[:2]]
