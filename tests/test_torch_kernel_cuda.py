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
    TFHE_BOOT_128, TFHE_BOOT_128_K4, TFHE_BOOT_128_L2, TfheEngine,
    TfheParams)
from node_fhe_accelerate_tpu_torch.ops.cmux import (
    build_all_step_kslabs, build_diag_kslabs, cmux_step, cmux_step_reference,
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
    _mul_t_raw, jadd_reference, jdbl_reference, pallas_field_mul,
    pallas_jadd, pallas_jadd_t, pallas_jdbl, pallas_jdbl_t)
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
                         (TFHE_BOOT_128_L2(), 40), (TFHE_BOOT_128(), 50)],
              ids=["k1_l3_ragged", "k4_ragged", "l2_n1024", "boot128"])


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
    eng = TfheEngine(p, ext_backend="pallas", device=cuda_device)
    sk = eng.lwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, sk, eng.glwe_keygen(gen))
    msgs = torch.arange(64, device=cuda_device) % 2
    ct = eng.lwe_encrypt(gen, msgs, sk)
    got = eng.bootstrap(ct, bsk)
    want = TfheEngine(p, ext_backend="mxu", device=cuda_device) \
        .bootstrap(ct, bsk)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))


# the slab step at every SHAPES entry, at the edges of a 128-row tile (1,
# 127 and 129 rows at TFHE_BOOT_128_K4), and on more tiles than the card
# has resident blocks (SMALL: 76 row tiles x 8 column tiles)
SLAB_SHAPES = dict(
    argvalues=SHAPES["argvalues"] + [(TFHE_BOOT_128_K4(), 1),
                                     (TFHE_BOOT_128_K4(), 127),
                                     (TFHE_BOOT_128_K4(), 129),
                                     (SMALL, 32 * 300 + 5)],
    ids=SHAPES["ids"] + ["k4_one_row", "k4_127", "k4_129",
                         "more_tiles_than_blocks"])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v3", "v2"])
@pytest.mark.parametrize("p,batch", **SLAB_SHAPES)
def test_slabs_kernel_matches_plain(cuda_device, p, batch, variant):
    acc, rot, row = random_step(p, batch, cuda_device, 7)
    kslabs = build_diag_kslabs(torch.cat([row, row], dim=-1))
    before = cmux_step_slabs.launches[variant]
    got = cmux_step_slabs(acc, rot, kslabs, p.pbs_base_log, variant=variant)
    torch.cuda.synchronize()
    assert cmux_step_slabs.launches[variant] == before + 1
    assert torch.equal(got, cmux_step_slabs_reference(acc, rot, kslabs,
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
    of each cmux_step_slabs variant, of ladder_tiles and of ladder_steps,
    equal to the plain versions."""
    p = TFHE_BOOT_128_K4()
    kdim = p.pbs_level * (p.glwe_dim + 1) * p.poly_degree
    monkeypatch.setattr(cmux_ops, "DIGIT_BYTES_LIMIT", 256 * kdim + 1)
    acc, rots, g = random_ladder(p, 600, cuda_device, 12, steps=2)
    kslabs = build_diag_kslabs(torch.cat([g[0], g[0]], dim=-1))
    before = (cmux_step.launches, blind_rotate_fused.launches,
              blind_rotate_fused_steps.launches,
              dict(cmux_step_slabs.launches))
    got = cmux_step(acc, rots[0], g[0], p.pbs_base_log)
    got_s = [cmux_step_slabs(acc, rots[0], kslabs, p.pbs_base_log,
                             variant=v) for v in ("v3", "v2")]
    got_t = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
    got_l = blind_rotate_fused_steps(acc, rots, build_all_step_kslabs(g),
                                     p.pbs_base_log)
    torch.cuda.synchronize()
    assert (cmux_step.launches, blind_rotate_fused.launches,
            blind_rotate_fused_steps.launches) == \
        (before[0] + 3, before[1] + 3, before[2] + 3)
    assert cmux_step_slabs.launches == {v: before[3][v] + 3
                                        for v in ("v3", "v2")}
    want = cmux_step_reference(acc, rots[0], g[0], p.pbs_base_log)
    assert torch.equal(got, want)
    assert all(torch.equal(x, want) for x in got_s)
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
P2 = (1 << 37) - (1 << 17) + 1
P_EXT = (1 << 54) - (1 << 24) + 1
Q_40_1 = 1095216660481
Q_60_1 = 1152921504606584833
# the largest NTT prime each form of the kernels' arithmetic takes: the
# doubles below 2^46 (2^46 - 2^38 + 1), Shoup's products below 2^62 (2^62 -
# 2^16 + 1; lazy butterflies need 4q < 2^64); the smallest above 2^46
# (2^46 + 2^15 + 1, the first of the wide form) and above 2^62 (2^62 + 19 *
# 2^15 + 1, refused); all 1 mod 2^15
Q_F64_MAX = (1 << 46) - (1 << 38) + 1
Q_WIDE_MIN = (1 << 46) + (1 << 15) + 1
Q_MAX = (1 << 62) - (1 << 16) + 1
Q_ABOVE = (1 << 62) + 622593
# every degree at a batch of 1 and a ragged one, with the moduli of the
# paths; the path shapes; more polynomials than resident blocks (264 at
# N = 4096, 132 at N = 16384 on an H100); the largest modulus
NTT_SHAPES = dict(argvalues=(
    [(1 << lg, b, q) for lg, q in zip(range(2, 15), [Q_40_1, P1, Q_60_1,
                                                     P2, P_EXT] * 3)
     for b in (1, 3 + 2 * lg)]
    + [(4096, 1536, P1), (4096, 512, P2), (256, 2560, P_EXT),
       (256, 37, P_EXT), (16384, 300, Q_60_1), (1024, 17, Q_MAX),
       (16384, 3, Q_MAX), (4, 5, Q_MAX), (16384, 3, Q_F64_MAX),
       (4, 5, Q_F64_MAX), (1024, 17, Q_WIDE_MIN)]),
    ids=[f"n{1 << lg}_b{b}" for lg in range(2, 15) for b in (1, 3 + 2 * lg)]
    + ["n4096_p1_path", "n4096_p2_path_inverse", "n256_pext_path",
       "n256_pext_ragged", "n16384_more_than_resident", "n1024_qmax",
       "n16384_qmax", "n4_qmax", "n16384_f64_qmax", "n4_f64_qmax",
       "n1024_wide_qmin"])


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
                                       (8192, 2, Q_40_1)]
                         + [(n, b, q) for n, b in ((256, 37), (4096, 5),
                                                   (4096, 300), (8192, 3))
                            for q in (P1, P2, P_EXT)
                            if (n, q) != (256, P_EXT)]
                         + [(4, 7, P1), (16, 5, Q_F64_MAX)])
def test_ntt_negacyclic_mul_matches_plain(cuda_device, n, batch, q):
    """K8 in both forms (doubles below 2^46, Shoup above) at ragged
    batches, and at N=4096 over more pairs than resident blocks (264), so
    that a block prefetches its next pair."""
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
def test_ntt_kernels_refuse_a_modulus_above_2_62(cuda_device):
    """The prime just above the largest one the kernels take: refused on
    the card; the plain path still takes it."""
    pk = PallasNTT(NTTContext(1024, Q_ABOVE))
    a = random_planes(1024, 2, Q_ABOVE, cuda_device, 3)
    before = dict(PallasNTT.launches)
    for entry in (pk.forward, pk.inverse):
        with pytest.raises(ValueError, match="largest modulus"):
            entry(a)
    with pytest.raises(ValueError, match="largest modulus"):
        pk.negacyclic_mul(a, a)
    assert PallasNTT.launches == before
    assert same_planes(pk.ntt.inverse(pk.ntt.forward(a)), a)


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
    """A device MSM at n=256, inside the band where the Pippenger (K9 wide
    adds, the point kernel for the narrow ops) and the per-point ladders
    (the point kernel) race once: the race's winner, and each candidate,
    == the host backend on the same inputs."""
    c = zk_curve.bn254_g1(device=cuda_device)
    rng = np.random.default_rng(16)
    pts = c.fixed_base_mul([int(v) for v in rng.integers(1, 2 ** 30, 256)])
    sc = limbs.limbs_from_ints([int(v) for v in
                                rng.integers(0, 2 ** 62, 256)], 8,
                               cuda_device)
    disp, op = c.msm_race()
    winner = disp.selection_for(op, sc, pts)
    want = c.msm(sc, pts, backend="host")
    for name in ("pippenger", "ladder"):
        fn = {"pippenger": c._msm_pippenger_impl,
              "ladder": c._msm_ladder}[name]
        assert [int(v) for v in c.to_affine_ints(fn(sc, pts))[:2]] == \
            [int(v) for v in c.to_affine_ints(want)[:2]], name
    before = (_mul_t_raw.launches, pallas_field_mul.launches,
              pallas_jadd.launches, pallas_jdbl.launches)
    got = c.msm(sc, pts)
    # the narrow point ops are one point-kernel launch each, no single
    # products.  The Pippenger: K9, the Horner tail's 256 doubles and 33
    # adds, and the 5 adds of the scan over the 32 group totals (1024
    # points, below K9's 2048); the ladders: a scalar_mul at width 256
    # (14 table adds, 64 rounds of 4 doubles and an add), 8 tree adds
    assert pallas_field_mul.launches == before[1]
    adds, k9 = (33 + 5, True) if winner == "pippenger" \
        else (14 + 64 + 8, False)
    assert (_mul_t_raw.launches > before[0]) == k9
    assert (pallas_jadd.launches - before[2],
            pallas_jdbl.launches - before[3]) == (adds, 256)
    assert [int(v) for v in c.to_affine_ints(got)[:2]] == \
        [int(v) for v in c.to_affine_ints(want)[:2]]


def edge_points(curve, batch, seed):
    """(P, Q): points of ``curve`` from random scalars, with the edge rows
    of jadd_formula first: P[0] at infinity, Q[1] = P[1] (the doubling
    case), Q[2] = -P[2] (to infinity), Q[3] at infinity, P[4] and Q[4] both
    at infinity -- as many as the batch holds."""
    rng = np.random.default_rng(seed)
    ks = [int(v) for v in rng.integers(1, 1 << 62, 2 * batch)]
    P = [x.clone() for x in curve.fixed_base_mul(ks[:batch],
                                                 backend="host")]
    Q = [x.clone() for x in curve.fixed_base_mul(ks[batch:],
                                                 backend="host")]
    f = curve.fq
    rows = list(range(min(batch, 5)))
    for i in rows[1:3]:
        for c in range(3):
            Q[c][i] = P[c][i]
    if len(rows) > 2:
        Q[1][2] = f.neg(P[1][2])
    for c, i in ((P[2], 0), (Q[2], 3), (P[2], 4), (Q[2], 4)):
        if i < batch:
            c[i] = 0
    return tuple(P), tuple(Q)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 32, 1000, 2047])
@pytest.mark.parametrize("name", ["bn254_g1", "bls12_381_g1"])
def test_point_kernel_matches_plain(cuda_device, name, batch):
    """K10's point kernel (one launch a Jacobian add or double) == its plain
    version, the level-stacked formulas over Field.mul_plain, on curve
    points with the edge rows and on random canonical elements (the
    algebra alone), D=32 and D=48; one launch each."""
    curve = getattr(zk_curve, name)(device=cuda_device)
    f = curve.fq
    P, Q = edge_points(curve, batch, 17 + batch)
    R = tuple(random_elements(f, batch, cuda_device, 18 + i)
              for i in range(6))
    for p, q in ((P, Q), (R[:3], R[3:])):
        before = (pallas_jadd.launches, pallas_jdbl.launches,
                  pallas_field_mul.launches)
        add, dbl = pallas_jadd(f, p, q), pallas_jdbl(f, p)
        torch.cuda.synchronize()
        assert (pallas_jadd.launches, pallas_jdbl.launches,
                pallas_field_mul.launches) == (before[0] + 1,
                                               before[1] + 1, before[2])
        assert same_planes(add, jadd_reference(f, p, q))
        assert same_planes(dbl, jdbl_reference(f, p))
    # Curve.add/double below 2048 points take the point kernel
    before = pallas_jadd.launches
    assert same_planes(curve.add(P, Q), jadd_reference(f, P, Q))
    assert pallas_jadd.launches == before + 1
    # and == jadd_formula/jdbl_formula evaluated over the field on the CPU
    cpu = getattr(zk_curve, name)(device="cpu")
    Pc, Qc = tuple(x.cpu() for x in P), tuple(x.cpu() for x in Q)
    assert same_planes([x.cpu() for x in pallas_jadd(f, P, Q)],
                       cpu.add(Pc, Qc))
    assert same_planes([x.cpu() for x in pallas_jdbl(f, P)], cpu.double(Pc))


@pytest.mark.cuda
def test_point_kernel_broadcasts_and_refuses(cuda_device):
    """Operands broadcast (expanded on the host, one launch); a digit count
    other than the field's is refused."""
    curve = zk_curve.bn254_g1(device=cuda_device)
    f = curve.fq
    P, Q = edge_points(curve, 8, 19)
    q0 = tuple(x[5] for x in Q)
    got = pallas_jadd(f, P, q0)
    want = jadd_reference(f, P, tuple(x.expand_as(P[0]) for x in q0))
    assert same_planes(got, want)
    with pytest.raises(ValueError, match="digits"):
        pallas_jdbl(zk_curve.bls12_381_g1(device=cuda_device).fq, P)


# ---------------------------------------------------------------------------
# The BFV stack's ring on the card (core/poly.py PolyRing): K6/K7 over the
# auxiliary primes of RescaleMultiplier, K8 in its narrow (Q_40_1, N=1024)
# and wide (Q_60_1, N=8192) forms, each against the ring on the CPU
# ---------------------------------------------------------------------------

BFV_RINGS = [(1024, 1095216660481, 64), (8192, 1152921504606584833, 65537)]


def _bfv_aux_primes():
    from node_fhe_accelerate_tpu_torch.core.bfv_mul import aux_prime_chain
    return [(n, p) for n, q, _ in BFV_RINGS
            for p in aux_prime_chain(n, n.bit_length() + 2 * q.bit_length()
                                     + 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(n, q) for n, q, _ in BFV_RINGS],
                         ids=["ballot_q40_n1024", "simd_q60_n8192"])
def test_polyring_on_card_matches_cpu(cuda_device, n, q):
    from node_fhe_accelerate_tpu_torch.core.poly import PolyRing
    gpu, cpu = PolyRing(n, q, device=cuda_device), PolyRing(n, q,
                                                            device="cpu")
    a = random_planes(n, 2, q, cuda_device, 21)
    b = random_planes(n, 2, q, cuda_device, 22)
    ac, bc = tuple(x.cpu() for x in a), tuple(x.cpu() for x in b)
    before = dict(PallasNTT.launches)
    got = (gpu.multiply(a, b), gpu.to_ntt(a), gpu.from_ntt(a))
    torch.cuda.synchronize()
    assert {k: PallasNTT.launches[k] - before[k] for k in before} == \
        dict(forward=1, inverse=1, negacyclic_mul=1)
    want = (cpu.multiply(ac, bc), cpu.to_ntt(ac), cpu.from_ntt(ac))
    for g, w in zip(got, want):
        assert same_planes(tuple(x.cpu() for x in g), w)
    for op in ("add", "sub", "pointwise"):
        assert same_planes(tuple(x.cpu() for x in getattr(gpu, op)(a, b)),
                           getattr(cpu, op)(ac, bc))
    np.testing.assert_array_equal(
        u64_to_np(got[0])[0], negacyclic_mul_np(u64_to_np(a)[0],
                                                u64_to_np(b)[0], q))


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", _bfv_aux_primes())
def test_bfv_aux_prime_transforms_match_plain(cuda_device, n, p):
    """K6 on four rows and K7 on three, as RescaleMultiplier launches them
    per auxiliary prime (the wide, Shoup form: ~59-bit primes)."""
    pk = PallasNTT(NTTContext(n, p))
    a = random_planes(n, 4, p, cuda_device, 23)
    fa = pk.forward(a)
    assert same_planes(fa, pk.ntt.forward(a))
    back = pk.inverse(tuple(x[:3] for x in fa))
    assert same_planes(back, tuple(x[:3] for x in a))


@pytest.mark.cuda
def test_bfv_multiply_on_card_matches_cpu(cuda_device):
    """Keys, an encryption and multiply_relin_rescale at the ballot ring
    from one generator state on the card and on the CPU: equal ciphertexts,
    and the product decrypts to the negacyclic product mod t."""
    from node_fhe_accelerate_tpu_torch.core.encrypt import EncryptionEngine
    from node_fhe_accelerate_tpu_torch.core.keys import KeyManager
    from node_fhe_accelerate_tpu_torch.core.params import (FHEScheme,
                                                           ParameterSet)
    n, q, t = BFV_RINGS[0]
    p = ParameterSet(scheme=FHEScheme.BFV, poly_degree=n, moduli=[q],
                     lwe_dimension=0, lwe_noise_std=3.2, decomp_base_log=20,
                     decomp_level=3, plaintext_modulus=t)
    state = torch.Generator(device=cuda_device).manual_seed(3).get_state()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        g = torch.Generator(device=cuda_device)
        g.set_state(state)
        eng = EncryptionEngine(p, device=dev)
        km = KeyManager(p, eng.ring)
        sk = km.generate_secret_key(g)
        pk = km.generate_public_key(g, sk)
        rlk = km.generate_relin_key(g, sk)
        c1 = eng.encrypt(g, [3, 1], pk)
        c2 = eng.encrypt(g, [5, 2], pk)
        prod = eng.multiply_relin_rescale(c1, c2, rlk)
        out[dev.type] = (u64_to_np(prod.c0), u64_to_np(prod.c1),
                         eng.decrypt(prod, sk, 3)[0].tolist())
    for g, w in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(g, w)
    assert out["cuda"][2] == [15, 11, 2]


# ---------------------------------------------------------------------------
# The RNS chains of the public API on the card: K6/K7/K8 at the primes and
# degrees of BFV_128_SIMD (Q_60_1..3 and the seven ~59-bit auxiliary primes
# of its RnsRescaleMultiplier, N=8192) and of CKKS_128_ML (N=16384: K6/K7 over
# Q_60_1, Q_50_3, Q_50_2 in the wide form and Q_40_1, Q_40_2 in the narrow
# one); then the RNS engine, CKKS and u64_shl on the card against the CPU
# ---------------------------------------------------------------------------


def _simd_primes():
    from node_fhe_accelerate_tpu_torch.core.bfv_mul import aux_prime_chain
    from node_fhe_accelerate_tpu_torch.core.params import BFV_128_SIMD
    p = BFV_128_SIMD()
    Q = int(np.prod([int(q) for q in p.moduli], dtype=object))
    bound = p.poly_degree.bit_length() + 2 * Q.bit_length() + 2
    return list(p.moduli) + aux_prime_chain(p.poly_degree, bound,
                                            exclude=tuple(p.moduli))


def _ckks_primes():
    from node_fhe_accelerate_tpu_torch.core.params import CKKS_128_ML
    return list(CKKS_128_ML().moduli)


@pytest.mark.cuda
@pytest.mark.parametrize("q", _simd_primes())
def test_simd_chain_kernels_match_plain(cuda_device, q):
    """K6 on six rows and K7 on three (the forward of relinearize's stacked
    gadget products, the inverse of a tensor product), and K8 on six rows
    (relinearize's 2K products of one prime), at N=8192."""
    pk = PallasNTT(NTTContext(8192, q))
    a = random_planes(8192, 6, q, cuda_device, 31)
    b = random_planes(8192, 6, q, cuda_device, 32)
    fa = pk.forward(a)
    assert same_planes(fa, pk.ntt.forward(a))
    back = pk.inverse(tuple(x[:3] for x in fa))
    assert same_planes(back, tuple(x[:3] for x in a))
    assert same_planes(pk.negacyclic_mul(a, b), pk.ntt.negacyclic_mul(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("q", _ckks_primes())
def test_ckks_chain_transforms_match_plain(cuda_device, q):
    """K6 on four rows (a product's four operands) and K7 on three at
    N=16384, where the ring product is K6, the pointwise product and K7."""
    from node_fhe_accelerate_tpu_torch.core.poly import PolyRing
    pk = PallasNTT(NTTContext(16384, q))
    a = random_planes(16384, 4, q, cuda_device, 33)
    fa = pk.forward(a)
    assert same_planes(fa, pk.ntt.forward(a))
    assert same_planes(pk.inverse(tuple(x[:3] for x in fa)),
                       tuple(x[:3] for x in a))
    gpu, cpu = PolyRing(16384, q, cuda_device), PolyRing(16384, q, "cpu")
    x, y = tuple(v[:1] for v in a), tuple(v[1:2] for v in a)
    assert same_planes(tuple(v.cpu() for v in gpu.multiply(x, y)),
                       cpu.multiply(tuple(v.cpu() for v in x),
                                    tuple(v.cpu() for v in y)))


def _small_chain(bits=(30, 30, 29)):
    """NTT primes of the given sizes at N=1024, distinct."""
    from node_fhe_accelerate_tpu_torch.ops.primes import find_ntt_prime
    out = []
    for b in bits:
        below = min([q for q in out if q.bit_length() == b], default=None)
        out.append(find_ntt_prime(b, 1024, below=below))
    return out


@pytest.mark.cuda
def test_rns_engine_on_card_matches_cpu(cuda_device):
    """Keys, encryptions, multiply_relin and a 2-of-3 threshold decryption
    over a three-prime chain at N=1024 from one generator state on the card
    and on the CPU: equal residues, the product decrypts."""
    from node_fhe_accelerate_tpu_torch.api.engine import FHEEngine
    from node_fhe_accelerate_tpu_torch.core.params import (FHEScheme,
                                                           ParameterSet)
    p = ParameterSet(scheme=FHEScheme.BFV, poly_degree=1024,
                     moduli=_small_chain(), lwe_dimension=0,
                     lwe_noise_std=3.2, plaintext_modulus=257)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        fhe = FHEEngine(p, rng_seed=5, device=dev)
        fhe.gen = torch.Generator(device=cuda_device).manual_seed(5)
        sk = fhe.generate_secret_key()
        ek = fhe.generate_eval_key(sk)
        pk = fhe.generate_public_key(sk)
        a, b = fhe.encrypt_packed([3, 1], pk), fhe.encrypt_packed([5, 2], pk)
        before = dict(PallasNTT.launches)
        prod = fhe.multiply_relin(a, b, ek)
        launched = {k: PallasNTT.launches[k] - before[k] for k in before}
        tk = fhe.generate_threshold_keys(2, 3)
        ct = fhe.encrypt_value(200, fhe.generate_public_key(tk.master_sk))
        parts = [fhe.partial_decrypt(ct, s) for s in tk.shares[1:]]
        out[dev.type] = ([np.stack([u64_to_np(r) for r in poly])
                          for poly in (prod.c0, prod.c1)],
                         fhe.decrypt_packed(prod, sk, 3).tolist(),
                         int(fhe.combine_partial_decryptions(
                             ct, parts, 2).values[0]), launched)
    for g, w in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(g, w)
    assert out["cuda"][1:3] == out["cpu"][1:3] == ([15, 11, 2], 200)
    assert out["cuda"][3]["negacyclic_mul"] == 3     # relinearize, a prime
    assert out["cuda"][3]["forward"] > 0 and out["cuda"][3]["inverse"] > 0


@pytest.mark.cuda
def test_ckks_fused_on_card_matches_eager_and_cpu(cuda_device):
    """Keys, encryptions and the fused multiply_relin_rescale over a
    50/50/40-bit chain at N=1024, scale 2^40, from one generator state on the card and
    on the CPU: fused == eager on each, the card == the CPU, and the
    product decodes."""
    from node_fhe_accelerate_tpu_torch.core.ckks import CkksEngine
    from node_fhe_accelerate_tpu_torch.core.params import (FHEScheme,
                                                           ParameterSet)
    p = ParameterSet(scheme=FHEScheme.CKKS, poly_degree=1024,
                     moduli=_small_chain((50, 50, 40)), lwe_dimension=0,
                     lwe_noise_std=3.2, plaintext_modulus=0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng = CkksEngine(p, scale=1 << 40, device=dev)
        g = torch.Generator(device=cuda_device).manual_seed(9)
        sk = eng.generate_secret_key(g)
        pk = eng.generate_public_key(g, sk)
        rlks = eng.generate_relin_keys(g, sk)
        x, y = eng.encrypt(g, [1.5, -2.0], pk), eng.encrypt(g, [2.0, 0.5], pk)
        fused = eng.multiply_relin_rescale(x, y, rlks, fused=True)
        eager = eng.multiply_relin_rescale(x, y, rlks, fused=False)
        for f, e in zip(fused.c0 + fused.c1, eager.c0 + eager.c1):
            assert same_planes(f, e)
        out[dev.type] = (fused, eng.decrypt(fused, sk, 2))
    for f, e in zip(out["cuda"][0].c0 + out["cuda"][0].c1,
                    out["cpu"][0].c0 + out["cpu"][0].c1):
        assert same_planes(tuple(v.cpu() for v in f), e)
    np.testing.assert_allclose(out["cuda"][1], [3.0, -1.0], atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 63, 64, 70, 96, 100, 120])
def test_u64_shl_on_card_matches_cpu(cuda_device, k):
    """u64_shl on the card, shifts of 64 and more included (zero), equal
    to the CPU and to Python's (x << k) mod 2^64."""
    from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np, u64_shl
    x = np.random.default_rng(k).integers(0, 1 << 63, 256,
                                          dtype=np.uint64) * 2 + 1
    got = u64_to_np(u64_shl(u64_from_np(x, cuda_device), k))
    np.testing.assert_array_equal(got, u64_to_np(u64_shl(u64_from_np(x),
                                                         k)))
    want = np.array([(int(v) << k) % (1 << 64) for v in x], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def _g2_pairs(g2h, width):
    """width G2 point pairs with the group law's edge rows first (Q = P,
    Q = -P, P at infinity, Q at infinity), as host affine pairs."""
    from node_fhe_accelerate_tpu_torch.zk import pairing as pr
    p = g2h.fixed_base_affine_host(list(range(1, width + 1)))
    q = g2h.fixed_base_affine_host(list(range(width + 7, 2 * width + 7)))
    q[0], q[1] = p[0], pr.g2_neg(p[1])
    p[2], q[3] = None, None
    return p, q


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2048, 1000])
def test_k9_over_fq2_matches_plain(cuda_device, width):
    """K9 through ``_TField2`` (the digit-major G2 add and double of the G2
    MSM's 2048-point chunks) equals its plain version on the CPU, at 2048
    points and at a ragged width."""
    from node_fhe_accelerate_tpu_torch.zk.curve_g2 import bn254_g2
    g2c, g2h = bn254_g2(cuda_device), bn254_g2("cpu")
    p, q = _g2_pairs(g2h, width)
    P, Q = g2c.from_affine_pairs(p), g2c.from_affine_pairs(q)
    Pc, Qc = g2h.from_affine_pairs(p), g2h.from_affine_pairs(q)
    before = _mul_t_raw.launches
    add = pallas_jadd_t(g2c.fq, P, Q)
    dbl = pallas_jdbl_t(g2c.fq, P)
    torch.cuda.synchronize()
    assert _mul_t_raw.launches > before
    for got, want in ((add, pallas_jadd_t(g2h.fq, Pc, Qc)),
                      (dbl, pallas_jdbl_t(g2h.fq, Pc))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2048, 40])
def test_g2_add_double_on_card_match_cpu(cuda_device, width):
    """``G2Curve.add``/``double`` on the card (K9 over Fq2 at 2048 points,
    the formulas over Field2 with K10's product below) equal the CPU on
    both sides of 2048 points."""
    from node_fhe_accelerate_tpu_torch.zk.curve_g2 import bn254_g2
    g2c, g2h = bn254_g2(cuda_device), bn254_g2("cpu")
    p, q = _g2_pairs(g2h, width)
    P, Q = g2c.from_affine_pairs(p), g2c.from_affine_pairs(q)
    Pc, Qc = g2h.from_affine_pairs(p), g2h.from_affine_pairs(q)
    assert g2c._path(P, Q) == ("k9" if width >= 2048 else "formula")
    k10 = pallas_field_mul.launches
    for got, want in ((g2c.add(P, Q), g2h.add(Pc, Qc)),
                      (g2c.double(P), g2h.double(Pc))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    if width < 2048:
        assert pallas_field_mul.launches > k10


@pytest.mark.cuda
def test_fr_ntt_on_card_matches_cpu(cuda_device):
    """The Fr NTT at d = 4096 on the card (one launch of K10's product a
    stage) equals the port on the CPU: forward, inverse and
    negacyclic_mul."""
    from node_fhe_accelerate_tpu_torch.zk.fr_ntt import FrNtt
    d = 4096
    fg = FrNtt(zk_field.bn254_fr(cuda_device), d)
    fc = FrNtt(zk_field.bn254_fr("cpu"), d)
    rng = np.random.default_rng(4)
    vals = [int.from_bytes(rng.bytes(40), "little") % fg.f.q
            for _ in range(2 * d)]
    a, b = fg.f.encode(vals[:d]), fg.f.encode(vals[d:])
    ac, bc = fc.f.encode(vals[:d]), fc.f.encode(vals[d:])
    before = pallas_field_mul.launches
    fwd = fg.forward(a)
    assert pallas_field_mul.launches - before == fg.logd
    assert torch.equal(fwd.cpu(), fc.forward(ac))
    assert torch.equal(fg.inverse(fwd).cpu(), ac)
    assert torch.equal(fg.negacyclic_mul(a, b).cpu(),
                       fc.negacyclic_mul(ac, bc))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 8192])
def test_dist_ring_on_card_matches_cpu(cuda_device, n):
    """DistPolyRing.multiply and to_ntt over 4 positions on one card equal
    the same ring over 4 CPU positions and PolyRing.multiply (K8 on the
    card)."""
    from node_fhe_accelerate_tpu_torch.core.poly import PolyRing
    from node_fhe_accelerate_tpu_torch.parallel.dist_ring import DistPolyRing
    from node_fhe_accelerate_tpu_torch.parallel.mesh import make_mesh
    q = (1 << 40) - (1 << 32) + 1
    card = DistPolyRing(n, q, mesh=make_mesh(4, data=4,
                                             devices=[cuda_device] * 4))
    cpu = DistPolyRing(n, q, mesh=make_mesh(4, data=4, devices=["cpu"] * 4))
    rng = np.random.default_rng(n)
    a = rng.integers(0, q, (2, n), dtype=np.uint64)
    b = rng.integers(0, q, (2, n), dtype=np.uint64)
    got = card.multiply(card.from_np(a), card.from_np(b))
    assert got[0].device.type == "cuda"
    want = cpu.multiply(cpu.from_np(a), cpu.from_np(b))
    assert np.array_equal(u64_to_np(got), u64_to_np(want))
    single = PolyRing(n, q, cuda_device)
    assert np.array_equal(u64_to_np(got), u64_to_np(single.multiply(
        single.from_np(a), single.from_np(b))))
    assert np.array_equal(u64_to_np(card.to_ntt(card.from_np(a))),
                          u64_to_np(cpu.to_ntt(cpu.from_np(a))))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "auto"])
def test_sharded_pbs_on_card_matches_cpu(cuda_device, backend):
    """The sharded bootstrap over 4 positions on one card (the per-step
    kernel, the fused ladder, or "auto"'s race of the four) equals the
    unsharded one on the card and the plain "mxu" bootstrap on the CPU on
    the same key; the key is held once on the card, and "auto" builds its
    K-major slabs at most once for it."""
    from node_fhe_accelerate_tpu_torch.parallel.mesh import (gather,
                                                             make_mesh)
    from node_fhe_accelerate_tpu_torch.parallel.pbs import (
        replicate_bsk, sharded_bootstrap_fn)
    p = dataclasses.replace(SMALL, n_lwe=16, lwe_noise_std=0.0,
                            glwe_noise_std=0.0)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    eng = TfheEngine(p, ext_backend=backend, device=cuda_device)
    lwe_sk = eng.lwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, lwe_sk, eng.glwe_keygen(gen))
    msgs = torch.arange(64, device=cuda_device) % 2
    ct = eng.lwe_encrypt(gen, msgs, lwe_sk)
    tp = eng.default_test_poly()
    mesh = make_mesh(4, data=4, devices=[cuda_device] * 4)
    rep = replicate_bsk(bsk, mesh)
    assert list(rep.copies) == ["cuda:0"]
    out = gather(sharded_bootstrap_fn(eng, mesh)(ct, rep, tp))
    ref = eng.bootstrap_with_test_poly(ct, bsk, tp)
    assert torch.equal(out.a, ref.a) and torch.equal(out.b, ref.b)
    if backend == "auto":
        assert len(eng.dispatcher.selection_table()) == 2
        assert len(eng._kslabs) == ("mxu_fused" in
                                    eng.dispatcher.winners("pbs"))
    from node_fhe_accelerate_tpu_torch.core.bootstrap import LweCiphertext
    cpu = TfheEngine(p, ext_backend="mxu", device="cpu")
    bsk_c = dataclasses.replace(bsk, ksk_a=bsk.ksk_a.cpu(),
                                ksk_b=bsk.ksk_b.cpu(),
                                ggsw_i8=bsk.ggsw_i8.cpu())
    want = cpu.bootstrap_with_test_poly(
        LweCiphertext(a=ct.a.cpu(), b=ct.b.cpu()), bsk_c, tp.cpu())
    assert torch.equal(out.a.cpu(), want.a) and \
        torch.equal(out.b.cpu(), want.b)
    assert torch.equal(eng.lwe_decrypt(out, lwe_sk), msgs.to(torch.int32))
