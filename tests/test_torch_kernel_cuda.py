"""The Hopper CMux kernels (csrc/cmux_step.cu, cmux_step_slabs.cu,
ladder_tiles.cu, ladder_steps.cu) vs their plain PyTorch versions on the
card.  Needs a CUDA device and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine with a card and no
JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernel_cuda.py

Inputs are random from a seeded torch.Generator.  Tolerance: exact
equality -- every value is an integer mod 2^32."""
import dataclasses

import pytest
import torch

from node_fhe_accelerate_tpu_torch.core.bootstrap import (
    TFHE_BOOT_128_K4, TFHE_BOOT_128_L2, TfheEngine, TfheParams)
from node_fhe_accelerate_tpu_torch.ops.cmux import (
    build_all_step_slabs, build_diag_slabs, cmux_step, cmux_step_reference,
    cmux_step_slabs, cmux_step_slabs_reference)
from node_fhe_accelerate_tpu_torch.ops.ladder import (
    blind_rotate_fused, blind_rotate_fused_reference,
    blind_rotate_fused_steps, blind_rotate_fused_steps_reference)

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
    rots[0, :6] = torch.tensor([0, n, 2 * n - 1, -1, -n - 5, 9 * n + 3])
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
@pytest.mark.parametrize("drop", [0, 1])
@pytest.mark.parametrize("p,batch", **SHAPES)
def test_ladder_steps_matches_plain(cuda_device, p, batch, drop):
    acc, rots, g = random_ladder(p, batch, cuda_device, 9, steps=5,
                                 drop=drop)
    slabs = build_all_step_slabs(g)
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
    """A batch of more 32-row tiles than the card has resident blocks: the
    persistent kernel loops over tiles."""
    p = SMALL
    acc, rots, g = random_ladder(p, 32 * 300 + 5, cuda_device, 10, steps=3)
    want = blind_rotate_fused_reference(acc, rots, g, p.pbs_base_log)
    got = blind_rotate_fused_steps(acc, rots, build_all_step_slabs(g),
                                   p.pbs_base_log)
    assert torch.equal(got, want)
    assert torch.equal(blind_rotate_fused(acc, rots, g, p.pbs_base_log),
                       want)


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
