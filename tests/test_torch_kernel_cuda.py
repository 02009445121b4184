"""The Hopper CMux kernel (csrc/cmux_step.cu) vs its plain PyTorch version
on the card.  Needs a CUDA device and skips without one.  The file imports
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
    cmux_step, cmux_step_reference)

torch.set_num_threads(2)

SMALL = TfheParams(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
                   pbs_level=3, ks_base_log=4, ks_level=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def random_step(p, batch, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    eng = TfheEngine(dataclasses.replace(p, n_lwe=1), device=dev)
    row = eng.generate_bootstrap_key(gen, eng.lwe_keygen(gen),
                                     eng.glwe_keygen(gen)).ggsw_i8[0]
    n = p.poly_degree
    acc = torch.randint(-(1 << 31), 1 << 31,
                        (batch, p.glwe_dim + 1, n), generator=gen,
                        dtype=torch.int64, device=dev).to(torch.int32)
    rot = torch.randint(-4 * n, 4 * n, (batch,), generator=gen,
                        dtype=torch.int32, device=dev)
    rot[:6] = torch.tensor([0, n, 2 * n - 1, -1, -n - 5, 9 * n + 3])
    return acc, rot, row


@pytest.mark.cuda
@pytest.mark.parametrize("p,batch", [(SMALL, 100), (TFHE_BOOT_128_K4(), 77),
                                     (TFHE_BOOT_128_L2(), 40)],
                         ids=["k1_l3_ragged", "k4_ragged", "l2_n1024"])
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
