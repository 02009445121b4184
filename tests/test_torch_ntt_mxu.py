"""The port's matrix NTT (node_fhe_accelerate_tpu_torch/ops/ntt_mxu.py)
against the JAX package's MxuNTT and the scalar 4-step oracle, on the CPU.

Shapes: N=64 with n1=8 (tests/test_ntt_mxu.py's) and N=1024 with n1=32 on a
batch.  Inputs are random 56-bit values from numpy with a seed.  Tolerance:
exact equality of every output digit (the JAX outputs) and of every residue
mod P_MXU (the oracle)."""
import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.ops import ntt_mxu as jmx
from node_fhe_accelerate_tpu_torch.ops.ntt_mxu import D, P_MXU, MxuNTT

torch.set_num_threads(2)


def oracle(mx: MxuNTT, a_ints, ks) -> list:
    """Twisted cyclic DFT with the 4-step (k2*n1 + k1) ordering, at the
    output positions ks."""
    p = P_MXU
    at = [int(x) * pow(mx.psi, j, p) % p for j, x in enumerate(a_ints)]
    out = []
    for k in ks:
        kk = k % mx.n1 + mx.n1 * (k // mx.n1)
        out.append(sum(v * pow(mx.omega, kk * j, p)
                       for j, v in enumerate(at)) % p)
    return out


def random_values(shape, seed):
    raw = np.random.default_rng(seed).integers(0, 1 << 56, shape,
                                               dtype=np.uint64)
    return np.vectorize(lambda v: int(v) % P_MXU, otypes=[object])(raw)


@pytest.mark.parametrize("n,n1,batch", [(64, 8, ()), (64, 8, (3,)),
                                        (1024, 32, (2,))])
def test_forward_matches_jax(n, n1, batch):
    a = random_values(batch + (n,), n)
    mx, jx = MxuNTT(n, n1=n1), jmx.MxuNTT(n, n1=n1)
    assert (mx.psi, mx.omega) == (jx.psi, jx.omega)
    got = mx.forward_negacyclic(mx.to_digits_host(a))
    assert got.dtype == torch.int32 and got.shape == batch + (n, D)
    want = np.asarray(jax.jit(jx.forward_negacyclic)(jx.to_digits_host(a)))
    np.testing.assert_array_equal(got.numpy(), want)
    vals = mx.digits_to_ints(got)
    flat_a = a.reshape(-1, n)
    flat_v = vals.reshape(-1, n)
    ks = list(range(n)) if n <= 64 else list(range(0, n, 97))
    for row in range(flat_a.shape[0]):
        want_k = oracle(mx, flat_a[row], ks)
        assert [int(flat_v[row, k]) % P_MXU for k in ks] == want_k
