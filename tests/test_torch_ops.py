"""PyTorch port vs the JAX package: uint32 helpers, ops/i8, torus rotate,
decompose and multiply, device selection, and the port's independence from
JAX.  Inputs come from numpy with fixed seeds and go through both packages.
Tolerance: exact equality -- every value is an integer mod 2^32."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from node_fhe_accelerate_tpu.core.torus import TorusRing as JaxRing
from node_fhe_accelerate_tpu.ops import i8 as jax_i8
from node_fhe_accelerate_tpu_torch.core.torus import TorusRing
from node_fhe_accelerate_tpu_torch.device import (
    resolve_device, tensor_to_u32, u32_to_tensor)
from node_fhe_accelerate_tpu_torch.ops import i8
from node_fhe_accelerate_tpu_torch.ops.u32 import lshr, matmul_mod32, uge

torch.set_num_threads(2)

N = 256
EDGES = np.array([0, 1, 0x7F, 0x80, 0xFF, 0x100, 0x7FFF, 0x8000,
                  0x7F7F7F7F, 0x80808080, 0x7FFFFFFF, 0x80000000,
                  0x80000001, 0xFFFFFF80, 0xFFFFFFFF], dtype=np.uint32)


def u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def t(x):
    return u32_to_tensor(x, "cpu")


@pytest.mark.parametrize("s", [0, 1, 7, 8, 16, 24, 31])
def test_lshr_matches_uint32(s):
    x = np.concatenate([EDGES, u32(np.random.default_rng(s), 64)])
    np.testing.assert_array_equal(tensor_to_u32(lshr(t(x), s)), x >> s)


def test_uge_matches_uint32():
    rng = np.random.default_rng(1)
    x = np.concatenate([EDGES, u32(rng, 64)])
    y = np.concatenate([EDGES[::-1], u32(rng, 64)])
    np.testing.assert_array_equal(uge(t(x), t(y)).numpy(), x >= y)
    for c in (0, 0x80, 0x80000000, 0xFFFFFFFF):
        np.testing.assert_array_equal(uge(t(x), c).numpy(), x >= c)


def test_matmul_mod32_exact_and_bounded():
    rng = np.random.default_rng(2)
    a = u32(rng, (5, 64))
    s = rng.integers(0, 2, (64, 3)).astype(np.uint32)
    want = (a.astype(np.uint64) @ s.astype(np.uint64)) % (1 << 32)
    got = matmul_mod32(t(a), torch.from_numpy(s.astype(np.int32)), 6 + 31)
    np.testing.assert_array_equal(tensor_to_u32(got), want.astype(np.uint32))
    with pytest.raises(ValueError):
        matmul_mod32(t(a), torch.from_numpy(s.astype(np.int32)), 53)


def test_u32_to_i8_digits_matches_jax():
    x = np.concatenate([EDGES, u32(np.random.default_rng(3), 200)])
    want = np.asarray(jax_i8.u32_to_i8_digits(jnp.asarray(x)))
    got = i8.u32_to_i8_digits(t(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_i8_digit_planes_to_u32_matches_jax():
    rng = np.random.default_rng(4)
    parts = rng.integers(-(1 << 30), 1 << 30, (50, 4)).astype(np.int32)
    want = np.asarray(jax_i8.i8_digit_planes_to_u32(jnp.asarray(parts)))
    got = i8.i8_digit_planes_to_u32(torch.from_numpy(parts))
    np.testing.assert_array_equal(tensor_to_u32(got), want)


def test_toeplitz_and_roll_match_jax():
    n = 32
    rng = np.random.default_rng(5)
    idx = i8.negacyclic_toeplitz_idx(n)
    np.testing.assert_array_equal(idx, jax_i8.negacyclic_toeplitz_idx(n))
    ghat = rng.integers(-128, 128, (2, 2 * n, 4)).astype(np.int8)
    want = np.asarray(jax_i8.toeplitz_from_doubled(jnp.asarray(ghat), idx))
    got = i8.toeplitz_from_doubled(torch.from_numpy(ghat), idx).numpy()
    np.testing.assert_array_equal(got, want)
    for s in (0, 1, 5, 2 * n - 1):
        np.testing.assert_array_equal(
            i8.roll_last(torch.from_numpy(ghat), s).numpy(),
            np.asarray(jax_i8.roll_last(jnp.asarray(ghat), s)))


@pytest.fixture(scope="module")
def rings():
    return TorusRing(N), JaxRing(N)


def test_rotate_matches_jax(rings):
    ring, jring = rings
    rng = np.random.default_rng(6)
    rots = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1, 2 * N, -1, -N,
                     -2 * N + 1, -5 * N - 3, 7 * N + 11, 17, -17],
                    dtype=np.int32)
    a = u32(rng, (len(rots), 2, N))
    want = np.asarray(jring.rotate(jnp.asarray(a),
                                   jnp.asarray(rots)[:, None]))
    got = ring.rotate(t(a), torch.from_numpy(rots)[:, None])
    np.testing.assert_array_equal(tensor_to_u32(got), want)


@pytest.mark.parametrize("base_log,level", [(7, 3), (8, 2), (2, 8), (4, 8)])
def test_decompose_matches_jax(rings, base_log, level):
    ring, jring = rings
    total = base_log * level
    low = 32 - total
    # digit-carry edges: values at and around each rounding boundary and
    # each balanced-digit threshold (d == B/2 carries into the next level)
    edges = []
    for l in range(level):
        w = 1 << (32 - (l + 1) * base_log)
        for d in ((1 << (base_log - 1)) - 1, 1 << (base_log - 1),
                  (1 << base_log) - 1):
            for off in (-(1 << max(low - 1, 0)) - 1, -(1 << max(low - 1, 0)),
                        0, (1 << max(low - 1, 0)) - 1, 1 << max(low - 1, 0)):
                edges.append((d * w + off) % (1 << 32))
    x = np.concatenate([EDGES, np.array(edges, dtype=np.uint64)
                        .astype(np.uint32),
                        u32(np.random.default_rng(total), 300)])
    want = np.asarray(jring.decompose(jnp.asarray(x), base_log, level))
    got = ring.decompose(t(x), base_log, level).numpy()
    np.testing.assert_array_equal(got, want)


def test_add_sub_neg_wrap(rings):
    ring, _ = rings
    rng = np.random.default_rng(7)
    a, b = u32(rng, 64), u32(rng, 64)
    np.testing.assert_array_equal(tensor_to_u32(ring.add(t(a), t(b))), a + b)
    np.testing.assert_array_equal(tensor_to_u32(ring.sub(t(a), t(b))), a - b)
    np.testing.assert_array_equal(tensor_to_u32(ring.neg(t(a))),
                                  np.uint32(0) - a)
    np.testing.assert_array_equal(
        tensor_to_u32(ring._roll_neg(t(a.reshape(2, 32)), 5)),
        np.concatenate([np.uint32(0) - a.reshape(2, 32)[:, -5:],
                        a.reshape(2, 32)[:, :-5]], axis=1))


def test_multiply_by_binary_matches_schoolbook():
    """Against a numpy schoolbook negacyclic product (uint64 wraps mod
    2^64, a multiple of 2^32; the JAX CRT multiply takes ~20 s eagerly)."""
    n = 64
    ring = TorusRing(n)
    rng = np.random.default_rng(8)
    a = u32(rng, (3, n))
    s = rng.integers(0, 2, n).astype(np.uint32)
    want = np.zeros((3, n), dtype=np.uint64)
    for c in range(n):
        for r in range(n):
            term = a[:, c].astype(np.uint64) * np.uint64(s[(r - c) % n])
            want[:, r] += term if r >= c else np.uint64(0) - term
    want = (want % (1 << 32)).astype(np.uint32)
    got = ring.multiply(t(a), torch.from_numpy(s.astype(np.int32)))
    np.testing.assert_array_equal(tensor_to_u32(got), want)


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_port_imports_without_jax():
    """The port never imports JAX or the JAX package: with both blocked in
    sys.modules, importing every port module still succeeds."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jax.numpy', 'node_fhe_accelerate_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import node_fhe_accelerate_tpu_torch\n"
        "import node_fhe_accelerate_tpu_torch.convert\n"
        "import node_fhe_accelerate_tpu_torch.core.keycache\n"
        "import node_fhe_accelerate_tpu_torch.ops.cmux\n"
        "import node_fhe_accelerate_tpu_torch.ops.ladder\n"
        "import node_fhe_accelerate_tpu_torch.core.params\n"
        "import node_fhe_accelerate_tpu_torch.ops.primes\n"
        "import node_fhe_accelerate_tpu_torch.ops.u64\n"
        "import node_fhe_accelerate_tpu_torch.ops.modular\n"
        "import node_fhe_accelerate_tpu_torch.ops.ntt\n"
        "import node_fhe_accelerate_tpu_torch.ops.ref_compat\n"
        "import node_fhe_accelerate_tpu_torch.ops.ntt_pallas\n"
        "import node_fhe_accelerate_tpu_torch.ops.limbs\n"
        "import node_fhe_accelerate_tpu_torch.ops.digits\n"
        "import node_fhe_accelerate_tpu_torch.ops.digits_pallas\n"
        "import node_fhe_accelerate_tpu_torch.zk.field\n"
        "import node_fhe_accelerate_tpu_torch.zk.field2\n"
        "import node_fhe_accelerate_tpu_torch.zk.curve\n"
        "import node_fhe_accelerate_tpu_torch.zk.rand\n"
        "import node_fhe_accelerate_tpu_torch.zk.hashes\n"
        "import node_fhe_accelerate_tpu_torch.zk.bulletproofs\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', "
        "'node_fhe_accelerate_tpu.')) for k, v in sys.modules.items() "
        "if v is not None)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
