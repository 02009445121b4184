"""The port's whole-ladder blind rotate (ops/ladder.py) vs the JAX package's
fused Pallas kernels ``blind_rotate_fused`` and ``blind_rotate_fused_steps``
in interpret mode, as tests/test_pallas_cmux.py runs them on the CPU.  On
the CPU the port's wrappers take their plain versions; the steps-outer one
contracts against the K-major slabs it is given, which the tests make from
the key rows (``build_all_step_kslabs``; tests/test_torch_slabs.py holds
that form equal to the JAX slabs rearranged).  Inputs come from a numpy
seed and
go through both packages (shapes of tests/test_pallas_cmux.py: 8 steps,
N=256, k=1, lvl=3, batch 8).  Tolerance: exact equality -- every value is
an integer mod 2^32."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from node_fhe_accelerate_tpu.ops import pallas_cmux as jx
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32, u32_to_tensor
from node_fhe_accelerate_tpu_torch.ops import cmux, ladder

torch.set_num_threads(2)

BASE_LOG, LVL, STEPS, N, KP1, BATCH = 7, 3, 8, 256, 2, 8


def make_inputs(seed, planes):
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << 32, (BATCH, KP1, N), dtype=np.uint64) \
        .astype(np.uint32)
    rots = rng.integers(-4 * N, 4 * N, (STEPS, BATCH)).astype(np.int32)
    rots[0, :6] = [0, N, 2 * N - 1, -1, -N - 5, 9 * N + 3]
    g = rng.integers(-128, 128, (STEPS, LVL, KP1, KP1, planes, 2 * N)) \
        .astype(np.int8)
    return acc, rots, g


@pytest.fixture(scope="module")
def full():
    """Inputs with all 4 digit planes, the K-major slabs the port's ladder
    takes and the JAX steps-outer result on the reference slabs."""
    acc, rots, g = make_inputs(0, 4)
    ref = cmux.build_all_step_slabs(torch.from_numpy(g))
    want = np.asarray(jx.blind_rotate_fused_steps(
        jnp.asarray(acc), jnp.asarray(rots), jnp.asarray(ref.numpy()),
        BASE_LOG, interpret=True))
    return acc, rots, g, cmux.build_all_step_kslabs(torch.from_numpy(g)), \
        want


def port_args(acc, rots):
    return u32_to_tensor(acc, "cpu"), torch.from_numpy(rots)


def test_fused_steps_matches_pallas(full):
    acc, rots, _, slabs, want = full
    got = ladder.blind_rotate_fused_steps(*port_args(acc, rots), slabs,
                                          BASE_LOG)
    np.testing.assert_array_equal(tensor_to_u32(got), want)


def test_fused_steps_truncated_key_matches_pallas():
    """drop=1: three planes, plane p weighted 256^(p+1)."""
    acc, rots, g = make_inputs(1, 3)
    ref = cmux.build_all_step_slabs(torch.from_numpy(g))
    want = np.asarray(jx.blind_rotate_fused_steps(
        jnp.asarray(acc), jnp.asarray(rots), jnp.asarray(ref.numpy()),
        BASE_LOG, drop=1, interpret=True))
    slabs = cmux.build_all_step_kslabs(torch.from_numpy(g))
    got = ladder.blind_rotate_fused_steps(*port_args(acc, rots), slabs,
                                          BASE_LOG, drop=1)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    undropped = ladder.blind_rotate_fused_steps(*port_args(acc, rots), slabs,
                                                BASE_LOG)
    assert not np.array_equal(tensor_to_u32(undropped), want)


def test_fused_matches_pallas(full):
    acc, rots, g, _, want_steps = full
    want = np.asarray(jx.blind_rotate_fused(
        jnp.asarray(acc), jnp.asarray(rots), jnp.asarray(g), BASE_LOG,
        interpret=True))
    got = ladder.blind_rotate_fused(*port_args(acc, rots),
                                    torch.from_numpy(g), BASE_LOG)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    np.testing.assert_array_equal(want, want_steps)


def test_ladders_equal_the_step_by_step_ladder(full):
    acc, rots, g, slabs, want = full
    a, r = port_args(acc, rots)
    for s in range(STEPS):
        a = cmux.cmux_step(a, r[s], torch.from_numpy(g[s]), BASE_LOG)
    np.testing.assert_array_equal(tensor_to_u32(a), want)


def test_ladders_flatten_leading_axes(full):
    acc, rots, g, slabs, want = full
    a, r = port_args(acc.reshape(2, 4, KP1, N), rots.reshape(STEPS, 2, 4))
    for got in (ladder.blind_rotate_fused_steps(a, r, slabs, BASE_LOG),
                ladder.blind_rotate_fused(a, r, torch.from_numpy(g),
                                          BASE_LOG)):
        assert got.shape == a.shape
        np.testing.assert_array_equal(
            tensor_to_u32(got).reshape(BATCH, KP1, N), want)


def test_fused_steps_sees_a_wrong_layout(full):
    acc, rots, g, slabs, want = full
    for wrong in (slabs.flip(1), slabs.flip(2),
                  cmux.build_all_step_slabs(torch.from_numpy(g))
                  .reshape(slabs.shape)):
        got = ladder.blind_rotate_fused_steps(*port_args(acc, rots),
                                              wrong.contiguous(), BASE_LOG)
        assert not np.array_equal(tensor_to_u32(got), want)


def test_ladders_reject_bad_inputs(full):
    acc, rots, g, slabs, _ = full
    a, r = port_args(acc, rots)
    gt = torch.from_numpy(g)
    with pytest.raises(ValueError):
        ladder.blind_rotate_fused(a, r[:3], gt, BASE_LOG)
    with pytest.raises(ValueError):
        ladder.blind_rotate_fused(a, r, gt[:, :, :1], BASE_LOG)
    with pytest.raises(ValueError):
        ladder.blind_rotate_fused(a, r.to(torch.int64), gt, BASE_LOG)
    with pytest.raises(ValueError):
        ladder.blind_rotate_fused_steps(a, r, slabs[:, :1], BASE_LOG)
    with pytest.raises(ValueError):
        ladder.blind_rotate_fused_steps(a, r, slabs, BASE_LOG, drop=1)
    with pytest.raises(ValueError):
        ladder.blind_rotate_fused_steps(a, r, slabs.to(torch.int16),
                                        BASE_LOG)
    with pytest.raises(ValueError):     # the reference layout, not the form
        ladder.blind_rotate_fused_steps(
            a, r, cmux.build_all_step_slabs(gt), BASE_LOG)


def test_empty_batch_returns_empty_without_a_launch(full):
    acc, rots, g, slabs, _ = full
    a, r = port_args(acc[:0], rots[:, :0])
    before = (ladder.blind_rotate_fused.launches,
              ladder.blind_rotate_fused_steps.launches)
    assert ladder.blind_rotate_fused(a, r, torch.from_numpy(g),
                                     BASE_LOG).shape == a.shape
    assert ladder.blind_rotate_fused_steps(a, r, slabs,
                                           BASE_LOG).shape == a.shape
    assert before == (ladder.blind_rotate_fused.launches,
                      ladder.blind_rotate_fused_steps.launches)



@pytest.mark.parametrize("steps", [0, 1])
def test_ladders_at_zero_and_one_step(full, steps):
    """No step returns acc; one step is one CMux step, in both ladders (the
    card tests hold the kernels to the same counts)."""
    acc, rots, g, slabs, _ = full
    a, r = port_args(acc, rots[:steps])
    gt = torch.from_numpy(g[:steps])
    want = cmux.cmux_step(a, r[0], gt[0], BASE_LOG) if steps else a
    for got in (ladder.blind_rotate_fused(a, r, gt, BASE_LOG),
                ladder.blind_rotate_fused_steps(a, r, slabs[:steps],
                                                BASE_LOG)):
        assert got.shape == a.shape
        assert torch.equal(got, want)
