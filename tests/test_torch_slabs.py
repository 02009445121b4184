"""The port's Toeplitz weight expansion and its CMux step against prepared
diagonal slabs (ops/cmux.py) vs the JAX package (ops/pallas_cmux.py): the
``build_*`` functions array for array, the step against
``cmux_step_pallas`` in interpret mode, as tests/test_pallas_cmux.py runs
it on the CPU.  On the CPU the port's wrapper takes its plain version,
which contracts against the slabs it is given.  Inputs come from a numpy
seed and go through both packages.  Tolerance: exact equality -- every value is an integer mod 2^32."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from node_fhe_accelerate_tpu.ops import pallas_cmux as jx
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32, u32_to_tensor
from node_fhe_accelerate_tpu_torch.ops import cmux

torch.set_num_threads(2)

BASE_LOG, LVL = 7, 3        # the shapes of tests/test_pallas_cmux.py


def random_planes(seed, n, lvl=LVL, kp1=2, planes=4, steps=None):
    """int8 digit planes (steps, lvl, k+1, k+1, P, 2N) of a random key."""
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    return rng.integers(-128, 128, lead + (lvl, kp1, kp1, planes, 2 * n)) \
        .astype(np.int8)


def doubled(g):
    return np.concatenate([g, g], axis=-1)


@pytest.mark.parametrize("name", ["build_diag_tiles", "build_diag_slabs",
                                  "build_rt_slabs"])
@pytest.mark.parametrize("n,kp1,planes", [(256, 2, 4), (512, 3, 3)],
                         ids=["N256", "N512_k2_P3"])
def test_row_expansion_matches_jax(name, n, kp1, planes):
    ghat2 = doubled(random_planes(1, n, lvl=2, kp1=kp1, planes=planes))
    want = np.asarray(getattr(jx, name)(jnp.asarray(ghat2)))
    got = getattr(cmux, name)(torch.from_numpy(ghat2))
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["build_all_step_tiles",
                                  "build_all_step_slabs"])
def test_all_step_expansion_matches_jax(name):
    g = random_planes(2, 256, steps=3, planes=3)
    want = np.asarray(getattr(jx, name)(jnp.asarray(g)))
    got = getattr(cmux, name)(torch.from_numpy(g))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_expansion_rejects_degree_not_multiple_of_128():
    g = torch.from_numpy(random_planes(3, 64))
    with pytest.raises(ValueError):
        cmux.build_diag_slabs(torch.cat([g, g], dim=-1))
    with pytest.raises(ValueError):
        cmux.build_all_step_slabs(g[None])


@pytest.fixture(scope="module")
def step_inputs():
    """acc, rot (with the edge rotations), one key row and its diagonal
    slabs, as numpy; batch 8, N=256, k=1."""
    n = 256
    rng = np.random.default_rng(4)
    acc = rng.integers(0, 1 << 32, (8, 2, n), dtype=np.uint64) \
        .astype(np.uint32)
    rot = rng.integers(-4 * n, 4 * n, 8).astype(np.int32)
    rot[:6] = [0, n, 2 * n - 1, -1, -n - 5, 9 * n + 3]
    g = random_planes(5, n)
    slabs = cmux.build_diag_slabs(torch.from_numpy(doubled(g)))
    return acc, rot, g, slabs


@pytest.fixture(scope="module")
def jax_v1(step_inputs):
    acc, rot, g, _ = step_inputs
    return np.asarray(jx.cmux_step_pallas(
        jnp.asarray(acc), jnp.asarray(rot), jnp.asarray(doubled(g)),
        BASE_LOG, interpret=True))


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_cmux_step_slabs_matches_pallas(step_inputs, jax_v1, variant):
    """The port's step on the slabs vs the same variant of the Pallas kernel
    (interpret mode), and vs the default variant's output."""
    acc, rot, g, slabs = step_inputs
    want = np.asarray(jx.cmux_step_pallas(
        jnp.asarray(acc), jnp.asarray(rot), jnp.asarray(doubled(g)),
        BASE_LOG, interpret=True, variant=variant))
    got = cmux.cmux_step_slabs(u32_to_tensor(acc, "cpu"),
                               torch.from_numpy(rot), slabs, BASE_LOG,
                               variant=variant)
    np.testing.assert_array_equal(tensor_to_u32(got), want)
    np.testing.assert_array_equal(want, jax_v1)


def test_cmux_step_slabs_equals_cmux_step(step_inputs):
    acc, rot, g, slabs = step_inputs
    a, r = u32_to_tensor(acc, "cpu"), torch.from_numpy(rot)
    want = cmux.cmux_step(a, r, torch.from_numpy(g), BASE_LOG)
    assert torch.equal(cmux.cmux_step_slabs(a, r, slabs, BASE_LOG), want)


def test_cmux_step_slabs_sees_a_wrong_layout(step_inputs, jax_v1):
    """The plain version contracts against the slabs it is given: slabs in
    another order give another result."""
    acc, rot, _, slabs = step_inputs
    got = cmux.cmux_step_slabs(u32_to_tensor(acc, "cpu"),
                               torch.from_numpy(rot),
                               slabs.flip(0).contiguous(), BASE_LOG)
    assert not np.array_equal(tensor_to_u32(got), jax_v1)


def test_cmux_step_slabs_rejects_bad_inputs(step_inputs):
    acc, rot, _, slabs = step_inputs
    a, r = u32_to_tensor(acc, "cpu"), torch.from_numpy(rot)
    with pytest.raises(ValueError):
        cmux.cmux_step_slabs(a, r, slabs, BASE_LOG, variant="v1")
    with pytest.raises(ValueError):
        cmux.cmux_step_slabs(a, r, slabs[:2], BASE_LOG)
    with pytest.raises(ValueError):
        cmux.cmux_step_slabs(a, r, slabs.to(torch.int32), BASE_LOG)
    with pytest.raises(ValueError):
        cmux.cmux_step_slabs(a, r[:3], slabs, BASE_LOG)
    with pytest.raises(ValueError):
        cmux.cmux_step_slabs(a, r, slabs, 9)


def test_empty_batch_returns_empty_without_a_launch(step_inputs):
    acc, rot, g, slabs = step_inputs
    a, r = u32_to_tensor(acc[:0], "cpu"), torch.from_numpy(rot[:0])
    before = (cmux.cmux_step.launches, dict(cmux.cmux_step_slabs.launches))
    assert cmux.cmux_step(a, r, torch.from_numpy(g), BASE_LOG).shape == a.shape
    assert cmux.cmux_step_slabs(a, r, slabs, BASE_LOG).shape == a.shape
    assert before == (cmux.cmux_step.launches, cmux.cmux_step_slabs.launches)
