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


# The K-major slab form of the steps-outer ladder kernel

def kmajor_from_jax_slabs(s, kp1, planes):
    """The K-major form from the JAX package's rt-major slabs, by numpy
    alone: (steps, rt, K, jp, p, r' = (h, q, w)) -> rows
    (jp, 2 rt + h, q, p, w), columns K."""
    steps, nt, kdim, _ = s.shape
    x = s.reshape(steps, nt, kdim, kp1, planes, 2, 8, 8)
    x = np.transpose(x, (0, 3, 1, 5, 6, 4, 7, 2))
    return x.reshape(steps, kp1 * planes * nt * 128, kdim)


@pytest.mark.parametrize("n,kp1,planes", [(256, 2, 4), (256, 5, 3),
                                          (512, 3, 3)],
                         ids=["N256", "N256_k4_P3", "N512_k2_P3"])
def test_kmajor_form_is_jax_slabs_rearranged(n, kp1, planes):
    g = random_planes(6, n, lvl=2, kp1=kp1, planes=planes, steps=2)
    jax_slabs = np.asarray(jx.build_all_step_slabs(jnp.asarray(g)))
    want = kmajor_from_jax_slabs(jax_slabs, kp1, planes)
    got = cmux.build_all_step_kslabs(torch.from_numpy(g))
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmajor_form_is_the_toeplitz_of_the_key_rows():
    """Entry by entry against the key rows ggsw_i8: row
    ((jp N/64 + b) 8 + q) 8P + 8p + w, column (l (k+1) + j) N + c holds
    g[s, l, j, jp, p, (64b + 8q + w - c) mod 2N]."""
    n, kp1, lvl, planes = 256, 2, 3, 4
    g = random_planes(7, n, lvl=lvl, kp1=kp1, planes=planes, steps=2)
    got = cmux.build_all_step_kslabs(torch.from_numpy(g)).numpy()
    s, row, col = np.meshgrid(np.arange(2), np.arange(kp1 * planes * n),
                              np.arange(lvl * kp1 * n), indexing="ij")
    jp, rest = np.divmod(row, planes * n)
    b, rest = np.divmod(rest, 64 * planes)
    q, rest = np.divmod(rest, 8 * planes)
    p, w = np.divmod(rest, 8)
    lj, c = np.divmod(col, n)
    l, j = np.divmod(lj, kp1)
    np.testing.assert_array_equal(
        got, g[s, l, j, jp, p, (64 * b + 8 * q + w - c) % (2 * n)])


def test_prepare_bsk_builds_the_form_once(monkeypatch):
    """prepare_bsk(form="slabs") builds the K-major form once per key, from
    the key rows, also when the key carries reference slabs; it is
    idempotent, and the "mxu_fused" ladder on a prepared key builds
    nothing."""
    from node_fhe_accelerate_tpu_torch.core import bootstrap as bt
    p = bt.TfheParams(n_lwe=2, poly_degree=256, glwe_dim=1, pbs_base_log=7,
                      pbs_level=3, ks_base_log=4, ks_level=8)
    rows = torch.from_numpy(random_planes(8, 256, steps=2))
    key = bt.BootstrapKey(ksk_a=None, ksk_b=None, params=p, ggsw_i8=rows)
    calls = []
    real = bt.build_all_step_kslabs
    monkeypatch.setattr(bt, "build_all_step_kslabs",
                        lambda g: calls.append(1) or real(g))
    eng = bt.TfheEngine(p, ext_backend="mxu_fused", device="cpu")
    prepared = eng.prepare_bsk(key)
    assert len(calls) == 1 and prepared.ggsw_slabs is None
    assert torch.equal(prepared.ggsw_kslabs, real(rows))
    assert eng.prepare_bsk(prepared) is prepared
    assert eng.prepare_bsk(prepared, form="slabs") is prepared
    acc = torch.zeros((3, 2, 256), dtype=torch.int32)
    lwe = bt.LweCiphertext(a=torch.zeros((3, 2), dtype=torch.int32),
                           b=torch.zeros(3, dtype=torch.int32))
    eng.blind_rotate(acc, lwe, prepared)
    assert len(calls) == 1
    carried = bt.BootstrapKey(ksk_a=None, ksk_b=None, params=p, ggsw_i8=rows,
                              ggsw_slabs=cmux.build_all_step_slabs(rows))
    from_slabs = eng.prepare_bsk(carried)
    assert torch.equal(from_slabs.ggsw_kslabs, prepared.ggsw_kslabs)
    assert from_slabs.ggsw_slabs is carried.ggsw_slabs


# How the wgmma kernels' wrappers split a batch (cmux.batch_chunks)

@pytest.mark.parametrize("batch,kdim,limit", [
    (1, 2560, 1 << 31), (4096, 2560, 1 << 31),
    (838_784, 2560, 1 << 31), (838_785, 2560, 1 << 31),
    (2 * 838_784 + 5, 2560, 1 << 31), (600, 2560, 256 * 2560 + 1),
    (1000, 6144, 256 * 6144)],
    ids=["one_row", "k4_4096", "k4_full", "k4_full_plus_1",
         "k4_two_full_plus_5", "lowered_limit", "limit_is_exclusive"])
def test_batch_chunks_keep_each_digit_buffer_below_the_limit(
        monkeypatch, batch, kdim, limit):
    """Ranges cover [0, batch) in order, each a whole number of 128-row
    tiles but the last, each padded digit buffer below the limit, and as
    few ranges as that allows."""
    monkeypatch.setattr(cmux, "DIGIT_BYTES_LIMIT", limit)
    chunks = cmux.batch_chunks(batch, kdim)
    assert chunks[0][0] == 0 and chunks[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all((stop - start) % 128 == 0 for start, stop in chunks[:-1])
    for start, stop in chunks:
        rows = -(-(stop - start) // 128) * 128
        assert 0 < stop - start and rows * kdim < limit
        assert cmux.digit_scratch(stop - start, kdim, "meta").numel() \
            == rows * kdim
    most = (limit - 1) // kdim // 128 * 128
    assert len(chunks) == -(-batch // most)
    if limit == 256 * kdim:
        assert most == 128


def test_batch_chunks_refuse_a_row_too_wide_for_one_tile():
    with pytest.raises(ValueError, match="no tile"):
        cmux.batch_chunks(10, (1 << 31) // 128)
