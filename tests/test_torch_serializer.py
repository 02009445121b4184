"""The port's FHEB blob and bootstrap-key serializer vs the JAX package's:
each side reads what the other wrote (small keys, in memory), and the port
reads the committed K4 key.  Tolerance: exact equality of every array."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from node_fhe_accelerate_tpu.core import serializer as jax_serializer
from node_fhe_accelerate_tpu.core.bootstrap import (
    BootstrapKey as JaxKey, TfheParams as JaxParams)
from node_fhe_accelerate_tpu.core.keycache import (
    deserialize_bootstrap_key as jax_deserialize,
    serialize_bootstrap_key as jax_serialize)
from node_fhe_accelerate_tpu_torch.convert import bsk_from_numpy, bsk_to_numpy
from node_fhe_accelerate_tpu_torch.core import serializer
from node_fhe_accelerate_tpu_torch.core.bootstrap import (
    TFHE_BOOT_128_K4, TfheParams)
from node_fhe_accelerate_tpu_torch.core.keycache import (
    deserialize_bootstrap_key, serialize_bootstrap_key)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K4_BLOB = os.path.join(ROOT, ".keycache",
                       "7f5658596c1857e89c056b7e0b17cabf.fheb")


@pytest.fixture(scope="module")
def key_arrays():
    """A random key at a small shape: (params, ggsw_i8, ksk_a, ksk_b)."""
    p = TfheParams(n_lwe=6, poly_degree=64, glwe_dim=2, pbs_base_log=8,
                   pbs_level=2, ks_base_log=4, ks_level=3)
    rng = np.random.default_rng(0)
    g = rng.integers(-128, 128, (6, 2, 3, 3, 4, 128)).astype(np.int8)
    ka = rng.integers(0, 1 << 32, (128, 3, 6),
                      dtype=np.uint64).astype(np.uint32)
    kb = rng.integers(0, 1 << 32, (128, 3), dtype=np.uint64).astype(np.uint32)
    return p, g, ka, kb


def assert_key_equal(got, want):
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compression", [0, 1], ids=["none", "zlib"])
def test_port_reads_jax_key_blob(key_arrays, compression):
    p, g, ka, kb = key_arrays
    jkey = JaxKey(ggsw_i8=jnp.asarray(g), ksk_a=jnp.asarray(ka),
                  ksk_b=jnp.asarray(kb),
                  params=JaxParams(**dataclasses.asdict(p)))
    raw = jax_serialize(jkey, compression=compression, seed=7)
    bsk = deserialize_bootstrap_key(raw, p, device="cpu")
    assert bsk.params == p
    assert_key_equal(bsk_to_numpy(bsk), (g, ka, kb))


@pytest.mark.parametrize("compression", [0, 1], ids=["none", "zlib"])
def test_jax_reads_port_key_blob(key_arrays, compression):
    p, g, ka, kb = key_arrays
    bsk = bsk_from_numpy(g, ka, kb, p, device="cpu")
    raw = serialize_bootstrap_key(bsk, compression=compression)
    jkey = jax_deserialize(raw, JaxParams(**dataclasses.asdict(p)))
    assert_key_equal([np.asarray(jkey.ggsw_i8), np.asarray(jkey.ksk_a),
                      np.asarray(jkey.ksk_b)], (g, ka, kb))


def test_blob_framing_is_byte_identical():
    payload = bytes(range(256)) * 3
    for comp in (0, 1):
        kw = dict(key_id=5, poly_degree=64, modulus=97, compression=comp)
        mine = serializer.serialize_blob(serializer.Magic.BALLOT, payload,
                                         **kw)
        theirs = jax_serializer.serialize_blob(jax_serializer.Magic.BALLOT,
                                               payload, **kw)
        assert mine == theirs
        _, back = serializer.deserialize_blob(theirs,
                                              serializer.Magic.BALLOT)
        assert back == payload


def test_blob_rejects_tampering(key_arrays):
    p, g, ka, kb = key_arrays
    raw = bytearray(serialize_bootstrap_key(
        bsk_from_numpy(g, ka, kb, p, device="cpu")))
    with pytest.raises(serializer.SerializationError):
        deserialize_bootstrap_key(bytes(raw), TFHE_BOOT_128_K4(),
                                  device="cpu")
    raw[-1] ^= 1
    with pytest.raises(serializer.SerializationError):
        deserialize_bootstrap_key(bytes(raw), device="cpu")
    with pytest.raises(serializer.SerializationError):
        serializer.deserialize_blob(bytes(raw), serializer.Magic.BALLOT)


def test_port_reads_committed_k4_key():
    with open(K4_BLOB, "rb") as f:
        bsk = deserialize_bootstrap_key(f.read(), TFHE_BOOT_128_K4(),
                                        device="cpu")
    assert tuple(bsk.ggsw_i8.shape) == (630, 2, 5, 5, 4, 512)
    assert bsk.ggsw_i8.dtype == torch.int8
    assert tuple(bsk.ksk_a.shape) == (1024, 8, 630)
    assert tuple(bsk.ksk_b.shape) == (1024, 8)
