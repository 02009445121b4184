"""The port's FHEB blob and bootstrap-key serializer vs the JAX package's:
each side reads what the other wrote (small keys, in memory), and the port
reads the committed K4 key; and the port's BootstrapKeyCache, in tmp_path
only.  Tolerance: exact equality of every array."""
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
    TFHE_BOOT_128_K4, TfheEngine, TfheParams)
from node_fhe_accelerate_tpu_torch.core.keycache import (
    RNG_TAG, BootstrapKeyCache, deserialize_bootstrap_key, peek_blob_origin,
    serialize_bootstrap_key)

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


# ---------------------------------------------------------------------------
# BootstrapKeyCache
# ---------------------------------------------------------------------------

CACHE_PARAMS = TfheParams(n_lwe=4, poly_degree=128, glwe_dim=1,
                          pbs_base_log=7, pbs_level=3, ks_base_log=4,
                          ks_level=8, lwe_noise_std=0.0, glwe_noise_std=0.0)


def cache_engine():
    return TfheEngine(CACHE_PARAMS, ext_backend="mxu", device="cpu")


def dir_state(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))
            if os.path.isfile(os.path.join(path, name))}


def untagged_blob(bsk, seed):
    """The key as the JAX package serializes it: seed, no generator tag."""
    g, ka, kb = bsk_to_numpy(bsk)
    jkey = JaxKey(ggsw_i8=jnp.asarray(g), ksk_a=jnp.asarray(ka),
                  ksk_b=jnp.asarray(kb),
                  params=JaxParams(**dataclasses.asdict(bsk.params)))
    return jax_serialize(jkey, seed=seed)


def test_cache_round_trip_hits_and_keys_match(tmp_path, monkeypatch):
    eng = cache_engine()
    cache = BootstrapKeyCache(str(tmp_path / "kc"))
    lwe_sk, glwe_sk, bsk = cache.get_or_generate(eng, 5)
    files = os.listdir(cache.dir)
    assert len(files) == 1 and files[0].endswith(".fheb")
    with open(os.path.join(cache.dir, files[0]), "rb") as f:
        assert peek_blob_origin(f.read()) == (5, RNG_TAG)

    def no_keygen(*a, **k):
        raise AssertionError("a cache hit must not run keygen")
    monkeypatch.setattr(eng, "generate_bootstrap_key", no_keygen)
    lwe2, glwe2, bsk2 = cache.get_or_generate(eng, 5)
    assert torch.equal(lwe_sk, lwe2) and torch.equal(glwe_sk, glwe2)
    assert_key_equal(bsk_to_numpy(bsk2), bsk_to_numpy(bsk))
    assert os.listdir(cache.dir) == files
    # the secret keys returned with a hit are the cached key's own
    msgs = torch.tensor([0, 1, 1, 0])
    ct = eng.lwe_encrypt(torch.Generator().manual_seed(1), msgs, lwe2)
    assert torch.equal(eng.lwe_decrypt(eng.bootstrap(ct, bsk2), lwe2),
                       msgs.to(torch.int32))
    # another seed is another entry
    assert cache.load(eng, 6)[2] is None


def test_cache_refuses_blob_without_generator_tag(tmp_path):
    """A blob the JAX package wrote (no tag) sits under the cache's own name
    and under another name: neither is returned, although
    ``deserialize_bootstrap_key`` reads it."""
    eng = cache_engine()
    cache = BootstrapKeyCache(str(tmp_path / "kc"))
    _, _, bsk = cache.get_or_generate(eng, 7)
    canonical = cache._path(eng, 7)
    raw = untagged_blob(bsk, 7)
    assert deserialize_bootstrap_key(raw, CACHE_PARAMS, device="cpu")
    assert peek_blob_origin(raw) == (7, None)
    other = os.path.join(cache.dir, "0" * 32 + ".fheb")
    for path in (canonical, other):
        with open(path, "wb") as f:
            f.write(raw)
    assert cache.load(eng, 7)[2] is None
    assert not os.path.exists(canonical)        # evicted from its own dir
    with open(other, "rb") as f:                # scanned, not adopted
        assert f.read() == raw
    assert cache.get_or_generate(eng, 7)[2] is not None


def test_cache_adopts_compatible_tagged_blob_of_its_own_directory(tmp_path):
    eng = cache_engine()
    cache = BootstrapKeyCache(str(tmp_path / "kc"))
    _, _, bsk = cache.get_or_generate(eng, 8)
    canonical = cache._path(eng, 8)
    moved = os.path.join(cache.dir, "f" * 32 + ".fheb")
    os.replace(canonical, moved)
    assert cache.load(eng, 9)[2] is None        # the seed must match
    got = cache.load(eng, 8)[2]
    assert_key_equal(bsk_to_numpy(got), bsk_to_numpy(bsk))
    assert os.path.exists(canonical) and os.path.exists(moved)


def test_cache_touches_no_file_of_another_directory(tmp_path, monkeypatch):
    """With the default directory under a working directory that holds a
    JAX-style ``.keycache`` blob: the cache writes to ``.keycache/torch``
    only and leaves the parent's files as they were."""
    monkeypatch.chdir(tmp_path)
    eng = cache_engine()
    _, _, bsk = BootstrapKeyCache(str(tmp_path / "seed")) \
        .get_or_generate(eng, 3)
    os.makedirs(".keycache")
    with open(os.path.join(".keycache", "a" * 32 + ".fheb"), "wb") as f:
        f.write(untagged_blob(bsk, 3))
    with open(os.path.join(".keycache", "b" * 32 + ".fheb"), "wb") as f:
        f.write(b"not a blob")
    before = dir_state(".keycache")
    cache = BootstrapKeyCache()
    assert cache.dir == os.path.join(".keycache", "torch")
    cache.get_or_generate(eng, 3)
    cache.get_or_generate(eng, 3)
    assert dir_state(".keycache") == before
    assert len(os.listdir(cache.dir)) == 1
