"""Bootstrap-key serialization and on-disk caching (counterpart of
node_fhe_accelerate_tpu/core/keycache.py).

FHEB blob around an npz payload with the key's arrays and TfheParams as
JSON -- the JAX package's format, so its committed keys load here and keys
made here load there.  Torus arrays are stored as uint32.

``BootstrapKeyCache`` returns secret keys derived from a seed together with
the cached key.  A ``torch.Generator`` does not draw what ``jax.random``
draws from the same seed, so a blob the JAX package wrote would come back
with secret keys that do not match it.  The cache therefore tags its blobs
with the generator family (``RNG_TAG``), hashes the tag into the file name,
refuses every blob without it, and keeps to a directory of its own.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os

import numpy as np
import torch

from ..device import resolve_device, tensor_to_u32, u32_to_tensor
from .bootstrap import BootstrapKey, TfheParams
from .serializer import (
    CompressionType, Magic, SerializationError, deserialize_blob,
    serialize_blob,
)

__all__ = ["serialize_bootstrap_key", "deserialize_bootstrap_key",
           "BootstrapKeyCache", "RNG_TAG", "peek_blob_origin"]

# Generator family of the keys the cache makes: a CPU torch.Generator, so
# the same seed gives the same keys whatever device the engine runs on.
RNG_TAG = "torch-cpu"


def serialize_bootstrap_key(bsk: BootstrapKey,
                            compression=CompressionType.NONE,
                            seed: int | None = None,
                            rng: str | None = None) -> bytes:
    """BootstrapKey -> FHEB blob (header + checksummed npz payload).
    ``seed`` and ``rng`` (the generator family the key was drawn from) are
    recorded when given; the prepared tiles and slabs are not stored."""
    arrays = {}
    if seed is not None:
        arrays["seed"] = np.asarray(int(seed), dtype=np.int64)
    if rng is not None:
        arrays["rng"] = np.frombuffer(rng.encode(), dtype=np.uint8)
    arrays["ggsw_i8"] = bsk.ggsw_i8.detach().cpu().numpy()
    arrays["ksk_a"] = tensor_to_u32(bsk.ksk_a)
    arrays["ksk_b"] = tensor_to_u32(bsk.ksk_b)
    arrays["params_json"] = np.frombuffer(
        json.dumps(dataclasses.asdict(bsk.params)).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return serialize_blob(Magic.BOOTSTRAP_KEY, buf.getvalue(),
                          poly_degree=bsk.params.poly_degree,
                          modulus=bsk.params.n_lwe,
                          compression=compression)


def deserialize_bootstrap_key(raw: bytes,
                              expected_params: TfheParams | None = None,
                              device=None) -> BootstrapKey:
    """FHEB blob -> BootstrapKey on ``device``; validates params match and
    that the blob carries the int8 GGSW form."""
    dev = resolve_device(device)
    _, payload = deserialize_blob(raw, Magic.BOOTSTRAP_KEY)
    with np.load(io.BytesIO(payload)) as z:
        params = TfheParams(**json.loads(bytes(z["params_json"]).decode()))
        if expected_params is not None and params != expected_params:
            raise SerializationError(
                f"bootstrap key params {params} != engine params "
                f"{expected_params}")
        if "ggsw_i8" not in z:
            raise SerializationError("blob lacks the int8 GGSW form")
        return BootstrapKey(
            ggsw_i8=torch.from_numpy(np.ascontiguousarray(z["ggsw_i8"]))
            .to(dev),
            ksk_a=u32_to_tensor(z["ksk_a"], dev),
            ksk_b=u32_to_tensor(z["ksk_b"], dev),
            params=params)


def peek_blob_origin(raw: bytes) -> tuple[int | None, str | None]:
    """(seed, generator family) recorded in a key blob; None where the blob
    does not say."""
    _, payload = deserialize_blob(raw, Magic.BOOTSTRAP_KEY)
    with np.load(io.BytesIO(payload)) as z:
        seed = int(z["seed"]) if "seed" in z else None
        rng = bytes(z["rng"]).decode() if "rng" in z else None
    return seed, rng


class BootstrapKeyCache:
    """Content-addressed bootstrap-key disk cache.

    File name = SHA-256 over (TfheParams fields, seed, key form, generator
    family).  A hit deserializes the blob (checksum-verified); a miss runs
    the engine's keygen and writes through.  Corrupt entries of the cache's
    own directory are evicted, never trusted; no other directory is read or
    written."""

    def __init__(self, cache_dir: str = os.path.join(".keycache", "torch")):
        self.dir = cache_dir

    def _path(self, engine, seed: int) -> str:
        h = hashlib.sha256()
        h.update(json.dumps(dataclasses.asdict(engine.p)).encode())
        h.update(str(int(seed)).encode())
        # every backend of the port consumes the one int8 form
        h.update(b"i8")
        h.update(RNG_TAG.encode())
        return os.path.join(self.dir, h.hexdigest()[:32] + ".fheb")

    @staticmethod
    def _secret_keys(engine, seed: int):
        """(generator, lwe_sk, glwe_sk): the secret keys drawn first from
        the seeded generator, which is left where the bootstrap key's
        draws begin."""
        gen = torch.Generator().manual_seed(int(seed))
        return gen, engine.lwe_keygen(gen), engine.glwe_keygen(gen)

    def get_or_generate(self, engine, seed: int):
        """Deterministic (lwe_sk, glwe_sk, bsk) from an int seed.  The cache
        owns the whole keygen, so the cached key always matches the secret
        keys it returns: they are redrawn from the seed on every call, and
        only the bootstrap key goes through the disk."""
        lwe_sk, glwe_sk, bsk = self.load(engine, seed)
        if bsk is None:
            gen, lwe_sk, glwe_sk = self._secret_keys(engine, seed)
            bsk = engine.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
            self.store(engine, seed, bsk)
        return lwe_sk, glwe_sk, bsk

    def _read(self, path: str, engine, seed: int) -> BootstrapKey:
        with open(path, "rb") as f:
            raw = f.read()
        blob_seed, rng = peek_blob_origin(raw)
        if rng != RNG_TAG:
            raise SerializationError(
                f"blob drawn from generator family {rng!r}, not "
                f"{RNG_TAG!r}: its secret keys cannot be rederived")
        if blob_seed != int(seed):
            raise SerializationError(f"blob seed {blob_seed} != {seed}")
        return deserialize_bootstrap_key(raw, engine.p, device=engine.device)

    def load(self, engine, seed: int):
        """(lwe_sk, glwe_sk, bsk-or-None) without generating on a miss."""
        _, lwe_sk, glwe_sk = self._secret_keys(engine, seed)
        path = self._path(engine, seed)
        if os.path.exists(path):
            try:
                return lwe_sk, glwe_sk, self._read(path, engine, seed)
            except (SerializationError, OSError, ValueError, KeyError):
                os.remove(path)     # corrupt or foreign entry: regenerate
        # The name hashes json.dumps(asdict(params)), so a field added to
        # TfheParams with a default moves it although old blobs still decode
        # to equal params.  Scan this directory for such a blob and adopt
        # it under the current name.
        return lwe_sk, glwe_sk, self._scan_compatible(engine, seed, path)

    def _scan_compatible(self, engine, seed: int, canonical_path: str):
        if not os.path.isdir(self.dir):
            return None
        for name in sorted(os.listdir(self.dir)):
            cand = os.path.join(self.dir, name)
            if not name.endswith(".fheb") or \
                    os.path.abspath(cand) == os.path.abspath(canonical_path):
                continue
            try:
                bsk = self._read(cand, engine, seed)
            except (SerializationError, OSError, ValueError, KeyError):
                continue            # incompatible candidate: keep scanning
            try:                    # adopt under the current name
                os.link(cand, canonical_path)
            except OSError:
                pass
            return bsk
        return None

    def store(self, engine, seed: int, bsk: BootstrapKey) -> str:
        path = self._path(engine, seed)
        os.makedirs(self.dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(serialize_bootstrap_key(bsk, seed=seed, rng=RNG_TAG))
        os.replace(tmp, path)
        return path
