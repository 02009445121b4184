"""Bootstrap-key serialization (counterpart of
node_fhe_accelerate_tpu/core/keycache.py:35-98).

FHEB blob around an npz payload with the key's arrays and TfheParams as
JSON -- the JAX package's format, so its committed keys load here and keys
made here load there.  Torus arrays are stored as uint32.  The disk cache
(``BootstrapKeyCache``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch

from ..device import resolve_device, tensor_to_u32, u32_to_tensor
from .bootstrap import BootstrapKey, TfheParams
from .serializer import (
    CompressionType, Magic, SerializationError, deserialize_blob,
    serialize_blob,
)

__all__ = ["serialize_bootstrap_key", "deserialize_bootstrap_key"]


def serialize_bootstrap_key(bsk: BootstrapKey,
                            compression=CompressionType.NONE,
                            seed: int | None = None) -> bytes:
    """BootstrapKey -> FHEB blob (header + checksummed npz payload)."""
    arrays = {}
    if seed is not None:
        arrays["seed"] = np.asarray(int(seed), dtype=np.int64)
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
