"""Carry keys and ciphertexts between the JAX package and the port as
numpy arrays (uint32 torus values <-> int32 tensors with the same bits).

The caller turns JAX arrays into numpy with ``np.asarray``; nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bootstrap import BootstrapKey, LweCiphertext, TfheParams
from .device import resolve_device, tensor_to_u32, u32_to_tensor

__all__ = ["bsk_from_numpy", "bsk_to_numpy", "lwe_from_numpy",
           "lwe_to_numpy"]


def _i8_tensor(arr, dev):
    if arr is None:
        return None
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int8))
    if not a.flags.writeable:       # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def bsk_from_numpy(ggsw_i8, ksk_a, ksk_b, params: TfheParams,
                   device=None, ggsw_tiles=None, ggsw_slabs=None
                   ) -> BootstrapKey:
    """int8 GGSW planes and uint32 KSK arrays -> the port's BootstrapKey;
    the prepared ``ggsw_tiles`` / ``ggsw_slabs`` of a JAX key carry across
    field by field where given."""
    dev = resolve_device(device)
    return BootstrapKey(ggsw_i8=_i8_tensor(ggsw_i8, dev),
                        ksk_a=u32_to_tensor(ksk_a, dev),
                        ksk_b=u32_to_tensor(ksk_b, dev), params=params,
                        ggsw_tiles=_i8_tensor(ggsw_tiles, dev),
                        ggsw_slabs=_i8_tensor(ggsw_slabs, dev))


def bsk_to_numpy(bsk: BootstrapKey):
    """BootstrapKey -> (ggsw_i8 int8, ksk_a uint32, ksk_b uint32)."""
    return (bsk.ggsw_i8.detach().cpu().numpy(), tensor_to_u32(bsk.ksk_a),
            tensor_to_u32(bsk.ksk_b))


def lwe_from_numpy(a, b, device=None) -> LweCiphertext:
    """uint32 (a, b) arrays -> LweCiphertext of int32 tensors."""
    dev = resolve_device(device)
    return LweCiphertext(a=u32_to_tensor(a, dev), b=u32_to_tensor(b, dev))


def lwe_to_numpy(ct: LweCiphertext):
    """LweCiphertext -> (a, b) uint32 arrays."""
    return tensor_to_u32(ct.a), tensor_to_u32(ct.b)
