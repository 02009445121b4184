"""Device selection and uint32 <-> int32 tensor conversion."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "u32_to_tensor", "tensor_to_u32"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Raises when CUDA is asked for (explicitly or by
    default) and no card is present -- the port never falls back to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def u32_to_tensor(arr, device=None) -> torch.Tensor:
    """uint32 array-like -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    if not a.flags.writeable:       # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
