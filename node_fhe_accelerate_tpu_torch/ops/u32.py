"""uint32 semantics on int32 tensors.

torch has no uint32 add, ``>>`` or ``>=`` on the CPU, so torus values live
in int32 tensors with the same bits.  Add, sub and mul wrap mod 2^32 as
uint32 does; the two operations whose result depends on the sign bit get
explicit helpers here, and ``matmul_mod32`` gives exact integer products
mod 2^32 (torch's CUDA matmul has no int32 path)."""
from __future__ import annotations

import torch

__all__ = ["lshr", "uge", "matmul_mod32"]

_SIGN = -(1 << 31)


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of uint32 bits held in int32 (int32 ``>>`` is
    arithmetic)."""
    if not 0 <= s < 32:
        raise ValueError(f"shift {s} outside [0, 32)")
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def uge(x: torch.Tensor, y) -> torch.Tensor:
    """Unsigned x >= y for uint32 bits held in int32: flipping the sign bit
    maps unsigned order onto signed order."""
    if not isinstance(y, torch.Tensor):
        y = int(y) & 0xFFFFFFFF
        y = y - (1 << 32) if y >= (1 << 31) else y
    return (x ^ _SIGN) >= (y ^ _SIGN)


def matmul_mod32(x: torch.Tensor, y: torch.Tensor,
                 bound_log2: float) -> torch.Tensor:
    """x @ y mod 2^32 for integer tensors, as int32.

    Computed as one float64 matmul, which is exact while every partial sum
    stays below 2^53: the caller passes log2 of the largest |sum| its
    operands can give (for example ``kN * ks_level * (base/2) * 2^31``
    for the key switch) and the call raises if it is not below 53."""
    if bound_log2 >= 53:
        raise ValueError(f"|sum| up to 2^{bound_log2:.1f} is not exact in "
                         "float64")
    out = torch.matmul(x.to(torch.float64), y.to(torch.float64))
    # int64 -> int32 keeps the low 32 bits: the result mod 2^32
    return out.to(torch.int64).to(torch.int32)
