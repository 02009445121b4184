"""Signed int8 digit planes and the negacyclic Toeplitz expansion
(counterpart of node_fhe_accelerate_tpu/ops/i8.py).

A torus (uint32) polynomial splits into 4 balanced base-256 digit planes;
a negacyclic product against a fixed polynomial g is a matmul by
T(g)[c, r] = g~[(r - c) mod 2N] with g~ = [g, -g]; int8 x int8 products
accumulate exactly in int32 and the planes recombine with weights 256^p
mod 2^32.  Torus values are int32 tensors with uint32 bits (ops/u32.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .u32 import lshr

__all__ = [
    "u32_to_i8_digits", "i8_digit_planes_to_u32", "roll_last",
    "negacyclic_toeplitz_idx", "toeplitz_from_doubled",
]


def u32_to_i8_digits(x: torch.Tensor, planes: int = 4) -> torch.Tensor:
    """Balanced signed base-256 digits: int8 of shape x.shape + (planes,)
    with x == sum_p digits[..., p] * 256**p (mod 2^32), digits in
    [-128, 127].  The carry past the top plane is dropped (mod 2^32)."""
    digits = []
    carry = torch.zeros_like(x)
    for p in range(planes):
        d = (lshr(x, 8 * p) & 0xFF) + carry                 # 0..256
        carry = (d >= 128).to(torch.int32)
        digits.append((d - (carry << 8)).to(torch.int8))
    return torch.stack(digits, dim=-1)


def i8_digit_planes_to_u32(partials: torch.Tensor) -> torch.Tensor:
    """Recombine int32 partial sums (..., planes), plane p weighted 256^p,
    into uint32 bits mod 2^32 (int32 multiply wraps)."""
    out = partials[..., 0]
    for p in range(1, partials.shape[-1]):
        out = out + partials[..., p] * (1 << (8 * p))
    return out


def roll_last(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll along the last axis by a static shift."""
    return torch.roll(x, shift, dims=-1)


def negacyclic_toeplitz_idx(n: int) -> np.ndarray:
    """IDX[c, r] = (r - c) mod 2N: g~[IDX[c, r]] == (X^c g)_r."""
    c = np.arange(n)[:, None]
    r = np.arange(n)[None, :]
    return ((r - c) % (2 * n)).astype(np.int32)


def toeplitz_from_doubled(ghat: torch.Tensor, idx) -> torch.Tensor:
    """ghat int8 (..., 2N, P) planes of g~ = [g, -g]; idx (N, N) from
    negacyclic_toeplitz_idx.  Returns (..., N, N, P) with
    [..., c, r, p] = ghat[..., (r - c) % 2N, p]."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                          device=ghat.device)
    return ghat[..., idx, :]
