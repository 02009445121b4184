"""Randomness for keys and encryption: uniform, ternary, gaussian, binary
(counterpart of node_fhe_accelerate_tpu/ops/sampling.py).

Each sampler draws from an explicit ``torch.Generator`` on the generator's
own device and returns (lo, hi) int32 limb planes (uint32 bits) of the
requested shape on ``device`` (default: CUDA, through ``resolve_device``),
with the reference's semantics:

* uniform: 64 random bits reduced mod q, in [0, q);
* ternary: uniform over {-1, 0, 1} mapped to {q-1, 0, 1};
* gaussian: round(N(0, std_dev)) mod q, std_dev in absolute integer units
  (callers scale fractional stds by q and clamp them to >= 3.2 through
  ``ParameterSet.noise_std_absolute``);
* binary: uniform over {0, 1}.

The draws are not those of the JAX package's threefry streams; the tests
hold the arithmetic that consumes them against the JAX package by passing
the JAX package's own draws in.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .modular import ModCtx
from .u64 import to_planes

__all__ = ["uniform_mod_q", "ternary", "gaussian", "binary_planes"]


def _randint(gen: torch.Generator, shape, high: int) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen,
                         dtype=torch.int64, device=gen.device)


def uniform_mod_q(gen: torch.Generator, shape, ctx: ModCtx, device=None):
    """Uniform in [0, q): 64 random bits reduced mod q (bias below
    2^-(64 - log q))."""
    dev = resolve_device(device)
    lo = _randint(gen, shape, 1 << 32).to(dev)
    hi = _randint(gen, shape, 1 << 32).to(dev)
    z = torch.zeros_like(lo)
    return to_planes(ctx._reduce_128((lo, hi, z, z)))


def ternary(gen: torch.Generator, shape, q: int, device=None):
    """Uniform over {q-1, 0, 1} as limb planes."""
    r = _randint(gen, shape, 3).to(resolve_device(device))
    v = torch.where(r == 2, q - 1, r)
    return to_planes((v & 0xFFFFFFFF, v >> 32))


def gaussian(gen: torch.Generator, shape, std_dev: float, q: int,
             device=None):
    """round(N(0, std_dev)) mod q as limb planes (float32 draws, rounded
    half to even); |sample| < 2^31 < q."""
    z = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * std_dev
    s = torch.round(z).to(torch.int64).to(resolve_device(device))
    v = torch.where(s < 0, s + q, s)
    return to_planes((v & 0xFFFFFFFF, v >> 32))


def binary_planes(gen: torch.Generator, shape, device=None):
    """Uniform over {0, 1} as limb planes."""
    b = _randint(gen, shape, 2).to(torch.int32).to(resolve_device(device))
    return b, torch.zeros_like(b)
