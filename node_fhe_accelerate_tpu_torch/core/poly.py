"""Polynomial ring R_q = Z_q[X]/(X^N+1) (counterpart of
node_fhe_accelerate_tpu/core/poly.py).

A polynomial is a (lo, hi) pair of int32 limb planes (uint32 bits) of shape
(..., N); batch axes lead and every op is batched.  The elementwise ops
run through the port's ``ModCtx`` (plain PyTorch on any device); the
transforms go through ``PallasNTT(NTTContext(N, q))``, as ``core/torus.py``
does:

* on a CUDA tensor ``to_ntt``/``from_ntt`` launch the forward and inverse
  NTT kernels (K6/K7, csrc/ntt.cu) and ``multiply`` the fused negacyclic
  product (K8; one launch for N <= 8192, above that K6, the pointwise
  product and K7), or raise;
* on a CPU tensor each takes its plain ``NTTContext`` version.

No wrapper falls back to the plain version when a kernel fails to build or
launch.  The NTT-domain flag of the reference's polynomial is the caller's
business (``Ciphertext.is_ntt``, core/encrypt.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sampling
from ..ops.modular import ModCtx, _lanes_of
from ..ops.ntt import NTTContext, negacyclic_mul_np
from ..ops.ntt_pallas import PallasNTT
from ..ops.u64 import u64_from_np, u64_to_np

__all__ = ["PolyRing"]

# K8 holds a and b in shared memory: its largest degree
_MUL_MAX_N = 1 << 13


class PolyRing:
    """Arithmetic in Z_q[X]/(X^N+1) for one modulus on one device."""

    def __init__(self, degree: int, modulus: int, device=None):
        self.n = degree
        self.q = modulus
        self.device = resolve_device(device)
        self.ntt = NTTContext(degree, modulus)
        self.pntt = PallasNTT(self.ntt)
        self.ctx: ModCtx = self.ntt.ctx

    # -- construction ----------------------------------------------------
    def zeros(self, batch=()):
        z = torch.zeros(tuple(batch) + (self.n,), dtype=torch.int32,
                        device=self.device)
        return z, z.clone()

    def constant(self, value: int, batch=()):
        """Polynomial with coeff[0] = value mod q, the rest zero."""
        coeffs = np.zeros(tuple(batch) + (self.n,), dtype=np.uint64)
        coeffs[..., 0] = value % self.q
        return self.from_np(coeffs)

    def from_np(self, coeffs):
        """uint64 coefficients -> limb planes on the ring's device."""
        return u64_from_np(np.asarray(coeffs, dtype=np.uint64), self.device)

    def to_np(self, p) -> np.ndarray:
        return u64_to_np(p)

    # -- sampling (draws on the generator's device) ----------------------
    def sample_uniform(self, gen: torch.Generator, batch=()):
        return sampling.uniform_mod_q(gen, tuple(batch) + (self.n,),
                                      self.ctx, self.device)

    def sample_ternary(self, gen: torch.Generator, batch=()):
        return sampling.ternary(gen, tuple(batch) + (self.n,), self.q,
                                self.device)

    def sample_gaussian(self, gen: torch.Generator, std_dev: float,
                        batch=()):
        return sampling.gaussian(gen, tuple(batch) + (self.n,), std_dev,
                                 self.q, self.device)

    # -- elementwise ring ops --------------------------------------------
    def add(self, a, b):
        return self.ctx.add(a, b)

    def sub(self, a, b):
        return self.ctx.sub(a, b)

    def neg(self, a):
        return self.ctx.neg(a)

    def scalar_mul(self, a, scalar: int):
        return self.ctx.mul(a, _lanes_of(scalar % self.q))

    def pointwise(self, a, b):
        return self.ctx.mul(a, b)

    # -- transforms -------------------------------------------------------
    def to_ntt(self, a):
        """Forward negacyclic NTT (natural -> bit-reversed order)."""
        return self.pntt.forward(tuple(a))

    def from_ntt(self, a):
        """Inverse negacyclic NTT with the N^-1 scale."""
        return self.pntt.inverse(tuple(a))

    def multiply(self, a, b):
        """Full negacyclic product of coefficient-form polynomials of one
        shape (..., N)."""
        a, b = tuple(a), tuple(b)
        if a[0].shape != b[0].shape:
            shape = torch.broadcast_shapes(a[0].shape, b[0].shape)
            a = tuple(x.expand(shape) for x in a)
            b = tuple(x.expand(shape) for x in b)
        if a[0].device.type == "cuda" and self.n > _MUL_MAX_N:
            return self.from_ntt(self.pointwise(self.to_ntt(a),
                                                self.to_ntt(b)))
        return self.pntt.negacyclic_mul(a, b)

    # -- host helpers -----------------------------------------------------
    def multiply_np(self, a, b):
        """Host oracle (Kronecker substitution)."""
        return negacyclic_mul_np(a, b, self.q)
