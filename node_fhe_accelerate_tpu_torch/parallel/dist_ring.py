"""Sharded polynomial ring: the PolyRing API over a device mesh
(counterpart of node_fhe_accelerate_tpu/parallel/dist_ring.py).

Puts the 4-step distributed NTT (dist_ntt.py) behind the surface of the
single-device ``PolyRing`` (core/poly.py), for degrees or batches beyond
one device: the only collective is the all-to-all coefficient transpose
between the radix-stage groups.

Coefficients enter and leave as whole (..., N) limb planes on the ring's
``device`` (the first position's), so ``EncryptionEngine(ring=...)``,
``KeyManager`` and ``RnsPolyRing(ring_factory=...)`` take it as a drop-in
ring.  The transforms lay them out as the (n1, n2) grid, split the j2
columns (k1 rows after the transpose) over the mesh positions, run each
position's stages on its device and join the result; the elementwise ring
ops (add, sub, neg, pointwise) run on the whole planes, whose bits do not
depend on the split.  ``multiply`` is twist -> local N1 DFTs -> all-to-all
-> local N2 DFTs -> pointwise -> inverse, bit-equal to the single-device
negacyclic NTT.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import sampling
from ..ops.modular import _lanes_of
from ..ops.u64 import u64_from_np, u64_to_np
from .dist_ntt import DistNTT
from .mesh import make_mesh, to_device

__all__ = ["DistPolyRing"]


class DistPolyRing:
    """Negacyclic ring Z_q[X]/(X^N+1) with its transforms split over a
    mesh axis.

    The API of core/poly.py's PolyRing for the ops that matter at scale:
    add/sub/neg/scalar_mul/pointwise/to_ntt/from_ntt/multiply and the
    samplers.  NTT-domain values use the dist-NTT layout, planes of shape
    batch + (n2, n1): opaque to callers, consistent between to_ntt,
    pointwise and from_ntt."""

    def __init__(self, degree: int, modulus: int, mesh=None,
                 n1: int | None = None, axis: str = "data"):
        self.n = degree
        self.q = modulus
        if mesh is None:
            mesh = make_mesh()
        self.mesh = mesh
        self.axis = axis
        self.positions = mesh.axis_devices(axis)
        self.device = self.positions[0]
        p = mesh.shape[axis]
        if n1 is None:
            # balanced split with both n1 and n2 divisible by the axis size
            n1 = 1 << ((degree.bit_length() - 1) // 2)
            while n1 % p or (degree // n1) % p:
                n1 *= 2
                if n1 > degree:
                    raise ValueError("degree too small for this mesh axis")
        if degree % n1 or n1 % p or (degree // n1) % p:
            raise ValueError("n1 and N/n1 must be divisible by the axis size")
        self.n1 = n1
        self.n2 = degree // n1
        self.dntt = DistNTT(degree, modulus, n1=n1, axis_name=axis)
        self.ctx = self.dntt.ctx
        # the transform domain's layout, for caches keyed by it (a relin
        # key's NTT form, core/ckks.py)
        self.ntt_layout = ("dist", n1, p)

    # -- layout -----------------------------------------------------------
    def to_grid(self, planes):
        """(..., N) -> (B, n1, n2) coefficient grid + batch shape."""
        batch = tuple(planes[0].shape[:-1])
        shp = (-1, self.n1, self.n2)
        return (tuple(p.reshape(shp) for p in planes), batch)

    def from_grid(self, grid, batch):
        shp = tuple(batch) + (self.n,)
        return tuple(g.reshape(shp) for g in grid)

    def _split(self, planes) -> list:
        """Rank-3 planes -> one (lo, hi) block of the last axis for each
        position, on its device."""
        P = len(self.positions)
        parts = [torch.chunk(p, P, dim=-1) for p in planes]
        return [to_device((lo.contiguous(), hi.contiguous()), dev)
                for lo, hi, dev in zip(*parts, self.positions)]

    def _join(self, shards) -> tuple:
        """Per-position blocks -> whole planes on the ring's device."""
        return tuple(torch.cat([to_device(s[i], self.device)
                                for s in shards], dim=-1) for i in (0, 1))

    @staticmethod
    def _flat3(planes):
        """batch + (d2, d1) planes -> rank-3 (B, d2, d1)."""
        return tuple(p.reshape((-1,) + tuple(p.shape[-2:])) for p in planes)

    # -- construction / host edges -----------------------------------------
    def from_np(self, coeffs):
        return u64_from_np(np.asarray(coeffs, dtype=np.uint64), self.device)

    def to_np(self, planes):
        return u64_to_np(planes)

    def zeros(self, batch=()):
        z = torch.zeros(tuple(batch) + (self.n,), dtype=torch.int32,
                        device=self.device)
        return z, z.clone()

    def constant(self, value: int, batch=()):
        coeffs = np.zeros(tuple(batch) + (self.n,), dtype=np.uint64)
        coeffs[..., 0] = value % self.q
        return self.from_np(coeffs)

    # -- sampling (PolyRing's samplers: the coefficient layout is the same
    # (..., N) planes; only the transforms are split) ----------------------
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

    # -- elementwise --------------------------------------------------------
    def add(self, a, b):
        return self.ctx.add(a, b)

    def sub(self, a, b):
        return self.ctx.sub(a, b)

    def neg(self, a):
        return self.ctx.neg(a)

    def scalar_mul(self, a, scalar: int):
        return self.ctx.mul(a, _lanes_of(scalar % self.q))

    def pointwise(self, a_hat, b_hat):
        """Elementwise product in the dist-NTT domain."""
        return self.ctx.mul(a_hat, b_hat)

    # -- transforms ----------------------------------------------------------
    def to_ntt(self, a):
        """(..., N) coefficients -> dist-NTT-domain planes of shape
        batch + (n2, n1): plain (lo, hi) limb planes, as PolyRing.to_ntt
        returns, so add/sub/neg work on NTT-domain values unchanged."""
        g, batch = self.to_grid(tuple(a))
        out = self._join(self.dntt.forward_local(self._split(g)))
        return tuple(p.reshape(batch + tuple(p.shape[-2:])) for p in out)

    def from_ntt(self, a_hat):
        batch = tuple(a_hat[0].shape[:-2])
        g = self._join(self.dntt.inverse_local(
            self._split(self._flat3(tuple(a_hat)))))
        return self.from_grid(g, batch)

    def multiply(self, a, b):
        """The distributed negacyclic product of coefficient-form planes of
        one shape (..., N) (broadcast first, as PolyRing.multiply)."""
        a, b = tuple(a), tuple(b)
        if a[0].shape != b[0].shape:
            shape = torch.broadcast_shapes(a[0].shape, b[0].shape)
            a = tuple(x.expand(shape) for x in a)
            b = tuple(x.expand(shape) for x in b)
        ga, batch = self.to_grid(a)
        gb, _ = self.to_grid(b)
        out = self.dntt.negacyclic_mul_local(self._split(ga),
                                             self._split(gb))
        return self.from_grid(self._join(out), batch)
