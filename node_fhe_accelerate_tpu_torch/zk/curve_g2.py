"""G2 over Fq2: the Jacobian group law and Pippenger MSM of zk/curve.py
instantiated over zk/field2.py's Field2 (counterpart of
node_fhe_accelerate_tpu/zk/curve_g2.py).

The device paths (add/double/scalar_mul/_msm_pippenger_impl) are inherited
unchanged -- they are written against the abstract field interface and an
Fq2 element is just a 2L-wide digit row.  On the card (``point_op_path``)
point ops of at least 2048 same-shape points run the digit-major K9 path
over ``_TField2``; smaller ones evaluate the formulas over ``Field2``,
three launches of K10's product per Fq2 product.  Only the host-side
plumbing is G2-specific: affine extraction/injection works in coefficient
pairs, the "host" backend routes to the host Jacobian Pippenger of
zk/pairing.py (``g2_msm``), and on-curve checks use the twist constant.

Where the JAX package picks host or device by ``jax.default_backend()``,
the port picks by the curve's device (host for a curve on the CPU, device
on the card); ``backend="device"`` runs the card's code on CPU tensors.
"""
from __future__ import annotations

import numpy as np

from . import pairing as pr
from .curve import Curve
from .field import BLS12_381_FR, BN254_FR
from .field2 import Field2, bls12_381_fq2, bn254_fq2

__all__ = ["G2Curve", "bn254_g2", "bls12_381_g2"]


class G2Curve(Curve):
    """Short-Weierstrass curve over Fq2 (a = 0, b = twist constant).

    ``host_mod`` supplies the matching host FQ2 tower (zk/pairing.py for
    BN254, zk/pairing_bls.py for BLS12-381) used by the host backend and
    affine extraction; the device paths never touch it."""

    def __init__(self, fq2, b, gx, gy, order, host_mod):
        super().__init__(fq2, b, gx, gy, order)
        self._hm = host_mod

    @property
    def FQ2(self):
        return self._hm.FQ2

    # -- host-side checks ------------------------------------------------------
    def is_on_curve_affine(self, x, y) -> bool:
        FQ2 = self.FQ2
        xf, yf = FQ2(list(self.fq._pair(x))), FQ2(list(self.fq._pair(y)))
        return yf * yf - xf * xf * xf == FQ2(list(self.fq._pair(self.b)))

    # -- host <-> device (pair-aware) -------------------------------------------
    def to_affine_pairs(self, pts) -> list:
        """Jacobian points -> list of affine (FQ2, FQ2) | None."""
        f: Field2 = self.fq
        x0, x1 = f.decode(pts[0])
        y0, y1 = f.decode(pts[1])
        z0, z1 = f.decode(pts[2])
        x0, x1, y0, y1, z0, z1 = (np.atleast_1d(a)
                                  for a in (x0, x1, y0, y1, z0, z1))
        FQ2 = self.FQ2
        out = []
        for i in range(len(x0)):
            if z0[i] == 0 and z1[i] == 0:
                out.append(None)
                continue
            Z = FQ2([int(z0[i]), int(z1[i])])
            zi = FQ2([1, 0]) / Z
            zi2 = zi * zi
            X = FQ2([int(x0[i]), int(x1[i])]) * zi2
            Y = FQ2([int(y0[i]), int(y1[i])]) * zi2 * zi
            out.append((X, Y))
        return out

    def from_affine_pairs(self, pts: list):
        """Affine (FQ2, FQ2) | None list -> Jacobian points on the curve's
        device."""
        xs, ys, zs = [], [], []
        for p in pts:
            if p is None:
                xs.append((1, 0))
                ys.append((1, 0))
                zs.append((0, 0))
            else:
                xs.append(tuple(int(c) for c in p[0].coeffs))
                ys.append(tuple(int(c) for c in p[1].coeffs))
                zs.append((1, 0))
        f: Field2 = self.fq
        return (f.encode(xs), f.encode(ys), f.encode(zs))

    # -- dispatching entry points -------------------------------------------------
    def msm(self, scalar_limbs, points, pad_pow2: bool = True,
            min_pippenger: int = 128, backend: str | None = None):
        """Same contract as Curve.msm; the host backend (the default for a
        curve on the CPU) is the host Jacobian Pippenger over FQ2
        (pairing.py g2_msm), or an affine fold where the tower has none."""
        if backend is None:
            backend = self._default_backend()
        if backend == "host":
            svals = self._scalars_to_ints(scalar_limbs)
            aff = self.to_affine_pairs(points)
            msm_fn = getattr(self._hm, "g2_msm", None)
            if msm_fn is not None:
                res = msm_fn(aff, svals)
            else:                     # affine fold (pairing_bls has no MSM)
                res = None
                for p_i, s_i in zip(aff, svals):
                    if p_i is None or s_i % self.order == 0:
                        continue
                    res = self._hm.g2_add(res, self._hm.g2_mul(p_i, s_i))
            X, Y, Z = self.from_affine_pairs([res])
            return (X[0], Y[0], Z[0])
        return super().msm(scalar_limbs, points, pad_pow2=pad_pow2,
                           min_pippenger=min_pippenger, backend="device")

    def fixed_base_mul(self, scalars, base_affine: tuple | None = None,
                       backend: str | None = None):
        """[s_i]B for a shared G2 base -> (n,) points: one batched ladder
        on the device, or ``fixed_base_affine_host``."""
        if base_affine is None:
            base_affine = self.gen_affine
        if backend is None:
            backend = self._default_backend()
        scalars = [int(s) % self.order for s in scalars]
        if backend == "device":
            return super().fixed_base_mul(scalars, base_affine,
                                          backend="device")
        return self.from_affine_pairs(
            self.fixed_base_affine_host(scalars, base_affine))

    def fixed_base_affine_host(self, scalars, base_affine: tuple | None = None
                               ) -> list:
        """[s_i]B as affine (FQ2, FQ2) pairs on the host, None for s_i = 0
        mod r: the points of ``g2_mul(B, s_i)``.  Where the tower has
        Jacobian helpers (BN254), a cached 8-bit-window table of B (every
        scalar costs <= 32 Jacobian adds) and one batched inversion; else
        ``g2_mul`` per scalar."""
        hm = self._hm
        FQ2 = self.FQ2
        if base_affine is None:
            base_affine = self.gen_affine
        base = (FQ2(list(self.fq._pair(base_affine[0]))),
                FQ2(list(self.fq._pair(base_affine[1]))))
        scalars = [int(s) % self.order for s in scalars]
        if not hasattr(hm, "_g2j_add"):
            return [hm.g2_mul(base, s) if s else None for s in scalars]
        key = tuple(base_affine)
        tbl = self._fb_tables.get(key)
        if tbl is None:
            # tbl[w][d] = [d * 256^w] B
            tbl = []
            P = hm._g2j_from_affine(base)
            for _ in range(32):
                row = [None] * 256
                acc = None
                for d in range(1, 256):
                    acc = hm._g2j_add(acc, P)
                    row[d] = acc
                tbl.append(row)
                P = hm._g2j_add(acc, P)              # [256] B_w
            self._fb_tables[key] = tbl
        jac = []
        for s in scalars:
            acc = None
            w = 0
            while s:
                if s & 255:
                    acc = hm._g2j_add(acc, tbl[w][s & 255])
                s >>= 8
                w += 1
            jac.append(acc)
        # one Fq2 inversion for all Z (Montgomery's trick)
        one = FQ2([1, 0])
        zs = [one if p is None else p[2] for p in jac]
        prefix = [one]
        for z in zs:
            prefix.append(prefix[-1] * z)
        inv_all = one / prefix[-1]
        out = [None] * len(jac)
        for i in range(len(jac) - 1, -1, -1):
            zi = prefix[i] * inv_all
            inv_all = inv_all * zs[i]
            if jac[i] is not None:
                zi2 = zi * zi
                out[i] = (jac[i][0] * zi2, jac[i][1] * zi2 * zi)
        return out


def bn254_g2(device=None) -> G2Curve:
    """BN254 G2: y^2 = x^3 + 3/(9+u) over Fq2; generator from pairing.py
    (G2_GENERATOR), order r (only r-torsion points are ever held)."""
    b2 = tuple(int(c) for c in pr._B2.coeffs)
    gx = tuple(int(c) for c in pr.G2_GENERATOR[0].coeffs)
    gy = tuple(int(c) for c in pr.G2_GENERATOR[1].coeffs)
    return G2Curve(bn254_fq2(device), b2, gx, gy, BN254_FR, pr)


def bls12_381_g2(device=None) -> G2Curve:
    """BLS12-381 G2: y^2 = x^3 + 4(1+u) over Fq2 (pairing_bls.py _B2); the
    same device stack over the 48-digit base field; the host backend
    folds affinely over the pairing_bls tower."""
    from . import pairing_bls as prb
    b2 = tuple(int(c) for c in prb._B2.coeffs)
    gx = tuple(int(c) for c in prb.G2_GENERATOR[0].coeffs)
    gy = tuple(int(c) for c in prb.G2_GENERATOR[1].coeffs)
    return G2Curve(bls12_381_fq2(device), b2, gx, gy, BLS12_381_FR, prb)
