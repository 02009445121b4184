"""Sharded multi-scalar multiplication over a device mesh (counterpart of
node_fhe_accelerate_tpu/parallel/msm.py).

Points and scalars split over the mesh's data axis; every position runs the
full bucketed Pippenger (``Curve._msm_pippenger_impl``: sorts, prefix scans,
the Horner tail; K9 and K10 on the card) on its slice, on its device -- the
data-dependent sort stays local -- and the per-position partial points
combine with log2(K) halving rounds of Jacobian adds (``Curve.add``) on the
first position.

MSM is associative-commutative over disjoint slices, so weak scaling is
embarrassing: each position's work is the Pippenger on n/K points and the
only communication is K - 1 partial points gathered to the first position.
"""
from __future__ import annotations

import torch

from ..zk.curve import Curve
from . import collectives
from .mesh import canonical_device, to_device

__all__ = ["sharded_msm"]

_CURVES = {}


def _curve_on(curve: Curve, device) -> Curve:
    """``curve`` itself on its own device; elsewhere one twin a
    (curve, device), over the same field on that device."""
    device = canonical_device(device)
    if canonical_device(curve.device) == device:
        return curve
    key = (id(curve), str(device))
    if key not in _CURVES:
        fq = type(curve.fq)(curve.fq.q, curve.fq.n_limbs, device)
        twin = Curve(fq, curve.b, *curve.gen_affine, curve.order)
        _CURVES[key] = (curve, twin)        # holds curve: ids stay unique
    return _CURVES[key][1]


def sharded_msm(curve: Curve, scalar_limbs, points, mesh,
                axis: str = "data", c: int = 8,
                _want_ici_bytes: bool = False):
    """sum_i s_i * P_i with the point set split over ``axis``.

    scalar_limbs: (n, L) int32 limbs; points: (X, Y, Z) Jacobian planes of
    leading dim n, on the curve's device.  n pads to a multiple of the
    axis size with zero scalars * infinity (Curve.msm's padding rule).
    Returns a single Jacobian point on the first position's device.

    ``_want_ici_bytes=True`` returns ``(point, bytes)``: the bytes the
    combine moved between distinct positions (``collectives.traffic``) --
    the K - 1 partial points the first position reads, not its own."""
    devs = mesh.axis_devices(axis)
    k = len(devs)
    n = scalar_limbs.shape[0]
    pad = (-n) % k
    if pad:
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (pad,) + tuple(scalar_limbs.shape[1:]))])
        inf = curve.infinity((pad,))
        points = tuple(torch.cat([points[i], inf[i]]) for i in range(3))
    per = scalar_limbs.shape[0] // k

    partials = []
    for i, dev in enumerate(devs):
        sl = slice(i * per, (i + 1) * per)
        local = _curve_on(curve, dev)
        partials.append(local._msm_pippenger_impl(
            to_device(scalar_limbs[sl].contiguous(), dev),
            to_device(tuple(p[sl].contiguous() for p in points), dev), c=c))

    before = collectives.traffic.bytes
    parts = collectives.gather_to(partials, 0)
    ici_bytes = collectives.traffic.bytes - before
    first = _curve_on(curve, devs[0])
    gx, gy, gz = (torch.stack([p[i] for p in parts]) for i in range(3))
    # log2(K) halving rounds of one batched Jacobian add each (the add is
    # branchless, so pairing works on whole arrays)
    while gx.shape[0] > 1:
        m = gx.shape[0]
        half = m // 2
        lo = (gx[:half], gy[:half], gz[:half])
        hi = (gx[half:m - m % 2], gy[half:m - m % 2], gz[half:m - m % 2])
        sx, sy, sz = first.add(lo, hi)
        if m % 2:
            sx = torch.cat([sx, gx[-1:]])
            sy = torch.cat([sy, gy[-1:]])
            sz = torch.cat([sz, gz[-1:]])
        gx, gy, gz = sx, sy, sz
    result = (gx[0], gy[0], gz[0])
    return (result, ici_bytes) if _want_ici_bytes else result
