"""Short-Weierstrass curves (a=0): BN254 G1 and BLS12-381 G1 (counterpart
of node_fhe_accelerate_tpu/zk/curve.py).

Points are (X, Y, Z) Jacobian digit planes with arbitrary batch axes, Z = 0
for infinity, and every operation is branchless: the doubling/infinity
cases of Jacobian addition are all computed and selected with masks, so a
batch of point ops is one sequence of wide tensor ops.  On the card
(``point_op_path``) point ops of at least 2048 same-shape points go to the
digit-major K9 path (``pallas_jadd_t``/``pallas_jdbl_t``), the rest over a
plain ``Field`` to the point kernel, one launch an add or a double
(``pallas_jadd``/``pallas_jdbl``); ``Field2`` and the CPU evaluate the
formulas over the field object.

The JAX package's ``jit``/``fori_loop``/``scan`` bodies are Python loops
with static shifts here; PyTorch runs eagerly.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import digits_pallas as dp
from ..ops import limbs as lb
from .field import BLS12_381_FR, BN254_FR, Field, bls12_381_fq, bn254_fq
from .field2 import Field2

__all__ = ["Curve", "bn254_g1", "bls12_381_g1", "Point", "msm_chunk_spans",
           "point_op_path"]


def msm_chunk_spans(n: int, max_chunk: int) -> list:
    """(offset, size) cover of n for the device MSM's binary-decomposition
    chunking: DESCENDING power-of-two chunks (each <= max_chunk, assumed a
    power of two >= 1024) plus one ragged tail < 1024."""
    spans = []
    off = 0
    rem = n
    while rem >= 1024:
        size = min(1 << (rem.bit_length() - 1), max_chunk)
        spans.append((off, size))
        off += size
        rem -= size
    if rem:
        spans.append((off, rem))            # tail: recursive pad/ladder
    return spans


Point = tuple  # (X, Y, Z) digit planes; Z == 0 encodes infinity


# ---------------------------------------------------------------------------
# Host big-int Jacobian arithmetic (a = 0 curves): the "host" backend of
# msm/fixed_base_mul, the default for a curve on the CPU.
# ---------------------------------------------------------------------------


_J_INF = (1, 1, 0)


def _jdbl(q: int, P: tuple) -> tuple:
    """dbl-2009-l for a=0 on host ints."""
    X, Y, Z = P
    if Z == 0:
        return P
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    t = (X + B) % q
    D = 2 * (t * t - A - C) % q
    E = 3 * A % q
    F = E * E % q
    X3 = (F - 2 * D) % q
    Y3 = (E * (D - X3) - 8 * C) % q
    Z3 = 2 * Y * Z % q
    return (X3, Y3, Z3)


def _jadd(q: int, P: tuple, Q: tuple) -> tuple:
    """add-2007-bl on host ints with explicit special cases."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if Z1 == 0:
        return Q
    if Z2 == 0:
        return P
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    U2 = X2 * Z1Z1 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    S2 = Y2 * Z1 * Z1Z1 % q
    if U1 == U2:
        if S1 != S2:
            return _J_INF
        return _jdbl(q, P)
    H = (U2 - U1) % q
    I = 4 * H * H % q
    J = H * I % q
    rr = 2 * (S2 - S1) % q
    V = U1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * S1 * J) % q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % q * H % q
    return (X3, Y3, Z3)


def _host_pippenger(q: int, scalars: list, jac_pts: list, c: int = 8) -> tuple:
    """Classic bucketed Pippenger over host ints."""
    nbuck = 1 << c
    maxbits = max((s.bit_length() for s in scalars), default=1)
    W = max(1, -(-maxbits // c))
    acc = _J_INF
    for w in range(W - 1, -1, -1):
        if acc[2] != 0:
            for _ in range(c):
                acc = _jdbl(q, acc)
        shift = w * c
        buckets = [None] * nbuck
        for s, P in zip(scalars, jac_pts):
            if P[2] == 0:
                continue
            d = (s >> shift) & (nbuck - 1)
            if d:
                buckets[d] = P if buckets[d] is None \
                    else _jadd(q, buckets[d], P)
        run = _J_INF
        s_w = _J_INF
        for k in range(nbuck - 1, 0, -1):
            if buckets[k] is not None:
                run = _jadd(q, run, buckets[k])
            if run[2] != 0:
                s_w = _jadd(q, s_w, run)
        acc = _jadd(q, acc, s_w)
    return acc


# ---------------------------------------------------------------------------
# Branchless Jacobian group-law formulas over a field-ops object `f`
# (add/sub/mul/square/neg/is_zero/select): Curve evaluates them over Field,
# the digit-major point ops (ops/digits_pallas.py) over _TField.
# ---------------------------------------------------------------------------


def jdbl_formula(f, p):
    """dbl-2009-l for a=0: 3M + 5S."""
    X, Y, Z = p
    A = f.square(X)
    B = f.square(Y)
    C = f.square(B)
    t = f.square(f.add(X, B))
    D = f.add(f.sub(f.sub(t, A), C), f.sub(f.sub(t, A), C))  # 2(t-A-C)
    E = f.add(f.add(A, A), A)                                 # 3A
    F = f.square(E)
    X3 = f.sub(F, f.add(D, D))
    eight_c = f.add(f.add(f.add(C, C), f.add(C, C)),
                    f.add(f.add(C, C), f.add(C, C)))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), eight_c)
    Z3 = f.mul(f.add(Y, Y), Z)
    # Doubling infinity stays infinity (Z=0 -> Z3=0 automatically)
    return (X3, Y3, Z3)


def jadd_formula(f, p, q, select, where_zero):
    """add-2007-bl with doubling/infinity cases resolved by masks.

    `select(pred, a, b)` picks per element between same-shape digit arrays;
    `where_zero(pred, a)` zeroes a where pred (the to-infinity case)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f.square(Z1)
    Z2Z2 = f.square(Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(Y1, f.mul(Z2, Z2Z2))
    S2 = f.mul(Y2, f.mul(Z1, Z1Z1))
    H = f.sub(U2, U1)
    rr = f.add(f.sub(S2, S1), f.sub(S2, S1))      # r = 2(S2-S1)
    I = f.square(f.add(H, H))
    J = f.mul(H, I)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.square(rr), J), f.add(V, V))
    Y3 = f.sub(f.mul(rr, f.sub(V, X3)),
               f.add(f.mul(S1, J), f.mul(S1, J)))
    # Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H = 2 Z1 Z2 H
    Z3 = f.mul(f.sub(f.sub(f.square(f.add(Z1, Z2)), Z1Z1), Z2Z2), H)

    same_x = f.is_zero(H)
    same_y = f.is_zero(f.sub(S2, S1))
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)

    dbl = jdbl_formula(f, p)
    use_dbl = same_x & same_y & ~p_inf & ~q_inf
    to_inf = same_x & ~same_y & ~p_inf & ~q_inf

    X3 = select(use_dbl, dbl[0], X3)
    Y3 = select(use_dbl, dbl[1], Y3)
    Z3 = select(use_dbl, dbl[2], Z3)
    Z3 = where_zero(to_inf, Z3)
    # p or q at infinity -> the other operand
    X3 = select(p_inf, X2, X3)
    Y3 = select(p_inf, Y2, Y3)
    Z3 = select(p_inf, Z2, Z3)
    X3 = select(q_inf, X1, X3)
    Y3 = select(q_inf, Y1, Y3)
    Z3 = select(q_inf, Z1, Z3)
    return (X3, Y3, Z3)


def point_op_path(device_type: str, plain_field: bool, k9_points: int) -> str:
    """Which path ``Curve.add``/``double`` take: "k9" (the digit-major K9
    point ops) when ``_pallas_geometry`` counts the points (at least 2048),
    "kernel" (the point kernel, one launch an op) on a CUDA tensor over a
    plain ``Field`` below that, else "formula" (``jadd_formula``/
    ``jdbl_formula`` over the field object)."""
    if k9_points:
        return "k9"
    if device_type == "cuda" and plain_field:
        return "kernel"
    return "formula"


def _cat_points(*pts):
    return tuple(torch.cat([p[i] for p in pts]) for i in range(3))


class Curve:
    """y^2 = x^3 + b over fq; scalar field order r.  The curve lives on its
    field's device."""

    def __init__(self, fq: Field, b: int, gx: int, gy: int, order: int):
        self.fq = fq
        self.device = fq.device
        self.b = b
        self.b_mont = fq.encode([b])[0]
        self.order = order
        self.gen_affine = (gx, gy)
        self._fb_tables: dict = {}      # host fixed-base window tables

    # -- construction --------------------------------------------------------
    def generator(self, batch=()):
        gx, gy = self.gen_affine
        shape = tuple(batch) + (self.fq.n_limbs,)
        X = self.fq.encode([gx])[0].expand(shape)
        Y = self.fq.encode([gy])[0].expand(shape)
        Z = self.fq.one_mont.expand(shape)
        return (X, Y, Z)

    def infinity(self, batch=()):
        shape = tuple(batch) + (self.fq.n_limbs,)
        one = self.fq.one_mont.expand(shape)
        return (one, one, torch.zeros(shape, dtype=torch.int32,
                                      device=self.device))

    def from_affine_ints(self, xs, ys):
        X = self.fq.encode(xs)
        Y = self.fq.encode(ys)
        Z = self.fq.one_mont.expand(X.shape)
        return (X, Y, Z)

    def to_affine_ints(self, p) -> tuple:
        """Host: decode to (x, y) int arrays + infinity flags, with the
        Z-inversions on the host (Montgomery batch trick, one modexp)."""
        q = self.fq.q
        jac = self._points_to_host(p)
        nz = [pz if pz else 1 for (_, _, pz) in jac]
        prefix = [1] * (len(nz) + 1)
        for i, z in enumerate(nz):
            prefix[i + 1] = prefix[i] * z % q
        inv_all = pow(prefix[-1], -1, q)
        xs = np.zeros(len(jac), dtype=object)
        ys = np.zeros(len(jac), dtype=object)
        inf = np.zeros(len(jac), dtype=bool)
        for i in range(len(jac) - 1, -1, -1):
            zi = prefix[i] * inv_all % q
            inv_all = inv_all * nz[i] % q
            X, Y, Z = jac[i]
            if Z == 0:
                inf[i] = True
            else:
                zi2 = zi * zi % q
                xs[i] = X * zi2 % q
                ys[i] = Y * zi2 % q * zi % q
        if p[0].dim() == 1:                  # unbatched single point
            return xs.reshape(()), ys.reshape(()), inf.reshape(())
        return xs, ys, inf

    def is_infinity(self, p):
        return self.fq.is_zero(p[2])

    def is_on_curve_affine(self, x: int, y: int) -> bool:
        q = self.fq.q
        return (y * y - (x * x * x + self.b)) % q == 0

    # -- group law (branchless) ---------------------------------------------
    def _pallas_geometry(self, p, q=None):
        """Total point count if the digit-major K9 point ops apply, else 0:
        the JAX package's routing rule (plain Field or Field2, same-shape
        operands, at least 2048 points, a multiple of 8)."""
        if type(self.fq) is not Field and type(self.fq) is not Field2:
            return 0
        shapes = [x.shape for x in (p if q is None else p + q)]
        if any(s != shapes[0] for s in shapes):
            return 0            # broadcasting left to the Field path
        total = 1
        for d in shapes[0][:-1]:
            total *= d
        return total if total >= 2048 and total % 8 == 0 else 0

    def _path(self, p, q=None) -> str:
        return point_op_path(p[0].device.type, type(self.fq) is Field,
                             self._pallas_geometry(p, q))

    def double(self, p):
        """dbl-2009-l for a=0: 3M + 5S."""
        path = self._path(p)
        if path == "k9":
            return dp.pallas_jdbl_t(self.fq, p)
        if path == "kernel":
            return dp.pallas_jdbl(self.fq, p)
        return jdbl_formula(self.fq, p)

    def add(self, p, q):
        """add-2007-bl with doubling/infinity cases resolved by masks."""
        path = self._path(p, q)
        if path == "k9":
            return dp.pallas_jadd_t(self.fq, p, q)
        if path == "kernel":
            return dp.pallas_jadd(self.fq, p, q)
        f = self.fq
        return jadd_formula(
            f, p, q, select=f.select,
            where_zero=lambda pred, a: f.select(pred, torch.zeros_like(a),
                                                a))

    def negate(self, p):
        X, Y, Z = p
        return (X, self.fq.neg(Y), Z)

    # -- scalar multiplication ----------------------------------------------
    def scalar_mul(self, scalar_limbs, p, window: int = 4):
        """[s]P via fixed-window (2^w-entry table) double-and-add, batched.

        scalar_limbs: (..., Ls) int32 with uint32 bits, little-endian (Fr
        residues, NOT Montgomery form).  The table takes 2^w - 2 batched
        adds; then ceil(bits/w) rounds of w doubles + one table gather + one
        add."""
        f = self.fq
        Ls = scalar_limbs.shape[-1]
        nbits = 32 * Ls
        w = window
        if 32 % w:
            raise ValueError(f"window {w} does not divide 32")
        batch = tuple(scalar_limbs.shape[:-1])
        shape = batch + (f.n_limbs,)
        base = tuple(c.expand(shape) for c in p)
        # table[j] = [j]P, j in [0, 2^w)
        rows = [self.infinity(batch), base]
        for _ in range((1 << w) - 2):
            rows.append(self.add(rows[-1], base))
        table = tuple(torch.stack([r[i] for r in rows]) for i in range(3))

        acc = self.infinity(batch)
        for i in range(nbits // w):
            # the window starting at bit nbits - (i+1)*w, MSB first
            for _ in range(w):
                acc = self.double(acc)
            shift_bits = nbits - (i + 1) * w
            limb = scalar_limbs[..., shift_bits // 32]
            # arithmetic >> then the mask: the low w bits of the window
            nib = ((limb >> (shift_bits % 32)) & ((1 << w) - 1)).long()
            idx = nib[None, ..., None].expand((1,) + shape)
            sel = tuple(torch.gather(t, 0, idx)[0] for t in table)
            acc = self.add(acc, sel)
        return acc

    # -- multi-scalar multiplication -----------------------------------------
    def _msm_pippenger_impl(self, scalar_limbs, points, c: int = 8):
        """Pippenger bucket MSM with sorts, gathers and prefix scans instead
        of a scatter into buckets:

          1. split every scalar into W = bits/c unsigned c-bit digits;
          2. per window, sort the points by digit (stable argsort + gather);
          3. prefix sums of the group add over the sorted points: within
             groups of g (log2(g) full-width adds), over the group totals
             (log2(n/g) adds at 1/g width), combined at the gathered bucket
             boundaries (one 255-wide add);
          4. the sum of points with digit <= k is C[e_k] with
             e_k = searchsorted(digits, k, 'right') - 1, so the window sum is
             S_w = (2^c - 1)*C_tot - sum_{k=0}^{2^c-2} C[e_k];
          5. Horner over windows: acc = 2^c * acc + S_w (c doubles + 1 add).
        """
        f = self.fq
        X, Y, Z = points
        n, Ls = scalar_limbs.shape
        per = 32 // c
        W = Ls * per
        nbuck = 1 << c
        dev = scalar_limbs.device

        # 1. digits (n, W), window 0 = least significant; the arithmetic >>
        #    of an int32 limb keeps the low c bits of each window after the
        #    mask
        shifts = torch.arange(per, dtype=torch.int32, device=dev) * c
        digits = ((scalar_limbs[..., None] >> shifts) & (nbuck - 1)) \
            .reshape(n, W)

        # 2. per-window sort of points by digit (stable, as jnp.argsort)
        order = torch.argsort(digits, dim=0, stable=True)        # (n, W)
        dsort = torch.gather(digits, 0, order)                    # (n, W)
        Xs, Ys, Zs = X[order], Y[order], Z[order]                 # (n, W, L)

        # 3. within-group inclusive prefix sums, then over group totals
        g = 8
        while n % g:
            g //= 2
        ngroups = n // g
        shp = Xs.shape[1:]
        Wx = Xs.reshape((ngroups, g) + shp)
        Wy = Ys.reshape((ngroups, g) + shp)
        Wz = Zs.reshape((ngroups, g) + shp)
        posg = torch.arange(g, device=dev).reshape((1, g) + (1,) * len(shp))
        if g > 1:
            for i in range(max(1, g.bit_length() - 1)):
                sh = 1 << i
                sx = torch.roll(Wx, sh, dims=1)
                sy = torch.roll(Wy, sh, dims=1)
                sz = torch.where(posg < sh, 0, torch.roll(Wz, sh, dims=1))
                Wx, Wy, Wz = self.add((Wx, Wy, Wz), (sx, sy, sz))
        Tx, Ty, Tz = self._prefix_scan_add((Wx[:, -1], Wy[:, -1], Wz[:, -1]))
        # exclusive version: shift down one group, identity (Z=0) in front
        Ex = torch.cat([Tx[:1], Tx[:-1]])
        Ey = torch.cat([Ty[:1], Ty[:-1]])
        Ez = torch.cat([torch.zeros_like(Tz[:1]), Tz[:-1]])
        Wxf = Wx.reshape((n,) + shp)
        Wyf = Wy.reshape((n,) + shp)
        Wzf = Wz.reshape((n,) + shp)

        # 4. C[e_k] for k = 0..2^c-2 per window: the within-group prefix at
        #    e_k plus the exclusive sum of the groups before it
        ks = torch.arange(nbuck - 1, dtype=dsort.dtype, device=dev)
        e = torch.searchsorted(dsort.T.contiguous(),
                               ks.expand(W, nbuck - 1).contiguous(),
                               right=True).T - 1                  # (255, W)
        empty = e < 0
        idx = e.clamp(min=0)[..., None]                           # (255, W, 1)

        def bound_gather(Wf, T):
            i1 = idx.expand(idx.shape[:2] + (Wf.shape[-1],))
            i2 = (idx // g).expand(idx.shape[:2] + (T.shape[-1],))
            return torch.gather(Wf, 0, i1), torch.gather(T, 0, i2)

        wx, ex = bound_gather(Wxf, Ex)
        wy, ey = bound_gather(Wyf, Ey)
        wz, ez = bound_gather(Wzf, Ez)
        Gx, Gy, Gz = self.add((wx, wy, wz), (ex, ey, ez))
        Gz = torch.where(empty[..., None], torch.zeros_like(Gz), Gz)

        # sum the 255 gathered prefixes per window (negated): the last
        # element of another prefix scan
        sums = self._prefix_scan_add((Gx, f.neg(Gy), Gz))
        negsum = (sums[0][-1], sums[1][-1], sums[2][-1])          # (W, L)

        # (2^c - 1) * C_tot  =  2^c * C_tot - C_tot
        ctot = (Tx[-1], Ty[-1], Tz[-1])
        m = self._double_n(ctot, c)
        m = self.add(m, self.negate(ctot))
        Sx, Sy, Sz = self.add(m, negsum)                          # (W, L)

        # 5. Horner over windows, most significant first
        acc = (Sx[-1], Sy[-1], Sz[-1])
        for i in range(1, W):
            w = W - 1 - i
            acc = self._double_n(acc, c)
            acc = self.add(acc, (Sx[w], Sy[w], Sz[w]))
        return acc

    def _double_n(self, p, k: int):
        """[2^k]p by k doubles."""
        for _ in range(k):
            p = self.double(p)
        return p

    def _prefix_scan_add(self, pts):
        """Inclusive prefix sums of the group op along axis 0, batched over
        trailing axes: Hillis-Steele with a masked roll, log2(n) adds.
        Wrapped-around entries are masked to the identity (Z = 0)."""
        X, Y, Z = pts
        n = X.shape[0]
        steps = max(1, (n - 1).bit_length())
        pos = torch.arange(n, device=X.device).reshape(
            (n,) + (1,) * (X.dim() - 1))
        for i in range(steps):
            sh = 1 << i
            sx = torch.roll(X, sh, dims=0)
            sy = torch.roll(Y, sh, dims=0)
            sz = torch.where(pos < sh, 0, torch.roll(Z, sh, dims=0))
            X, Y, Z = self.add((X, Y, Z), (sx, sy, sz))
        return X, Y, Z

    # -- host <-> device point conversion -------------------------------------
    def _scalars_to_ints(self, scalar_limbs) -> list:
        return [int(v) for v in
                lb.limbs_to_ints(scalar_limbs).reshape(-1)]

    def _points_to_host(self, pts) -> list:
        """Montgomery planes -> Jacobian host int tuples."""
        f = self.fq
        X = np.atleast_1d(f.decode(pts[0]))
        Y = np.atleast_1d(f.decode(pts[1]))
        Z = np.atleast_1d(f.decode(pts[2]))
        return [(int(x), int(y), int(z)) for x, y, z in zip(X, Y, Z)]

    def _points_from_host(self, jac_list: list):
        """Jacobian host int tuples -> (n,) Montgomery planes on the curve's
        device (batch Z-inversion with the Montgomery trick: one modexp)."""
        q = self.fq.q
        zs = [p[2] for p in jac_list]
        nz = [z if z else 1 for z in zs]
        prefix = [1] * (len(nz) + 1)
        for i, z in enumerate(nz):
            prefix[i + 1] = prefix[i] * z % q
        inv_all = pow(prefix[-1], -1, q)
        xs, ys, zflags = [0] * len(zs), [0] * len(zs), [0] * len(zs)
        for i in range(len(nz) - 1, -1, -1):
            zi = prefix[i] * inv_all % q
            inv_all = inv_all * nz[i] % q
            X, Y, Z = jac_list[i]
            if Z == 0:
                xs[i] = ys[i] = 1          # matches infinity(): X=Y=1, Z=0
            else:
                zi2 = zi * zi % q
                xs[i] = X * zi2 % q
                ys[i] = Y * zi2 % q * zi % q
                zflags[i] = 1
        f = self.fq
        return (f.encode(xs), f.encode(ys), f.encode(zflags))

    def _default_backend(self) -> str:
        return "host" if self.device.type == "cpu" else "device"

    def fixed_base_mul(self, scalars, base_affine: tuple | None = None,
                       backend: str | None = None):
        """[s_i]B for one shared base point -> (n,) points.

        scalars: host ints.  ``backend`` defaults to "host" for a curve on
        the CPU (a cached 8-bit-window fixed-base table; every scalar costs
        <= 32 additions) and "device" on the card (one batched ladder for
        all n scalars)."""
        if base_affine is None:
            base_affine = self.gen_affine
        if backend is None:
            backend = self._default_backend()
        scalars = [int(s) % self.order for s in scalars]
        if backend == "device":
            g = self.from_affine_ints([base_affine[0]], [base_affine[1]])
            return self.scalar_mul(
                lb.limbs_from_ints(scalars, 8, self.device),
                (g[0][0], g[1][0], g[2][0]))
        q = self.fq.q
        tbl = self._fb_tables.get(base_affine)
        if tbl is None:
            # tbl[w][d] = [d * 256^w] B, built with ~32*255 additions
            tbl = []
            P = (base_affine[0], base_affine[1], 1)
            for _ in range(32):
                row = [_J_INF] * 256
                acc = _J_INF
                for d in range(1, 256):
                    acc = _jadd(q, acc, P)
                    row[d] = acc
                tbl.append(row)
                P = _jadd(q, acc, P)            # [256] B_w
            self._fb_tables[base_affine] = tbl
        out = []
        for s in scalars:
            acc = _J_INF
            w = 0
            while s:
                d = s & 255
                if d:
                    acc = _jadd(q, acc, tbl[w][d])
                s >>= 8
                w += 1
            out.append(acc)
        return self._points_from_host(out)

    def msm(self, scalar_limbs, points, pad_pow2: bool = True,
            min_pippenger: int = 128, backend: str | None = None):
        """sum_i s_i * P_i.

        ``backend`` defaults to "host" (a classic big-int Pippenger) for a
        curve on the CPU and to "device" on the card; a CUDA curve takes the
        host path only when the caller passes ``backend="host"``.  The
        device path covers n > 1024 that is not a power of two (or exceeds
        ``NFA_MSM_CHUNK``, default 16384) with descending power-of-two
        chunks; pads to a power of two (zero scalars x infinity), and below
        256 to 256.  For 32 <= n_pad <= 1024 the Pippenger and the
        per-point ladders race once per shape through
        ``utils.dispatch.global_dispatcher()`` and the winner runs, as in
        the JAX package; outside that band the Pippenger runs for n_pad >=
        ``min_pippenger`` and the ladders below."""
        if backend is None:
            backend = self._default_backend()
        if backend == "host":
            svals = self._scalars_to_ints(scalar_limbs)
            jac = self._points_to_host(points)
            res = _host_pippenger(self.fq.q, svals, jac)
            X, Y, Z = self._points_from_host([res])
            return (X[0], Y[0], Z[0])

        n = scalar_limbs.shape[0]
        max_chunk = int(os.environ.get("NFA_MSM_CHUNK", "16384"))
        # <= 0 would make the span loop emit zero-size chunks forever, and a
        # non-power-of-two defeats the shape reuse the chunking exists for
        max_chunk = 1 << (max(max_chunk, 1024).bit_length() - 1)
        if n > 1024 and (n & (n - 1) or n > max_chunk):
            acc = None
            for o, sz in msm_chunk_spans(n, max_chunk):
                part = self.msm(
                    scalar_limbs[o:o + sz],
                    tuple(c[o:o + sz] for c in points),
                    pad_pow2=True, min_pippenger=min_pippenger,
                    backend="device")
                if acc is None:
                    acc = part
                else:
                    s = self.add(tuple(c[None] for c in acc),
                                 tuple(c[None] for c in part))
                    acc = (s[0][0], s[1][0], s[2][0])
            return acc
        n_pad = n
        if pad_pow2 and n & (n - 1):
            n_pad = 1 << (n - 1).bit_length()
        n_pad = max(n_pad, 256)          # one canonical small-MSM shape
        if n_pad > n:
            pad = n_pad - n
            scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
                (pad,) + tuple(scalar_limbs.shape[1:]))])
            points = _cat_points(points, self.infinity((pad,)))
        if 32 <= n_pad <= 1024:
            disp, op = self.msm_race()
            return disp.dispatch(op, scalar_limbs, points)
        if n_pad >= min_pippenger:
            return self._msm_pippenger_impl(scalar_limbs, points)
        return self._msm_ladder(scalar_limbs, points)

    def msm_race(self):
        """(dispatcher, op) of this curve's Pippenger-vs-ladder race, its
        two candidates registered at first use; the op is keyed by the
        field and the curve object, as in the JAX package."""
        from ..utils.dispatch import global_dispatcher
        disp = global_dispatcher()
        op = f"msm_{self.fq.q % 100003}_{id(self)}"
        if not disp.has(op):
            disp.register(op, "pippenger", self._msm_pippenger_impl)
            disp.register(op, "ladder", self._msm_ladder)
        return disp, op

    def _msm_ladder(self, scalar_limbs, points):
        """Small-batch MSM: per-point windowed ladders + tree reduction."""
        X, Y, Z = self.scalar_mul(scalar_limbs, points)
        while X.shape[0] > 1:
            half = X.shape[0] // 2
            s = self.add((X[:half], Y[:half], Z[:half]),
                         (X[half:2 * half], Y[half:2 * half],
                          Z[half:2 * half]))
            if X.shape[0] % 2:
                X, Y, Z = _cat_points(s, (X[-1:], Y[-1:], Z[-1:]))
            else:
                X, Y, Z = s
        return (X[0], Y[0], Z[0])

    def eq(self, p, q):
        """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
        f = self.fq
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = f.square(Z1), f.square(Z2)
        ex = f.eq(f.mul(X1, Z2Z2), f.mul(X2, Z1Z1))
        ey = f.eq(f.mul(Y1, f.mul(Z2, Z2Z2)), f.mul(Y2, f.mul(Z1, Z1Z1)))
        both_inf = f.is_zero(Z1) & f.is_zero(Z2)
        one_inf = f.is_zero(Z1) ^ f.is_zero(Z2)
        return (ex & ey & ~one_inf) | both_inf


def bn254_g1(device=None) -> Curve:
    """BN254 (alt_bn128): y^2 = x^3 + 3, generator (1, 2)."""
    return Curve(bn254_fq(device), b=3, gx=1, gy=2, order=BN254_FR)


def bls12_381_g1(device=None) -> Curve:
    """BLS12-381 G1: y^2 = x^3 + 4, standard generator."""
    gx = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
    gy = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
    return Curve(bls12_381_fq(device), b=4, gx=gx, gy=gy, order=BLS12_381_FR)
