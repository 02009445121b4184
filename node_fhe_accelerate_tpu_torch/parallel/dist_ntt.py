"""Distributed negacyclic NTT: 4-step decomposition with one all-to-all
(counterpart of node_fhe_accelerate_tpu/parallel/dist_ntt.py).

The polynomial's coefficient axis is split over the positions of a mesh
axis and the transform runs as

    twist (psi^j, local)  ->  local N1-point NTTs along the unsplit axis
    -> twiddle multiply (local) -> ALL-TO-ALL transpose between positions
    -> local N2-point NTTs

the Bailey/4-step factorization whose one collective is the all-to-all.
The JAX package builds these transforms in XLA outside any Pallas kernel;
here they are plain limb-plane PyTorch on ``ops/modular.ModCtx`` (on any
device), not the NTT kernels of ``csrc/ntt.cu``.

Where the JAX package writes a ``shard_map`` body that calls
``lax.all_to_all`` inside, the port's ``*_local`` methods take the list of
per-position shards (position order) and return the list of results: the
per-position stages are plain functions mapped over the positions, the
transpose is ``collectives.all_to_all``.  Every power table is built once,
on the host at construction, and moved to a device once per
(direction, device, position); the JAX package builds some inside its
traced bodies, where they run once at trace time.

Correctness oracle: the single-device negacyclic NTT (ops/ntt.py) up to the
4-step's (k1, k2) output ordering.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.modular import ModCtx
from ..ops.ntt import find_primitive_2n_root
from ..ops.u64 import (_add128, _mul_wide, to_lanes, to_planes,
                       u64_from_np)
from .collectives import all_to_all

__all__ = ["DistNTT", "CyclicNTT", "matrix_cyclic_ntt"]


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _moveaxis(planes, src, dst):
    return tuple(torch.movedim(p, src, dst) for p in planes)


def _reshape(planes, shape):
    return tuple(p.reshape(shape) for p in planes)


class _DeviceTables:
    """Host uint64 tables moved to each device once, as int64 lanes."""

    def __init__(self):
        self._cache = {}

    def get(self, key, device, build):
        k = (key, str(device))
        if k not in self._cache:
            self._cache[k] = to_lanes(u64_from_np(build(), device))
        return self._cache[k]


class CyclicNTT:
    """Log-stage cyclic DFT of power-of-two size m over Z_q.

    Forward = Gentleman-Sande DIF (natural in -> BIT-REVERSED out);
    inverse = Cooley-Tukey DIT (bit-reversed in -> natural out, m^-1
    scaled): the pairing absorbs the bit-reversal permutation, as in the
    negacyclic NTTContext (ops/ntt.py).  The local sub-transform of the
    4-step distributed NTT.  Operates along the LAST axis of limb-plane
    pairs, on their device."""

    def __init__(self, m: int, q: int, omega: int):
        if m & (m - 1):
            raise ValueError("m must be a power of two")
        if pow(omega, m, q) != 1 or (m > 1 and pow(omega, m // 2, q) == 1):
            raise ValueError("omega must have exact order m")
        self.m = m
        self.logm = m.bit_length() - 1
        self.q = q
        self.ctx = ModCtx(q)
        self.omega = omega
        omega_inv = pow(omega, -1, q)
        self.m_inv = pow(m, -1, q)
        # GS-DIF stage s: half = m >> (s+1), twiddles omega^(j * 2^s) for j
        # in [0, half), Montgomery-scaled (one mont_mul = exact modmul);
        # the DIT inverse runs the stages backwards with omega^-1
        self._fwd_np = []
        self._inv_np = []
        for s in range(self.logm):
            half = m >> (s + 1)
            tw = [pow(omega, j << s, q) for j in range(half)]
            itw = [pow(omega_inv, j << s, q) for j in range(half)]
            self._fwd_np.append(self._prep(tw).reshape(1, half))
            self._inv_np.append(self._prep(itw).reshape(1, half))
        self._m_inv_c = int(self._prep([self.m_inv])[0])
        self._tables = _DeviceTables()

    def _prep(self, vals) -> np.ndarray:
        r = self.ctx.r_mod_q
        return np.array([int(v) * r % self.q for v in vals], dtype=np.uint64)

    def _tw(self, inverse: bool, s: int, device):
        src = self._inv_np if inverse else self._fwd_np
        return self._tables.get((inverse, s), device, lambda: src[s])

    def forward(self, a):
        """(..., m) natural order -> (..., m) bit-reversed order."""
        ctx, m = self.ctx, self.m
        x = to_lanes(tuple(a))
        batch = x[0].shape[:-1]
        for s in range(self.logm):
            shp = batch + (1 << s, 2, m >> (s + 1))
            xr = _reshape(x, shp)
            u = tuple(p[..., 0, :] for p in xr)
            v = tuple(p[..., 1, :] for p in xr)
            top = ctx._add(u, v)
            bot = ctx._mont_mul(ctx._sub(u, v),
                                self._tw(False, s, x[0].device))
            x = tuple(torch.stack([t, b], dim=-2).reshape(batch + (m,))
                      for t, b in zip(top, bot))
        return to_planes(x)

    def inverse(self, a):
        """(..., m) bit-reversed order -> (..., m) natural, m^-1 scaled."""
        ctx, m = self.ctx, self.m
        x = to_lanes(tuple(a))
        batch = x[0].shape[:-1]
        for s in range(self.logm - 1, -1, -1):
            shp = batch + (1 << s, 2, m >> (s + 1))
            xr = _reshape(x, shp)
            u = tuple(p[..., 0, :] for p in xr)
            wv = ctx._mont_mul(tuple(p[..., 1, :] for p in xr),
                               self._tw(True, s, x[0].device))
            top, bot = ctx._add(u, wv), ctx._sub(u, wv)
            x = tuple(torch.stack([t, b], dim=-2).reshape(batch + (m,))
                      for t, b in zip(top, bot))
        c = self._m_inv_c
        return to_planes(ctx._mont_mul(x, (c & 0xFFFFFFFF, c >> 32)))


_W_CACHE = {}


def _w_matrix(q: int, w: int, m: int, scale: int, device):
    """The DFT matrix W[i, j] = scale * w^(i j) mod q as lanes on
    ``device``, built once per (q, w, m, scale, device)."""
    key = (q, w, m, scale, str(device))
    if key not in _W_CACHE:
        W = np.empty((m, m), dtype=np.uint64)
        for i in range(m):
            for j in range(m):
                W[i, j] = pow(w, i * j, q) * scale % q
        _W_CACHE[key] = to_lanes(u64_from_np(W, device))
    return _W_CACHE[key]


def _mat_mod_mul(ctx: ModCtx, w_lanes, a_lanes):
    """C = W @ A mod q on lanes: W (M, M), A (M, ...); the u128 column sums
    accumulate, one reduction per output."""
    M = w_lanes[0].shape[0]
    acc = None
    for k in range(M):
        ak = (a_lanes[0][k][None], a_lanes[1][k][None])
        wshape = (M,) + (1,) * (ak[0].dim() - 1)
        wk = (w_lanes[0][:, k].reshape(wshape),
              w_lanes[1][:, k].reshape(wshape))
        prod = _mul_wide(wk, ak)                          # (M, ...)
        acc = prod if acc is None else _add128(acc, prod)
    return ctx._reduce_128(acc)


def matrix_cyclic_ntt(ctx: ModCtx, omega: int, m: int, a_planes,
                      inverse: bool = False):
    """Cyclic DFT of size m along axis 0 via the W matrix (MatrixNTT)."""
    q = ctx.q
    w = pow(omega, -1, q) if inverse else omega
    scale = pow(m, -1, q) if inverse else 1
    W = _w_matrix(q, w, m, scale, a_planes[0].device)
    return to_planes(_mat_mod_mul(ctx, W, to_lanes(tuple(a_planes))))


class DistNTT:
    """Sharded negacyclic NTT over the positions of a mesh axis.

    N = n1 * n2; coefficients arrive as (..., N) and are laid out as the
    (j1, j2) grid (..., n1, n2) with the j2 columns split over the
    positions in n2/P-column blocks.  ``forward_local`` and friends take
    and return the per-position shards; ``reference_forward`` computes the
    same result on the host for equivalence tests."""

    def __init__(self, degree: int, q: int, n1: int, axis_name: str = "data"):
        if degree % n1:
            raise ValueError("n1 must divide N")
        self.n = degree
        self.n1 = n1
        self.n2 = degree // n1
        self.q = q
        self.ctx = ModCtx(q)
        self.axis_name = axis_name
        self.psi = find_primitive_2n_root(degree, q)
        self.omega = self.psi * self.psi % q
        self.w1 = pow(self.omega, self.n2, q)   # order n1
        self.w2 = pow(self.omega, self.n1, q)   # order n2
        n, n2 = degree, self.n2

        # host tables, each built once
        self.twist = np.array([pow(self.psi, j, q) for j in range(n)],
                              dtype=np.uint64)
        # inter-step twiddles omega^(k1*j2), (n1, n2)
        self.step_tw = np.array(
            [[pow(self.omega, k1 * j2, q) for j2 in range(n2)]
             for k1 in range(n1)], dtype=np.uint64).reshape(n1, n2)

        # ---- log-stage local transforms (production path) ----
        self.c1 = CyclicNTT(n1, q, self.w1)
        self.c2 = CyclicNTT(n2, q, self.w2)
        logn1 = n1.bit_length() - 1
        omega_inv = pow(self.omega, -1, q)
        psi_inv = pow(self.psi, -1, q)
        # step twiddles with k1 rows in the local transform's BITREV order
        brv = [_bit_reverse(pos, logn1) for pos in range(n1)]
        self.step_tw_brv = np.array(
            [[pow(self.omega, k1 * j2, q) for j2 in range(n2)]
             for k1 in brv], dtype=np.uint64).reshape(n1, n2)
        self.step_tw_brv_inv = np.array(
            [[pow(omega_inv, k1 * j2, q) for j2 in range(n2)]
             for k1 in brv], dtype=np.uint64).reshape(n1, n2)
        # the twist factors psi^(j1*n2) a row and psi^(j2) a column, each
        # direction
        self._twist_rows = {
            inv: np.array([pow(base, r * n2, q) for r in range(n1)],
                          dtype=np.uint64)
            for inv, base in ((False, self.psi), (True, psi_inv))}
        self._twist_cols = {
            inv: np.array([pow(base, c, q) for c in range(n2)],
                          dtype=np.uint64)
            for inv, base in ((False, self.psi), (True, psi_inv))}
        self._tables = _DeviceTables()
        self._local_twist = {}

    # -- host reference ---------------------------------------------------
    def reference_forward(self, a_np: np.ndarray) -> np.ndarray:
        """Host oracle: X[k2*n1+k1] = sum_j twist_j a_j omega^(k j) with the
        4-step output ordering."""
        q = self.q
        n = self.n
        at = [int(x) * int(t) % q for x, t in zip(a_np, self.twist)]
        out = np.empty(n, dtype=np.uint64)
        for k in range(n):
            k1, k2 = k % self.n1, k // self.n1
            s = 0
            for j in range(n):
                s = (s + at[j] * pow(self.omega,
                                     (k1 + self.n1 * k2) * j, q)) % q
            out[k] = s
        return out

    # -- device tables ----------------------------------------------------
    def _lanes(self, name: str, device):
        return self._tables.get(name, device, lambda: getattr(self, name))

    def _twist_table(self, inverse: bool, device, idx: int, cols: int):
        """psi^(+-(j1*n2 + j2)) for the (n1, cols) block of columns
        [idx*cols, (idx+1)*cols), as lanes, built once per (direction,
        device, position)."""
        key = (inverse, str(device), idx, cols)
        if key not in self._local_twist:
            rows = self._tables.get(("rows", inverse), device,
                                    lambda: self._twist_rows[inverse])
            col = self._tables.get(
                ("cols", inverse), device,
                lambda: self._twist_cols[inverse])
            col = tuple(c[idx * cols:(idx + 1) * cols][None, :] for c in col)
            self._local_twist[key] = self.ctx._mul(
                tuple(r[:, None] for r in rows), col)
        return self._local_twist[key]

    def _mul_lanes(self, planes, lanes):
        return to_planes(self.ctx._mul(to_lanes(tuple(planes)), lanes))

    # -- single-device 4-step ---------------------------------------------
    def forward_4step(self, planes):
        """Single-device 4-step forward (matrix sub-transforms): (..., N) ->
        (..., N) in the (k1 + n1*k2) ordering."""
        ctx = self.ctx
        n1, n2 = self.n1, self.n2
        batch = planes[0].shape[:-1]
        dev = planes[0].device
        x = self._mul_lanes(planes, self._lanes("twist", dev))
        # (j1, j2) grid, row-major j = j1*n2 + j2; N1-point NTTs along j1
        x = _moveaxis(_reshape(x, batch + (n1, n2)), -2, 0)
        y = matrix_cyclic_ntt(ctx, self.w1, n1, x)        # (k1, ..., n2)
        st = tuple(s.reshape((n1,) + (1,) * len(batch) + (n2,))
                   for s in self._lanes("step_tw", dev))
        y = self._mul_lanes(y, st)
        # N2-point NTTs along j2
        z = matrix_cyclic_ntt(ctx, self.w2, n2, _moveaxis(y, -1, 0))
        # (k2, k1, ...) -> (..., k2, k1) flattened: X[k2*n1 + k1]
        z = _moveaxis(z, (0, 1), (-2, -1))
        return _reshape(z, batch + (self.n,))

    # -- sharded: matrix sub-transforms -----------------------------------
    def forward_sharded(self, shards: list) -> list:
        """Per-position shards (..., n1, n2/P) of the (j1, j2) grid (j2
        split) -> shards (..., n2, n1/P) of the (k2, k1) output grid (k1
        split), with matrix sub-transforms and one all-to-all."""
        ctx = self.ctx
        n1, n2 = self.n1, self.n2
        P = len(shards)
        rows = n1 // P
        ys = []
        for idx, local in enumerate(shards):
            cols = local[0].shape[-1]
            dev = local[0].device
            x = self._mul_lanes(local,
                                self._twist_table(False, dev, idx, cols))
            y = matrix_cyclic_ntt(ctx, self.w1, n1, _moveaxis(x, -2, 0))
            y = _moveaxis(y, 0, -2)                       # (..., n1, cols)
            st = tuple(s[:, idx * cols:(idx + 1) * cols]
                       for s in self._lanes("step_tw", dev))
            y = self._mul_lanes(y, st)
            ys.append(_reshape(y, y[0].shape[:-2] + (P, rows, cols)))
        out = []
        for g in self._transpose_fwd(ys):                  # (..., rows, n2)
            z = matrix_cyclic_ntt(ctx, self.w2, n2, _moveaxis(g, -1, 0))
            out.append(_moveaxis(z, 0, -2))               # (..., n2, rows)
        return out

    def _transpose_fwd(self, ys: list) -> list:
        """All-to-all from j2-split (..., P, rows, cols) blocks to k1-split
        (..., rows, n2): position d receives k1 block d of every
        position's columns."""
        P = len(ys)
        nd = ys[0][0].dim()
        g = all_to_all(ys, split_dim=nd - 3, concat_dim=nd - 1)
        out = []
        for gl in g:                              # (..., rows, cols, P)
            gl = _moveaxis(gl, -1, -2)            # (..., rows, P, cols)
            out.append(_reshape(gl, gl[0].shape[:-3]
                                + (gl[0].shape[-3], P * gl[0].shape[-1])))
        return out

    # ------------------------------------------------------------------
    # Production path: log-stage locals, full round trip, negacyclic mul
    # ------------------------------------------------------------------
    # Transform-domain layout ("dist-NTT order"): the shard of position d
    # has shape (..., n2, n1/P) and holds positions (k2_pos, k1_pos) of the
    # BITREV-ordered (k2, k1) grid, k1 positions [d*rows, (d+1)*rows).  The
    # ordering is internal: pointwise ops are elementwise and
    # inverse_local undoes it exactly.

    def _twist_local(self, planes, idx: int, inverse: bool = False):
        """Multiply a position's (..., n1, cols) columns by
        psi^(j1*n2 + j2) (or its inverse), j2 = idx*cols + local column."""
        cols = planes[0].shape[-1]
        return self._mul_lanes(planes, self._twist_table(
            inverse, planes[0].device, idx, cols))

    def forward_local(self, shards: list) -> list:
        """In: per-position (..., n1, n2/P) shards of the (j1, j2)
        coefficient grid (j2 split).  Out: dist-NTT-order shards
        (..., n2, n1/P).  One all-to-all."""
        n1 = self.n1
        P = len(shards)
        rows = n1 // P
        ys = []
        for idx, local in enumerate(shards):
            cols = local[0].shape[-1]
            x = self._twist_local(local, idx)
            # local N1 DFT along j1 (axis -2) -> k1 positions (bitrev order)
            y = _moveaxis(self.c1.forward(_moveaxis(x, -2, -1)), -1, -2)
            # step twiddles omega^(k1 * j2), k1 in bitrev row order
            st = tuple(s[:, idx * cols:(idx + 1) * cols]
                       for s in self._lanes("step_tw_brv", x[0].device))
            y = self._mul_lanes(y, st)
            ys.append(_reshape(y, y[0].shape[:-2] + (P, rows, cols)))
        # local N2 DFT along j2 (full axis) -> k2 positions (bitrev order)
        return [_moveaxis(self.c2.forward(g), -1, -2)
                for g in self._transpose_fwd(ys)]

    def inverse_local(self, shards: list) -> list:
        """The exact inverse of ``forward_local``.  In: dist-NTT-order
        shards (..., n2, n1/P); out: coefficient shards (..., n1, n2/P)."""
        n1, n2 = self.n1, self.n2
        P = len(shards)
        rows = n1 // P
        cols = n2 // P
        ys = []
        for idx, z in enumerate(shards):
            # inverse N2 along k2 (axis -2): bitrev -> natural, n2^-1 scaled
            y = self.c2.inverse(_moveaxis(z, -2, -1))     # (..., rows, n2)
            # divide out the step twiddles omega^(-k1*j2), this k1 block
            st = tuple(s[idx * rows:(idx + 1) * rows]
                       for s in self._lanes("step_tw_brv_inv", y[0].device))
            y = self._mul_lanes(y, st)
            ys.append(_reshape(y, y[0].shape[:-1] + (P, cols)))
        # all-to-all back: k1-split -> j2-split
        nd = ys[0][0].dim()
        g = all_to_all(ys, split_dim=nd - 2, concat_dim=nd - 3)
        out = []
        for idx, gl in enumerate(g):              # (..., P, rows, cols)
            gl = _reshape(gl, gl[0].shape[:-3] + (n1, cols))
            # inverse N1 along k1 (axis -2): bitrev -> natural, n1^-1 scaled
            x = _moveaxis(self.c1.inverse(_moveaxis(gl, -2, -1)), -1, -2)
            # un-twist (n1^-1 n2^-1 = N^-1 is already applied)
            out.append(self._twist_local(x, idx, inverse=True))
        return out

    def pointwise_local(self, a: list, b: list) -> list:
        """Elementwise product in the dist-NTT domain, position by
        position."""
        return [self.ctx.mul(x, y) for x, y in zip(a, b)]

    def negacyclic_mul_local(self, a: list, b: list) -> list:
        """The full distributed negacyclic multiply on coefficient shards
        (..., n1, n2/P)."""
        return self.inverse_local(self.pointwise_local(
            self.forward_local(a), self.forward_local(b)))
