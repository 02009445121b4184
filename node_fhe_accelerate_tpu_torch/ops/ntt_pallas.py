"""Fused negacyclic NTT kernels for Hopper (counterpart of
node_fhe_accelerate_tpu/ops/ntt_pallas.py).

``PallasNTT(ntt)`` gives the same (lo, hi) limb-plane API as its
``NTTContext`` and the same bits:

* ``forward``: all log N Cooley-Tukey stages in one launch (K6);
* ``inverse``: the Gentleman-Sande stages with the N^-1 scale folded into
  the last one, in one launch (K7);
* ``negacyclic_mul``: forward(a), forward(b), the pointwise product and the
  inverse in one launch (K8; below 2^46 its tables hold the twiddles alone,
  as doubles).

A CUDA tensor launches the kernel of ``csrc/ntt.cu`` (built at first use,
see ``_build.py``) or raises; only a CPU tensor takes the plain
``NTTContext`` function.  Each entry counts its launches in
``PallasNTT.launches``.

The kernels hold 2^ELEMS_LOG coefficients of a polynomial in each thread's
registers and run the stages on them in passes of up to ELEMS_LOG stages
(``passes``), exchanging the coefficients through shared memory between
passes.  Below q = 2^46 (``F64_MAX_Q``) they compute on integers held
exactly in doubles; above, with Shoup's product, so each twiddle w comes
with its quotient floor(w 2^64 / q), and with values below 4q between
stages, which needs q < 2^62 (``MAX_Q``).  ``twiddle_table`` lays the
psi^bitrev tables of the ``NTTContext`` out in the order the passes read
them; the tables go to the card once per device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import KernelLibrary, launch
from .ntt import NTTContext

__all__ = ["PallasNTT", "NTT_LIB", "ELEMS_LOG", "MAX_Q", "F64_MAX_Q",
           "passes", "stage_place", "twiddle_table", "shoup_pair"]

_PTR, _INT, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
NTT_LIB = KernelLibrary("ntt.cu", {
    "nfa_ntt_transform": [_PTR] * 5 + [_U64] * 5 + [_INT] * 3 + [_PTR],
    "nfa_ntt_negacyclic_mul": [_PTR] * 8 + [_U64] * 6 + [_INT] * 2 + [_PTR],
})
# Shared memory holds the polynomials in flight as u64: one of N = 16384 is
# 128 KB, and the product holds a and b, so N = 8192 is its largest.
MAX_LOGN_TRANSFORM = 14
MAX_LOGN_MUL = 13
# log2 of the coefficients one thread holds (fewer when N < 16)
ELEMS_LOG = 4
# lazy butterflies keep values below 4q < 2^64
MAX_Q = 1 << 62
# below this the kernels hold the values exactly in doubles instead
F64_MAX_Q = 1 << 46


def passes(logn: int) -> list[tuple[int, int]]:
    """(c_lo, r) of each pass in forward order: a thread holds the
    coefficients whose index bits c_lo .. c_lo + eb - 1 vary (eb =
    min(logn, ELEMS_LOG)), and the pass runs the stages of the top r of
    those bits.  The first pass takes the top logn mod eb bits (eb when
    that is 0), the others eb bits each, down to bit 0; the inverse runs
    the passes in the opposite order."""
    eb = min(logn, ELEMS_LOG)
    r0 = logn % eb or eb
    return [(logn - eb, r0)] + [(logn - r0 - p * eb, eb)
                                for p in range(1, 1 + (logn - r0) // eb)]


def stage_place(logn: int, c: int) -> tuple[int, int, int]:
    """(c_lo, jj, hb) of the stage on index bit c: its pass's lowest
    window bit, c's place in the window, and the bits above the window."""
    eb = min(logn, ELEMS_LOG)
    c_lo = next(lo for lo, r in passes(logn) if lo + eb - r <= c < lo + eb)
    return c_lo, c - c_lo, logn - c_lo - eb


def shoup_pair(w: int, q: int) -> tuple[int, int]:
    """(w, floor(w 2^64 / q)): a twiddle and its Shoup quotient."""
    return w, (w << 64) // q


def twiddle_table(ntt: NTTContext, inverse: bool) -> np.ndarray:
    """The (w, w') pairs of every stage, uint64 (entries, 2), as the
    kernel reads them.  The stage on bit c (m = N >> (c+1) twiddles;
    pair (x, x + 2^c) takes psi^bitrev(m + (x >> (c+1)))) is one block of
    m entries at m - 1 (forward) or N - 2m (inverse, which folds its
    last stage's single twiddle into constants); the twiddle of window
    bits e_hi above c and high bits h is at e_hi 2^hb + h."""
    logn, n, q = ntt.logn, ntt.n, ntt.q
    table = ntt.ipsis if inverse else ntt.psis
    eb = min(logn, ELEMS_LOG)
    out = np.zeros((n - 2 if inverse else n - 1, 2), dtype=np.uint64)
    for c in range(logn - 1 if inverse else logn):
        m = n >> (c + 1)
        c_lo, jj, hb = stage_place(logn, c)
        base = n - 2 * m if inverse else m - 1
        for e_hi in range(1 << (eb - 1 - jj)):
            for h in range(1 << hb):
                w = int(table[m + ((h << (eb - 1 - jj)) | e_hi)])
                out[base + (e_hi << hb) + h] = shoup_pair(w, q)
    return out


class PallasNTT:
    """Forward, inverse and negacyclic product over an ``NTTContext`` in one
    kernel launch each, bit-exact with the context's plain functions.

    Largest degree: N = 16384 for ``forward`` and ``inverse``, N = 8192 for
    ``negacyclic_mul``; on the card q is the context's odd modulus below
    2^62.  Any batch shape: leading axes are flattened."""

    launches = {"forward": 0, "inverse": 0, "negacyclic_mul": 0}

    def __init__(self, ntt: NTTContext):
        self.ntt = ntt
        self.ctx = ntt.ctx
        self.n = ntt.n
        self.logn = ntt.logn
        self._tw = {}

    def last_stage(self, scale: int = 1) -> tuple[int, ...]:
        """Shoup pairs of the inverse's folded last stage, (c, c', d, d')
        with c = N^-1 scale and d = psi^-bitrev(1) N^-1 scale mod q: the
        sum output is multiplied by c, the difference output by d."""
        q = self.ntt.q
        c = self.ntt.n_inv * scale % q
        d = int(self.ntt.ipsis[1]) * c % q
        return shoup_pair(c, q) + shoup_pair(d, q)

    def _tables(self, device, narrow: bool = False):
        """(forward, inverse) ``twiddle_table``s on ``device``: as int64
        tensors with the u64 bits of the (w, w') pairs, or, ``narrow``, the
        twiddles w alone as float64 (exact: w < q < 2^46), which K8 reads
        in its narrow form."""
        key = (str(device), narrow)
        if key not in self._tw:
            tables = [twiddle_table(self.ntt, inv) for inv in (False, True)]
            self._tw[key] = tuple(
                torch.from_numpy(t[:, 0].astype(np.float64) if narrow
                                 else t.view(np.int64)).to(device)
                for t in tables)
        return self._tw[key]

    def _check(self, planes, name: str, max_logn: int):
        lo, hi = planes
        if lo.dtype != torch.int32 or hi.dtype != torch.int32 \
                or lo.shape != hi.shape or lo.device != hi.device:
            raise ValueError(f"{name}: (lo, hi) must be int32 planes of one "
                             "shape on one device")
        if lo.dim() < 1 or lo.shape[-1] != self.n:
            raise ValueError(f"{name}: last axis must be N={self.n}, got "
                             f"{tuple(lo.shape)}")
        if lo.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: tensors on {lo.device}")
        if lo.device.type == "cuda":
            if self.logn > max_logn:
                raise ValueError(f"{name}: N={self.n} exceeds the kernel's "
                                 f"largest degree 2^{max_logn}")
            if self.ntt.q >= MAX_Q:
                raise ValueError(f"{name}: q={self.ntt.q} is not below the "
                                 "kernel's largest modulus 2^62")
        return lo.shape[:-1], lo.device

    def _rows(self, planes):
        """(B, N) contiguous planes with 16-byte aligned rows."""
        out = []
        for p in planes:
            p = p.reshape(-1, self.n).contiguous()
            out.append(p if p.data_ptr() % 16 == 0 else p.clone())
        return out

    def _transform(self, planes, inverse: bool):
        name = "inverse" if inverse else "forward"
        batch, dev = self._check(planes, name, MAX_LOGN_TRANSFORM)
        if dev.type == "cpu":
            return (self.ntt.inverse if inverse else self.ntt.forward)(planes)
        lo, hi = self._rows(planes)
        b = lo.shape[0]
        olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
        if b:
            launch(NTT_LIB.load().nfa_ntt_transform, f"ntt {name}", dev,
                   lo.data_ptr(), hi.data_ptr(), olo.data_ptr(),
                   ohi.data_ptr(), self._tables(dev)[int(inverse)].data_ptr(),
                   self.ntt.q, *self.last_stage(), int(inverse), b, self.logn)
            PallasNTT.launches[name] += 1
        return olo.reshape(batch + (self.n,)), ohi.reshape(batch + (self.n,))

    def forward(self, planes):
        """Negacyclic forward NTT of (lo, hi) int32 planes (..., N)."""
        return self._transform(planes, inverse=False)

    def inverse(self, planes):
        """Negacyclic inverse NTT (with the N^-1 scale) of (..., N)."""
        return self._transform(planes, inverse=True)

    def negacyclic_mul(self, a, b):
        """a * b mod (X^N + 1, q) for planes a, b of one shape (..., N)."""
        batch, dev = self._check(a, "negacyclic_mul", MAX_LOGN_MUL)
        self._check(b, "negacyclic_mul", MAX_LOGN_MUL)
        if a[0].shape != b[0].shape or a[0].device != b[0].device:
            raise ValueError("negacyclic_mul: a and b must share shape and "
                             "device")
        if dev.type == "cpu":
            return self.ntt.negacyclic_mul(a, b)
        alo, ahi, blo, bhi = self._rows((*a, *b))
        n_rows = alo.shape[0]
        olo, ohi = torch.empty_like(alo), torch.empty_like(ahi)
        if n_rows:
            c = self.ctx
            narrow = c.q < F64_MAX_Q
            fwd, inv = self._tables(dev, narrow)
            # the wide form's pointwise Montgomery product leaves a factor
            # R^-1, which the folded last stage takes back with N^-1; the
            # narrow form's product is exact
            launch(NTT_LIB.load().nfa_ntt_negacyclic_mul,
                   "ntt negacyclic_mul", dev, alo.data_ptr(),
                   ahi.data_ptr(), blo.data_ptr(), bhi.data_ptr(),
                   olo.data_ptr(), ohi.data_ptr(), fwd.data_ptr(),
                   inv.data_ptr(), c.q, c.q_inv_neg,
                   *self.last_stage(1 if narrow else c.r_mod_q), n_rows,
                   self.logn)
            PallasNTT.launches["negacyclic_mul"] += 1
        return olo.reshape(batch + (self.n,)), ohi.reshape(batch + (self.n,))
