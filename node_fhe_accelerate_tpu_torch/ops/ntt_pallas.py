"""Fused negacyclic NTT kernels for Hopper (counterpart of
node_fhe_accelerate_tpu/ops/ntt_pallas.py).

``PallasNTT(ntt)`` gives the same (lo, hi) limb-plane API as its
``NTTContext`` and the same bits:

* ``forward``: all log N Cooley-Tukey stages in one launch (K6);
* ``inverse``: the Gentleman-Sande stages and the N^-1 scale in one launch
  (K7);
* ``negacyclic_mul``: forward(a), forward(b), the pointwise product and the
  inverse in one launch (K8).

A CUDA tensor launches the kernel of ``csrc/ntt.cu`` (built at first use,
see ``_build.py``) or raises; only a CPU tensor takes the plain
``NTTContext`` function.  Each entry counts its launches in
``PallasNTT.launches``.  The kernels read the compact Montgomery-scaled
psi^bitrev tables of the ``NTTContext`` (N u64 per direction), copied to
the card once per device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, launch
from .ntt import NTTContext

__all__ = ["PallasNTT", "NTT_LIB"]

_PTR, _INT, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
NTT_LIB = KernelLibrary("ntt.cu", {
    "nfa_ntt_transform": [_PTR] * 5 + [_U64] * 3 + [_INT] * 3 + [_PTR],
    "nfa_ntt_negacyclic_mul": [_PTR] * 8 + [_U64] * 4 + [_INT] * 2 + [_PTR],
})
# Shared memory holds the block's polynomials as u64: one of N = 16384 is
# 128 KB, and the product holds two, so N = 8192 is its largest.
MAX_LOGN_TRANSFORM = 14
MAX_LOGN_MUL = 13


class PallasNTT:
    """Forward, inverse and negacyclic product over an ``NTTContext`` in one
    kernel launch each, bit-exact with the context's plain functions.

    Largest degree: N = 16384 for ``forward`` and ``inverse``, N = 8192 for
    ``negacyclic_mul``; q is the context's odd modulus below 2^63.  Any
    batch shape: leading axes are flattened."""

    launches = {"forward": 0, "inverse": 0, "negacyclic_mul": 0}

    def __init__(self, ntt: NTTContext):
        self.ntt = ntt
        self.ctx = ntt.ctx
        self.n = ntt.n
        self.logn = ntt.logn
        self._tw = {}

    def _tables(self, device):
        """(forward, inverse) Montgomery-scaled tables as int64 tensors with
        u64 bits on ``device`` (every entry is below q < 2^63)."""
        key = str(device)
        if key not in self._tw:
            self._tw[key] = tuple(
                torch.from_numpy(t.view("int64").copy()).to(device)
                for t in (self.ntt.fwd_mont, self.ntt.inv_mont))
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
        if lo.device.type == "cuda" and self.logn > max_logn:
            raise ValueError(f"{name}: N={self.n} exceeds the kernel's "
                             f"largest degree 2^{max_logn}")
        return lo.shape[:-1], lo.device

    def _transform(self, planes, inverse: bool):
        name = "inverse" if inverse else "forward"
        batch, dev = self._check(planes, name, MAX_LOGN_TRANSFORM)
        if dev.type == "cpu":
            return (self.ntt.inverse if inverse else self.ntt.forward)(planes)
        lo, hi = (p.reshape(-1, self.n).contiguous() for p in planes)
        b = lo.shape[0]
        olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
        if b:
            c = self.ctx
            launch(NTT_LIB.load().nfa_ntt_transform, f"ntt {name}", dev,
                   lo.data_ptr(), hi.data_ptr(), olo.data_ptr(),
                   ohi.data_ptr(), self._tables(dev)[int(inverse)].data_ptr(),
                   c.q, c.q_inv_neg, self.ntt.n_inv_mont, int(inverse), b,
                   self.logn)
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
        alo, ahi, blo, bhi = (p.reshape(-1, self.n).contiguous()
                              for p in (*a, *b))
        n_rows = alo.shape[0]
        olo, ohi = torch.empty_like(alo), torch.empty_like(ahi)
        if n_rows:
            c = self.ctx
            fwd, inv = self._tables(dev)
            launch(NTT_LIB.load().nfa_ntt_negacyclic_mul,
                   "ntt negacyclic_mul", dev, alo.data_ptr(),
                   ahi.data_ptr(), blo.data_ptr(), bhi.data_ptr(),
                   olo.data_ptr(), ohi.data_ptr(), fwd.data_ptr(),
                   inv.data_ptr(), c.q, c.q_inv_neg, self.ntt.n_inv_mont,
                   c.r2_mod_q, n_rows, self.logn)
            PallasNTT.launches["negacyclic_mul"] += 1
        return olo.reshape(batch + (self.n,)), ohi.reshape(batch + (self.n,))
