"""Matrix NTT: the four-step NTT as exact float32 matrix multiplies
(counterpart of node_fhe_accelerate_tpu/ops/ntt_mxu.py).

The reference's "matrix NTT" idea (matrix_ntt.cpp:346), done exactly
instead of with float roundoff:

* modulus P_MXU = 2^56 - 2^24 + 1 (prime, two-adicity 24), so elements are
  exactly 7 8-bit digits and the Solinas fold is digit-aligned (2^56 = 7
  digits -> a fold is a 3-digit shift minus the identity);
* a 32-point sub-NTT is ONE float32 matmul against a precomputed
  (32*7, 32*13) block matrix that performs the twiddle contraction and the
  digit convolution at once: every entry is an 8-bit digit and every output
  column sums 32 * 7 * 255^2 < 2^24, so float32 accumulation is exact, and
  TF32 inputs too (an 8-bit digit fits TF32's mantissa);
* N = 1024 = 32 x 32 runs as the classic four-step: row sub-NTTs,
  inter-step twiddles, column sub-NTTs (the factorization of
  parallel/dist_ntt.py).

Forward only, bit-exact against the scalar oracle
(tests/test_torch_ntt_mxu.py).  The JAX package computes it outside any
Pallas kernel, in XLA; here the matmuls are ``torch.matmul`` and the digit
folds plain PyTorch on the input's device.  No global matmul setting is
touched.
"""
from __future__ import annotations

import numpy as np
import torch

from .primes import is_prime
from .ntt import find_primitive_2n_root

__all__ = ["P_MXU", "MxuNTT"]

P_MXU = (1 << 56) - (1 << 24) + 1
D = 7          # digits per element (exactly 56 bits)
COLS = 2 * D - 1


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """x moved one digit up along the last axis (a zero digit in front,
    the top digit dropped)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _pad_to(x: torch.Tensor, d: int) -> torch.Tensor:
    if x.shape[-1] == d:
        return x
    pad = torch.zeros(x.shape[:-1] + (d - x.shape[-1],), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=-1)


class MxuNTT:
    """Cyclic/negacyclic NTT of size n1*n2 over P_MXU via digit matmuls."""

    def __init__(self, degree: int, n1: int = 32):
        if degree % n1:
            raise ValueError("n1 must divide N")
        self.n = degree
        self.n1 = n1
        self.n2 = degree // n1
        p = P_MXU
        assert is_prime(p)
        self.psi = find_primitive_2n_root(degree, p)
        self.omega = self.psi * self.psi % p
        self.w1 = pow(self.omega, self.n2, p)   # order n1
        self.w2 = pow(self.omega, self.n1, p)   # order n2

        # sub-NTT block matrices: M[j*D + d, k*COLS + (d+e)] += W[j,k]_e
        self._m1 = self._sub_ntt_matrix(self.w1, n1)
        self._m2 = self._sub_ntt_matrix(self.w2, self.n2)
        # twist (negacyclic) and inter-step twiddle digit tables
        tw = np.array([pow(self.psi, j, p) for j in range(degree)],
                      dtype=object)
        self._twist = _to_digits_obj(tw).astype(np.float32)
        step = np.empty((n1, self.n2), dtype=object)
        for k1 in range(n1):
            for j2 in range(self.n2):
                step[k1, j2] = pow(self.omega, k1 * j2, p)
        self._step = _to_digits_obj(step).astype(np.float32)
        self._dev = {}

    def _tables(self, device):
        """(m1, m2, twist digits, step digits) as float32 on ``device``,
        moved once."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.from_numpy(t).to(device)
                for t in (self._m1, self._m2, self._twist, self._step))
        return self._dev[key]

    @staticmethod
    def _sub_ntt_matrix(w: int, m: int) -> np.ndarray:
        """(m*D, m*COLS) float32 matrix: the digit-expanded DFT matrix with
        the digit-convolution column mapping built in (digit e of W[j, k]
        at column d + e for every input digit d)."""
        p = P_MXU
        out = np.zeros((m * D, m * COLS), dtype=np.float32)
        for j in range(m):
            for k in range(m):
                wjk = pow(w, j * k, p)
                for e in range(D):
                    digit = (wjk >> (8 * e)) & 0xFF
                    if digit == 0:
                        continue
                    for d in range(D):
                        out[j * D + d, k * COLS + d + e] += digit
        return out

    # -- digit-domain modular reduction -------------------------------------
    @staticmethod
    def _carry_fix(cols: torch.Tensor, rounds: int = 3) -> torch.Tensor:
        """Reduce column magnitudes (< 2^24) toward 8-bit digits; leaves
        digits in [0, 256] (the redundant top bit is the fold's)."""
        x = cols
        for _ in range(rounds):
            x = (x & 255) + _shift_up(x >> 8)
        return x

    @staticmethod
    def _fold_mod_p(cols: torch.Tensor) -> torch.Tensor:
        """(..., C <= 16) int32 digit columns (values < 2^24) -> (..., D)
        digits in [0, 255] of the same value mod P_MXU (possibly a
        non-canonical residue < 2^56, enough for the next stage's exact
        matmul bound).

        Uses 2^56 = 2^24 - 1 (mod p): the high digits H fold to
        (H << 3 digits) - H, which keeps the running value nonnegative even
        though single digits go negative; signed carry ripples (arithmetic
        >> on int32) then settle exactly."""
        x = _pad_to(cols, cols.shape[-1] + 2)
        x = MxuNTT._carry_fix(x, rounds=3)          # digits <= 256
        while x.shape[-1] > D + 1:
            lo = x[..., :D]
            hi = x[..., D:]                          # length <= 11
            m = hi.shape[-1]
            sh = torch.cat([torch.zeros(hi.shape[:-1] + (3,), dtype=x.dtype,
                                        device=x.device), hi], dim=-1)
            width = max(D, m + 3) + 1   # a slack column: no carry drops
            x = _pad_to(lo, width) + _pad_to(sh, width) - _pad_to(hi, width)
            for _ in range(3):
                x = (x & 255) + _shift_up(x >> 8)
        # at most one top digit left (value < 2^57): fold it, then settle
        if x.shape[-1] == D + 1:
            top = x[..., D]
            x = x[..., :D].clone()
            x[..., 3] += top
            x[..., 0] -= top
        # exact signed ripple: a borrow moves one digit a round, and the
        # value stays >= 0, so D + 3 rounds settle it
        for _ in range(D + 3):
            carry_out = x[..., -1] >> 8
            x = (x & 255) + _shift_up(x >> 8)
            # the top carry folds again (the value may cross 2^56)
            x[..., 3] += carry_out
            x[..., 0] -= carry_out
        return x

    # -- elementwise digit multiply (twiddles) ------------------------------
    @staticmethod
    def _ewise_mul(a_digits: torch.Tensor, t_digits: torch.Tensor
                   ) -> torch.Tensor:
        """(..., D) x (..., D) -> (..., COLS) int32 columns via the outer
        product (every column sum < 2^24, exact in float32)."""
        prod = (a_digits.to(torch.float32)[..., :, None]
                * t_digits[..., None, :])          # (..., D, D)
        cols = torch.zeros(prod.shape[:-2] + (COLS,), dtype=torch.float32,
                           device=prod.device)
        for d in range(D):
            cols[..., d: d + D] += prod[..., d, :]
        return cols.to(torch.int32)

    # -- transforms ----------------------------------------------------------
    def forward_negacyclic(self, a_digits: torch.Tensor) -> torch.Tensor:
        """(..., N, D) int32 strict digits -> (..., N, D), output indexed
        X[k2*n1 + k1] (the 4-step ordering; DistNTT.reference_forward's)."""
        n1, n2 = self.n1, self.n2
        batch = tuple(a_digits.shape[:-2])
        m1, m2, twist, step = self._tables(a_digits.device)

        # 1. twist by psi^j (elementwise digit convolution + fold)
        x = self._fold_mod_p(self._ewise_mul(a_digits, twist))
        # 2. grid (j1, j2): j = j1*n2 + j2
        x = x.reshape(batch + (n1, n2, D))
        # 3. row sub-NTTs along j1: (batch, n2, n1*D) @ (n1*D, n1*COLS)
        xt = x.transpose(-3, -2).reshape(batch + (n2, n1 * D))
        y = torch.matmul(xt.to(torch.float32), m1)
        y = y.to(torch.int32).reshape(batch + (n2, n1, COLS))
        y = self._fold_mod_p(y)                       # (batch, n2, k1, D)
        y = y.transpose(-3, -2)                       # (batch, k1, j2, D)
        # 4. inter-step twiddles omega^(k1*j2)
        y = self._fold_mod_p(self._ewise_mul(y, step))
        # 5. column sub-NTTs along j2: matmul with m2
        yt = y.reshape(batch + (n1, n2 * D))
        z = torch.matmul(yt.to(torch.float32), m2)
        z = z.to(torch.int32).reshape(batch + (n1, n2, COLS))
        z = self._fold_mod_p(z)                       # (batch, k1, k2, D)
        # 6. output ordering X[k2*n1 + k1]
        z = z.transpose(-3, -2)                       # (batch, k2, k1, D)
        return z.reshape(batch + (self.n, D))

    # -- host helpers --------------------------------------------------------
    @staticmethod
    def to_digits_host(values: np.ndarray, device=None) -> torch.Tensor:
        """Host ints -> (..., D) int32 digit tensor on ``device`` (default
        CPU)."""
        return torch.from_numpy(_to_digits_obj(
            np.asarray(values, dtype=object))).to(device)

    @staticmethod
    def digits_to_ints(arr) -> np.ndarray:
        """(..., D) digits (tensor or array) -> object ints (< 2^56)."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr, dtype=np.int64)
        out = np.zeros(a.shape[:-1], dtype=object)
        for i in range(a.shape[-1]):
            out += (a[..., i].astype(object) % 256) << (8 * i)
        return out


def _to_digits_obj(x: np.ndarray) -> np.ndarray:
    out = np.empty(x.shape + (D,), dtype=np.int32)
    it = np.nditer(x, flags=["multi_index", "refs_ok"])
    for v in it:
        val = int(v.item())
        for i in range(D):
            out[it.multi_index + (i,)] = (val >> (8 * i)) & 0xFF
    return out
