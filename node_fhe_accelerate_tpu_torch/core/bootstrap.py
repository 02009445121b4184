"""TFHE programmable bootstrap in PyTorch (counterpart of
node_fhe_accelerate_tpu/core/bootstrap.py).

Same torus-2^32 scheme, same key layout and the same exact integer algebra
as the JAX engine, so the two agree bit for bit on shared inputs.  Torus
values are int32 tensors with uint32 bits (ops/u32.py).  Randomness comes
from an explicit ``torch.Generator``; the draws differ from ``jax.random``,
so keys made here are checked by decryption, not by equality.

External-product backends:

* ``"kernel"`` (default): each blind-rotate step is ops/cmux.py
  ``cmux_step`` -- the hand-written Hopper kernel for a CUDA tensor, its
  plain PyTorch version for a CPU tensor.
* ``"mxu"``: the plain ``external_product_mxu`` algebra (rotate, then
  cmux), the reference the kernel is held against.

The reference's "ntt", "crt", fused and adaptive "auto" backends are not
ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import i8 as i8ops
from ..ops.cmux import cmux_step, external_product_plain
from ..ops.u32 import lshr, matmul_mod32
from .torus import TorusRing

__all__ = [
    "TfheParams", "TFHE_BOOT_128", "TFHE_BOOT_128_L2", "TFHE_BOOT_128_K4",
    "TFHE_BOOT_128_K4T",
    "LweCiphertext", "GlweCiphertext", "BootstrapKey", "TfheEngine",
]


@dataclass(frozen=True)
class TfheParams:
    """Torus-2^32 TFHE parameters; the same fields as the JAX package's
    TfheParams, so serialized keys carry across."""

    n_lwe: int = 630
    poly_degree: int = 1024
    glwe_dim: int = 1            # k
    pbs_base_log: int = 7        # gadget base for the bootstrap
    pbs_level: int = 3
    ks_base_log: int = 2         # gadget base for key switching
    ks_level: int = 8
    lwe_noise_std: float = 2.0 ** 17    # absolute torus units (sigma * 2^32)
    glwe_noise_std: float = 2.0 ** 7
    plaintext_modulus: int = 4
    # Drop this many LOW digit planes from the BSK's int8 form ("mxu"
    # backend only): an approximate gadget (see TFHE_BOOT_128_K4T).
    bsk_drop_planes: int = 0


def TFHE_BOOT_128() -> TfheParams:
    return TfheParams()


def TFHE_BOOT_128_L2() -> TfheParams:
    """Level-2 gadget (Bg=2^8, l=2) at k=1, N=1024.  Digits stay int8
    (|d| <= 128) and the int32 accumulation bound holds
    (4096 * 128 * 128 = 2^26)."""
    return TfheParams(pbs_base_log=8, pbs_level=2)


def TFHE_BOOT_128_K4() -> TfheParams:
    """k=4, N=256: the GLWE lattice dimension kN stays 1024 while the
    per-step contraction (l(k+1)N) x ((k+1)PN) shrinks 2.56x against
    k=1/N=1024.  Decode margin at t=4 is Delta/2 = 2^29; the rotation
    rounding drift (~2^25.8 over 630 steps) and the external-product noise
    (~2^24.4 accumulated) stay well inside it.  Sample extract yields the
    same kN = 1024-dim LWE, so the key-switch key keeps its shape."""
    return TfheParams(poly_degree=256, glwe_dim=4,
                      pbs_base_log=8, pbs_level=2)


def TFHE_BOOT_128_K4T() -> TfheParams:
    """K4 geometry with a TRUNCATED (approximate-gadget) bootstrap key: the
    int8 BSK drops its least-significant base-256 digit plane (25% fewer
    MACs per step, same key and hardness).

    **FAILED validation at t=4 -- do NOT use in production.**  The JAX
    package measured the decode failing: output phase-error std 2^27.5,
    max 2^30.6 > the Delta/2 = 2^29 margin.  The naive model (dropped digit
    d0 in [-128, 127] -> per-step std ~2^17.9, ~2^22.5 over 630 steps)
    under-predicts the truncation error ~20x, because the CMux difference's
    digits are test-polynomial-structured, not uniform.  Kept as a measured
    negative result and for noise research.  Requires ext_backend="mxu"."""
    return TfheParams(poly_degree=256, glwe_dim=4,
                      pbs_base_log=8, pbs_level=2, bsk_drop_planes=1)


@dataclass
class LweCiphertext:
    """(a, b) with phase b - <a, s>."""
    a: Any   # int32 (..., n), uint32 bits
    b: Any   # int32 (...)


@dataclass
class GlweCiphertext:
    """Stacked (k+1, N): rows 0..k-1 mask, row k body."""
    data: Any  # int32 (..., k+1, N)


@dataclass
class BootstrapKey:
    """GGSW(s_i) per LWE key bit, in int8 digit-plane form, plus the LWE
    key-switch key.

    * ``ggsw_i8``: int8 (n, lvl, k+1, k+1, P, 2N), the signed base-256
      digit planes of g~ = [g, -g] with the coefficient axis last (P is
      4 - bsk_drop_planes);
    * ``ksk_a``: int32 (kN, ks_level, n); ``ksk_b``: int32 (kN, ks_level).
    """
    ggsw_i8: Any
    ksk_a: Any
    ksk_b: Any
    params: TfheParams


def _i32(v: int) -> int:
    """A uint32 constant as the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


class TfheEngine:
    """Batched torus-2^32 TFHE on one device."""

    def __init__(self, params: TfheParams, ext_backend: str = "kernel",
                 device=None):
        """``device`` defaults to CUDA and raises without a card; pass
        ``device="cpu"`` for the plain PyTorch path."""
        if ext_backend not in ("kernel", "mxu"):
            raise ValueError(f"unknown ext_backend {ext_backend!r}")
        if params.bsk_drop_planes and ext_backend != "mxu":
            raise ValueError(
                "bsk_drop_planes requires ext_backend='mxu' "
                f"(got {ext_backend!r})")
        k, lvl = params.glwe_dim, params.pbs_level
        # int32 accumulation bound: terms * (base/2) * 128 < 2^31
        terms = (k + 1) * lvl * params.poly_degree
        if terms * (1 << (params.pbs_base_log - 1)) * 128 >= (1 << 31):
            raise ValueError(
                "pbs_base_log/level/N too large for exact int32 "
                "accumulation on the int8 path")
        self.p = params
        self.backend = ext_backend
        self.device = resolve_device(device)
        self.ring = TorusRing(params.poly_degree)
        self.t = params.plaintext_modulus
        self.delta = (1 << 32) // self.t

    # ------------------------------------------------------------------
    # Random draws
    # ------------------------------------------------------------------
    def _uniform(self, gen: torch.Generator, shape) -> torch.Tensor:
        x = torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=gen,
                          dtype=torch.int64, device=gen.device)
        return x.to(torch.int32).to(self.device)

    def _bits(self, gen: torch.Generator, shape) -> torch.Tensor:
        x = torch.randint(0, 2, tuple(shape), generator=gen,
                          dtype=torch.int32, device=gen.device)
        return x.to(self.device)

    def _noise(self, gen: torch.Generator, shape, std: float) -> torch.Tensor:
        e = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return torch.round(e).to(torch.int64).to(torch.int32).to(self.device)

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------
    def encode(self, m) -> torch.Tensor:
        m = torch.as_tensor(m, device=self.device).to(torch.int32)
        return m * _i32(self.delta)

    def decode(self, phase: torch.Tensor) -> torch.Tensor:
        """round(phase * t / 2^32) mod t, exact: top bits + rounding."""
        shift = 32 - int(math.log2(self.t))
        return lshr(phase + _i32(1 << (shift - 1)), shift) % self.t

    # ------------------------------------------------------------------
    # LWE
    # ------------------------------------------------------------------
    def lwe_keygen(self, gen: torch.Generator) -> torch.Tensor:
        """Binary LWE secret (n,)."""
        return self._bits(gen, (self.p.n_lwe,))

    def lwe_encrypt(self, gen: torch.Generator, m, sk,
                    noise_std: float | None = None) -> LweCiphertext:
        """b = <a, s> + e + encode(m); batch shape taken from m."""
        enc = self.encode(m)
        a = self._uniform(gen, enc.shape + (self.p.n_lwe,))
        std = self.p.lwe_noise_std if noise_std is None else noise_std
        e = self._noise(gen, enc.shape, std)
        return LweCiphertext(a=a, b=self._dot_u32(a, sk) + e + enc)

    def lwe_phase(self, ct: LweCiphertext, sk) -> torch.Tensor:
        return ct.b - self._dot_u32(ct.a, sk)

    def lwe_decrypt(self, ct: LweCiphertext, sk) -> torch.Tensor:
        return self.decode(self.lwe_phase(ct, sk))

    @staticmethod
    def _dot_u32(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """<a, s> mod 2^32 for a binary s: |sum| <= n * 2^31."""
        bound = math.log2(max(a.shape[-1], 1)) + 31
        return matmul_mod32(a, s.unsqueeze(-1), bound).squeeze(-1)

    @staticmethod
    def lwe_add(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
        return LweCiphertext(a=x.a + y.a, b=x.b + y.b)

    @staticmethod
    def lwe_sub(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
        return LweCiphertext(a=x.a - y.a, b=x.b - y.b)

    @staticmethod
    def lwe_negate(x: LweCiphertext) -> LweCiphertext:
        return LweCiphertext(a=0 - x.a, b=0 - x.b)

    def lwe_add_plain(self, x: LweCiphertext, m) -> LweCiphertext:
        return LweCiphertext(a=x.a, b=x.b + self.encode(m))

    # ------------------------------------------------------------------
    # GLWE
    # ------------------------------------------------------------------
    def glwe_keygen(self, gen: torch.Generator) -> torch.Tensor:
        """Binary GLWE secret: (k, N)."""
        return self._bits(gen, (self.p.glwe_dim, self.p.poly_degree))

    def _mask_dot(self, mask: torch.Tensor, glwe_sk: torch.Tensor
                  ) -> torch.Tensor:
        """sum_i mask_i * s_i over (..., k, N) as one exact matmul against
        the stacked negacyclic matrices of s: |sum| <= kN * 2^31."""
        k, n = self.p.glwe_dim, self.p.poly_degree
        t = self.ring.negacyclic_matrix(glwe_sk).reshape(k * n, n)
        flat = mask.reshape(-1, k * n)
        out = matmul_mod32(flat, t, math.log2(k * n) + 31)
        return out.reshape(mask.shape[:-2] + (n,))

    def glwe_encrypt_zero(self, gen: torch.Generator, glwe_sk,
                          batch=(), noise_std=None) -> GlweCiphertext:
        """(a_1..a_k, b = sum a_i * s_i + e)."""
        k, n = self.p.glwe_dim, self.p.poly_degree
        batch = tuple(batch)
        mask = self._uniform(gen, batch + (k, n))
        std = self.p.glwe_noise_std if noise_std is None else noise_std
        body = self._noise(gen, batch + (n,), std) + \
            self._mask_dot(mask, glwe_sk)
        return GlweCiphertext(data=torch.cat([mask, body.unsqueeze(-2)],
                                             dim=-2))

    def glwe_phase(self, ct: GlweCiphertext, glwe_sk) -> torch.Tensor:
        """body - sum mask_i * s_i."""
        k = self.p.glwe_dim
        return ct.data[..., k, :] - self._mask_dot(ct.data[..., :k, :],
                                                   glwe_sk)

    # ------------------------------------------------------------------
    # GGSW / bootstrap key generation
    # ------------------------------------------------------------------
    def generate_bootstrap_key(self, gen: torch.Generator, lwe_sk,
                               glwe_sk) -> BootstrapKey:
        """GGSW(s_i) per LWE bit in int8 digit-plane form + key-switch key.

        GGSW(v) row (j, l) = GLWE(0) + v * g_l * E_j with
        g_l = 2^(32-(l+1)*base_log) and E_j the unit at component j."""
        p = self.p
        n, k, lvl, N = p.n_lwe, p.glwe_dim, p.pbs_level, p.poly_degree
        # (n, k+1 rows j, lvl, k+1, N)
        ggsw = self.glwe_encrypt_zero(gen, glwe_sk,
                                      batch=(n, k + 1, lvl)).data
        gl = torch.tensor([_i32(1 << (32 - (l + 1) * p.pbs_base_log))
                           for l in range(lvl)], dtype=torch.int32,
                          device=self.device)
        for j in range(k + 1):
            ggsw[:, j, :, j, 0] += lwe_sk[:, None] * gl[None, :]
        g = torch.movedim(ggsw, 2, 1)                     # (n, lvl, j, jp, N)
        ghat = torch.cat([g, 0 - g], dim=-1)
        d8 = i8ops.u32_to_i8_digits(ghat)                 # (..., 2N, P)
        ggsw_i8 = torch.movedim(d8, -1, -2)               # (..., P, 2N)
        ggsw_i8 = ggsw_i8[..., p.bsk_drop_planes:, :].contiguous()

        # key-switch key from the extracted key (kN) to lwe_sk (n)
        s_in = glwe_sk.reshape(k * N)
        gk = torch.tensor([_i32(1 << (32 - (l + 1) * p.ks_base_log))
                           for l in range(p.ks_level)], dtype=torch.int32,
                          device=self.device)
        ksk_a = self._uniform(gen, (k * N, p.ks_level, n))
        e = self._noise(gen, (k * N, p.ks_level), p.lwe_noise_std)
        ksk_b = self._dot_u32(ksk_a, lwe_sk) + e + s_in[:, None] * gk[None, :]
        return BootstrapKey(ggsw_i8=ggsw_i8, ksk_a=ksk_a, ksk_b=ksk_b,
                            params=p)

    # ------------------------------------------------------------------
    # External product / CMux
    # ------------------------------------------------------------------
    def external_product_mxu(self, ggsw_i8_row, glwe_data) -> torch.Tensor:
        """GGSW (x) GLWE as one exact int8 contraction.

        ggsw_i8_row: int8 (lvl, k+1, k+1, P, 2N) digit planes of g~=[g,-g]
        for one LWE bit; glwe_data: int32 (..., k+1, N)."""
        p = self.p
        # Key/engine plane-count agreement: a 4-plane BSK under a drop=1
        # engine (or vice versa) would recombine with the wrong 256^p
        # weights -- fail loudly instead.
        if ggsw_i8_row.shape[-2] != 4 - p.bsk_drop_planes:
            raise ValueError(
                f"BSK has {ggsw_i8_row.shape[-2]} digit planes but engine "
                f"params expect {4 - p.bsk_drop_planes} "
                f"(bsk_drop_planes={p.bsk_drop_planes})")
        return external_product_plain(ggsw_i8_row, glwe_data,
                                      p.pbs_base_log, p.bsk_drop_planes)

    def cmux(self, ggsw_row, ct0_data, ct1_data) -> torch.Tensor:
        """ct0 + GGSW (x) (ct1 - ct0)."""
        return ct0_data + self.external_product_mxu(ggsw_row,
                                                    ct1_data - ct0_data)

    # ------------------------------------------------------------------
    # Blind rotate / sample extract / key switch
    # ------------------------------------------------------------------
    def _rotations(self, x: torch.Tensor, coarse: int = 1) -> torch.Tensor:
        """round(x * 2N / 2^32), exact; with ``coarse`` = K (a power of
        two) rounded to a multiple of K (many-LUT bootstrapping)."""
        bits = self.ring.logn + 1 - (coarse.bit_length() - 1)
        r = 1 << (32 - bits - 1)
        return lshr(x + r, 32 - bits) * coarse

    def blind_rotate(self, acc_data, lwe: LweCiphertext, bsk: BootstrapKey,
                     lut_count: int = 1) -> torch.Tensor:
        """acc <- X^{-b~} acc; then the CMux ladder over the LWE mask, one
        step per bootstrap-key row."""
        p = self.p
        kp1, n = p.glwe_dim + 1, p.poly_degree
        b_rot = 0 - self._rotations(lwe.b, lut_count)
        acc = self.ring.rotate(acc_data, b_rot[..., None])
        lead = acc.shape[:-2]
        acc = acc.reshape(-1, kp1, n).contiguous()
        rots = self._rotations(lwe.a, lut_count).reshape(-1, p.n_lwe)
        rots = rots.t().contiguous()                      # (n_lwe, B)
        g = bsk.ggsw_i8
        if g.shape[0] != p.n_lwe:
            raise ValueError(f"BSK has {g.shape[0]} rows, params say "
                             f"n_lwe={p.n_lwe}")
        for i in range(p.n_lwe):
            if self.backend == "kernel":
                acc = cmux_step(acc, rots[i], g[i], p.pbs_base_log)
            else:
                rotated = self.ring.rotate(acc, rots[i][:, None])
                acc = self.cmux(g[i], acc, rotated)
        return acc.reshape(lead + (kp1, n))

    def sample_extract(self, acc_data) -> LweCiphertext:
        """Constant coefficient as LWE of dim kN: a[i*N] = mask_i[0],
        a[i*N + j] = -mask_i[N-j] for j >= 1; b = body[0]."""
        k, N = self.p.glwe_dim, self.p.poly_degree
        idx = torch.remainder(-torch.arange(N, device=acc_data.device), N)
        vals = acc_data[..., :k, idx]
        a = torch.cat([vals[..., :1], 0 - vals[..., 1:]], dim=-1)
        return LweCiphertext(a=a.reshape(acc_data.shape[:-2] + (k * N,)),
                             b=acc_data[..., k, 0])

    def sample_extract_at(self, acc_data, positions) -> LweCiphertext:
        """Coefficients at ``positions`` (K,) as an LWE batch with a
        LEADING positions axis: a[i*N + j] = mask_i[(p - j) mod N] * (+1 if
        j <= p else -1)."""
        k, N = self.p.glwe_dim, self.p.poly_degree
        dev = acc_data.device
        pos = torch.as_tensor(np.asarray(positions), dtype=torch.long,
                              device=dev)
        j = torch.arange(N, device=dev)
        idx = torch.remainder(pos[:, None] - j[None, :], N)   # (K, N)
        vals = acc_data[..., :k, :][..., idx]                 # (..., k, K, N)
        a = torch.where(j[None, :] <= pos[:, None], vals, 0 - vals)
        a = torch.movedim(a, -2, 0)                           # (K, ..., k, N)
        a = a.reshape((pos.shape[0],) + acc_data.shape[:-2] + (k * N,))
        b = torch.movedim(acc_data[..., k, :][..., pos], -1, 0)
        return LweCiphertext(a=a, b=b)

    def key_switch(self, lwe: LweCiphertext, bsk: BootstrapKey
                   ) -> LweCiphertext:
        """kN-dim -> n-dim via gadget decomposition against the KSK.

        One float64 matmul per output, exact: |digit| <= 2^(ks_base_log-1)
        and |ksk| <= 2^31, so |sum| <= kN * ks_level * 2^(ks_base_log-1)
        * 2^31 (2^46 at K4) < 2^53."""
        p = self.p
        digits = self.ring.decompose(lwe.a, p.ks_base_log, p.ks_level)
        d = torch.movedim(digits, 0, -1)                   # (..., kN, lvl)
        flat = d.reshape(d.shape[:-2] + (-1,))             # (..., kN*lvl)
        kn_l = flat.shape[-1]
        bound = math.log2(kn_l) + (p.ks_base_log - 1) + 31
        ka = bsk.ksk_a.reshape(kn_l, -1)                   # (kN*lvl, n)
        a_out = 0 - matmul_mod32(flat, ka, bound)
        kb = bsk.ksk_b.reshape(kn_l, 1)
        b_out = lwe.b - matmul_mod32(flat, kb, bound).squeeze(-1)
        return LweCiphertext(a=a_out, b=b_out)

    # ------------------------------------------------------------------
    # Bootstrapping
    # ------------------------------------------------------------------
    def default_test_poly(self) -> torch.Tensor:
        """Identity LUT."""
        return self.make_lut(lambda x: x)

    def _poly(self, coeffs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            coeffs.astype(np.uint32).view(np.int32)).to(self.device)

    def make_lut(self, func: Callable[[int], int],
                 out_modulus: int | None = None) -> torch.Tensor:
        """Test polynomial for f: coefficient i holds
        f(round(i * t / 2N)) * Delta; the tail half-window holds -f(0) for
        message 0's negative-noise edge (negacyclic wrap)."""
        N = self.p.poly_degree
        t = self.t
        t_out = out_modulus or t
        delta_out = (1 << 32) // t_out
        i = np.arange(N)
        inputs = ((i * t + N) // (2 * N)) % t
        outs = np.array([int(func(int(v))) % t_out for v in inputs],
                        dtype=np.uint64)
        coeffs = (outs * delta_out) % (1 << 32)
        half_win = N // t
        f0 = int(func(0)) % t_out
        coeffs[N - half_win:] = (-f0 * delta_out) % (1 << 32)
        return self._poly(coeffs)

    def make_many_lut(self, funcs: Sequence[Callable[[int], int]],
                      out_modulus: int | None = None) -> torch.Tensor:
        """Interleaved test polynomial T[K*u + j] = f_j(round(u*t*K/2N)):
        one blind rotate with rotations coarsened to multiples of K
        evaluates all K functions (K a power of two, t*K <= N)."""
        K = len(funcs)
        if K & (K - 1):
            raise ValueError("lut count must be a power of two")
        N, t = self.p.poly_degree, self.t
        t_out = out_modulus or t
        delta_out = (1 << 32) // t_out
        if t * K > N:
            raise ValueError("t * lut_count must be <= N")
        U = N // K
        u = np.arange(U)
        inputs = ((u * t * K + N) // (2 * N)) % t
        coeffs = np.zeros(N, dtype=np.uint64)
        half_win_u = N // (t * K)
        tail = np.arange(U - half_win_u, U)
        for j, f in enumerate(funcs):
            outs = np.array([int(f(int(v))) % t_out for v in inputs],
                            dtype=np.uint64)
            coeffs[K * u + j] = (outs * delta_out) % (1 << 32)
            f0 = int(f(0)) % t_out
            coeffs[K * tail + j] = (-f0 * delta_out) % (1 << 32)
        return self._poly(coeffs)

    def _test_poly_acc(self, batch, test_poly) -> torch.Tensor:
        k, N = self.p.glwe_dim, self.p.poly_degree
        acc = torch.zeros(tuple(batch) + (k + 1, N), dtype=torch.int32,
                          device=self.device)
        acc[..., k, :] = test_poly
        return acc

    def bootstrap_many_lut(self, lwe: LweCiphertext, bsk: BootstrapKey,
                           funcs: Sequence[Callable[[int], int]],
                           out_modulus: int | None = None) -> LweCiphertext:
        """K functions of one encrypted input with ONE blind rotate; the
        result has a leading axis K (result j = f_j(m))."""
        tp = self.make_many_lut(funcs, out_modulus)
        acc = self._test_poly_acc(lwe.b.shape, tp)
        acc = self.blind_rotate(acc, lwe, bsk, lut_count=len(funcs))
        extracted = self.sample_extract_at(acc, np.arange(len(funcs)))
        return self.key_switch(extracted, bsk)

    def bootstrap_with_test_poly(self, lwe: LweCiphertext, bsk: BootstrapKey,
                                 test_poly) -> LweCiphertext:
        """test-poly accumulator -> blind rotate -> extract -> key switch."""
        acc = self._test_poly_acc(lwe.b.shape, test_poly)
        acc = self.blind_rotate(acc, lwe, bsk)
        return self.key_switch(self.sample_extract(acc), bsk)

    def bootstrap(self, lwe: LweCiphertext, bsk: BootstrapKey):
        return self.bootstrap_with_test_poly(lwe, bsk,
                                             self.default_test_poly())

    def programmable_bootstrap(self, lwe: LweCiphertext, bsk: BootstrapKey,
                               lut):
        return self.bootstrap_with_test_poly(lwe, bsk, lut)
