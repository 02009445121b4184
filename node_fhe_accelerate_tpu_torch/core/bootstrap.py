"""TFHE programmable bootstrap in PyTorch (counterpart of
node_fhe_accelerate_tpu/core/bootstrap.py).

Same torus-2^32 scheme, same key layout and the same exact integer algebra
as the JAX engine, so the two agree bit for bit on shared inputs.  Torus
values are int32 tensors with uint32 bits (ops/u32.py).  Randomness comes
from an explicit ``torch.Generator``; the draws differ from ``jax.random``,
so keys made here are checked by decryption, not by equality.

External-product backends, under the reference's names:

* ``"pallas"`` (default; ``"kernel"`` is a synonym): each blind-rotate step
  is ops/cmux.py ``cmux_step``.  The reference switches to precomputed
  tiles when the key carries them; here both of its entries are the one
  kernel that reads the key row as stored, so there is one path.
* ``"pallas_fused"``: the whole ladder in one launch, batch tile outer
  (ops/ladder.py ``blind_rotate_fused``), on the key as stored.
* ``"mxu_fused"``: the whole ladder in one launch, steps outer
  (ops/ladder.py ``blind_rotate_fused_steps``), on the K-major slabs of
  ``prepare_bsk(form="slabs")``.
* ``"mxu"``: the plain ``external_product_mxu`` algebra (rotate, then
  cmux), the reference the kernels are held against.
* ``"ntt"``: the single-prime external product over P_EXT
  (``external_product``) against a key stored NTT-resident in Montgomery
  form (``ggsw_ext``); per step one forward NTT of the digits and one
  inverse NTT of the (k+1) outputs.
* ``"crt"``: the same over both CRT primes (``external_product_crt``,
  key ``ggsw_crt``), exact for every preset gadget, including TFHE_256's
  Bg = 2^10, l = 3 at N = 4096 that the int8 bound and P_EXT both reject;
  per step two forward and two inverse NTT launches.

For a CUDA tensor the kernel backends launch hand-written Hopper kernels
(the CMux kernels, or the NTT kernels of ops/ntt_pallas.py for "ntt" and
"crt", whose pointwise accumulation and CRT recombination stay plain
PyTorch as they stay XLA in the reference); for a CPU tensor each takes its
plain PyTorch version.  The reference's adaptive "auto" race is not ported
yet.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import i8 as i8ops
from ..ops.cmux import (build_all_step_kslabs, build_all_step_tiles,
                        cmux_step, external_product_plain)
from ..ops.ladder import blind_rotate_fused, blind_rotate_fused_steps
from ..ops.u32 import lshr, matmul_mod32
from .torus import P1, P2, TorusRing

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
    # Drop this many LOW digit planes from the BSK's int8 form ("mxu" and
    # "mxu_fused" backends): an approximate gadget (see TFHE_BOOT_128_K4T).
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
    negative result and for noise research.  Requires ext_backend="mxu" or
    "mxu_fused"."""
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
    """GGSW(s_i) per LWE key bit, plus the LWE key-switch key.  The GGSW
    matrix is stored in the form the engine's backend consumes:

    * ``ggsw_i8`` (int8 backends): int8 (n, lvl, k+1, k+1, P, 2N), the
      signed base-256 digit planes of g~ = [g, -g] with the coefficient
      axis last (P is 4 - bsk_drop_planes);
    * ``ggsw_ext`` ("ntt"): (lo, hi) int32 planes, each (n, k+1, lvl, k+1,
      N), of the rows centered mod P_EXT, scaled by R = 2^64 (Montgomery
      form) and NTT'd;
    * ``ggsw_crt`` ("crt"): ((lo1, hi1), (lo2, hi2)), the rows' NTT forms
      mod P1 and mod P2 in that layout;
    * ``ksk_a``: int32 (kN, ks_level, n); ``ksk_b``: int32 (kN, ks_level);
    * ``ggsw_tiles``: per-step diagonal Toeplitz tiles, int8
      (n, lvl, k+1, k+1, P, 2*nt-1, 128, 128), set by
      ``TfheEngine.prepare_bsk(form="tiles")``;
    * ``ggsw_slabs``: per-step rt-major slabs in the reference's layout,
      int8 (n, nt, lvl*(k+1)*N, (k+1)*P*128), as a key converted from the
      JAX package carries them (``convert.bsk_from_numpy``);
    * ``ggsw_kslabs``: the K-major slabs the "mxu_fused" backend reads,
      int8 (n, (k+1)*P*N, lvl*(k+1)*N) (ops/cmux.py
      ``build_all_step_kslabs``), set by ``prepare_bsk(form="slabs")``.
    """
    ksk_a: Any
    ksk_b: Any
    params: TfheParams
    ggsw_i8: Any = None
    ggsw_ext: Any = None
    ggsw_crt: Any = None
    ggsw_tiles: Any = None
    ggsw_slabs: Any = None
    ggsw_kslabs: Any = None


def _row(g, i):
    """Row i of a key form: a tensor, or nested tuples of limb planes."""
    if isinstance(g, torch.Tensor):
        return g[i]
    return tuple(_row(x, i) for x in g)


def _i32(v: int) -> int:
    """A uint32 constant as the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


class TfheEngine:
    """Batched torus-2^32 TFHE on one device."""

    _INT8 = ("pallas", "pallas_fused", "mxu_fused", "mxu")

    def __init__(self, params: TfheParams, ext_backend: str = "pallas",
                 device=None):
        """``ext_backend``: see the module docstring.  ``device`` defaults
        to CUDA and raises without a card; pass ``device="cpu"`` for the
        plain PyTorch path."""
        if ext_backend == "auto":
            raise NotImplementedError(
                "ext_backend 'auto' comes with the slice that ports "
                "utils/dispatch.py (the adaptive race)")
        if ext_backend == "kernel":
            ext_backend = "pallas"
        if ext_backend not in self._INT8 + ("ntt", "crt"):
            raise ValueError(f"unknown ext_backend {ext_backend!r}")
        if params.bsk_drop_planes and ext_backend not in ("mxu",
                                                          "mxu_fused"):
            raise ValueError(
                "bsk_drop_planes requires ext_backend='mxu' or "
                f"'mxu_fused' (got {ext_backend!r})")
        if ext_backend in ("pallas", "pallas_fused", "mxu_fused") \
                and params.poly_degree % 128:
            raise ValueError(f"ext_backend {ext_backend!r} needs "
                             "poly_degree % 128 == 0")
        self.ring = TorusRing(params.poly_degree)
        k, lvl = params.glwe_dim, params.pbs_level
        half_base = 1 << (params.pbs_base_log - 1)
        if ext_backend in self._INT8:
            # int32 accumulation bound: terms * (base/2) * 128 < 2^31
            terms = (k + 1) * lvl * params.poly_degree
            if terms * half_base * 128 >= (1 << 31):
                raise ValueError(
                    "pbs_base_log/level/N too large for exact int32 "
                    "accumulation on the int8 path")
        elif ext_backend == "crt":
            bound = (k + 1) * lvl * params.poly_degree * half_base * (1 << 31)
            if 2 * bound >= P1 * P2:
                raise ValueError("gadget exceeds even the dual-prime bound")
        elif not self.ring.ext_bound_ok(params.pbs_base_log, (k + 1) * lvl):
            raise ValueError(
                "pbs_base_log/level too large for the single-prime "
                "external product (P_EXT); use ext_backend=\"crt\" "
                "(dual-prime) or reduce base_log")
        self.p = params
        self.backend = ext_backend
        self.device = resolve_device(device)
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
    def ggsw_rows(self, gen: torch.Generator, lwe_sk,
                  glwe_sk) -> torch.Tensor:
        """GGSW(s_i) per LWE bit in the torus domain: int32
        (n, k+1 rows j, lvl, k+1, N), the first draws of
        ``generate_bootstrap_key``.

        GGSW(v) row (j, l) = GLWE(0) + v * g_l * E_j with
        g_l = 2^(32-(l+1)*base_log) and E_j the unit at component j."""
        p = self.p
        n, k, lvl = p.n_lwe, p.glwe_dim, p.pbs_level
        ggsw = self.glwe_encrypt_zero(gen, glwe_sk,
                                      batch=(n, k + 1, lvl)).data
        gl = torch.tensor([_i32(1 << (32 - (l + 1) * p.pbs_base_log))
                           for l in range(lvl)], dtype=torch.int32,
                          device=self.device)
        for j in range(k + 1):
            ggsw[:, j, :, j, 0] += lwe_sk[:, None] * gl[None, :]
        return ggsw

    def generate_bootstrap_key(self, gen: torch.Generator, lwe_sk,
                               glwe_sk) -> BootstrapKey:
        """The GGSW rows (``ggsw_rows``) in the form this engine's backend
        consumes, + the key-switch key.  The random draws do not depend on
        the backend: engines of different backends make the same key from
        generators in the same state."""
        p = self.p
        n, k, N = p.n_lwe, p.glwe_dim, p.poly_degree
        ggsw = self.ggsw_rows(gen, lwe_sk, glwe_sk)
        forms = {}
        if self.backend == "ntt":
            # NTT-resident Montgomery form over the external-product prime
            forms["ggsw_ext"] = self.ring.forward_ext_mont(ggsw)
        elif self.backend == "crt":
            # NTT-resident in both CRT primes (standard domain)
            forms["ggsw_crt"] = self.ring.forward(ggsw)
        else:
            g = torch.movedim(ggsw, 2, 1)                 # (n, lvl, j, jp, N)
            ghat = torch.cat([g, 0 - g], dim=-1)
            d8 = i8ops.u32_to_i8_digits(ghat)             # (..., 2N, P)
            ggsw_i8 = torch.movedim(d8, -1, -2)           # (..., P, 2N)
            forms["ggsw_i8"] = \
                ggsw_i8[..., p.bsk_drop_planes:, :].contiguous()
        del ggsw

        # key-switch key from the extracted key (kN) to lwe_sk (n)
        s_in = glwe_sk.reshape(k * N)
        gk = torch.tensor([_i32(1 << (32 - (l + 1) * p.ks_base_log))
                           for l in range(p.ks_level)], dtype=torch.int32,
                          device=self.device)
        ksk_a = self._uniform(gen, (k * N, p.ks_level, n))
        e = self._noise(gen, (k * N, p.ks_level), p.lwe_noise_std)
        ksk_b = self._dot_u32(ksk_a, lwe_sk) + e + s_in[:, None] * gk[None, :]
        return BootstrapKey(ksk_a=ksk_a, ksk_b=ksk_b, params=p, **forms)

    def prepare_bsk(self, bsk: BootstrapKey,
                    form: str | None = None) -> BootstrapKey:
        """Precompute the per-step Toeplitz expansion once per key.

        form="slabs": the K-major slabs the "mxu_fused" ladder kernel reads
        (``ggsw_kslabs``, 8.26 GB at TFHE_BOOT_128_K4), built from
        ``ggsw_i8``.  The reference layout itself is not built here: no
        kernel reads it, and the K-major form replaces it in the prepared
        key (a key converted from the JAX package keeps the slabs it came
        with, unread).  form="tiles": the diagonal 128x128 tiles (6.19 GB
        at K4); no kernel of the port reads them (the per-step kernel takes
        the key row as stored), they are kept for parity with the
        reference.  Default: the form this engine's backend
        consumes.  Idempotent; the returned key drops into every int8
        backend unchanged; a key without the int8 form ("ntt", "crt") is
        returned as it is."""
        if form is None:
            form = "slabs" if self.backend == "mxu_fused" else "tiles"
        if form not in ("slabs", "tiles"):
            raise ValueError(f"unknown form {form!r}: 'slabs' or 'tiles'")
        field = "ggsw_kslabs" if form == "slabs" else "ggsw_tiles"
        if bsk.ggsw_i8 is None or getattr(bsk, field) is not None:
            return bsk
        build = build_all_step_tiles if form == "tiles" \
            else build_all_step_kslabs
        built = build(bsk.ggsw_i8)
        return dataclasses.replace(bsk, **{field: built})

    # ------------------------------------------------------------------
    # External product / CMux
    # ------------------------------------------------------------------
    def _digit_rows(self, glwe_data):
        """Gadget digits of glwe_data (..., k+1, N), as int32
        (lvl, ..., k+1, N)."""
        return self.ring.decompose(glwe_data, self.p.pbs_base_log,
                                   self.p.pbs_level)

    @staticmethod
    def _pair_rows(d_hat, g_row):
        """Align NTT-domain digits (lvl, ..., k+1 j, N) with one key row
        (k+1 j, lvl, k+1 jp, N) for a sum over (j, l): digits become
        (..., j*lvl, 1, N), the row (j*lvl, jp, N)."""
        d = tuple(torch.movedim(x, 0, -2) for x in d_hat)  # (..., j, l, N)
        d = tuple(x.reshape(x.shape[:-3] + (-1, 1, x.shape[-1])) for x in d)
        g = tuple(x.reshape((-1,) + x.shape[2:]) for x in g_row)
        return d, g

    def external_product(self, ggsw_row_ext, glwe_data) -> torch.Tensor:
        """GGSW (x) GLWE over the single prime P_EXT.

        ggsw_row_ext: (lo, hi) Montgomery NTT planes (k+1, lvl, k+1, N) for
        one LWE bit; glwe_data: int32 (..., k+1, N).  One forward NTT of
        the digits, the pointwise Montgomery products summed over (j, l),
        one inverse NTT of the k+1 outputs."""
        ring = self.ring
        d_hat = ring.forward_digits_ext(self._digit_rows(glwe_data))
        d, g = self._pair_rows(d_hat, ggsw_row_ext)
        acc = ring._sum_products(ring.ntt_ext.ctx, d, g, -3, mont=True)
        return ring.inverse_ext_to_torus(acc)

    def external_product_crt(self, ggsw_row_crt, glwe_data) -> torch.Tensor:
        """GGSW (x) GLWE over both CRT primes, exact for every preset
        gadget: |sum| <= terms*N*(B/2)*2^31 < P1*P2/2 ~ 2^76.

        ggsw_row_crt: ((lo1, hi1), (lo2, hi2)) NTT planes, each
        (k+1, lvl, k+1, N), for one LWE bit.  Per prime one forward NTT of
        the digits and one inverse NTT of the k+1 outputs."""
        ring = self.ring
        d_hat = ring.forward_digits(self._digit_rows(glwe_data))
        acc = []
        for i, ctx in enumerate((ring.ntt1.ctx, ring.ntt2.ctx)):
            d, g = self._pair_rows(d_hat[i], ggsw_row_crt[i])
            acc.append(ring._sum_products(ctx, d, g, -3))
        return ring.inverse(tuple(acc))

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
        """ct0 + GGSW (x) (ct1 - ct0), through the external product of the
        key row's form: "ntt" and "crt" take their NTT rows, every other
        backend the int8 row."""
        diff = ct1_data - ct0_data
        if self.backend == "crt":
            return ct0_data + self.external_product_crt(ggsw_row, diff)
        if self.backend == "ntt":
            return ct0_data + self.external_product(ggsw_row, diff)
        return ct0_data + self.external_product_mxu(ggsw_row, diff)

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
        step per bootstrap-key row, routed by backend (module docstring)."""
        p = self.p
        kp1, n = p.glwe_dim + 1, p.poly_degree
        b_rot = 0 - self._rotations(lwe.b, lut_count)
        acc = self.ring.rotate(acc_data, b_rot[..., None])
        lead = acc.shape[:-2]
        acc = acc.reshape(-1, kp1, n).contiguous()
        rots = self._rotations(lwe.a, lut_count).reshape(-1, p.n_lwe)
        rots = rots.t().contiguous()                      # (n_lwe, B)
        g = self._key_form(bsk)
        if self.backend == "mxu_fused":
            # The K-major slabs come from prepare_bsk(form="slabs"); without
            # them they are built here, on every call: prepare once in a
            # service.
            slabs = self.prepare_bsk(bsk, "slabs").ggsw_kslabs
            planes = slabs.shape[1] // (kp1 * n)
            if planes != 4 - p.bsk_drop_planes:
                raise ValueError(
                    f"BSK slabs carry {planes} digit planes but engine "
                    f"params expect {4 - p.bsk_drop_planes}")
            acc = blind_rotate_fused_steps(acc, rots, slabs, p.pbs_base_log,
                                           drop=p.bsk_drop_planes)
        elif self.backend == "pallas_fused":
            acc = blind_rotate_fused(acc, rots, g, p.pbs_base_log)
        else:
            for i in range(p.n_lwe):
                if self.backend == "pallas":
                    acc = cmux_step(acc, rots[i], g[i], p.pbs_base_log)
                else:                             # "mxu", "ntt", "crt"
                    rotated = self.ring.rotate(acc, rots[i][:, None])
                    acc = self.cmux(_row(g, i), acc, rotated)
        return acc.reshape(lead + (kp1, n))

    def _key_form(self, bsk: BootstrapKey):
        """The key's GGSW form this backend consumes, checked against
        n_lwe."""
        field = {"ntt": "ggsw_ext", "crt": "ggsw_crt"}.get(self.backend,
                                                          "ggsw_i8")
        g = getattr(bsk, field)
        if g is None:
            raise ValueError(f"ext_backend {self.backend!r} needs a key with "
                             f"{field}: make it with an engine of this "
                             "backend")
        rows = _row(g, slice(None))
        while not isinstance(rows, torch.Tensor):
            rows = rows[0]
        if rows.shape[0] != self.p.n_lwe:
            raise ValueError(f"BSK has {rows.shape[0]} rows, params say "
                             f"n_lwe={self.p.n_lwe}")
        return g

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

    # ------------------------------------------------------------------
    # Encrypted comparisons.  Message domain: [0, t/2) (the negacyclic
    # half-torus window); results encode 0/1 at Delta.
    # ------------------------------------------------------------------
    def lwe_is_zero(self, lwe: LweCiphertext, bsk: BootstrapKey
                    ) -> LweCiphertext:
        """PBS of [x == 0] (for x in [0, t/2))."""
        lut = self.make_lut(lambda v: 1 if v == 0 else 0)
        return self.programmable_bootstrap(lwe, bsk, lut)

    def lwe_eq(self, a: LweCiphertext, b: LweCiphertext, bsk: BootstrapKey
               ) -> LweCiphertext:
        """Encrypted equality: PBS([a - b == 0]), valid for
        |a - b| < t/2 (the negative wrap passes through the negacyclic
        negation of the LUT window)."""
        return self.lwe_is_zero(self.lwe_sub(a, b), bsk)

    def lwe_gt_threshold(self, lwe: LweCiphertext, threshold: int,
                         bsk: BootstrapKey) -> LweCiphertext:
        """PBS of [x >= threshold] (x in [0, t/2))."""
        lut = self.make_lut(lambda v: 1 if v >= threshold else 0)
        return self.programmable_bootstrap(lwe, bsk, lut)

    def lwe_lt_threshold(self, lwe: LweCiphertext, threshold: int,
                         bsk: BootstrapKey) -> LweCiphertext:
        """PBS of [x < threshold] (x in [0, t/2))."""
        lut = self.make_lut(lambda v: 1 if v < threshold else 0)
        return self.programmable_bootstrap(lwe, bsk, lut)

    def lwe_in_range(self, lwe: LweCiphertext, lo: int, hi: int,
                     bsk: BootstrapKey) -> LweCiphertext:
        """PBS of [lo <= x <= hi] (x in [0, t/2))."""
        lut = self.make_lut(lambda v: 1 if lo <= v <= hi else 0)
        return self.programmable_bootstrap(lwe, bsk, lut)

    def detect_duplicate(self, new_lwe: LweCiphertext, existing: list,
                         bsk: BootstrapKey) -> LweCiphertext:
        """OR of encrypted equalities against existing ballots: the K
        equality tests run as ONE batched PBS (the existing-ballot axis is
        a batch axis of the blind rotate), then the homomorphic bit-sum
        feeds a single threshold PBS."""
        if not existing:
            return LweCiphertext(a=torch.zeros_like(new_lwe.a),
                                 b=torch.zeros_like(new_lwe.b))
        a = torch.stack([ct.a for ct in existing])          # (K, ..., n)
        b = torch.stack([ct.b for ct in existing])          # (K, ...)
        diff = LweCiphertext(a=new_lwe.a[None] - a, b=new_lwe.b[None] - b)
        bits = self.lwe_is_zero(diff, bsk)                  # batched PBS
        # int64 sum, then the low 32 bits: the sum mod 2^32
        acc = LweCiphertext(a=bits.a.sum(dim=0).to(torch.int32),
                            b=bits.b.sum(dim=0).to(torch.int32))
        return self.lwe_gt_threshold(acc, 1, bsk)
