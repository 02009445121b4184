"""Plain TFHE programmable bootstrap over the torus Z/2^32: the yardstick the
PBS cells hold the program to.

Plain PyTorch integer arithmetic, independent of the program under test (it
imports nothing of it, nor JAX): torus values are int64 tensors in
[0, 2^32), and every negacyclic product is a float64 matrix product that is
exact because each sum stays below 2^53 (checked where the sizes are known).
It runs on whatever device its inputs lie on.

The scheme, as the TFHE library defines it:

* LWE: (a, b) with phase b - <a, s> = m * Delta + e, Delta = 2^32 / t, s
  binary of dimension n;
* GGSW(s_i) row (j, l): a GLWE encryption of zero under the binary GLWE key
  plus s_i * 2^(32 - (l+1) Bg) at coefficient 0 of component j;
* the test polynomial: coefficient c holds f(round(c t / 2N)) * Delta, its
  last N / t coefficients -f(0) * Delta (message 0 with negative noise
  wraps around the negacyclic ring);
* blind rotate: acc = X^(-round(2N b / 2^32)) * (0, ..., 0, tp), then per
  key bit acc += GGSW(s_i) (x) (X^(round(2N a_i / 2^32)) acc - acc);
* the external product decomposes the GLWE with signed digits in
  [-Bg/2, Bg/2) after rounding to the top l * Bg bits (the TFHE library's
  decomposition);
* sample extract of coefficient 0, then the key switch from the kN-bit key
  to the n-bit key through the same decomposition at (ks_base_log,
  ks_level);
* decode: round(phase * t / 2^32) mod t.

Key draws.  ``make_keys`` consumes a ``torch.Generator`` in this order:
LWE key bits (n,), GLWE key bits (k, N), the GGSW masks (n, k+1, l, k, N)
as uniform 32-bit words, their noise (n, k+1, l, N) as rounded float32
normals times sigma_glwe, the key-switch masks (kN, ks_level, n) and their
noise (kN, ks_level) times sigma_lwe.  Each draw is one torch call:
``randint(0, 2)`` in int32 for bits, ``randint(-2^31, 2^31)`` in int64 for
words, ``randn`` in float32 for normals.  The same generator state gives
the same keys to whoever draws in that order, on the same device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

MOD = 1 << 32
MASK = MOD - 1
EXACT = 1 << 53

__all__ = ["Params", "Keys", "make_keys", "lwe_secret", "lwe_encrypt",
           "test_poly", "bootstrap", "decode", "phase", "to_i32", "from_i32"]


@dataclass(frozen=True)
class Params:
    n_lwe: int
    poly_degree: int
    glwe_dim: int
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    lwe_noise_std: float
    glwe_noise_std: float
    plaintext_modulus: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        return cls(**{f.name: cfg[f.name] for f in fields(cls)})


@dataclass
class Keys:
    lwe_sk: torch.Tensor    # int64 (n,) bits
    glwe_sk: torch.Tensor   # int64 (k, N) bits
    ggsw: torch.Tensor      # int64 (n, k+1 j, l, k+1 jp, N) in [0, 2^32)
    ksk_a: torch.Tensor     # int64 (kN, ks_level, n) in [0, 2^32)
    ksk_b: torch.Tensor     # int64 (kN, ks_level) in [0, 2^32)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Torus values (any integer tensor) -> int32 with the same low 32
    bits."""
    x = x.to(torch.int64) & MASK
    return torch.where(x >= (1 << 31), x - MOD, x).to(torch.int32)


def from_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 torus values in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def _signed(x: torch.Tensor) -> torch.Tensor:
    """Torus values in [0, 2^32) -> the same residues in [-2^31, 2^31)."""
    return torch.where(x >= (1 << 31), x - MOD, x)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def _bits(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 2, tuple(shape), generator=gen,
                         dtype=torch.int32, device=gen.device).to(torch.int64)


def _words(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=gen,
                         dtype=torch.int64, device=gen.device) & MASK


def _normals(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    e = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return torch.round(e).to(torch.int64)


# ---------------------------------------------------------------------------
# Exact products
# ---------------------------------------------------------------------------

def _matmul_mod(x: torch.Tensor, w: torch.Tensor, bound_log2: float
                ) -> torch.Tensor:
    """(x @ w) mod 2^32 for integer tensors whose every sum is below
    2^bound_log2 <= 2^53 in magnitude: exact in float64."""
    if bound_log2 >= 53:
        raise ValueError(f"sum bound 2^{bound_log2:.1f} is not exact in "
                         "float64")
    out = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    return out.to(torch.int64) & MASK


def _toeplitz_index(n: int, device):
    """(index, negate) with (X^c p)_r = +-p[index[c, r]], negated where
    r < c."""
    c = torch.arange(n, device=device)[:, None]
    r = torch.arange(n, device=device)[None, :]
    d = r - c
    return torch.remainder(d, n), d < 0


def _toeplitz(p: torch.Tensor) -> torch.Tensor:
    """T[..., c, r] = (X^c p)_r mod X^N + 1, for p (..., N): a @ T(p) is the
    negacyclic product a * p."""
    idx, neg = _toeplitz_index(p.shape[-1], p.device)
    vals = p[..., idx]
    return torch.where(neg, -vals, vals)


def _negacyclic_dot(mask: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """sum_i mask_i * sk_i mod (X^N + 1, 2^32) for mask (..., k, N) in
    [0, 2^32) and a binary sk (k, N)."""
    k, n = sk.shape
    t = _toeplitz(sk).reshape(k * n, n)
    flat = mask.reshape(-1, k * n)
    out = _matmul_mod(flat, t, math.log2(k * n) + 32)
    return out.reshape(mask.shape[:-2] + (n,))


def _dot_bits(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 over the last axis, s binary."""
    n = s.shape[0]
    lead = a.shape[:-1]
    out = _matmul_mod(a.reshape(-1, n), s.reshape(n, 1),
                      math.log2(max(n, 2)) + 32)
    return out.reshape(lead)


# ---------------------------------------------------------------------------
# Keys and encryption
# ---------------------------------------------------------------------------

def lwe_secret(gen: torch.Generator, p: Params) -> torch.Tensor:
    """The LWE key: the first draw of ``make_keys``."""
    return _bits(gen, (p.n_lwe,))


def make_keys(gen: torch.Generator, p: Params) -> Keys:
    """Secret keys, the GGSW rows of the bootstrap key and the key-switch
    key, from the draws the module docstring lists, in that order."""
    n, k, N, lvl = p.n_lwe, p.glwe_dim, p.poly_degree, p.pbs_level
    lwe_sk = _bits(gen, (n,))
    glwe_sk = _bits(gen, (k, N))
    mask = _words(gen, (n, k + 1, lvl, k, N))
    noise = _normals(gen, (n, k + 1, lvl, N), p.glwe_noise_std)
    body = (noise + _negacyclic_dot(mask, glwe_sk)) & MASK
    ggsw = torch.cat([mask, body.unsqueeze(-2)], dim=-2)
    for j in range(k + 1):
        for l in range(lvl):
            g = 1 << (32 - (l + 1) * p.pbs_base_log)
            ggsw[:, j, l, j, 0] = (ggsw[:, j, l, j, 0] + lwe_sk * g) & MASK
    ksk_a = _words(gen, (k * N, p.ks_level, n))
    e = _normals(gen, (k * N, p.ks_level), p.lwe_noise_std)
    gk = torch.tensor([1 << (32 - (l + 1) * p.ks_base_log)
                       for l in range(p.ks_level)], dtype=torch.int64,
                      device=ksk_a.device)
    s_in = glwe_sk.reshape(k * N)
    ksk_b = (_dot_bits(ksk_a, lwe_sk) + e + s_in[:, None] * gk) & MASK
    return Keys(lwe_sk=lwe_sk, glwe_sk=glwe_sk, ggsw=ggsw, ksk_a=ksk_a,
                ksk_b=ksk_b)


def lwe_encrypt(gen: torch.Generator, m: torch.Tensor, lwe_sk: torch.Tensor,
                p: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) encrypting the integer messages m (B,) under lwe_sk: a
    uniform words (B, n), then the noise (B,) from ``gen``."""
    delta = MOD // p.plaintext_modulus
    m = m.to(torch.int64)
    a = _words(gen, tuple(m.shape) + (p.n_lwe,))
    e = _normals(gen, m.shape, p.lwe_noise_std)
    b = (_dot_bits(a, lwe_sk) + e + m * delta) & MASK
    return a, b


def phase(a: torch.Tensor, b: torch.Tensor, lwe_sk: torch.Tensor
          ) -> torch.Tensor:
    return (b - _dot_bits(a, lwe_sk)) & MASK


def decode(a: torch.Tensor, b: torch.Tensor, lwe_sk: torch.Tensor,
           p: Params) -> torch.Tensor:
    """round(phase * t / 2^32) mod t."""
    shift = 32 - int(math.log2(p.plaintext_modulus))
    ph = phase(a, b, lwe_sk)
    return (((ph + (1 << (shift - 1))) & MASK) >> shift) \
        % p.plaintext_modulus


# ---------------------------------------------------------------------------
# Bootstrap
# ---------------------------------------------------------------------------

def test_poly(table, p: Params, device) -> torch.Tensor:
    """The accumulator's body for the function v -> table[v] (t entries):
    int64 (N,) in [0, 2^32)."""
    n, t = p.poly_degree, p.plaintext_modulus
    if len(table) != t:
        raise ValueError(f"a LUT needs {t} entries, got {len(table)}")
    delta = MOD // t
    tab = torch.tensor([int(v) % t for v in table], dtype=torch.int64,
                       device=device)
    c = torch.arange(n, device=device)
    coeffs = (tab[((c * t + n) // (2 * n)) % t] * delta) & MASK
    coeffs[n - n // t:] = (-int(tab[0]) * delta) & MASK
    return coeffs


def _round_2n(x: torch.Tensor, n: int) -> torch.Tensor:
    """round(x * 2N / 2^32) mod 2N."""
    shift = 32 - (2 * n).bit_length() + 1
    return ((x + (1 << (shift - 1))) & MASK) >> shift


def _rotate(acc: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X^r * acc for acc (B, ..., N) and r (B,) in [0, 2N)."""
    n = acc.shape[-1]
    i = torch.arange(n, device=acc.device)
    src = torch.remainder(i[None, :] - r[:, None], 2 * n)     # (B, N)
    wrap = src >= n
    src = torch.where(wrap, src - n, src)
    shape = (acc.shape[0],) + (1,) * (acc.dim() - 2) + (n,)
    src = src.reshape(shape).expand(acc.shape)
    vals = torch.gather(acc, -1, src)
    return torch.where(wrap.reshape(shape), -vals, vals) & MASK


def _decompose(x: torch.Tensor, base_log: int, level: int) -> torch.Tensor:
    """Signed digits (..., level) of x in [0, 2^32), digit l of weight
    2^(32 - (l+1) base_log), each in [-2^(base_log-1), 2^(base_log-1)),
    after rounding x to its top level * base_log bits; the carry out of
    the top digit wraps."""
    total = level * base_log
    if total > 32:
        raise ValueError("level * base_log exceeds 32 bits")
    y = x
    if total < 32:
        y = ((x + (1 << (32 - total - 1))) & MASK) >> (32 - total)
    half, base = 1 << (base_log - 1), 1 << base_log
    digits = []
    carry = torch.zeros_like(y)
    for _ in range(level):                     # least significant first
        d = (y & (base - 1)) + carry
        y = y >> base_log
        carry = (d >= half).to(torch.int64)
        digits.append(d - carry * base)
    digits.reverse()
    return torch.stack(digits, dim=-1)


def _step_matrix(row: torch.Tensor, idx, neg) -> torch.Tensor:
    """One GGSW row (k+1 j, l, k+1 jp, N) as the float64 matrix
    ((k+1) l N, (k+1) N) that maps the digits, ordered (j, l, c), to the
    external product's output, ordered (jp, r)."""
    kp1, lvl, _, n = row.shape
    vals = _signed(row).to(torch.float64)[..., idx]     # (j, l, jp, c, r)
    t = torch.where(neg, -vals, vals)
    return t.permute(0, 1, 3, 2, 4).reshape(kp1 * lvl * n, kp1 * n)


def blind_rotate(keys: Keys, p: Params, a: torch.Tensor, b: torch.Tensor,
                 tp: torch.Tensor) -> torch.Tensor:
    """The accumulator (B, k+1, N) after the CMux ladder over a (B, n)."""
    n, k, lvl = p.poly_degree, p.glwe_dim, p.pbs_level
    terms = (k + 1) * lvl * n
    bound = math.log2(terms) + (p.pbs_base_log - 1) + 31
    if bound >= 53:
        raise ValueError(f"external product sums reach 2^{bound:.1f}")
    rows = a.shape[0]
    acc = torch.zeros((rows, k + 1, n), dtype=torch.int64, device=a.device)
    acc[:, k, :] = tp
    acc = _rotate(acc, (2 * n - _round_2n(b, n)) % (2 * n))
    rots = _round_2n(a, n)
    idx, neg = _toeplitz_index(n, a.device)
    for i in range(p.n_lwe):
        diff = (_rotate(acc, rots[:, i]) - acc) & MASK
        d = _decompose(diff, p.pbs_base_log, lvl)          # (B, j, c, l)
        d = d.permute(0, 1, 3, 2).reshape(rows, terms).to(torch.float64)
        w = _step_matrix(keys.ggsw[i], idx, neg)
        prod = torch.matmul(d, w).to(torch.int64)
        acc = (acc + prod.reshape(rows, k + 1, n)) & MASK
    return acc


def sample_extract(acc: torch.Tensor, p: Params):
    """Coefficient 0 as an LWE of dimension kN: a[i N] = mask_i[0],
    a[i N + j] = -mask_i[N - j]; b = body[0]."""
    k, n = p.glwe_dim, p.poly_degree
    rows = acc.shape[0]
    idx = torch.remainder(-torch.arange(n, device=acc.device), n)
    vals = acc[:, :k, idx]
    a = torch.cat([vals[..., :1], -vals[..., 1:]], dim=-1) & MASK
    return a.reshape(rows, k * n), acc[:, k, 0]


def key_switch(keys: Keys, p: Params, a: torch.Tensor, b: torch.Tensor):
    """From the extracted key (kN) to the LWE key (n)."""
    kn = a.shape[-1]
    d = _decompose(a, p.ks_base_log, p.ks_level).reshape(a.shape[0], -1)
    bound = math.log2(kn * p.ks_level) + (p.ks_base_log - 1) + 31
    ka = _signed(keys.ksk_a).reshape(kn * p.ks_level, p.n_lwe)
    kb = _signed(keys.ksk_b).reshape(kn * p.ks_level, 1)
    a_out = (-_matmul_mod(d, ka, bound)) & MASK
    b_out = (b - _matmul_mod(d, kb, bound).squeeze(-1)) & MASK
    return a_out, b_out


def bootstrap(keys: Keys, p: Params, a: torch.Tensor, b: torch.Tensor,
              table) -> tuple[torch.Tensor, torch.Tensor]:
    """PBS of v -> table[v] on LWE (a (B, n), b (B,)), torus values in
    [0, 2^32): the accumulator, blind rotate, sample extract, key switch."""
    tp = test_poly(table, p, a.device)
    acc = blind_rotate(keys, p, a, b, tp)
    return key_switch(keys, p, *sample_extract(acc, p))
