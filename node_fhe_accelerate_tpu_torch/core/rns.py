"""RNS (multi-modulus) polynomial rings and the BFV engine over the whole
moduli chain (counterpart of node_fhe_accelerate_tpu/core/rns.py).

A ciphertext polynomial is a residue tuple: one (lo, hi) pair of int32
limb planes per prime q_i.  Every elementwise op and transform runs per
prime through the port's ``PolyRing`` (on the card K6/K7 and the fused
product K8, csrc/ntt.cu, for each prime), and the primes couple only where
RNS theory puts them:

* encode/decode: m * Delta mod Q with Delta = floor(Q/t), and the CRT
  recombination on the host (Python integers);
* multiply: the exact tensor product with the t/Q rescale of
  core/bfv_mul.py ``RnsRescaleMultiplier``;
* relinearize: the RNS gadget.  d2 splits into its CRT components
  t_j = |d2 (Q/q_j)^-1|_{q_j}, each lifted to every prime (a residue below
  2^62 reduced mod q_i), against keys that encrypt (Q/q_j) s^2 mod Q.

The samplers draw one signed integer sample and map it to every prime
(``RnsPolyRing.from_signed``), so the residues are one polynomial over Z_Q;
a uniform polynomial is drawn per prime (independent uniforms mod each
prime are uniform mod Q).  Every generator call splits into its draws (an
explicit ``torch.Generator``, on the generator's device) and a
``*_from_draws`` half that takes them as residue tuples.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.u64 import M32, to_planes, u64_from_np, u64_to_np
from .encrypt import Ciphertext
from .keys import PublicKey, SecretKey
from .params import ParameterSet
from .poly import PolyRing

__all__ = ["RnsPolyRing", "RnsKeySet", "RnsRelinKey", "RnsEncryptionEngine",
           "rns_keyswitch"]


def _signed_to_planes(s: torch.Tensor, q: int):
    """Integer tensor of signed values (|v| < 2^31) -> limb planes mod q."""
    v = s.to(torch.int64)
    v = torch.where(v < 0, v + q, v)
    return to_planes((v & M32, v >> 32))


def stack(polys):
    """Residue tuples of one shape -> one residue tuple with a leading
    axis."""
    return tuple((torch.stack([p[i][0] for p in polys]),
                  torch.stack([p[i][1] for p in polys]))
                 for i in range(len(polys[0])))


def row(poly, k):
    """Row k of a residue tuple with a leading axis."""
    return tuple((lo[k], hi[k]) for lo, hi in poly)


class RnsPolyRing:
    """Z_Q[X]/(X^N+1) with Q = prod q_i: a list of per-prime PolyRings.

    A polynomial is a tuple of K limb-plane pairs; batch axes lead as in
    PolyRing."""

    def __init__(self, degree: int, moduli: list, device=None, rings=None,
                 ring_factory=None):
        """``rings`` are the per-prime rings, when another chain shares
        them; else ``ring_factory(degree, q)`` makes one a prime (default: a
        ``PolyRing`` on ``device``).  Pass e.g. ``lambda n, q:
        DistPolyRing(n, q, mesh=mesh)`` to run the RNS stack, and CKKS on
        top of it, over the 4-step sharded ring (parallel/dist_ring.py):
        the coefficient planes are the same in both.  Without ``device``
        the ring lives on its per-prime rings' device."""
        self.n = degree
        self.moduli = list(moduli)
        self.K = len(self.moduli)
        self.Q = math.prod(self.moduli)
        # ``q`` aliases the composite, so modulus-generic callers (Shamir
        # sharing, Lagrange weights) work over Z_Q unchanged
        self.q = self.Q
        if rings is None and ring_factory is not None:
            rings = [ring_factory(degree, q) for q in self.moduli]
        if rings is not None and device is None:
            device = rings[0].device
        self.device = resolve_device(device)
        self.rings = (list(rings) if rings is not None else
                      [PolyRing(degree, q, self.device) for q in self.moduli])

    # -- construction ----------------------------------------------------
    def zeros(self, batch=()):
        return tuple(r.zeros(batch) for r in self.rings)

    def from_int_coeffs(self, coeffs) -> tuple:
        """Host object-dtype (or uint64) coefficients mod Q -> residues."""
        c = np.asarray(coeffs, dtype=object)
        return tuple(u64_from_np(np.array(c % q, dtype=np.uint64),
                                 self.device) for q in self.moduli)

    def to_np(self, poly) -> np.ndarray:
        """Residues -> uint64 array (K, ..., N) (serialization edge)."""
        return np.stack([r.to_np(p) for r, p in zip(self.rings, poly)])

    def from_np(self, arr):
        """(K, ..., N) or flat uint64 residues -> residue tuple."""
        a = np.asarray(arr, dtype=np.uint64).reshape(self.K, -1, self.n)
        a = a.squeeze(1) if a.shape[1] == 1 else a
        return tuple(r.from_np(a[i]) for i, r in enumerate(self.rings))

    def to_int_coeffs(self, poly) -> np.ndarray:
        """Residues -> object-dtype coefficients in [0, Q) via CRT."""
        res = [u64_to_np(p).astype(object) for p in poly]
        x = np.zeros_like(res[0])
        for i, q in enumerate(self.moduli):
            qi_star = self.Q // q
            inv = pow(qi_star % q, -1, q)
            x = x + (res[i] * inv % q) * qi_star
        return x % self.Q

    def from_signed(self, s: torch.Tensor):
        """One signed integer sample (|v| < 2^31) -> its residue tuple."""
        s = s.to(self.device)
        return tuple(_signed_to_planes(s, q) for q in self.moduli)

    # -- sampling (one integer sample shared across the primes) ----------
    def _shape(self, batch):
        return tuple(batch) + (self.n,)

    def sample_uniform(self, gen: torch.Generator, batch=()):
        return tuple(r.sample_uniform(gen, batch) for r in self.rings)

    def sample_ternary(self, gen: torch.Generator, batch=()):
        s = torch.randint(0, 3, self._shape(batch), generator=gen,
                          dtype=torch.int64, device=gen.device) - 1
        return self.from_signed(s)

    def sample_gaussian(self, gen: torch.Generator, std_dev: float,
                        batch=()):
        z = torch.randn(self._shape(batch), generator=gen,
                        dtype=torch.float32, device=gen.device) * std_dev
        return self.from_signed(torch.round(z).to(torch.int64))

    def sample_binary(self, gen: torch.Generator, batch=()):
        return self.from_signed(torch.randint(
            0, 2, self._shape(batch), generator=gen, dtype=torch.int64,
            device=gen.device))

    # -- ring ops (per-prime maps) ----------------------------------------
    def add(self, a, b):
        return tuple(r.add(x, y) for r, x, y in zip(self.rings, a, b))

    def sub(self, a, b):
        return tuple(r.sub(x, y) for r, x, y in zip(self.rings, a, b))

    def neg(self, a):
        return tuple(r.neg(x) for r, x in zip(self.rings, a))

    def scalar_mul(self, a, scalar: int):
        return tuple(r.scalar_mul(x, scalar % r.q)
                     for r, x in zip(self.rings, a))

    def pointwise(self, a, b):
        return tuple(r.pointwise(x, y) for r, x, y in zip(self.rings, a, b))

    def to_ntt(self, a):
        return tuple(r.to_ntt(x) for r, x in zip(self.rings, a))

    def from_ntt(self, a):
        return tuple(r.from_ntt(x) for r, x in zip(self.rings, a))

    def multiply(self, a, b):
        """Negacyclic product per prime (coefficient form in and out)."""
        return tuple(r.multiply(x, y) for r, x, y in zip(self.rings, a, b))


@dataclass
class RnsRelinKey:
    """RNS keyswitch key: component j encrypts (Q/q_j) s^2 over Z_Q.

    a[j] / b[j] are residue tuples (length K each); b_j = a_j s + e_j +
    (Q/q_j) s^2 mod Q.  ``ntt_forms`` caches the key's NTT form per chain
    (core/ckks.py), keyed by the degree, the moduli and the device."""
    a: list
    b: list
    key_id: str = "rns-relin"
    ntt_forms: dict = field(default_factory=dict, init=False, repr=False,
                            compare=False)


def lift(ring: RnsPolyRing, w, j: int, i: int):
    """A residue polynomial mod q_j (below 2^62) reduced mod q_i."""
    if i == j:
        return w
    z = torch.zeros_like(w[0])
    return ring.rings[i].ctx.reduce_128((w[0], w[1], z, z))


def gadget_components(ring: RnsPolyRing, d2) -> list:
    """The CRT components t_j = |d2 (Q/q_j)^-1|_{q_j} of d2, each lifted
    to every prime: K residue tuples."""
    out = []
    for j, qj in enumerate(ring.moduli):
        inv = pow((ring.Q // qj) % qj, -1, qj)
        w = ring.rings[j].scalar_mul(d2[j], inv)
        out.append(tuple(lift(ring, w, j, i) for i in range(ring.K)))
    return out


def rns_keyswitch(ring: RnsPolyRing, c0, c1, d2, ka, kb):
    """(c0 + sum_j t_j kb[j], c1 + sum_j t_j ka[j]) with t_j the gadget
    components of d2: the 2K products of a prime in one stacked product
    launch."""
    t = gadget_components(ring, d2)
    K = ring.K
    prods = ring.multiply(stack(t + t), stack(list(kb) + list(ka)))
    for j in range(K):
        c0 = ring.add(c0, row(prods, j))
        c1 = ring.add(c1, row(prods, K + j))
    return tuple(c0), tuple(c1)


class RnsKeySet:
    """Keygen over the RNS ring (secret, public and relin keys), in the
    single-modulus key dataclasses with residue tuples in their poly
    slots."""

    def __init__(self, ring: RnsPolyRing, noise_std: float):
        self.ring = ring
        self.noise_std = noise_std

    def generate_secret_key(self, gen: torch.Generator) -> SecretKey:
        return SecretKey(poly=self.ring.sample_ternary(gen), key_id="rns-sk")

    def generate_public_key(self, gen: torch.Generator,
                            sk: SecretKey) -> PublicKey:
        a = self.ring.sample_uniform(gen)
        e = self.ring.sample_gaussian(gen, self.noise_std)
        return self.public_key_from_draws(sk, a, e)

    def public_key_from_draws(self, sk: SecretKey, a, e) -> PublicKey:
        ring = self.ring
        b = ring.add(ring.multiply(a, sk.poly), e)
        return PublicKey(a=a, b=b, key_id="rns-pk")

    def generate_relin_key(self, gen: torch.Generator,
                           sk: SecretKey) -> RnsRelinKey:
        """Draws (a_j, e_j) component by component."""
        a_list, e_list = [], []
        for _ in self.ring.moduli:
            a_list.append(self.ring.sample_uniform(gen))
            e_list.append(self.ring.sample_gaussian(gen, self.noise_std))
        return self.relin_key_from_draws(sk, a_list, e_list)

    def relin_key_from_draws(self, sk: SecretKey, a_list,
                             e_list) -> RnsRelinKey:
        ring = self.ring
        s2 = ring.multiply(sk.poly, sk.poly)
        # a_j s for every j in one product launch per prime
        a_s = ring.multiply(stack(a_list), sk.poly)
        b_list = []
        for j, (qj, e) in enumerate(zip(ring.moduli, e_list)):
            gs2 = ring.scalar_mul(s2, ring.Q // qj)
            b_list.append(ring.add(ring.add(row(a_s, j), e), gs2))
        return RnsRelinKey(a=list(a_list), b=b_list)


class RnsEncryptionEngine:
    """BFV over the whole RNS chain; the interface of EncryptionEngine.

    The phase convention (c0 - c1 s + c2 s^2) and decode (round(phase t / Q)
    mod t) of core/encrypt.py, with q -> Q = prod q_i."""

    def __init__(self, params: ParameterSet, device=None):
        self.params = params
        self.ring = RnsPolyRing(params.poly_degree, params.moduli, device)
        self.device = self.ring.device
        self.q = self.ring.Q
        self.t = params.plaintext_modulus if params.plaintext_modulus > 0 \
            else 4
        self.delta = self.q // self.t
        noise_std = params.noise_std_absolute()
        self._noise_std = noise_std
        self.initial_noise_budget = math.log2(self.q) - math.log2(
            2.0 * max(noise_std, 1.0) * math.sqrt(params.poly_degree))
        self.keyset = RnsKeySet(self.ring, noise_std)
        self._rescaler = None

    # -- encode / decode (host <-> device edge) ---------------------------
    def encode(self, values):
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        coeffs = np.zeros(self.ring.n, dtype=object)
        k = min(len(vals), self.ring.n)
        coeffs[:k] = (vals[:k].astype(object) * self.delta) % self.q
        return self.ring.from_int_coeffs(coeffs)

    def decode(self, phase_poly, num_values: int = 1) -> np.ndarray:
        x = self.ring.to_int_coeffs(phase_poly)[..., :num_values]
        vals = (x * self.t + self.q // 2) // self.q % self.t
        return vals.astype(np.uint64)

    # -- encryption -------------------------------------------------------
    def encrypt(self, gen: torch.Generator, values,
                pk: PublicKey) -> Ciphertext:
        ring = self.ring
        u = ring.sample_ternary(gen)
        e1 = ring.sample_gaussian(gen, self._noise_std)
        e2 = ring.sample_gaussian(gen, self._noise_std)
        return self.encrypt_from_draws(values, pk, u, e1, e2)

    def encrypt_from_draws(self, values, pk: PublicKey, u, e1,
                           e2) -> Ciphertext:
        ring = self.ring
        m = self.encode(values)
        # pk.b u and pk.a u in one product launch per prime
        prod = ring.multiply(stack([pk.b, pk.a]), stack([u, u]))
        c0 = ring.add(ring.add(row(prod, 0), e1), m)
        c1 = ring.add(row(prod, 1), e2)
        return Ciphertext(c0=c0, c1=c1,
                          noise_budget=self.initial_noise_budget,
                          key_id=pk.key_id)

    def encrypt_symmetric(self, gen: torch.Generator, values,
                          sk: SecretKey) -> Ciphertext:
        a = self.ring.sample_uniform(gen)
        e = self.ring.sample_gaussian(gen, self._noise_std)
        return self.encrypt_symmetric_from_draws(values, sk, a, e)

    def encrypt_symmetric_from_draws(self, values, sk: SecretKey, a,
                                     e) -> Ciphertext:
        ring = self.ring
        m = self.encode(values)
        c0 = ring.add(ring.add(ring.multiply(a, sk.poly), e), m)
        return Ciphertext(c0=c0, c1=a,
                          noise_budget=self.initial_noise_budget,
                          key_id=sk.key_id)

    # -- decryption -------------------------------------------------------
    def phase(self, ct: Ciphertext, sk: SecretKey):
        ring = self.ring
        p = ring.sub(ct.c0, ring.multiply(ct.c1, sk.poly))
        if ct.is_degree_2:
            s2 = ring.multiply(sk.poly, sk.poly)
            p = ring.add(p, ring.multiply(ct.c2, s2))
        return p

    def decrypt(self, ct: Ciphertext, sk: SecretKey, num_values: int = 1):
        ph = self.phase(ct, sk)
        return self.decode(ph, num_values), self.noise_budget(ph)

    def noise_budget(self, phase_poly) -> float:
        x = self.ring.to_int_coeffs(phase_poly).reshape(-1)
        max_noise = 0
        for c in x.tolist():
            rounded = (c * self.t + self.q // 2) // self.q
            recon = (rounded * self.delta) % self.q
            d = abs(c - recon)
            d = min(d, self.q - d)
            max_noise = max(max_noise, d)
        if max_noise == 0:
            return math.log2(self.q / self.t)
        return math.log2(self.q / self.t) - math.log2(2.0 * max_noise)

    # -- homomorphic ops --------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        ring = self.ring
        nb = min(a.noise_budget, b.noise_budget) - 0.5
        c2 = None
        if a.is_degree_2 or b.is_degree_2:
            za = a.c2 if a.is_degree_2 else ring.zeros()
            zb = b.c2 if b.is_degree_2 else ring.zeros()
            c2 = ring.add(za, zb)
        return Ciphertext(c0=ring.add(a.c0, b.c0), c1=ring.add(a.c1, b.c1),
                          c2=c2, noise_budget=nb, key_id=a.key_id)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """c0 - c0', c1 - c1' (degree 1, as the JAX package's RNS
        engine)."""
        ring = self.ring
        nb = min(a.noise_budget, b.noise_budget) - 0.5
        return Ciphertext(c0=ring.sub(a.c0, b.c0), c1=ring.sub(a.c1, b.c1),
                          noise_budget=nb, key_id=a.key_id)

    def negate(self, a: Ciphertext) -> Ciphertext:
        ring = self.ring
        return Ciphertext(
            c0=ring.neg(a.c0), c1=ring.neg(a.c1),
            c2=ring.neg(a.c2) if a.is_degree_2 else None,
            noise_budget=a.noise_budget, key_id=a.key_id)

    def add_plain(self, a: Ciphertext, values) -> Ciphertext:
        return Ciphertext(c0=self.ring.add(a.c0, self.encode(values)),
                          c1=a.c1, c2=a.c2,
                          noise_budget=a.noise_budget - 0.1,
                          key_id=a.key_id)

    def multiply_scalar(self, a: Ciphertext, scalar: int) -> Ciphertext:
        ring = self.ring
        return Ciphertext(c0=ring.scalar_mul(a.c0, scalar),
                          c1=ring.scalar_mul(a.c1, scalar),
                          noise_budget=a.noise_budget - 1.0,
                          key_id=a.key_id)

    def multiply_plain(self, a: Ciphertext, values) -> Ciphertext:
        ring = self.ring
        vals = np.atleast_1d(np.asarray(values, dtype=np.uint64))
        coeffs = np.zeros(ring.n, dtype=object)
        coeffs[: len(vals)] = vals.astype(object) % self.t
        pt = ring.from_int_coeffs(coeffs)
        prod = ring.multiply(stack([a.c0, a.c1]), stack([pt, pt]))
        return Ciphertext(c0=row(prod, 0), c1=row(prod, 1),
                          noise_budget=a.noise_budget - 2.0,
                          key_id=a.key_id)

    # -- multiply (exact tensor product + t/Q rescale) --------------------
    @property
    def rescaler(self):
        """core/bfv_mul.py's RnsRescaleMultiplier, built at first use."""
        if self._rescaler is None:
            from .bfv_mul import RnsRescaleMultiplier
            self._rescaler = RnsRescaleMultiplier(
                self.ring.n, self.ring.moduli, self.t, self.device)
        return self._rescaler

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.multiply_rescale(a, b)

    def multiply_rescale(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.is_degree_2 or b.is_degree_2:
            raise ValueError("relinearize before multiplying degree-2")
        d0, d1, d2 = self.rescaler.multiply(list(a.c0), list(a.c1),
                                            list(b.c0), list(b.c1))
        nb = min(a.noise_budget, b.noise_budget) - (
            math.log2(self.t) + math.log2(self.params.poly_degree) + 3.0)
        return Ciphertext(c0=d0, c1=d1, c2=d2, noise_budget=nb,
                          key_id=a.key_id)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.multiply_rescale(a, a)

    # -- RNS relinearization ----------------------------------------------
    def relinearize(self, ct: Ciphertext, rlk: RnsRelinKey) -> Ciphertext:
        if not ct.is_degree_2:
            return ct
        c0, c1 = rns_keyswitch(self.ring, ct.c0, ct.c1, ct.c2, rlk.a, rlk.b)
        return Ciphertext(c0=c0, c1=c1, noise_budget=ct.noise_budget - 1.0,
                          key_id=ct.key_id)

    def multiply_relin(self, a, b, rlk: RnsRelinKey) -> Ciphertext:
        return self.relinearize(self.multiply_rescale(a, b), rlk)

    multiply_relin_rescale = multiply_relin

    # -- voting primitives (as EncryptionEngine's) ------------------------
    def tally_votes(self, ballots: list) -> Ciphertext:
        return self.batch_add(ballots)

    def tally_multi_candidate(self, ballots: list) -> Ciphertext:
        return self.batch_add(ballots)

    def tally_weighted(self, ballots: list, weights: list) -> Ciphertext:
        if len(ballots) != len(weights):
            raise ValueError("weights must match ballots")
        return self.batch_add([self.multiply_scalar(b, w)
                               for b, w in zip(ballots, weights)])

    def update_tally(self, tally: Ciphertext, ballot: Ciphertext
                     ) -> Ciphertext:
        return self.add(tally, ballot)

    def batch_add(self, cts: list) -> Ciphertext:
        """A left fold of ``add`` (its noise-budget bookkeeping too)."""
        if not cts:
            raise ValueError("empty ciphertext list")
        out = cts[0]
        for ct in cts[1:]:
            out = self.add(out, ct)
        return out
