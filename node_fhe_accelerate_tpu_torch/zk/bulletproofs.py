"""Bulletproofs: Pedersen commitments, inner-product argument, range proofs
(counterpart of node_fhe_accelerate_tpu/zk/bulletproofs.py, same protocol
and transcript schedule):

* generators: G = curve generator, H/U/g_i/h_i hash-to-curve from labeled
  seeds ("Bulletproofs_H", "Bulletproofs_g_<i>", ...);
* range proof: A,S commitments -> y,z -> T1,T2 -> x -> t_hat/tau_x/mu -> w
  -> inner-product argument on folded generators;
* IPA: recursive halving with L/R commitments and x challenges;
  verification folds both checks into ONE batched MSM.

Protocol scalars are host ints (the transcript serializes them anyway);
every bulk point operation -- vector commitments, generator folding, the
verifier MSM -- is a batched point op on the curve's device.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from ..ops import limbs as lb
from .curve import Curve, _cat_points, bn254_g1
from .hashes import Transcript
from .rand import ScalarRng

__all__ = ["BulletproofsGens", "PedersenCommitment", "RangeProof",
           "InnerProductProof", "BulletproofsProver", "BulletproofsVerifier",
           "hash_to_curve"]


def hash_to_curve(label: bytes, curve: Curve):
    """Deterministic try-and-increment hash-to-curve.  Returns affine ints
    (x, y)."""
    q = curve.fq.q
    ctr = 0
    while True:
        h = hashlib.sha256(label + ctr.to_bytes(4, "little")).digest()
        x = int.from_bytes(h, "little") % q
        rhs = (x * x * x + curve.b) % q
        y = pow(rhs, (q + 1) // 4, q)
        if y * y % q == rhs:
            if y % 2:
                y = q - y
            return (x, y)
        ctr += 1


@dataclass
class BulletproofsGens:
    """G, H, U and the g/h vectors."""
    curve: Curve
    G: tuple
    H: tuple
    U: tuple
    g_vec: tuple   # batched points (n, D)
    h_vec: tuple
    n: int

    @classmethod
    def generate(cls, curve: Curve, n: int) -> "BulletproofsGens":
        G = curve.generator()
        hx, hy = hash_to_curve(b"Bulletproofs_H", curve)
        ux, uy = hash_to_curve(b"Bulletproofs_U", curve)
        gs = [hash_to_curve(f"Bulletproofs_g_{i}".encode(), curve)
              for i in range(n)]
        hs = [hash_to_curve(f"Bulletproofs_h_{i}".encode(), curve)
              for i in range(n)]
        return cls(
            curve=curve,
            G=G,
            H=curve.from_affine_ints([hx], [hy]),
            U=curve.from_affine_ints([ux], [uy]),
            g_vec=curve.from_affine_ints([g[0] for g in gs],
                                         [g[1] for g in gs]),
            h_vec=curve.from_affine_ints([h[0] for h in hs],
                                         [h[1] for h in hs]),
            n=n,
        )


@dataclass
class PedersenCommitment:
    point: tuple            # V = value*G + blinding*H
    value: int | None = None
    blinding: int | None = None


@dataclass
class InnerProductProof:
    L: list                 # affine int triples (x, y, inf) per round
    R: list
    a: int
    b: int


@dataclass
class RangeProof:
    A: tuple
    S: tuple
    T1: tuple
    T2: tuple
    t_hat: int
    tau_x: int
    mu: int
    inner: InnerProductProof | None = None


def _scalars(vals, width=8, device=None):
    return lb.limbs_from_ints([int(v) for v in vals], width, device)


def _aff(curve: Curve, p) -> tuple:
    """Point -> (x, y, inf) host ints for the transcript."""
    x, y, inf = curve.to_affine_ints(p)
    return (int(x.reshape(-1)[0]), int(y.reshape(-1)[0]),
            bool(inf.reshape(-1)[0]))


def _slice(p, sl):
    return (p[0][sl], p[1][sl], p[2][sl])


def _single(p, i=0):
    return (p[0][i], p[1][i], p[2][i])


class BulletproofsProver:
    def __init__(self, curve: Curve | None = None,
                 rng_seed: int | None = None):
        self.curve = curve or bn254_g1()
        self.r = self.curve.order
        # Default: OS CSPRNG.  Seeded mode is for reproducible tests ONLY --
        # predictable Pedersen blindings make commitments brute-forceable.
        self._rng = ScalarRng(self.r, rng_seed)

    # -- helpers -------------------------------------------------------------
    def random_scalar(self) -> int:
        return self._rng.scalar()

    def _scalars(self, vals):
        return _scalars(vals, device=self.curve.device)

    def commit(self, value: int, blinding: int, gens: BulletproofsGens
               ) -> PedersenCommitment:
        """V = value*G + blinding*H (Pedersen)."""
        pts = _stack_points([gens.G, _single(gens.H)])
        V = self.curve.msm(self._scalars([value, blinding]), pts)
        return PedersenCommitment(point=V, value=value, blinding=blinding)

    def _vector_commit(self, a_scalars, b_scalars, g_vec, h_vec):
        """sum a_i g_i + sum b_i h_i as one MSM."""
        return self.curve.msm(
            self._scalars(list(a_scalars) + list(b_scalars)),
            _cat_points(g_vec, h_vec))

    # -- inner product argument -----------------------------------------------
    def prove_inner_product(self, a, b, g_vec, h_vec, U, transcript
                            ) -> InnerProductProof:
        c = self.curve
        r = self.r
        a = [x % r for x in a]
        b = [x % r for x in b]
        g, h = g_vec, h_vec
        n = len(a)
        Ls, Rs = [], []
        while n > 1:
            half = n // 2
            a_lo, a_hi = a[:half], a[half:]
            b_lo, b_hi = b[:half], b[half:]
            g_lo, g_hi = _slice(g, slice(0, half)), _slice(g, slice(half, n))
            h_lo, h_hi = _slice(h, slice(0, half)), _slice(h, slice(half, n))
            c_L = sum(x * y for x, y in zip(a_lo, b_hi)) % r
            c_R = sum(x * y for x, y in zip(a_hi, b_lo)) % r

            L = c.msm(self._scalars(a_lo + b_hi + [c_L]),
                      _stack_points([g_hi, h_lo, U]))
            R = c.msm(self._scalars(a_hi + b_lo + [c_R]),
                      _stack_points([g_lo, h_hi, U]))
            La, Ra = _aff(c, L), _aff(c, R)
            Ls.append(La)
            Rs.append(Ra)
            transcript.append_point("L", La)
            transcript.append_point("R", Ra)
            x = transcript.challenge_field_element("x", r)
            x_inv = pow(x, -1, r)

            a = [(lo * x + hi * x_inv) % r for lo, hi in zip(a_lo, a_hi)]
            b = [(lo * x_inv + hi * x) % r for lo, hi in zip(b_lo, b_hi)]
            # g' = x_inv*g_lo + x*g_hi ; h' = x*h_lo + x_inv*h_hi: the four
            # scalar_muls of the JAX package as one batched ladder and one
            # batched add (the same points, a quarter of the narrow ops)
            prods = c.scalar_mul(
                self._scalars([x_inv] * half + [x] * (2 * half)
                              + [x_inv] * half),
                _cat_points(g_lo, g_hi, h_lo, h_hi))
            folded = c.add(
                _cat_points(_slice(prods, slice(0, half)),
                            _slice(prods, slice(2 * half, 3 * half))),
                _cat_points(_slice(prods, slice(half, 2 * half)),
                            _slice(prods, slice(3 * half, None))))
            g = _slice(folded, slice(0, half))
            h = _slice(folded, slice(half, None))
            n = half
        return InnerProductProof(L=Ls, R=Rs, a=a[0], b=b[0])

    # -- range proof ------------------------------------------------------------
    def prove_range(self, value: int, blinding: int, n: int,
                    gens: BulletproofsGens) -> RangeProof:
        """Single-value proof == aggregated proof with m=1 (identical
        transcript and formulas)."""
        return self.prove_range_aggregated([value], [blinding], n, gens)

    def prove_range_aggregated(self, values: list, blindings: list, n: int,
                               gens: BulletproofsGens) -> RangeProof:
        """One proof that every values[j] lies in [0, 2^n) -- the standard
        Bulletproofs aggregation; proof size grows only logarithmically in
        m = len(values)."""
        m = len(values)
        if m == 0 or m & (m - 1):
            raise ValueError("number of values must be a power of two")
        if len(blindings) != m:
            raise ValueError("one blinding per value")
        for v in values:
            if v < 0 or v >= (1 << n):
                raise ValueError("value out of range")
        N = m * n
        if gens.n < N:
            raise ValueError("not enough generators")
        c = self.curve
        r = self.r
        transcript = Transcript("Bulletproofs_RangeProof")

        a_L = [(values[i // n] >> (i % n)) & 1 for i in range(N)]
        a_R = [(x - 1) % r for x in a_L]
        s_L = [self.random_scalar() for _ in range(N)]
        s_R = [self.random_scalar() for _ in range(N)]
        alpha = self.random_scalar()
        rho = self.random_scalar()

        g_n = _slice(gens.g_vec, slice(0, N))
        h_n = _slice(gens.h_vec, slice(0, N))

        A = c.msm(self._scalars(a_L + a_R + [alpha]),
                  _stack_points([g_n, h_n, gens.H]))
        S = c.msm(self._scalars(s_L + s_R + [rho]),
                  _stack_points([g_n, h_n, gens.H]))
        A_a, S_a = _aff(c, A), _aff(c, S)
        transcript.append_point("A", A_a)
        transcript.append_point("S", S_a)
        y = transcript.challenge_field_element("y", r)
        z = transcript.challenge_field_element("z", r)

        y_pow = _powers(y, N, r)
        two_pow = _powers(2, n, r)
        # z^(1+j) per value j (1-indexed): z^2 for the first value -- the
        # m=1 case degenerates to the single-proof z^2 everywhere.
        z_pow = _powers(z, m + 2, r)
        l0 = [(aL - z) % r for aL in a_L]
        r0 = [(y_pow[i] * ((a_R[i] + z) % r)
               + z_pow[2 + i // n] * two_pow[i % n]) % r
              for i in range(N)]
        t0 = sum(l0[i] * r0[i] for i in range(N)) % r
        t1 = sum(l0[i] * (y_pow[i] * s_R[i]) + s_L[i] * r0[i]
                 for i in range(N)) % r
        t2 = sum(s_L[i] * y_pow[i] * s_R[i] for i in range(N)) % r

        tau1 = self.random_scalar()
        tau2 = self.random_scalar()
        T1 = c.msm(self._scalars([t1, tau1]),
                   _stack_points([c.generator(), gens.H]))
        T2 = c.msm(self._scalars([t2, tau2]),
                   _stack_points([c.generator(), gens.H]))
        T1_a, T2_a = _aff(c, T1), _aff(c, T2)
        transcript.append_point("T1", T1_a)
        transcript.append_point("T2", T2_a)
        x = transcript.challenge_field_element("x", r)
        x2 = x * x % r

        l_vec = [(l0[i] + s_L[i] * x) % r for i in range(N)]
        r_vec = [(r0[i] + y_pow[i] * s_R[i] * x) % r for i in range(N)]
        t_hat = (t0 + t1 * x + t2 * x2) % r
        tau_x = (tau2 * x2 + tau1 * x
                 + sum(z_pow[2 + j] * blindings[j] for j in range(m))) % r
        mu = (alpha + rho * x) % r
        n = N

        transcript.append_field_element("t_hat", t_hat)
        transcript.append_field_element("tau_x", tau_x)
        transcript.append_field_element("mu", mu)
        w = transcript.challenge_field_element("w", r)
        # h' = h_i^(y^-i) and U' = w U as one batched ladder (the JAX
        # package runs two; h' does not enter the transcript)
        y_inv_pow = _powers(pow(y, -1, r), n, r)
        prods = c.scalar_mul(self._scalars(y_inv_pow + [w]),
                             _stack_points([h_n, gens.U]))
        h_prime = _slice(prods, slice(0, n))
        U_prime = _slice(prods, slice(n, None))

        inner = self.prove_inner_product(
            l_vec, r_vec, g_n, h_prime, _single(U_prime), transcript)
        return RangeProof(A=A_a, S=S_a, T1=T1_a, T2=T2_a, t_hat=t_hat,
                          tau_x=tau_x, mu=mu, inner=inner)


class BulletproofsVerifier:
    def __init__(self, curve: Curve | None = None):
        self.curve = curve or bn254_g1()
        self.r = self.curve.order

    def _delta(self, y, z, n, m=1):
        """(z - z^2)<1, y^(mn)> - sum_j z^(3+j)<1, 2^n>."""
        r = self.r
        z2 = z * z % r
        z_pow = _powers(z, m + 3, r)
        sy = sum(_powers(y, m * n, r)) % r
        s2 = (1 << n) - 1
        return ((z - z2) * sy
                - sum(z_pow[3 + j] * s2 for j in range(m))) % r

    def verify_range(self, commitment: PedersenCommitment, proof: RangeProof,
                     n: int, gens: BulletproofsGens) -> bool:
        return self.verify_range_aggregated([commitment], proof, n, gens)

    def verify_range_aggregated(self, commitments: list, proof: RangeProof,
                                n: int, gens: BulletproofsGens) -> bool:
        c = self.curve
        r = self.r
        m = len(commitments)
        if m == 0 or m & (m - 1):
            return False
        N = m * n
        transcript = Transcript("Bulletproofs_RangeProof")
        transcript.append_point("A", proof.A)
        transcript.append_point("S", proof.S)
        y = transcript.challenge_field_element("y", r)
        z = transcript.challenge_field_element("z", r)
        transcript.append_point("T1", proof.T1)
        transcript.append_point("T2", proof.T2)
        x = transcript.challenge_field_element("x", r)
        transcript.append_field_element("t_hat", proof.t_hat)
        transcript.append_field_element("tau_x", proof.tau_x)
        transcript.append_field_element("mu", proof.mu)
        w = transcript.challenge_field_element("w", r)

        z_pow = _powers(z, m + 3, r)
        x2 = x * x % r
        delta = self._delta(y, z, n, m)

        # Single-MSM batch verification: the two checks
        #   (1) t_hat G + tau_x H - sum z^(2+j) V_j - delta G - x T1
        #       - x^2 T2 == 0
        #   (2) P - RHS_ipa == 0, with P's definition substituted and the
        #       y^-i of h' folded into the h_i exponents
        # are combined with a fresh uniform rho as (1) + rho*(2) and
        # evaluated as ONE multi-scalar multiplication that must land on
        # the point at infinity.  For (1), (2) not both zero the combination
        # vanishes with probability 1/r (Schwartz-Zippel over rho).
        rho = secrets.randbelow(r - 1) + 1

        # IPA challenges (same transcript order as the prover)
        rounds = len(proof.inner.L)
        if (1 << rounds) != N:
            return False
        challenges = []
        for La, Ra in zip(proof.inner.L, proof.inner.R):
            transcript.append_point("L", La)
            transcript.append_point("R", Ra)
            challenges.append(transcript.challenge_field_element("x", r))
        inv_ch = [pow(ch, -1, r) for ch in challenges]
        s = []
        for i in range(N):
            acc = 1
            for j in range(rounds):
                bit = (i >> (rounds - 1 - j)) & 1
                acc = acc * (challenges[j] if bit else inv_ch[j]) % r
            s.append(acc)

        y_pow = _powers(y, N, r)
        two_pow = _powers(2, n, r)
        y_inv_pow = _powers(pow(y, -1, r), N, r)
        g_n = _slice(gens.g_vec, slice(0, N))
        h_n = _slice(gens.h_vec, slice(0, N))
        A = c.from_affine_ints([proof.A[0]], [proof.A[1]])
        S = c.from_affine_ints([proof.S[0]], [proof.S[1]])
        T1 = c.from_affine_ints([proof.T1[0]], [proof.T1[1]])
        T2 = c.from_affine_ints([proof.T2[0]], [proof.T2[1]])
        h_scalars = [(z * y_pow[i] + z_pow[2 + i // n] * two_pow[i % n]) % r
                     for i in range(N)]
        a_s, b_s = proof.inner.a, proof.inner.b

        scalars = [
            (proof.t_hat - delta) % r,                       # G
            (proof.tau_x - rho * proof.mu) % r,              # H
        ]
        pts = [c.generator(), gens.H]
        scalars += [(r - z_pow[2 + j]) % r for j in range(m)]  # V_j
        pts += [cm.point for cm in commitments]
        scalars += [(r - x) % r, (r - x2) % r, rho, rho * x % r]
        pts += [T1, T2, A, S]
        # g_i: rho * (-z - s_i a);   h_i: rho * y^-i * (h_sc_i - s_i^-1 b).
        # s_i^-1 = s_{N-1-i}: flipping every challenge bit inverts the
        # product and maps index i to its complement -- no inversions.
        scalars += [rho * (r - (z + s[i] * a_s) % r) % r for i in range(N)]
        pts += [g_n]
        scalars += [rho * y_inv_pow[i] % r
                    * ((h_scalars[i] - s[N - 1 - i] * b_s) % r) % r
                    for i in range(N)]
        pts += [h_n]
        scalars += [rho * w % r * (proof.t_hat - a_s * b_s) % r]  # U
        pts += [gens.U]
        for j in range(rounds):
            Lx, Ly, _ = proof.inner.L[j]
            Rx, Ry, _ = proof.inner.R[j]
            pts.append(c.from_affine_ints([Lx], [Ly]))
            scalars.append(rho * challenges[j] % r * challenges[j] % r)
            pts.append(c.from_affine_ints([Rx], [Ry]))
            scalars.append(rho * inv_ch[j] % r * inv_ch[j] % r)

        res = c.msm(_scalars([sc % r for sc in scalars], device=c.device),
                    _stack_points(pts))
        # infinity iff Jacobian Z == 0
        return not bool(res[2].any())

    def verify_inner_product(self, P, c_val, proof: InnerProductProof,
                             g_vec, h_vec, U, w, transcript) -> bool:
        """s-vector verification: check
        P == sum(s_i a g_i) + sum(s_i^-1 b h_i) + (a b w) U
           - sum(x_j^2 L_j + x_j^-2 R_j)."""
        c = self.curve
        r = self.r
        n = g_vec[0].shape[0]
        rounds = len(proof.L)
        if (1 << rounds) != n:
            return False
        challenges = []
        for La, Ra in zip(proof.L, proof.R):
            transcript.append_point("L", La)
            transcript.append_point("R", Ra)
            challenges.append(transcript.challenge_field_element("x", r))
        inv_ch = [pow(x, -1, r) for x in challenges]

        s = []
        for i in range(n):
            acc = 1
            for j in range(rounds):
                bit = (i >> (rounds - 1 - j)) & 1
                acc = acc * (challenges[j] if bit else inv_ch[j]) % r
            s.append(acc)

        scalars = ([(s[i] * proof.a) % r for i in range(n)]
                   + [(pow(s[i], -1, r) * proof.b) % r for i in range(n)]
                   + [proof.a * proof.b % r * w % r])
        pts = [g_vec, h_vec, U]
        # subtract L/R terms: -x_j^2 L_j - x_j^-2 R_j
        for j in range(rounds):
            Lx, Ly, _ = proof.L[j]
            Rx, Ry, _ = proof.R[j]
            pts.append(c.from_affine_ints([Lx], [Ly]))
            scalars.append((r - challenges[j] * challenges[j]) % r)
            pts.append(c.from_affine_ints([Rx], [Ry]))
            scalars.append((r - inv_ch[j] * inv_ch[j]) % r)
        rhs = c.msm(_scalars(scalars, device=c.device), _stack_points(pts))
        return bool(c.eq(P, rhs))


def _powers(x, n, r):
    out = [1]
    for _ in range(1, n):
        out.append(out[-1] * x % r)
    return out


def _stack_points(pieces):
    """Stack a mix of single points (D,) and batched points (n, D)."""
    return _cat_points(*[p if p[0].dim() > 1 else tuple(c[None] for c in p)
                         for p in pieces])
