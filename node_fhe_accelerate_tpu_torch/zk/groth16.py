"""Groth16 zk-SNARK over BN254 with a real pairing check (counterpart of
node_fhe_accelerate_tpu/zk/groth16.py).

R1CS constraints + circuit builder + setup/prove/verify.  The QAP math runs
on the prover's device: constraints are compiled once into padded sparse
gather tables, witness evaluation is a batched gather + field product +
tree add over Fr digit planes, and the quotient polynomial h comes out of
the Fr NTT (zk/fr_ntt.py) with no polynomial division -- the QAP lives on
the negacyclic domain x^d + 1, where h is the upper half of the full
product A*B.  The prover's G1 MSMs, the G1 fixed-base ladders of the setup
and the B-in-G2 MSM and G2 fixed-base ladder run on the curve's device
(zk/curve.py, zk/curve_g2.py); verification evaluates the optimal-ate
pairing product on the host (zk/pairing.py).

Where the JAX package picks its host twins by ``jax.default_backend()``,
the port picks by device: ``backend=None`` means the host twins for a
prover on the CPU and the device pipelines on the card; ``backend=
"device"`` runs the card's code on CPU tensors, and a CUDA prover runs
the host twins only when asked (``backend="host"``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import u32_to_tensor
from . import pairing as pr
from .bulletproofs import _scalars, _stack_points
from .commitments import _affine_or_none
from .curve import bn254_g1
from .field import BN254_FR as R, bn254_fr
from .fr_ntt import FrNtt
from .rand import ScalarRng

__all__ = ["R1CS", "CircuitBuilder", "Groth16Setup", "Groth16Proof",
           "Groth16Prover", "Groth16Verifier", "evaluate_witness"]


# ---------------------------------------------------------------------------
# R1CS + circuit builder
# ---------------------------------------------------------------------------


@dataclass
class R1CS:
    """Constraints <a,w> * <b,w> = <c,w>; w = [1, publics..., privates...]."""
    num_vars: int
    num_public: int          # not counting the constant-1 wire
    constraints: list        # [(a: {idx: coeff}, b, c), ...]

    @property
    def num_constraints(self):
        return len(self.constraints)


class CircuitBuilder:
    """Minimal gate-level builder."""

    def __init__(self):
        self._num_vars = 1      # wire 0 = constant 1
        self._public: list = []
        self._constraints: list = []

    def public_input(self) -> int:
        v = self._num_vars
        self._num_vars += 1
        self._public.append(v)
        return v

    def private_input(self) -> int:
        v = self._num_vars
        self._num_vars += 1
        return v

    def mul(self, x: int, y: int) -> int:
        """z = x * y."""
        z = self.private_input()
        self._constraints.append(({x: 1}, {y: 1}, {z: 1}))
        return z

    def add(self, x: int, y: int) -> int:
        """z = x + y (one linear constraint via mul by 1)."""
        z = self.private_input()
        self._constraints.append(({x: 1, y: 1}, {0: 1}, {z: 1}))
        return z

    def mul_const(self, x: int, k: int) -> int:
        z = self.private_input()
        self._constraints.append(({x: k % R}, {0: 1}, {z: 1}))
        return z

    def assert_equal(self, x: int, y: int):
        self._constraints.append(({x: 1}, {0: 1}, {y: 1}))

    def assert_bool(self, x: int):
        """x * (x - 1) = 0."""
        self._constraints.append(({x: 1}, {x: 1, 0: R - 1}, {}))

    def build(self) -> R1CS:
        # Reorder wires so publics come right after the constant wire
        order = [0] + self._public + [
            v for v in range(1, self._num_vars) if v not in self._public]
        remap = {old: new for new, old in enumerate(order)}
        cons = [tuple({remap[k]: v for k, v in part.items()}
                      for part in con) for con in self._constraints]
        return R1CS(num_vars=self._num_vars, num_public=len(self._public),
                    constraints=cons)


def evaluate_witness(r1cs: R1CS, assignment: dict) -> list:
    """Full witness vector from {wire: value}; wire 0 forced to 1."""
    w = [0] * r1cs.num_vars
    w[0] = 1
    for k, v in assignment.items():
        w[k] = v % R
    for a, b, c in r1cs.constraints:
        av = sum(co * w[i] for i, co in a.items()) % R
        bv = sum(co * w[i] for i, co in b.items()) % R
        cv = sum(co * w[i] for i, co in c.items()) % R
        if av * bv % R != cv:
            raise ValueError("witness does not satisfy constraints")
    return w


# ---------------------------------------------------------------------------
# Compiled circuit: sparse R1CS evaluator + NTT h-pipeline
# ---------------------------------------------------------------------------


def _pack_u32(digits):
    """(d, 32) canonical 8-bit digits -> (d, 8) int32 tensor holding the
    uint32 limbs' bits (packed in int64: torch has no uint32 shifts on the
    CPU)."""
    dd = digits.reshape(digits.shape[0], -1, 4).to(torch.int64)
    limbs = dd[..., 0] | (dd[..., 1] << 8) | (dd[..., 2] << 16) \
        | (dd[..., 3] << 24)
    return torch.where(limbs >= 1 << 31, limbs - (1 << 32),
                       limbs).to(torch.int32)


class _CompiledCircuit:
    """R1CS compiled to tables on ``device``.

    Each constraint part (a/b/c) becomes (d, kmax) wire-index + Montgomery
    coefficient tables; evaluating the whole system against a witness is a
    gather + one batched field product + log(kmax) tree adds.  The
    h-polynomial pipeline then runs on the device: interpolate A, B over
    the psi domain, the full 2d-wide product by CRT at size d, take the
    upper half (see fr_ntt.py for why that IS (AB - C)/t), and repack the
    canonical digits into u32 limbs for the G1 MSM."""

    def __init__(self, r1cs: R1CS, d: int, device=None):
        self.f = bn254_fr(device)
        self.device = self.f.device
        self.d = d
        self.r1cs = r1cs
        self.ntt = FrNtt(self.f, d)
        # psi twist tables for the cyclic product (see _pipeline): every
        # transform stays at size d
        q = self.f.q
        pows = [1] * d
        for i in range(1, d):
            pows[i] = pows[i - 1] * self.ntt.psi_inv % q
        self._tw_inv = self.f.encode(pows)                   # psi^-i, (d, L)
        for i in range(1, d):
            pows[i] = pows[i - 1] * self.ntt.psi % q
        self._tw_fwd = self.f.encode(pows)                   # psi^+k, (d, L)
        self._inv2 = self.f.encode([pow(2, -1, q)])[0]
        kmax = 1
        for con in r1cs.constraints:
            for part in con:
                kmax = max(kmax, len(part))
        self.kmax = kmax

        def build(part_idx):
            cols = np.zeros((d, kmax), np.int64)
            coeffs = [0] * (d * kmax)
            for j, con in enumerate(r1cs.constraints):
                for k, (i, co) in enumerate(con[part_idx].items()):
                    cols[j, k] = i
                    coeffs[j * kmax + k] = co % R
            planes = self.f.encode(coeffs).reshape(d, kmax, -1)
            return torch.from_numpy(cols).to(self.device), planes

        self.tables = [build(i) for i in range(3)]

    def _eval_part(self, w, cols, cf):
        p = self.f.mul(cf, w[cols])            # (d, kmax, L)
        while p.shape[-2] > 1:
            half = p.shape[-2] // 2
            lo = p[..., :half, :]
            hi = p[..., half: 2 * half, :]
            rest = p[..., 2 * half:, :]
            p = torch.cat([self.f.add(lo, hi), rest], dim=-2)
        return p[..., 0, :]                     # (d, L)

    def _pipeline(self, w):
        f = self.f
        ae = self._eval_part(w, *self.tables[0])
        be = self._eval_part(w, *self.tables[1])
        ce = self._eval_part(w, *self.tables[2])
        pe = f.mul(ae, be)
        ok = bool(f.eq(pe, ce).all())
        # h = (A*B) div (x^d + 1) by upper-half CRT, all transforms size d:
        #   Pn = A*B mod (x^d+1)  -- pointwise in the psi domain,
        #   Pc = A*B mod (x^d-1)  -- psi-untwist, negacyclic mul, psi-retwist
        #   (cyclic conv of a_i psi^-i is psi^-k times the negacyclic conv),
        #   h_k = p_{d+k} = (Pc_k - Pn_k) / 2.
        A = self.ntt.interpolate(ae)
        B = self.ntt.interpolate(be)
        Pn = self.ntt.interpolate(pe)
        Pc = f.mul(self.ntt.negacyclic_mul(f.mul(A, self._tw_inv),
                                           f.mul(B, self._tw_inv)),
                   self._tw_fwd)
        h_mont = f.mul(f.sub(Pc, Pn), self._inv2)
        return _pack_u32(f.from_mont(h_mont)), ok

    def h_limbs(self, w_ints, backend: str | None = None):
        """Witness ints -> (d, 8) int32 tensor (uint32 bits) of the h
        coefficients on the circuit's device; raises if the witness fails
        the constraint check.  ``backend`` "host" runs the same algebra on
        host big ints (``_h_limbs_host``, the fr_ntt.py ``*_ints`` twins),
        "device" the digit-plane pipeline; None picks host on the CPU and
        device on the card."""
        if backend is None:
            backend = "host" if self.device.type == "cpu" else "device"
        if backend == "host":
            return u32_to_tensor(self._h_limbs_host(w_ints), self.device)
        w = self.f.encode([int(x) % R for x in w_ints])
        limbs, ok = self._pipeline(w)
        if not ok:
            raise ValueError("witness does not satisfy constraints (device)")
        return limbs

    def _h_limbs_host(self, w_ints):
        d = self.d
        w = [int(x) % R for x in w_ints]
        ae = [0] * d
        be = [0] * d
        ce = [0] * d
        for j, (a, b, c) in enumerate(self.r1cs.constraints):
            ae[j] = sum(co * w[i] for i, co in a.items()) % R
            be[j] = sum(co * w[i] for i, co in b.items()) % R
            ce[j] = sum(co * w[i] for i, co in c.items()) % R
            if ae[j] * be[j] % R != ce[j]:
                raise ValueError(
                    "witness does not satisfy constraints (host)")
        # same size-d CRT pipeline as _pipeline, on host big ints
        q = self.f.q
        ntt = self.ntt
        A = ntt.interpolate_ints(np.array(ae, dtype=object))
        B = ntt.interpolate_ints(np.array(be, dtype=object))
        Pn = ntt.interpolate_ints(
            np.array([a * b % q for a, b in zip(ae, be)], dtype=object))
        tw = [1] * d
        for i in range(1, d):
            tw[i] = tw[i - 1] * ntt.psi_inv % q
        At = np.array([a * t % q for a, t in zip(A, tw)], dtype=object)
        Bt = np.array([b * t % q for b, t in zip(B, tw)], dtype=object)
        Pc_t = ntt.negacyclic_mul_ints(At, Bt)
        for i in range(1, d):
            tw[i] = tw[i - 1] * ntt.psi % q
        inv2 = pow(2, -1, q)
        h = [(int(pc) * t - int(pn)) % q * inv2 % q
             for pc, t, pn in zip(Pc_t, tw, Pn)]
        buf = b"".join(int(x).to_bytes(32, "little") for x in h)
        return np.frombuffer(buf, dtype=np.uint32).reshape(d, 8).copy()


# ---------------------------------------------------------------------------
# Setup / prove / verify
# ---------------------------------------------------------------------------


@dataclass
class Groth16Setup:
    r1cs: R1CS
    # proving key (batched G1 points on a device + host G2)
    alpha_g1: object
    beta_g1: object
    delta_g1: object
    a_query: object          # (n_vars,) G1
    b_query_g1: object
    l_query: object          # private-wire query /delta
    h_query: object          # [tau^i t(tau)/delta]
    beta_g2: object          # FQ2 affine
    delta_g2: object
    gamma_g2: object
    b_query_g2: list         # per-var G2 points
    # verifying key
    ic: object               # (num_public+1,) G1 for the public input MSM


@dataclass
class Groth16Proof:
    a: tuple                 # affine ints
    b: tuple                 # FQ2 affine pair
    c: tuple                 # affine ints


def _domain_size(r1cs: R1CS) -> int:
    m = max(r1cs.num_constraints, 2)
    return 1 << (m - 1).bit_length()


class Groth16Prover:
    """Setup and prove on ``device`` (``cuda`` unless the caller asks for
    another); ``backend`` as the module docstring says."""

    def __init__(self, rng_seed: int | None = None, device=None,
                 backend: str | None = None):
        self.curve = bn254_g1(device)
        self.device = self.curve.device
        self.backend = backend or self.curve._default_backend()
        # Default: OS CSPRNG.  Seeded mode is for reproducible tests ONLY --
        # predictable setup randomness (tau, alpha, beta, gamma, delta) is
        # recoverable toxic waste and allows proof forgery.
        self._rng = ScalarRng(R, rng_seed)
        self._g2_curve = None

    def _rand(self):
        return self._rng.scalar()

    def _g2(self):
        """This prover's one G2 curve object (the MSM band race is keyed
        on the curve object)."""
        if self._g2_curve is None:
            from .curve_g2 import bn254_g2
            self._g2_curve = bn254_g2(self.device)
        return self._g2_curve

    def _scalars(self, vals):
        return _scalars(vals, device=self.device)

    def compiled(self, setup: "Groth16Setup") -> _CompiledCircuit:
        """The setup's compiled circuit on this prover's device (built once
        per device and kept on the setup)."""
        cache = setup.__dict__.setdefault("_circuits", {})
        key = str(self.device)
        if key not in cache:
            cache[key] = _CompiledCircuit(setup.r1cs,
                                          _domain_size(setup.r1cs),
                                          self.device)
        return cache[key]

    def _b_g2_device(self, setup: "Groth16Setup", w: list, s_s: int):
        """Device G2 MSM for the proof's B: one Pippenger over
        [beta, delta, B_0..B_{n-1}] with scalars [1, s, w_0..w_{n-1}].
        The points are encoded once per device and kept on the setup."""
        g2c = self._g2()
        cache = setup.__dict__.setdefault("_b_query_g2_dev", {})
        key = str(self.device)
        if key not in cache:
            aff = [setup.beta_g2, setup.delta_g2] + list(setup.b_query_g2)
            cache[key] = g2c.from_affine_pairs(aff)    # None -> infinity
        out = g2c.msm(self._scalars([1, s_s] + list(w)), cache[key],
                      backend="device")
        return g2c.to_affine_pairs((out[0][None], out[1][None],
                                    out[2][None]))[0]

    # -- setup ----------------------------------------------------------------
    def setup(self, r1cs: R1CS) -> Groth16Setup:
        c = self.curve
        backend = self.backend
        m = max(r1cs.num_constraints, 2)
        d = _domain_size(r1cs)
        circuit = _CompiledCircuit(r1cs, d, self.device)
        points = circuit.ntt.points              # roots of x^d + 1
        while True:
            tau, alpha, beta, gamma, delta = (self._rand() for _ in range(5))
            if tau not in points:                # keep tau - x_j invertible
                break

        # Lagrange-at-tau over the psi domain has a closed form:
        # L_j(tau) = t(tau) * x_j * (-1/d) / (tau - x_j), t(x) = x^d + 1.
        t_tau = (pow(tau, d, R) + 1) % R
        neg_dinv = (-pow(d, -1, R)) % R
        L = [t_tau * x % R * neg_dinv % R * pow((tau - x) % R, -1, R) % R
             for x in points[:m]]
        A = [0] * r1cs.num_vars
        B = [0] * r1cs.num_vars
        C = [0] * r1cs.num_vars
        for j, (a, b, cc) in enumerate(r1cs.constraints):
            for i, co in a.items():
                A[i] = (A[i] + co * L[j]) % R
            for i, co in b.items():
                B[i] = (B[i] + co * L[j]) % R
            for i, co in cc.items():
                C[i] = (C[i] + co * L[j]) % R

        gi = pow(gamma, -1, R)
        di = pow(delta, -1, R)
        n_pub = r1cs.num_public
        ic_scalars = [((beta * A[i] + alpha * B[i] + C[i]) % R) * gi % R
                      for i in range(n_pub + 1)]
        l_scalars = [((beta * A[i] + alpha * B[i] + C[i]) % R) * di % R
                     for i in range(n_pub + 1, r1cs.num_vars)]
        h_scalars = [pow(tau, i, R) * t_tau % R * di % R for i in range(d)]

        def g1s(scalars):
            if not scalars:
                return c.infinity((1,))
            return c.fixed_base_mul(scalars, backend=backend)

        # G2 query [B_i(tau)] G2: on the host a windowed fixed-base table
        # (the points of the JAX package's per-wire g2_mul), or one
        # fixed-base ladder over the wire axis on the device
        g2c = self._g2()
        if backend == "host":
            b_query_g2 = g2c.fixed_base_affine_host(B)
        else:
            dev = g2c.fixed_base_mul(B, backend="device")
            aff = g2c.to_affine_pairs(dev)
            b_query_g2 = [a if bi else None for a, bi in zip(aff, B)]

        setup = Groth16Setup(
            r1cs=r1cs,
            alpha_g1=g1s([alpha]), beta_g1=g1s([beta]), delta_g1=g1s([delta]),
            a_query=g1s(A), b_query_g1=g1s(B),
            l_query=g1s(l_scalars) if l_scalars else None,
            h_query=g1s(h_scalars),
            beta_g2=pr.g2_mul(pr.G2_GENERATOR, beta),
            delta_g2=pr.g2_mul(pr.G2_GENERATOR, delta),
            gamma_g2=pr.g2_mul(pr.G2_GENERATOR, gamma),
            b_query_g2=b_query_g2,
            ic=g1s(ic_scalars),
        )
        setup._circuits = {str(self.device): circuit}
        return setup

    # -- prove ---------------------------------------------------------------
    def prove(self, setup: Groth16Setup, assignment: dict) -> Groth16Proof:
        c = self.curve
        backend = self.backend
        r1cs = setup.r1cs
        w = evaluate_witness(r1cs, assignment)

        # h coefficients: sparse R1CS eval -> Fr NTT pipeline
        h_limbs = self.compiled(setup).h_limbs(w, backend=backend)

        r_s = self._rand()
        s_s = self._rand()

        # A = alpha + sum w_i A_i(tau) + r*delta
        pts_a = _stack_points([setup.alpha_g1, setup.a_query,
                               setup.delta_g1])
        A_pt = c.msm(self._scalars([1] + w + [r_s]), pts_a, backend=backend)
        # B (G2) = beta + sum w_i B_i + s*delta: one Pippenger over Fq2 on
        # the device, or the host FQ2 Jacobian Pippenger
        if backend == "host":
            g2_pts = []
            g2_scs = []
            for i, wi in enumerate(w):
                if wi and setup.b_query_g2[i] is not None:
                    g2_pts.append(setup.b_query_g2[i])
                    g2_scs.append(wi)
            B_g2 = pr.g2_add(setup.beta_g2, pr.g2_mul(setup.delta_g2, s_s))
            if g2_pts:
                B_g2 = pr.g2_add(B_g2, pr.g2_msm(g2_pts, g2_scs))
        else:
            B_g2 = self._b_g2_device(setup, w, s_s)
        # B in G1 for C computation
        pts_b1 = _stack_points([setup.beta_g1, setup.b_query_g1,
                                setup.delta_g1])
        B_g1 = c.msm(self._scalars([1] + w + [s_s]), pts_b1, backend=backend)

        # C = sum_priv w_i L_i + sum h_i H_i + s*A + r*B1 - r*s*delta
        n_pub = r1cs.num_public
        priv_w = w[n_pub + 1:]
        pieces = [setup.h_query]
        scalar_arrays = [h_limbs]
        if setup.l_query is not None and priv_w:
            pieces.insert(0, setup.l_query)
            scalar_arrays.insert(0, self._scalars(priv_w))
        pieces += [A_pt, B_g1, setup.delta_g1]
        scalar_arrays.append(self._scalars([s_s, r_s, (-r_s * s_s) % R]))
        C_pt = c.msm(torch.cat(scalar_arrays), _stack_points(pieces),
                     backend=backend)

        return Groth16Proof(
            a=_affine_or_none(c, A_pt),
            b=B_g2,
            c=_affine_or_none(c, C_pt),
        )


class Groth16Verifier:
    """Pairing-product verification on the host; the public-input MSM on
    ``device`` (the setup's ``ic`` points live there)."""

    def __init__(self, device=None):
        self.curve = bn254_g1(device)

    def verify(self, setup: Groth16Setup, public_inputs: list,
               proof: Groth16Proof) -> bool:
        """e(A, B) == e(alpha, beta) * e(pub, gamma) * e(C, delta)."""
        c = self.curve
        if len(public_inputs) != setup.r1cs.num_public:
            return False
        pub_scalars = [1] + [p % R for p in public_inputs]
        pub_pt = c.msm(_scalars(pub_scalars, device=c.device), setup.ic)
        pub_aff = _affine_or_none(c, pub_pt)
        alpha_aff = _affine_or_none(c, _one(setup.alpha_g1))
        q = c.fq.q

        def neg(p):
            return None if p is None else (p[0], (-p[1]) % q)

        # e(-A, B) * e(alpha, beta) * e(pub, gamma) * e(C, delta) == 1
        return pr.pairing_check([
            (neg(proof.a), proof.b),
            (alpha_aff, setup.beta_g2),
            (pub_aff, setup.gamma_g2),
            (proof.c, setup.delta_g2),
        ])


def _one(p):
    return (p[0][0], p[1][0], p[2][0]) if p[0].dim() == 2 else p
