"""PLONK over BN254 with KZG commitments, the real pairing, and device
polynomial arithmetic (counterpart of node_fhe_accelerate_tpu/zk/plonk.py).

Gate constraint system q_L a + q_R b + q_O c + q_M a b + q_C + PI = 0, copy
constraints via the grand-product permutation argument, KZG-committed
witness/permutation/quotient polynomials, and ``tally_correctness_circuit``.

Prover pipeline on the prover's device:

* the evaluation domain is the NEGACYCLIC point set x_j = psi^(2j+1)
  (roots of X^n + 1), closed under multiplication by omega = psi^2 -- so it
  supports the z(omega*X) shift like the classic cyclic domain, while the
  vanishing polynomial is Z_H(X) = X^n + 1 and Lagrange values have the
  closed form L_j(X) = Z_H(X) * x_j * (-1/n) / (X - x_j) (zk/fr_ntt.py);
* interpolation/evaluation = the Fr NTT (zk/fr_ntt.py) over 8-bit digit
  planes (zk/field.py): on the card one launch of K10's product a stage;
* the quotient numerator gate + alpha*perm + alpha^2*bound is assembled
  elementwise in evaluation form on the EIGHT-n negacyclic extension
  domain (the blinded numerator has degree 4n+5), then one inverse NTT
  gives its coefficients, and division by Z_H = X^n + 1 is an 8-block
  back-substitution with a remainder check;
* the grand product z runs on host big ints with ONE modular inversion
  (Montgomery batch trick);
* commitments are MSMs on the curve's device (zk/commitments.py KZG).

Standard proof shape (GWC19 round 5): 9 G1 points ([a],[b],[c],[z],[t_lo],
[t_mid],[t_hi],[W_zeta],[W_zeta_omega]) + 6 field evaluations, with the
linearization polynomial r(X) and two batched openings; verification is
exactly 2 pairings (on the host),

    e(W_z + u*W_zw, [tau]_2) == e(zeta*W_z + u*zeta*omega*W_zw + F - E, [1]_2)

with [F] and [E] computed in ONE MSM.  Zero-knowledge blinding: the wires
carry (b1 X + b2) Z_H, the grand product a quadratic (b7 X^2 + b8 X + b9)
Z_H, the quotient chunks the telescoping b10/b11 split blinders.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .bulletproofs import _scalars
from .commitments import (KZGScheme, KZGSetup, _affine_or_none, _poly_eval,
                          _syn_div)
from .curve import bn254_g1
from .field import BN254_FR as R, bn254_fr
from .fr_ntt import FrNtt
from .hashes import Transcript
from .rand import ScalarRng

__all__ = ["PlonkCircuit", "PlonkSetup", "PlonkProof", "PlonkProver",
           "PlonkVerifier", "tally_correctness_circuit"]

K1 = 2   # coset shifts for the permutation argument
K2 = 3


@dataclass
class Gate:
    ql: int
    qr: int
    qo: int
    qm: int
    qc: int
    a: int       # variable ids
    b: int
    c: int


class PlonkCircuit:
    """Gate-based constraint system (plonk.h:147 PLONKConstraintSystem)."""

    def __init__(self):
        self.gates: list[Gate] = []
        self._num_vars = 1          # var 0 is the constant zero wire
        self.public_gates: list[int] = []   # gate rows carrying public input

    def new_var(self) -> int:
        v = self._num_vars
        self._num_vars += 1
        return v

    def add_gate(self, ql, qr, qo, qm, qc, a, b, c):
        self.gates.append(Gate(ql % R, qr % R, qo % R, qm % R, qc % R,
                               a, b, c))

    # convenience gates (plonk.h CircuitBuilder surface)
    def public_input(self) -> int:
        """a + PI = 0 row: exposes variable as a public input."""
        v = self.new_var()
        self.public_gates.append(len(self.gates))
        self.add_gate(1, 0, 0, 0, 0, v, 0, 0)
        return v

    def add(self, x, y) -> int:
        z = self.new_var()
        self.add_gate(1, 1, R - 1, 0, 0, x, y, z)
        return z

    def mul(self, x, y) -> int:
        z = self.new_var()
        self.add_gate(0, 0, R - 1, 1, 0, x, y, z)
        return z

    def constant(self, k) -> int:
        z = self.new_var()
        self.add_gate(R - 1, 0, 0, 0, k % R, z, 0, 0)
        return z

    def assert_equal(self, x, y):
        self.add_gate(1, R - 1, 0, 0, 0, x, y, 0)


def tally_correctness_circuit(num_ballots: int) -> tuple:
    """Assert sum(ballot_i) == total (TallyCorrectnessCircuit, plonk.h:463).

    Returns (circuit, ballot_vars, total_var)."""
    c = PlonkCircuit()
    total = c.public_input()
    ballots = [c.new_var() for _ in range(num_ballots)]
    acc = ballots[0]
    for b in ballots[1:]:
        acc = c.add(acc, b)
    c.assert_equal(acc, total)
    return c, ballots, total


# ---------------------------------------------------------------------------
# Domain: negacyclic Fr NTT + the prover pipelines on a device
# ---------------------------------------------------------------------------


_DOMAINS: dict = {}


def _get_domain(n: int, device=None) -> "_Domain":
    """The size-n domain on ``device``, built once per (n, device)."""
    dev = resolve_device(device)
    d = _DOMAINS.get((n, str(dev)))
    if d is None:
        d = _Domain(n, dev)
        _DOMAINS[n, str(dev)] = d
    return d


class _Domain:
    """Size-n negacyclic evaluation domain with the interpolate / quotient
    pipelines on ``device`` (shared across setups of the same size)."""

    def __init__(self, n: int, device=None):
        f = bn254_fr(device)
        self.f = f
        self.n = n
        self.ntt = FrNtt(f, n)
        # The blinded numerator has degree 4n+5, so the extension domain is
        # 8n (roots of X^{8n} + 1) — exact coefficients, nothing wraps.
        self.ntt8 = FrNtt(f, 8 * n)
        self.points = self.ntt.points           # x_j = psi^(2j+1)
        self.omega = self.ntt.psi * self.ntt.psi % R
        # H, K1*H, K2*H must be pairwise disjoint: k^n == 1 would fold a
        # coset back onto H (x^n is constant on each coset).
        for k in (K1, K2, K2 * pow(K1, -1, R) % R):
            if pow(k, n, R) == 1:
                raise ValueError("coset shift collides with the domain")

        # constant planes for the quotient pipeline
        pts8 = self.ntt8.points[:]
        self._x8 = f.encode(pts8)                         # X on 8n domain
        self._k1x8 = f.encode([K1 * x % R for x in pts8])
        self._k2x8 = f.encode([K2 * x % R for x in pts8])
        # z(omega X) coefficient scaling for the blinded z (degree n+2)
        self._omega_pows = f.encode(
            [pow(self.omega, i, R) for i in range(n + 3)])
        self._one = f.encode([1])[0]

    # -- host <-> device ------------------------------------------------------
    def encode_vals(self, values):
        return self.f.encode([v % R for v in values])

    def interp(self, values):
        """Domain values (host ints) -> coefficient planes (NTT)."""
        return self.ntt.interpolate(self.encode_vals(values))

    def interp_ints(self, values) -> list:
        """Domain values (host ints) -> coefficient ints via the NTT."""
        co = self.interp(values)
        return [int(x) for x in self.f.decode(co)]

    # -- quotient pipeline ------------------------------------------------------
    def _eval8(self, coeffs):
        """(m, L) coefficient planes, m <= 8n -> values on the 8n domain."""
        f, n8 = self.f, 8 * self.n
        m = coeffs.shape[-2]
        pad = coeffs.new_zeros((n8 - m,) + tuple(coeffs.shape[-1:]))
        return self.ntt8.evaluate(torch.cat([coeffs, pad], dim=-2))

    def _quotient(self, a_c, b_c, c_c, z_c, pi_c, l1_c, sel_c, sig_c,
                  beta, gamma, alpha):
        """Blinded coefficient planes -> (t planes (3n+6, L), rem_ok).

        a_c/b_c/c_c: (n+2, L) blinded wires; z_c: (n+3, L) blinded grand
        product; sel_c: (5, n, L) ql,qr,qo,qm,qc; sig_c: (3, n, L).  The
        numerator (degree <= 4n+5) is assembled elementwise on the 8n
        extension domain; division by Z_H = X^n + 1 is an 8-block back
        substitution with a remainder + degree-bound check."""
        f, n = self.f, self.n
        # z(omega X) coefficients (blinded z has n+3 of them)
        zw_c = f.mul(z_c, self._omega_pows[: z_c.shape[-2]])

        a8 = self._eval8(a_c)
        b8 = self._eval8(b_c)
        c8 = self._eval8(c_c)
        z8 = self._eval8(z_c)
        zw8 = self._eval8(zw_c)
        pi8 = self._eval8(pi_c)
        l18 = self._eval8(l1_c)
        ql8, qr8, qo8, qm8, qc8 = (self._eval8(sel_c[i]) for i in range(5))
        s18, s28, s38 = (self._eval8(sig_c[i]) for i in range(3))

        gate = f.add(
            f.add(f.add(f.mul(ql8, a8), f.mul(qr8, b8)),
                  f.add(f.mul(qo8, c8), f.mul(qm8, f.mul(a8, b8)))),
            f.add(qc8, pi8))

        def shifted(w8, x8):
            return f.add(w8, f.add(f.mul(beta, x8), gamma))

        lhs = f.mul(f.mul(shifted(a8, self._x8), shifted(b8, self._k1x8)),
                    f.mul(shifted(c8, self._k2x8), z8))
        rhs = f.mul(f.mul(shifted(a8, s18), shifted(b8, s28)),
                    f.mul(shifted(c8, s38), zw8))
        perm = f.sub(lhs, rhs)
        bound = f.mul(f.sub(z8, self._one), l18)

        num8 = f.add(gate, f.add(f.mul(alpha, perm),
                                 f.mul(f.mul(alpha, alpha), bound)))
        num_c = self.ntt8.interpolate(num8)

        # divide by Z_H = X^n + 1: back-substitute over the 8 n-blocks
        # (num = sum_i b_i X^{in}  =>  q_6 = b_7, q_i = b_{i+1} - q_{i+1},
        #  rem = b_0 - q_0)
        blocks = [num_c[i * n:(i + 1) * n] for i in range(8)]
        qs = [None] * 7
        qs[6] = blocks[7]
        for i in range(5, -1, -1):
            qs[i] = f.sub(blocks[i + 1], qs[i + 1])
        rem = f.sub(blocks[0], qs[0])
        q_full = torch.cat(qs, dim=-2)                  # (7n, L)
        # t has degree <= 3n+5; everything above must be exactly zero
        tail_ok = bool(f.is_zero(q_full[3 * n + 6:]).all())
        ok = bool(f.is_zero(rem).all()) and tail_ok
        return q_full[: 3 * n + 6], ok

    def quotient_ints(self, a_p, b_p, c_p, z_p, pi_p, l1_p, sel_p, sig_p,
                      beta: int, gamma: int, alpha: int):
        """Blinded coefficient planes -> t coefficients (3n+6 ints)."""
        f = self.f
        enc1 = lambda s: f.encode([s % R])      # (1, L) broadcast scalar
        t_planes, ok = self._quotient(a_p, b_p, c_p, z_p, pi_p, l1_p,
                                      sel_p, sig_p,
                                      enc1(beta), enc1(gamma), enc1(alpha))
        if not ok:
            raise ValueError("constraint identity does not vanish on H")
        return [int(x) for x in f.decode(t_planes)]


def _batch_inverse(vals: list) -> list:
    """Montgomery trick: n inversions for one modexp + 3n multiplies."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R
    inv_all = pow(prefix[n], -1, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * vals[i] % R
    return out


# ---------------------------------------------------------------------------
# Setup / prove / verify
# ---------------------------------------------------------------------------


@dataclass
class PlonkSetup:
    circuit: PlonkCircuit
    n: int                       # padded domain size
    kzg: KZGSetup
    selector_polys: dict         # name -> coeffs (ints, for openings)
    selector_commits: dict
    sigma_polys: list            # 3 permutation polynomials (ints)
    sigma_commits: list
    domain: list                 # the n evaluation points
    sigma_tags: list = None      # raw permutation values (grand product)
    sel_planes: object = None    # (5, n, L) device coefficient planes
    sig_planes: object = None    # (3, n, L)
    l1_poly: list = None         # L_0 coefficients
    l1_plane: object = None


@dataclass
class PlonkProof:
    """Standard PLONK proof: 9 G1 points + 6 field evaluations.

    commits: a, b, c, z, t_lo, t_mid, t_hi, w_z, w_zw (affine triples)
    evals:   a, b, c, s1, s2 at zeta; z_w = z(omega*zeta)
    """
    commits: dict                # name -> (x, y, is_infinity)
    evals: dict                  # name -> int


class PlonkProver:
    """Setup and prove on ``device`` (``cuda`` unless the caller asks for
    another): the NTT pipelines and the KZG MSMs run there."""

    def __init__(self, rng_seed: int | None = None, device=None):
        self.kzg_scheme = KZGScheme(bn254_g1(device))
        self.device = self.kzg_scheme.curve.device
        # Default: OS CSPRNG; seeded mode for reproducible tests only.
        self._rng = ScalarRng(R, rng_seed)

    def _rand(self) -> int:
        return self._rng.scalar()

    def setup(self, circuit: PlonkCircuit, kzg_seed: int = 0) -> PlonkSetup:
        n = max(4, 1 << (len(circuit.gates) - 1).bit_length()) \
            if circuit.gates else 4
        dm = _get_domain(n, self.device)
        dom = dm.points
        gates = circuit.gates + [Gate(0, 0, 0, 0, 0, 0, 0, 0)] * (
            n - len(circuit.gates))

        sel = {
            "ql": dm.interp_ints([g.ql for g in gates]),
            "qr": dm.interp_ints([g.qr for g in gates]),
            "qo": dm.interp_ints([g.qo for g in gates]),
            "qm": dm.interp_ints([g.qm for g in gates]),
            "qc": dm.interp_ints([g.qc for g in gates]),
        }

        # Copy constraints: wire slots are (col, row); slots sharing a
        # variable form permutation cycles.  sigma maps slot tag -> tag.
        tags = {0: dom, 1: [K1 * x % R for x in dom],
                2: [K2 * x % R for x in dom]}
        by_var: dict = {}
        for row, g in enumerate(gates):
            for col, v in enumerate((g.a, g.b, g.c)):
                by_var.setdefault(v, []).append((col, row))
        sigma_tags = [[tags[c][r] for r in range(n)] for c in range(3)]
        for v, slots in by_var.items():
            if len(slots) > 1:
                # rotate the cycle
                for (c1, r1), (c2, r2) in zip(slots, slots[1:] + slots[:1]):
                    sigma_tags[c1][r1] = tags[c2][r2]
        sigma_polys = [dm.interp_ints(sigma_tags[c]) for c in range(3)]

        l1_poly = dm.interp_ints([1] + [0] * (n - 1))

        max_deg = 3 * n + 8
        kzg = self.kzg_scheme.setup(max_deg, seed=kzg_seed)
        sel_commits = {k: self.kzg_scheme.commit(v, kzg)
                       for k, v in sel.items()}
        sig_commits = [self.kzg_scheme.commit(s, kzg) for s in sigma_polys]
        f = dm.f
        enc = lambda polys: torch.stack([f.encode(p) for p in polys])
        return PlonkSetup(
            circuit=circuit, n=n, kzg=kzg,
            selector_polys=sel, selector_commits=sel_commits,
            sigma_polys=sigma_polys, sigma_commits=sig_commits,
            domain=dom, sigma_tags=sigma_tags,
            sel_planes=enc([sel[k] for k in ("ql", "qr", "qo", "qm", "qc")]),
            sig_planes=enc(sigma_polys),
            l1_poly=l1_poly, l1_plane=f.encode(l1_poly))

    def prove(self, setup: PlonkSetup, assignment: dict,
              public_inputs: list) -> PlonkProof:
        """assignment: {var: value}; var 0 must be 0."""
        n = setup.n
        dm = _get_domain(n, self.device)
        dom = setup.domain
        circuit = setup.circuit
        w = dict(assignment)
        w[0] = 0

        gates = circuit.gates + [Gate(0, 0, 0, 0, 0, 0, 0, 0)] * (
            n - len(circuit.gates))
        a_vals = [w.get(g.a, 0) % R for g in gates]
        b_vals = [w.get(g.b, 0) % R for g in gates]
        c_vals = [w.get(g.c, 0) % R for g in gates]

        # public input polynomial: -pub at its gate row
        pi_vals = [0] * n
        for pub, row in zip(public_inputs, circuit.public_gates):
            pi_vals[row] = (-pub) % R

        # sanity: every gate satisfied
        for i, g in enumerate(gates):
            lhs = (g.ql * a_vals[i] + g.qr * b_vals[i] + g.qo * c_vals[i]
                   + g.qm * a_vals[i] * b_vals[i] + g.qc + pi_vals[i]) % R
            if lhs != 0:
                raise ValueError(f"gate {i} unsatisfied")

        # witness interpolation (the NTT on the prover's device)
        a_p = dm.interp(a_vals)
        b_p = dm.interp(b_vals)
        c_p = dm.interp(c_vals)
        pi_p = dm.interp(pi_vals)
        dec = lambda p: [int(x) for x in dm.f.decode(p)]
        a_poly, b_poly, c_poly, pi_poly = dec(a_p), dec(b_p), dec(c_p), \
            dec(pi_p)

        # Zero-knowledge blinders: w'(X) = w(X) + (b_1 X + b_2) Z_H(X)
        # with Z_H = X^n + 1 — vanishes on H, so evaluations on the domain
        # (hence the gate checks and the grand product) are unchanged,
        # while w'(zeta) and [w'] are statistically independent of the
        # witness (GWC19 round 1; the reference has no hiding at all).
        def blind_wire(poly):
            bb1, bb2 = self._rand(), self._rand()
            out = list(poly) + [0, 0]
            out[0] = (out[0] + bb2) % R
            out[1] = (out[1] + bb1) % R
            out[n] = (out[n] + bb2) % R
            out[n + 1] = (out[n + 1] + bb1) % R
            return out

        a_poly = blind_wire(a_poly)
        b_poly = blind_wire(b_poly)
        c_poly = blind_wire(c_poly)

        kzg = setup.kzg
        scheme = self.kzg_scheme
        tr = Transcript("PLONK")
        commits = {}
        for name, poly in (("a", a_poly), ("b", b_poly), ("c", c_poly)):
            com = scheme.commit(poly, kzg)
            commits[name] = com
            tr.append_point(name, _aff3(scheme.curve, com))
        beta = tr.challenge_field_element("beta", R)
        gamma = tr.challenge_field_element("gamma", R)

        # grand product z over the raw permutation tags (host big ints,
        # one modular inversion via the batch trick)
        st = setup.sigma_tags
        nums = [0] * (n - 1)
        dens = [0] * (n - 1)
        for i in range(n - 1):
            nums[i] = ((a_vals[i] + beta * dom[i] + gamma)
                       * (b_vals[i] + beta * K1 * dom[i] + gamma)
                       * (c_vals[i] + beta * K2 * dom[i] + gamma)) % R
            dens[i] = ((a_vals[i] + beta * st[0][i] + gamma)
                       * (b_vals[i] + beta * st[1][i] + gamma)
                       * (c_vals[i] + beta * st[2][i] + gamma)) % R
        den_invs = _batch_inverse(dens)
        z_vals = [1]
        for i in range(n - 1):
            z_vals.append(z_vals[-1] * nums[i] % R * den_invs[i] % R)
        z_poly = dm.interp_ints(z_vals)
        # quadratic blinder for z (it is opened at TWO points, zeta and
        # omega*zeta, plus its commitment — three leaked values need three
        # random coefficients): z'(X) = z(X) + (b7 X^2 + b8 X + b9) Z_H(X)
        b7, b8, b9 = self._rand(), self._rand(), self._rand()
        z_poly = list(z_poly) + [0, 0, 0]
        for off, bb in ((0, b9), (1, b8), (2, b7)):
            z_poly[off] = (z_poly[off] + bb) % R
            z_poly[n + off] = (z_poly[n + off] + bb) % R
        z_com = scheme.commit(z_poly, kzg)
        commits["z"] = z_com
        tr.append_point("z", _aff3(scheme.curve, z_com))
        alpha = tr.challenge_field_element("alpha", R)

        # quotient t = [gate + alpha*perm + alpha^2*(z-1)L1] / (X^n + 1),
        # assembled in evaluation form on the 8n domain (the NTT; the
        # blinded numerator has degree 4n+5), split into chunks
        # t_lo + X^n t_mid + X^2n t_hi (plonk.cpp:693-720 commits one t;
        # the split keeps every commitment within the SRS), with the
        # telescoping b10/b11 chunk blinders of the PLONK paper:
        # t_lo' = t_lo + b10 X^n, t_mid' = t_mid - b10 + b11 X^n,
        # t_hi' = t_hi - b11  (their recombination at any point is t).
        enc = dm.f.encode
        t_poly = dm.quotient_ints(
            enc([x % R for x in a_poly]), enc([x % R for x in b_poly]),
            enc([x % R for x in c_poly]), enc([x % R for x in z_poly]),
            pi_p, setup.l1_plane, setup.sel_planes,
            setup.sig_planes, beta, gamma, alpha)
        b10, b11 = self._rand(), self._rand()
        t_lo = t_poly[:n] + [b10]
        t_mid = [(t_poly[n] - b10) % R] + t_poly[n + 1:2 * n] + [b11]
        t_hi = [(t_poly[2 * n] - b11) % R] + t_poly[2 * n + 1:]
        for name, part in (("t_lo", t_lo), ("t_mid", t_mid),
                           ("t_hi", t_hi)):
            com = scheme.commit(part, kzg)
            commits[name] = com
            tr.append_point(name, _aff3(scheme.curve, com))
        zeta = tr.challenge_field_element("zeta", R)

        # evaluations sent in the proof
        ev = lambda poly, x: _poly_eval(poly, x, R)
        evals = {"a": ev(a_poly, zeta), "b": ev(b_poly, zeta),
                 "c": ev(c_poly, zeta),
                 "s1": ev(setup.sigma_polys[0], zeta),
                 "s2": ev(setup.sigma_polys[1], zeta),
                 "z_w": ev(z_poly, zeta * dm.omega % R)}
        for name in ("a", "b", "c", "s1", "s2", "z_w"):
            tr.append_field_element("ev_" + name, evals[name])
        v = tr.challenge_field_element("v", R)

        # linearization polynomial r(X): committed polys scaled by scalar
        # coefficients derived from the evaluations (GWC19 round 5)
        ea, eb, ec = evals["a"], evals["b"], evals["c"]
        es1, es2, ezw = evals["s1"], evals["s2"], evals["z_w"]
        zh_z = (pow(zeta, n, R) + 1) % R
        l1_z = _lagrange_at(n, dom[0], zeta)
        lhsprod = ((ea + beta * zeta + gamma) *
                   (eb + beta * K1 * zeta + gamma) % R *
                   ((ec + beta * K2 * zeta + gamma) % R)) % R
        sig12 = ((ea + beta * es1 + gamma) *
                 (eb + beta * es2 + gamma)) % R
        zn = pow(zeta, n, R)

        def axpy(acc_poly, poly, s):
            s %= R
            if len(poly) > len(acc_poly):      # blinded polys exceed n
                acc_poly.extend([0] * (len(poly) - len(acc_poly)))
            for i, cf in enumerate(poly):
                acc_poly[i] = (acc_poly[i] + s * cf) % R

        r_poly = [0] * n
        axpy(r_poly, setup.selector_polys["qm"], ea * eb)
        axpy(r_poly, setup.selector_polys["ql"], ea)
        axpy(r_poly, setup.selector_polys["qr"], eb)
        axpy(r_poly, setup.selector_polys["qo"], ec)
        axpy(r_poly, setup.selector_polys["qc"], 1)
        axpy(r_poly, z_poly, alpha * lhsprod + alpha * alpha * l1_z)
        axpy(r_poly, setup.sigma_polys[2], R - alpha * beta % R
             * sig12 % R * ezw % R)
        axpy(r_poly, t_lo, R - zh_z)
        axpy(r_poly, t_mid, R - zh_z * zn % R)
        axpy(r_poly, t_hi, R - zh_z * zn % R * zn % R)

        # r(zeta) must equal -r0 (the verifier-computed constant part)
        pi_z = ev(pi_poly, zeta)
        r0 = (pi_z - alpha * sig12 % R * ((ec + gamma) % R) % R * ezw
              - alpha * alpha % R * l1_z) % R
        if (ev(r_poly, zeta) + r0) % R != 0:
            raise AssertionError("linearization identity failed")

        # batched opening at zeta over [r, a, b, c, s1, s2] with powers
        # of v, and the single z opening at omega*zeta
        combined = list(r_poly)
        vp = 1
        for poly in (a_poly, b_poly, c_poly,
                     setup.sigma_polys[0], setup.sigma_polys[1]):
            vp = vp * v % R
            axpy(combined, poly, vp)
        comb_val = ((R - r0) + v * ea + v * v % R * eb
                    + pow(v, 3, R) * ec + pow(v, 4, R) * es1
                    + pow(v, 5, R) * es2) % R
        w_z = scheme.commit(_syn_div(combined, zeta, comb_val, R), kzg)
        w_zw = scheme.commit(
            _syn_div(z_poly, zeta * dm.omega % R, ezw, R), kzg)
        commits["w_z"] = w_z
        commits["w_zw"] = w_zw
        tr.append_point("w_z", _aff3(scheme.curve, w_z))
        tr.append_point("w_zw", _aff3(scheme.curve, w_zw))

        return PlonkProof(commits={k: _aff3(scheme.curve, p_)
                                   for k, p_ in commits.items()},
                          evals=evals)


def _aff3(curve, p):
    """Point -> (x, y, is_infinity) host triple."""
    a = _affine_or_none(curve, p)
    return (a[0], a[1], False) if a is not None else (0, 0, True)


def _lagrange_at(n: int, x_j: int, zeta: int) -> int:
    """L_j(zeta) on the negacyclic domain: Z_H(zeta) x_j (-1/n)/(zeta-x_j)."""
    z_h = (pow(zeta, n, R) + 1) % R
    return z_h * x_j % R * (R - pow(n, -1, R)) % R \
        * pow((zeta - x_j) % R, -1, R) % R


class PlonkVerifier:
    """Standard PLONK verification: transcript replay, the constant part
    r0 of the linearization, one MSM on ``device`` building [F] - [E] +
    zeta*[W_z] + u*zeta*omega*[W_zw], and EXACTLY 2 pairings on the
    host."""

    def __init__(self, device=None):
        self.scheme = KZGScheme(bn254_g1(device))

    def verify(self, setup: PlonkSetup, public_inputs: list,
               proof: PlonkProof) -> bool:
        n = setup.n
        curve = self.scheme.curve
        e = proof.evals
        if set(e) != {"a", "b", "c", "s1", "s2", "z_w"} or \
                not {"a", "b", "c", "z", "t_lo", "t_mid", "t_hi",
                     "w_z", "w_zw"} <= set(proof.commits):
            return False
        tr = Transcript("PLONK")
        for name in ("a", "b", "c"):
            tr.append_point(name, proof.commits[name])
        beta = tr.challenge_field_element("beta", R)
        gamma = tr.challenge_field_element("gamma", R)
        tr.append_point("z", proof.commits["z"])
        alpha = tr.challenge_field_element("alpha", R)
        for name in ("t_lo", "t_mid", "t_hi"):
            tr.append_point(name, proof.commits[name])
        zeta = tr.challenge_field_element("zeta", R)
        for name in ("a", "b", "c", "s1", "s2", "z_w"):
            tr.append_field_element("ev_" + name, e[name] % R)
        v = tr.challenge_field_element("v", R)
        tr.append_point("w_z", proof.commits["w_z"])
        tr.append_point("w_zw", proof.commits["w_zw"])
        u = tr.challenge_field_element("u", R)

        dom = setup.domain
        omega = _get_domain(n, curve.device).omega

        # recompute PI(zeta) from the public inputs via closed-form
        # Lagrange values (no interpolation needed)
        pi_z = 0
        for pub, row in zip(public_inputs, setup.circuit.public_gates):
            pi_z = (pi_z - pub * _lagrange_at(n, dom[row], zeta)) % R

        zh_z = (pow(zeta, n, R) + 1) % R
        if zh_z == 0:
            return False        # zeta hit the domain (negligible)
        l1_z = _lagrange_at(n, dom[0], zeta)
        zn = pow(zeta, n, R)

        ea, eb, ec = e["a"] % R, e["b"] % R, e["c"] % R
        es1, es2, ezw = e["s1"] % R, e["s2"] % R, e["z_w"] % R
        lhsprod = ((ea + beta * zeta + gamma) *
                   (eb + beta * K1 * zeta + gamma) % R *
                   ((ec + beta * K2 * zeta + gamma) % R)) % R
        sig12 = ((ea + beta * es1 + gamma) *
                 (eb + beta * es2 + gamma)) % R
        r0 = (pi_z - alpha * sig12 % R * ((ec + gamma) % R) % R * ezw
              - alpha * alpha % R * l1_z) % R

        # [F] - [E] + zeta [W_z] + u zeta omega [W_zw]  in ONE MSM
        sel_c = {k: _aff3(curve, p_)
                 for k, p_ in setup.selector_commits.items()}
        sig_c = [_aff3(curve, p_) for p_ in setup.sigma_commits]
        g_aff = _aff3(curve, curve.generator())
        e_scalar = ((R - r0) + v * ea + v * v % R * eb
                    + pow(v, 3, R) * ec + pow(v, 4, R) * es1
                    + pow(v, 5, R) * es2 + u * ezw) % R
        terms = [
            (ea * eb % R, sel_c["qm"]),
            (ea, sel_c["ql"]), (eb, sel_c["qr"]), (ec, sel_c["qo"]),
            (1, sel_c["qc"]),
            ((alpha * lhsprod + alpha * alpha % R * l1_z + u) % R,
             proof.commits["z"]),
            (R - alpha * beta % R * sig12 % R * ezw % R, sig_c[2]),
            (R - zh_z, proof.commits["t_lo"]),
            (R - zh_z * zn % R, proof.commits["t_mid"]),
            (R - zh_z * zn % R * zn % R, proof.commits["t_hi"]),
            (v, proof.commits["a"]), (v * v % R, proof.commits["b"]),
            (pow(v, 3, R), proof.commits["c"]),
            (pow(v, 4, R), sig_c[0]), (pow(v, 5, R), sig_c[1]),
            (R - e_scalar, g_aff),
            (zeta, proof.commits["w_z"]),
            (u * zeta % R * omega % R, proof.commits["w_zw"]),
        ]
        rhs_aff = _msm_affine(curve, terms)
        lhs_aff = _msm_affine(curve, [(1, proof.commits["w_z"]),
                                      (u, proof.commits["w_zw"])])
        if lhs_aff is None or rhs_aff is None:
            return False

        # e(W_z + u W_zw, [tau]_2) == e(rhs, [1]_2)  — exactly 2 pairings
        kzg = setup.kzg
        neg_rhs = (rhs_aff[0], (-rhs_aff[1]) % curve.fq.q)
        return self.scheme.pm.pairing_check(
            [(lhs_aff, kzg.tau_h2), (neg_rhs, kzg.h2)])


def _msm_affine(curve, terms):
    """One MSM over (scalar, affine-triple) terms on the curve's device;
    returns the affine int pair, or None at infinity.  Zero scalars and
    points at infinity are dropped (they contribute the identity)."""
    xs, ys, ss = [], [], []
    for s, aff in terms:
        s %= R
        if s == 0 or aff[2]:
            continue
        xs.append(aff[0])
        ys.append(aff[1])
        ss.append(s)
    if not xs:
        return None
    pts = curve.from_affine_ints(xs, ys)
    return _affine_or_none(curve, curve.msm(
        _scalars(ss, device=curve.device), pts))
