"""Polynomial commitments: KZG (BN254 or BLS12-381) and FRI (counterpart
of node_fhe_accelerate_tpu/zk/commitments.py).

* KZG: powers-of-tau SRS (one fixed-base product on the curve's device),
  commit = one G1 MSM over the SRS, open via the quotient polynomial
  (p(X) - p(z)) / (X - z).  ``verify`` runs the optimal-ate pairing check
  e(C - [v]G, H2) * e(-pi, [tau - z]H2) == 1 (zk/pairing.py or
  zk/pairing_bls.py), and ``verify_dev`` is a fast test-only variant that
  uses the trusted-setup secret directly.
* FRI: Reed-Solomon fold-and-query over BN254 Fr with Poseidon-Merkle
  layer commitments (commit, round folding with transcript challenges,
  spot-check verification), on the host but for the Merkle hashing.

Host ints carry the protocol scalars; MSMs, Merkle layers and batch hashing
run on the curve's or field's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bulletproofs import _scalars
from .curve import Curve, bn254_g1
from .field import bn254_fr
from .hashes import MerkleTree, PoseidonHash, Transcript

__all__ = ["KZGSetup", "KZGScheme", "FRIConfig", "FRIProof", "FRIScheme"]


# ---------------------------------------------------------------------------
# KZG
# ---------------------------------------------------------------------------


@dataclass
class KZGSetup:
    """SRS: [1]G, [tau]G, [tau^2]G, ... plus [1]H2, [tau]H2
    (zk_polynomial_commitment.h KZGSetup).

    `tau` is retained ONLY for dev-mode verification and must be discarded
    in production ceremonies.  h2/tau_h2 are G2 points (FQ2 affine) for the
    real pairing check.
    """
    curve: Curve
    powers: tuple            # batched points (n, D)
    max_degree: int
    tau: int | None = None
    h2: object = None
    tau_h2: object = None


class KZGScheme:
    """KZG over a pairing curve (zk_polynomial_commitment.h KZGScheme256).

    Curve-parametric: BN254 (default) or BLS12-381 — the pairing module is
    selected by the curve's subgroup order (zk/pairing.py / pairing_bls.py
    expose the same surface)."""

    def __init__(self, curve: Curve | None = None, pairing_mod=None):
        self.curve = curve or bn254_g1()
        self.r = self.curve.order
        if pairing_mod is None:
            from . import pairing as _bn
            if self.r == _bn.R:
                pairing_mod = _bn
            else:
                from . import pairing_bls as _bls
                if self.r != _bls.R:
                    raise ValueError("no pairing module for this curve")
                pairing_mod = _bls
        self.pm = pairing_mod

    def _scalars(self, vals):
        return _scalars(vals, device=self.curve.device)

    def setup(self, max_degree: int, seed: int = 0) -> KZGSetup:
        G2_GENERATOR, g2_mul = self.pm.G2_GENERATOR, self.pm.g2_mul

        rng = np.random.default_rng(seed)
        tau = int.from_bytes(rng.bytes(40), "little") % self.r
        powers_int = [pow(tau, i, self.r) for i in range(max_degree + 1)]
        pts = self.curve.fixed_base_mul(powers_int)
        return KZGSetup(curve=self.curve, powers=pts,
                        max_degree=max_degree, tau=tau,
                        h2=G2_GENERATOR, tau_h2=g2_mul(G2_GENERATOR, tau))

    def commit(self, coeffs: list, setup: KZGSetup):
        """C = sum c_i [tau^i]G — one device MSM."""
        if len(coeffs) > setup.max_degree + 1:
            raise ValueError("polynomial degree exceeds SRS")
        pts = (setup.powers[0][: len(coeffs)],
               setup.powers[1][: len(coeffs)],
               setup.powers[2][: len(coeffs)])
        return self.curve.msm(self._scalars([c % self.r for c in coeffs]),
                              pts)

    def open(self, coeffs: list, z: int, setup: KZGSetup):
        """Evaluation proof: pi = commit((p(X) - p(z)) / (X - z)).

        Returns (value p(z), proof point).
        """
        r = self.r
        value = _poly_eval(coeffs, z, r)
        quotient = _syn_div(coeffs, z, value, r)
        proof = self.commit(quotient, setup) if quotient else \
            self.curve.infinity()
        return value, proof

    def verify_dev(self, commitment, z: int, value: int, proof,
                   setup: KZGSetup) -> bool:
        """Check e(C - [v]G, G) == e(pi, [tau - z]G) algebraically with the
        setup secret: C - [v]G == [tau - z] pi.  Dev/test only."""
        if setup.tau is None:
            raise ValueError("dev verification requires the setup secret")
        c = self.curve
        r = self.r
        g = c.generator()
        lhs = c.add(commitment, c.negate(
            c.scalar_mul(self._scalars([value % r]), g)[0:3]))
        lhs = (lhs[0], lhs[1], lhs[2])
        rhs = c.scalar_mul(self._scalars([(setup.tau - z) % r]), proof)
        return bool(c.eq(lhs, _first(rhs)))

    def verify(self, commitment, z: int, value: int, proof,
               setup: KZGSetup) -> bool:
        """Real pairing check: e(C - [v]G, H2) * e(-pi, [tau - z]H2) == 1.

        The genuine optimal-ate check (zk/pairing.py or pairing_bls.py per
        the curve), on the host."""
        pm = self.pm
        pairing_check, g2_add, g2_mul, g2_neg, G2_GENERATOR = (
            pm.pairing_check, pm.g2_add, pm.g2_mul, pm.g2_neg,
            pm.G2_GENERATOR)

        c = self.curve
        r = self.r
        g = c.generator()
        lhs_pt = c.add(commitment,
                       c.negate(_first(c.scalar_mul(
                           self._scalars([value % r]), g))))
        lhs_aff = _affine_or_none(c, lhs_pt)
        pi_aff = _affine_or_none(c, proof)
        # [tau - z]H2 = tau_h2 + [-z]H2
        tz_h2 = g2_add(setup.tau_h2, g2_neg(g2_mul(G2_GENERATOR, z % r)))
        neg_pi = None if pi_aff is None else (pi_aff[0],
                                              (-pi_aff[1]) % c.fq.q)
        return pairing_check([(lhs_aff, setup.h2), (neg_pi, tz_h2)])


def _first(p):
    return (p[0][0], p[1][0], p[2][0]) if p[0].ndim == 2 else p


def _affine_or_none(curve, p):
    """Device point -> affine int pair, or None at infinity."""
    x, y, inf = curve.to_affine_ints(p)
    x, y, inf = np.atleast_1d(x), np.atleast_1d(y), np.atleast_1d(inf)
    if bool(inf[0]):
        return None
    return (int(x[0]), int(y[0]))


def _poly_eval(coeffs, z, r):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % r
    return acc


def _syn_div(coeffs, z, value, r):
    """Quotient of (p(X) - value) by (X - z), Horner synthetic division."""
    out = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % r
        out[i - 1] = acc
    return out


# ---------------------------------------------------------------------------
# FRI
# ---------------------------------------------------------------------------


@dataclass
class FRIConfig:
    """(zk_polynomial_commitment.h FRIConfig)"""
    domain_log: int = 8          # evaluation domain size 2^k
    num_queries: int = 8
    fold_stop: int = 2           # stop folding at this many coefficients


@dataclass
class FRILayer:
    evals: list                  # host ints
    tree: MerkleTree


@dataclass
class FRIProof:
    layer_roots: list            # digit arrays (host-held)
    final_poly: list             # coefficients of the last layer
    queries: list                # per query: list of (idx, v0, v1, path0, path1)
    domain_log: int


class FRIScheme:
    """Radix-2 FRI over BN254 Fr with Poseidon-Merkle commitments."""

    def __init__(self, config: FRIConfig | None = None, device=None):
        self.cfg = config or FRIConfig()
        self.f = bn254_fr(device)
        self.r = self.f.q
        self.poseidon = PoseidonHash(self.f)
        # 2-adic generator of the evaluation domain
        self.two_adicity = 28
        g = 5  # multiplicative generator of BN254 Fr
        self.root_2_28 = pow(g, (self.r - 1) >> self.two_adicity, self.r)

    def domain(self, log_n: int) -> list:
        w = pow(self.root_2_28, 1 << (self.two_adicity - log_n), self.r)
        out = [1]
        for _ in range((1 << log_n) - 1):
            out.append(out[-1] * w % self.r)
        return out

    def evaluate(self, coeffs: list, log_n: int) -> list:
        """Evaluate over the 2^log_n domain (host Horner per point; the
        device NTT path arrives with the Fr-FFT)."""
        dom = self.domain(log_n)
        return [_poly_eval(coeffs, x, self.r) for x in dom]

    def commit(self, coeffs: list, transcript: Transcript) -> tuple:
        """Build all FRI layers; returns (layers, proof skeleton)."""
        r = self.r
        log_n = self.cfg.domain_log
        if len(coeffs) > (1 << log_n):
            raise ValueError("polynomial too large for domain")
        evals = self.evaluate(coeffs, log_n)
        layers = []
        roots = []
        cur_evals = evals
        cur_log = log_n
        cur_coeffs = list(coeffs)
        while len(cur_coeffs) > self.cfg.fold_stop:
            tree = MerkleTree(self.poseidon, self.f.encode(cur_evals))
            layers.append(FRILayer(evals=cur_evals, tree=tree))
            roots.append(tree.root)
            transcript.append_field_element(
                "fri_root", int(self.f.decode(tree.root)))
            beta = transcript.challenge_field_element("fri_beta", r)
            # fold: p(X) = p_even(X^2) + X p_odd(X^2);
            # p'(Y) = p_even(Y) + beta * p_odd(Y)
            even = cur_coeffs[0::2]
            odd = cur_coeffs[1::2]
            cur_coeffs = [(e + beta * o) % r
                          for e, o in zip(even, odd + [0] * (len(even) - len(odd)))]
            cur_log -= 1
            cur_evals = self.evaluate(cur_coeffs, cur_log)
        return layers, roots, cur_coeffs

    def prove(self, coeffs: list) -> FRIProof:
        transcript = Transcript("FRI")
        layers, roots, final_poly = self.commit(coeffs, transcript)
        for c in final_poly:
            transcript.append_field_element("fri_final", c)
        # query phase
        queries = []
        n0 = 1 << self.cfg.domain_log
        for qi in range(self.cfg.num_queries):
            idx = transcript.challenge_field_element(f"fri_q{qi}", n0)
            idx = idx % n0
            per_layer = []
            cur = idx
            for layer in layers:
                n = len(layer.evals)
                half = n // 2
                i0 = cur % half
                i1 = i0 + half
                per_layer.append({
                    "i0": i0,
                    "v0": layer.evals[i0],
                    "v1": layer.evals[i1],
                    "path0": layer.tree.path(i0),
                    "path1": layer.tree.path(i1),
                })
                cur = i0
            queries.append(per_layer)
        return FRIProof(layer_roots=roots, final_poly=final_poly,
                        queries=queries, domain_log=self.cfg.domain_log)

    def verify(self, proof: FRIProof) -> bool:
        r = self.r
        transcript = Transcript("FRI")
        betas = []
        for root in proof.layer_roots:
            transcript.append_field_element(
                "fri_root", int(self.f.decode(root)))
            betas.append(transcript.challenge_field_element("fri_beta", r))
        for c in proof.final_poly:
            transcript.append_field_element("fri_final", c)

        n0 = 1 << proof.domain_log
        for qi, per_layer in enumerate(proof.queries):
            idx = transcript.challenge_field_element(f"fri_q{qi}", n0) % n0
            cur_log = proof.domain_log
            expected_next = None
            cur = idx
            for li, q in enumerate(per_layer):
                n = 1 << cur_log
                half = n // 2
                i0 = cur % half
                if q["i0"] != i0:
                    return False
                # Merkle checks
                root = proof.layer_roots[li]
                leaf0 = self.f.encode([q["v0"]])[0]
                leaf1 = self.f.encode([q["v1"]])[0]
                tree_stub = MerkleTree.__new__(MerkleTree)
                tree_stub.p = self.poseidon
                if not tree_stub.verify(leaf0, i0, q["path0"], root):
                    return False
                if not tree_stub.verify(leaf1, i0 + half, q["path1"], root):
                    return False
                if expected_next is not None:
                    # the folded value from the previous layer lives at this
                    # layer's index `cur`: slot v0 when cur < half, else v1
                    got = q["v0"] if cur < half else q["v1"]
                    if got != expected_next:
                        return False
                # fold consistency:
                # p'(x^2) = (p(x) + p(-x))/2 + beta*(p(x) - p(-x))/(2x)
                dom = self.domain(cur_log)
                x = dom[i0]
                v0, v1 = q["v0"], q["v1"]      # p(x), p(-x)
                inv2 = pow(2, -1, r)
                even = (v0 + v1) * inv2 % r
                odd = (v0 - v1) * inv2 % r * pow(x, -1, r) % r
                expected_next = (even + betas[li] * odd) % r
                cur_log -= 1
                cur = i0
            # final layer: evaluate final_poly at the folded point
            dom = self.domain(cur_log)
            x_final = dom[cur % (1 << cur_log)]
            if _poly_eval(proof.final_poly, x_final, r) != expected_next:
                return False
        return True
