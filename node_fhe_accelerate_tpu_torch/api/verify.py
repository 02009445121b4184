"""Public election verification: re-verify everything from an exported
package (counterpart of node_fhe_accelerate_tpu/api/verify.py).

Loads a `VerificationPackage` (live objects or the portable JSON export),
re-verifies each ballot's validity proof, the Groth16 eligibility proof
when present, nullifier uniqueness, the audit hash chain, and the tally
consistency; emits progress callbacks and JSON/HTML reports.  The JSON
export writes points and scalars as decimal strings, byte for byte as the
JAX package writes them.  The verifier's MSMs run on ``device`` (``cuda``
unless the caller asks for another); the CLI front-end lives in
node_fhe_accelerate_tpu_torch/cli.py.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Optional

__all__ = ["VerificationPackage", "VerificationResult", "PublicVerifier"]


# -- JSON helpers for proof objects ------------------------------------------


def _pt3(t):
    """(x, y, inf) host-int tuple -> JSON list."""
    return [str(t[0]), str(t[1]), bool(t[2])]


def _unpt3(l):
    return (int(l[0]), int(l[1]), bool(l[2]))


def _g1aff(p):
    """Groth16 G1 affine (x, y) or None."""
    return None if p is None else [str(p[0]), str(p[1])]


def _ung1aff(l):
    return None if l is None else (int(l[0]), int(l[1]))


def _g2aff(p):
    """G2 affine (FQ2, FQ2) or None."""
    if p is None:
        return None
    return [[str(c) for c in p[0].coeffs], [str(c) for c in p[1].coeffs]]


def _ung2aff(l):
    from ..zk.pairing import FQ2
    if l is None:
        return None
    return (FQ2([int(c) for c in l[0]]), FQ2([int(c) for c in l[1]]))


def _dev_pt(curve, p):
    """Batched/single device point -> affine JSON (first element)."""
    x, y, inf = curve.to_affine_ints(p)
    import numpy as _np
    x, y, inf = _np.atleast_1d(x), _np.atleast_1d(y), _np.atleast_1d(inf)
    return [str(int(x[0])), str(int(y[0])), bool(inf[0])]


@dataclass
class VerificationPackage:
    """Everything a third party needs to re-verify an election."""
    election_id: str
    num_candidates: int
    ballots: list                 # api.voting.Ballot objects
    audit_json: str
    decrypted_tally: Optional[list] = None
    bp_gens: object = None
    range_bits: int = 8
    elig_vk: object = None        # Groth16 verifying key (setup shim)
    tree_root: Optional[int] = None

    @classmethod
    def from_voting_system(cls, vs) -> "VerificationPackage":
        root = None
        if getattr(vs, "_voter_tree", None) is not None:
            f = vs.poseidon.f
            root = int(f.decode(vs._voter_tree.root[None, :])[0])
        return cls(
            election_id=vs.election_id,
            num_candidates=vs.num_candidates,
            ballots=list(vs._ballots),
            audit_json=vs.export_audit_trail(),
            decrypted_tally=[int(x) for x in vs._decrypted_tally]
            if vs._decrypted_tally is not None else None,
            bp_gens=getattr(vs, "bp_gens", None),
            range_bits=vs.RANGE_BITS,
            elig_vk=getattr(vs, "_elig_setup", None),
            tree_root=root,
        )

    # -- portable JSON export (cli.ts loads this from disk) ------------------
    def to_json(self) -> str:
        """Portable package: proofs + publics + audit chain.  (Encrypted
        ballots travel separately through the serializer's FHEB format --
        the public verifier checks proofs, not ciphertexts.)"""
        from ..zk.curve import bn254_g1

        curve = bn254_g1("cpu")       # decoding reads host constants only
        ballots = []
        for b in self.ballots:
            e = {
                "id": b.ballot_id,
                "nullifier": str(b.nullifier),
                "timestamp": b.timestamp,
            }
            if b.validity_proof is not None:
                p = b.validity_proof
                e["commitment"] = _dev_pt(curve, b.validity_commitment.point)
                e["range_proof"] = {
                    "A": _pt3(p.A), "S": _pt3(p.S),
                    "T1": _pt3(p.T1), "T2": _pt3(p.T2),
                    "t_hat": str(p.t_hat), "tau_x": str(p.tau_x),
                    "mu": str(p.mu),
                    "L": [_pt3(t) for t in p.inner.L],
                    "R": [_pt3(t) for t in p.inner.R],
                    "a": str(p.inner.a), "b": str(p.inner.b),
                }
            if getattr(b, "eligibility_proof", None) is not None:
                gp = b.eligibility_proof
                e["eligibility"] = {
                    "publics": [str(x) for x in b.eligibility_publics],
                    "a": _g1aff(gp.a), "b": _g2aff(gp.b), "c": _g1aff(gp.c),
                }
            ballots.append(e)
        out = {
            "electionId": self.election_id,
            "numCandidates": self.num_candidates,
            "rangeBits": self.range_bits,
            "treeRoot": str(self.tree_root)
            if self.tree_root is not None else None,
            "ballots": ballots,
            "auditJson": self.audit_json,
            "decryptedTally": self.decrypted_tally,
        }
        vk = self.elig_vk
        if vk is not None:
            out["eligibilityVk"] = {
                "numPublic": vk.r1cs.num_public,
                "alphaG1": _dev_pt(curve, vk.alpha_g1),
                "betaG2": _g2aff(vk.beta_g2),
                "gammaG2": _g2aff(vk.gamma_g2),
                "deltaG2": _g2aff(vk.delta_g2),
                "ic": _ic_to_json(curve, vk.ic),
            }
        return json.dumps(out)

    @classmethod
    def from_json(cls, raw: str, device=None) -> "VerificationPackage":
        """The package's points go to ``device``."""
        from ..zk.bulletproofs import (InnerProductProof, PedersenCommitment,
                                       RangeProof)
        from ..zk.curve import bn254_g1
        from ..zk.groth16 import Groth16Proof

        curve = bn254_g1(device)
        d = json.loads(raw)
        ballots = []
        for e in d["ballots"]:
            com = proof = None
            if "range_proof" in e:
                rp = e["range_proof"]
                cx = _unpt3(e["commitment"])
                com = PedersenCommitment(
                    point=curve.from_affine_ints([cx[0]], [cx[1]]))
                proof = RangeProof(
                    A=_unpt3(rp["A"]), S=_unpt3(rp["S"]),
                    T1=_unpt3(rp["T1"]), T2=_unpt3(rp["T2"]),
                    t_hat=int(rp["t_hat"]), tau_x=int(rp["tau_x"]),
                    mu=int(rp["mu"]),
                    inner=InnerProductProof(
                        L=[_unpt3(t) for t in rp["L"]],
                        R=[_unpt3(t) for t in rp["R"]],
                        a=int(rp["a"]), b=int(rp["b"])))
            elig_proof = elig_pubs = None
            if "eligibility" in e:
                el = e["eligibility"]
                elig_pubs = [int(x) for x in el["publics"]]
                elig_proof = Groth16Proof(a=_ung1aff(el["a"]),
                                          b=_ung2aff(el["b"]),
                                          c=_ung1aff(el["c"]))
            ballots.append(SimpleNamespace(
                ballot_id=e["id"], nullifier=int(e["nullifier"]),
                timestamp=e.get("timestamp", 0.0),
                validity_commitment=com, validity_proof=proof,
                eligibility_proof=elig_proof,
                eligibility_publics=elig_pubs))
        vk = None
        if d.get("eligibilityVk"):
            v = d["eligibilityVk"]
            ax = _unpt3(v["alphaG1"])
            vk = SimpleNamespace(
                r1cs=SimpleNamespace(num_public=int(v["numPublic"])),
                alpha_g1=curve.from_affine_ints([ax[0]], [ax[1]]),
                beta_g2=_ung2aff(v["betaG2"]),
                gamma_g2=_ung2aff(v["gammaG2"]),
                delta_g2=_ung2aff(v["deltaG2"]),
                ic=_ic_from_json(curve, v["ic"]))
        return cls(
            election_id=d["electionId"],
            num_candidates=int(d["numCandidates"]),
            ballots=ballots,
            audit_json=d["auditJson"],
            decrypted_tally=d.get("decryptedTally"),
            bp_gens=None,        # regenerated deterministically on demand
            range_bits=int(d["rangeBits"]),
            elig_vk=vk,
            tree_root=int(d["treeRoot"]) if d.get("treeRoot") else None,
        )


def _ic_to_json(curve, ic):
    import numpy as _np
    xs, ys, infs = curve.to_affine_ints(ic)
    xs, ys, infs = _np.atleast_1d(xs), _np.atleast_1d(ys), \
        _np.atleast_1d(infs)
    return [[str(int(x)), str(int(y)), bool(i)]
            for x, y, i in zip(xs, ys, infs)]


def _ic_from_json(curve, rows):
    return curve.from_affine_ints([int(r[0]) for r in rows],
                                  [int(r[1]) for r in rows])


@dataclass
class VerificationResult:
    valid: bool
    ballots_checked: int = 0
    ballots_valid: int = 0
    audit_valid: bool = False
    nullifiers_unique: bool = False
    tally_consistent: bool = True
    failures: list = field(default_factory=list)
    elapsed_s: float = 0.0


class PublicVerifier:
    """(public-verifier.ts:143)  Its curves live on ``device``."""

    def __init__(self, progress: Optional[Callable[[int, int, str], None]]
                 = None, device=None):
        from ..device import resolve_device
        self.progress = progress
        self.device = resolve_device(device)

    def verify_all(self, pkg: VerificationPackage) -> VerificationResult:
        from .audit import AuditTrailManager
        from ..zk.bulletproofs import BulletproofsVerifier

        t0 = time.perf_counter()
        res = VerificationResult(valid=True)

        # 1. audit chain
        audit = AuditTrailManager.import_json(pkg.audit_json)
        res.audit_valid, bad = audit.verify_integrity()
        if not res.audit_valid:
            res.valid = False
            res.failures.append(f"audit chain broken at entries {bad}")

        # 2. nullifier uniqueness
        nulls = [b.nullifier for b in pkg.ballots]
        res.nullifiers_unique = len(nulls) == len(set(nulls))
        if not res.nullifiers_unique:
            res.valid = False
            res.failures.append("duplicate nullifiers detected")

        # 3. ballot validity + eligibility proofs
        need_gens = any(b.validity_proof is not None for b in pkg.ballots)
        gens = pkg.bp_gens
        if need_gens and gens is None:
            # generators are deterministic hash-to-curve: re-derive them
            from ..zk.bulletproofs import BulletproofsGens
            from ..zk.curve import bn254_g1
            gens = BulletproofsGens.generate(bn254_g1(self.device),
                                             pkg.range_bits)
        verifier = BulletproofsVerifier(gens.curve) if need_gens else None
        elig_verifier = None
        if pkg.elig_vk is not None:
            from ..zk.groth16 import Groth16Verifier
            elig_verifier = Groth16Verifier(self.device)
        total = len(pkg.ballots)
        for i, b in enumerate(pkg.ballots):
            if self.progress:
                self.progress(i, total, "verifying ballots")
            res.ballots_checked += 1
            ok = True
            if b.validity_proof is not None:
                ok = verifier.verify_range(b.validity_commitment,
                                           b.validity_proof, pkg.range_bits,
                                           gens)
            ep = getattr(b, "eligibility_proof", None)
            if ok and ep is not None and elig_verifier is not None:
                from ..zk.field import BN254_FR
                pubs = b.eligibility_publics
                ok = (pubs is not None
                      and (pkg.tree_root is None or pubs[0] == pkg.tree_root)
                      and pubs[1] == b.nullifier % BN254_FR
                      and elig_verifier.verify(pkg.elig_vk, pubs, ep))
            if ok:
                res.ballots_valid += 1
            else:
                res.valid = False
                res.failures.append(f"ballot {b.ballot_id}: invalid proof")

        # 4. tally consistency: counts must sum to ballot count
        if pkg.decrypted_tally is not None:
            if sum(pkg.decrypted_tally) != len(pkg.ballots):
                res.tally_consistent = False
                res.valid = False
                res.failures.append(
                    f"tally sum {sum(pkg.decrypted_tally)} != "
                    f"{len(pkg.ballots)} ballots")

        res.elapsed_s = time.perf_counter() - t0
        if self.progress:
            self.progress(total, total, "done")
        return res

    # -- reports (public-verifier.ts:692-773) --------------------------------
    @staticmethod
    def json_report(pkg: VerificationPackage, res: VerificationResult) -> str:
        return json.dumps({
            "electionId": pkg.election_id,
            "valid": res.valid,
            "ballotsChecked": res.ballots_checked,
            "ballotsValid": res.ballots_valid,
            "auditValid": res.audit_valid,
            "nullifiersUnique": res.nullifiers_unique,
            "tallyConsistent": res.tally_consistent,
            "failures": res.failures,
            "elapsedSeconds": res.elapsed_s,
        }, indent=2)

    @staticmethod
    def html_report(pkg: VerificationPackage, res: VerificationResult) -> str:
        status = "VALID" if res.valid else "INVALID"
        rows = "".join(
            f"<li>{f}</li>" for f in res.failures) or "<li>none</li>"
        return (
            f"<html><body><h1>Election {pkg.election_id}: {status}</h1>"
            f"<p>Ballots: {res.ballots_valid}/{res.ballots_checked} valid</p>"
            f"<p>Audit chain: {'ok' if res.audit_valid else 'BROKEN'}</p>"
            f"<p>Failures:</p><ul>{rows}</ul></body></html>")
