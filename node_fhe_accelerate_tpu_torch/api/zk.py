"""ZKProofManager -- unified facade over the three proof systems
(counterpart of node_fhe_accelerate_tpu/api/zk.py):

* ballot validity  -> Bulletproofs range proofs      (zk/bulletproofs.py)
* eligibility      -> Groth16 over the Poseidon-Merkle EligibilityCircuit
                      (zk/circuits.py + zk/groth16.py, real pairing verify)
* tally correctness-> PLONK over tally_correctness_circuit (zk/plonk.py)

Result objects carry a valid flag, timing and an error string; camelCase
aliases cover the TypeScript method names.  Everything runs on ``device``
(``cuda`` unless the caller asks for another); the manager keeps one
prover and one verifier object per proof system, so the MSM band race of
each curve object runs once.
"""
from __future__ import annotations

import secrets
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["ZKProofManager", "ZKVerificationResult", "BallotValidityProof",
           "EligibilityProof", "TallyCorrectnessProof"]


@dataclass
class ZKVerificationResult:
    """zk-types.ts ZKVerificationResult."""
    valid: bool
    verification_time_ms: float = 0.0
    error: Optional[str] = None


@dataclass
class BallotValidityProof:
    commitment: object
    range_proof: object
    num_candidates: int
    range_bits: int


@dataclass
class EligibilityProof:
    proof: object                 # Groth16Proof
    public_inputs: list           # [merkle_root, nullifier]


@dataclass
class TallyCorrectnessProof:
    proof: object                 # PlonkProof
    total: int
    num_ballots: int


class ZKProofManager:
    """Unified prove/verify across the ballot / eligibility / tally systems.

    Bulletproofs are always available; Groth16 and PLONK lazily set up on
    first use (`init_eligibility` / `init_tally`), mirroring the
    reference's initGroth16/initPlonk key injection."""

    def __init__(self, range_bits: int = 8, tree_depth: int = 8,
                 device=None):
        from ..device import resolve_device
        from ..zk.bulletproofs import (BulletproofsProver,
                                       BulletproofsVerifier,
                                       BulletproofsGens)
        from ..zk.curve import bn254_g1

        self.device = resolve_device(device)
        self.range_bits = range_bits
        self.tree_depth = tree_depth
        curve = bn254_g1(self.device)
        self._bp_prover = BulletproofsProver(curve)
        self._bp_verifier = BulletproofsVerifier(curve)
        self._bp_gens = BulletproofsGens.generate(curve, range_bits)
        self._elig = None        # (circuit, tree, order, prover, setup, ...)
        self._tally = None       # (circuit, ballots, total, prover, setup)
        self._elig_verifier = None
        self._tally_verifier = None

    # -- ballot validity (Bulletproofs; zk-proofs.ts:86-155) -----------------
    def prove_ballot_validity(self, vote: int, num_candidates: int
                              ) -> BallotValidityProof:
        if not (0 <= vote < num_candidates):
            raise ValueError("vote out of range")
        blinding = self._bp_prover.random_scalar()
        commitment = self._bp_prover.commit(vote, blinding, self._bp_gens)
        proof = self._bp_prover.prove_range(vote, blinding, self.range_bits,
                                            self._bp_gens)
        return BallotValidityProof(commitment=commitment, range_proof=proof,
                                   num_candidates=num_candidates,
                                   range_bits=self.range_bits)

    def verify_ballot_validity(self, p: BallotValidityProof
                               ) -> ZKVerificationResult:
        t0 = time.perf_counter()
        try:
            ok = self._bp_verifier.verify_range(
                p.commitment, p.range_proof, p.range_bits, self._bp_gens)
            return ZKVerificationResult(
                bool(ok), (time.perf_counter() - t0) * 1e3,
                None if ok else "range proof rejected")
        except Exception as e:  # malformed proof objects must not crash
            return ZKVerificationResult(
                False, (time.perf_counter() - t0) * 1e3, str(e))

    def batch_verify_ballots(self, proofs: list) -> list:
        return [self.verify_ballot_validity(p) for p in proofs]

    # -- eligibility (Groth16; zk-proofs.ts:196-271) --------------------------
    def init_eligibility(self, voter_ids: list) -> int:
        """Build the Poseidon-Merkle registry + Groth16 setup; returns the
        root (a public input of every eligibility proof).  voter_ids are
        ints (field elements); registration secrets are drawn here from
        the OS CSPRNG and returned via get_voter_secret."""
        from ..zk.circuits import EligibilityCircuit
        from ..zk.hashes import MerkleTree, PoseidonHash
        from ..zk.groth16 import Groth16Prover

        poseidon = PoseidonHash(device=self.device)
        # circuit depth must equal the padded tree depth exactly (the
        # witness feeds one sibling per level); derive it from the roster
        depth = max(1, (len(voter_ids) - 1).bit_length())
        self.tree_depth = depth
        circuit = EligibilityCircuit(depth, poseidon)
        self._secrets = {int(v): secrets.randbits(248) for v in voter_ids}
        order = [int(v) for v in voter_ids]
        leaf_ints = circuit.leaves(order)
        leaf_ints += [0] * ((1 << depth) - len(leaf_ints))
        leaves = poseidon.f.encode(leaf_ints)
        tree = MerkleTree(poseidon, leaves)
        prover = Groth16Prover(device=self.device)
        setup = prover.setup(circuit.r1cs)
        root = int(poseidon.f.decode(tree.root[None, :])[0])
        self._elig = (circuit, tree, order, prover, setup, poseidon, root)
        return root

    def get_voter_secret(self, voter_id: int) -> int:
        return self._secrets[int(voter_id)]

    def prove_eligibility(self, voter_id: int, voter_secret: int
                          ) -> EligibilityProof:
        if self._elig is None:
            raise RuntimeError("call init_eligibility first")
        circuit, tree, order, prover, setup, poseidon, root = self._elig
        idx = order.index(int(voter_id))
        f = poseidon.f
        path = [int(f.decode(s[None, :])[0]) for s in tree.path(idx)]
        bits = [(idx >> k) & 1 for k in range(circuit.depth)]
        wit = circuit.generate_witness(int(voter_id), int(voter_secret),
                                       path, bits, root)
        proof = prover.prove(setup, wit.assignment)
        return EligibilityProof(proof=proof,
                                public_inputs=wit.public_inputs)

    def verify_eligibility(self, p: EligibilityProof) -> ZKVerificationResult:
        from ..zk.groth16 import Groth16Verifier
        if self._elig is None:
            raise RuntimeError("call init_eligibility first")
        setup = self._elig[4]
        if self._elig_verifier is None:
            self._elig_verifier = Groth16Verifier(self.device)
        t0 = time.perf_counter()
        try:
            ok = self._elig_verifier.verify(setup, p.public_inputs, p.proof)
            return ZKVerificationResult(
                bool(ok), (time.perf_counter() - t0) * 1e3,
                None if ok else "pairing check failed")
        except Exception as e:
            return ZKVerificationResult(
                False, (time.perf_counter() - t0) * 1e3, str(e))

    # -- tally correctness (PLONK; zk-proofs.ts:328-416) -----------------------
    def init_tally(self, num_ballots: int) -> None:
        from ..zk.plonk import PlonkProver, tally_correctness_circuit
        circuit, ballots, total = tally_correctness_circuit(num_ballots)
        prover = PlonkProver(device=self.device)
        setup = prover.setup(circuit)
        self._tally = (circuit, ballots, total, prover, setup)

    def prove_tally_correctness(self, ballot_values: list, total: int
                                ) -> TallyCorrectnessProof:
        from ..zk.plonk import R as FR
        if self._tally is None:
            self.init_tally(len(ballot_values))
        circuit, ballots, total_var, prover, setup = self._tally
        if len(ballot_values) != len(ballots):
            raise ValueError("ballot count does not match the tally circuit")
        assign = {total_var: total % FR}
        for var, v in zip(ballots, ballot_values):
            assign[var] = int(v) % FR
        # accumulator wires from the gate program (addition chain)
        acc_val = assign[ballots[0]]
        for g in circuit.gates:
            if g.qm == 0 and g.ql == 1 and g.qr == 1:
                a = assign.get(g.a, acc_val)
                acc_val = (a + assign[g.b]) % FR
                assign[g.c] = acc_val
        proof = prover.prove(setup, assign, [total % FR])
        return TallyCorrectnessProof(proof=proof, total=total,
                                     num_ballots=len(ballot_values))

    def verify_tally_correctness(self, p: TallyCorrectnessProof
                                 ) -> ZKVerificationResult:
        from ..zk.plonk import PlonkVerifier, R as FR
        if self._tally is None:
            raise RuntimeError("call init_tally first")
        setup = self._tally[4]
        if self._tally_verifier is None:
            self._tally_verifier = PlonkVerifier(self.device)
        t0 = time.perf_counter()
        try:
            ok = self._tally_verifier.verify(setup, [p.total % FR], p.proof)
            return ZKVerificationResult(
                bool(ok), (time.perf_counter() - t0) * 1e3,
                None if ok else "opening check failed")
        except Exception as e:
            return ZKVerificationResult(
                False, (time.perf_counter() - t0) * 1e3, str(e))

    # -- metadata (zk-proofs.ts:560) -------------------------------------------
    def get_proof_system(self, proof_type: str) -> dict:
        table = {
            "ballot": {"system": "bulletproofs", "curve": "bn254",
                       "interactive": False,
                       "trusted_setup": False},
            "eligibility": {"system": "groth16", "curve": "bn254",
                            "interactive": False, "trusted_setup": True},
            "tally": {"system": "plonk", "curve": "bn254",
                      "interactive": False,
                      "trusted_setup": "universal (KZG SRS)"},
        }
        if proof_type not in table:
            raise ValueError(f"unknown proof type {proof_type!r}")
        return table[proof_type]


# camelCase aliases (zk-proofs.ts method names)
for _camel, _snake in {
    "proveBallotValidity": "prove_ballot_validity",
    "verifyBallotValidity": "verify_ballot_validity",
    "batchVerify": "batch_verify_ballots",
    "proveEligibility": "prove_eligibility",
    "verifyEligibility": "verify_eligibility",
    "proveTallyCorrectness": "prove_tally_correctness",
    "verifyTallyCorrectness": "verify_tally_correctness",
    "getProofSystem": "get_proof_system",
}.items():
    setattr(ZKProofManager, _camel, getattr(ZKProofManager, _snake))
