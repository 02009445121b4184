"""End-to-end encrypted voting system (counterpart of
node_fhe_accelerate_tpu/api/voting.py): the election lifecycle (create ->
register -> start -> submit -> verify -> end -> threshold decrypt -> audit
export), each subsystem backed by the port's implementations on the
system's device (``cuda`` unless the caller asks for another):

* ballots: RLWE one-hot encryption (core/encrypt.py; one K8 launch each on
  the card)
* ballot validity: Bulletproofs range proof on the vote choice
  (zk/bulletproofs.py)
* eligibility: Groth16 SNARK over the Poseidon-Merkle EligibilityCircuit
  (zk/circuits.py) -- membership + nullifier proven in-circuit with public
  inputs [merkle_root, nullifier]; enable with eligibility_snark=True.  The
  tree leaf commits to a secret voter identity vid = H(voter_id || secret)
  rather than the public voter_id, so knowing someone's voter_id is not
  enough to forge their membership proof.
* tally: streaming homomorphic adds (api/tally.py)
* decryption: M-of-N Shamir threshold (core/threshold.py)
* audit: hash-chained log (api/audit.py)
* fraud: duplicate/timing/statistical detection (api/fraud.py)
"""
from __future__ import annotations

import secrets
import time
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np

from ..core import threshold as th
from ..core.encrypt import Ciphertext
from ..zk.bulletproofs import (
    BulletproofsGens, BulletproofsProver, BulletproofsVerifier,
)
from ..zk.circuits import EligibilityCircuit
from ..zk.curve import bn254_g1
from ..zk.field import BN254_FR
from ..zk.groth16 import Groth16Prover, Groth16Verifier
from ..zk.hashes import Blake2sHash, MerkleTree, PoseidonHash
from .audit import AuditActor, AuditOperation, AuditTrailManager
from .context import FHEContext
from .fraud import FraudDetector, TimestampedBallot
from .tally import TallyStreamManager

__all__ = ["ElectionState", "Ballot", "VotingSystem"]


class ElectionState(Enum):
    CREATED = "created"
    REGISTRATION = "registration"
    ACTIVE = "active"
    ENDED = "ended"
    DECRYPTED = "decrypted"


@dataclass
class Ballot:
    ballot_id: str
    ciphertext: Ciphertext
    validity_proof: object
    validity_commitment: object
    eligibility_root: object
    nullifier: int
    timestamp: float
    eligibility_proof: object = None       # Groth16Proof when SNARK mode
    eligibility_publics: list = None       # [merkle_root, nullifier] ints


class VotingSystem:
    """(voting-example.ts:152-587)  ``device`` goes to the FHE context's
    engine; the ZK objects live on the same device."""

    RANGE_BITS = 8  # vote choice in [0, 2^8)

    def __init__(self, election_id: str, num_candidates: int,
                 threshold=(3, 5), preset: str = "TFHE_128_VOTING",
                 enable_zk: bool = True, eligibility_snark: bool = False,
                 device=None):
        # enable_zk=False skips ballot validity proofs (fast tally-only mode
        # for tests/benchmarks); eligibility nullifiers stay on.
        # eligibility_snark=True additionally proves Merkle membership +
        # nullifier correctness in a Groth16 SNARK per ballot
        # (voting-example.ts:627-701); off by default because proving costs
        # seconds per ballot at realistic tree depths.
        if num_candidates < 2:
            raise ValueError("need at least two candidates")
        self.election_id = election_id
        self.num_candidates = num_candidates
        self.state = ElectionState.CREATED

        # FHE context with threshold keys (fhe-context.ts:356)
        self.ctx = FHEContext.create(preset, threshold=threshold,
                                     device=device)
        self.device = self.ctx.engine.device
        # swap the context pk to the threshold master key so threshold
        # decryption applies to ballots
        tk = self.ctx.threshold_keys
        self.ctx.sk = tk.master_sk
        self.ctx.pk = self.ctx.engine.generate_public_key(tk.master_sk)
        self.threshold = threshold

        # ZK machinery (voting-example.ts:173-183)
        self.enable_zk = enable_zk
        if enable_zk:
            curve = bn254_g1(self.device)
            self.bp_gens = BulletproofsGens.generate(curve, self.RANGE_BITS)
            self.bp_prover = BulletproofsProver(curve)
            self.bp_verifier = BulletproofsVerifier(curve)
        self.poseidon = PoseidonHash(device=self.device)
        self.eligibility_snark = eligibility_snark
        self._elig_circuit: Optional[EligibilityCircuit] = None
        self._elig_setup = None
        self._elig_prover: Optional[Groth16Prover] = None
        self._elig_verifier = Groth16Verifier(self.device) \
            if eligibility_snark else None

        # services
        self.tally = TallyStreamManager(self.ctx.engine.engine)
        self.audit = AuditTrailManager()
        self.fraud = FraudDetector(self.ctx.engine.engine)

        self._voters: dict[str, int] = {}       # voter_id -> secret
        self._voter_tree: Optional[MerkleTree] = None
        self._ballots: list[Ballot] = []
        self._nullifiers: set = set()
        self._timestamped: list[TimestampedBallot] = []
        self._decrypted_tally: Optional[np.ndarray] = None

        self.audit.log(AuditOperation.ELECTION_CREATED, AuditActor.OFFICIAL,
                       "system", {"electionId": election_id,
                                  "candidates": num_candidates})
        self.state = ElectionState.REGISTRATION

    # -- registration (voting-example.ts:227) --------------------------------
    def register_voter(self, voter_id: str) -> int:
        if self.state != ElectionState.REGISTRATION:
            raise ValueError("registration is closed")
        if voter_id in self._voters:
            raise ValueError(f"voter {voter_id!r} already registered")
        # OS CSPRNG: the eligibility secret must be unpredictable even to
        # someone who knows voter_id (the reference accepts voter-supplied
        # key material at registration, voting-example.ts:227; here the
        # system generates it with real entropy and returns it to the voter).
        secret = secrets.randbits(248)
        self._voters[voter_id] = secret
        self.audit.log(AuditOperation.VOTER_REGISTERED, AuditActor.VOTER,
                       voter_id)
        return secret

    # -- lifecycle -----------------------------------------------------------
    def start_election(self):
        if not self._voters:
            raise ValueError("no registered voters")
        f = self.poseidon.f
        if self.eligibility_snark:
            # EligibilityCircuit semantics (groth16.h:342-406):
            # leaf = hash2(vid, vid); tree padded to a power of two.
            n = len(self._voters)
            depth = max(1, (n - 1).bit_length())
            self._elig_circuit = EligibilityCircuit(depth, self.poseidon)
            self._elig_order = list(self._voters)       # voter_id -> index
            leaf_ints = self._elig_circuit.leaves(
                [self._vid(v) for v in self._elig_order])
            # pad with zero leaves to the full 2^depth so circuit depth
            # and tree depth agree
            leaf_ints += [0] * ((1 << depth) - n)
            leaves = f.encode(leaf_ints)
            self._voter_tree = MerkleTree(self.poseidon, leaves)
            self._elig_prover = Groth16Prover(device=self.device)
            self._elig_setup = self._elig_prover.setup(
                self._elig_circuit.r1cs)
        else:
            # hash-only mode: tree over H(voter_secret)
            leaves = f.encode([self._leaf_value(s)
                               for s in self._voters.values()])
            self._voter_tree = MerkleTree(self.poseidon, leaves)
        self.state = ElectionState.ACTIVE
        self.tally.start_election(self.election_id)
        self.audit.log(AuditOperation.ELECTION_STARTED, AuditActor.OFFICIAL,
                       "system")

    def _vid(self, voter_id: str) -> int:
        """Secret voter identity: H(voter_id || secret) — unknowable
        without the registration secret (see class docstring)."""
        secret = self._voters[voter_id]
        return Blake2sHash.to_field_element(
            Blake2sHash.hash(voter_id.encode()
                             + secret.to_bytes(32, "little")), BN254_FR)

    def _leaf_value(self, secret: int) -> int:
        return int(self.poseidon.f.decode(
            self.poseidon.hash(self.poseidon.f.encode([secret])[0])))

    def _nullifier(self, secret: int) -> int:
        return self.poseidon.hash_ints([secret, 1])

    # -- ballots (voting-example.ts:267) -------------------------------------
    def submit_ballot(self, voter_id: str, choice: int) -> Ballot:
        if self.state != ElectionState.ACTIVE:
            raise ValueError("election is not active")
        if voter_id not in self._voters:
            raise ValueError("voter not registered")
        if not (0 <= choice < self.num_candidates):
            raise ValueError("invalid candidate")
        secret = self._voters[voter_id]
        elig_proof = None
        elig_publics = None
        if self.eligibility_snark:
            circ = self._elig_circuit
            vid = self._vid(voter_id)
            nullifier = circ.nullifier(vid, secret)
            if nullifier in self._nullifiers:
                raise ValueError(
                    "ballot already submitted (nullifier reuse)")
            idx = self._elig_order.index(voter_id)
            f = self.poseidon.f
            path = [int(f.decode(s[None, :])[0])
                    for s in self._voter_tree.path(idx)]
            bits = [(idx >> k) & 1 for k in range(circ.depth)]
            root = int(f.decode(self._voter_tree.root[None, :])[0])
            wit = circ.generate_witness(vid, secret, path, bits, root)
            elig_proof = self._elig_prover.prove(self._elig_setup,
                                                 wit.assignment)
            elig_publics = wit.public_inputs
        else:
            nullifier = self._nullifier(secret)
            if nullifier in self._nullifiers:
                raise ValueError(
                    "ballot already submitted (nullifier reuse)")

        # One-hot encrypt: slot[candidate] = 1
        onehot = np.zeros(self.num_candidates, dtype=np.uint64)
        onehot[choice] = 1
        ct = self.ctx.engine.encrypt_packed(onehot, self.ctx.pk)

        # Validity: choice in range via Bulletproofs (zk-proofs.ts:86 intent)
        commitment = proof = None
        if self.enable_zk:
            blinding = self.bp_prover.random_scalar()
            commitment = self.bp_prover.commit(choice, blinding, self.bp_gens)
            proof = self.bp_prover.prove_range(choice, blinding,
                                               self.RANGE_BITS, self.bp_gens)

        ballot = Ballot(
            ballot_id=f"{self.election_id}-{len(self._ballots)}",
            ciphertext=ct, validity_proof=proof,
            validity_commitment=commitment,
            eligibility_root=self._voter_tree.root,
            nullifier=nullifier, timestamp=time.time(),
            eligibility_proof=elig_proof,
            eligibility_publics=elig_publics)
        self._nullifiers.add(nullifier)
        self._ballots.append(ballot)
        self._timestamped.append(
            TimestampedBallot(ballot=ct, timestamp=ballot.timestamp,
                              voter_id=voter_id))
        self.tally.process_ballot(self.election_id, ct)
        self.audit.log_ballot_submitted(voter_id,
                                        {"ballotId": ballot.ballot_id})
        return ballot

    # -- verification (voting-example.ts:376) --------------------------------
    def verify_ballot(self, ballot: Ballot) -> bool:
        if not self.enable_zk:
            return ballot.nullifier in self._nullifiers
        ok = self.bp_verifier.verify_range(
            ballot.validity_commitment, ballot.validity_proof,
            self.RANGE_BITS, self.bp_gens)
        if ok and self.eligibility_snark:
            f = self.poseidon.f
            root = int(f.decode(self._voter_tree.root[None, :])[0])
            pubs = ballot.eligibility_publics
            ok = (ballot.eligibility_proof is not None
                  and pubs is not None
                  and pubs[0] == root                    # election's tree
                  and pubs[1] == ballot.nullifier % BN254_FR
                  and self._elig_verifier.verify(self._elig_setup, pubs,
                                                 ballot.eligibility_proof))
        self.audit.log(
            AuditOperation.PROOF_VERIFIED if ok else AuditOperation.PROOF_FAILED,
            AuditActor.VERIFIER, "system", {"ballotId": ballot.ballot_id})
        return ok

    # -- end + decrypt (voting-example.ts:400-426) ---------------------------
    def end_election(self) -> Ciphertext:
        if self.state != ElectionState.ACTIVE:
            raise ValueError("election is not active")
        self.state = ElectionState.ENDED
        tally_ct = self.tally.end_election(self.election_id)
        self.audit.log(AuditOperation.ELECTION_ENDED, AuditActor.OFFICIAL,
                       "system", {"ballots": len(self._ballots)})
        if tally_ct is None:
            raise ValueError("no ballots were cast")
        return tally_ct

    def decrypt_tally(self, official_share_ids: list) -> np.ndarray:
        """Threshold decryption with the given officials' shares."""
        if self.state != ElectionState.ENDED:
            raise ValueError("end the election first")
        tally_ct = self.tally.get_tally(self.election_id)
        tk = self.ctx.threshold_keys
        shares = [s for s in tk.shares if s.share_id in official_share_ids]
        ring = self.ctx.engine.ring
        partials = [th.partial_decrypt(ring, tally_ct.c1, s) for s in shares]
        for s in shares:
            self.audit.log(AuditOperation.PARTIAL_DECRYPTION,
                           AuditActor.OFFICIAL, f"official-{s.share_id}")
        phase = th.combine_partial_decryptions(ring, tally_ct.c0, partials,
                                               tk.threshold)
        counts = self.ctx.engine.engine.decode(phase, self.num_candidates)
        self._decrypted_tally = counts
        self.state = ElectionState.DECRYPTED
        self.audit.log(AuditOperation.TALLY_DECRYPTED, AuditActor.OFFICIAL,
                       "quorum", {"counts": [int(c) for c in counts]})
        return counts

    # -- fraud + audit -------------------------------------------------------
    def run_fraud_checks(self):
        dup = self.fraud.detect_duplicates([b.ciphertext
                                            for b in self._ballots])
        timing = self.fraud.detect_timing_anomalies(self._timestamped)
        alerts = dup.alerts + timing.alerts
        for a in alerts:
            self.audit.log_fraud_alert({"type": a.type.value,
                                        "description": a.description})
        return alerts

    def export_audit_trail(self) -> str:
        self.audit.log(AuditOperation.EXPORT_PERFORMED, AuditActor.SYSTEM,
                       "system")
        return self.audit.export_json()
