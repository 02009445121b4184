"""Hash-chained immutable audit trail (a copy of
node_fhe_accelerate_tpu/api/audit.py, which imports nothing of JAX; the
port keeps its own).

Twin of the reference's `AuditTrailManager` (src/api/audit-trail.ts:67-1023):
SHA-256 prev-hash chain, 20+ operation types, actor roles, integrity
verification by walking the chain, JSON/CSV export.  This piece of the
reference is real logic (not simulated) and ports semantically intact.
"""
from __future__ import annotations

import csv
import hashlib
import io
import json
import time
from dataclasses import asdict, dataclass
from enum import Enum

__all__ = ["AuditOperation", "AuditActor", "AuditEntry", "AuditTrailManager"]


class AuditOperation(Enum):
    # audit-trail.ts operation catalogue
    SYSTEM_INITIALIZED = "system_initialized"
    ELECTION_CREATED = "election_created"
    ELECTION_STARTED = "election_started"
    ELECTION_ENDED = "election_ended"
    VOTER_REGISTERED = "voter_registered"
    VOTER_VERIFIED = "voter_verified"
    BALLOT_SUBMITTED = "ballot_submitted"
    BALLOT_VERIFIED = "ballot_verified"
    BALLOT_REJECTED = "ballot_rejected"
    TALLY_UPDATED = "tally_updated"
    TALLY_DECRYPTED = "tally_decrypted"
    PARTIAL_DECRYPTION = "partial_decryption"
    KEY_GENERATED = "key_generated"
    KEY_SHARE_DISTRIBUTED = "key_share_distributed"
    PROOF_GENERATED = "proof_generated"
    PROOF_VERIFIED = "proof_verified"
    PROOF_FAILED = "proof_failed"
    FRAUD_ALERT = "fraud_alert"
    FRAUD_CHECK = "fraud_check"
    EXPORT_PERFORMED = "export_performed"
    VERIFICATION_PERFORMED = "verification_performed"
    CONFIG_CHANGED = "config_changed"


class AuditActor(Enum):
    SYSTEM = "system"
    VOTER = "voter"
    OFFICIAL = "official"
    VERIFIER = "verifier"


@dataclass
class AuditEntry:
    sequence: int
    timestamp: float
    operation: str
    actor_type: str
    actor_id: str
    details: dict
    prev_hash: str
    hash: str = ""

    def compute_hash(self) -> str:
        payload = json.dumps(
            {"sequence": self.sequence, "timestamp": self.timestamp,
             "operation": self.operation, "actorType": self.actor_type,
             "actorId": self.actor_id, "details": self.details,
             "prevHash": self.prev_hash},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()


GENESIS_HASH = "0" * 64


class AuditTrailManager:
    """Append-only hash chain (audit-trail.ts:265)."""

    def __init__(self, clock=time.time):
        self._entries: list[AuditEntry] = []
        self._clock = clock

    def log(self, operation: AuditOperation, actor_type: AuditActor,
            actor_id: str, details: dict | None = None) -> AuditEntry:
        prev = self._entries[-1].hash if self._entries else GENESIS_HASH
        e = AuditEntry(
            sequence=len(self._entries), timestamp=self._clock(),
            operation=operation.value, actor_type=actor_type.value,
            actor_id=actor_id, details=details or {}, prev_hash=prev)
        e.hash = e.compute_hash()
        self._entries.append(e)
        return e

    # convenience loggers mirroring audit-trail.ts API surface
    def log_ballot_submitted(self, voter_id: str, details=None):
        return self.log(AuditOperation.BALLOT_SUBMITTED, AuditActor.VOTER,
                        voter_id, details)

    def log_fraud_alert(self, details):
        return self.log(AuditOperation.FRAUD_ALERT, AuditActor.SYSTEM,
                        "fraud-detector", details)

    @property
    def entries(self) -> list[AuditEntry]:
        return list(self._entries)

    def verify_integrity(self) -> tuple[bool, list[int]]:
        """Walk the chain re-hashing every entry (audit-trail.ts:693-708)."""
        bad = []
        prev = GENESIS_HASH
        for i, e in enumerate(self._entries):
            if e.prev_hash != prev or e.compute_hash() != e.hash \
                    or e.sequence != i:
                bad.append(i)
            prev = e.hash
        return (not bad, bad)

    # -- export (audit-trail.ts:951) ----------------------------------------
    def export_json(self) -> str:
        return json.dumps([asdict(e) for e in self._entries], indent=2)

    def export_csv(self) -> str:
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["sequence", "timestamp", "operation", "actorType",
                    "actorId", "details", "prevHash", "hash"])
        for e in self._entries:
            w.writerow([e.sequence, e.timestamp, e.operation, e.actor_type,
                        e.actor_id, json.dumps(e.details, sort_keys=True),
                        e.prev_hash, e.hash])
        return buf.getvalue()

    @classmethod
    def import_json(cls, raw: str) -> "AuditTrailManager":
        mgr = cls()
        for d in json.loads(raw):
            mgr._entries.append(AuditEntry(**d))
        return mgr
