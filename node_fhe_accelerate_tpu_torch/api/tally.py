"""Live tally streaming: event-driven encrypted tally management
(counterpart of node_fhe_accelerate_tpu/api/tally.py).

Twin of the reference's `TallyStreamManager` + `TallyWebSocketAdapter`
(src/api/tally-streaming.ts:179-802): ballot_received / tally_updated /
election lifecycle events, filtered subscribers, and a transport-agnostic
message adapter (subscribe/unsubscribe/get_tally).  Unlike the reference —
whose homomorphicAdd is an explicit placeholder (tally-streaming.ts:804-827)
— the tally updates here run the real RLWE addition on the engine's
device (any engine with ``add``: core/encrypt.py or core/rns.py).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

from ..core.encrypt import EncryptionEngine, Ciphertext

__all__ = ["TallyEventType", "TallyEvent", "TallyStreamManager",
           "TallyMessageAdapter"]


class TallyEventType(Enum):
    BALLOT_RECEIVED = "ballot_received"
    TALLY_UPDATED = "tally_updated"
    ELECTION_STARTED = "election_started"
    ELECTION_ENDED = "election_ended"
    ERROR = "error"


@dataclass
class TallyEvent:
    type: TallyEventType
    election_id: str
    timestamp: float
    data: dict = field(default_factory=dict)


@dataclass
class _Subscriber:
    callback: Callable[[TallyEvent], None]
    event_filter: Optional[set] = None
    election_filter: Optional[str] = None


class TallyStreamManager:
    """Encrypted running tallies + event fan-out (tally-streaming.ts:179)."""

    def __init__(self, engine: EncryptionEngine):
        self.engine = engine
        self._tallies: dict[str, Ciphertext] = {}
        self._counts: dict[str, int] = {}
        self._subs: list[_Subscriber] = []
        self._active: set[str] = set()

    # -- subscriptions -------------------------------------------------------
    def subscribe(self, callback, events=None, election_id=None) -> int:
        self._subs.append(_Subscriber(
            callback=callback,
            event_filter=set(events) if events else None,
            election_filter=election_id))
        return len(self._subs) - 1

    def unsubscribe(self, sub_id: int):
        if 0 <= sub_id < len(self._subs):
            self._subs[sub_id] = None

    def _emit(self, event: TallyEvent):
        for sub in self._subs:
            if sub is None:
                continue
            if sub.event_filter and event.type not in sub.event_filter:
                continue
            if sub.election_filter and event.election_id != sub.election_filter:
                continue
            sub.callback(event)

    # -- election lifecycle --------------------------------------------------
    def start_election(self, election_id: str):
        self._active.add(election_id)
        self._emit(TallyEvent(TallyEventType.ELECTION_STARTED, election_id,
                              time.time()))

    def end_election(self, election_id: str) -> Optional[Ciphertext]:
        self._active.discard(election_id)
        self._emit(TallyEvent(TallyEventType.ELECTION_ENDED, election_id,
                              time.time(),
                              {"ballots": self._counts.get(election_id, 0)}))
        return self._tallies.get(election_id)

    # -- ballots -------------------------------------------------------------
    def process_ballot(self, election_id: str, ballot: Ciphertext):
        """Homomorphically fold the ballot into the running tally — real FHE
        (the reference's placeholder fixed)."""
        if election_id not in self._active:
            raise ValueError(f"election {election_id!r} is not active")
        self._emit(TallyEvent(TallyEventType.BALLOT_RECEIVED, election_id,
                              time.time()))
        cur = self._tallies.get(election_id)
        self._tallies[election_id] = ballot if cur is None \
            else self.engine.add(cur, ballot)
        self._counts[election_id] = self._counts.get(election_id, 0) + 1
        self._emit(TallyEvent(TallyEventType.TALLY_UPDATED, election_id,
                              time.time(),
                              {"count": self._counts[election_id]}))

    def get_tally(self, election_id: str) -> Optional[Ciphertext]:
        return self._tallies.get(election_id)

    def get_count(self, election_id: str) -> int:
        return self._counts.get(election_id, 0)


class TallyMessageAdapter:
    """Transport-agnostic message protocol
    (TallyWebSocketAdapter, tally-streaming.ts:596): handles JSON messages
    {action: subscribe|unsubscribe|get_tally, ...} and pushes events through
    a supplied send callable."""

    def __init__(self, manager: TallyStreamManager, send: Callable[[str], None]):
        self.manager = manager
        self.send = send
        self._sub_ids: list[int] = []

    def handle_message(self, raw: str):
        try:
            msg = json.loads(raw)
            action = msg.get("action")
            if action == "subscribe":
                sid = self.manager.subscribe(
                    lambda ev: self.send(json.dumps({
                        "type": ev.type.value,
                        "electionId": ev.election_id,
                        "timestamp": ev.timestamp,
                        "data": ev.data,
                    })),
                    election_id=msg.get("electionId"))
                self._sub_ids.append(sid)
                self.send(json.dumps({"type": "subscribed", "id": sid}))
            elif action == "unsubscribe":
                self.manager.unsubscribe(msg.get("id", -1))
                self.send(json.dumps({"type": "unsubscribed"}))
            elif action == "get_tally":
                eid = msg.get("electionId", "")
                self.send(json.dumps({
                    "type": "tally",
                    "electionId": eid,
                    "count": self.manager.get_count(eid),
                }))
            else:
                self.send(json.dumps({"type": "error",
                                      "message": f"unknown action {action!r}"}))
        except json.JSONDecodeError:
            self.send(json.dumps({"type": "error", "message": "bad json"}))

    def close(self):
        for sid in self._sub_ids:
            self.manager.unsubscribe(sid)
