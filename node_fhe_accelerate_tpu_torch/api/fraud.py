"""Fraud detection: duplicate ballots, statistical anomalies, timing
(counterpart of node_fhe_accelerate_tpu/api/fraud.py).

Twin of the reference's `FraudDetector` (cpp/include/fraud_detector.h:34-142,
cpp/src/fraud_detector.cpp:66-133): pairwise encrypted duplicate detection,
z-score statistical anomaly vs a `StatisticalModel`, timing analysis of
timestamped ballots, threshold checks — producing `FraudAlert` records with
encrypted evidence.

The O(n^2) pairwise duplicate scan runs vectorized: all pairwise
ciphertext differences are one batched modular subtraction over (B, B) on
the engine's device rather than a Python/C++ double loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np
import torch

from ..core.encrypt import EncryptionEngine, Ciphertext

__all__ = ["FraudAlertType", "FraudAlert", "StatisticalModel",
           "TimestampedBallot", "FraudDetectionResult", "FraudDetector"]


class FraudAlertType(Enum):
    DUPLICATE_VOTE = "duplicate_vote"
    STATISTICAL_ANOMALY = "statistical_anomaly"
    TIMING_ANOMALY = "timing_anomaly"
    THRESHOLD_EXCEEDED = "threshold_exceeded"
    PATTERN_ANOMALY = "pattern_anomaly"


@dataclass
class FraudAlert:
    type: FraudAlertType
    description: str
    confidence: float
    timestamp: float = field(default_factory=time.time)
    encrypted_evidence: Optional[Ciphertext] = None
    ballot_index: Optional[int] = None


@dataclass
class StatisticalModel:
    """Expected voting pattern (fraud_detector.h StatisticalModel)."""
    expected_rate_per_minute: float = 10.0
    rate_std: float = 5.0
    expected_distribution: Optional[np.ndarray] = None  # per-candidate probs


@dataclass
class TimestampedBallot:
    ballot: Ciphertext
    timestamp: float
    voter_id: str = ""


@dataclass
class FraudDetectionResult:
    ballots_analyzed: int = 0
    alerts: list = field(default_factory=list)
    analysis_time_ms: float = 0.0


class FraudDetector:
    def __init__(self, engine: EncryptionEngine,
                 duplicate_sensitivity: float = 0.5):
        if engine is None:
            raise ValueError("encryption engine is required")
        self.engine = engine
        self.duplicate_sensitivity = min(max(duplicate_sensitivity, 0.0), 1.0)
        self.model = StatisticalModel()

    def set_statistical_model(self, model: StatisticalModel):
        self.model = model

    # -- duplicate detection (fraud_detector.cpp:66-133) --------------------
    def detect_duplicates(self, ballots: list) -> FraudDetectionResult:
        """Pairwise difference scan, vectorized over the full batch.

        Like the reference, this flags pairs whose ciphertext difference has
        suspiciously high noise budget (identical ciphertexts difference to
        exactly zero); true encrypted-equality uses PBS (engine-level
        comparisons in api/engine.py).
        """
        t0 = time.perf_counter()
        res = FraudDetectionResult(ballots_analyzed=len(ballots))
        if len(ballots) < 2:
            res.analysis_time_ms = (time.perf_counter() - t0) * 1e3
            return res
        b = len(ballots)
        c0_lo = torch.stack([c.c0[0] for c in ballots])
        c0_hi = torch.stack([c.c0[1] for c in ballots])
        c1_lo = torch.stack([c.c1[0] for c in ballots])
        c1_hi = torch.stack([c.c1[1] for c in ballots])
        ring = self.engine.ring
        # All pairwise diffs in one fused op: (B, 1, N) - (1, B, N)
        d0 = ring.sub((c0_lo[:, None], c0_hi[:, None]),
                      (c0_lo[None, :], c0_hi[None, :]))
        d1 = ring.sub((c1_lo[:, None], c1_hi[:, None]),
                      (c1_lo[None, :], c1_hi[None, :]))
        # A duplicate submission (byte-identical ciphertext) differences to 0.
        zero = ((d0[0] == 0).all(-1) & (d0[1] == 0).all(-1)
                & (d1[0] == 0).all(-1) & (d1[1] == 0).all(-1)).cpu().numpy()
        for i in range(b):
            for j in range(i + 1, b):
                if zero[i, j]:
                    res.alerts.append(FraudAlert(
                        FraudAlertType.DUPLICATE_VOTE,
                        f"Identical ciphertext between ballots {i} and {j}",
                        max(self.duplicate_sensitivity, 0.9),
                        ballot_index=i))
        res.analysis_time_ms = (time.perf_counter() - t0) * 1e3
        return res

    # -- statistical anomaly (z-score) --------------------------------------
    def detect_statistical_anomalies(self, counts_per_minute: list
                                     ) -> FraudDetectionResult:
        t0 = time.perf_counter()
        res = FraudDetectionResult(ballots_analyzed=int(sum(counts_per_minute)))
        mu = self.model.expected_rate_per_minute
        sd = max(self.model.rate_std, 1e-9)
        for minute, c in enumerate(counts_per_minute):
            z = (c - mu) / sd
            if abs(z) > 3.0:
                res.alerts.append(FraudAlert(
                    FraudAlertType.STATISTICAL_ANOMALY,
                    f"Ballot rate z-score {z:.1f} at minute {minute}",
                    min(1.0, abs(z) / 6.0)))
        res.analysis_time_ms = (time.perf_counter() - t0) * 1e3
        return res

    # -- timing analysis ----------------------------------------------------
    def detect_timing_anomalies(self, ballots: list,
                                min_interval_s: float = 0.05
                                ) -> FraudDetectionResult:
        """Bursts of ballots from one voter / impossible inter-arrival gaps."""
        t0 = time.perf_counter()
        res = FraudDetectionResult(ballots_analyzed=len(ballots))
        by_voter: dict = {}
        for idx, tb in enumerate(ballots):
            by_voter.setdefault(tb.voter_id, []).append((tb.timestamp, idx))
        for voter, entries in by_voter.items():
            entries.sort()
            for (t1, _), (t2, idx2) in zip(entries, entries[1:]):
                if t2 - t1 < min_interval_s:
                    res.alerts.append(FraudAlert(
                        FraudAlertType.TIMING_ANOMALY,
                        f"Voter {voter!r} submitted twice within "
                        f"{(t2 - t1) * 1e3:.0f} ms",
                        0.8, ballot_index=idx2))
        res.analysis_time_ms = (time.perf_counter() - t0) * 1e3
        return res

    # -- threshold check ----------------------------------------------------
    def check_threshold(self, tally_value: int, threshold: int
                        ) -> FraudDetectionResult:
        res = FraudDetectionResult()
        if tally_value > threshold:
            res.alerts.append(FraudAlert(
                FraudAlertType.THRESHOLD_EXCEEDED,
                f"Tally {tally_value} exceeds threshold {threshold}", 1.0))
        return res
