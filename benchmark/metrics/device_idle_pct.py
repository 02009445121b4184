"""device_idle_pct: the share of a call in which the device ran nothing:
1 - (device busy time a traced call) / (mean wall of the window's calls),
busy the union of the profiler's device events.  The wall is that of the
untraced calls: the profiler's host activity lengthens a traced call's wall
by a few ms, and idles the device for it.  Layer: the device."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402


def read(rec: dict):
    tr, calls = rec.get("trace"), rec.get("calls") or []
    if tr is None or not tr.calls or not calls:
        return None
    busy = harness.busy_ns(tr.device) / 1e9 / tr.calls
    if busy <= 0:
        return None
    wall = sum(c["sync"] - c["call"] for c in calls) / len(calls)
    return 100.0 * (1.0 - busy / wall)
