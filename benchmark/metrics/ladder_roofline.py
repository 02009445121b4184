"""ladder_roofline: the least time of a call's CMux ladder, its int8 MACs
(yardstick.ladder_int8_macs_per_row times the rows) at the card's published
dense int8 peak, as a share of the device's busy time per traced call (all
of its operations, whichever kernel implements the ladder).  Layer: the
kernels (csrc/*.cu)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, yardstick  # noqa: E402


def read(rec: dict):
    tr, peak, work = rec.get("trace"), rec.get("peak"), rec.get("work")
    if tr is None or peak is None or not work or not tr.calls:
        return None
    busy = harness.busy_ns(tr.device) / 1e9 / tr.calls
    if busy <= 0:
        return None
    bound = yardstick.int8_mac_time_s(
        work["ladder_int8_macs_per_row"] * work["rows"], peak)
    return 100.0 * bound / busy
