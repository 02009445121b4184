"""launches_per_call: CUDA kernel and memset events a call issues, counted
in the profiler's device events of the traced calls (not the program's own
counters).  Layer: the ops (ops/cmux.py, ops/ladder.py, ops/_build.py)."""


def read(rec: dict):
    tr = rec.get("trace")
    if tr is None or not tr.calls:
        return None
    n = sum(1 for ev in tr.device if ev[3] in ("kernel", "memset"))
    return n / tr.calls if n else None
