"""host_enqueue_ms: the host's time from a call of the entry to its return,
before the synchronize, averaged over the window's calls outside the
profiled ones (host clock).  Layer: the public API (FHEEngine)."""


def read(rec: dict):
    calls = rec.get("calls") or []
    if not calls:
        return None
    return 1e3 * sum(c["ret"] - c["call"] for c in calls) / len(calls)
