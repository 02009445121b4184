"""race_s: host clock around the cell's first call, synchronized: the
dispatcher's race of its candidates and the winner's call.  Layer: the
dispatcher (utils/dispatch.py)."""


def read(rec: dict):
    return rec.get("spans", {}).get("race_s")
