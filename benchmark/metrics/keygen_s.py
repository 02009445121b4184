"""keygen_s: host clock around the bootstrap and key-switch key generation
on the card and whatever key preparation the entry needs, synchronized.
Layer: the engine (core/bootstrap.py)."""


def read(rec: dict):
    return rec.get("spans", {}).get("keygen_s")
