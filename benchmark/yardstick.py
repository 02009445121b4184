"""The benchmark's own counts and peaks: the work a bootstrap needs and the
card's published rates, kept apart from the program so that no change to
the program moves them.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, without
sparsity), which assume the card's full power limit of 700 W; a run reports
the limit ``nvidia-smi`` reads beside every share of a peak.
"""
from __future__ import annotations

__all__ = ["PEAKS", "peak_for", "ladder_int8_macs_per_row",
           "int8_mac_time_s"]

# name fragment of torch.cuda.get_device_name() -> published peaks
PEAKS = {
    "H100": {
        "int8_ops_per_s": 1979e12,   # dense int8 tensor-core rate, 2 ops a MAC
        "hbm_bytes_per_s": 3.35e12,
        "power_w": 700.0,
        "source": "NVIDIA H100 SXM data sheet, dense rates at 700 W",
    },
}


def peak_for(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None when the
    table has none (a share of a peak is then not reported)."""
    for fragment, peak in PEAKS.items():
        if fragment in kind:
            return peak
    return None


def ladder_int8_macs_per_row(cfg: dict) -> int:
    """int8 multiply-accumulates of one bootstrap's CMux ladder on the int8
    path: n steps, each a (l (k+1) N)-deep contraction of the digits against
    the key row's Toeplitz expansion, (k+1) outputs of N coefficients, each
    32-bit key word as 4 base-256 digit planes."""
    n, N = cfg["n_lwe"], cfg["poly_degree"]
    k, lvl = cfg["glwe_dim"], cfg["pbs_level"]
    return n * (lvl * (k + 1) * N) * ((k + 1) * 4 * N)


def int8_mac_time_s(macs: float, peak: dict) -> float:
    """The least time the card could take for ``macs`` int8
    multiply-accumulates: at the published int8 rate, two ops a MAC."""
    return macs / (peak["int8_ops_per_s"] / 2)
