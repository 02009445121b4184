"""Tests of the benchmark itself: the plain reference against the program
on the CPU, the yardstick's counts, the run-time guards, and the check's
control and planted faults.  Run from the repository root:

    python -m pytest benchmark/tests -q -p no:randomly -n 0

Tests marked ``cuda`` need a card and skip without one (decided in a
fixture, never at import)."""
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402

# a parameter set a CPU test run can hold: the cells' gadgets and key
# switch at n = 8 and N = 256
SMALL = {
    "k4": dict(n_lwe=8, poly_degree=256, glwe_dim=4, pbs_base_log=8,
               pbs_level=2),
    "boot128": dict(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
                    pbs_level=3),
}
CELL_OF = {"k4": "k4_pbs_b4096", "boot128": "boot128_pbs_b1024"}


def small_cell(kind: str, rows: int = 8) -> harness.Cell:
    """The cell of ``kind`` with its configuration cut to SMALL and
    ``rows`` rows a call."""
    cell = harness.load_cell(CELL_OF[kind])
    cell.config.update(SMALL[kind])
    cell.traffic.update(rows=rows, warmup_calls=1, traced_calls=2)
    return cell


def run_small(cell: harness.Cell, seed: int = 2**31 + 11, calls: int = 4,
              trace: bool = False, device="cpu", **override):
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=trace,
                          device=torch.device(device),
                          t_start=time.perf_counter(),
                          params_override=override, calls=calls)
    return harness.run_cell(cell, ctx)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
