"""The yardstick's counts and peaks."""
import pytest

from benchmark import harness, yardstick


def test_ladder_macs_of_the_configurations():
    k4 = harness.load_cell("k4_pbs_b4096").config
    boot = harness.load_cell("boot128_pbs_b1024").config
    assert yardstick.ladder_int8_macs_per_row(k4) == 8_257_536_000
    assert yardstick.ladder_int8_macs_per_row(boot) == 31_708_938_240


def test_k4_bound_at_the_h100_peak():
    k4 = harness.load_cell("k4_pbs_b4096").config
    peak = yardstick.peak_for("NVIDIA H100 80GB HBM3")
    bound = yardstick.int8_mac_time_s(
        yardstick.ladder_int8_macs_per_row(k4) * 4096, peak)
    assert bound == pytest.approx(0.03418, abs=5e-6)


def test_published_peaks():
    peak = yardstick.peak_for("NVIDIA H100 80GB HBM3")
    assert peak["int8_ops_per_s"] == 1979e12
    assert peak["hbm_bytes_per_s"] == 3.35e12
    assert peak["power_w"] == 700.0
    assert yardstick.peak_for("cpu") is None
