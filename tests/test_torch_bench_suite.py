"""The port's benchmark suite and profiling utilities
(node_fhe_accelerate_tpu_torch/utils/bench_suite.py, profiling.py) on the
CPU: the result schema and statistics against the JAX package's, and the
tiny modmul, ntt and poly_mul suites with their oracle checks, written to
a temporary directory.  Tolerance: exact equality of fields, headers and
statistics (the same float operations on the same samples)."""
import csv
import dataclasses
import json
import os

import numpy as np
import torch

from node_fhe_accelerate_tpu.utils import bench_suite as jbs
from node_fhe_accelerate_tpu_torch.utils import bench_suite as tbs
from node_fhe_accelerate_tpu_torch.utils import profiling

torch.set_num_threads(2)


def fake_result(mod):
    return mod.BenchmarkResult(
        suite="ntt", name="ntt_forward_1024", backend="x", size=1024,
        batch=8, mean_us=12.5, stddev_us=0.25, throughput_ops_s=8.0,
        speedup_vs_baseline=0.5, correct=True)


def test_result_fields_and_csv_header_match_jax():
    assert [f.name for f in dataclasses.fields(tbs.BenchmarkResult)] == \
        [f.name for f in dataclasses.fields(jbs.BenchmarkResult)]
    assert tbs._BASELINES == jbs._BASELINES
    runners = {}
    for mod in (jbs, tbs):
        r = mod.ComprehensiveBenchmarkRunner.__new__(
            mod.ComprehensiveBenchmarkRunner)
        r.results = [fake_result(mod)]
        runners[mod] = r
    assert runners[tbs].export_csv() == runners[jbs].export_csv()
    assert runners[tbs].export_json() == runners[jbs].export_json()


def test_statistical_analyzer_matches_jax():
    rng = np.random.default_rng(4)
    a = [float(x) for x in rng.uniform(0.1, 0.2, 7)]
    b = [float(x) for x in rng.uniform(0.15, 0.3, 5)]
    for xs in (a, b, [0.5]):
        assert tbs.StatisticalAnalyzer.analyze(xs) == \
            jbs.StatisticalAnalyzer.analyze(xs)
    for x, y in ((a, b), (b, a), (a, a)):
        assert tbs.StatisticalAnalyzer.significantly_faster(x, y) == \
            jbs.StatisticalAnalyzer.significantly_faster(x, y)


def test_tiny_suites_are_correct(tmp_path):
    r = tbs.ComprehensiveBenchmarkRunner(
        warmup=1, iters=2, device="cpu",
        keycache_dir=str(tmp_path / "keycache"))
    r.benchmark_memory()
    r.benchmark_modmul(sizes=(1024,))
    r.benchmark_ntt(degrees=(1024,), batch=4)
    r.benchmark_poly_mul(degrees=(1024,), batch=2)
    names = [x.name for x in r.results]
    assert names == ["dispatch_floor", "h2d_16mb", "d2h_16mb",
                     "modmul_batch_1024", "ntt_forward_1024",
                     "poly_mul_1024"]
    assert all(x.correct for x in r.results)
    assert all(x.backend.startswith("cpu-") for x in r.results)
    assert r.results[3].mean_minus_floor_us >= 0
    r.export_all(str(tmp_path))
    with open(tmp_path / "modmul.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows[0]["name"] == "modmul_batch_1024" and \
        rows[0]["correct"] == "True"
    with open(tmp_path / "benchmark_results.json") as f:
        assert len(json.load(f)) == 6
    assert (tmp_path / "benchmark_report.html").read_text().count(
        "<tr class='ok'>") == 6


def test_profiling_on_the_cpu(tmp_path):
    with profiling.Timer("x") as t:
        torch.ones(100).sum()
    assert t.elapsed_s > 0
    assert profiling.Timer.time_blocked(lambda: torch.ones(10) * 2, 3) > 0
    with profiling.trace(str(tmp_path / "trace")) as tf:
        (torch.arange(1000) * 3).sum()
    assert tf.path == os.path.join(str(tmp_path / "trace"), "trace.json")
    with open(tf.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert profiling.device_memory_stats() == []
    assert profiling.live_array_bytes() == 0
