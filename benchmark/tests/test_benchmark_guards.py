"""The run-time guards and the layout a later PR extends by adding files."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_banned_modules_compare_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "node_fhe_accelerate_tpu", "node_fhe_accelerate_tpu.core.ntt",
              "node_fhe_accelerate_tpu_torch",
              "node_fhe_accelerate_tpu_torch.api.engine", "jaxtyping",
              "numpy", "flaxen"]
    assert harness.banned_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "node_fhe_accelerate_tpu", "node_fhe_accelerate_tpu.core.ntt"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not harness.banned_modules(names), (path, names)


def test_the_reference_imports_nothing_of_the_program():
    src = (ROOT / "benchmark" / "reference" / "tfhe_pbs.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module]
            for m in mods:
                assert m.split(".")[0] not in (harness.PROGRAM,) \
                    + harness.BANNED_MODULES


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "k4_pbs_b4096",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_bare_benchmark_directory_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "cannot be imported" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_every_entry_finds_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in bench["paths"]:
        assert (ROOT / path).is_dir()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (ROOT / "benchmark" / "drivers"
                / f"{cell.traffic['driver']}.py").is_file()
        assert cell.per_layer and len(cell.end_to_end) >= 2
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
