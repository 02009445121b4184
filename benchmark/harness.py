"""The machinery every cell shares: finding a cell's files by name, seeds,
the run-time guards, reading the profiler's trace, the per-layer readers
and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its configuration
is the JSON file the configuration's entry names; its traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module
``benchmark/drivers/<driver>.py`` that runs it; each per-layer metric is
read by ``benchmark/metrics/<metric>.py``.  A driver's ``run(ctx)`` returns
an ``Outcome``; ``run_cell`` turns it into the result line.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent

# top-level module names that no run may load, compared whole: the JAX
# package's name is a prefix of the program's
BANNED_MODULES = ("jax", "jaxlib", "flax", "node_fhe_accelerate_tpu")
PROGRAM = "node_fhe_accelerate_tpu_torch"


class RunError(Exception):
    """A run that cannot give a result: no card, a missing program, a
    banned module.  The harness prints the message and exits non-zero."""


# ---------------------------------------------------------------------------
# Files found by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a fresh module called ``name``."""
    if not path.is_file():
        raise RunError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload with the entries and files it names."""
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # BENCHMARK.json metric entries reported here
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def banned_modules(names) -> list[str]:
    """The loaded modules whose top-level name is banned, compared whole
    (``node_fhe_accelerate_tpu_torch`` is not ``node_fhe_accelerate_tpu``)."""
    return sorted(n for n in names if n.split(".")[0] in BANNED_MODULES)


def import_program(root: Path = ROOT):
    """Import the program from this checkout, never from elsewhere."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    try:
        import node_fhe_accelerate_tpu_torch as prog
    except ImportError as e:
        raise RunError(f"the program {PROGRAM} cannot be imported from "
                       f"{root}: {e}") from e
    where = Path(prog.__file__).resolve()
    if root.resolve() not in where.parents:
        raise RunError(f"{PROGRAM} was imported from {where}, outside the "
                       f"checkout {root}")
    return prog


def require_cards(count: int):
    """The card list for a cell of ``count`` chips; raises without them:
    a run never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device is available")
    if torch.cuda.device_count() < count:
        raise RunError(f"the cell needs {count} cards, "
                       f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernels build under ``build/kernels`` beside it)."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def power_limit_w() -> float | None:
    """The card's power limit as nvidia-smi reads it (None if it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def percentile(values, q: int) -> float:
    """The q-th percentile (1 <= q <= 99), statistics.quantiles' inclusive
    method."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """Raw events of one profiled stretch of calls, in ns on the
    profiler's clock: device events (name, start, end, kind) with kind
    "kernel", "memset" or "memcpy", and host events (name, start, end)."""
    calls: int
    wall_s: float
    device: list
    host: list
    window: tuple         # (start, end) of the harness's annotation


WINDOW_MARK = "bench.traced_window"
PROFILER_OWN = ("Activity Buffer Request",)


def _device_kind(e) -> str:
    """"kernel", "memset" or "memcpy"; "annotation" for the device-side
    copy of a host annotation, which is no device work."""
    kind = ""
    if hasattr(e, "activity_type"):
        kind = str(e.activity_type()).lower()
    name = e.name().lower()
    if "annotation" in kind or e.name() == WINDOW_MARK:
        return "annotation"
    if "memcpy" in kind or name.startswith("memcpy"):
        return "memcpy"
    if "memset" in kind or name.startswith("memset"):
        return "memset"
    return "kernel"


def read_trace(prof, calls: int, wall_s: float) -> Trace:
    from torch.autograd import DeviceType
    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            kind = _device_kind(e)
            if kind != "annotation":
                device.append((e.name(), start, end, kind))
        elif e.name() == WINDOW_MARK:
            window = (start, end)
        elif e.name() not in PROFILER_OWN:
            host.append((e.name(), start, end))
    device.sort(key=lambda x: x[1])
    if window is None and device:
        window = (device[0][1], device[-1][2])
    return Trace(calls=calls, wall_s=wall_s, device=device, host=host,
                 window=window or (0, 0))


def busy_intervals(device) -> list:
    """The union of the device events' intervals, in order."""
    out = []
    for _, s, e, _ in sorted(device, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(device) -> int:
    return sum(e - s for s, e in busy_intervals(device))


def top_device_ops(device, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    tot = {}
    for name, s, e, _ in device:
        tot[name] = tot.get(name, 0) + (e - s)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """[label, seconds] of the longest stretches of the traced window in
    which no device operation ran, each labelled by the innermost host
    event running at its middle and the device operation that ended it."""
    busy = busy_intervals(trace.device)
    w0, w1 = trace.window
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    nxt = {s: name for name, s, _, _ in trace.device}
    for i in range(0, len(edges) - 1, 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            gaps.append((e - s, s, e))
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:n]:
        mid = (s + e) // 2
        inner = [h for h in trace.host if h[1] <= mid <= h[2]]
        doing = min(inner, key=lambda h: h[2] - h[1])[0] if inner \
            else "host code outside any traced op"
        after = nxt.get(e, "end of window")
        out.append([f"{doing[:60]} -> {after[:60]}", length / 1e9])
    return out


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

@dataclass
class Check:
    """A number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back from one run.

    ``end_to_end`` holds the host-clock metrics by name; ``records`` what
    the per-layer readers read: ``spans`` (name -> seconds), ``calls`` (the
    window's calls as dicts of host times ``call``, ``ret``, ``sync``),
    ``trace`` (a ``Trace`` of the profiled calls, or None), ``work``
    (counts of the cell's work) and ``peak`` (the card's published peaks,
    or None)."""
    attempted: int
    failed: int
    checks: list
    end_to_end: dict = field(default_factory=dict)
    records: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the host clock's reading at the start of the process."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    params_override: dict = field(default_factory=dict)
    calls: int | None = None      # a fixed number of window calls


def read_per_layer(cell: Cell, records: dict) -> dict:
    """Each per-layer metric from its reader; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{m['name']}")
        value = reader.read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, ctx: Context, outcome: Outcome, kind: str,
                count: int) -> dict:
    """The result's JSON object; its last key holds the compared numbers
    beside their limits."""
    if ctx.trace:
        metrics = read_per_layer(cell, outcome.records)
    else:
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": kind, "count": count,
              "memory_peak_bytes": int(outcome.memory_peak_bytes),
              "power_limit_w": power_limit_w()
              if ctx.device.type == "cuda" else None}
    res = {"correct": all(c.ok for c in outcome.checks),
           "attempted": int(outcome.attempted),
           "failed": int(outcome.failed),
           "metrics": metrics, "device": device}
    tr = outcome.records.get("trace")
    if ctx.trace and tr is not None:
        device["busy_s"] = busy_ns(tr.device) / 1e9
        device["window_s"] = tr.wall_s
        res["breakdown"] = {"device_ops": top_device_ops(tr.device),
                            "idle_gaps": idle_gaps(tr)}
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return res


def run_cell(cell: Cell, ctx: Context) -> tuple[dict, Outcome]:
    """Run the cell's driver once; (result line, outcome)."""
    driver = load_module(BENCH_DIR / "drivers"
                         / f"{cell.traffic['driver']}.py",
                         f"bench_driver_{cell.traffic['driver']}")
    outcome = driver.run(ctx)
    if ctx.device.type == "cuda":
        import torch
        kind, count = torch.cuda.get_device_name(ctx.device), cell.chips
    else:
        kind, count = "cpu", 1
    return result_line(cell, ctx, outcome, kind, count), outcome
