"""Closed-loop chained programmable bootstraps through the program's public
entry, ``FHEEngine.programmable_bootstrap`` (ext_backend "auto").

One client: each call bootstraps ``rows`` LWE ciphertexts with a LUT drawn
from the seed among the traffic file's tables, ends in a synchronize, and
its output is the next call's input.  The messages start uniform in the
traffic file's set.

Set-up (``setup_s``): the program's import and kernel load, the engine, the
keys from the seed (``keygen_s``), the first call with the dispatcher's race
(``race_s``), ``warmup_calls`` more calls.  The window: calls for
``seconds``, each timed from the call to its synchronize; with ``trace``
``traced_calls`` more under the profiler.  Then the check, once the
memory peak is read and the program's state is freed: every row of every
call decoded with the reference's key against the plaintext chain
(``rows_wrong``), and ``exact_calls`` calls (the first, the last and others
drawn from the seed) recomputed by the plain reference from their inputs
and compared word for word (``words_differ``).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark import yardstick  # noqa: E402
from benchmark.reference import tfhe_pbs as ref  # noqa: E402

LUT_DRAWS = 1 << 16


def _log(msg: str) -> None:
    print(f"pbs_chain: {msg}", file=sys.stderr, flush=True)


class _Record:
    """The window's outputs: copied into one buffer sized in set-up, so the
    window allocates nothing for them; past its end, held as they are."""

    def __init__(self, cap: int, rows: int, n: int, device):
        self.a = torch.empty((cap, rows, n), dtype=torch.int32, device=device)
        self.b = torch.empty((cap, rows), dtype=torch.int32, device=device)
        self.extra = []
        self.count = 0

    def add(self, y) -> None:
        if self.count < self.a.shape[0]:
            self.a[self.count].copy_(y.a)
            self.b[self.count].copy_(y.b)
        else:
            self.extra.append((y.a, y.b))
        self.count += 1

    def nbytes(self) -> int:
        return (self.a.numel() + self.b.numel()) * 4 + sum(
            (a.numel() + b.numel()) * 4 for a, b in self.extra)

    def get(self, i: int):
        if i < self.a.shape[0]:
            return self.a[i], self.b[i]
        return self.extra[i - self.a.shape[0]]


def run(ctx) -> harness.Outcome:
    from node_fhe_accelerate_tpu_torch.api.engine import FHEEngine
    from node_fhe_accelerate_tpu_torch.core.bootstrap import (LweCiphertext,
                                                              TfheParams)
    from node_fhe_accelerate_tpu_torch.core.params import \
        create_parameter_set

    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    p = ref.Params.from_config(cfg)
    rows = int(traffic["rows"])
    names = sorted(traffic["luts"])
    tables = [tuple(int(v) for v in traffic["luts"][k]) for k in names]
    funcs = [lambda v, tab=tab: tab[v] for tab in tables]
    key_seed = harness.derive_seed(ctx.seed, "keys")
    lut_draws = np.random.default_rng(
        harness.derive_seed(ctx.seed, "luts")).integers(
        0, len(tables), LUT_DRAWS)

    # -- set-up: the program's engine and keys -----------------------------
    fields = {f: cfg[f] for f in ("n_lwe", "poly_degree", "glwe_dim",
                                  "pbs_base_log", "pbs_level", "ks_base_log",
                                  "ks_level", "lwe_noise_std",
                                  "glwe_noise_std", "plaintext_modulus")}
    fields.update(ctx.params_override)
    eng = FHEEngine(create_parameter_set(cfg["deployment"]["ring_preset"]),
                    tfhe_params=TfheParams(**fields), rng_seed=key_seed,
                    device=dev)
    t0 = time.perf_counter()
    _, _, bsk = eng.generate_bootstrap_key()
    sync()
    keygen_s = time.perf_counter() - t0

    # the inputs: the benchmark's own messages and encryption
    in_gen = torch.Generator(device=dev).manual_seed(
        harness.derive_seed(ctx.seed, "inputs"))
    msgs = torch.tensor(traffic["messages"], device=dev)[torch.randint(
        0, len(traffic["messages"]), (rows,), generator=in_gen, device=dev)]
    key_gen = torch.Generator(device=dev).manual_seed(key_seed)
    a0, b0 = ref.lwe_encrypt(in_gen, msgs, ref.lwe_secret(key_gen, p), p)
    lwe0 = LweCiphertext(a=ref.to_i32(a0), b=ref.to_i32(b0))
    sync()

    t0 = time.perf_counter()
    eng.programmable_bootstrap(lwe0, bsk, funcs[0])
    sync()
    race_s = time.perf_counter() - t0
    disp = eng.tfhe.dispatcher
    if disp is not None:
        for sel in disp.selection_table().values():
            _log(f"race: winner {sel['winner']}, seconds a call "
                 + ", ".join(f"{k} {v:.4f}" for k, v in sel["timings"].items()))
    else:
        _log(f"no race: backend {eng.tfhe.backend!r}")
    warm = []
    for w in range(int(traffic["warmup_calls"])):
        t0 = time.perf_counter()
        eng.programmable_bootstrap(lwe0, bsk, funcs[w % len(funcs)])
        sync()
        warm.append(time.perf_counter() - t0)
    fastest = min(warm) if warm else race_s
    traced = int(traffic["traced_calls"]) if ctx.trace else 0
    if ctx.calls is None:
        cap = int(ctx.seconds / (0.7 * fastest)) + traced + 8
    else:
        cap = ctx.calls + traced
    rec = _Record(cap, rows, p.n_lwe, dev)
    peak = yardstick.peak_for(torch.cuda.get_device_name(dev)) if cuda \
        else None
    sync()

    # -- the window --------------------------------------------------------
    calls = []
    x = lwe0
    t_begin = time.perf_counter()
    setup_s = t_begin - ctx.t_start
    while True:
        i = len(calls)
        t_call = time.perf_counter()
        y = eng.programmable_bootstrap(x, bsk, funcs[lut_draws[i]])
        t_ret = time.perf_counter()
        sync()
        t_sync = time.perf_counter()
        calls.append({"call": t_call, "ret": t_ret, "sync": t_sync})
        rec.add(y)
        x = y
        if ctx.calls is not None:
            if len(calls) >= ctx.calls:
                break
        elif t_sync - t_begin >= ctx.seconds:
            break
    t_end = calls[-1]["sync"]
    window_s = t_end - t_begin
    n_window = len(calls)

    trace = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        held = []
        with profile(activities=acts) as prof:
            with record_function(harness.WINDOW_MARK):
                t0 = time.perf_counter()
                for _ in range(traced):
                    i = n_window + len(held)
                    y = eng.programmable_bootstrap(x, bsk,
                                                   funcs[lut_draws[i]])
                    sync()
                    held.append(y)
                    x = y
                wall = time.perf_counter() - t0
        for y in held:
            rec.add(y)
        trace = harness.read_trace(prof, traced, wall)

    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del eng, bsk, x, y
    if cuda:
        torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    t0 = time.perf_counter()
    keys = ref.make_keys(torch.Generator(device=dev).manual_seed(key_seed), p)
    total = rec.count
    expect = msgs.to(torch.int64)
    rows_wrong = 0
    for i in range(total):
        expect = torch.tensor(tables[lut_draws[i]], device=dev)[expect]
        a, b = rec.get(i)
        got = ref.decode(ref.from_i32(a), ref.from_i32(b), keys.lwe_sk, p)
        rows_wrong += int((got != expect).sum())
    exact = _exact_calls(total, int(traffic["exact_calls"]), ctx.seed)
    words_differ = 0
    for i in exact:
        if i == 0:
            a_in, b_in = a0, b0
        else:
            a_in, b_in = (ref.from_i32(v) for v in rec.get(i - 1))
        a_ref, b_ref = ref.bootstrap(keys, p, a_in, b_in,
                                     tables[lut_draws[i]])
        a, b = (ref.from_i32(v) for v in rec.get(i))
        words_differ += int((a != a_ref).sum()) + int((b != b_ref).sum())
    sync()
    _log(f"check: {total} calls decoded, calls {exact} recomputed, "
         f"{time.perf_counter() - t0:.2f} s")

    times = [c["sync"] - c["call"] for c in calls]
    e2e = {"pbs_per_s": rows * n_window / window_s,
           "pbs_call_p95_ms": 1e3 * harness.percentile(times, 95),
           "setup_s": setup_s}
    slow = sorted(range(n_window), key=lambda j: -times[j])[:5]
    _log(f"window: {n_window} calls of {rows} rows in {window_s:.3f} s; "
         f"set-up {setup_s:.2f} s (keys {keygen_s:.2f} s, race and first "
         f"call {race_s:.2f} s, warm-up calls "
         + ", ".join(f"{1e3 * w:.2f}" for w in warm) + " ms); calls ms: "
         f"min {1e3 * min(times):.2f}, median {1e3 * np.median(times):.2f}, "
         f"max {1e3 * max(times):.2f}; slowest "
         + ", ".join(f"#{j} {1e3 * times[j]:.2f}" for j in slow)
         + f"; outputs held for the check {rec.nbytes() / 2**30:.2f} GiB")
    records = {"spans": {"keygen_s": keygen_s, "race_s": race_s,
                         "setup_s": setup_s},
               "calls": calls, "trace": trace, "peak": peak,
               "work": {"rows": rows, "ladder_int8_macs_per_row":
                        yardstick.ladder_int8_macs_per_row(cfg)}}
    return harness.Outcome(
        attempted=rows * total, failed=rows_wrong,
        checks=[harness.Check("rows_wrong", rows_wrong, 0),
                harness.Check("words_differ", words_differ, 0)],
        end_to_end=e2e, records=records, memory_peak_bytes=memory_peak)


def _exact_calls(total: int, count: int, seed: int) -> list[int]:
    """The calls recomputed word for word: the first, the last and the
    rest drawn from the seed among those between."""
    picks = {0, total - 1}
    inner = list(range(1, total - 1))
    if inner and count > 2:
        rng = np.random.default_rng(harness.derive_seed(seed, "exact"))
        picks.update(int(v) for v in rng.choice(
            inner, size=min(count - 2, len(inner)), replace=False))
    return sorted(picks)
