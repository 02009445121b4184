#!/usr/bin/env python3
"""Where the time of the wgmma CMux kernels goes, by ablation, on one GPU.

    python3 scripts/ablate_cmux_kernels.py [--steps 20] [--seed 3]

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc.  No profiler that reads inside a kernel runs there, so this builds,
beside the real kernels, copies of ``csrc/cmux_step.cu`` (K1) and
``csrc/ladder_steps.cu`` (K5) with one part of the shared body
(``csrc/cmux_common.cuh``) switched off -- the digit phase of the consumer
warps or of all warps, the CMux epilogue, the wgmma instructions, K5's TMA
loads of the B tiles, or K1's on-chip Toeplitz expansion -- and times each
at TFHE_BOOT_128_K4, batch 4096, by CUDA events, in turns.  The ablated kernels compute wrong results; only their
times mean anything: base minus ablated is what the part costs where it is
not hidden behind the others.  The copies go to build/ablation/ (ignored
by git).  Prints the card's name and power limit, then one JSON object
per kernel: milliseconds per step, two rounds each.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "node_fhe_accelerate_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ablation")

MMA = "WgmmaS8<64 * P>::mma(d, da + 2 * kk, db + 2 * kk, kc | kk);"
EPI = "epilogue_store<P>(d, prev"
DIG = "      digit_rows<8>(src, h.rots"
DIG_PRODUCER = "      digit_rows<4>(s ? h.out : h.acc,"
EXP = "expand_b_tile<P>(st + kATileBytes"
B_LOAD = """mbar_expect_tx(&full[stage], sb);
              tma_load(st + kATileBytes, map_b, &full[stage], kc * kChunk,
                       s * kp1 * P * n + ct * 64 * P);"""
# name: (source, {text: replacement}); each text occurs once in the source
# and its copy of the shared header together
ABLATIONS = {
    "K5": ("ladder_steps.cu", {}),
    "K5 without the consumers' digit phase after step 0": (
        "ladder_steps.cu", {DIG: "if (s == 0) " + DIG}),
    "K5 without the digit phase after step 0": (
        "ladder_steps.cu", {DIG: "if (s == 0) " + DIG,
                            DIG_PRODUCER: "if (s == 0) " + DIG_PRODUCER}),
    "K5 without the B loads": (
        "ladder_steps.cu", {B_LOAD: "mbar_expect_tx(&full[stage], "
                                    "kATileBytes);"}),
    "K5 without the epilogue": ("ladder_steps.cu", {EPI: "if (0) " + EPI}),
    "K5 without wgmma": ("ladder_steps.cu", {MMA: ";"}),
    "K1": ("cmux_step.cu", {}),
    "K1 without the consumers' digit phase": (
        "cmux_step.cu", {DIG: "if (0) " + DIG}),
    "K1 without the digit phase": (
        "cmux_step.cu", {DIG: "if (0) " + DIG,
                         DIG_PRODUCER: "if (0) " + DIG_PRODUCER}),
    "K1 without the epilogue": ("cmux_step.cu", {EPI: "if (0) " + EPI}),
    "K1 without wgmma": ("cmux_step.cu", {MMA: ";"}),
    "K1 without the Toeplitz expansion": (
        "cmux_step.cu", {EXP: "if (0) " + EXP}),
}


def ablated_sources(name: str) -> tuple[str, str]:
    """The shared header and the kernel source of ablation ``name``, with
    its edits made.  Raises if a text to replace does not occur exactly
    once, so an edit of the kernels that moves one shows at once."""
    source, edits = ABLATIONS[name]
    h = open(os.path.join(CSRC, "cmux_common.cuh")).read()
    s = open(os.path.join(CSRC, source)).read()
    for old, new in edits.items():
        if h.count(old) + s.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} does not occur exactly "
                               "once")
        h, s = h.replace(old, new), s.replace(old, new)
    return h, s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_cmux_kernels: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from node_fhe_accelerate_tpu_torch.core.bootstrap import (
        TFHE_BOOT_128_K4, TfheEngine)
    from node_fhe_accelerate_tpu_torch.ops import cmux, ladder
    from node_fhe_accelerate_tpu_torch.ops._build import (KernelLibrary,
                                                          build_all, launch)

    libs = {}
    for i, (name, (source, _)) in enumerate(ABLATIONS.items()):
        d = os.path.join(OUT, f"v{i}")
        os.makedirs(d, exist_ok=True)
        h, s = ablated_sources(name)
        with open(os.path.join(d, "cmux_common.cuh"), "w") as f:
            f.write(h)
        path = os.path.join(d, f"ablation_{i}.cu")
        with open(path, "w") as f:
            f.write(s)
        lib = ladder.STEPS_LIB if source == "ladder_steps.cu" \
            else cmux.STEP_LIB
        libs[name] = KernelLibrary(path, dict(lib.functions))
    build_all(list(libs.values()))

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    p = TFHE_BOOT_128_K4()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    eng = TfheEngine(dataclasses.replace(p, n_lwe=args.steps),
                     ext_backend="mxu", device=dev)
    g = eng.generate_bootstrap_key(gen, eng.lwe_keygen(gen),
                                   eng.glwe_keygen(gen)).ggsw_i8
    batch, kp1, n = 4096, p.glwe_dim + 1, p.poly_degree
    lvl, planes = p.pbs_level, g.shape[-2]
    acc = torch.randint(-(1 << 31), 1 << 31, (batch, kp1, n), generator=gen,
                        dtype=torch.int64, device=dev).to(torch.int32)
    rots = torch.randint(-4 * n, 4 * n, (args.steps, batch), generator=gen,
                         dtype=torch.int32, device=dev)
    kslabs = cmux.build_all_step_kslabs(g)
    out = torch.empty_like(acc)
    dig = cmux.digit_scratch(batch, lvl * kp1 * n, dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(name):
        counter.zero_()
        lib = libs[name].load()
        if name.startswith("K5"):
            launch(lib.nfa_ladder_steps, name, dev, acc.data_ptr(),
                   rots.data_ptr(), kslabs.data_ptr(), out.data_ptr(),
                   dig.data_ptr(), counter.data_ptr(), batch, kp1, lvl,
                   planes, n, p.pbs_base_log, 0, args.steps)
        else:
            launch(lib.nfa_cmux_step, name, dev, acc.data_ptr(),
                   rots[0].data_ptr(), g[0].data_ptr(), out.data_ptr(),
                   dig.data_ptr(), counter.data_ptr(), batch, kp1, lvl,
                   planes, n, p.pbs_base_log)

    def ms_per_step(name):
        iters = 3 if name.startswith("K5") else 20
        run(name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run(name)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        return ms / args.steps if name.startswith("K5") else ms

    times = {name: [] for name in libs}
    for _ in range(2):
        for name in libs:
            times[name].append(ms_per_step(name))
    for name, ms in times.items():
        print(json.dumps({"kernel": name, "ms_per_step": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
