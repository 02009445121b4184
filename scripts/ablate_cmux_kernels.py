#!/usr/bin/env python3
"""Where the time of the wgmma CMux kernels goes, by ablation, on one GPU.

    python3 scripts/ablate_cmux_kernels.py [--steps 20] [--seed 3]

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc. No profiler that reads inside a kernel runs there, so this builds,
beside the real kernels, copies of ``csrc/cmux_step.cu`` (K1),
``csrc/ladder_tiles.cu`` (K4) and ``csrc/ladder_steps.cu`` (K5) with one
part of the shared body (``csrc/cmux_common.cuh``) switched off or changed,
and times each at TFHE_BOOT_128_K4, batch 4096, by CUDA events, in turns.
Parts switched off: the digit phase of the consumer warps or of all warps,
or its loads of the rotated accumulator; the CMux epilogue, or only its
loads of the accumulator, or only its stores; the wgmma instructions; K1's
and K4's waits at the grid barriers; K5's TMA loads of the B tiles; the on-chip
Toeplitz expansion of K1 and K4; K4's TMA loads of the A tiles (what a
multicast of A across a cluster could save at most), its table reloads at
each step and output component, or the 16-byte copies of the tables'
wraps. Changed: K4 with other register splits. The ablated kernels compute
wrong results; only their times mean anything: base minus ablated is what
the part costs where it is not hidden behind the others. The copies go to
build/ablation/ (ignored by git). Prints the card's name and power limit,
then one JSON object per kernel: milliseconds per step, two rounds each.
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
# false at run time, not at compile time: with `if (0)` ptxas drops the
# wgmma whose accumulators nothing reads any more
EPI_OFF = "if (h.batch < 0) "
EPI_LOAD = "epilogue_load(prev, src, rows);"
EPI_STORE = "*reinterpret_cast<uint2*>(dst + r.o[half] + 8 * q) ="
DIG = "      digit_rows<8>(src, h.rots"
DIG_PRODUCER = "      digit_rows<4>(s ? h.out : h.acc,"
ROT_LO = "const uint4 lo = *reinterpret_cast<const uint4*>(a + (p0 & ~3u));"
ROT_HI = """const uint4 hi =
            *reinterpret_cast<const uint4*>(a + ((p0 + 4u) & (n - 4u)));"""
# every wait at a grid barrier returns at once (the arrivals stay).  Not for
# K5: its producer threads other than the first do not wait on the ring, so
# without the waits they run steps ahead and their arrivals at the block's
# named barrier fall out of step with the consumers' (the kernel hangs).
NO_WAIT = {"if (v >= target) break;": "break;"}
WRAP_TX = "static_cast<uint32_t>(ntab) * hs);"
WRAP_HEAD = "bulk_load(dst, src + two_n - kWrap, kWrap, tab_bar);"
WRAP_TAIL = "bulk_load(dst + kWrap + two_n, src, kWrap, tab_bar);"
EXP = "expand_b_tile<P>(st + kATileBytes"
A_TX = "mbar_expect_tx_only(&full[stage], kATileBytes);"
# setmaxnreg of the consumers and of the producer when it expands B (the sum
# stays 168 x 384)
REG_C = '"n"(kExpand ? 208'
REG_P = '"n"(kExpand ? 88'
A_LOAD = "tma_load(st, map_a, &full[stage], kc * kChunk, rt * kTileM);"
RELOAD = """if (kExpand && (jp != cur_jp || (kStepKeys && s != cur_s)))
          load_tables(s, jp);"""
PREFETCH = """if (kStepKeys && s + 1 < h.n_steps && t0 < t1)
        load_tables(s + 1, first_jp);"""
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
    "K5 without the epilogue": ("ladder_steps.cu", {EPI: EPI_OFF + EPI}),
    "K5 without wgmma": ("ladder_steps.cu", {MMA: ";"}),
    "K1": ("cmux_step.cu", {}),
    "K1 without the consumers' digit phase": (
        "cmux_step.cu", {DIG: "if (0) " + DIG}),
    "K1 without the digit phase": (
        "cmux_step.cu", {DIG: "if (0) " + DIG,
                         DIG_PRODUCER: "if (0) " + DIG_PRODUCER}),
    "K1 without the epilogue": ("cmux_step.cu", {EPI: EPI_OFF + EPI}),
    "K1 without wgmma": ("cmux_step.cu", {MMA: ";"}),
    "K1 without the grid barrier's wait": ("cmux_step.cu", NO_WAIT),
    "K1 without the Toeplitz expansion": (
        "cmux_step.cu", {EXP: "if (0) " + EXP}),
    "K4": ("ladder_tiles.cu", {}),
    "K4 without the digit phase after step 0": (
        "ladder_tiles.cu", {DIG: "if (s == 0) " + DIG,
                            DIG_PRODUCER: "if (s == 0) " + DIG_PRODUCER}),
    "K4 without the digit phase's rotated loads": (
        "ladder_tiles.cu", {ROT_LO: "const uint4 lo = cur;",
                            ROT_HI: "const uint4 hi = cur;"}),
    "K4 without the epilogue": ("ladder_tiles.cu", {EPI: EPI_OFF + EPI}),
    "K4 without the epilogue's loads of acc": (
        "ladder_tiles.cu", {EPI_LOAD: "for (auto& v : prev) "
                                      "v[0] = v[1] = v[2] = v[3] = v[4] = "
                                      "v[5] = v[6] = v[7] = make_uint2(0, 0);"}),
    "K4 without the epilogue's stores": (
        "ladder_tiles.cu", {EPI_STORE: "if (r.o[half] == ~size_t(0)) "
                                       + EPI_STORE}),
    "K4 without the A loads": (
        "ladder_tiles.cu", {A_TX: ";", A_LOAD: ";"}),
    "K4 with 216/72 registers": (
        "ladder_tiles.cu", {REG_C: REG_C.replace("208", "216"),
                            REG_P: REG_P.replace("88", "72")}),
    "K4 with 200/104 registers": (
        "ladder_tiles.cu", {REG_C: REG_C.replace("208", "200"),
                            REG_P: REG_P.replace("88", "104")}),
    "K4 without wgmma": ("ladder_tiles.cu", {MMA: ";"}),
    "K4 without the grid barriers' waits": ("ladder_tiles.cu", NO_WAIT),
    "K4 without the Toeplitz expansion": (
        "ladder_tiles.cu", {EXP: "if (0) " + EXP}),
    "K4 with one load of the tables per launch": (
        "ladder_tiles.cu", {RELOAD: "if (kExpand && cur_jp < 0) "
                                    "load_tables(s, jp);",
                            PREFETCH: "if (0) load_tables(s + 1, "
                                      "first_jp);"}),
    "K4 without the tables' 16-byte wrap copies": (
        "ladder_tiles.cu", {WRAP_TX: "static_cast<uint32_t>(ntab) * two_n);",
                            WRAP_HEAD: "", WRAP_TAIL: ""}),
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
        lib = {"ladder_steps.cu": ladder.STEPS_LIB,
               "ladder_tiles.cu": ladder.TILES_LIB}.get(source,
                                                        cmux.STEP_LIB)
        libs[name] = KernelLibrary(path, lib.functions)
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
        if name.startswith("K4"):
            launch(lib.nfa_ladder_tiles, name, dev, acc.data_ptr(),
                   rots.data_ptr(), g.data_ptr(), out.data_ptr(),
                   dig.data_ptr(), counter.data_ptr(), batch, kp1, lvl,
                   planes, n, p.pbs_base_log, args.steps)
        elif name.startswith("K5"):
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
        ladder_ = name.startswith(("K4", "K5"))
        iters = 3 if ladder_ else 20
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
        return ms / args.steps if ladder_ else ms

    times = {name: [] for name in libs}
    for _ in range(2):
        for name in libs:
            # on standard error as it goes: a kernel that hangs shows here
            print(f"timing {name}", file=sys.stderr, flush=True)
            times[name].append(ms_per_step(name))
    for name, ms in times.items():
        print(json.dumps({"kernel": name, "ms_per_step": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
