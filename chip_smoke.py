#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Run from the repository root.  It imports neither JAX nor the JAX package.
Phases (any failure ends the run with a non-zero exit and no result line):

1. the card's name and power limit, torch/CUDA versions, and the build of
   every kernel source under csrc/ (one nvcc each for sm_90a, side by side,
   into build/), with the compiler's register and spill lines;
2. every kernel vs its plain PyTorch version, bit for bit, at batch 4096:
   one CMux step through cmux_step and through cmux_step_slabs (v3, v2) on
   a row of the committed TFHE_BOOT_128_K4 key (.keycache) and on a
   TFHE_BOOT_128_L2-shaped row (k=1, N=1024); the whole ladder through
   ladder_tiles and ladder_steps over all 630 rows of the committed key and
   over a short ladder at the L2 shape; ladder_steps also on a short
   truncated-key ladder (drop=1);
3. a full 630-step ``bootstrap_with_test_poly`` on the committed K4 key at
   batch 256, once through the per-step kernel backend and once through
   "mxu" -- bit-equal;
4. the main paths at full width: port keygen at TFHE_BOOT_128_K4 from a
   seeded torch.Generator, ``prepare_bsk`` to slabs, 4096 messages
   encrypted; then, each with the launch counts set to 0 just before and
   read just after: one bootstrap through the per-step backend (630
   launches), the direct slab-step entries once each, 3 chained bootstraps
   through "mxu_fused" and 3 through "pallas_fused" (one ladder launch per
   bootstrap, each ending in a synchronize, decode checked, bit-equal to
   the per-step backend), and a ``detect_duplicate`` with a known answer;
5. timings with CUDA events for each kernel (kernel, plain version, its
   bound, and torch._int_mm on the same int8 contraction as a yardstick),
   the key switch, and bootstraps/s per backend.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K4_BLOB = os.path.join(ROOT, ".keycache",
                       "7f5658596c1857e89c056b7e0b17cabf.fheb")
BATCH = 4096
CHAINED = 3

# Published dense peaks (NVIDIA data sheets): int8 tensor-core ops/s and
# device-memory bytes/s, at the full power limit.
PEAKS = {"H100 SXM": (1979e12, 3.35e12), "H100 PCIe": (1513e12, 2.0e12),
         "H100 NVL": (1671e12, 3.9e12), "H200": (1979e12, 4.8e12)}


def variant(name: str) -> str:
    for tag in ("H200", "NVL", "PCIe"):
        if tag in name:
            return "H200" if tag == "H200" else f"H100 {tag}"
    return "H100 SXM"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(macs, nbytes, peak_ops, peak_bytes):
    """Least time in ms for `macs` int8 MACs (2 ops each) at the int8 peak
    and `nbytes` at the memory rate; the larger wins."""
    t_ops, t_bytes = 2 * macs / peak_ops, nbytes / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def step_work(b, kp1, n, lvl, planes):
    """(int8 MACs, bytes) of one CMux step apart from its weights: the
    contraction, and acc in, out and rot."""
    return (b * (lvl * kp1 * n) * (kp1 * planes * n),
            2 * b * kp1 * n * 4 + b * 4)


def random_u32(gen, shape):
    import torch
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         dtype=torch.int64, device="cuda").to(torch.int32)


def check_equal(label, got, want):
    """Raise unless got == want bit for bit; returns max |got - want|."""
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel != plain version "
                             f"({int((got != want).sum())} elements differ)")
    log(f"phase 2 {label}: kernel == plain (bit-exact), batch "
        f"{got.shape[0]}")
    return int((got.long() - want.long()).abs().max())


def timed_ms(fn):
    """(result, ms) of one call, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chained(eng, ct, key, tp, count):
    """`count` chained bootstraps, each ending in a synchronize: (outputs,
    seconds of each)."""
    import torch
    outs, secs = [], []
    for _ in range(count):
        t0 = time.perf_counter()
        ct = eng.bootstrap_with_test_poly(ct, key, tp)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(ct)
    return outs, secs


def same_lwe(x, y):
    import torch
    return torch.equal(x.a, y.a) and torch.equal(x.b, y.b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from node_fhe_accelerate_tpu_torch.core.bootstrap import (
        TFHE_BOOT_128_K4, TFHE_BOOT_128_L2, LweCiphertext, TfheEngine)
    from node_fhe_accelerate_tpu_torch.core.keycache import (
        deserialize_bootstrap_key)
    from node_fhe_accelerate_tpu_torch.ops import cmux, ladder
    from node_fhe_accelerate_tpu_torch.ops._build import build_all

    # ---- phase 1: card, versions, kernel builds
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bytes = PEAKS[variant(name)]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} card {name} ({variant(name)} peaks)")
    libs = [cmux.STEP_LIB, cmux.SLABS_LIB, ladder.TILES_LIB, ladder.STEPS_LIB]
    t0 = time.perf_counter()
    build_all(libs)
    log(f"phase 1: {len(libs)} kernel sources built side by side and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(f"--- {lib.source.name} (nvcc {lib.info['seconds']} s)")
        log(lib.info["log"].strip())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev = torch.device("cuda")
    err = dict.fromkeys(["cmux_step", "v3", "v2", "ladder_tiles",
                         "ladder_steps"], 0)

    def worse(key, value):
        err[key] = max(err[key], value)

    # ---- phase 2: every kernel vs its plain version
    pk4 = TFHE_BOOT_128_K4()
    with open(K4_BLOB, "rb") as f:
        bsk = deserialize_bootstrap_key(f.read(), pk4, device=dev)
    kp1, n = pk4.glwe_dim + 1, pk4.poly_degree
    base_log = pk4.pbs_base_log
    acc = random_u32(gen, (BATCH, kp1, n))
    rot = torch.randint(-4 * n, 4 * n, (BATCH,), generator=gen,
                        dtype=torch.int32, device="cuda")
    row = bsk.ggsw_i8[0]
    slabs_row = cmux.build_diag_slabs(torch.cat([row, row], dim=-1))

    def check_steps(label, acc, rot, row, slabs, base_log):
        want = cmux.cmux_step_reference(acc, rot, row, base_log)
        worse("cmux_step", check_equal(
            f"cmux_step {label}", cmux.cmux_step(acc, rot, row, base_log),
            want))
        want_s = cmux.cmux_step_slabs_reference(acc, rot, slabs, base_log)
        if not torch.equal(want_s, want):
            raise AssertionError(f"{label}: the two plain steps differ")
        for v in ("v3", "v2"):
            worse(v, check_equal(
                f"cmux_step_slabs {v} {label}",
                cmux.cmux_step_slabs(acc, rot, slabs, base_log, variant=v),
                want_s))

    check_steps("K4", acc, rot, row, slabs_row, base_log)
    pl2 = TFHE_BOOT_128_L2()
    short = 4
    e2 = TfheEngine(dataclasses.replace(pl2, n_lwe=short), device=dev)
    g2 = e2.generate_bootstrap_key(gen, e2.lwe_keygen(gen),
                                   e2.glwe_keygen(gen)).ggsw_i8
    acc2 = random_u32(gen, (BATCH, pl2.glwe_dim + 1, pl2.poly_degree))
    rots2 = torch.randint(-(1 << 20), 1 << 20, (short, BATCH), generator=gen,
                          dtype=torch.int32, device="cuda")
    check_steps("L2 (k=1, N=1024)", acc2, rots2[0], g2[0],
                cmux.build_diag_slabs(torch.cat([g2[0], g2[0]], dim=-1)),
                pl2.pbs_base_log)

    # whole ladders: the committed K4 key (630 rows), a short L2 ladder, and
    # a short truncated-key ladder for ladder_steps
    rots = torch.randint(-4 * n, 4 * n, (pk4.n_lwe, BATCH), generator=gen,
                         dtype=torch.int32, device="cuda")
    want, plain_tiles_ms = timed_ms(
        lambda: ladder.blind_rotate_fused_reference(acc, rots, bsk.ggsw_i8,
                                                    base_log))
    worse("ladder_tiles", check_equal(
        "ladder_tiles K4, 630 steps",
        ladder.blind_rotate_fused(acc, rots, bsk.ggsw_i8, base_log), want))
    slabs_all = cmux.build_all_step_slabs(bsk.ggsw_i8)
    want_s, plain_steps_ms = timed_ms(
        lambda: ladder.blind_rotate_fused_steps_reference(
            acc, rots, slabs_all, base_log))
    if not torch.equal(want_s, want):
        raise AssertionError("K4: the two plain ladders differ")
    worse("ladder_steps", check_equal(
        "ladder_steps K4, 630 steps",
        ladder.blind_rotate_fused_steps(acc, rots, slabs_all, base_log),
        want_s))
    del slabs_all, want, want_s
    worse("ladder_tiles", check_equal(
        f"ladder_tiles L2, {short} steps",
        ladder.blind_rotate_fused(acc2, rots2, g2, pl2.pbs_base_log),
        ladder.blind_rotate_fused_reference(acc2, rots2, g2,
                                            pl2.pbs_base_log)))
    slabs2 = cmux.build_all_step_slabs(g2)
    worse("ladder_steps", check_equal(
        f"ladder_steps L2, {short} steps",
        ladder.blind_rotate_fused_steps(acc2, rots2, slabs2,
                                        pl2.pbs_base_log),
        ladder.blind_rotate_fused_steps_reference(acc2, rots2, slabs2,
                                                  pl2.pbs_base_log)))
    del acc2, rots2, g2, slabs2, e2
    et = TfheEngine(dataclasses.replace(pk4, n_lwe=short, bsk_drop_planes=1),
                    ext_backend="mxu_fused", device=dev)
    gt = et.generate_bootstrap_key(gen, et.lwe_keygen(gen),
                                   et.glwe_keygen(gen)).ggsw_i8
    slabs_t = cmux.build_all_step_slabs(gt)
    want_t = acc
    for i in range(short):
        want_t = et.cmux(gt[i], want_t,
                         et.ring.rotate(want_t, rots[i][:, None]))
    got_t = ladder.blind_rotate_fused_steps(acc, rots[:short], slabs_t,
                                            base_log, drop=1)
    worse("ladder_steps", check_equal(
        f"ladder_steps K4 drop=1, {short} steps vs plain slabs ladder",
        got_t, ladder.blind_rotate_fused_steps_reference(
            acc, rots[:short], slabs_t, base_log, 1)))
    worse("ladder_steps", check_equal(
        f"ladder_steps K4 drop=1, {short} steps vs mxu algebra", got_t,
        want_t))
    del et, gt, slabs_t, want_t, got_t

    # ---- phase 3: whole ladder on the committed key, per-step kernel vs mxu
    lwe = LweCiphertext(a=random_u32(gen, (256, pk4.n_lwe)),
                        b=random_u32(gen, (256,)))
    outs = []
    for backend in ("pallas", "mxu"):
        eng = TfheEngine(pk4, ext_backend=backend, device=dev)
        t0 = time.perf_counter()
        outs.append(eng.bootstrap_with_test_poly(lwe, bsk,
                                                 eng.default_test_poly()))
        torch.cuda.synchronize()
        log(f"phase 3: {backend} bootstrap, 630 steps, batch 256: "
            f"{time.perf_counter() - t0:.3f} s")
    if not same_lwe(outs[0], outs[1]):
        raise AssertionError("phase 3: per-step kernel and mxu bootstraps "
                             "differ")
    log("phase 3: per-step kernel == mxu over the whole ladder (bit-exact)")
    del outs, lwe, bsk

    # ---- phase 4: the main paths at full width
    eng = TfheEngine(pk4, device=dev)          # ext_backend="pallas"
    t0 = time.perf_counter()
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    key = eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    eng_steps = TfheEngine(pk4, ext_backend="mxu_fused", device=dev)
    eng_tiles = TfheEngine(pk4, ext_backend="pallas_fused", device=dev)
    t0 = time.perf_counter()
    key = eng_steps.prepare_bsk(key)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    log(f"phase 4: keygen {keygen_s:.2f} s; prepare_bsk(form='slabs') "
        f"{prepare_s:.3f} s, slabs {tuple(key.ggsw_slabs.shape)} = "
        f"{key.ggsw_slabs.numel()} bytes")
    msgs = torch.arange(BATCH, device=dev) % 2
    ct0 = eng.lwe_encrypt(gen, msgs, lwe_sk)
    tp = eng.default_test_poly()
    torch.cuda.synchronize()

    def counts():
        return {"cmux_step": cmux.cmux_step.launches,
                "cmux_step_slabs_v3": cmux.cmux_step_slabs.launches["v3"],
                "cmux_step_slabs_v2": cmux.cmux_step_slabs.launches["v2"],
                "ladder_tiles": ladder.blind_rotate_fused.launches,
                "ladder_steps": ladder.blind_rotate_fused_steps.launches}

    def zero_counts():
        cmux.cmux_step.launches = 0
        cmux.cmux_step_slabs.launches.update(v3=0, v2=0)
        ladder.blind_rotate_fused.launches = 0
        ladder.blind_rotate_fused_steps.launches = 0

    def expect_counts(path, **want):
        got = counts()
        full = dict.fromkeys(got, 0)
        full.update(want)
        if got != full:
            raise AssertionError(f"phase 4 {path}: launches {got}, "
                                 f"expected {full}")
        return got

    def expect_decode(path, ct):
        dec = eng.lwe_decrypt(ct, lwe_sk)
        if not torch.equal(dec, msgs.to(torch.int32)):
            raise AssertionError(f"phase 4 {path}: decode mismatch in "
                                 f"{int((dec != msgs).sum())} of {BATCH}")

    launches, rates = {}, {}
    # the earlier path: per-step kernel, one bootstrap
    zero_counts()
    (first,), secs = chained(eng, ct0, key, tp, 1)
    launches.update({"cmux_step": expect_counts(
        "per-step", cmux_step=pk4.n_lwe)["cmux_step"]})
    expect_decode("per-step", first)
    rates["pallas"] = BATCH / sum(secs)
    # the direct slab-step entries, on the first step of that bootstrap
    acc_s = eng.ring.rotate(eng._test_poly_acc(ct0.b.shape, tp),
                            (0 - eng._rotations(ct0.b))[..., None])
    rot_s = eng._rotations(ct0.a)[:, 0].contiguous()
    slabs_s = cmux.build_diag_slabs(torch.cat([key.ggsw_i8[0]] * 2, dim=-1))
    want_s = cmux.cmux_step(acc_s, rot_s, key.ggsw_i8[0], base_log)
    zero_counts()
    got_v = [cmux.cmux_step_slabs(acc_s, rot_s, slabs_s, base_log, variant=v)
             for v in ("v3", "v2")]
    torch.cuda.synchronize()
    got = expect_counts("slab steps", cmux_step_slabs_v3=1,
                        cmux_step_slabs_v2=1)
    launches.update({k: got[k] for k in ("cmux_step_slabs_v3",
                                         "cmux_step_slabs_v2")})
    if not all(torch.equal(g, want_s) for g in got_v):
        raise AssertionError("phase 4: slab steps differ from cmux_step")
    del acc_s, rot_s, slabs_s, want_s, got_v
    # the fused backends: one ladder launch per bootstrap
    finals = {}
    for backend, e, kname in (("mxu_fused", eng_steps, "ladder_steps"),
                              ("pallas_fused", eng_tiles, "ladder_tiles")):
        zero_counts()
        outs, secs = chained(e, ct0, key, tp, CHAINED)
        launches[kname] = expect_counts(backend, **{kname: CHAINED})[kname]
        expect_decode(backend, outs[-1])
        if not same_lwe(outs[0], first):
            raise AssertionError(f"phase 4: {backend} differs from the "
                                 "per-step backend on the same input")
        finals[backend] = outs[-1]
        rates[backend] = BATCH * CHAINED / sum(secs)
        log(f"phase 4: {CHAINED} chained bootstraps of {BATCH} through "
            f"{backend}: {[round(x, 4) for x in secs]} s -> "
            f"{rates[backend]:.1f} bootstraps/s; decode ok; == per-step "
            f"backend; {kname} launches {launches[kname]}")
    if not same_lwe(finals["mxu_fused"], finals["pallas_fused"]):
        raise AssertionError("phase 4: the fused backends differ after "
                             f"{CHAINED} chained bootstraps")
    log(f"phase 4: per-step backend, 1 bootstrap of {BATCH}: "
        f"{rates['pallas']:.1f} bootstraps/s; decode ok; cmux_step launches "
        f"{launches['cmux_step']}")
    # detect_duplicate with a known answer: 8 new ballots against 3 lists,
    # at most one match per ballot (the sum of equality bits must stay in
    # the message domain [0, t/2))
    new_m = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0], device=dev)
    old_m = torch.tensor([[0, 0, 1, 0, 0, 1, 0, 1],
                          [1, 0, 1, 1, 0, 1, 0, 1],
                          [1, 0, 1, 0, 0, 1, 1, 1]], device=dev)
    new_ct = eng.lwe_encrypt(gen, new_m, lwe_sk)
    old_cts = [eng.lwe_encrypt(gen, m, lwe_sk) for m in old_m]
    zero_counts()
    dup = eng_steps.lwe_decrypt(
        eng_steps.detect_duplicate(new_ct, old_cts, key), lwe_sk)
    expect_counts("detect_duplicate", ladder_steps=2)
    want_dup = (old_m == new_m[None]).any(dim=0).to(torch.int32)
    if not torch.equal(dup, want_dup):
        raise AssertionError(f"phase 4: detect_duplicate gave "
                             f"{dup.tolist()}, expected {want_dup.tolist()}")
    log(f"phase 4: detect_duplicate through mxu_fused: {dup.tolist()} "
        "as expected, 2 ladder launches")

    # ---- phase 5: timings
    lvl, planes = pk4.pbs_level, row.shape[-2]
    macs, io_bytes = step_work(BATCH, kp1, n, lvl, planes)
    x8 = torch.randint(-128, 128, (BATCH, lvl * kp1 * n), generator=gen,
                       dtype=torch.int8, device="cuda")
    # column-major B: cuBLASLt's int8 path wants it, and a row-major B
    # takes a path several times slower
    w8 = torch.randint(-128, 128, (kp1 * planes * n, lvl * kp1 * n),
                       generator=gen, dtype=torch.int8, device="cuda").t()
    int_mm_ms = cuda_ms(lambda: torch._int_mm(x8, w8), 20)
    steps = pk4.n_lwe
    rows_bytes = key.ggsw_i8.numel()
    times = {
        "cmux_step": (
            cuda_ms(lambda: cmux.cmux_step(acc, rot, row, base_log), 20),
            cuda_ms(lambda: cmux.cmux_step_reference(acc, rot, row,
                                                     base_log), 5, warmup=1),
            bound(macs, io_bytes + row.numel(), peak_ops, peak_bytes),
            int_mm_ms),
        "ladder_tiles": (
            cuda_ms(lambda: ladder.blind_rotate_fused(
                acc, rots, key.ggsw_i8, base_log), 2, warmup=1),
            plain_tiles_ms,
            bound(steps * macs, io_bytes + 4 * BATCH * (steps - 1)
                  + rows_bytes, peak_ops, peak_bytes),
            steps * int_mm_ms),
        "ladder_steps": (
            cuda_ms(lambda: ladder.blind_rotate_fused_steps(
                acc, rots, key.ggsw_slabs, base_log), 2, warmup=1),
            plain_steps_ms,
            bound(steps * macs, io_bytes + 4 * BATCH * (steps - 1)
                  + key.ggsw_slabs.numel(), peak_ops, peak_bytes),
            steps * int_mm_ms),
    }
    plain_slabs_ms = cuda_ms(lambda: cmux.cmux_step_slabs_reference(
        acc, rot, slabs_row, base_log), 5, warmup=1)
    for v in ("v3", "v2"):
        times[f"cmux_step_slabs_{v}"] = (
            cuda_ms(lambda: cmux.cmux_step_slabs(acc, rot, slabs_row,
                                                 base_log, variant=v), 20),
            plain_slabs_ms,
            bound(macs, io_bytes + slabs_row.numel(), peak_ops, peak_bytes),
            int_mm_ms)
    extracted = eng.sample_extract(random_u32(gen, (BATCH, kp1, n)))
    ks_ms = cuda_ms(lambda: eng.key_switch(extracted, key), 10)
    log(f"phase 5: K4 batch {BATCH}; one step is {macs:.3e} MACs; "
        f"torch._int_mm on it {int_mm_ms:.4f} ms; key switch {ks_ms:.4f} ms")
    for kname, (ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        log(f"phase 5: {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), library {lib_ms:.4f} ms")
    log("phase 5: bootstraps/s " + ", ".join(
        f"{b} {r:.1f}" for b, r in rates.items()))

    src = "node_fhe_accelerate_tpu_torch/csrc/"
    ref = "node_fhe_accelerate_tpu/ops/pallas_cmux.py:"
    table = [("cmux_step", "cmux_step.cu", 144, "cmux_step"),
             ("cmux_step_slabs_v3", "cmux_step_slabs.cu", 183, "v3"),
             ("cmux_step_slabs_v2", "cmux_step_slabs.cu", 226, "v2"),
             ("ladder_tiles", "ladder_tiles.cu", 282, "ladder_tiles"),
             ("ladder_steps", "ladder_steps.cu", 459, "ladder_steps")]
    record = {"kernels": [{
        "name": kname, "route": "cuda", "source": src + source,
        "replaces": ref + str(line), "launches": launches[kname],
        "max_abs_err": err[ekey], "ms": times[kname][0],
        "plain_ms": times[kname][1], "bound_ms": times[kname][2][0],
        "bound_by": times[kname][2][1], "library_ms": times[kname][3]}
        for kname, source, line, ekey in table]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
