#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Run from the repository root.  It imports neither JAX nor the JAX package.
Phases (any failure ends the run with a non-zero exit and no result line):

1. the card's name and power limit, torch/CUDA versions, and the build of
   the CMux kernel (csrc/cmux_step.cu, nvcc for sm_90a into build/);
2. kernel vs its plain PyTorch version, one CMux step at batch 4096:
   on a row of the committed TFHE_BOOT_128_K4 key (.keycache) and on a
   TFHE_BOOT_128_L2-shaped row (k=1, N=1024) -- bit-exact;
3. a full 630-step ``bootstrap_with_test_poly`` on the committed K4 key at
   batch 256, once through the "kernel" backend and once through "mxu" --
   bit-equal;
4. the main path at full width: port keygen at TFHE_BOOT_128_K4 from a
   seeded torch.Generator, 4096 messages encrypted, 3 chained bootstraps
   (each consumes the last one's output, each ends in a synchronize);
   decode must return the messages and the kernel's launch count must be
   630 per bootstrap;
5. timings with CUDA events: the CMux step (kernel, plain version, its
   bound, and torch._int_mm on the same int8 contraction as a yardstick),
   the key switch, and bootstraps/s of phase 4.

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


def step_bound(b, kp1, n, lvl, planes, peak_ops, peak_bytes):
    """Least time of one CMux step: its int8 MACs (2 ops each) at the
    int8 peak vs its bytes (acc in, out, rot, one key row) at the memory
    rate; the larger wins."""
    macs = b * (lvl * kp1 * n) * (kp1 * planes * n)
    nbytes = 2 * b * kp1 * n * 4 + b * 4 + lvl * kp1 * kp1 * planes * 2 * n
    t_ops, t_bytes = 2 * macs / peak_ops, nbytes / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", macs, nbytes)


def random_u32(gen, shape):
    import torch
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         dtype=torch.int64, device="cuda").to(torch.int32)


def check_step(cmux, acc, rot, g, base_log, label):
    import torch
    got = cmux.cmux_step(acc, rot, g, base_log)
    torch.cuda.synchronize()
    want = cmux.cmux_step_reference(acc, rot, g, base_log)
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel != plain version "
                             f"({int((got != want).sum())} elements differ)")
    log(f"phase 2 {label}: kernel == plain (bit-exact), batch "
        f"{acc.shape[0]}")
    return err


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
    from node_fhe_accelerate_tpu_torch.ops import cmux

    # ---- phase 1: card, versions, kernel build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bytes = PEAKS[variant(name)]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} card {name} ({variant(name)} peaks)")
    t0 = time.perf_counter()
    cmux.build()
    log(f"phase 1: cmux_step kernel built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {cmux.build_info['seconds']})")
    log(cmux.build_info["log"].strip())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev = torch.device("cuda")

    # ---- phase 2: one step, kernel vs plain, at K4 and at the L2 shape
    pk4 = TFHE_BOOT_128_K4()
    with open(K4_BLOB, "rb") as f:
        bsk = deserialize_bootstrap_key(f.read(), pk4, device=dev)
    kp1, n = pk4.glwe_dim + 1, pk4.poly_degree
    acc = random_u32(gen, (BATCH, kp1, n))
    rot = torch.randint(-4 * n, 4 * n, (BATCH,), generator=gen,
                        dtype=torch.int32, device="cuda")
    row = bsk.ggsw_i8[0]
    max_err = check_step(cmux, acc, rot, row, pk4.pbs_base_log, "K4")
    pl2 = TFHE_BOOT_128_L2()
    e2 = TfheEngine(dataclasses.replace(pl2, n_lwe=1), device=dev)
    row2 = e2.generate_bootstrap_key(gen, e2.lwe_keygen(gen),
                                     e2.glwe_keygen(gen)).ggsw_i8[0]
    acc2 = random_u32(gen, (BATCH, pl2.glwe_dim + 1, pl2.poly_degree))
    rot2 = torch.randint(-(1 << 20), 1 << 20, (BATCH,), generator=gen,
                         dtype=torch.int32, device="cuda")
    max_err = max(max_err, check_step(cmux, acc2, rot2, row2,
                                      pl2.pbs_base_log, "L2 (k=1, N=1024)"))
    del acc2, rot2, row2, e2

    # ---- phase 3: whole ladder on the committed key, kernel vs mxu
    lwe = LweCiphertext(a=random_u32(gen, (256, pk4.n_lwe)),
                        b=random_u32(gen, (256,)))
    outs = []
    for backend in ("kernel", "mxu"):
        eng = TfheEngine(pk4, ext_backend=backend, device=dev)
        t0 = time.perf_counter()
        outs.append(eng.bootstrap_with_test_poly(lwe, bsk,
                                                 eng.default_test_poly()))
        torch.cuda.synchronize()
        log(f"phase 3: {backend} bootstrap, 630 steps, batch 256: "
            f"{time.perf_counter() - t0:.3f} s")
    if not (torch.equal(outs[0].a, outs[1].a)
            and torch.equal(outs[0].b, outs[1].b)):
        raise AssertionError("phase 3: kernel and mxu bootstraps differ")
    log("phase 3: kernel == mxu over the whole ladder (bit-exact)")
    del outs, lwe, bsk

    # ---- phase 4: the main path at full width
    eng = TfheEngine(pk4, device=dev)          # ext_backend="kernel"
    t0 = time.perf_counter()
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    key = eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    msgs = torch.arange(BATCH, device=dev) % 2
    ct = eng.lwe_encrypt(gen, msgs, lwe_sk)
    tp = eng.default_test_poly()
    torch.cuda.synchronize()
    cmux.cmux_step.launches = 0
    iter_s = []
    for _ in range(CHAINED):
        t0 = time.perf_counter()
        ct = eng.bootstrap_with_test_poly(ct, key, tp)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
    launches = cmux.cmux_step.launches
    dec = eng.lwe_decrypt(ct, lwe_sk)
    if not torch.equal(dec, msgs.to(torch.int32)):
        raise AssertionError(f"phase 4: decode mismatch in "
                             f"{int((dec != msgs).sum())} of {BATCH}")
    if launches != pk4.n_lwe * CHAINED:
        raise AssertionError(f"phase 4: {launches} kernel launches, "
                             f"expected {pk4.n_lwe * CHAINED}")
    rate = BATCH * CHAINED / sum(iter_s)
    log(f"phase 4: keygen {keygen_s:.2f} s; {CHAINED} chained bootstraps "
        f"of {BATCH}: {[round(s, 4) for s in iter_s]} s -> {rate:.1f} "
        f"bootstraps/s; decode ok; cmux_step launches {launches}")

    # ---- phase 5: timings
    ms = cuda_ms(lambda: cmux.cmux_step(acc, rot, row, pk4.pbs_base_log), 20)
    plain_ms = cuda_ms(lambda: cmux.cmux_step_reference(
        acc, rot, row, pk4.pbs_base_log), 5, warmup=1)
    lvl, planes = pk4.pbs_level, row.shape[-2]
    x8 = torch.randint(-128, 128, (BATCH, lvl * kp1 * n), generator=gen,
                       dtype=torch.int8, device="cuda")
    # column-major B: cuBLASLt's int8 path wants it, and a row-major B
    # takes a path several times slower
    w8 = torch.randint(-128, 128, (kp1 * planes * n, lvl * kp1 * n),
                       generator=gen, dtype=torch.int8, device="cuda").t()
    library_ms = cuda_ms(lambda: torch._int_mm(x8, w8), 20)
    bound_ms, bound_by, macs, nbytes = step_bound(
        BATCH, kp1, n, lvl, planes, peak_ops, peak_bytes)
    extracted = eng.sample_extract(random_u32(gen, (BATCH, kp1, n)))
    ks_ms = cuda_ms(lambda: eng.key_switch(extracted, key), 10)
    log(f"phase 5: cmux_step K4 batch {BATCH}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{macs:.3e} MACs, {nbytes} bytes), torch._int_mm "
        f"{library_ms:.4f} ms; key switch {ks_ms:.4f} ms; "
        f"{rate:.1f} bootstraps/s")

    record = {"kernels": [{
        "name": "cmux_step", "route": "cuda",
        "source": "node_fhe_accelerate_tpu_torch/csrc/cmux_step.cu",
        "replaces": "node_fhe_accelerate_tpu/ops/pallas_cmux.py:144",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
