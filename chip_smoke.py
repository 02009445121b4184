#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Run from the repository root.  It imports neither JAX nor the JAX package.
Phases (any failure ends the run with a non-zero exit and no result line):

1. the card's name and power limit, torch/CUDA versions, and the build of
   every kernel source under csrc/ (one nvcc each for sm_90a, side by side,
   into build/), with the compiler's register and spill lines;
2. every kernel vs its plain PyTorch version, bit for bit: the digit-plane
   Montgomery products (digits.cu: K9 digit-major at D=32 with the MSM's
   widths B=131072, 16384, 8160, at D=48 with B=32768 and at a ragged
   B=1000; K10 row-major at D=32 with B=8160 and 1, at D=48 with B=4096)
   on canonical random elements, the edge values 0, 1, 2, q-1, q-2, ... in
   both layouts, K9 == K10 on transposed inputs, and a few rows against
   the big-integer oracle a*b*R^-1 mod q; the NTT
   kernels (ntt.cu: forward, inverse, negacyclic product) at the JAX
   package's bench shapes (N=1024/B=8192, 4096/2048, 16384/512 with
   Q_40_1, 16384/512 with Q_60_1; the product at N=1024/B=2048, and
   against the big-integer oracle on a few rows), at the bootstrap's shapes
   (P1 and P2 at N=4096/B=1536, P_EXT at N=256/B=2560) and at a ragged
   batch; then, at batch 4096,
   one CMux step through cmux_step and through cmux_step_slabs (v3, v2) on
   a row of the committed TFHE_BOOT_128_K4 key (.keycache) and on a
   TFHE_BOOT_128_L2-shaped row (k=1, N=1024), and cmux_step again at a
   ragged batch of 4000; the whole ladder through ladder_tiles and
   ladder_steps over all 630 rows of the committed key and over a short
   ladder at the L2 shape; ladder_tiles also on short ladders at batches of
   1, 127 and 129 rows (one more than a 128-row tile) and at 0 and 1
   steps; ladder_steps (on the K-major slabs of build_all_step_kslabs) also
   on a short truncated-key ladder (drop=1) and on a short ladder at the
   ragged batch;
3. a full 630-step ``bootstrap_with_test_poly`` on the committed K4 key at
   batch 256, once through the per-step kernel backend and once through
   "mxu" -- bit-equal;
4. the main paths at full width: port keygen at TFHE_BOOT_128_K4 from a
   seeded torch.Generator, ``prepare_bsk`` to the K-major slabs (its time
   and bytes), 4096 messages encrypted; then, each with the launch counts
   set to 0 just before and read just after: one bootstrap through the
   per-step backend (630 launches), one through the plain "mxu" backend
   (the port's library path, no kernel launch; timed as the end-to-end
   yardstick), the direct slab-step entries once each, 3 chained bootstraps
   through "mxu_fused" and 3 through "pallas_fused" (one ladder launch per
   bootstrap, each ending in a synchronize, decode checked, bit-equal to
   the per-step and "mxu" backends), and a ``detect_duplicate`` with a
   known answer;
   then the NTT paths, counts likewise: keys from one generator state at
   TFHE_BOOT_128_K4 through "ntt" and "crt", one bootstrap of 256 each,
   bit-equal to "pallas" on its key from the same state (630 forward and
   630 inverse NTT launches through "ntt", twice that through "crt");
   TFHE_256 (n=1024, N=4096, k=1, Bg=2^10, l=3, the JAX bench's
   pbs_n1024_N4096_l3_tfhe256 row) through "crt": keygen and one
   decode-checked bootstrap of TFHE256_BATCH (2048 forward and 2048 inverse
   launches); and the CRT ring product (one fused product launch per
   prime) against the float64 mask product at N=4096; then the ZK path,
   counts likewise and for each MSM covering the ``msm`` call alone:
   msm_bn254_4096 as the JAX suite builds it (utils/bench_suite.py:
   points from ``fixed_base_mul(1..4096)`` on the card, 62-bit scalars from
   default_rng(7)) through the Pippenger, 504 K9 and 2584 K10 launches,
   equal to the host Pippenger; the same at BLS12-381 G1 with n=1024 (456
   and 2584); and a 64-bit Bulletproofs range proof on the card
   (``BulletproofsGens.generate(curve, 64)``, a seeded prover, the value
   drawn as the JAX suite draws it) equal field for field to the proof the
   port makes on the CPU from the same seed, verifying, and refused once
   t_hat is tampered;
5. timings with CUDA events for each kernel (kernel, plain version, its
   bound, and torch._int_mm on the same int8 contraction as a yardstick;
   no PyTorch call computes an NTT mod q or a Montgomery product mod a
   254- or 381-bit prime, so the NTT and digit kernels have none), the key
   switch, bootstraps/s per backend, the time of one TFHE_256 "crt" step
   split into its NTT launches and the plain work around them, the wall
   time of msm_bn254_4096, its split by point op and width, and, within
   one call under torch.profiler, the device time and launches of K9, K10
   and the other kernels and the device's idle share, and the seconds of
   one 64-bit prove_range and verify_range.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K4_BLOB = os.path.join(ROOT, ".keycache",
                       "7f5658596c1857e89c056b7e0b17cabf.fheb")
BATCH = 4096
CHAINED = 3
NTT_BATCH = 256          # the NTT-backend bootstraps at K4
TFHE256_BATCH = 256      # the JAX bench's batch for the TFHE_256 row

# Published dense peaks (NVIDIA data sheets): int8 tensor-core ops/s and
# device-memory bytes/s, at the full power limit.
PEAKS = {"H100 SXM": (1979e12, 3.35e12), "H100 PCIe": (1513e12, 2.0e12),
         "H100 NVL": (1671e12, 3.9e12), "H200": (1979e12, 4.8e12)}


# 32-bit integer multiplies per clock per SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput); times the
# SM count and the card's maximum SM clock gives the INT32 multiply rate.
INT32_MUL_PER_SM_CLK = 64
# 32-bit multiplies of one 64-bit Montgomery product: the 64x64->128
# product (8), its low half times -q^-1 (4), m*q (8).
MONT_MULS = 20
MSM_N = 4096             # the JAX suite's msm_bn254_4096 row
MSM_BLS_N = 1024
BP_BITS = 64             # the JAX suite's bp_range_prove_64 row
# launches of one Pippenger (c = 8, W = 32 windows of 8-limb scalars), each
# point add evaluating 24 products and each double 7: the wide adds of the
# group scans (log2 8 + ceil(log2(n/8)) + 1 bucket gather + 8 bucket scans)
# take K9, the narrow tail (8 + 31*8 doubles and 2 + 31 adds at widths 32
# and 1) takes K10
PIPPENGER_LAUNCHES = {4096: (24 * (3 + 9 + 1 + 8), 7 * 256 + 24 * 33),
                      1024: (24 * (3 + 7 + 1 + 8), 7 * 256 + 24 * 33)}


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


def ntt_bound(kind, b, n, mul_rate, peak_bytes):
    """(ms, bound_by) of one NTT launch over b polynomials of degree n:
    its 32-bit multiplies at the INT32 rate against its bytes (each input
    plane read once, each output plane written once) at the memory rate."""
    logn = n.bit_length() - 1
    butterflies = b * (n // 2) * logn
    if kind == "forward":
        monts, nbytes = butterflies, 16 * b * n
    elif kind == "inverse":
        monts, nbytes = butterflies + b * n, 16 * b * n
    else:   # two forwards, the pointwise product (2), inverse, scale
        monts, nbytes = 3 * butterflies + 3 * b * n, 24 * b * n
    t_ops = MONT_MULS * monts / mul_rate
    t_bytes = nbytes / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def digits_bound(d, b, mul_rate, peak_bytes):
    """(ms, bound_by) of one Montgomery product over b elements of d 8-bit
    digits held as int32: two operand planes read and one written (12 d
    bytes an element) at the memory rate, against the 32-bit multiplies of
    one CIOS product over L = d/4 limbs (2L^2 + L word products, low and
    high halves each) at the INT32 rate."""
    L = d // 4
    t_ops = 2 * (2 * L * L + L) * b / mul_rate
    t_bytes = 12 * d * b / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def step_work(b, kp1, n, lvl, planes):
    """(int8 MACs, bytes) of one CMux step apart from its weights: the
    contraction, and acc in, out and rot."""
    return (b * (lvl * kp1 * n) * (kp1 * planes * n),
            2 * b * kp1 * n * 4 + b * 4)


def ptxas_summary(text):
    """'kernel<P>: R registers, S bytes spilled' per entry function of a
    ptxas -v log."""
    out, name = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"_kernelILi(\d+)E", line)
            name = f"P={m.group(1)}" if m else "kernel"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       "spilled")
            name = None
    return out


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

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from node_fhe_accelerate_tpu_torch.core.bootstrap import (
        TFHE_BOOT_128_K4, TFHE_BOOT_128_L2, LweCiphertext, TfheEngine,
        TfheParams)
    from node_fhe_accelerate_tpu_torch.core.keycache import (
        deserialize_bootstrap_key)
    from node_fhe_accelerate_tpu_torch.core.params import Primes
    from node_fhe_accelerate_tpu_torch.core.torus import P1, P2, P_EXT
    from node_fhe_accelerate_tpu_torch.ops import cmux, ladder
    from node_fhe_accelerate_tpu_torch.ops._build import build_all
    from node_fhe_accelerate_tpu_torch.ops.ntt import (NTTContext,
                                                       negacyclic_mul_np)
    from node_fhe_accelerate_tpu_torch.ops.ntt_pallas import NTT_LIB, PallasNTT
    from node_fhe_accelerate_tpu_torch.ops.u64 import u64_to_np
    from node_fhe_accelerate_tpu_torch.ops import digits as dg
    from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
    from node_fhe_accelerate_tpu_torch.ops.limbs import limbs_from_ints
    from node_fhe_accelerate_tpu_torch.zk.bulletproofs import (
        BulletproofsGens, BulletproofsProver, BulletproofsVerifier)
    from node_fhe_accelerate_tpu_torch.zk.curve import (bls12_381_g1,
                                                        bn254_g1)
    from node_fhe_accelerate_tpu_torch.zk.field import (bls12_381_fq,
                                                        bn254_fq)

    # ---- phase 1: card, versions, kernel builds
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bytes = PEAKS[variant(name)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mul_rate = INT32_MUL_PER_SM_CLK * sms * max_sm_mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} card {name} ({variant(name)} peaks); "
        f"{sms} SMs at up to {max_sm_mhz:.0f} MHz: {mul_rate:.4e} 32-bit "
        "integer multiplies/s")
    libs = [cmux.STEP_LIB, cmux.SLABS_LIB, ladder.TILES_LIB, ladder.STEPS_LIB,
            NTT_LIB, dp.DIGITS_LIB]
    t0 = time.perf_counter()
    build_all(libs)
    log(f"phase 1: {len(libs)} kernel sources built side by side and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(f"--- {lib.source.name} (nvcc {lib.info['seconds']} s)")
        log(lib.info["log"].strip())
    for lib in (cmux.STEP_LIB, ladder.TILES_LIB, ladder.STEPS_LIB):
        log(f"phase 1: {lib.source.name} (wgmma): "
            + "; ".join(ptxas_summary(lib.info["log"])))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev = torch.device("cuda")
    err = dict.fromkeys(["cmux_step", "v3", "v2", "ladder_tiles",
                         "ladder_steps", "ntt", "digits"], 0)

    def worse(key, value):
        err[key] = max(err[key], value)

    # ---- phase 2: every kernel vs its plain version
    # the digit-plane Montgomery products (K9 digit-major, K10 row-major)
    # against Field.mul_plain, on canonical elements: random digits with the
    # top digit below q's
    fq32, fq48 = bn254_fq(dev), bls12_381_fq(dev)

    def rand_elems(f, b):
        x = torch.randint(0, 256, (b, f.n_limbs), generator=gen,
                          dtype=torch.int32, device="cuda")
        x[:, -1] %= int(f._q_digits_np[-1])
        return x

    def check_digits(label, f, a, b, k9):
        want = f.mul_plain(a, b)
        got = (dp._mul_t_raw(f, a.T.contiguous(), b.T.contiguous()).T
               if k9 else dp.pallas_field_mul(f, a, b))
        worse("digits", check_equal(label, got, want))
        rinv = pow(1 << (8 * f.n_limbs), -1, f.q)
        rows = [dg.digits_to_ints(x[:3]) for x in (a, b, got)]
        for x, y, z in zip(*rows):
            if z != x * y * rinv % f.q:
                raise AssertionError(f"{label}: a row != the big-integer "
                                     "oracle a*b*R^-1 mod q")
        return got

    digit_shapes = {"mul_t": [(fq32, 131072), (fq32, 16384), (fq32, 8160),
                              (fq48, 32768), (fq32, 1000)],
                    "mul": [(fq32, 8160), (fq32, 1), (fq48, 4096)]}
    for kind, shapes in digit_shapes.items():
        for f, b in shapes:
            check_digits(f"digits {kind} D={f.n_limbs}", f,
                         rand_elems(f, b), rand_elems(f, b), kind == "mul_t")
    for f in (fq32, fq48):
        q = f.q
        edge = [0, 1, 2, q - 1, q - 2, 255, 256, (1 << 254) % q, q // 2,
                0xFF00FF00FF00FF00]
        a, b = f.encode(edge), f.encode(edge[::-1])
        for kind in ("mul_t", "mul"):
            check_digits(f"digits {kind} D={f.n_limbs} edge values", f, a,
                         b, kind == "mul_t")
    a, b = rand_elems(fq32, 8160), rand_elems(fq32, 8160)
    aT, bT = a.T.contiguous(), b.T.contiguous()
    if not torch.equal(dp._mul_t_raw(fq32, aT, bT).T,
                       dp.pallas_field_mul(fq32, a, b)):
        raise AssertionError("digits: K9 != K10 on transposed inputs")
    log("phase 2 digits: K9 == K10 on transposed inputs, D=32 B=8160; "
        "rows 0-2 of every check == the big-integer oracle")
    del a, b, aT, bT
    # the NTT kernels against NTTContext, on canonical random residues
    ntts = {}

    def pntt(n, q):
        if (n, q) not in ntts:
            ntts[n, q] = PallasNTT(NTTContext(n, q))
        return ntts[n, q]

    def rand_planes(b, n, q):
        v = torch.randint(0, q, (b, n), generator=gen, dtype=torch.int64,
                          device="cuda")
        return v.to(torch.int32), (v >> 32).to(torch.int32)

    def check_planes(label, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{label}: kernel != plain version "
                                     f"({int((g != w).sum())} differ)")
        log(f"phase 2 {label}: kernel == plain (bit-exact), batch "
            f"{got[0].shape[0]}")

    q40, q60 = Primes.Q_40_1, Primes.Q_60_1
    for label, deg, b, q in (("bench Q_40_1", 1024, 8192, q40),
                             ("bench Q_40_1", 4096, 2048, q40),
                             ("bench Q_40_1", 16384, 512, q40),
                             ("bench Q_60_1", 16384, 512, q60),
                             ("path P1", 4096, 1536, P1),
                             ("path P2", 4096, 1536, P2),
                             ("path P_EXT", 256, 2560, P_EXT),
                             ("ragged P1", 4096, 24, P1),
                             ("ragged P_EXT", 256, 24, P_EXT)):
        pk, a = pntt(deg, q), rand_planes(b, deg, q)
        fa = pk.forward(a)
        check_planes(f"ntt forward {label} N={deg}", fa, pk.ntt.forward(a))
        back = pk.inverse(fa)
        check_planes(f"ntt inverse {label} N={deg}", back,
                     pk.ntt.inverse(fa))
        check_planes(f"ntt inverse(forward) {label} N={deg} == input", back,
                     a)
    for label, deg, b, q in (("bench Q_40_1", 1024, 2048, q40),
                             ("ragged P1", 4096, 24, P1)):
        pk = pntt(deg, q)
        a, c = rand_planes(b, deg, q), rand_planes(b, deg, q)
        got = pk.negacyclic_mul(a, c)
        check_planes(f"ntt negacyclic_mul {label} N={deg}", got,
                     pk.ntt.negacyclic_mul(a, c))
        an, cn, gn = u64_to_np(a), u64_to_np(c), u64_to_np(got)
        for i in range(3):
            if not (gn[i] == negacyclic_mul_np(an[i], cn[i], q)).all():
                raise AssertionError(f"ntt negacyclic_mul {label}: row {i} "
                                     "!= the big-integer oracle")
        log(f"phase 2 ntt negacyclic_mul {label}: rows 0-2 == "
            "negacyclic_mul_np")
    del a, c, fa, back, got
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
    ragged = 4000
    worse("cmux_step", check_equal(
        "cmux_step K4 ragged", cmux.cmux_step(acc[:ragged], rot[:ragged],
                                              row, base_log),
        cmux.cmux_step_reference(acc[:ragged], rot[:ragged], row, base_log)))

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
    slabs_all = cmux.build_all_step_kslabs(bsk.ggsw_i8)
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
    slabs2 = cmux.build_all_step_kslabs(g2)
    worse("ladder_steps", check_equal(
        f"ladder_steps L2, {short} steps",
        ladder.blind_rotate_fused_steps(acc2, rots2, slabs2,
                                        pl2.pbs_base_log),
        ladder.blind_rotate_fused_steps_reference(acc2, rots2, slabs2,
                                                  pl2.pbs_base_log)))
    del acc2, rots2, g2, slabs2, e2
    # ladder_tiles at the edges of a 128-row tile and at 0 and 1 steps, on
    # the committed key

    def check_tiles(label, a, r, g):
        got = ladder.blind_rotate_fused(a, r, g, base_log)
        worse("ladder_tiles", check_equal(
            f"ladder_tiles K4 {label}, {g.shape[0]} steps", got,
            ladder.blind_rotate_fused_reference(a, r, g, base_log)))

    for rows_e in (1, 127, 129):
        check_tiles(f"batch {rows_e}", acc[:rows_e],
                    rots[:short, :rows_e].contiguous(), bsk.ggsw_i8[:short])
    for steps_e in (0, 1):
        check_tiles(f"batch {BATCH}", acc, rots[:steps_e].contiguous(),
                    bsk.ggsw_i8[:steps_e])
    et = TfheEngine(dataclasses.replace(pk4, n_lwe=short, bsk_drop_planes=1),
                    ext_backend="mxu_fused", device=dev)
    gt = et.generate_bootstrap_key(gen, et.lwe_keygen(gen),
                                   et.glwe_keygen(gen)).ggsw_i8
    slabs_t = cmux.build_all_step_kslabs(gt)
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
    slabs_r = cmux.build_all_step_kslabs(bsk.ggsw_i8[:short])
    worse("ladder_steps", check_equal(
        f"ladder_steps K4 ragged, {short} steps",
        ladder.blind_rotate_fused_steps(acc[:ragged], rots[:short, :ragged],
                                        slabs_r, base_log),
        ladder.blind_rotate_fused_reference(acc[:ragged],
                                            rots[:short, :ragged],
                                            bsk.ggsw_i8[:short], base_log)))
    del slabs_r

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
        f"{prepare_s:.3f} s, K-major slabs {tuple(key.ggsw_kslabs.shape)} = "
        f"{key.ggsw_kslabs.numel()} bytes")
    msgs = torch.arange(BATCH, device=dev) % 2
    ct0 = eng.lwe_encrypt(gen, msgs, lwe_sk)
    tp = eng.default_test_poly()
    torch.cuda.synchronize()

    def counts():
        return {"cmux_step": cmux.cmux_step.launches,
                "cmux_step_slabs_v3": cmux.cmux_step_slabs.launches["v3"],
                "cmux_step_slabs_v2": cmux.cmux_step_slabs.launches["v2"],
                "ladder_tiles": ladder.blind_rotate_fused.launches,
                "ladder_steps": ladder.blind_rotate_fused_steps.launches,
                **{f"ntt_{k}": v for k, v in PallasNTT.launches.items()},
                "digits_mul_t": dp._mul_t_raw.launches,
                "digits_mul": dp.pallas_field_mul.launches}

    def zero_counts():
        cmux.cmux_step.launches = 0
        cmux.cmux_step_slabs.launches.update(v3=0, v2=0)
        ladder.blind_rotate_fused.launches = 0
        ladder.blind_rotate_fused_steps.launches = 0
        PallasNTT.launches.update(forward=0, inverse=0, negacyclic_mul=0)
        dp._mul_t_raw.launches = 0
        dp.pallas_field_mul.launches = 0

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
    # the port's library path ("mxu": the plain contraction on the card,
    # no kernel of csrc/), one bootstrap, as the end-to-end yardstick
    eng_mxu = TfheEngine(pk4, ext_backend="mxu", device=dev)
    zero_counts()
    (first_mxu,), secs = chained(eng_mxu, ct0, key, tp, 1)
    expect_counts("mxu")
    if not same_lwe(first_mxu, first):
        raise AssertionError("phase 4: the mxu bootstrap differs from the "
                             "per-step backend")
    rates["mxu"] = BATCH / sum(secs)
    log(f"phase 4: mxu (plain) backend, 1 bootstrap of {BATCH}: "
        f"{secs[0]:.4f} s -> {rates['mxu']:.1f} bootstraps/s; == per-step "
        "backend; no kernel launches")
    del first_mxu, eng_mxu
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

    # the NTT backends at K4: keys from one generator state, one per form
    state = torch.Generator(device="cuda").manual_seed(args.seed + 1) \
        .get_state()

    def keys_from_state(backend, params):
        e = TfheEngine(params, ext_backend=backend, device=dev)
        g = torch.Generator(device="cuda")
        g.set_state(state)
        lsk, gsk = e.lwe_keygen(g), e.glwe_keygen(g)
        return e, lsk, e.generate_bootstrap_key(g, lsk, gsk), g

    e_ref, lsk_n, key_ref, g_n = keys_from_state("pallas", pk4)
    msgs_n = torch.arange(NTT_BATCH, device=dev) % 2
    ct_n = e_ref.lwe_encrypt(g_n, msgs_n, lsk_n)
    tp4 = e_ref.default_test_poly()
    want_n = e_ref.bootstrap_with_test_poly(ct_n, key_ref, tp4)
    for backend, per_step in (("ntt", 1), ("crt", 2)):
        e_b, lsk_b, key_b, _ = keys_from_state(backend, pk4)
        if not torch.equal(lsk_b, lsk_n):
            raise AssertionError(f"phase 4: {backend} keygen drew other "
                                 "secret keys from the same state")
        zero_counts()
        (out,), secs = chained(e_b, ct_n, key_b, tp4, 1)
        got = expect_counts(f"{backend} K4", ntt_forward=per_step * pk4.n_lwe,
                            ntt_inverse=per_step * pk4.n_lwe)
        if not same_lwe(out, want_n):
            raise AssertionError(f"phase 4: {backend} bootstrap differs from "
                                 "pallas on keys from the same state")
        dec = e_b.lwe_decrypt(out, lsk_n)
        if not torch.equal(dec, msgs_n.to(torch.int32)):
            raise AssertionError(f"phase 4: {backend} K4 decode mismatch")
        rates[f"{backend} K4"] = NTT_BATCH / secs[0]
        log(f"phase 4: {backend} at K4, 1 bootstrap of {NTT_BATCH}: "
            f"{secs[0]:.3f} s -> {rates[f'{backend} K4']:.1f} bootstraps/s; "
            f"== pallas (bit-exact); decode ok; ntt forward/inverse "
            f"launches {got['ntt_forward']}/{got['ntt_inverse']}")
        del e_b, key_b, out
    del key_ref, want_n

    # the slice's full-width path: TFHE_256 through "crt", as the JAX
    # package's bench builds it (utils/bench_suite.py, pbs_n1024_N4096_l3)
    p256 = TfheParams(n_lwe=1024, poly_degree=4096, glwe_dim=1,
                      pbs_base_log=10, pbs_level=3, ks_base_log=4, ks_level=8,
                      lwe_noise_std=2.0 ** 10, glwe_noise_std=2.0 ** 4,
                      plaintext_modulus=16)
    e256 = TfheEngine(p256, ext_backend="crt", device=dev)
    g256 = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    t0 = time.perf_counter()
    lsk256, gsk256 = e256.lwe_keygen(g256), e256.glwe_keygen(g256)
    key256 = e256.generate_bootstrap_key(g256, lsk256, gsk256)
    torch.cuda.synchronize()
    keygen256_s = time.perf_counter() - t0
    crt_bytes = sum(x.numel() * 4 for pr in key256.ggsw_crt for x in pr)
    log(f"phase 4: TFHE_256 crt keygen {keygen256_s:.2f} s, ggsw_crt "
        f"{crt_bytes} bytes")
    msgs256 = torch.arange(TFHE256_BATCH, device=dev) % 8
    ct256 = e256.lwe_encrypt(g256, msgs256, lsk256)
    zero_counts()
    (out256,), secs = chained(e256, ct256, key256,
                              e256.default_test_poly(), 1)
    launches.update(
        {k: v for k, v in expect_counts(
            "TFHE_256 crt", ntt_forward=2 * p256.n_lwe,
            ntt_inverse=2 * p256.n_lwe).items()
         if k in ("ntt_forward", "ntt_inverse")})
    dec = e256.lwe_decrypt(out256, lsk256)
    if not torch.equal(dec, msgs256.to(torch.int32)):
        raise AssertionError(f"phase 4: TFHE_256 decode mismatch in "
                             f"{int((dec != msgs256).sum())} of "
                             f"{TFHE256_BATCH}")
    rates["crt TFHE_256"] = TFHE256_BATCH / secs[0]
    log(f"phase 4: TFHE_256 crt, 1 bootstrap of {TFHE256_BATCH}: "
        f"{secs[0]:.3f} s -> {rates['crt TFHE_256']:.2f} bootstraps/s; "
        f"decode ok; ntt forward/inverse launches "
        f"{launches['ntt_forward']}/{launches['ntt_inverse']}")
    # the CRT ring product at N=4096: one fused launch per prime; equal to
    # the engine's float64 mask product on the binary key, and to the plain
    # CPU product on random torus polynomials
    ring = e256.ring
    masks = random_u32(gen, (TFHE256_BATCH, p256.poly_degree))
    other = random_u32(gen, (TFHE256_BATCH, p256.poly_degree))
    zero_counts()
    prod_key = ring.multiply(masks, gsk256[0])
    prod_rand = ring.multiply(masks, other)
    torch.cuda.synchronize()
    got = expect_counts("ring multiply", ntt_negacyclic_mul=4)
    launches["ntt_negacyclic_mul"] = got["ntt_negacyclic_mul"]
    if not torch.equal(prod_key,
                       e256._mask_dot(masks.unsqueeze(-2), gsk256)):
        raise AssertionError("phase 4: ring multiply != mask product")
    rows = slice(0, 4)
    if not torch.equal(prod_rand[rows].cpu(),
                       ring.multiply(masks[rows].cpu(), other[rows].cpu())):
        raise AssertionError("phase 4: ring multiply on the card != plain "
                             "CPU product")
    log(f"phase 4: ring multiply N=4096 batch {TFHE256_BATCH}: == float64 "
        "mask product, == plain CPU product (rows 0-3); "
        f"{launches['ntt_negacyclic_mul']} product launches")

    # the ZK path at full width: msm_bn254_4096 as the JAX suite builds it
    # (utils/bench_suite.py: points from fixed_base_mul(1..4096), scalars
    # from default_rng(7)), then BLS12-381 G1 at n=1024; the counts cover
    # the msm call alone
    def affine(curve, p):
        x, y, inf = curve.to_affine_ints(p)
        return ([int(v) for v in np.atleast_1d(x)],
                [int(v) for v in np.atleast_1d(y)],
                np.atleast_1d(inf).tolist())

    msm_runs = {}
    for cname, make, n_pts in (("bn254", bn254_g1, MSM_N),
                               ("bls12_381", bls12_381_g1, MSM_BLS_N)):
        curve = make(dev)
        t0 = time.perf_counter()
        # the device backend: a scalar_mul at width n_pts (K9)
        pts = curve.fixed_base_mul(list(range(1, n_pts + 1)))
        torch.cuda.synchronize()
        fbm_s = time.perf_counter() - t0
        if affine(curve, pts) != affine(curve, curve.fixed_base_mul(
                list(range(1, n_pts + 1)), backend="host")):
            raise AssertionError(f"phase 4: {cname} fixed_base_mul on the "
                                 "card != the host table")
        svals = [int(v) for v in
                 np.random.default_rng(7).integers(1, 1 << 62, n_pts)]
        scal = limbs_from_ints(svals, 8, dev)
        zero_counts()
        t0 = time.perf_counter()
        res = curve.msm(scal, pts)
        torch.cuda.synchronize()
        msm_s = time.perf_counter() - t0
        k9, k10 = PIPPENGER_LAUNCHES[n_pts]
        got = expect_counts(f"msm {cname} n={n_pts}", digits_mul_t=k9,
                            digits_mul=k10)
        if cname == "bn254":
            launches["digits_mul_t"] = got["digits_mul_t"]
            launches["digits_mul"] = got["digits_mul"]
        t0 = time.perf_counter()
        host = curve.msm(scal, pts, backend="host")
        host_s = time.perf_counter() - t0
        if affine(curve, res) != affine(curve, host):
            raise AssertionError(f"phase 4: msm {cname} n={n_pts} on the card "
                                 "!= the host Pippenger")
        msm_runs[cname] = (curve, scal, pts, msm_s)
        log(f"phase 4: msm {cname} n={n_pts}: fixed_base_mul on the card "
            f"{fbm_s:.3f} s (== host table); msm {msm_s:.4f} s, == host "
            f"Pippenger ({host_s:.2f} s); K9 launches {got['digits_mul_t']}, "
            f"K10 launches {got['digits_mul']}")

    # a 64-bit Bulletproofs range proof on the card (the JAX suite's
    # bp_range_prove_64 / bp_range_verify_64 rows), field for field equal
    # to the proof the port makes on the CPU from the same seed
    value = int.from_bytes(np.random.default_rng(9).bytes(8), "little")
    proofs, bp_secs = {}, {}
    for where in ("cuda", "cpu"):
        curve = bn254_g1(where)
        gens = BulletproofsGens.generate(curve, BP_BITS)
        prover = BulletproofsProver(curve, rng_seed=args.seed + 3)
        blinding = prover.random_scalar()
        com = prover.commit(value, blinding, gens)
        zero_counts()
        t0 = time.perf_counter()
        proof = prover.prove_range(value, blinding, BP_BITS, gens)
        if where == "cuda":
            torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        bp_counts = counts()
        verifier = BulletproofsVerifier(curve)
        t0 = time.perf_counter()
        ok = verifier.verify_range(com, proof, BP_BITS, gens)
        verify_s = time.perf_counter() - t0
        proofs[where] = (affine(curve, com.point), proof)
        bp_secs[where] = (prove_s, verify_s)
        if not ok:
            raise AssertionError(f"phase 4: the 64-bit proof made on {where} "
                                 "does not verify")
        if where == "cuda":
            if not (bp_counts["digits_mul_t"] and bp_counts["digits_mul"]) \
                    or any(v for k, v in bp_counts.items()
                           if not k.startswith("digits")):
                raise AssertionError(f"phase 4: prove_range launches "
                                     f"{bp_counts}")
            proof.t_hat = (proof.t_hat + 1) % curve.order
            if verifier.verify_range(com, proof, BP_BITS, gens):
                raise AssertionError("phase 4: a tampered proof verified")
            proof.t_hat = (proof.t_hat - 1) % curve.order
            log(f"phase 4: prove_range {BP_BITS} bits on the card: K9 "
                f"launches {bp_counts['digits_mul_t']}, K10 "
                f"{bp_counts['digits_mul']}; tampered t_hat refused")
    (com_g, pg), (com_c, pc) = proofs["cuda"], proofs["cpu"]
    fields = ("A", "S", "T1", "T2", "t_hat", "tau_x", "mu")
    if com_g != com_c or any(getattr(pg, k) != getattr(pc, k)
                             for k in fields) \
            or (pg.inner.L, pg.inner.R, pg.inner.a, pg.inner.b) != \
            (pc.inner.L, pc.inner.R, pc.inner.a, pc.inner.b):
        raise AssertionError("phase 4: the proof made on the card != the "
                             "proof made on the CPU")
    log(f"phase 4: {BP_BITS}-bit range proof: card == CPU field for field; "
        f"verifies on both; prove {bp_secs['cuda'][0]:.3f} s on the card, "
        f"{bp_secs['cpu'][0]:.3f} s on the CPU; verify "
        f"{bp_secs['cuda'][1]:.3f} s / {bp_secs['cpu'][1]:.3f} s")

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
                acc, rots, key.ggsw_kslabs, base_log), 2, warmup=1),
            plain_steps_ms,
            bound(steps * macs, io_bytes + 4 * BATCH * (steps - 1)
                  + key.ggsw_kslabs.numel(), peak_ops, peak_bytes),
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
        f"{b} {r:.2f}" for b, r in rates.items()))

    # the NTT kernels: at the TFHE_256 path's shapes (the JSON record), and
    # at the JAX bench's and the K4 "ntt" path's shapes
    kp256 = p256.glwe_dim + 1
    fwd_b = p256.pbs_level * TFHE256_BATCH * kp256
    inv_b = TFHE256_BATCH * kp256
    ntt_rows = []

    def time_ntt(kind, n, b, q, label):
        pk = pntt(n, q)
        a, c = rand_planes(b, n, q), rand_planes(b, n, q)
        if kind == "negacyclic_mul":
            run, plain = (lambda: pk.negacyclic_mul(a, c),
                          lambda: pk.ntt.negacyclic_mul(a, c))
        else:
            run = lambda: getattr(pk, kind)(a)
            plain = lambda: getattr(pk.ntt, kind)(a)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 2, warmup=1)
        b_ms, b_by = ntt_bound(kind, b, n, mul_rate, peak_bytes)
        ntt_rows.append((kind, label, n, b, ms, plain_ms, b_ms, b_by))
        log(f"phase 5: ntt {kind} {label} N={n} B={b}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            "library none (no PyTorch call computes an NTT mod q)")
        return ms, plain_ms, (b_ms, b_by), None

    times["ntt_forward"] = time_ntt("forward", 4096, fwd_b, P1,
                                    "TFHE_256 path P1")
    times["ntt_inverse"] = time_ntt("inverse", 4096, inv_b, P1,
                                    "TFHE_256 path P1")
    times["ntt_negacyclic_mul"] = time_ntt("negacyclic_mul", 4096,
                                           TFHE256_BATCH, P1,
                                           "ring multiply path P1")
    kp4 = pk4.glwe_dim + 1
    for kind, deg, b, q, label in (
            ("forward", 4096, fwd_b, P2, "TFHE_256 path P2"),
            ("inverse", 4096, inv_b, P2, "TFHE_256 path P2"),
            ("forward", pk4.poly_degree, pk4.pbs_level * NTT_BATCH * kp4,
             P_EXT, "K4 ntt path P_EXT"),
            ("inverse", pk4.poly_degree, NTT_BATCH * kp4, P_EXT,
             "K4 ntt path P_EXT"),
            ("forward", 1024, 8192, q40, "bench Q_40_1"),
            ("forward", 4096, 2048, q40, "bench Q_40_1"),
            ("forward", 16384, 512, q40, "bench Q_40_1"),
            ("forward", 16384, 512, q60, "bench Q_60_1"),
            ("inverse", 1024, 8192, q40, "bench Q_40_1"),
            ("inverse", 16384, 512, q40, "bench Q_40_1"),
            ("negacyclic_mul", 1024, 2048, q40, "bench poly_mul Q_40_1")):
        time_ntt(kind, deg, b, q, label)

    # one TFHE_256 "crt" step, split into its NTT launches and the plain
    # torch work around them
    acc256 = random_u32(gen, (TFHE256_BATCH, kp256, p256.poly_degree))
    rot256 = torch.randint(0, 2 * p256.poly_degree, (TFHE256_BATCH,),
                           generator=gen, dtype=torch.int32, device="cuda")
    row256 = tuple((lo[0], hi[0]) for lo, hi in key256.ggsw_crt)
    ctxs = (ring.ntt1.ctx, ring.ntt2.ctx)
    rotated = ring.rotate(acc256, rot256[:, None])
    digits = e256._digit_rows(rotated - acc256)
    dplanes = [ring._digits_to_planes(digits, t)
               for t in (ring.ntt1, ring.ntt2)]
    d_hat = ring.forward_digits(digits)
    accs = [ring._sum_products(ctxs[i], *e256._pair_rows(d_hat[i],
                                                        row256[i]), -3)
            for i in range(2)]
    rs = (ring.pntt1.inverse(accs[0]), ring.pntt2.inverse(accs[1]))
    parts = {
        "step": lambda: e256.cmux(row256, acc256, ring.rotate(
            acc256, rot256[:, None])),
        "rotate + difference": lambda: ring.rotate(
            acc256, rot256[:, None]) - acc256,
        "decompose": lambda: e256._digit_rows(rotated - acc256),
        "digits to planes": lambda: [ring._digits_to_planes(digits, t)
                                     for t in (ring.ntt1, ring.ntt2)],
        "K6 forward x2": lambda: (ring.pntt1.forward(dplanes[0]),
                                  ring.pntt2.forward(dplanes[1])),
        "pointwise products + sum": lambda: [
            ring._sum_products(ctxs[i], *e256._pair_rows(d_hat[i],
                                                         row256[i]), -3)
            for i in range(2)],
        "K7 inverse x2": lambda: (ring.pntt1.inverse(accs[0]),
                                  ring.pntt2.inverse(accs[1])),
        "CRT to torus": lambda: ring._crt_to_torus(*rs),
    }
    split = {k: cuda_ms(f, 5, warmup=1) for k, f in parts.items()}
    kernel_ms = split["K6 forward x2"] + split["K7 inverse x2"]
    log(f"phase 5: TFHE_256 crt step, batch {TFHE256_BATCH}: "
        f"{split['step']:.4f} ms; NTT launches {kernel_ms:.4f} ms = "
        f"{100 * kernel_ms / split['step']:.1f}% of the step; " + "; ".join(
            f"{k} {v:.4f} ms ({100 * v / split['step']:.1f}%)"
            for k, v in split.items() if k != "step"))

    # the digit kernels at the phase 2 shapes; the JSON rows at the main
    # path's shapes (K9 at its widest, B=131072; K10 at B=1, where 2480 of
    # its 2584 launches run)
    digit_times = {}
    for kind, shapes in digit_shapes.items():
        for f, b in shapes:
            a, c = rand_elems(f, b), rand_elems(f, b)
            if kind == "mul_t":
                aT, cT = a.T.contiguous(), c.T.contiguous()
                run = lambda: dp._mul_t_raw(f, aT, cT)
                plain = lambda: dp.mul_t_reference(f, aT, cT)
            else:
                run = lambda: dp.pallas_field_mul(f, a, c)
                plain = lambda: dp.field_mul_reference(f, a, c)
            ms = cuda_ms(run, 20)
            plain_ms = cuda_ms(plain, 3, warmup=1)
            b_ms, b_by = digits_bound(f.n_limbs, b, mul_rate, peak_bytes)
            digit_times[kind, f.n_limbs, b] = (ms, plain_ms, (b_ms, b_by),
                                               None)
            log(f"phase 5: digits {kind} D={f.n_limbs} B={b}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), library none (no PyTorch call computes a "
                "Montgomery product mod a 254- or 381-bit prime)")
    times["digits_mul_t"] = digit_times["mul_t", 32, 131072]
    times["digits_mul"] = digit_times["mul", 32, 1]
    # msm_bn254_4096: wall time of one call ending in a synchronize (its
    # split into the kernels and the rest comes from the profiler below)
    curve, scal, pts, _ = msm_runs["bn254"]
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        curve.msm(scal, pts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"phase 5: msm_bn254_4096 wall {[round(x, 4) for x in walls]} s; "
        f"BLS12-381 n={MSM_BLS_N} msm {msm_runs['bls12_381'][3]:.4f} s; "
        f"prove_range {BP_BITS} {bp_secs['cuda'][0]:.3f} s, verify_range "
        f"{bp_secs['cuda'][1]:.3f} s")
    # where one msm_bn254_4096 spends its time: every point op of one call
    # on the host clock between synchronizes, by kind and width (the rest
    # is the sorts, gathers and searches around them) ...
    ops = {}

    def timed(kind, fn):
        def run(*args):
            width = args[0][0].numel() // args[0][0].shape[-1]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            count, secs = ops.get((kind, width), (0, 0.0))
            ops[kind, width] = (count + 1, secs + time.perf_counter() - t)
            return out
        return run

    curve.add, curve.double = timed("add", curve.add), timed("double",
                                                             curve.double)
    t0 = time.perf_counter()
    curve.msm(scal, pts)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    del curve.add, curve.double             # the class's methods again
    in_ops = sum(s for _, s in ops.values())
    log(f"phase 5: msm_bn254_4096 by point op ({split_s:.4f} s with a "
        "synchronize around each op): " + "; ".join(
            f"{kind} at width {w}: {c} x {1e3 * s / c:.3f} ms = {s:.4f} s"
            for (kind, w), (c, s) in sorted(ops.items(),
                                            key=lambda kv: -kv[0][1]))
        + f"; outside the point ops {split_s - in_ops:.4f} s")
    # ... and, within one profiled call alone, the device time of K9
    # (mont_mul_kernel<L, true>), K10 (<L, false>) and every other kernel,
    # and the device's idle share of that call's wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        curve.msm(scal, pts)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    kernels = [(getattr(e, "self_device_time_total", 0), e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(k[0] for k in kernels)
    if busy_us:
        prof_us = prof_s * 1e6
        mont = {}
        for label, tag in (("K9", "true>"), ("K10", "false>")):
            mine = [k for k in kernels
                    if "mont_mul_kernel" in k[2] and tag in k[2]]
            mont[label] = (sum(k[0] for k in mine), sum(k[1] for k in mine))
        other_us = busy_us - mont["K9"][0] - mont["K10"][0]
        log(f"phase 5: msm_bn254_4096 under the profiler, one call of "
            f"{prof_s:.4f} s: device busy {busy_us / 1e6:.4f} s, idle share "
            f"{100 * (1 - busy_us / prof_us):.1f}%; " + "; ".join(
                f"{label} {us / 1e3:.3f} ms device in {cnt} launches "
                f"({us / max(cnt, 1):.2f} us each, "
                f"{100 * us / prof_us:.2f}% of the call)"
                for label, (us, cnt) in mont.items())
            + f"; other device kernels {other_us / 1e3:.2f} ms "
            f"({100 * other_us / prof_us:.1f}%) in "
            f"{sum(k[1] for k in kernels) - mont['K9'][1] - mont['K10'][1]}"
            " launches; the most time: " + "; ".join(
                f"{key[:60]} x{cnt} {us / 1e3:.2f} ms"
                for us, cnt, key in sorted(kernels)[::-1][:6]))
    else:
        log("phase 5: msm_bn254_4096 device split and idle share not "
            "measured (the profiler recorded no device events)")

    src = "node_fhe_accelerate_tpu_torch/csrc/"
    ref = "node_fhe_accelerate_tpu/ops/pallas_cmux.py:"
    ntt_ref = "node_fhe_accelerate_tpu/ops/ntt_pallas.py:"
    digits_ref = "node_fhe_accelerate_tpu/ops/digits_pallas.py:"
    table = [("cmux_step", "cmux_step.cu", ref + "144", "cmux_step"),
             ("cmux_step_slabs_v3", "cmux_step_slabs.cu", ref + "183", "v3"),
             ("cmux_step_slabs_v2", "cmux_step_slabs.cu", ref + "226", "v2"),
             ("ladder_tiles", "ladder_tiles.cu", ref + "282", "ladder_tiles"),
             ("ladder_steps", "ladder_steps.cu", ref + "459", "ladder_steps"),
             ("ntt_forward", "ntt.cu", ntt_ref + "179", "ntt"),
             ("ntt_inverse", "ntt.cu", ntt_ref + "179", "ntt"),
             ("ntt_negacyclic_mul", "ntt.cu", ntt_ref + "227", "ntt"),
             ("digits_mul_t", "digits.cu", digits_ref + "393", "digits"),
             ("digits_mul", "digits.cu", digits_ref + "252", "digits")]
    record = {"kernels": [{
        "name": kname, "route": "cuda", "source": src + source,
        "replaces": line, "launches": launches[kname],
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
