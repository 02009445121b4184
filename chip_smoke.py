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
   the big-integer oracle a*b*R^-1 mod q; K10's point kernel (a Jacobian
   add or double in one launch) on BN254 and BLS12-381 G1 points with the
   edge rows (p or q at infinity, p = q, p = -q) and on random elements at
   B = 1, 32 and 1000, against its plain version and against the formulas
   over the field on the CPU; K9 over Fq2 (``_TField2``: the digit-major
   G2 add and double the G2 MSM's 2048-point chunks take) at 2048 points
   and at a ragged 1000, against its plain version and the host G2 on the
   edge rows; the Fr NTT (one launch of K10's product a stage) forward
   and inverse at d = 4096 and 16384 against the port on the CPU; the NTT
   kernels (ntt.cu: forward, inverse, negacyclic product) at the JAX
   package's bench shapes (N=1024/B=8192, 4096/2048, 16384/512 with
   Q_40_1, 16384/512 with Q_60_1; the product at N=1024/B=2048, in both of
   its forms, and against the big-integer oracle on a few rows), at the
   bootstrap's shapes
   (P1 and P2 at N=4096/B=1536, P_EXT at N=256/B=2560), at the BFV
   stack's (the auxiliary primes of the rescale at N=1024 and 8192, Q_60_1
   at N=8192, the product over Q_40_1 at N=1024 and Q_60_1 at N=8192), at
   the public API's chains (BFV_128_SIMD's three primes and the seven
   auxiliary primes of its RnsRescaleMultiplier at N=8192, the product over
   its three primes at 2 and 6 rows; CKKS_128_ML's five primes at
   N=16384, both arithmetic forms), at every degree
   from N=4 to 16384 at a ragged batch, at a batch of 1, N=4 and 16384
   over Q_60_1 and over the largest modulus they take (2^62 - 2^16 + 1),
   and refusing the prime just above 2^62; then, at batch 4096,
   one CMux step through cmux_step and through cmux_step_slabs (v3, v2, on
   the K-major diagonal slabs of build_diag_kslabs, built once per phase)
   on a row of the committed TFHE_BOOT_128_K4 key (.keycache), on a
   TFHE_BOOT_128_L2-shaped row (k=1, N=1024), and on a TFHE_BOOT_128 row
   (k=1, N=1024, l=3, Bg=2^7, the entry's default) at 1024 rows (the
   benchmark's boot128_pbs_b1024 batch), and cmux_step again at a ragged
   batch of 4000; the whole ladder through ladder_tiles and ladder_steps
   over all 630 rows of the committed key, over a short ladder at the L2
   shape, and over a short ladder at TFHE_BOOT_128 on 1024 rows;
   ladder_tiles also on short ladders at batches of 1, 127 and 129 rows
   (one more than a 128-row tile) and at 0 and 1 steps; ladder_steps (on
   the K-major slabs of build_all_step_kslabs) also on a short
   truncated-key ladder (drop=1) and on a short ladder at the ragged
   batch;
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
   default_rng(7)) through the Pippenger, 504 K9 launches, 256 + 33
   point-kernel launches (the Horner tail's doubles and adds) and no K10
   single product, equal to the host Pippenger; the same at BLS12-381 G1
   with n=1024 (456 K9); and a 64-bit Bulletproofs range proof on the card
   (``BulletproofsGens.generate(curve, 64)``, a seeded prover, the value
   drawn as the JAX suite draws it), verifying, and refused once t_hat is
   tampered, and an 8-bit proof from the same seed on the card equal field
   for field to the proof the port makes on the CPU; each MSM is also held equal to the host's result by
   projective equality on the card (``Curve.eq``: 8 launches of K10's
   single product, which no MSM or proof launches any more); the MSMs
   inside the band 32 <= n_pad <= 1024 (BLS12-381 at n=1024, the proof's
   at n=256) race the Pippenger against the ladders once, before the
   counts (``Curve.msm_race``), each candidate's time must be finite, and
   the selection is printed;
   then the slice's entry and the BFV stack, counts likewise: the default
   constructor ``TfheEngine(TFHE_BOOT_128_K4())`` ("auto") at batch 4096,
   its race's ``selection_table`` (seconds per call of "pallas", "mxu",
   "pallas_fused" and "mxu_fused", each finite but "mxu_fused"'s when its
   slabs do not fit by the engine's rule read before the race, the winner
   a kernel backend) and one
   decode-checked bootstrap routed to the winner, bit-equal
   to the winner named explicitly and, rows 0-3, to the port on the CPU;
   the ballot shape of
   utils/bench_suite.py (N=1024, q=Q_40_1, t=64, noise from the parameter
   set): 3-of-5 threshold keys and a public key from a seeded generator,
   4096 one-hot ballots over 4 candidates encrypted (one K8 launch each;
   ballot 0 bit-equal to the port on the CPU from the same generator
   state), their ``batch_add`` tally decoded to the counts mod t, also
   3-of-5 through ``threshold``, 16 ``encrypt_with_proof`` that verify
   and a tampered ballot refused, and the tally's c0 through
   ``serialize_polynomial`` with LZ4 and back, ``quick_verify`` refusing
   a flipped byte; and BFV_128_SIMD's first modulus (N=8192, Q_60_1,
   t=65537): keys with a relin key, 8 ``multiply_relin_rescale`` of sparse
   messages (each K6/K7 on the 3 auxiliary primes and for relinearize),
   each decoded to the numpy negacyclic product mod t, product 0 bit-equal
   to the port on the CPU from the same generator state;
   then the public API over the whole chains, counts likewise:
   BFV_128_SIMD (N=8192, three 60-bit primes, t=65537) through
   ``FHEContext.create_simd`` (keys with the RNS relin key and 3-of-5
   shares, dense packed encryptions, an add, ``multiply`` at depth 1 and 2
   each decoded to the numpy negacyclic product mod t, the noise budgets,
   the product through the serializer and back, a 3-of-5 threshold
   decryption, the depth-1 product bit-equal to the port on the CPU from
   the same generator state), and the engine's own "auto" TfheEngine
   (n=630, N=1024, k=1): its race ("mxu_fused" running in it whenever its
   slabs fit by the engine's rule before the race), then
   ``programmable_bootstrap`` and ``bootstrap`` of 256 rows decoded,
   bit-equal to the winner named explicitly and, the NOT's rows 0-1, to
   the port on the CPU; CKKS_128_ML (N=16384, five primes)
   through
   ``CkksContext`` (8192 real slots, ``multiply`` from level 5 to 4 and 3
   and ``dot`` of three ciphertexts, each level's largest error, within
   atol 1e-3; the fused product bit-equal to the eager one on the card and
   to the port on the CPU on the same inputs);
   ``ChunkedCiphertextProcessor.chunked_multiply_raw`` at N=8192 over
   Q_60_1, bit-equal to ``multiply_raw``; and ``SpeculativePBS`` on the
   phase-4 K4 key through the default engine, 4 LUTs x 1024 rows bit-equal
   to four ``bootstrap_with_test_poly`` and ``run_all_funcs`` bit-equal to
   ``bootstrap_many_lut``;
   then the SNARK slice through the voting API, counts likewise:
   ``VotingSystem`` (4 candidates, TFHE_128_VOTING, 3-of-5,
   ``eligibility_snark=True``) with 256 registered voters (a Poseidon
   Merkle tree of depth 8; EligibilityCircuit(8), d = 4096), the Groth16
   setup on the card, the MSM band races of the path's curve objects
   once, 1 ballot (a Groth16 eligibility proof: G1 MSMs, the G2 MSM
   whose 2048-point chunk runs K9 over Fq2, the h-pipeline on the Fr NTT;
   an 8-bit range proof; one K8 ``encrypt_packed``), verifying, a
   second ballot of the voter refused (nullifier), swapped publics and a
   swapped proof refused, the tally decrypted 3-of-5 to the votes mod t;
   the exported package through ``PublicVerifier`` and through ``python
   -m node_fhe_accelerate_tpu_torch.cli verify`` (exit 0), one flipped
   proof digit failing it; ``ZKProofManager.init_tally(1024)`` and one
   PLONK tally proof (n = 2048, the quotient on 16,384 points) verifying,
   a wrong total refused; and seeded Groth16 (EligibilityCircuit(0), one
   voter, on the election prover's curve objects, whose band races it
   reuses) and PLONK (x*y = z) proofs on the card equal to the port's on
   the CPU;
5. timings with CUDA events for each kernel (kernel, plain version, its
   bound, and torch._int_mm on the same int8 contraction as a yardstick;
   the NTT kernels as device time of back-to-back launches, a spin kernel
   holding the stream while the host enqueues them, and their bound as
   the least modular products the transform needs, ``ntt_bound``;
   no PyTorch call computes an NTT mod q or a Montgomery product mod a
   254- or 381-bit prime, so the NTT and digit kernels have none), the key
   switch, bootstraps/s per backend, the time of one TFHE_256 "crt" step
   split into its NTT launches and the plain work around them, K10's point
   kernel at B = 1 and 32 (device time back to back and a call with the
   host's wrapper) beside the launch floor (an empty kernel back to back),
   the ballots encrypted per second and the tally's seconds, one
   ``multiply_relin_rescale`` at N=8192 split into its NTT launches, the
   digit work of RescaleMultiplier and the rest, and by device kernel
   under torch.profiler,
   ms per chain multiply at BFV_128_SIMD and per CKKS multiply at L=5
   and 4, ballots/s over the chain, each multiply once under
   torch.profiler (launches, the device's idle share),
   the wall time of msm_bn254_4096, its split by point op and width, and,
   within one call under torch.profiler, the device time and launches of
   K9, K10's single product and point kernel and the other kernels and the
   device's idle share, and the seconds of one 64-bit prove_range and
   verify_range; the seconds of the Groth16 setup, one eligibility proof
   and one verify, the PLONK tally's setup, prove and verify, one FrNtt
   forward at d = 4096 and 16384 (CUDA events), ballots with proofs per
   second, and one Groth16 proof under torch.profiler (launches and
   device time by kernel, the device's idle share);
6. the multi-device slice on a mesh of 4 positions (4 cards when the
   machine has them, else the first card four times; the log says which),
   after the timings, each item run once under device-only tracing (the
   device's busy time) and once alone with the counts set to 0 before and
   read after it (wall, launches, idle share, bytes moved between
   positions): the sharded bootstrap at TFHE_BOOT_128_K4, batch
   4096 (1024 a position, the key held once per distinct device) through
   "pallas_fused", "pallas" and "mxu_fused", each bit-equal to the
   unsharded bootstrap and decoded, 0 bytes between positions; the sharded
   tally (4096 one-hot ballots at the ballot shape, 1024 encrypted a
   position, reduced, joined by ``psum_mod``), bit-equal to the unsharded
   ``batch_add`` and decoded to the counts; ``DistPolyRing`` multiply at
   N=8192 (Q_40_1) and 16384 (Q_60_1) bit-equal to ``PolyRing.multiply``,
   ``EncryptionEngine`` over it at N=8192 (keys, 3 encryptions, tally,
   decrypt), and one CKKS_128_ML ``multiply_relin_rescale`` over five
   distributed primes, c0 bit-equal to the single-ring engine's, error
   below 1e-3; msm_bn254_4096 sharded (4 Pippengers of 1024 and the
   combine of 3 partial points) equal to the host Pippenger; ``MxuNTT`` at
   N=1024, batch 256, card == CPU and rows against the oracle;
   ``scaling_report`` (the sharded bootstrap through "pallas_fused" at 1,
   2 and 4 positions, 1024 a position, and the collective rows) and
   ``bench_suite`` (warmup 1, iters 2: memory, modmul, ntt, poly_mul and
   the pbs_n630_N256_l2_k4 rows, every row correct), written under
   build/chip_smoke/; and ``profiling.trace`` around one sharded
   bootstrap, whose Chrome trace must hold its CUDA kernel events.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import io
import json
import math
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
# FP64 fused multiply-adds per clock per SM on compute capability 9.0 (the
# same table); times the SM count and the clock gives the FP64 rate.
FP64_PER_SM_CLK = 64


# The least exact modular product I know of, per modulus: 2 L^2 32-bit
# multiplies for an L-limb modulus (L = 2 for the NTT moduli, 33 to 62
# bits: the product of two L-limb residues, L^2 32 x 32 -> 64 partial
# products of two multiplies each, reduced by shifts and adds, every NTT
# modulus here being 2^a - 2^b + 1), and below 2^46 also 6 FP64 operations
# on the FP64 pipes (csrc/ntt.cu's narrow form), which can run beside the
# integer ones.  The kernels' wide form takes about 15 multiplies.
def modmul_rate(q, mul_rate, fp64_rate):
    """Modular products per second with both pipes at their least work."""
    limbs = -(-q.bit_length() // 32)
    return (mul_rate / (2 * limbs * limbs)
            + (fp64_rate / 6 if q < 1 << 46 else 0))


# the BFV rings (N, q, t): the ballot shape of utils/bench_suite.py (N=1024,
# q = Q_40_1, t = 64) and BFV_128_SIMD's first modulus (N=8192, Q_60_1,
# t = 65537), as EncryptionEngine takes it
BFV_RINGS = ((1024, 1095216660481, 64), (8192, 1152921504606584833, 65537))
BALLOTS = 4096
CANDIDATES = 4
PROOFS = 16
SIMD_PRODUCTS = 8
CHAIN_BALLOTS = 64       # one-hot ballots encrypted over BFV_128_SIMD's chain
MANY_LUT_MIN_OK = 4094   # of run_all_funcs's 4 x 1,024 values at K4, seed 0
MSM_N = 4096             # the JAX suite's msm_bn254_4096 row
MSM_BLS_N = 1024
BP_BITS = 64             # the JAX suite's bp_range_prove_64 row
BP_CMP_BITS = 8          # the range proof held card == CPU
# launches of one Pippenger (c = 8, W = 32 windows of 8-limb scalars): the
# wide adds of the group scans (log2 8 + ceil(log2(n/8)) + 1 bucket gather +
# 8 bucket scans, at least 2048 points each) take K9, 24 products an add;
# the narrow tail (8 + 31*8 doubles and 2 + 31 adds at widths 32 and 1)
# takes the point kernel, one launch an op, and no single product:
# (K9, K10 products, point-kernel adds, point-kernel doubles)
PIPPENGER_LAUNCHES = {4096: (24 * (3 + 9 + 1 + 8), 0, 33, 256),
                      1024: (24 * (3 + 7 + 1 + 8), 0, 33, 256)}


def rescale_bound_bits(n, q):
    """Bits of the auxiliary CRT basis of RescaleMultiplier(n, q, t)."""
    return n.bit_length() + 2 * q.bit_length() + 2


# launches of one Pippenger-vs-ladder band candidate at n = 1024 (K9, K10
# products, point-kernel adds, point-kernel doubles): the ladder is a
# scalar_mul at width 1024 (the point kernel: 14 table adds, 64 rounds of 4
# doubles and an add) and 10 adds of the tree reduction
LADDER_LAUNCHES = {1024: (0, 0, 14 + 64 + 10, 256)}


def variant(name: str) -> str:
    for tag in ("H200", "NVL", "PCIe"):
        if tag in name:
            return "H200" if tag == "H200" else f"H100 {tag}"
    return "H100 SXM"


_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, prefixed with the seconds since the run began."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


def bound(macs, nbytes, peak_ops, peak_bytes):
    """Least time in ms for `macs` int8 MACs (2 ops each) at the int8 peak
    and `nbytes` at the memory rate; the larger wins."""
    t_ops, t_bytes = 2 * macs / peak_ops, nbytes / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ntt_bound(kind, b, n, q, mul_rate, fp64_rate, peak_bytes):
    """(ms, bound_by) of one NTT launch over b polynomials of degree n mod
    q: the modular products the function needs at ``modmul_rate`` against
    its bytes (each input plane read once, each output plane written once)
    at the memory rate.  Products: (n/2) log n butterflies a forward; an
    inverse adds n/2 for the N^-1 scale folded into its last stage; the
    ring product is two forwards, n pointwise products and an inverse."""
    logn = n.bit_length() - 1
    butterflies = b * (n // 2) * logn
    if kind == "forward":
        products, nbytes = butterflies, 16 * b * n
    elif kind == "inverse":
        products, nbytes = butterflies + b * n // 2, 16 * b * n
    else:
        products, nbytes = 3 * butterflies + 3 * b * n // 2, 24 * b * n
    t_ops = products / modmul_rate(q, mul_rate, fp64_rate)
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


def point_bound(op, d, b, mul_rate, peak_bytes):
    """(ms, bound_by) of one point-kernel launch over b points of d 8-bit
    digits held as int32: its planes read (6 an add, 3 a double) and 3
    written, 4 d bytes each, against the 32-bit multiplies of its CIOS
    products at the INT32 rate (as ``digits_bound``): 16 an add on these
    inputs (the double's 7 more only where p = q, which no timed row
    holds), 7 a double."""
    L = d // 4
    products, planes = (16, 9) if op == "add" else (7, 6)
    t_ops = 2 * (2 * L * L + L) * products * b / mul_rate
    t_bytes = 4 * d * planes * b / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def step_work(b, kp1, n, lvl, planes):
    """(int8 MACs, bytes) of one CMux step apart from its weights: the
    contraction, and acc in, out and rot."""
    return (b * (lvl * kp1 * n) * (kp1 * planes * n),
            2 * b * kp1 * n * 4 + b * 4)


def cmux_entry(line):
    """'P=p[ v3|v2]' of a CMux kernel's entry (v3/v2: the tile order of
    the slab kernel)."""
    m = re.search(r"_kernelILi(\d+)E(?:Lb([01])E)?", line)
    return (f"P={m.group(1)}" + {"1": " v3", "0": " v2"}.get(m.group(2), "")
            if m else "kernel")


def ntt_entry(line):
    """'forward|inverse|mul log N [f64|shoup]' of an entry of csrc/ntt.cu
    (the arithmetic form)."""
    m = re.search(r"ntt_(transform|negacyclic_mul)_kernelILi(\d+)E"
                  r"(?:Lb([01])E)?(?:\w*?(F64|Shoup)Arith)?", line)
    if not m:
        return None
    kind = ("mul" if m.group(1) == "negacyclic_mul" else
            "inverse" if m.group(3) == "1" else "forward")
    return (f"{kind} {m.group(2)}"
            + {"F64": " f64", "Shoup": " shoup"}.get(m.group(4), ""))


def digits_entry(line):
    """'mul L=l digit-major|row-major' or 'point L=l add|double' of an
    entry of csrc/digits.cu."""
    m = re.search(r"(mont_mul|point)_kernelILi(\d+)ELb([01])E", line)
    if not m:
        return None
    kind = ({"1": "digit-major", "0": "row-major"} if m.group(1) == "mont_mul"
            else {"1": "add", "0": "double"})[m.group(3)]
    return f"{'mul' if m.group(1) == 'mont_mul' else 'point'} " \
        f"L={m.group(2)} {kind}"


def ptxas_summary(text, entry=cmux_entry):
    """'<entry>: R registers, S bytes spilled, F bytes stack' per entry
    function of a ptxas -v log, named by ``entry`` (a stack frame means
    values left the registers)."""
    out, name, stack, spill = [], None, 0, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = entry(line)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled, {stack} bytes stack")
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


def nonzero(counts):
    """The launch counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


# what "auto" routes a bootstrap to on the card, and the ladder launches
# of one call there
PBS_KERNEL_LAUNCHES = {"pallas": ("cmux_step", 630),
                       "pallas_fused": ("ladder_tiles", 1),
                       "mxu_fused": ("ladder_steps", 1)}


def check_race(path, sel, may_sit_out=()):
    """A race on the card: every candidate but those of ``may_sit_out``
    must have run (a time that is finite)."""
    if not all(math.isfinite(v) for k, v in sel["timings"].items()
               if k not in may_sit_out):
        raise AssertionError(f"phase 4: {path} race {sel}: a candidate did "
                             "not run")


def fused_may_sit_out(need, share):
    """(("mxu_fused",) when the engine's own memory rule (K-major slabs of
    ``need`` bytes within ``share`` of the free memory), read now, keeps
    it from building the slabs, else (); the line that says so): read
    before a race, so that "mxu_fused" must run whenever its slabs fit."""
    import torch
    free = torch.cuda.mem_get_info()[0]
    fits = need <= share * free
    return (() if fits else ("mxu_fused",)), (
        f"K-major slabs {need / 1e9:.2f} GB, {free / 1e9:.2f} GB free "
        f"before the race: mxu_fused {'must run' if fits else 'may sit out'}")


def same_lwe(x, y):
    import torch
    return torch.equal(x.a, y.a) and torch.equal(x.b, y.b)


def device_trace(fn, devices=(None,)):
    """One call of ``fn`` under torch.profiler with device activity only,
    ending in a synchronize of each of ``devices`` (the current card by
    default): (result, wall s, [(device us, launches, kernel)] by device
    time, largest first), read from the profiler's raw events
    (key_averages builds a Python event tree over every event, which takes
    minutes at 10^5-10^6 launches).  The profiler slows the host: a caller
    divides the busy time by the wall of a call without it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        for d in devices:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return out, wall, sorted(((us, n, name) for name, (us, n)
                              in by_name.items()), reverse=True)


def profile_call(fn):
    """``device_trace`` of one call: (wall s under the profiler,
    device-busy us, device launches, [(us, count, kernel)] largest first);
    busy 0 where the profiler recorded no device events."""
    _, wall, kern = device_trace(fn)
    return wall, sum(k[0] for k in kern), sum(k[1] for k in kern), kern


def profile_line(label, fn, plain_ms):
    """A log line of ``profile_call``: busy, launches, the NTT kernels'
    share and the kernels that took the most time.  The profiler slows the
    host, so the idle share is the busy time over ``plain_ms``, the same
    call's wall without the profiler (by CUDA events)."""
    wall, busy, count, kern = profile_call(fn)
    if not busy:
        return (f"phase 5: {label} device split not measured (the profiler "
                "recorded no device events)")
    ntt = sum(k[0] for k in kern if "ntt_" in k[2].lower())
    return (f"phase 5: {label} under the profiler, one call of "
            f"{wall * 1e3:.2f} ms ({plain_ms:.2f} ms without it): device "
            f"busy {busy / 1e3:.3f} ms, idle share "
            f"{100 * (1 - busy / (plain_ms * 1e3)):.1f}% of the call without "
            f"the profiler ({100 * (1 - busy / (wall * 1e6)):.1f}% under "
            f"it); {count} device launches; NTT (K6/K7/K8) "
            f"{ntt / 1e3:.3f} ms ({100 * ntt / busy:.1f}% of busy); the most "
            "time: " + "; ".join(f"{key[:60]} x{cnt} {us / 1e3:.3f} ms"
                                 for us, cnt, key in kern[:5]))


ELECTION_VOTERS = 256      # tree depth 8, ZKProofManager's default
ELECTION_VOTES = [3]       # ~33 s a ballot on the card: G2 is host-bound
TALLY_BALLOTS = 1024       # n = 2048, the quotient on 16,384 points
FR_NTT_SIZES = (4096, 16384)
PROFILE_BEFORE_S = 950     # the proof under the profiler takes ~1-2 min
SEEDED_DEPTH = 0           # the seeded Groth16's tree: one voter


def snark_counts():
    """The launch counts of the kernels the SNARK slice runs."""
    from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
    from node_fhe_accelerate_tpu_torch.ops.ntt_pallas import PallasNTT
    return {"ntt_negacyclic_mul": PallasNTT.launches["negacyclic_mul"],
            "digits_mul_t": dp._mul_t_raw.launches,
            "digits_mul": dp.pallas_field_mul.launches,
            "digits_jadd": dp.pallas_jadd.launches,
            "digits_jdbl": dp.pallas_jdbl.launches}


def g2_edge_pairs(g2h, width):
    """``width`` G2 point pairs (P_i = [i+1]G2, Q_i = [width+7+i]G2) with
    the edge rows of the group law first: Q = P, Q = -P, P at infinity, Q
    at infinity (host affine FQ2 pairs)."""
    from node_fhe_accelerate_tpu_torch.zk import pairing as pr
    p_aff = g2h.fixed_base_affine_host(list(range(1, width + 1)))
    q_aff = g2h.fixed_base_affine_host(list(range(width + 7,
                                                  2 * width + 7)))
    q_aff[0] = p_aff[0]
    q_aff[1] = pr.g2_neg(p_aff[1])
    p_aff[2] = None
    q_aff[3] = None
    return p_aff, q_aff


def snark_phase2(dev, seed, worse):
    """Phase 2 of the SNARK slice: K9 over Fq2 (``_TField2``: the
    digit-major point ops ``pallas_jadd_t``/``pallas_jdbl_t`` on G2 points)
    against its plain version at the G2 MSM's 2048-point chunk and at a
    ragged width, rows against the host G2; and the Fr NTT (one K10
    product a stage) at d = 4096 and 16384 on the card against the port on
    the CPU.  Returns the FrNtt objects on the card."""
    import numpy as np
    import torch
    from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
    from node_fhe_accelerate_tpu_torch.zk import pairing as pr
    from node_fhe_accelerate_tpu_torch.zk.curve_g2 import bn254_g2
    from node_fhe_accelerate_tpu_torch.zk.field import bn254_fr
    from node_fhe_accelerate_tpu_torch.zk.fr_ntt import FrNtt

    g2c, g2h = bn254_g2(dev), bn254_g2("cpu")
    for width in (2048, 1000):
        p_aff, q_aff = g2_edge_pairs(g2h, width)
        P, Q = g2c.from_affine_pairs(p_aff), g2c.from_affine_pairs(q_aff)
        Pc, Qc = g2h.from_affine_pairs(p_aff), g2h.from_affine_pairs(q_aff)
        k9 = dp._mul_t_raw.launches
        add = dp.pallas_jadd_t(g2c.fq, P, Q)
        dbl = dp.pallas_jdbl_t(g2c.fq, P)
        torch.cuda.synchronize()
        k9 = dp._mul_t_raw.launches - k9
        if not k9:
            raise AssertionError("phase 2 K9 over Fq2: no K9 launch")
        for op, got, want in (("jadd_t", add, dp.pallas_jadd_t(g2h.fq, Pc,
                                                                Qc)),
                              ("jdbl_t", dbl, dp.pallas_jdbl_t(g2h.fq, Pc))):
            for i, (g, w) in enumerate(zip(got, want)):
                worse("digits", check_equal(
                    f"K9 over Fq2 (_TField2) {op} G2 width {width} "
                    f"coordinate {i}", g.cpu(), w))
        s_aff = g2c.to_affine_pairs(add)
        d_aff = g2c.to_affine_pairs(dbl)
        for i in list(range(6)) + [width - 1]:
            want_s = pr.g2_add(p_aff[i], q_aff[i])
            want_d = None if p_aff[i] is None else pr.g2_double(p_aff[i])
            if (s_aff[i] != want_s) or (d_aff[i] != want_d):
                raise AssertionError(f"phase 2 K9 over Fq2 width {width}: "
                                     f"row {i} != the host G2")
        log(f"phase 2 K9 over Fq2: G2 add and double at width {width}, "
            f"{k9} K9 launches, == the plain version (bit-exact), edge rows "
            "(Q = P, Q = -P, P or Q at infinity) and the last row == the "
            "host G2")
    rng = np.random.default_rng(seed + 12)
    ntts = {}
    for d in FR_NTT_SIZES:
        fg, fc = FrNtt(bn254_fr(dev), d), FrNtt(bn254_fr("cpu"), d)
        vals = [int.from_bytes(rng.bytes(40), "little") % fg.f.q
                for _ in range(d)]
        a_g, a_c = fg.f.encode(vals), fc.f.encode(vals)
        k10 = dp.pallas_field_mul.launches
        fwd = fg.forward(a_g)
        inv = fg.inverse(fwd)
        torch.cuda.synchronize()
        k10 = dp.pallas_field_mul.launches - k10
        if k10 != 2 * fg.logd + 1:
            raise AssertionError(f"phase 2 FrNtt d={d}: {k10} K10 launches, "
                                 f"expected {2 * fg.logd + 1}")
        fwd_c = fc.forward(a_c)
        worse("digits", check_equal(f"FrNtt forward d={d} (card vs CPU)",
                                    fwd.cpu(), fwd_c))
        worse("digits", check_equal(f"FrNtt inverse d={d} (card vs CPU)",
                                    inv.cpu(), fc.inverse(fwd_c)))
        if not torch.equal(inv.cpu(), a_c):
            raise AssertionError(f"phase 2 FrNtt d={d}: inverse(forward(a))"
                                 " != a")
        ntts[d] = (fg, a_g)
        log(f"phase 2 FrNtt d={d}: forward and inverse on the card == the "
            f"port on the CPU, inverse(forward(a)) == a; {k10} K10 product "
            "launches (one a stage, one for d^-1)")
    return ntts


def snark_phase4(dev, zero_counts, counts, voters=ELECTION_VOTERS,
                 votes=ELECTION_VOTES, tally_n=TALLY_BALLOTS):
    """Phase 4 of the SNARK slice: the election with eligibility SNARKs
    through the voting API, its exported package through PublicVerifier
    and the CLI, the PLONK tally proof, and the seeded Groth16 and PLONK
    proofs on the card against the port on the CPU.  Returns the timings,
    launch counts and objects phase 5 reads."""
    import contextlib
    import io
    import json
    import tempfile

    import torch
    from node_fhe_accelerate_tpu_torch import cli
    from node_fhe_accelerate_tpu_torch.api.verify import (PublicVerifier,
                                                          VerificationPackage)
    from node_fhe_accelerate_tpu_torch.api.voting import VotingSystem
    from node_fhe_accelerate_tpu_torch.api.zk import (TallyCorrectnessProof,
                                                      ZKProofManager)
    from node_fhe_accelerate_tpu_torch.ops.limbs import limbs_from_ints
    from node_fhe_accelerate_tpu_torch.utils.dispatch import (
        global_dispatcher)
    from node_fhe_accelerate_tpu_torch.zk import circuits, groth16
    from node_fhe_accelerate_tpu_torch.zk import plonk
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    races0 = dict(global_dispatcher().selection_table())
    out = {"secs": {}}
    secs = out["secs"]
    # the election: 256 voters (tree depth 8), 3-of-5 keys at
    # TFHE_128_VOTING, the Groth16 setup on the card at start_election
    t0 = time.perf_counter()
    vs = VotingSystem("chip-smoke", num_candidates=4, threshold=(3, 5),
                      eligibility_snark=True, device=dev)
    for i in range(voters):
        vs.register_voter(f"voter-{i}")
    secs["election keys and registration"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs.start_election()
    sync()
    secs["groth16 setup"] = time.perf_counter() - t0
    r1cs = vs._elig_setup.r1cs
    d = groth16._domain_size(r1cs)
    log(f"phase 4 election: {voters} voters, EligibilityCircuit("
        f"{vs._elig_circuit.depth}): {r1cs.num_constraints} constraints, "
        f"{r1cs.num_vars} wires, d = {d}; Groth16 setup on the card "
        f"{secs['groth16 setup']:.2f} s")
    # the MSM band races of the path's curve objects, once, outside the
    # counts: the prover's G1 and G2 MSMs end in a 512-point tail, the
    # verifier's and the range proofs' MSMs pad to 256
    prover = vs._elig_prover
    t0 = time.perf_counter()
    for curve, n_pad in ((prover.curve, 512), (prover._g2(), 512),
                         (vs._elig_verifier.curve, 256),
                         (vs.bp_prover.curve, 256)):
        disp, op = curve.msm_race()
        scal = limbs_from_ints(list(range(3, 3 + n_pad)), 8, dev)
        pts = curve.generator((n_pad,))
        disp.selection_for(op, scal, tuple(c.contiguous() for c in pts))
    sync()
    secs["band races"] = time.perf_counter() - t0
    # each ballot's eligibility proof timed inside submit_ballot
    proof_s = []
    real_prove = prover.prove

    def timed_prove(*a, **kw):
        t = time.perf_counter()
        got = real_prove(*a, **kw)
        sync()
        proof_s.append(time.perf_counter() - t)
        return got

    prover.prove = timed_prove
    zero_counts()
    ballots, ballot_s = [], []
    for i, v in enumerate(votes):
        t0 = time.perf_counter()
        ballots.append(vs.submit_ballot(f"voter-{i}", v))
        sync()
        ballot_s.append(time.perf_counter() - t0)
    del prover.prove
    secs["groth16 proof"] = proof_s
    t0 = time.perf_counter()
    ok = [vs.verify_ballot(b) for b in ballots]
    secs["verify_ballot"] = (time.perf_counter() - t0) / len(ballots)
    out["launches"] = counts()
    if not all(ok):
        raise AssertionError(f"phase 4 election: verify_ballot {ok}")
    if on_card:
        got = snark_counts()
        missing = [k for k, v in got.items() if not v]
        if missing:
            raise AssertionError(f"phase 4 election: kernels {missing} were "
                                 f"not launched ({got})")
        if got["ntt_negacyclic_mul"] != len(votes):
            raise AssertionError(f"phase 4 election: {got['ntt_negacyclic_mul']}"
                                 f" K8 launches for {len(votes)} ballots")
    secs["ballot"] = ballot_s
    try:
        vs.submit_ballot("voter-0", 1)
        raise AssertionError("phase 4 election: a second ballot of voter-0 "
                             "was taken")
    except ValueError as e:
        if "nullifier" not in str(e):
            raise
    b0 = ballots[0]
    pubs = b0.eligibility_publics
    b0.eligibility_publics = [pubs[0], (pubs[1] + 1) % groth16.R]
    refused_pub = not vs.verify_ballot(b0)
    b0.eligibility_publics = pubs
    good = b0.eligibility_proof
    b0.eligibility_proof = groth16.Groth16Proof(a=good.c, b=good.b, c=good.a)
    refused_proof = not vs.verify_ballot(b0)
    b0.eligibility_proof = good
    if not (refused_pub and refused_proof and vs.verify_ballot(b0)):
        raise AssertionError("phase 4 election: swapped publics or a swapped "
                             "proof verified")
    vs.end_election()
    counts_dec = vs.decrypt_tally([1, 3, 5])
    t_mod = vs.ctx.engine.params.plaintext_modulus
    want = [votes.count(c) % t_mod for c in range(4)]
    if [int(c) for c in counts_dec] != want:
        raise AssertionError(f"phase 4 election: tally {counts_dec} != "
                             f"{want}")
    log(f"phase 4 election: {len(votes)} ballots (Groth16 eligibility, "
        f"8-bit range proof, one-hot encryption) in "
        f"{[round(x, 3) for x in ballot_s]} s (the eligibility proofs "
        f"{[round(x, 3) for x in proof_s]} s), each verifies "
        f"({secs['verify_ballot']:.3f} s a ballot); a second ballot of the "
        f"same voter refused (nullifier); swapped publics and a swapped "
        f"proof refused; tally 3-of-5 {list(map(int, counts_dec))} == "
        f"{want}; launches {nonzero(out['launches'])}")
    # the exported package: PublicVerifier, then the CLI in a process of
    # its own, and one flipped proof byte
    pkg = VerificationPackage.from_voting_system(vs)
    raw = pkg.to_json()
    t0 = time.perf_counter()
    res = PublicVerifier(device=dev).verify_all(
        VerificationPackage.from_json(raw, device=dev))
    secs["public verify"] = time.perf_counter() - t0
    if not (res.valid and res.ballots_valid == len(votes)):
        raise AssertionError(f"phase 4 package: PublicVerifier {res}")
    with tempfile.TemporaryDirectory() as tmp:
        good_path = os.path.join(tmp, "package.json")
        bad_path = os.path.join(tmp, "tampered.json")
        with open(good_path, "w") as fh:
            fh.write(raw)
        d_raw = json.loads(raw)
        x = d_raw["ballots"][0]["eligibility"]["c"][0]
        d_raw["ballots"][0]["eligibility"]["c"][0] = \
            x[:-1] + str((int(x[-1]) + 1) % 10)
        with open(bad_path, "w") as fh:
            fh.write(json.dumps(d_raw))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "node_fhe_accelerate_tpu_torch.cli",
             "verify", good_path, "--quiet", "--device", str(dev)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        secs["cli verify"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 4 package: the CLI exited "
                                 f"{proc.returncode}: {proc.stdout[-800:]}"
                                 f"{proc.stderr[-800:]}")
        with contextlib.redirect_stdout(io.StringIO()):
            rc_bad = cli.main(["verify", bad_path, "--quiet", "--device",
                               str(dev)])
        if rc_bad == 0:
            raise AssertionError("phase 4 package: a flipped proof byte "
                                 "verified")
    log(f"phase 4 package: {len(raw)} bytes of JSON; PublicVerifier "
        f"{res.ballots_valid}/{res.ballots_checked} valid in "
        f"{secs['public verify']:.2f} s; `python -m "
        f"node_fhe_accelerate_tpu_torch.cli verify` exit 0 in "
        f"{secs['cli verify']:.2f} s (its own process: start, build, "
        f"races); one flipped proof digit: exit {rc_bad}")
    # the PLONK tally proof over 1024 ballots (n = 2048, the quotient on
    # 16,384 points) through ZKProofManager
    mgr = ZKProofManager(device=dev)
    t0 = time.perf_counter()
    mgr.init_tally(tally_n)
    sync()
    secs["plonk setup"] = time.perf_counter() - t0
    vals = [(7 * i + 3) % 5 for i in range(tally_n)]
    zero_counts()
    t0 = time.perf_counter()
    tproof = mgr.prove_tally_correctness(vals, sum(vals))
    sync()
    secs["plonk prove"] = time.perf_counter() - t0
    out["plonk launches"] = counts()
    t0 = time.perf_counter()
    tres = mgr.verify_tally_correctness(tproof)
    secs["plonk verify"] = time.perf_counter() - t0
    wrong = mgr.verify_tally_correctness(TallyCorrectnessProof(
        proof=tproof.proof, total=tproof.total + 1,
        num_ballots=tproof.num_ballots))
    if not tres.valid or wrong.valid:
        raise AssertionError(f"phase 4 PLONK tally: {tres}, wrong total "
                             f"{wrong}")
    setup_n = mgr._tally[4].n
    log(f"phase 4 PLONK tally: {tally_n} ballots, {len(mgr._tally[0].gates)}"
        f" gates, n = {setup_n}, quotient on {8 * setup_n} points; setup "
        f"{secs['plonk setup']:.2f} s, prove {secs['plonk prove']:.2f} s, "
        f"verify {secs['plonk verify']:.3f} s; a wrong total refused; "
        f"prove launches {nonzero(out['plonk launches'])}")
    # seeded proofs: Groth16 at EligibilityCircuit(0) (one registered
    # voter: the root is its leaf; 491 wires, so its G2 MSM pads to the
    # 512 points whose band race the election ran on the same curve
    # objects) and PLONK at the 4-gate x*y = z, on the card and in the port
    # on the CPU
    proofs = {}
    for where in (dev, torch.device("cpu")):
        circ = circuits.EligibilityCircuit(SEEDED_DEPTH, device=where)
        wit = circ.generate_witness(12345, 67890, [], [], circ.leaf(12345))
        gp = groth16.Groth16Prover(rng_seed=5, device=where)
        if where == dev and on_card:
            gp.curve, gp._g2_curve = prover.curve, prover._g2()
        t0 = time.perf_counter()
        gs = gp.setup(circ.r1cs)
        g_proof = gp.prove(gs, wit.assignment)
        g_s = time.perf_counter() - t0
        if not groth16.Groth16Verifier(where).verify(gs, wit.public_inputs,
                                                     g_proof):
            raise AssertionError(f"phase 4 seeded Groth16 on {where}: does "
                                 "not verify")
        pc = plonk.PlonkCircuit()
        z = pc.public_input()
        x_, y_ = pc.new_var(), pc.new_var()
        xy = pc.mul(x_, y_)
        pc.assert_equal(xy, z)
        pp = plonk.PlonkProver(rng_seed=3, device=where)
        ps = pp.setup(pc, kzg_seed=1)
        p_proof = pp.prove(ps, {z: 42, x_: 6, y_: 7, xy: 42}, [42])
        if not plonk.PlonkVerifier(where).verify(ps, [42], p_proof):
            raise AssertionError(f"phase 4 seeded PLONK on {where}: does "
                                 "not verify")
        proofs[where.type] = (g_proof, p_proof, g_s)
    (gc, pcd, gcs), (gh, ph, ghs) = proofs[dev.type], proofs["cpu"]
    same_g = (gc.a, gc.c) == (gh.a, gh.c) and gc.b == gh.b
    same_p = pcd.commits == ph.commits and pcd.evals == ph.evals
    if not (same_g and same_p):
        raise AssertionError(f"phase 4 seeded proofs: card != CPU (Groth16 "
                             f"{same_g}, PLONK {same_p})")
    log(f"phase 4 seeded proofs: Groth16 at EligibilityCircuit("
        f"{SEEDED_DEPTH}) (setup + "
        f"prove {gcs:.2f} s on the card, {ghs:.2f} s on the CPU) and PLONK "
        "at x*y = z: the card's proofs == the port's on the CPU, field for "
        "field; both verify")
    races = {k: v for k, v in global_dispatcher().selection_table().items()
             if k not in races0 and k[0].startswith("msm_")}
    out["races"] = races
    race_s = sum(4 * sum(v["timings"].values()) for v in races.values())
    log(f"phase 4 SNARK path: {len(races)} MSM band races (keyed on the "
        f"curve object and shape; ~{race_s:.1f} s of candidate calls, 4 a "
        "candidate): " + "; ".join(
            f"n={k[1][0][0]} -> {v['winner']} (" + ", ".join(
                f"{c} {t:.3f} s" for c, t in v["timings"].items()) + ")"
            for k, v in races.items()))
    out.update(vs=vs, prover=prover, ballots=ballots, mgr=mgr,
               tproof=tproof, vals=vals)
    return out


def snark_phase5(dev, res, ntts):
    """Phase 5 of the SNARK slice: the seconds of the Groth16 setup, proof
    (each ballot's, timed in phase 4) and verify, PLONK setup/prove/verify,
    FrNtt forward at each size (CUDA events), ballots with proofs per
    second, and one Groth16 proof under the profiler (device activity
    only: launches and device time by kernel, the top kernels, and the
    device's idle share of the proof's wall without the profiler)."""
    from node_fhe_accelerate_tpu_torch.timing import cuda_ms
    from node_fhe_accelerate_tpu_torch.zk import groth16
    secs = res["secs"]
    vs, prover = res["vs"], res["prover"]
    setup = vs._elig_setup
    circ = vs._elig_circuit
    # voter 0's witness again, for a verify and the profiled proof
    f = vs.poseidon.f
    idx = vs._elig_order.index("voter-0")
    path = [int(f.decode(s[None])[0]) for s in vs._voter_tree.path(idx)]
    root = int(f.decode(vs._voter_tree.root[None])[0])
    wit = circ.generate_witness(vs._vid("voter-0"), vs._voters["voter-0"],
                                path, [(idx >> k) & 1
                                       for k in range(circ.depth)], root)
    b0 = res["ballots"][0]
    t0 = time.perf_counter()
    ok = vs._elig_verifier.verify(setup, b0.eligibility_publics,
                                  b0.eligibility_proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("phase 5: the eligibility proof does not "
                             "verify")
    ntt_ms = {d: cuda_ms(lambda: fg.forward(a), 5, warmup=1)
              for d, (fg, a) in ntts.items()}
    prove_s = secs["groth16 proof"]
    ballot_rate = len(secs["ballot"]) / sum(secs["ballot"])
    log(f"phase 5 SNARK: Groth16 (d = {groth16._domain_size(setup.r1cs)}) "
        f"setup {secs['groth16 setup']:.3f} s, one proof "
        f"{[round(x, 3) for x in prove_s]} s, one verify {verify_s:.3f} s; "
        f"PLONK tally ({TALLY_BALLOTS} ballots) setup "
        f"{secs['plonk setup']:.3f} s, prove {secs['plonk prove']:.3f} s, "
        f"verify {secs['plonk verify']:.3f} s; FrNtt forward " + ", ".join(
            f"d={d} {ms:.3f} ms" for d, ms in ntt_ms.items())
        + f"; ballots with proofs {ballot_rate:.4f}/s "
        f"({[round(x, 3) for x in secs['ballot']]} s each); the band races "
        f"{secs['band races']:.2f} s once")
    # a proof launches some 10^5-10^6 kernels; skipped, and said so, where
    # the run has too little of its time limit left for it
    if time.perf_counter() - _START > PROFILE_BEFORE_S:
        log(f"phase 5 SNARK: Groth16 proof device split not measured (the "
            f"run is past {PROFILE_BEFORE_S} s of its 1200 s)")
        return
    t0 = time.perf_counter()
    wall, busy, count, kern = profile_call(
        lambda: prover.prove(setup, wit.assignment))
    log(f"phase 5 SNARK: {len(kern)} kernel names, {count} device events; "
        f"the profiled proof and its reading {time.perf_counter() - t0:.1f}"
        " s")
    if not busy:
        log("phase 5 SNARK: Groth16 proof device split not measured (the "
            "profiler recorded no device events)")
        return
    groups = {}
    for label, name_in, tag in (
            ("K9", "mont_mul_kernel", "true>"),
            ("K10 product", "mont_mul_kernel", "false>"),
            ("K10 point add", "point_kernel", "true>"),
            ("K10 point double", "point_kernel", "false>")):
        mine = [k for k in kern if name_in in k[2] and tag in k[2]]
        groups[label] = (sum(k[0] for k in mine), sum(k[1] for k in mine))
    other = (busy - sum(v[0] for v in groups.values()),
             count - sum(v[1] for v in groups.values()))
    plain = min(prove_s)
    log(f"phase 5 SNARK: one Groth16 proof under the profiler (device "
        f"activity), {wall:.3f} s ({plain:.3f} s without it): device busy "
        f"{busy / 1e6:.4f} s, idle share "
        f"{100 * (1 - busy / (plain * 1e6)):.1f}% of the proof without the "
        f"profiler ({100 * (1 - busy / (wall * 1e6)):.1f}% under it); "
        f"{count} launches: " + "; ".join(
            f"{k} {us / 1e3:.2f} ms in {n}" for k, (us, n) in groups.items())
        + f"; other kernels {other[0] / 1e3:.2f} ms in {other[1]}; the most "
        "time: " + "; ".join(f"{key[:60]} x{cnt} {us / 1e3:.2f} ms"
                             for us, cnt, key in kern[:6]))


# the multi-device slice (phase 4 "parallel"): a mesh of 4 positions, one
# a card when the machine has 4, else the first card four times
MESH_POSITIONS = 4
DIST_DEGREES = ((8192, "Q_40_1"), (16384, "Q_60_1"))
MXU_N, MXU_BATCH = 1024, 256


def parallel_phase6(dev, seed, zero_counts, counts, tfhe, ballot_p,
                    msm_run):
    """The multi-device slice's phase, run after phase 5 so that the
    earlier paths' timings keep their place in the time limit.  Each item
    runs under device-only tracing (busy) and then alone with the launch
    counts set to 0 just before and read just after it (wall, launches,
    idle share, bytes between positions): the sharded PBS at
    TFHE_BOOT_128_K4 (batch 4096, 1024 a position) through pallas_fused,
    pallas and mxu_fused; the sharded tally (4096 ballots encrypted 1024 a
    position, reduced, joined by psum_mod); DistPolyRing at N=8192 and
    16384, EncryptionEngine over it, CKKS_128_ML over five distributed
    primes; msm_bn254_4096 sharded; MxuNTT; scaling_report; bench_suite;
    then profiling.trace.  Returns the items' log records."""
    import numpy as np
    import torch
    from node_fhe_accelerate_tpu_torch.core.ckks import CkksEngine
    from node_fhe_accelerate_tpu_torch.core.encrypt import EncryptionEngine
    from node_fhe_accelerate_tpu_torch.core.keys import KeyManager
    from node_fhe_accelerate_tpu_torch.core.params import (
        CKKS_128_ML, FHEScheme, ParameterSet, Primes)
    from node_fhe_accelerate_tpu_torch.core.poly import PolyRing
    from node_fhe_accelerate_tpu_torch.ops.ntt_mxu import P_MXU, MxuNTT
    from node_fhe_accelerate_tpu_torch.ops.u64 import u64_to_np
    from node_fhe_accelerate_tpu_torch.parallel import collectives
    from node_fhe_accelerate_tpu_torch.parallel.dist_ring import DistPolyRing
    from node_fhe_accelerate_tpu_torch.parallel.mesh import (
        gather, make_mesh, replicate, to_device)
    from node_fhe_accelerate_tpu_torch.parallel.msm import sharded_msm
    from node_fhe_accelerate_tpu_torch.parallel.pbs import (
        replicate_bsk, shard_lwe_batch, sharded_bootstrap_fn)
    from node_fhe_accelerate_tpu_torch.utils import (bench_suite,
                                                     profiling,
                                                     scaling_report)

    traffic = collectives.traffic
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    cards = torch.cuda.device_count()
    positions = scaling_report.default_devices(MESH_POSITIONS)
    mesh = make_mesh(MESH_POSITIONS, data=MESH_POSITIONS, devices=positions)
    where = ("4 cards" if cards >= MESH_POSITIONS else
             f"one card four times ({positions[0]})")
    log(f"phase 6 parallel: mesh of {MESH_POSITIONS} positions on {where}: "
        f"{[str(d) for d in mesh.axis_devices()]}")
    items = {}
    distinct = mesh.distinct_devices()

    def item(label, fn, **need):
        """Run ``fn`` twice, with the counts set to 0 just before each:
        once under device-only tracing (the device's busy time), then
        alone between synchronizes of every mesh device (the wall, the
        launches, the bytes moved between positions and the result it
        returns).  Every kernel in ``need`` must have launched in the
        second run (the value: an exact count, or None for at least once),
        and every other kernel never.  The profiler slows the host, so the
        idle share divides the traced run's busy time by the untraced
        run's wall."""
        zero_counts()
        _, traced_wall, kern = device_trace(fn, distinct)
        busy, events = sum(k[0] for k in kern), sum(k[1] for k in kern)
        zero_counts()
        traffic.reset()
        for d in distinct:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        res = fn()
        for d in distinct:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        got = counts()
        for k, v in got.items():
            want = need.get(k, 0)
            if (want is None and v == 0) or (want is not None and v != want):
                raise AssertionError(
                    f"phase 6 parallel {label}: launches {nonzero(got)}, "
                    f"expected {need}")
        idle = 100 * (1 - busy / (wall * 1e6))
        items[label] = (wall, nonzero(got), idle, traffic.bytes,
                        traffic.values)
        log(f"phase 6 parallel {label}: wall {wall:.4f} s ({traced_wall:.4f}"
            f" s under device-only tracing), launches {nonzero(got)}, "
            f"{events} device events, busy {busy / 1e6:.4f} s, idle share "
            f"{idle:.1f}% of the untraced wall; {traffic.bytes} bytes in "
            f"{traffic.values} values moved between positions")
        return res

    # -- 1. the sharded PBS at TFHE_BOOT_128_K4, batch 4096 ---------------
    key, lwe_sk, ct0, tp, msgs, engines = tfhe
    rep = replicate_bsk(key, mesh)
    if len(rep.copies) != len(mesh.distinct_devices()):
        raise AssertionError("phase 6 parallel: the key is not held once "
                             "per distinct device")
    if cards < MESH_POSITIONS and not all(
            a is b for a, b in ((rep.on(positions[0]).ggsw_i8, key.ggsw_i8),
                                (rep.on(positions[0]).ggsw_kslabs,
                                 key.ggsw_kslabs))):
        raise AssertionError("phase 6 parallel: the key was copied on its "
                             "own card")
    ct_sh = shard_lwe_batch(ct0, mesh)
    n_lwe = key.params.n_lwe
    for backend, kname, per in (("pallas_fused", "ladder_tiles", 1),
                                ("pallas", "cmux_step", n_lwe),
                                ("mxu_fused", "ladder_steps", 1)):
        e = engines[backend]
        f = sharded_bootstrap_fn(e, mesh)
        out = item(f"sharded PBS {backend}", lambda: f(ct_sh, rep, tp),
                   **{kname: per * MESH_POSITIONS})
        moved = items[f"sharded PBS {backend}"][3]
        whole = gather(out, positions[0])
        ref = e.bootstrap_with_test_poly(ct0, key, tp)
        if not same_lwe(whole, ref):
            raise AssertionError(f"phase 6 parallel: sharded {backend} != "
                                 "the unsharded bootstrap")
        if not torch.equal(e.lwe_decrypt(whole, lwe_sk),
                           msgs.to(torch.int32)):
            raise AssertionError(f"phase 6 parallel: sharded {backend} "
                                 "decodes wrong")
        if moved:
            raise AssertionError(f"phase 6 parallel: sharded {backend} "
                                 f"moved {moved} bytes between positions")
    log(f"phase 6 parallel: sharded PBS at K4, batch {ct0.b.shape[0]} "
        f"({ct0.b.shape[0] // MESH_POSITIONS} a position): pallas_fused, "
        "pallas, mxu_fused each bit-equal to the unsharded bootstrap, "
        f"decoded; the key held {len(rep.copies)} time(s) "
        f"({len(mesh.distinct_devices())} distinct device(s)); 0 bytes "
        "between positions")

    # -- 2. the sharded tally at the ballot shape -------------------------
    e0 = EncryptionEngine(ballot_p, device=positions[0])
    km = KeyManager(ballot_p, e0.ring)
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    sk = km.generate_secret_key(g)
    pk = km.generate_public_key(g, sk)
    pk_r = replicate(pk, mesh)
    engs = {str(d): EncryptionEngine(ballot_p, device=d)
            for d in mesh.distinct_devices()}
    choices = np.random.default_rng(13).integers(0, CANDIDATES, BALLOTS)
    onehots = np.eye(CANDIDATES, dtype=np.uint64)[choices]
    per = BALLOTS // MESH_POSITIONS

    def sharded_tally():
        cts, parts = [], []
        for i, d in enumerate(positions):
            e = engs[str(d)]
            gi = torch.Generator(device=d).manual_seed(seed + 100 + i)
            mine = [e.encrypt(gi, onehots[j], pk_r.on(d))
                    for j in range(i * per, (i + 1) * per)]
            cts.extend(mine)
            parts.append(e.batch_add(mine))
        c0 = collectives.psum_mod(e0.ring.ctx, [p.c0 for p in parts])
        c1 = collectives.psum_mod(e0.ring.ctx, [p.c1 for p in parts])
        return cts, c0, c1

    cts, c0, c1 = item("sharded tally", sharded_tally,
                       ntt_negacyclic_mul=BALLOTS)
    for k in range(1, MESH_POSITIONS):
        for x, y in ((c0[k], c0[0]), (c1[k], c1[0])):
            if not np.array_equal(u64_to_np(x), u64_to_np(y)):
                raise AssertionError("phase 6 parallel: psum_mod left the "
                                     "positions with different sums")
    whole = e0.batch_add([to_device(c, positions[0]) for c in cts])
    for f_, got in (("c0", c0[0]), ("c1", c1[0])):
        if not np.array_equal(u64_to_np(got),
                              u64_to_np(getattr(whole, f_))):
            raise AssertionError(f"phase 6 parallel: the sharded tally's "
                                 f"{f_} != the unsharded batch_add")
    dec = e0.decode(e0.phase(dataclasses.replace(whole, c0=c0[0],
                                                 c1=c1[0]), sk), CANDIDATES)
    want_counts = np.bincount(choices, minlength=CANDIDATES) % e0.t
    if not np.array_equal(dec, want_counts):
        raise AssertionError(f"phase 6 parallel: sharded tally decodes to "
                             f"{dec.tolist()}, not {want_counts.tolist()}")
    log(f"phase 6 parallel: sharded tally of {BALLOTS} one-hot ballots "
        f"({per} a position, one K8 each) joined by psum_mod == the "
        f"unsharded batch_add (bit-exact), decoded to {dec.tolist()}")

    # -- 3. the distributed ring ------------------------------------------
    for n_d, qname in DIST_DEGREES:
        q = getattr(Primes, qname)
        t0 = time.perf_counter()
        dring = DistPolyRing(n_d, q, mesh=mesh)
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(n_d)
        a = rng.integers(0, q, (2, n_d), dtype=np.uint64)
        b = rng.integers(0, q, (2, n_d), dtype=np.uint64)
        da, db = dring.from_np(a), dring.from_np(b)
        prod = item(f"DistPolyRing multiply N={n_d}",
                    lambda: dring.multiply(da, db))
        single = PolyRing(n_d, q, dev)
        want = single.multiply(single.from_np(a), single.from_np(b))
        if not np.array_equal(u64_to_np(prod), u64_to_np(want)):
            raise AssertionError(f"phase 6 parallel: DistPolyRing N={n_d} "
                                 "!= PolyRing.multiply")
        log(f"phase 6 parallel: DistPolyRing N={n_d} over {qname} (n1="
            f"{dring.n1}; tables {init_s:.2f} s): multiply of 2 rows == "
            "PolyRing.multiply on the card (bit-exact)")
        if n_d == 8192:
            ring8 = dring
    bfv_p = ParameterSet(
        scheme=FHEScheme.BFV, poly_degree=8192, moduli=[Primes.Q_40_1],
        lwe_dimension=64, lwe_noise_std=3.2e-11, glwe_dimension=1,
        decomp_base_log=8, decomp_level=5, plaintext_modulus=64)

    def dist_bfv():
        eng = EncryptionEngine(bfv_p, ring=ring8)
        kmd = KeyManager(bfv_p, ring8)
        gd = torch.Generator(device=dev).manual_seed(seed + 17)
        skd = kmd.generate_secret_key(gd)
        pkd = kmd.generate_public_key(gd, skd)
        total = eng.batch_add([eng.encrypt(gd, [1, i], pkd)
                               for i in range(3)])
        return eng.decrypt(total, skd, 2)

    vals, budget = item("EncryptionEngine over DistPolyRing N=8192",
                        dist_bfv)
    if vals.tolist() != [3, 3] or not budget > 5:
        raise AssertionError(f"phase 6 parallel: BFV over DistPolyRing "
                             f"decrypts {vals.tolist()} (budget {budget})")
    log("phase 6 parallel: EncryptionEngine over DistPolyRing N=8192: "
        f"keys, 3 encryptions, tally, decrypt -> {vals.tolist()} (noise "
        f"budget {budget:.1f} bits)")
    ckks_p = CKKS_128_ML()
    t0 = time.perf_counter()
    dist = CkksEngine(ckks_p, ring_factory=lambda n_, q_: DistPolyRing(
        n_, q_, mesh=mesh))
    gc = torch.Generator(device=dev).manual_seed(seed + 19)
    csk = dist.generate_secret_key(gc)
    cpk = dist.generate_public_key(gc, csk)
    rlk = dist.generate_relin_keys(gc, csk)
    slots = 64
    rng = np.random.default_rng(5)
    va, vb = np.zeros(ckks_p.poly_degree // 2), \
        np.zeros(ckks_p.poly_degree // 2)
    va[:slots], vb[:slots] = rng.uniform(-1, 1, slots), \
        rng.uniform(-1, 1, slots)
    ca, cb = dist.encrypt(gc, va, cpk), dist.encrypt(gc, vb, cpk)
    torch.cuda.synchronize()
    ckks_keys_s = time.perf_counter() - t0
    out = item("CKKS_128_ML multiply_relin_rescale over DistPolyRing",
               lambda: dist.multiply_relin_rescale(ca, cb, rlk))
    got = dist.decrypt(out, csk)
    ckks_err = float(np.max(np.abs(np.real(got[:slots]) - va[:slots]
                                   * vb[:slots])))
    ref = CkksEngine(ckks_p, device=dev).multiply_relin_rescale(ca, cb, rlk)
    for x, y in zip(out.c0, ref.c0):
        if not np.array_equal(u64_to_np(x), u64_to_np(y)):
            raise AssertionError("phase 6 parallel: CKKS c0 over "
                                 "DistPolyRing != the single-ring engine")
    if not ckks_err < 1e-3:
        raise AssertionError(f"phase 6 parallel: CKKS over DistPolyRing "
                             f"error {ckks_err}")
    log(f"phase 6 parallel: CKKS_128_ML over 5 distributed primes: keys "
        f"and 2 encryptions {ckks_keys_s:.2f} s; one multiply_relin_rescale "
        f"(three steps) c0 == the single-ring engine's (bit-exact), error "
        f"{ckks_err:.3e} on {slots} slots")
    del dist, rlk, ca, cb, out, ref

    # -- 4. msm_bn254_4096 sharded ----------------------------------------
    curve, scal, pts = msm_run
    # each position's Pippenger at n=1024, then log2(4) halving adds of
    # the partials at widths 2 and 1 (the point kernel)
    k9, _, jadd, jdbl = PIPPENGER_LAUNCHES[MSM_N // MESH_POSITIONS]
    res, moved = item("sharded msm_bn254_4096", lambda: sharded_msm(
        curve, scal, pts, mesh, _want_ici_bytes=True),
        digits_mul_t=MESH_POSITIONS * k9,
        digits_jadd=MESH_POSITIONS * jadd + 2,
        digits_jdbl=MESH_POSITIONS * jdbl)
    partials = items["sharded msm_bn254_4096"][4]
    host = curve.msm(scal, pts, backend="host")
    if not bool(curve.eq(res, host)):
        raise AssertionError("phase 6 parallel: sharded msm_bn254_4096 != "
                             "the host Pippenger")
    if partials != MESH_POSITIONS - 1:
        raise AssertionError(f"phase 6 parallel: the MSM combine moved "
                             f"{partials} partial points")
    log(f"phase 6 parallel: sharded msm_bn254_4096 (1024 points a "
        f"position) == the host Pippenger by Curve.eq; the combine moved "
        f"{partials} partial points, {moved} bytes between positions")

    # -- 5. MxuNTT ---------------------------------------------------------
    mx = MxuNTT(MXU_N, n1=32)
    raw = np.random.default_rng(23).integers(0, 1 << 56,
                                             (MXU_BATCH, MXU_N),
                                             dtype=np.uint64)
    vals_m = np.vectorize(lambda v: int(v) % P_MXU, otypes=[object])(raw)
    digits = mx.to_digits_host(vals_m)
    digits_d = digits.to(dev)
    got_m = item(f"MxuNTT N={MXU_N} batch {MXU_BATCH}",
                 lambda: mx.forward_negacyclic(digits_d))
    want_m = MxuNTT(MXU_N, n1=32).forward_negacyclic(digits)
    if not torch.equal(got_m.cpu(), want_m):
        raise AssertionError("phase 6 parallel: MxuNTT on the card != the "
                             "port on the CPU")
    ints = mx.digits_to_ints(got_m)
    ks = list(range(0, MXU_N, 111))
    for row in (0, MXU_BATCH - 1):
        at = [int(x) * pow(mx.psi, j, P_MXU) % P_MXU
              for j, x in enumerate(vals_m[row])]
        for k in ks:
            kk = k % mx.n1 + mx.n1 * (k // mx.n1)
            want_k = sum(v * pow(mx.omega, kk * j, P_MXU)
                         for j, v in enumerate(at)) % P_MXU
            if int(ints[row, k]) % P_MXU != want_k:
                raise AssertionError(f"phase 6 parallel: MxuNTT row {row} "
                                     f"output {k} != the oracle")
    log(f"phase 6 parallel: MxuNTT N={MXU_N} batch {MXU_BATCH} (float32 "
        "matmuls) on the card == the port on the CPU (bit-exact); rows 0 "
        f"and {MXU_BATCH - 1} == the big-integer oracle at {len(ks)} "
        "outputs")

    # -- 6. scaling_report -------------------------------------------------
    def scaling():
        text = scaling_report.run(
            per_device_batch=1024, params=key.params,
            backend="pallas_fused", devices=positions, positions=(1, 2, 4),
            seed=seed + 29)
        return text, scaling_report.collective_rows(devices=positions)

    text, crow = item("scaling_report", scaling,
                      ladder_tiles=4 * (1 + 2 + 4), digits_jadd=None,
                      digits_jdbl=None)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "scaling.csv"), "w") as fh:
        fh.write(text + scaling_report.rows_csv(crow))
    rows = list(csv.DictReader(io.StringIO(text)))
    if not all(r["correct"] == "True" and r["ici_bytes_per_step"] == "0"
               for r in rows) or not all(r[7] for r in crow):
        raise AssertionError(f"phase 6 parallel: scaling report {rows} "
                             f"{crow}")
    log("phase 6 parallel: scaling_report (pallas_fused, 1024 a position): "
        + "; ".join(f"{r['devices']} position(s) "
                    f"{float(r['bootstraps_per_s']):,.1f} bootstraps/s, "
                    f"efficiency {r['weak_scaling_efficiency']}, first call "
                    f"{r['compile_s']} s" for r in rows)
        + "; " + "; ".join(f"{r[9].split(' (')[0]}: {r[6]} bytes between "
                           f"positions, first call {r[2]:.3f} s"
                           for r in crow)
        + f"; written to {os.path.relpath(out_dir, ROOT)}/scaling.csv")

    # -- 7. bench_suite ------------------------------------------------------
    def suites():
        runner = bench_suite.ComprehensiveBenchmarkRunner(
            warmup=1, iters=2, device=dev,
            keycache_dir=os.path.join(out_dir, "keycache"))
        runner.benchmark_memory()
        runner.benchmark_modmul()
        runner.benchmark_ntt()
        runner.benchmark_poly_mul()
        runner.benchmark_bootstrap(presets=("l2_k4",))
        return runner

    runner = item("bench_suite", suites, ntt_forward=None, ntt_inverse=None,
                  ntt_negacyclic_mul=None, cmux_step=None)
    runner.export_all(os.path.join(out_dir, "bench_suite"))
    bad = [r.name for r in runner.results if not r.correct]
    if bad or len(runner.results) != 12:
        raise AssertionError(f"phase 6 parallel: bench_suite rows "
                             f"{[(r.name, r.correct) for r in runner.results]}")
    log("phase 6 parallel: bench_suite (warmup 1, iters 2), every row "
        "correct: " + "; ".join(
            f"{r.name} {r.backend} {r.throughput_ops_s:,.1f} {r.unit}"
            for r in runner.results)
        + f"; written to {os.path.relpath(out_dir, ROOT)}/bench_suite")

    # -- 8. profiling.trace around one sharded bootstrap --------------------
    f = sharded_bootstrap_fn(engines["pallas_fused"], mesh)
    zero_counts()
    with profiling.trace(os.path.join(out_dir, "trace")) as tf:
        profiling.block_until_ready(f(ct_sh, rep, tp))
    got = counts()
    if nonzero(got) != {"ladder_tiles": MESH_POSITIONS}:
        raise AssertionError(f"phase 6 parallel: traced bootstrap "
                             f"launches {nonzero(got)}")
    with open(tf.path) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    if len(kern) < MESH_POSITIONS:
        raise AssertionError(f"phase 6 parallel: the trace holds "
                             f"{len(kern)} kernel events")
    log(f"phase 6 parallel: profiling.trace around one sharded bootstrap: "
        f"{os.path.relpath(tf.path, ROOT)}, {len(events)} events, "
        f"{len(kern)} CUDA kernel events ("
        + ", ".join(sorted({k[:40] for k in kern})[:4]) + ")")
    return items


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from node_fhe_accelerate_tpu_torch.api.ckks_context import CkksContext
    from node_fhe_accelerate_tpu_torch.api.context import FHEContext
    from node_fhe_accelerate_tpu_torch.api.engine import create_fhe_engine
    from node_fhe_accelerate_tpu_torch.core.bootstrap import (
        KSLABS_SHARE_OF_FREE, TFHE_BOOT_128, TFHE_BOOT_128_K4,
        TFHE_BOOT_128_L2, LweCiphertext, TfheEngine, TfheParams,
        kslabs_bytes)
    from node_fhe_accelerate_tpu_torch.core.ckks import CkksEngine
    from node_fhe_accelerate_tpu_torch.core.speculative import SpeculativePBS
    from node_fhe_accelerate_tpu_torch.core.streaming import (
        ChunkedCiphertextProcessor)
    from node_fhe_accelerate_tpu_torch.core.keycache import (
        deserialize_bootstrap_key)
    from node_fhe_accelerate_tpu_torch.core import serializer, threshold
    from node_fhe_accelerate_tpu_torch.core.bfv_mul import aux_prime_chain
    from node_fhe_accelerate_tpu_torch.core.encrypt import EncryptionEngine
    from node_fhe_accelerate_tpu_torch.core.keys import KeyManager
    from node_fhe_accelerate_tpu_torch.core.params import (
        BFV_128_SIMD, CKKS_128_ML, FHEScheme, ParameterSet, Primes)
    from node_fhe_accelerate_tpu_torch.core.verifiable import (
        VerifiableEncryption)
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
    from node_fhe_accelerate_tpu_torch.timing import (cuda_ms, device_ms,
                                                      max_sm_mhz)
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
    print(smi, flush=True)              # as nvidia-smi prints it
    sm_mhz = max_sm_mhz()
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bytes = PEAKS[variant(name)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mul_rate = INT32_MUL_PER_SM_CLK * sms * sm_mhz * 1e6
    fp64_rate = FP64_PER_SM_CLK * sms * sm_mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} card {name} ({variant(name)} peaks); "
        f"{sms} SMs at up to {sm_mhz:.0f} MHz: {mul_rate:.4e} 32-bit "
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
    for lib in (cmux.STEP_LIB, cmux.SLABS_LIB, ladder.TILES_LIB,
                ladder.STEPS_LIB):
        log(f"phase 1: {lib.source.name} (wgmma): "
            + "; ".join(ptxas_summary(lib.info["log"])))
    log("phase 1: digits.cu: " + "; ".join(
        ptxas_summary(dp.DIGITS_LIB.info["log"], digits_entry)))
    log("phase 1: ntt.cu (by log N): " + "; ".join(sorted(
        ptxas_summary(NTT_LIB.info["log"], ntt_entry),
        key=lambda x: (x.split()[0], int(x.split()[1].strip(":"))))))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev = torch.device("cuda")
    simd_p, ckks_p = BFV_128_SIMD(), CKKS_128_ML()
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

    # K10's point kernel (one launch a Jacobian add or double) against its
    # plain version (the level-stacked formulas over Field.mul_plain) on
    # curve points with the edge rows of jadd_formula first (p at
    # infinity, p = q, p = -q, q at infinity, both at infinity) and on
    # random canonical elements, at the MSM tail's widths 1 and 32 and at
    # 1000; and against jadd_formula/jdbl_formula over the field on the CPU
    def edge_points(curve, b):
        ks = [int(v) for v in np.random.default_rng(b).integers(
            1, 1 << 62, 2 * b)]
        P = [x.clone() for x in curve.fixed_base_mul(ks[:b], backend="host")]
        Q = [x.clone() for x in curve.fixed_base_mul(ks[b:], backend="host")]
        for i in range(1, min(b, 3)):
            for c in range(3):
                Q[c][i] = P[c][i]
        if b > 2:
            Q[1][2] = curve.fq.neg(P[1][2])
        for c, i in ((P[2], 0), (Q[2], 3), (P[2], 4), (Q[2], 4)):
            if i < b:
                c[i] = 0
        return tuple(P), tuple(Q)

    def check_points(label, f, p, q):
        """(P + Q, 2P) by the point kernel, each == its plain version."""
        outs = []
        for op, got, want in (
                ("jadd", dp.pallas_jadd(f, p, q), dp.jadd_reference(f, p, q)),
                ("jdbl", dp.pallas_jdbl(f, p), dp.jdbl_reference(f, p))):
            for i, (g, w) in enumerate(zip(got, want)):
                worse("digits", check_equal(f"digits {op} {label} "
                                            f"coordinate {i}", g, w))
            outs.append(got)
        return outs

    for cname, make in (("bn254", bn254_g1), ("bls12_381", bls12_381_g1)):
        curve, curve_cpu = make(dev), make("cpu")
        f = curve.fq
        for b in (1, 32, 1000):
            P, Q = edge_points(curve, b)
            add, dbl = check_points(f"{cname} D={f.n_limbs} edge rows",
                                    f, P, Q)
            Pc, Qc = tuple(x.cpu() for x in P), tuple(x.cpu() for x in Q)
            if not all(torch.equal(g.cpu(), w) for g, w in
                       zip(add + dbl, curve_cpu.add(Pc, Qc)
                           + curve_cpu.double(Pc))):
                raise AssertionError(f"digits point kernel {cname} B={b}: "
                                     "!= the formulas over the field on "
                                     "the CPU")
            R = [rand_elems(f, b) for _ in range(6)]
            check_points(f"{cname} D={f.n_limbs} random elements", f, R[:3],
                         R[3:])
    log("phase 2 digits: the point kernel == the formulas over the field "
        "on the CPU, BN254 and BLS12-381, B = 1, 32, 1000")
    del P, Q, R, add, dbl
    # the SNARK slice's shapes: K9 over Fq2 at the G2 MSM's widths, the Fr
    # NTT (K10's product a stage) at d = 4096 and 16384
    snark_ntts = snark_phase2(dev, args.seed, worse)
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
    # the largest NTT prime each form of the kernels' arithmetic takes
    # (doubles below 2^46, Shoup's products below 2^62), the first of the
    # wide form, and the smallest above 2^62, which they refuse
    q_f64, q_wide = (1 << 46) - (1 << 38) + 1, (1 << 46) + (1 << 15) + 1
    q_max, q_above = (1 << 62) - (1 << 16) + 1, (1 << 62) + 622593
    shapes = [("bench Q_40_1", 1024, 8192, q40),
              ("bench Q_40_1", 4096, 2048, q40),
              ("bench Q_40_1", 16384, 512, q40),
              ("bench Q_60_1", 16384, 512, q60),
              ("path P1", 4096, 1536, P1),
              ("path P2", 4096, 1536, P2),
              ("path P_EXT", 256, 2560, P_EXT),
              ("ragged P1", 4096, 24, P1),
              ("ragged P_EXT", 256, 24, P_EXT),
              ("batch 1 P1", 4096, 1, P1),
              ("Q_60_1", 4, 7, q60),
              ("Q_60_1", 16384, 3, q60),
              ("largest q", 1024, 17, q_max),
              ("largest q", 16384, 3, q_max),
              ("largest q of the doubles", 16384, 3, q_f64),
              ("smallest q of the wide form", 1024, 17, q_wide)]
    # every degree the kernels take, at a ragged batch
    shapes += [("every degree", 1 << lg, 3 + 2 * lg,
                (q40, P2, q60, P_EXT, q_max)[lg % 5]) for lg in range(2, 15)]
    for label, deg, b, q in shapes:
        pk, a = pntt(deg, q), rand_planes(b, deg, q)
        fa = pk.forward(a)
        check_planes(f"ntt forward {label} N={deg}", fa, pk.ntt.forward(a))
        back = pk.inverse(fa)
        check_planes(f"ntt inverse {label} N={deg}", back,
                     pk.ntt.inverse(fa))
        check_planes(f"ntt inverse(forward) {label} N={deg} == input", back,
                     a)
    pk = pntt(1024, q_above)
    for entry in (pk.forward, pk.inverse):
        try:
            entry(rand_planes(2, 1024, q_above))
        except ValueError:
            continue
        raise AssertionError("ntt: q above 2^62 was not refused")
    log("phase 2 ntt: q = 2^62 + 622593 refused (ValueError)")
    for label, deg, b, q in (("bench Q_40_1", 1024, 2048, q40),
                             ("ragged P1", 4096, 24, P1),
                             ("Q_60_1", 4, 7, q60),
                             ("path P_EXT", 256, 37, P_EXT),
                             ("largest degree Q_40_1", 8192, 3, q40)):
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
    # the BFV slice's shapes: K6/K7 over the auxiliary primes of the
    # rescale multiplier at the ballot ring (N=1024) and BFV_128_SIMD's
    # first modulus (N=8192), at the batches RescaleMultiplier gives them
    # (4 operands forward, 3 products inverse), and over Q_60_1 at N=8192
    # at relinearize's (3 forward, 2 inverse); K8 over Q_40_1 at N=1024
    # (narrow form) and over Q_60_1 at N=8192 (wide form), at 1 and 2 rows
    # (a phase, an encryption's two products)
    bfv_ntt = [(deg, pr, 4, 3) for deg, qq, tt in BFV_RINGS
               for pr in aux_prime_chain(deg, rescale_bound_bits(deg, qq))]
    bfv_ntt.append((8192, q60, 3, 2))
    for deg, pr, b_fwd, b_inv in bfv_ntt:
        pk = pntt(deg, pr)
        a = rand_planes(b_fwd, deg, pr)
        fa = pk.forward(a)
        check_planes(f"ntt forward BFV q={pr} N={deg}", fa,
                     pk.ntt.forward(a))
        check_planes(f"ntt inverse BFV q={pr} N={deg}", pk.inverse(fa),
                     a)
        fb = rand_planes(b_inv, deg, pr)
        check_planes(f"ntt inverse BFV q={pr} N={deg} products",
                     pk.inverse(fb), pk.ntt.inverse(fb))
    for deg, qq, _ in BFV_RINGS:
        pk = pntt(deg, qq)
        for rows in (1, 2):
            a, c = rand_planes(rows, deg, qq), rand_planes(rows, deg, qq)
            got = pk.negacyclic_mul(a, c)
            check_planes(f"ntt negacyclic_mul BFV q={qq} N={deg} "
                         f"({'narrow' if qq < (1 << 46) else 'wide'} form)",
                         got, pk.ntt.negacyclic_mul(a, c))
        an, cn, gn = u64_to_np(a), u64_to_np(c), u64_to_np(got)
        if not (gn[0] == negacyclic_mul_np(an[0], cn[0], qq)).all():
            raise AssertionError(f"ntt negacyclic_mul BFV q={qq}: row 0 != "
                                 "the big-integer oracle")
    del a, c, fa, fb, got
    # the public API's chains: BFV_128_SIMD's three primes and the seven
    # auxiliary primes of its RnsRescaleMultiplier at N=8192 (K6 on the
    # four lifted operands, K7 on the three products, K8 on relinearize's
    # 2K = 6 stacked products of a prime and an encryption's 2), and
    # CKKS_128_ML's five primes at N=16384, where the ring product is K6,
    # the pointwise product and K7 (K6 on the five gadget components of the
    # fused multiply, K7 on its three products), in the wide form above
    # 2^46 (Q_60_1, Q_50_3, Q_50_2) and the narrow one below (Q_40_1,
    # Q_40_2)
    chain_q = list(simd_p.moduli)
    chain_ntt = [(8192, q, 4, 3) for q in chain_q + aux_prime_chain(
        8192, rescale_bound_bits(8192, math.prod(chain_q)),
        exclude=tuple(chain_q))]
    chain_ntt += [(16384, q, 5, 3) for q in ckks_p.moduli]
    for deg, q, b_fwd, b_inv in chain_ntt:
        pk = pntt(deg, q)
        a = rand_planes(b_fwd, deg, q)
        fa = pk.forward(a)
        check_planes(f"ntt forward chain q={q} N={deg}", fa,
                     pk.ntt.forward(a))
        check_planes(f"ntt inverse chain q={q} N={deg}", pk.inverse(fa), a)
        fb = rand_planes(b_inv, deg, q)
        check_planes(f"ntt inverse chain q={q} N={deg} products",
                     pk.inverse(fb), pk.ntt.inverse(fb))
    for q in chain_q:
        pk = pntt(8192, q)
        for rows in (2, 6):
            a, c = rand_planes(rows, 8192, q), rand_planes(rows, 8192, q)
            got = pk.negacyclic_mul(a, c)
            check_planes(f"ntt negacyclic_mul chain q={q} N=8192", got,
                         pk.ntt.negacyclic_mul(a, c))
        an, cn, gn = u64_to_np(a), u64_to_np(c), u64_to_np(got)
        if not (gn[5] == negacyclic_mul_np(an[5], cn[5], q)).all():
            raise AssertionError(f"ntt negacyclic_mul chain q={q}: row 5 "
                                 "!= the big-integer oracle")
    del a, c, fa, fb, got
    pk4 = TFHE_BOOT_128_K4()
    with open(K4_BLOB, "rb") as f:
        bsk = deserialize_bootstrap_key(f.read(), pk4, device=dev)
    kp1, n = pk4.glwe_dim + 1, pk4.poly_degree
    base_log = pk4.pbs_base_log
    acc = random_u32(gen, (BATCH, kp1, n))
    rot = torch.randint(-4 * n, 4 * n, (BATCH,), generator=gen,
                        dtype=torch.int32, device="cuda")
    row = bsk.ggsw_i8[0]
    slabs_row = cmux.build_diag_kslabs(torch.cat([row, row], dim=-1))

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
    e2 = TfheEngine(dataclasses.replace(pl2, n_lwe=short),
                    ext_backend="pallas", device=dev)
    g2 = e2.generate_bootstrap_key(gen, e2.lwe_keygen(gen),
                                   e2.glwe_keygen(gen)).ggsw_i8
    acc2 = random_u32(gen, (BATCH, pl2.glwe_dim + 1, pl2.poly_degree))
    rots2 = torch.randint(-(1 << 20), 1 << 20, (short, BATCH), generator=gen,
                          dtype=torch.int32, device="cuda")
    check_steps("L2 (k=1, N=1024)", acc2, rots2[0], g2[0],
                cmux.build_diag_kslabs(torch.cat([g2[0], g2[0]], dim=-1)),
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
    # TFHE_BOOT_128 (k=1, N=1024, l=3, Bg=2^7), the ladder "auto" runs in
    # the entry's bootstraps, at the batch of boot128_pbs_b1024; from a
    # generator of its own, so that the later phases draw what they drew
    # without these checks
    pb = TFHE_BOOT_128()
    rows_b = 1024
    gen_b = torch.Generator(device="cuda").manual_seed(args.seed + 8)
    eb = TfheEngine(dataclasses.replace(pb, n_lwe=short),
                    ext_backend="pallas", device=dev)
    gb = eb.generate_bootstrap_key(gen_b, eb.lwe_keygen(gen_b),
                                   eb.glwe_keygen(gen_b)).ggsw_i8
    accb = random_u32(gen_b, (rows_b, pb.glwe_dim + 1, pb.poly_degree))
    rotsb = torch.randint(-4 * pb.poly_degree, 4 * pb.poly_degree,
                          (short, rows_b), generator=gen_b,
                          dtype=torch.int32, device="cuda")
    check_steps("TFHE_BOOT_128 (k=1, N=1024, l=3)", accb, rotsb[0], gb[0],
                cmux.build_diag_kslabs(torch.cat([gb[0], gb[0]], dim=-1)),
                pb.pbs_base_log)
    want_b = ladder.blind_rotate_fused_reference(accb, rotsb, gb,
                                                 pb.pbs_base_log)
    worse("ladder_tiles", check_equal(
        f"ladder_tiles TFHE_BOOT_128, {short} steps",
        ladder.blind_rotate_fused(accb, rotsb, gb, pb.pbs_base_log), want_b))
    slabsb = cmux.build_all_step_kslabs(gb)
    want_sb = ladder.blind_rotate_fused_steps_reference(
        accb, rotsb, slabsb, pb.pbs_base_log)
    if not torch.equal(want_sb, want_b):
        raise AssertionError("TFHE_BOOT_128: the two plain ladders differ")
    worse("ladder_steps", check_equal(
        f"ladder_steps TFHE_BOOT_128, {short} steps",
        ladder.blind_rotate_fused_steps(accb, rotsb, slabsb,
                                        pb.pbs_base_log), want_sb))
    del accb, rotsb, gb, slabsb, eb, want_b, want_sb, gen_b
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
    eng = TfheEngine(pk4, ext_backend="pallas", device=dev)
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
                "digits_mul": dp.pallas_field_mul.launches,
                "digits_jadd": dp.pallas_jadd.launches,
                "digits_jdbl": dp.pallas_jdbl.launches}

    def zero_counts():
        cmux.cmux_step.launches = 0
        cmux.cmux_step_slabs.launches.update(v3=0, v2=0)
        ladder.blind_rotate_fused.launches = 0
        ladder.blind_rotate_fused_steps.launches = 0
        PallasNTT.launches.update(forward=0, inverse=0, negacyclic_mul=0)
        dp._mul_t_raw.launches = 0
        dp.pallas_field_mul.launches = 0
        dp.pallas_jadd.launches = 0
        dp.pallas_jdbl.launches = 0

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
    slabs_s = cmux.build_diag_kslabs(torch.cat([key.ggsw_i8[0]] * 2,
                                               dim=-1))
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
        winner = "pippenger"
        if n_pts <= 1024:
            # inside the band: the Pippenger and the ladders race once
            # (here, outside the counts), then the winner runs
            disp, op = curve.msm_race()
            t0 = time.perf_counter()
            winner = disp.selection_for(op, scal, pts)
            race_s = time.perf_counter() - t0
            (sel,) = [v for k, v in disp.selection_table().items()
                      if k[0] == op]
            check_race(f"msm {cname} n={n_pts}", sel)
            log(f"phase 4: msm {cname} n={n_pts} band selection: {winner} "
                f"(race {race_s:.3f} s; seconds per call: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sel["timings"].items())
                + ")")
        zero_counts()
        t0 = time.perf_counter()
        res = curve.msm(scal, pts)
        torch.cuda.synchronize()
        msm_s = time.perf_counter() - t0
        k9, k10, jadd, jdbl = (PIPPENGER_LAUNCHES if winner == "pippenger"
                               else LADDER_LAUNCHES)[n_pts]
        got = expect_counts(f"msm {cname} n={n_pts}", digits_mul_t=k9,
                            digits_mul=k10, digits_jadd=jadd,
                            digits_jdbl=jdbl)
        if cname == "bn254":
            for k in ("digits_mul_t", "digits_jadd", "digits_jdbl"):
                launches[k] = got[k]
        t0 = time.perf_counter()
        host = curve.msm(scal, pts, backend="host")
        host_s = time.perf_counter() - t0
        if affine(curve, res) != affine(curve, host):
            raise AssertionError(f"phase 4: msm {cname} n={n_pts} on the card "
                                 "!= the host Pippenger")
        # and by projective equality on the card (Curve.eq: 2 squares and
        # 6 products, each one launch of K10's single product)
        zero_counts()
        same = bool(curve.eq(res, host))
        got_eq = expect_counts(f"msm {cname} Curve.eq", digits_mul=8)
        if not same:
            raise AssertionError(f"phase 4: Curve.eq on the card says msm "
                                 f"{cname} != the host Pippenger")
        if cname == "bn254":
            launches["digits_mul"] = got_eq["digits_mul"]
        msm_runs[cname] = (curve, scal, pts, msm_s)
        log(f"phase 4: msm {cname} n={n_pts}: fixed_base_mul on the card "
            f"{fbm_s:.3f} s (== host table); msm ({winner}) {msm_s:.4f} s, "
            f"== host Pippenger ({host_s:.2f} s); K9 launches "
            f"{got['digits_mul_t']}, "
            f"K10 products {got['digits_mul']}, point kernel adds "
            f"{got['digits_jadd']} and doubles {got['digits_jdbl']}; "
            f"Curve.eq == host on the card, K10 products "
            f"{got_eq['digits_mul']}")

    # a 64-bit Bulletproofs range proof on the card (the JAX suite's
    # bp_range_prove_64 / bp_range_verify_64 rows); then an 8-bit proof
    # from the same seed on the card and in the port on the CPU, field for
    # field equal (the CPU's 64-bit proof took ~70 s of the run)
    value = int.from_bytes(np.random.default_rng(9).bytes(8), "little")
    proofs, bp_secs, bp_curves = {}, {}, {}
    for where, bits in (("cuda", BP_BITS), ("cuda", BP_CMP_BITS),
                        ("cpu", BP_CMP_BITS)):
        first = where not in bp_curves
        curve = bp_curves.setdefault(where, bn254_g1(where))
        gens = BulletproofsGens.generate(curve, bits)
        prover = BulletproofsProver(curve, rng_seed=args.seed + 3)
        blinding = prover.random_scalar()
        bit_value = value % (1 << bits)
        if where == "cuda" and first:
            # every MSM of the proof pads to n=256, inside the band: race
            # this curve's candidates once, outside the timed prove
            disp, op = curve.msm_race()
            pts256 = curve.fixed_base_mul(list(range(1, 257)),
                                          backend="host")
            sc256 = limbs_from_ints(list(range(7, 7 + 256)), 8, dev)
            winner256 = disp.selection_for(op, sc256, pts256)
            (sel,) = [v for k, v in disp.selection_table().items()
                      if k[0] == op]
            check_race("msm bn254 n=256", sel)
            log(f"phase 4: msm bn254 n=256 band selection: {winner256} "
                "(seconds per call: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sel["timings"].items())
                + ")")
        com = prover.commit(bit_value, blinding, gens)
        zero_counts()
        t0 = time.perf_counter()
        proof = prover.prove_range(bit_value, blinding, bits, gens)
        if where == "cuda":
            torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        bp_counts = counts()
        verifier = BulletproofsVerifier(curve)
        t0 = time.perf_counter()
        ok = verifier.verify_range(com, proof, bits, gens)
        verify_s = time.perf_counter() - t0
        path_counts = counts()              # prove and verify
        proofs[where, bits] = (affine(curve, com.point), proof)
        bp_secs[where, bits] = (prove_s, verify_s)
        if not ok:
            raise AssertionError(f"phase 4: the {bits}-bit proof made on "
                                 f"{where} does not verify")
        if where == "cuda" and bits == BP_BITS:
            # the proof's MSMs and ladders and the verifier's MSM run the
            # point kernel, and K9 when the Pippenger won the band race
            need = ("digits_jadd", "digits_jdbl") + (
                ("digits_mul_t",) if winner256 == "pippenger" else ())
            if not all(path_counts[k] for k in need) \
                    or any(v for k, v in path_counts.items()
                           if not k.startswith("digits")):
                raise AssertionError(f"phase 4: range proof launches "
                                     f"{path_counts}")
            proof.t_hat = (proof.t_hat + 1) % curve.order
            if verifier.verify_range(com, proof, BP_BITS, gens):
                raise AssertionError("phase 4: a tampered proof verified")
            proof.t_hat = (proof.t_hat - 1) % curve.order
            log(f"phase 4: prove_range {BP_BITS} bits on the card: K9 "
                f"launches {bp_counts['digits_mul_t']}, K10 products "
                f"{bp_counts['digits_mul']}, point kernel adds "
                f"{bp_counts['digits_jadd']} and doubles "
                f"{bp_counts['digits_jdbl']}; with verify_range: "
                f"{path_counts}; tampered t_hat refused")
    (com_g, pg) = proofs["cuda", BP_CMP_BITS]
    (com_c, pc) = proofs["cpu", BP_CMP_BITS]
    fields = ("A", "S", "T1", "T2", "t_hat", "tau_x", "mu")
    if com_g != com_c or any(getattr(pg, k) != getattr(pc, k)
                             for k in fields) \
            or (pg.inner.L, pg.inner.R, pg.inner.a, pg.inner.b) != \
            (pc.inner.L, pc.inner.R, pc.inner.a, pc.inner.b):
        raise AssertionError("phase 4: the proof made on the card != the "
                             "proof made on the CPU")
    log(f"phase 4: {BP_BITS}-bit range proof on the card: prove "
        f"{bp_secs['cuda', BP_BITS][0]:.3f} s, verify "
        f"{bp_secs['cuda', BP_BITS][1]:.3f} s; {BP_CMP_BITS}-bit range "
        f"proof: card == CPU field for field; verifies on both; prove "
        f"{bp_secs['cuda', BP_CMP_BITS][0]:.3f} s on the card, "
        f"{bp_secs['cpu', BP_CMP_BITS][0]:.3f} s on the CPU; verify "
        f"{bp_secs['cuda', BP_CMP_BITS][1]:.3f} s / "
        f"{bp_secs['cpu', BP_CMP_BITS][1]:.3f} s")

    # the default constructor, TfheEngine(params): "auto" races its four
    # candidates on the first bootstrap of a batch shape (here, outside
    # every timed loop), then routes every bootstrap of that shape to the
    # winner
    eng_auto = TfheEngine(pk4)
    if eng_auto.backend != "pallas" or eng_auto.dispatcher is None:
        raise AssertionError(f"phase 4: TfheEngine(params) resolved to "
                             f"{eng_auto.backend!r} without a race")
    sit_out, fit_line = fused_may_sit_out(kslabs_bytes(key.ggsw_i8),
                                          KSLABS_SHARE_OF_FREE)
    t0 = time.perf_counter()
    eng_auto.bootstrap_with_test_poly(ct0, key, tp)
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t0
    (sel,) = eng_auto.dispatcher.selection_table().values()
    winner = sel["winner"]
    log(f"phase 4: auto at batch {BATCH}: race and first call {race_s:.2f} "
        f"s; {fit_line}; selection_table: winner {winner}, seconds per call "
        + ", ".join(f"{k} {v:.4f}" for k, v in sel["timings"].items()))
    # every candidate ran (a kernel that fails raises out of the race; only
    # "mxu_fused" sits out, and only when its slabs do not fit by the
    # engine's rule), and on the card a kernel backend wins: "mxu" is the
    # plain contraction
    check_race("auto", sel, may_sit_out=sit_out)
    if winner not in PBS_KERNEL_LAUNCHES:
        raise AssertionError(f"phase 4: auto race {sel}: the plain \"mxu\" "
                             "won")
    zero_counts()
    (out_auto,), secs = chained(eng_auto, ct0, key, tp, 1)
    kname, per = PBS_KERNEL_LAUNCHES[winner]
    expect_counts("auto", **{kname: per})
    expect_decode("auto", out_auto)
    want_auto = TfheEngine(pk4, ext_backend=winner).bootstrap_with_test_poly(
        ct0, key, tp)
    if not same_lwe(out_auto, want_auto):
        raise AssertionError(f"phase 4: auto differs from {winner} named "
                             "explicitly")
    # rows 0-3 against the port on the CPU ("auto" is "mxu" there), on the
    # same key rows and ciphertexts
    rows_c = slice(0, 4)
    key_cpu = dataclasses.replace(
        key, ggsw_i8=key.ggsw_i8.cpu(), ksk_a=key.ksk_a.cpu(),
        ksk_b=key.ksk_b.cpu(), ggsw_kslabs=None)
    eng_cpu = TfheEngine(pk4, device="cpu")
    got_cpu = eng_cpu.bootstrap_with_test_poly(
        LweCiphertext(a=ct0.a[rows_c].cpu(), b=ct0.b[rows_c].cpu()),
        key_cpu, tp.cpu())
    if not (torch.equal(got_cpu.a, out_auto.a[rows_c].cpu())
            and torch.equal(got_cpu.b, out_auto.b[rows_c].cpu())):
        raise AssertionError("phase 4: auto rows 0-3 != the port on the CPU")
    rates["auto"] = BATCH / secs[0]
    log(f"phase 4: auto, 1 bootstrap of {BATCH} routed to {winner}: "
        f"{secs[0]:.4f} s -> {rates['auto']:.1f} bootstraps/s; decode ok; "
        f"== {winner} named explicitly (bit-exact); rows 0-3 == the port "
        f"on the CPU ({eng_cpu.backend}, bit-exact)")
    del out_auto, want_auto, key_cpu, eng_cpu, got_cpu

    # the ballot shape (utils/bench_suite.py, the voting preset's RLWE
    # ring): 3-of-5 threshold keys and a public key of their master secret
    # from a seeded generator, one-hot ballots over the candidates
    # encrypted with the public key, their tally, decrypted with the master
    # secret and 3-of-5, proofs of correct encryption, and the tally's
    # polynomial through the LZ4 codec
    ballot_p = ParameterSet(
        scheme=FHEScheme.TFHE, poly_degree=1024, moduli=[Primes.Q_40_1],
        lwe_dimension=630, lwe_noise_std=3.2e-11, glwe_dimension=1,
        decomp_base_log=23, decomp_level=1, plaintext_modulus=64)
    state_b = torch.Generator(device="cuda").manual_seed(
        args.seed + 4).get_state()

    def ballot_setup(device):
        g = torch.Generator(device="cuda")
        g.set_state(state_b)
        e = EncryptionEngine(ballot_p, device=device)
        tk = threshold.generate_threshold_keys(g, e.ring, 3, 5)
        pk = KeyManager(ballot_p, e.ring).generate_public_key(g,
                                                              tk.master_sk)
        return e, tk, pk, g

    choices = np.random.default_rng(11).integers(0, CANDIDATES, BALLOTS)
    onehots = np.eye(CANDIDATES, dtype=np.uint64)[choices]
    zero_counts()
    eb, tkb, pkb, gb = ballot_setup(dev)
    t0 = time.perf_counter()
    ballots = [eb.encrypt(gb, onehots[i], pkb) for i in range(BALLOTS)]
    torch.cuda.synchronize()
    ballot_s = time.perf_counter() - t0
    got = expect_counts("ballots", ntt_negacyclic_mul=1 + BALLOTS)
    bfv_counts = {"ballot keygen + encrypt": nonzero(got)}
    e_cpu, _, pk_cpu, g_cpu = ballot_setup("cpu")
    first_cpu = e_cpu.encrypt(g_cpu, onehots[0], pk_cpu)
    for f in ("c0", "c1"):
        if not np.array_equal(u64_to_np(getattr(ballots[0], f)),
                              u64_to_np(getattr(first_cpu, f))):
            raise AssertionError(f"phase 4: ballot 0 {f} on the card != the "
                                 "port on the CPU from the same state")
    zero_counts()
    t0 = time.perf_counter()
    tally = eb.batch_add(ballots)
    torch.cuda.synchronize()
    tally_s = time.perf_counter() - t0
    expect_counts("tally")
    counts_t = np.bincount(choices, minlength=CANDIDATES) % eb.t
    zero_counts()
    dec, budget = eb.decrypt(tally, tkb.master_sk, CANDIDATES)
    parts = [threshold.partial_decrypt(eb.ring, tally.c1, tkb.shares[i])
             for i in (0, 2, 4)]
    dec_th = eb.decode(threshold.combine_partial_decryptions(
        eb.ring, tally.c0, parts, 3), CANDIDATES)
    bfv_counts["tally decrypt + 3-of-5"] = nonzero(expect_counts(
        "tally decryption", ntt_negacyclic_mul=1 + 3))
    if not (np.array_equal(dec, counts_t) and np.array_equal(dec_th,
                                                             counts_t)):
        raise AssertionError(f"phase 4: tally decoded {dec.tolist()} / "
                             f"3-of-5 {dec_th.tolist()}, counts mod t "
                             f"{counts_t.tolist()}")
    ve = VerifiableEncryption(eb)
    zero_counts()
    proofs_ok = 0
    for i in range(PROOFS):
        ct_p, proof_p = ve.encrypt_with_proof(gb, int(choices[i]), pkb)
        proofs_ok += ve.verify(ct_p, proof_p, pkb)
    bfv_counts["16 proofs + verify"] = nonzero(expect_counts(
        "proofs", ntt_negacyclic_mul=PROOFS * (3 + 2)))
    if proofs_ok != PROOFS:
        raise AssertionError(f"phase 4: {PROOFS - proofs_ok} proofs of "
                             "correct encryption did not verify")
    if ve.verify(eb.add_plain(ct_p, [1]), proof_p, pkb):
        raise AssertionError("phase 4: a proof verified a tampered ballot")
    tally_np = u64_to_np(tally.c0)
    blob = serializer.serialize_polynomial(
        tally_np, serializer.Magic.BALLOT, modulus=eb.q,
        compression=serializer.CompressionType.LZ4)
    _, back = serializer.deserialize_polynomial(blob, serializer.Magic.BALLOT)
    if not np.array_equal(back, tally_np):
        raise AssertionError("phase 4: the tally polynomial did not come "
                             "back from its LZ4 blob")
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 1
    try:
        serializer.quick_verify(bytes(flipped), serializer.Magic.BALLOT)
    except serializer.SerializationError:
        pass
    else:
        raise AssertionError("phase 4: quick_verify took a flipped byte")
    rates["ballots encrypted"] = BALLOTS / ballot_s
    log(f"phase 4: ballots (N=1024, q=Q_40_1, t=64, noise std "
        f"{eb._noise_std:.3f}): {BALLOTS} one-hot ballots over {CANDIDATES} "
        f"candidates encrypted in {ballot_s:.3f} s "
        f"({rates['ballots encrypted']:.1f} ballots/s); ballot 0 == the "
        f"port on the CPU from the same generator state (bit-exact); tally "
        f"of {BALLOTS} in {tally_s:.4f} s, decoded {dec.tolist()} == counts "
        f"mod t, 3-of-5 threshold decryption (shares 1, 3, 5) the same; "
        f"noise budget {budget:.2f} bits; {PROOFS} proofs of encryption "
        f"verify, a tampered ballot refused; tally c0 through "
        f"serialize_polynomial (41-bit packing, LZ4): {len(blob)} bytes, "
        f"back equal, quick_verify refuses a flipped byte; launches "
        f"{bfv_counts}")
    del ballots, first_cpu, e_cpu

    # BFV_128_SIMD's first modulus as EncryptionEngine takes it (N=8192,
    # Q_60_1, t=65537): keys with a relinearization key (digits of 2^20 at
    # the preset's 3 levels: the preset's 2^60 gadget would leave the whole
    # of c2 as one digit, whose product with the key noise swamps Delta),
    # then products of sparse random messages (8 coefficients below 2^8)
    # through multiply_relin_rescale, each decoded against the numpy
    # negacyclic product mod t
    state_s = torch.Generator(device="cuda").manual_seed(
        args.seed + 5).get_state()
    rng_s = np.random.default_rng(13)
    n_s, t_s = simd_p.poly_degree, simd_p.plaintext_modulus

    def sparse_message():
        # 8 coefficients below 2^8: the product's noise term
        # (q mod t) * k * m grows with the coefficients, and at the full
        # range of t it leaves ~3 bits of budget
        m = np.zeros(n_s, dtype=np.uint64)
        m[rng_s.choice(n_s, 8, replace=False)] = rng_s.integers(0, 256, 8)
        return m

    def negacyclic_mod_t(a, b):
        out = np.zeros(n_s, dtype=object)
        for i in np.nonzero(a)[0]:
            for j in np.nonzero(b)[0]:
                k = int(i + j)
                out[k % n_s] += (-1 if k >= n_s else 1) * int(a[i]) * int(b[j])
        return (out % t_s).astype(np.uint64)

    def simd_setup(device):
        g = torch.Generator(device="cuda")
        g.set_state(state_s)
        e = EncryptionEngine(simd_p, device=device)
        km = KeyManager(simd_p, e.ring)
        sk = km.generate_secret_key(g)
        pk = km.generate_public_key(g, sk)
        rlk = km.generate_relin_key(g, sk, decomp_base_log=20)
        return e, sk, pk, rlk, g

    msgs_s = [(sparse_message(), sparse_message())
              for _ in range(SIMD_PRODUCTS)]
    zero_counts()
    es, sks, pks, rlks, gs = simd_setup(dev)
    es.rescaler                 # its auxiliary NTT contexts, built once
    cts_s = [(es.encrypt(gs, a, pks), es.encrypt(gs, b, pks))
             for a, b in msgs_s]
    torch.cuda.synchronize()
    bfv_counts_s = {"keygen + encrypt": nonzero(expect_counts(
        "SIMD keygen + encrypt",
        ntt_negacyclic_mul=1 + 1 + rlks.decomp_level + 2 * SIMD_PRODUCTS))}
    zero_counts()
    t0 = time.perf_counter()
    prods = [es.multiply_relin_rescale(a, b, rlks) for a, b in cts_s]
    torch.cuda.synchronize()
    simd_s = time.perf_counter() - t0
    n_aux = len(es.rescaler.aux_primes)
    bfv_counts_s["multiply_relin_rescale"] = nonzero(expect_counts(
        "SIMD multiply_relin_rescale",
        ntt_forward=SIMD_PRODUCTS * (n_aux + 3),
        ntt_inverse=SIMD_PRODUCTS * (n_aux + 1)))
    for i, ((a, b), pr) in enumerate(zip(msgs_s, prods)):
        vals, budget_s = es.decrypt(pr, sks, n_s)
        wrong = int((vals != negacyclic_mod_t(a, b)).sum())
        if wrong:
            raise AssertionError(f"phase 4: SIMD product {i} decoded "
                                 f"{wrong} coefficients wrong")
    e_c, sk_c, pk_c, rlk_c, g_c = simd_setup("cpu")
    c_a, c_b = e_c.encrypt(g_c, msgs_s[0][0], pk_c), \
        e_c.encrypt(g_c, msgs_s[0][1], pk_c)
    t0 = time.perf_counter()
    prod_cpu = e_c.multiply_relin_rescale(c_a, c_b, rlk_c)
    cpu_mul_s = time.perf_counter() - t0
    for f in ("c0", "c1"):
        if not np.array_equal(u64_to_np(getattr(prods[0], f)),
                              u64_to_np(getattr(prod_cpu, f))):
            raise AssertionError(f"phase 4: SIMD product 0 {f} on the card "
                                 "!= the port on the CPU from the same "
                                 "state")
    log(f"phase 4: BFV_128_SIMD first modulus (N=8192, Q_60_1, t=65537, "
        f"{n_aux} auxiliary primes, relin digits 2^20 x "
        f"{rlks.decomp_level}): {SIMD_PRODUCTS} multiply_relin_rescale in "
        f"{simd_s:.3f} s, each decoded == the numpy negacyclic product mod "
        f"t (last noise budget {budget_s:.2f} bits); product 0 == the port "
        f"on the CPU from the same generator state (bit-exact; "
        f"{cpu_mul_s:.2f} s there); launches {bfv_counts_s}")
    del e_c, sk_c, pk_c, rlk_c, c_a, c_b, prod_cpu

    # the public API over the whole chains.  BFV_128_SIMD (N=8192, Q_60_1
    # Q_60_2 Q_60_3, t=65537) through FHEContext.create_simd: keys (the RNS
    # relin key, 3-of-5 threshold shares), dense packed encryptions (a
    # random value mod t in every slot), an add, multiply (relinearized) at
    # depth 1 and 2, each decoded to the numpy negacyclic product mod t,
    # the noise budgets, the product through the serializer and back, a
    # 3-of-5 threshold decryption, and the depth-1 product bit-equal to the
    # port on the CPU from the same generator state
    rng_c = np.random.default_rng(17)
    n_c, t_c = simd_p.poly_degree, simd_p.plaintext_modulus
    seed_c = args.seed + 6

    def negacyclic_t(a, b):
        # |coefficients| < 8192 * 65537^2 < 2^46: exact in int64
        full = np.convolve(a.astype(np.int64), b.astype(np.int64))
        out = full[:n_c].copy()
        out[:n_c - 1] -= full[n_c:]
        return (out % t_c).astype(np.uint64)

    def chain_context(device):
        eng_c = create_fhe_engine("BFV_128_SIMD", rng_seed=seed_c,
                                  device=device)
        # both devices draw from one CUDA generator state
        eng_c.gen = torch.Generator(device="cuda").manual_seed(seed_c)
        return FHEContext(eng_c, threshold_config=(3, 5))

    vals_c = [rng_c.integers(0, t_c, n_c, dtype=np.uint64)
              for _ in range(3)]
    k_c = len(chain_q)
    zero_counts()
    t0 = time.perf_counter()
    ctx_c = FHEContext.create_simd(threshold=(3, 5), rng_seed=seed_c,
                                   device=dev)
    torch.cuda.synchronize()
    chain_keys_s = time.perf_counter() - t0
    # a public key (one product a prime), the relin key (s^2 and the K
    # stacked a_j s, a launch each a prime); the shares take no product
    chain_counts = {"keys": nonzero(expect_counts(
        "BFV chain keys", ntt_negacyclic_mul=3 * k_c))}
    fhe_c = ctx_c.engine
    zero_counts()
    cts_c = [ctx_c.encrypt(v) for v in vals_c]
    chain_counts["3 encryptions"] = nonzero(expect_counts(
        "BFV chain encrypt", ntt_negacyclic_mul=3 * k_c))
    n_aux_c = len(fhe_c.engine.rescaler.aux_primes)
    zero_counts()
    t0 = time.perf_counter()
    prod1 = ctx_c.multiply(cts_c[0], cts_c[1])
    torch.cuda.synchronize()
    chain_mul_s = time.perf_counter() - t0
    # per auxiliary prime one K6 and one K7; relinearize one K8 a prime
    chain_counts["multiply depth 1"] = nonzero(expect_counts(
        "BFV chain multiply", ntt_forward=n_aux_c, ntt_inverse=n_aux_c,
        ntt_negacyclic_mul=k_c))
    zero_counts()
    prod2 = ctx_c.multiply(prod1, cts_c[2])
    chain_counts["multiply depth 2"] = nonzero(expect_counts(
        "BFV chain multiply depth 2", ntt_forward=n_aux_c,
        ntt_inverse=n_aux_c, ntt_negacyclic_mul=k_c))
    sum_c = ctx_c.add(cts_c[0], cts_c[1])
    want1 = negacyclic_t(vals_c[0], vals_c[1])
    want2 = negacyclic_t(want1, vals_c[2])
    for label, ct, want in (("add", sum_c, (vals_c[0] + vals_c[1]) % t_c),
                            ("depth 1", prod1, want1),
                            ("depth 2", prod2, want2)):
        got = ctx_c.decrypt_packed(ct, n_c)
        if not np.array_equal(got, want):
            raise AssertionError(f"phase 4: BFV chain {label} decoded "
                                 f"{int((got != want).sum())} of {n_c} "
                                 "coefficients wrong")
    budgets_c = [ctx_c.noise_budget(ct) for ct in (cts_c[0], prod1, prod2)]
    blob_c = fhe_c.serialize_ciphertext(prod1)
    back_c = fhe_c.deserialize_ciphertext(blob_c)
    for f in ("c0", "c1"):
        if not np.array_equal(fhe_c.ring.to_np(getattr(back_c, f)),
                              fhe_c.ring.to_np(getattr(prod1, f))):
            raise AssertionError(f"phase 4: BFV chain product {f} did not "
                                 "come back from its blob")
    tk_c = ctx_c.threshold_keys
    zero_counts()
    ct_th = fhe_c.encrypt_packed(vals_c[2],
                                 fhe_c.generate_public_key(tk_c.master_sk))
    parts_c = [fhe_c.partial_decrypt(ct_th, tk_c.shares[i])
               for i in (0, 2, 4)]
    dec_th = fhe_c.combine_partial_decryptions(ct_th, parts_c, 3)
    chain_counts["3-of-5"] = nonzero(expect_counts(
        "BFV chain 3-of-5", ntt_negacyclic_mul=k_c * (1 + 1 + 3)))
    got_th = fhe_c.engine.decode(threshold.combine_partial_decryptions(
        fhe_c.ring, ct_th.c0, parts_c, 3), n_c)
    if not (np.array_equal(got_th, vals_c[2])
            and int(dec_th.values[0]) == int(vals_c[2][0])):
        raise AssertionError("phase 4: BFV chain 3-of-5 decryption wrong")
    t0 = time.perf_counter()
    ctx_cpu = chain_context("cpu")
    a_cpu, b_cpu = ctx_cpu.encrypt(vals_c[0]), ctx_cpu.encrypt(vals_c[1])
    prod_cpu = ctx_cpu.multiply(a_cpu, b_cpu)
    chain_cpu_s = time.perf_counter() - t0
    for f in ("c0", "c1"):
        if not np.array_equal(fhe_c.ring.to_np(getattr(prod1, f)),
                              ctx_cpu.engine.ring.to_np(getattr(prod_cpu,
                                                                f))):
            raise AssertionError(f"phase 4: BFV chain product {f} on the "
                                 "card != the port on the CPU from the same "
                                 "state")
    log(f"phase 4: BFV_128_SIMD over its chain (N=8192, {k_c} primes, "
        f"t=65537, {n_aux_c} auxiliary primes) through "
        f"FHEContext.create_simd: keys and 3-of-5 shares {chain_keys_s:.2f}"
        f" s; add, multiply at depth 1 ({chain_mul_s:.3f} s) and depth 2 "
        f"of dense packed messages each decoded == the numpy negacyclic "
        f"product mod t; noise budget fresh / depth 1 / depth 2 "
        + " / ".join(f"{b:.2f}" for b in budgets_c) + " bits; the product "
        f"through serialize_ciphertext ({len(blob_c)} bytes) and back equal;"
        f" 3-of-5 threshold decryption (shares 1, 3, 5) == the messages; "
        f"depth-1 product == the port on the CPU from the same generator "
        f"state (bit-exact; keys, 2 encryptions and the product "
        f"{chain_cpu_s:.2f} s there); launches {chain_counts}")
    del ctx_cpu, a_cpu, b_cpu, prod_cpu
    # the entry's bootstraps: FHEEngine's own TfheEngine (TfheParams():
    # n=630, N=1024, k=1, l=3, "auto"), keys from the engine's generator,
    # programmable_bootstrap of NOT and bootstrap at a batch of 256, after
    # the race of the first call; each decoded
    rows_e = 256
    lwe_sk_e, _, bsk_e = fhe_c.generate_bootstrap_key()
    m_e = torch.arange(rows_e, device=dev) % 2
    lwe_e = fhe_c.tfhe.lwe_encrypt(fhe_c.gen, m_e, lwe_sk_e)
    sit_out_e, fit_line_e = fused_may_sit_out(kslabs_bytes(bsk_e.ggsw_i8),
                                              KSLABS_SHARE_OF_FREE)
    t0 = time.perf_counter()
    fhe_c.bootstrap(lwe_e, bsk_e)
    torch.cuda.synchronize()
    race_e = time.perf_counter() - t0
    (sel_e,) = fhe_c.tfhe.dispatcher.selection_table().values()
    check_race("FHEEngine bootstrap", sel_e, may_sit_out=sit_out_e)
    if sel_e["winner"] not in PBS_KERNEL_LAUNCHES:
        raise AssertionError(f"phase 4: FHEEngine race {sel_e}: the plain "
                             "\"mxu\" won")
    zero_counts()
    not_e = fhe_c.programmable_bootstrap(lwe_e, bsk_e, lambda v: 1 - v)
    id_e = fhe_c.bootstrap(lwe_e, bsk_e)
    kname, per = PBS_KERNEL_LAUNCHES[sel_e["winner"]]
    boot_counts = nonzero(expect_counts("FHEEngine bootstraps",
                                        **{kname: 2 * per}))
    if not (torch.equal(fhe_c.tfhe.lwe_decrypt(not_e, lwe_sk_e),
                        (1 - m_e).to(torch.int32))
            and torch.equal(fhe_c.tfhe.lwe_decrypt(id_e, lwe_sk_e),
                            m_e.to(torch.int32))):
        raise AssertionError("phase 4: FHEEngine bootstraps decode wrong")
    # bit-equal to the winner named explicitly, and the NOT's rows 0-1 to
    # the port on the CPU ("auto" is "mxu" there; ~37 s a bootstrap), on
    # the same key and ciphertexts
    p_e = fhe_c.tfhe.p
    lut_e = fhe_c.tfhe.make_lut(lambda v: 1 - v)
    eng_w = TfheEngine(p_e, ext_backend=sel_e["winner"], device=dev)
    if not (same_lwe(not_e, eng_w.programmable_bootstrap(lwe_e, bsk_e,
                                                         lut_e))
            and same_lwe(id_e, eng_w.bootstrap(lwe_e, bsk_e))):
        raise AssertionError(f"phase 4: FHEEngine bootstraps differ from "
                             f"{sel_e['winner']} named explicitly")
    bsk_ec = dataclasses.replace(
        bsk_e, ggsw_i8=bsk_e.ggsw_i8.cpu(), ksk_a=bsk_e.ksk_a.cpu(),
        ksk_b=bsk_e.ksk_b.cpu(), ggsw_kslabs=None)
    rows_ec = slice(0, 2)
    lwe_ec = LweCiphertext(a=lwe_e.a[rows_ec].cpu(), b=lwe_e.b[rows_ec].cpu())
    eng_ec = TfheEngine(p_e, device="cpu")
    want_ec = eng_ec.programmable_bootstrap(lwe_ec, bsk_ec, lut_e.cpu())
    if not (torch.equal(want_ec.a, not_e.a[rows_ec].cpu())
            and torch.equal(want_ec.b, not_e.b[rows_ec].cpu())):
        raise AssertionError("phase 4: FHEEngine programmable_bootstrap "
                             "(NOT) rows 0-1 != the port on the CPU")
    log(f"phase 4: FHEEngine (TfheParams(), auto) at batch {rows_e}: race "
        f"and first call {race_e:.2f} s; {fit_line_e}; winner "
        f"{sel_e['winner']} (seconds per call " + ", ".join(
            f"{k} {v:.4f}" for k, v in sel_e["timings"].items())
        + f"); programmable_bootstrap (NOT) and bootstrap decoded, == "
        f"{sel_e['winner']} named explicitly (bit-exact), the NOT's rows "
        f"0-1 == the port on the CPU ({eng_ec.backend}, bit-exact); launches "
        f"{boot_counts}")
    del lwe_e, not_e, id_e, bsk_e, eng_w, bsk_ec, lwe_ec, eng_ec, want_ec

    # CKKS_128_ML (N=16384, five primes, scale 2^49) through CkksContext:
    # 8192 real slots a ciphertext, multiply (the fused multiply,
    # relinearize and rescale) from level 5 to 4 and 3, and dot over three
    # ciphertexts, each level's largest error printed; the level-5 product
    # within tests/test_ckks.py's atol 1e-3, bit-equal to the eager three
    # steps on the card and to the port on the CPU on the same inputs
    rng_k = np.random.default_rng(19)
    slots = ckks_p.poly_degree // 2
    vals_k = [rng_k.uniform(-1, 1, slots) for _ in range(3)]
    L_k = len(ckks_p.moduli)
    zero_counts()
    t0 = time.perf_counter()
    cctx = CkksContext("CKKS_128_ML", rng_seed=args.seed + 7, device=dev)
    torch.cuda.synchronize()
    ckks_keys_s = time.perf_counter() - t0
    # N=16384 exceeds K8: a ring product is K6 on each operand, the
    # pointwise product and K7, a prime; the public key one product, the
    # relin key of level L two (s^2 and the stacked a_j s) over L primes
    ckks_counts = {"keys": nonzero(expect_counts(
        "CKKS keys", ntt_forward=2 * L_k + sum(4 * L for L in
                                               range(2, L_k + 1)),
        ntt_inverse=L_k + sum(2 * L for L in range(2, L_k + 1))))}
    zero_counts()
    xs = [cctx.encrypt(v) for v in vals_k]
    ckks_counts["3 encryptions"] = nonzero(expect_counts(
        "CKKS encrypt", ntt_forward=3 * 2 * L_k, ntt_inverse=3 * L_k))
    zero_counts()
    t0 = time.perf_counter()
    m5 = cctx.multiply(xs[0], xs[1])
    torch.cuda.synchronize()
    ckks_mul_s = time.perf_counter() - t0
    # the relin key's NTT form once (a launch a prime), then per prime the
    # four operands, the gadget components (K6) and d2, the two sums (K7)
    ckks_counts["multiply L=5"] = nonzero(expect_counts(
        "CKKS multiply L=5", ntt_forward=3 * L_k, ntt_inverse=2 * L_k))
    zero_counts()
    m4 = cctx.multiply(m5, xs[2])
    ckks_counts["multiply L=4"] = nonzero(expect_counts(
        "CKKS multiply L=4", ntt_forward=3 * (L_k - 1),
        ntt_inverse=2 * (L_k - 1)))
    zero_counts()
    weights_k = [0.5, -1.0, 2.0]
    dot_k = cctx.dot(xs, weights_k)
    ckks_counts["dot of 3"] = nonzero(expect_counts(
        "CKKS dot", ntt_forward=3 * 4 * L_k, ntt_inverse=3 * 2 * L_k))
    errs_k = {}
    for label, ct, want in (
            ("fresh L=5", xs[0], vals_k[0]),
            ("multiply L=4", m5, vals_k[0] * vals_k[1]),
            ("multiply L=3", m4, vals_k[0] * vals_k[1] * vals_k[2]),
            ("dot L=4", dot_k, sum(w * v for w, v in zip(weights_k,
                                                         vals_k)))):
        got = cctx.decrypt(ct, slots)
        errs_k[label] = (ct.level, float(np.abs(got - want).max()))
    if not all(e < 1e-3 for _, e in errs_k.values()):
        raise AssertionError(f"phase 4: CKKS errors {errs_k} not within "
                             "atol 1e-3")
    eager = cctx.engine.multiply_relin_rescale(xs[0], xs[1],
                                               cctx.relin_keys, fused=False)
    same_k = all(torch.equal(u, v) for f, e in zip(m5.c0 + m5.c1,
                                                    eager.c0 + eager.c1)
                 for u, v in zip(f, e))
    if not same_k:
        raise AssertionError("phase 4: CKKS fused != eager on the card")
    eng_k_cpu = CkksEngine(ckks_p, device="cpu")

    def to_cpu(poly):
        return tuple((lo.cpu(), hi.cpu()) for lo, hi in poly)

    rlk5 = cctx.relin_keys[L_k]
    keys_cpu = [None] * L_k + [dataclasses.replace(
        rlk5, a=[to_cpu(x) for x in rlk5.a], b=[to_cpu(x) for x in rlk5.b])]
    x_cpu = [dataclasses.replace(x, c0=to_cpu(x.c0), c1=to_cpu(x.c1))
             for x in xs[:2]]
    t0 = time.perf_counter()
    m5_cpu = eng_k_cpu.multiply_relin_rescale(*x_cpu, keys_cpu)
    ckks_cpu_s = time.perf_counter() - t0
    if not all(torch.equal(u.cpu(), v) for f, e in zip(
            m5.c0 + m5.c1, m5_cpu.c0 + m5_cpu.c1) for u, v in zip(f, e)):
        raise AssertionError("phase 4: CKKS product on the card != the port "
                             "on the CPU on the same inputs")
    log(f"phase 4: CKKS_128_ML (N=16384, {L_k} primes, scale "
        f"2^{cctx.engine.scale.bit_length() - 1}) through CkksContext: keys "
        f"(relin keys of levels 2-{L_k}) {ckks_keys_s:.2f} s; {slots} real "
        f"slots a ciphertext; multiply at L=5 {ckks_mul_s:.3f} s (first "
        "call, the relin key's NTT form included); largest error by level "
        + "; ".join(f"{k} (level {lv}) {e:.3e}" for k, (lv, e) in
                    errs_k.items())
        + f" (atol 1e-3); fused == eager on the card (bit-exact); == the "
        f"port on the CPU on the same inputs (eager there, "
        f"{ckks_cpu_s:.2f} s; bit-exact); launches {ckks_counts}")
    del eng_k_cpu, keys_cpu, x_cpu, m5_cpu, eager

    # ChunkedCiphertextProcessor.chunked_multiply_raw at N=8192 over Q_60_1
    # (the first-modulus engine above), chunks of 1024: bit-equal to
    # multiply_raw
    zero_counts()
    chunked = ChunkedCiphertextProcessor(es, 1024).chunked_multiply_raw(
        *cts_s[0])
    stream_counts = nonzero(expect_counts("chunked_multiply_raw",
                                          ntt_forward=1, ntt_inverse=1))
    direct = es.multiply_raw(*cts_s[0])
    for f in ("c0", "c1", "c2"):
        if not np.array_equal(u64_to_np(getattr(chunked, f)),
                              u64_to_np(getattr(direct, f))):
            raise AssertionError(f"phase 4: chunked_multiply_raw {f} != "
                                 "multiply_raw")
    log(f"phase 4: chunked_multiply_raw N=8192 Q_60_1, chunks of 1024 == "
        f"multiply_raw (bit-exact); launches {stream_counts}")
    del chunked, direct

    # SpeculativePBS on the phase-4 K4 key through the default engine
    # (its blind rotate is K1's per-step backend): 4 LUTs x 1024 rows in one
    # ladder, bit-equal to 4 bootstrap_with_test_poly of "pallas"; and
    # run_all_funcs, the 4 functions through one many-LUT blind rotate,
    # bit-equal to bootstrap_many_lut; both decoded
    spec_rows = 1024
    lwe_r = LweCiphertext(a=ct0.a[:spec_rows], b=ct0.b[:spec_rows])
    funcs = [lambda v: v, lambda v: 1 - v, lambda v: 1, lambda v: 0]
    luts = [eng.make_lut(f) for f in funcs]
    sp = SpeculativePBS(eng_auto)
    zero_counts()
    t0 = time.perf_counter()
    every = sp.run_all(lwe_r, key, luts)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    spec_counts = {"run_all": nonzero(expect_counts(
        "SpeculativePBS.run_all", cmux_step=pk4.n_lwe))}
    zero_counts()
    many = sp.run_all_funcs(lwe_r, key, funcs)
    spec_counts["run_all_funcs"] = nonzero(expect_counts(
        "SpeculativePBS.run_all_funcs", cmux_step=pk4.n_lwe))
    m_r = msgs[:spec_rows].to(torch.int32)
    want_dec = [m_r, 1 - m_r, torch.ones_like(m_r), torch.zeros_like(m_r)]
    for i, lut in enumerate(luts):
        one = eng.bootstrap_with_test_poly(lwe_r, key, lut)
        if not (torch.equal(one.a, every.a[i])
                and torch.equal(one.b, every.b[i])):
            raise AssertionError(f"phase 4: SpeculativePBS LUT {i} != its "
                                 "own bootstrap")
        if not torch.equal(eng.lwe_decrypt(one, lwe_sk), want_dec[i]):
            raise AssertionError(f"phase 4: SpeculativePBS LUT {i} decode")
    want_many = eng.bootstrap_many_lut(lwe_r, key, funcs)
    if not same_lwe(many, want_many):
        raise AssertionError("phase 4: run_all_funcs != bootstrap_many_lut")
    # the many-LUT path rounds each rotation to a multiple of 4: at K4 its
    # drift is of the order of the narrowed message window, and a few
    # values decode wrong (an open fault of the path, which mirrors the
    # reference's routing); fewer right than the card gave at seed 0 fails
    many_right = eng.lwe_decrypt(many, lwe_sk) == torch.stack(want_dec)
    many_ok = int(many_right.sum())
    many_wrong = [tuple(ix) for ix in (~many_right).nonzero().tolist()[:8]]
    if many_ok < MANY_LUT_MIN_OK:
        raise AssertionError(
            f"phase 4: run_all_funcs decoded {many_ok} of {4 * spec_rows} "
            f"right, fewer than {MANY_LUT_MIN_OK}")
    log(f"phase 4: SpeculativePBS at K4, 4 LUTs x {spec_rows} rows: run_all"
        f" {spec_s:.3f} s, == 4 bootstrap_with_test_poly (bit-exact), every "
        f"row decoded; run_all_funcs == bootstrap_many_lut (bit-exact), "
        f"{many_ok} of {4 * spec_rows} values decoded right (4 functions in "
        f"one coarse rotation; wrong at (function, row) {many_wrong}); "
        f"launches {spec_counts}")
    del every, many, want_many, lwe_r

    # the SNARK slice: the 256-voter election with eligibility SNARKs, its
    # package through PublicVerifier and the CLI, the PLONK tally proof,
    # seeded proofs card == CPU; the kernels' launch counts in the JSON
    # record are this path's for the kernels it runs
    snark = snark_phase4(dev, zero_counts, counts)
    for k in snark_counts():
        launches[k] = snark["launches"][k]

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

    def time_ntt(kind, n, b, q, label):
        pk = pntt(n, q)
        a, c = rand_planes(b, n, q), rand_planes(b, n, q)
        if kind == "negacyclic_mul":
            run, plain = (lambda: pk.negacyclic_mul(a, c),
                          lambda: pk.ntt.negacyclic_mul(a, c))
        else:
            run = lambda: getattr(pk, kind)(a)
            plain = lambda: getattr(pk.ntt, kind)(a)
        ms, host_ms = device_ms(run, 20)
        with_host = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 2, warmup=1)
        b_ms, b_by = ntt_bound(kind, b, n, q, mul_rate, fp64_rate,
                               peak_bytes)
        log(f"phase 5: ntt {kind} {label} N={n} B={b}: kernel {ms:.4f} ms "
            f"(back to back; {with_host:.4f} ms a call with the host's "
            f"wrapper in between, which takes {host_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library none "
            "(no PyTorch call computes an NTT mod q)")
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
            ("negacyclic_mul", 1024, 2048, q40, "bench poly_mul Q_40_1"),
            ("negacyclic_mul", 4096, TFHE256_BATCH, P2,
             "ring multiply path P2"),
            ("negacyclic_mul", 4096, TFHE256_BATCH, P_EXT,
             "wide form P_EXT")):
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

    # BFV: the ballots' and the tally's rates from phase 4, and one
    # multiply_relin_rescale at N=8192 by CUDA events, split into its NTT
    # launches (per auxiliary prime one forward of the four lifted operands
    # and one inverse of the three products; relinearize's three forward
    # and one inverse over Q_60_1), the digit work of RescaleMultiplier
    # (CRT recombination and rescale: conv_full and exact_norm, whose carry
    # lookahead is two cummax scans) and the rest; then one call under
    # torch.profiler, by device kernel
    rs = es.rescaler
    c_a, c_b = cts_s[0]
    opnds = (c_a.c0, c_a.c1, c_b.c0, c_b.c1)
    lifted = [[rs._lift_centered(x, i) for i in range(n_aux)]
              for x in opnds]
    residues = rs.aux.tensor_residues(lifted)
    deg2 = es.multiply_rescale(c_a, c_b)
    fwd_in = [rand_planes(4, n_s, pr) for pr in rs.aux_primes]
    inv_in = [rand_planes(3, n_s, pr) for pr in rs.aux_primes]
    rel_in = rand_planes(3, n_s, es.q)
    rel_inv = rand_planes(2, n_s, es.q)

    def bfv_ntts():
        for ntt, a, b in zip(rs.aux.ntt, fwd_in, inv_in):
            ntt.forward(a)
            ntt.inverse(b)
        for _ in range(3):
            es.ring.pntt.forward(rel_in)
        es.ring.pntt.inverse(rel_inv)

    def digit_work():
        for comp in range(3):
            rs._rescale_digits(*rs.aux.centered([r[comp] for r in residues]))

    bfv_parts = {
        "multiply_relin_rescale": lambda: es.multiply_relin_rescale(
            c_a, c_b, rlks),
        "NTT launches": bfv_ntts,
        "digit work (CRT + rescale)": digit_work,
        "lift to the auxiliary primes": lambda: [
            [rs._lift_centered(x, i) for i in range(n_aux)] for x in opnds],
        "relinearize": lambda: es.relinearize(deg2, rlks),
    }
    bfv_split = {k: cuda_ms(f, 5, warmup=1) for k, f in bfv_parts.items()}
    ntt_back_ms = device_ms(bfv_ntts, 5)[0]
    total_ms = bfv_split["multiply_relin_rescale"]
    rest_ms = total_ms - bfv_split["NTT launches"] - \
        bfv_split["digit work (CRT + rescale)"]
    log(f"phase 5: BFV ballots {rates['ballots encrypted']:.1f} ballots/s "
        f"(N=1024, one encrypt a call, {BALLOTS} calls); tally of "
        f"{BALLOTS} {tally_s:.4f} s; {smi}")
    log(f"phase 5: BFV_128_SIMD multiply_relin_rescale N=8192: "
        f"{total_ms:.3f} ms a call; NTT launches "
        f"{bfv_split['NTT launches']:.3f} ms "
        f"({100 * bfv_split['NTT launches'] / total_ms:.1f}%; "
        f"{ntt_back_ms:.3f} ms back to back on the device); digit work "
        f"{bfv_split['digit work (CRT + rescale)']:.3f} ms "
        f"({100 * bfv_split['digit work (CRT + rescale)'] / total_ms:.1f}%);"
        f" the rest {rest_ms:.3f} ms ({100 * rest_ms / total_ms:.1f}%); "
        f"within it: lift {bfv_split['lift to the auxiliary primes']:.3f} "
        f"ms, relinearize {bfv_split['relinearize']:.3f} ms; {smi}")
    prof_s, busy, _, kern = profile_call(
        lambda: es.multiply_relin_rescale(c_a, c_b, rlks))
    if busy:
        # cummax runs as torch's scan-with-indices kernel
        groups = {"NTT (K6/K7)": ("ntt_",),
                  "cummax": ("scan_innermost_dim_with_indices",)}
        split_us = {g: sum(k[0] for k in kern
                           if any(m in k[2].lower() for m in ms))
                    for g, ms in groups.items()}
        log(f"phase 5: BFV_128_SIMD multiply_relin_rescale under the "
            f"profiler, one call of {prof_s * 1e3:.2f} ms ({total_ms:.2f} "
            f"ms without it): device busy {busy / 1e3:.3f} ms, idle share "
            f"{100 * (1 - busy / (total_ms * 1e3)):.1f}% of the call "
            f"without the profiler ({100 * (1 - busy / (prof_s * 1e6)):.1f}"
            "% under it); " + "; ".join(
                f"{g} {us / 1e3:.3f} ms ({100 * us / busy:.1f}% of busy)"
                for g, us in split_us.items())
            + f"; {sum(k[1] for k in kern)} device launches; the most "
            "time: " + "; ".join(f"{key[:60]} x{cnt} {us / 1e3:.3f} ms"
                                 for us, cnt, key in kern[:6]))
    else:
        log("phase 5: BFV multiply device split not measured (the profiler "
            "recorded no device events)")
    del residues, lifted, deg2, fwd_in, inv_in

    # the public API over the chains: ms per multiply (relinearized) at
    # BFV_128_SIMD over its three primes, per CKKS multiply (fused) at
    # L=5 and L=4, by CUDA events; one-hot ballots encrypted/s over the
    # chain (one FHEContext.encrypt a ballot, as a voter submits); one call
    # of each multiply under torch.profiler
    chain_ms = cuda_ms(lambda: ctx_c.multiply(cts_c[0], cts_c[1]), 3,
                       warmup=1)
    ckks5_ms = cuda_ms(lambda: cctx.multiply(xs[0], xs[1]), 5, warmup=1)
    ckks4_ms = cuda_ms(lambda: cctx.multiply(m5, xs[2]), 5, warmup=1)
    onehot = np.eye(CANDIDATES, dtype=np.uint64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CHAIN_BALLOTS):
        ctx_c.encrypt(onehot[i % CANDIDATES])
    torch.cuda.synchronize()
    chain_ballots = CHAIN_BALLOTS / (time.perf_counter() - t0)
    log(f"phase 5: BFV_128_SIMD over its chain: {chain_ms:.3f} ms a "
        f"multiply (relinearized); {chain_ballots:.1f} ballots/s "
        f"({CHAIN_BALLOTS} one-hot ballots, one encrypt a call); "
        f"CKKS_128_ML: {ckks5_ms:.3f} ms a multiply at L=5, "
        f"{ckks4_ms:.3f} ms at L=4 (fused); {smi}")
    log(profile_line("BFV_128_SIMD chain multiply",
                     lambda: ctx_c.multiply(cts_c[0], cts_c[1]), chain_ms))
    log(profile_line("CKKS_128_ML multiply L=5",
                     lambda: cctx.multiply(xs[0], xs[1]), ckks5_ms))

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
            back_ms, host_ms = device_ms(run, 20)
            plain_ms = cuda_ms(plain, 3, warmup=1)
            b_ms, b_by = digits_bound(f.n_limbs, b, mul_rate, peak_bytes)
            digit_times[kind, f.n_limbs, b] = (ms, plain_ms, (b_ms, b_by),
                                               None)
            log(f"phase 5: digits {kind} D={f.n_limbs} B={b}: kernel "
                f"{ms:.4f} ms a call ({back_ms:.4f} ms back to back; the "
                f"host's wrapper takes {host_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), library none (no PyTorch call computes a "
                "Montgomery product mod a 254- or 381-bit prime)")
    times["digits_mul_t"] = digit_times["mul_t", 32, 131072]
    times["digits_mul"] = digit_times["mul", 32, 1]
    # K10's point kernel at the MSM tail's widths (1: 248 of its 256
    # doubles and 31 of its 33 adds; 32), D=32 and 48: device time back to
    # back (timing.device_ms; the JSON rows, at B=1 and D=32) and events
    # around host-paced calls, beside the launch floor: an empty kernel
    # (torch.cuda._sleep(0)) launched back to back
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 100)[0]
    point_times = {}
    for cname, make in (("bn254", bn254_g1), ("bls12_381", bls12_381_g1)):
        curve = make(dev)
        f = curve.fq
        for b in (1, 32):
            P = curve.fixed_base_mul(list(range(3, 3 + b)), backend="host")
            Q = curve.fixed_base_mul(list(range(1000, 1000 + b)),
                                     backend="host")
            for op, run, plain in (
                    ("add", lambda: dp.pallas_jadd(f, P, Q),
                     lambda: dp.jadd_reference(f, P, Q)),
                    ("double", lambda: dp.pallas_jdbl(f, P),
                     lambda: dp.jdbl_reference(f, P))):
                back_ms, host_ms = device_ms(run, 50)
                ms = cuda_ms(run, 50)
                plain_ms = cuda_ms(plain, 3, warmup=1)
                b_ms, b_by = point_bound(op, f.n_limbs, b, mul_rate,
                                         peak_bytes)
                point_times[op, f.n_limbs, b] = (back_ms, plain_ms,
                                                 (b_ms, b_by), None)
                log(f"phase 5: digits point {op} {cname} D={f.n_limbs} "
                    f"B={b}: kernel {back_ms:.5f} ms back to back (launch "
                    f"floor {floor_ms:.5f} ms), {ms:.4f} ms a call with the "
                    f"host's wrapper in between (which takes {host_ms:.4f} "
                    f"ms), plain {plain_ms:.4f} ms, bound {b_ms:.7f} ms "
                    f"({b_by}), library none")
    times["digits_jadd"] = point_times["add", 32, 1]
    times["digits_jdbl"] = point_times["double", 32, 1]
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
        f"prove_range {BP_BITS} {bp_secs['cuda', BP_BITS][0]:.3f} s, "
        f"verify_range {bp_secs['cuda', BP_BITS][1]:.3f} s")
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
    # (mont_mul_kernel<L, true>), K10's single product (<L, false>) and
    # point kernel (point_kernel<L, add>) and every other kernel, and the
    # device's idle share of the call's wall without the profiler
    prof_s, busy_us, count, kernels = profile_call(
        lambda: curve.msm(scal, pts))
    if busy_us:
        plain_us = min(walls) * 1e6
        mont = {}
        for label, name_in, tag in (
                ("K9", "mont_mul_kernel", "true>"),
                ("K10 product", "mont_mul_kernel", "false>"),
                ("K10 point add", "point_kernel", "true>"),
                ("K10 point double", "point_kernel", "false>")):
            mine = [k for k in kernels if name_in in k[2] and tag in k[2]]
            mont[label] = (sum(k[0] for k in mine), sum(k[1] for k in mine))
        other_us = busy_us - sum(v[0] for v in mont.values())
        log(f"phase 5: msm_bn254_4096 under the profiler, one call of "
            f"{prof_s:.4f} s ({min(walls):.4f} s without it): device busy "
            f"{busy_us / 1e6:.4f} s, idle share "
            f"{100 * (1 - busy_us / plain_us):.1f}% of the call without the "
            f"profiler ({100 * (1 - busy_us / (prof_s * 1e6)):.1f}% under "
            "it); " + "; ".join(
                f"{label} {us / 1e3:.3f} ms device in {cnt} launches "
                f"({us / max(cnt, 1):.2f} us each, "
                f"{100 * us / plain_us:.2f}% of the call)"
                for label, (us, cnt) in mont.items())
            + f"; other device kernels {other_us / 1e3:.2f} ms "
            f"({100 * other_us / plain_us:.1f}%) in "
            f"{count - sum(v[1] for v in mont.values())}"
            " launches; the most time: " + "; ".join(
                f"{key[:60]} x{cnt} {us / 1e3:.2f} ms"
                for us, cnt, key in kernels[:6]))
    else:
        log("phase 5: msm_bn254_4096 device split and idle share not "
            "measured (the profiler recorded no device events)")

    snark_phase5(dev, snark, snark_ntts)

    # the multi-device slice on a mesh of 4 positions, after the timings;
    # its items' launch counts are logged per item, and the JSON record
    # keeps the counts of the paths its timing rows describe
    parallel_phase6(
        dev, args.seed, zero_counts, counts,
        (key, lwe_sk, ct0, tp, msgs, {"pallas_fused": eng_tiles,
                                      "pallas": eng,
                                      "mxu_fused": eng_steps}),
        ballot_p, msm_runs["bn254"][:3])

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
             ("digits_mul", "digits.cu", digits_ref + "252", "digits"),
             ("digits_jadd", "digits.cu", digits_ref + "252", "digits"),
             ("digits_jdbl", "digits.cu", digits_ref + "252", "digits")]
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
