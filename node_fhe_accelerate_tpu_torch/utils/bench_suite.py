"""Benchmark suite: timings, statistics, CSV/JSON/HTML export (counterpart
of node_fhe_accelerate_tpu/utils/bench_suite.py).

Twin of the reference's ``ComprehensiveBenchmarkRunner``
(cpp/include/comprehensive_benchmark.h:313-429, with the CSV column schema
its reports use: name, backend, mean_us, stddev_us, throughput, speedup,
correct), its ``StatisticalAnalyzer`` (:141-186) and ``BenchmarkTimer``
(:271-300), with the JAX package's rows, schema and suites over the port's
modules on the runner's device (``cuda`` unless the caller asks for the
CPU).

Suites: modmul, ntt, poly_mul, bootstrap (+ TFHE_256 through "crt"), zk
(Groth16 prove/verify, the BN254 G1 and G2 MSMs), zk proof systems
(Bulletproofs, PLONK), memory (dispatch floor, host<->device copies), CKKS,
ballot submission and the tally pipeline.  Every row carries a ``correct``
flag checked against the big-integer oracle (the accelerated path must
match the scalar truth) and ``speedup_vs_baseline`` against the Apple
reference's own measured numbers (BASELINE.md) where one exists for the
same op and shape.  ``backend`` names the port's route on the runner's
device: ``<device>-plain`` for plain PyTorch, ``<device>-ntt`` for the ring
transforms (the NTT kernels on the card), ``<device>-<ext_backend>`` for a
bootstrap.

``python -m node_fhe_accelerate_tpu_torch.utils.bench_suite [outdir]``
runs it and writes ``<outdir>/*.csv``, ``benchmark_results.json`` and
``benchmark_report.html`` (default ``build/bench_suite``), with its
bootstrap keys cached under ``<outdir>/keycache``.
"""
from __future__ import annotations

import csv
import inspect
import io
import json
import math
import os
import sys
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..device import resolve_device
from .profiling import block_until_ready

__all__ = ["BenchmarkResult", "StatisticalAnalyzer", "BenchmarkTimer",
           "ComprehensiveBenchmarkRunner", "force_execution"]


# Reference (M4 Max) throughputs from BASELINE.md, ops/sec, keyed by row
# name.  Rows without an entry have no reference measurement (vs_baseline
# left at 0.0).
_BASELINES = {
    "modmul_batch_1024": 564_000.0,      # Barrett 4x, BENCHMARK_REPORT.md:31
    "modmul_batch_16384": 37_200.0,      # BENCHMARK_REPORT.md:58
    "modmul_batch_65536": 8_750.0,       # BENCHMARK_REPORT.md:72-84
    "ntt_forward_1024": 116_500.0,       # AMX matrix NTT, :86-97
    "ntt_forward_4096": 25_200.0,        # SME tile NTT, :99-110
    "ntt_forward_16384": 5_370.0,        # :112-123
    "poly_mul_1024": 47_100.0,           # NTT-based, :125-131
    "poly_mul_4096": 10_300.0,           # :133-139
    "pbs_n630_N1024_l2": 50.0,           # <20ms/bootstrap, README.md:75
    "pbs_n630_N1024_l3": 50.0,
    "pbs_n630_N256_l2_k4": 50.0,         # security-equivalent kN=1024
    # Reference README proof-system targets (README.md:82-84, BASELINE.md):
    # BP <50ms gen / <5ms verify; PLONK <150ms gen / <5ms verify.
    "bp_range_prove_64": 1.0 / 0.050,
    "bp_range_verify_64": 1.0 / 0.005,
    "plonk_prove": 1.0 / 0.150,
    "plonk_verify": 1.0 / 0.005,
    "groth16_prove_2e12": 1.0 / 0.100,   # Groth16 <100ms gen, README.md:83
    "groth16_prove_2e14": 1.0 / 0.100,
    "groth16_prove_2e16": 1.0 / 0.100,
    "groth16_verify_2e12": 1.0 / 0.001,  # Groth16 <1ms verify, README.md:83
    "groth16_verify_2e14": 1.0 / 0.001,
    "groth16_verify_2e16": 1.0 / 0.001,
    # Reference README hom-mul claim (README.md:754): <50 ms -> 20 mul/s.
    # (The reference never computes CKKS; its preset is BFV-on-one-modulus.)
    "ckks_mul_relin_rescale_N16384": 20.0,
    # Reference README voting-scale claim (README.md:756): 10k ballots/s,
    # an anchor for the end-to-end submit path (encrypt + BP validity +
    # Groth16 eligibility) that the reference never measures.
    "ballot_submit_depth20": 10_000.0,
    # Memory-suite analog (comprehensive_benchmark.cpp memory benchmarks):
    # 16 MB cache-aligned copy, 212.55 us (BENCHMARK_REPORT.md:209-217)
    # -> bytes/s.
    "d2h_16mb": 16 * 1024 * 1024 / 212.55e-6,
    "h2d_16mb": 16 * 1024 * 1024 / 212.55e-6,
}


@dataclass
class BenchmarkResult:
    suite: str
    name: str
    backend: str
    size: int
    batch: int
    mean_us: float
    stddev_us: float
    throughput_ops_s: float
    speedup_vs_baseline: float
    correct: bool
    # what one "op" means for throughput_ops_s: e.g. "bootstrap/s",
    # "mul/s" (one leveled multiply), "bytes/s", "proof/s"
    unit: str = "op/s"
    # mean_us minus the measured per-dispatch floor (the memory suite's
    # dispatch_floor row), separating device work from the fixed cost of
    # one call; -1 = floor not measured
    mean_minus_floor_us: float = -1.0
    proof_bytes: int = 0     # serialized proof size, proof rows only


class StatisticalAnalyzer:
    """mean/stddev/significance (comprehensive_benchmark.h:141-186)."""

    @staticmethod
    def analyze(samples_s: list) -> tuple:
        n = len(samples_s)
        mean = sum(samples_s) / n
        var = sum((s - mean) ** 2 for s in samples_s) / max(n - 1, 1)
        return mean, math.sqrt(var)

    @staticmethod
    def significantly_faster(a: list, b: list, z: float = 2.0) -> bool:
        """Welch-style z-test: is a faster than b with confidence."""
        ma, sa = StatisticalAnalyzer.analyze(a)
        mb, sb = StatisticalAnalyzer.analyze(b)
        denom = math.sqrt(sa ** 2 / len(a) + sb ** 2 / len(b)) or 1e-12
        return (mb - ma) / denom > z


def force_execution(out):
    """Wait until the computation that produced ``out`` has finished: a
    synchronize of every card holding one of its tensors (a no-op for CPU
    tensors, which are computed when returned)."""
    block_until_ready(out)


class BenchmarkTimer:
    """Warm-up + timed iterations over a thunk, every iteration closed by
    ``force_execution``."""

    def __init__(self, warmup: int = 2, iters: int = 5):
        self.warmup = warmup
        self.iters = iters

    def run(self, thunk) -> list:
        """``thunk`` may take the iteration index: benches use it to feed
        distinct inputs to the timed iterations."""
        takes_i = len(inspect.signature(thunk).parameters) >= 1
        call = (lambda i: thunk(i)) if takes_i else (lambda i: thunk())
        out = None
        for w in range(self.warmup):
            out = call(w % max(self.iters, 1))
        force_execution(out)
        samples = []
        for i in range(self.iters):
            t0 = time.perf_counter()
            out = call(i)
            force_execution(out)
            samples.append(time.perf_counter() - t0)
        return samples


class ComprehensiveBenchmarkRunner:
    """(comprehensive_benchmark.h:400 run_full_suite) on ``device``;
    bootstrap keys go through a ``BootstrapKeyCache`` in ``keycache_dir``
    (default the port's ``.keycache/torch``)."""

    def __init__(self, warmup: int = 2, iters: int = 5, device=None,
                 keycache_dir: str | None = None):
        self.timer = BenchmarkTimer(warmup, iters)
        self.results: list[BenchmarkResult] = []
        self.device = resolve_device(device)
        self.keycache_dir = keycache_dir

    def _backend(self, route: str) -> str:
        return f"{self.device.type}-{route}"

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _cache(self):
        from ..core.keycache import BootstrapKeyCache
        return (BootstrapKeyCache(self.keycache_dir) if self.keycache_dir
                else BootstrapKeyCache())

    # -- suites --------------------------------------------------------------
    def benchmark_modmul(self, sizes=(1024, 16384, 65536)):
        from ..core.params import Primes
        from ..ops.modular import ModCtx, mod_mul_np
        from ..ops.u64 import u64_from_np, u64_to_np

        q = Primes.Q_40_1
        ctx = ModCtx(q)
        for n in sizes:
            rng = np.random.default_rng(n)
            a = rng.integers(0, q, n, dtype=np.uint64)
            b = rng.integers(0, q, n, dtype=np.uint64)
            ap, bp = u64_from_np(a, self.device), u64_from_np(b, self.device)
            samples = self.timer.run(lambda: ctx.mul(ap, bp))
            correct = bool(np.array_equal(u64_to_np(ctx.mul(ap, bp)),
                                          mod_mul_np(a, b, q)))
            self._record("modmul", f"modmul_batch_{n}",
                         self._backend("plain"), n, samples, n, correct,
                         batch=n)

    def benchmark_ntt(self, degrees=(1024, 4096, 16384),
                      batch: int | None = None):
        """Forward NTTs of a batch (``PolyRing.to_ntt``: the forward NTT
        kernel on the card); ``batch`` defaults to the JAX suite's
        constant working set, 8192 rows at N=1024 down to 512 at 16384."""
        from ..core.params import Primes
        from ..core.poly import PolyRing
        from ..ops.u64 import u64_to_np

        for n in degrees:
            rows = batch or max(256, (8192 * 1024) // n)
            q = Primes.Q_40_1 if n <= (1 << 31) else Primes.Q_60_1
            ring = PolyRing(n, q, self.device)
            rng = np.random.default_rng(n)
            a = rng.integers(0, q, (rows, n), dtype=np.uint64)
            planes = ring.from_np(a)
            samples = self.timer.run(lambda: ring.to_ntt(planes))
            # correctness: round-trip one row
            rt = u64_to_np(ring.from_ntt(ring.to_ntt(ring.from_np(a[0]))))
            self._record("ntt", f"ntt_forward_{n}", self._backend("ntt"), n,
                         samples, rows, bool(np.array_equal(rt, a[0])),
                         batch=rows)

    def benchmark_poly_mul(self, degrees=(1024,), batch: int = 2048):
        """Negacyclic products of a batch (``PolyRing.multiply``: the fused
        product kernel on the card up to N=8192)."""
        from ..core.params import Primes
        from ..core.poly import PolyRing
        from ..ops.ntt import negacyclic_mul_np
        from ..ops.u64 import u64_to_np

        q = Primes.Q_40_1
        for n in degrees:
            ring = PolyRing(n, q, self.device)
            rng = np.random.default_rng(n)
            a = rng.integers(0, q, (batch, n), dtype=np.uint64)
            b = rng.integers(0, q, (batch, n), dtype=np.uint64)
            ap, bp = ring.from_np(a), ring.from_np(b)
            samples = self.timer.run(lambda: ring.multiply(ap, bp))
            got = u64_to_np(ring.multiply(ring.from_np(a[0]),
                                          ring.from_np(b[0])))
            ok = bool(np.array_equal(got, negacyclic_mul_np(a[0], b[0], q)))
            self._record("poly_mul", f"poly_mul_{n}", self._backend("ntt"),
                         n, samples, batch, ok, batch=batch)

    def benchmark_bootstrap(self, batch: int = 4096, production: bool = True,
                            presets=None):
        """TFHE PBS at the production shapes (TFHE_BOOT_128_K4 and the
        k=1, N=1024 presets) through the plain "mxu" backend and, on the
        card, the per-step kernel "pallas"; decode-checked.  ``presets``
        picks tags among "l2_k4", "l2", "l3" (default all);
        ``production=False`` runs a tiny smoke shape at batch 8."""
        from ..core.bootstrap import (TFHE_BOOT_128, TFHE_BOOT_128_K4,
                                      TFHE_BOOT_128_L2, TfheEngine,
                                      TfheParams)

        todo = ([("l2_k4", TFHE_BOOT_128_K4()), ("l2", TFHE_BOOT_128_L2()),
                 ("l3", TFHE_BOOT_128())] if production else
                [("tiny", TfheParams(
                    n_lwe=16, poly_degree=256, pbs_base_log=7, pbs_level=3,
                    ks_base_log=4, ks_level=8, lwe_noise_std=0.0,
                    glwe_noise_std=0.0))])
        if presets is not None:
            todo = [(t, p) for t, p in todo if t in presets]
        if not production:
            batch = 8
        cache = self._cache()
        for tag, p in todo:
            eng = TfheEngine(p, ext_backend="mxu", device=self.device)
            lwe_sk, _, bsk = cache.get_or_generate(eng, 0)
            msgs = torch.arange(batch, device=self.device) % 2
            cts = [eng.lwe_encrypt(self._gen(100 + i), msgs, lwe_sk)
                   for i in range(self.timer.iters)]
            tp = eng.default_test_poly()
            name = f"pbs_n{p.n_lwe}_N{p.poly_degree}_{tag}"
            engines = [("mxu", eng)]
            if production and p.poly_degree % 128 == 0 \
                    and self.device.type == "cuda":
                # the per-step CMux kernel on the same ggsw_i8 key
                engines.append(("pallas", TfheEngine(
                    p, ext_backend="pallas", device=self.device)))
            for route, e in engines:
                samples = self.timer.run(
                    lambda i, e=e: e.bootstrap_with_test_poly(cts[i], bsk,
                                                              tp))
                out = e.bootstrap_with_test_poly(cts[0], bsk, tp)
                correct = bool(torch.equal(e.lwe_decrypt(out, lwe_sk),
                                           msgs.to(torch.int32)))
                self._record("bootstrap", name, self._backend(route), batch,
                             samples, batch, correct, batch=batch)

    def benchmark_bootstrap_tfhe256(self, batch: int = 256):
        """PBS at the TFHE_256_SECURE polynomial geometry (N=4096, l=3,
        Bg=2^10 -- parameter_set.cpp:166-191) on the dual-prime "crt"
        external product.  Opt-in from run_full_suite via
        NFA_BENCH_TFHE256=1 (its key is cached after the first run)."""
        from ..core.bootstrap import TfheEngine, TfheParams
        p = TfheParams(n_lwe=1024, poly_degree=4096, glwe_dim=1,
                       pbs_base_log=10, pbs_level=3,
                       ks_base_log=4, ks_level=8,
                       lwe_noise_std=2.0 ** 10, glwe_noise_std=2.0 ** 4,
                       plaintext_modulus=16)
        eng = TfheEngine(p, ext_backend="crt", device=self.device)
        lwe_sk, _, bsk = self._cache().get_or_generate(eng, 0)
        msgs = torch.arange(batch, device=self.device) % 8
        ct = eng.lwe_encrypt(self._gen(3), msgs, lwe_sk)
        tp = eng.default_test_poly()
        samples = self.timer.run(
            lambda: eng.bootstrap_with_test_poly(ct, bsk, tp))
        out = eng.bootstrap_with_test_poly(ct, bsk, tp)
        correct = bool(torch.equal(eng.lwe_decrypt(out, lwe_sk),
                                   msgs.to(torch.int32)))
        self._record("bootstrap", "pbs_n1024_N4096_l3_tfhe256",
                     self._backend("crt"), batch, samples, batch, correct,
                     batch=batch)

    def benchmark_zk(self, log_constraints: int = 12, msm_points: int = 4096,
                     msm: bool = True):
        """ZK proving scale: Groth16 prove over a 2^log_constraints-gate
        multiplication chain and raw BN254 G1 and G2 MSMs.  ``correct`` =
        the proof verifies under the real pairing / the MSM equals the
        host big-integer Pippenger."""
        from ..zk.bulletproofs import _scalars
        from ..zk.curve import bn254_g1
        from ..zk.curve_g2 import bn254_g2
        from ..zk.groth16 import (R, CircuitBuilder, Groth16Prover,
                                  Groth16Verifier)
        from ..zk.pairing import G2_GENERATOR, g2_msm, g2_mul

        dev = self.device
        m = 1 << log_constraints
        cb = CircuitBuilder()
        x = cb.public_input()
        w = cb.private_input()
        cur = cb.mul(x, w)
        for _ in range(m - 2):
            cur = cb.mul(cur, w)
        r1cs = cb.build()
        vals = {0: 1, 1: 3, 2: 2}
        acc, wid = 3, 3
        for _ in range(m - 1):
            acc = acc * 2 % R
            vals[wid] = acc
            wid += 1
        prover = Groth16Prover(device=dev)
        setup = prover.setup(r1cs)
        proof = prover.prove(setup, vals)         # warm the paths
        # prove() ends in host reads: the thunk returns no tensor
        samples = self.timer.run(lambda: (prover.prove(setup, vals), 0)[1])
        verifier = Groth16Verifier(dev)
        ok = verifier.verify(setup, [3], proof)
        backend = self._backend("groth16")
        self._record("zk", f"groth16_prove_2e{log_constraints}", backend,
                     m, samples, 1, bool(ok), batch=1, unit="proof/s")
        vsamples = self.timer.run(
            lambda: (verifier.verify(setup, [3], proof), 0)[1])
        self._record("zk", f"groth16_verify_2e{log_constraints}", backend,
                     m, vsamples, 1, bool(ok), batch=1, unit="verify/s")
        if not msm:
            return

        c = bn254_g1(dev)
        rng = np.random.default_rng(7)
        svals = [int(s) for s in rng.integers(1, 1 << 62, msm_points)]
        pts = c.fixed_base_mul(list(range(1, msm_points + 1)))
        limbs = _scalars(svals, device=dev)
        out = c.msm(limbs, pts)
        samples = self.timer.run(lambda: c.msm(limbs, pts))
        want = c.msm(limbs, pts, backend="host")
        ga, gb, gi = c.to_affine_ints(out)
        wa, wb, wi = c.to_affine_ints(want)
        ok = (np.array_equal(ga, wa) and np.array_equal(gb, wb)
              and np.array_equal(gi, wi))
        self._record("zk", f"msm_bn254_{msm_points}", self._backend("msm"),
                     msm_points, samples, msm_points, bool(ok),
                     batch=msm_points)

        # the G2 MSM (Fq2 Pippenger); smaller: the host check is an FQ2
        # big-integer Pippenger
        g2n = max(64, msm_points // 8)
        g2c = bn254_g2(dev)
        ks = [int(k) for k in rng.integers(1, 1 << 16, g2n)]
        aff = [g2_mul(G2_GENERATOR, k) for k in ks]
        pts2 = g2c.from_affine_pairs(aff)
        svals2 = [int(s) for s in rng.integers(1, 1 << 62, g2n)]
        limbs2 = _scalars(svals2, device=dev)
        out2 = g2c.msm(limbs2, pts2)
        samples = self.timer.run(lambda: g2c.msm(limbs2, pts2))
        got_aff = g2c.to_affine_pairs((out2[0][None], out2[1][None],
                                       out2[2][None]))[0]
        ok2 = got_aff == g2_msm(aff, svals2)
        self._record("zk", f"msm_bn254_g2_{g2n}", self._backend("msm"), g2n,
                     samples, g2n, bool(ok2), batch=g2n)

    def benchmark_memory(self):
        """Dispatch floor + copy bandwidth (the reference's memory suite,
        cpp/src/comprehensive_benchmark.cpp, BENCHMARK_REPORT.md:189-217).

        The dispatch_floor row is the fixed cost of one tiny elementwise
        call closed by ``force_execution``; it is kept on the runner and
        subtracted into later rows' mean_minus_floor_us column."""
        dev = self.device
        tiny = [torch.full((8, 128), i + 1, dtype=torch.int32, device=dev)
                for i in range(self.timer.iters)]
        samples = self.timer.run(lambda i: tiny[i] + 1)
        ok = bool(int((tiny[0] + 1)[0, 0]) == 2)
        self.dispatch_floor_s = min(samples)
        self._record("memory", "dispatch_floor", self._backend("plain"),
                     8 * 128 * 4, samples, 1, ok, batch=1,
                     unit="dispatch/s")

        # host->device and device->host copies of 16 MB (the reference's
        # largest memcpy row is 16384 KB), from pageable host memory
        nbytes = 16 * 1024 * 1024
        arrs = [torch.from_numpy(np.random.default_rng(i).integers(
            0, 2 ** 31, nbytes // 4, dtype=np.int32))
            for i in range(self.timer.iters)]
        samples = self.timer.run(lambda i: arrs[i].to(dev, copy=True))
        self._record("memory", "h2d_16mb", self._backend("copy"), nbytes,
                     samples, nbytes, True, batch=1, unit="bytes/s")
        dev_arrs = [a.to(dev) + i for i, a in enumerate(arrs)]
        force_execution(dev_arrs)
        samples = self.timer.run(
            lambda i: dev_arrs[i].to("cpu", copy=True))
        ok = all(torch.equal(d.cpu(), a + i)
                 for i, (d, a) in enumerate(zip(dev_arrs, arrs)))
        self._record("memory", "d2h_16mb", self._backend("copy"), nbytes,
                     samples, nbytes, ok, batch=1, unit="bytes/s")

    def benchmark_zk_proof_systems(self):
        """Bulletproofs + PLONK prove/verify rows with proof sizes, against
        the reference's README targets (README.md:82-84): a 64-bit range
        proof and the x*y = z PLONK circuit."""
        from ..zk.bulletproofs import (BulletproofsGens, BulletproofsProver,
                                       BulletproofsVerifier)
        from ..zk.curve import bn254_g1
        from ..zk.plonk import PlonkCircuit, PlonkProver, PlonkVerifier

        dev = self.device
        backend = self._backend("proof")
        curve = bn254_g1(dev)
        n_bits = 64
        gens = BulletproofsGens.generate(curve, n_bits)
        prover = BulletproofsProver(curve)
        verifier = BulletproofsVerifier(curve)
        rng = np.random.default_rng(9)
        vals = [int.from_bytes(rng.bytes(8), "little")
                for _ in range(self.timer.iters)]
        blinds = [prover.random_scalar() for _ in vals]
        coms = [prover.commit(v, b, gens) for v, b in zip(vals, blinds)]
        samples = self.timer.run(
            lambda i: prover.prove_range(vals[i], blinds[i], n_bits, gens))
        proofs = [prover.prove_range(v, b, n_bits, gens)
                  for v, b in zip(vals, blinds)]
        # uncompressed size: 4 points + 3 scalars + IPA (2 log2 n points +
        # 2 scalars); the reference's ~700 B claim is compressed points
        bp_bytes = 4 * 64 + 3 * 32 + 2 * int(math.log2(n_bits)) * 64 + 2 * 32
        oks = []
        samples_v = self.timer.run(
            lambda i: oks.append(verifier.verify_range(
                coms[i], proofs[i], n_bits, gens)))
        ok_all = all(verifier.verify_range(c, p, n_bits, gens)
                     for c, p in zip(coms, proofs))
        self._record("zk", f"bp_range_prove_{n_bits}", backend, n_bits,
                     samples, 1, bool(ok_all), batch=1, unit="proof/s",
                     proof_bytes=bp_bytes)
        self._record("zk", f"bp_range_verify_{n_bits}", backend, n_bits,
                     samples_v, 1, bool(all(oks)), batch=1, unit="verify/s",
                     proof_bytes=bp_bytes)

        c = PlonkCircuit()
        z = c.public_input()
        x = c.new_var()
        y = c.new_var()
        xy = c.mul(x, y)
        c.assert_equal(xy, z)
        pprover = PlonkProver(device=dev)
        psetup = pprover.setup(c, kzg_seed=1)
        asg = [{z: 42, x: 6, y: 7, xy: 42} for _ in range(self.timer.iters)]
        samples = self.timer.run(lambda i: pprover.prove(psetup, asg[i],
                                                         [42]))
        pproofs = [pprover.prove(psetup, a, [42]) for a in asg]
        pverifier = PlonkVerifier(dev)
        plonk_bytes = 64 * len(pproofs[0].commits) + \
            32 * len(pproofs[0].evals)
        oks2 = []
        samples_v = self.timer.run(
            lambda i: oks2.append(pverifier.verify(psetup, [42],
                                                   pproofs[i])))
        ok_all2 = all(pverifier.verify(psetup, [42], p) for p in pproofs)
        self._record("zk", "plonk_prove", backend, len(c.gates), samples,
                     1, bool(ok_all2), batch=1, unit="proof/s",
                     proof_bytes=plonk_bytes)
        self._record("zk", "plonk_verify", backend, len(c.gates),
                     samples_v, 1, bool(all(oks2)), batch=1,
                     unit="verify/s", proof_bytes=plonk_bytes)

    def benchmark_ckks(self):
        """CKKS leveled multiply-relin-rescale at the CKKS_128_ML chain
        (N=16384, 5 moduli -- parameter_set.cpp:226-259), one multiply an
        op over 8 timed iterations, precision checked elementwise."""
        from ..core.ckks import CkksEngine
        from ..core.params import CKKS_128_ML

        params = CKKS_128_ML()
        eng = CkksEngine(params, device=self.device)
        gen = self._gen(0)
        sk = eng.generate_secret_key(gen)
        pk = eng.generate_public_key(gen, sk)
        rlk = eng.generate_relin_keys(gen, sk)
        n_slots = params.poly_degree // 2
        rng = np.random.default_rng(5)
        va = rng.uniform(-1, 1, n_slots)
        vb = rng.uniform(-1, 1, n_slots)
        ca = eng.encrypt(gen, va, pk)
        cb = eng.encrypt(gen, vb, pk)
        cbs = [eng.encrypt(gen, vb, pk)
               for _ in range(max(self.timer.iters, 8))]
        saved = self.timer.iters
        self.timer.iters = max(saved, 8)
        try:
            samples = self.timer.run(
                lambda i: eng.multiply_relin_rescale(ca, cbs[i], rlk).c0)
        finally:
            self.timer.iters = saved
        out = eng.multiply_relin_rescale(ca, cb, rlk)
        got = eng.decrypt(out, sk)
        correct = bool(np.max(np.abs(np.real(got) - va * vb)) < 1e-3)
        self._record("ckks", "ckks_mul_relin_rescale_N16384",
                     self._backend("ckks"), params.poly_degree, samples,
                     1, correct, batch=1, unit="mul/s (8192 slots/mul)")

    @staticmethod
    def _ballot_params():
        from ..core.params import FHEScheme, ParameterSet
        return ParameterSet(
            scheme=FHEScheme.TFHE, poly_degree=1024,
            moduli=[1095216660481], lwe_dimension=630,
            lwe_noise_std=3.2e-11, glwe_dimension=1,
            decomp_base_log=23, decomp_level=1, plaintext_modulus=64)

    def benchmark_ballot(self, depth: int = 20):
        """End-to-end ballot submission at a voter scale of 2^depth: one-hot
        encrypt + an 8-bit Bulletproofs validity proof + a Groth16
        Poseidon-Merkle eligibility proof, the chain of
        VotingSystem.submit_ballot (api/voting.py).  The Merkle path is
        synthesized (root = fold of random siblings): the same per-ballot
        work as a real 2^depth-leaf tree without building it."""
        from ..core.encrypt import EncryptionEngine
        from ..core.keys import KeyManager
        from ..zk.bulletproofs import (BulletproofsGens, BulletproofsProver,
                                       BulletproofsVerifier)
        from ..zk.circuits import EligibilityCircuit
        from ..zk.curve import bn254_g1
        from ..zk.groth16 import Groth16Prover, Groth16Verifier

        dev = self.device
        params = self._ballot_params()
        eng = EncryptionEngine(params, device=dev)
        km = KeyManager(params, eng.ring)
        gen = self._gen(0)
        sk = km.generate_secret_key(gen)
        pk = km.generate_public_key(gen, sk)

        curve = bn254_g1(dev)
        n_bits = 8
        gens = BulletproofsGens.generate(curve, n_bits)
        bp_prover = BulletproofsProver(curve)
        bp_verifier = BulletproofsVerifier(curve)

        circ = EligibilityCircuit(depth, device=dev)
        g16_prover = Groth16Prover(rng_seed=7, device=dev)
        g16_setup = g16_prover.setup(circ.r1cs)
        g16_verifier = Groth16Verifier(dev)

        rng = np.random.default_rng(11)
        iters = max(self.timer.iters, 3)
        wits = []
        for i in range(iters):
            vid = int(rng.integers(1, 1 << 62)) | (i << 62)
            secret = int(rng.integers(1, 1 << 62))
            path = [int(x) for x in rng.integers(1, 1 << 62, depth)]
            bits = [int(b) for b in rng.integers(0, 2, depth)]
            node = circ.leaf(vid)
            for sib, bit in zip(path, bits):
                node = (circ.hash2_int(sib, node) if bit
                        else circ.hash2_int(node, sib))
            wits.append((vid, secret, path, bits, node))
        blinds = [bp_prover.random_scalar() for _ in range(iters)]
        choices = [int(rng.integers(0, 4)) for _ in range(iters)]
        results = {}

        def submit(i):
            vid, secret, path, bits, root = wits[i]
            onehot = np.zeros(4, dtype=np.uint64)
            onehot[choices[i]] = 1
            ct = eng.encrypt(self._gen(5000 + i), onehot, pk)
            com = bp_prover.commit(choices[i], blinds[i], gens)
            bp = bp_prover.prove_range(choices[i], blinds[i], n_bits, gens)
            wit = circ.generate_witness(vid, secret, path, bits, root)
            g16 = g16_prover.prove(g16_setup, wit.assignment)
            results[i] = (ct, com, bp, g16, wit.public_inputs)
            return ct.c0

        saved_w, saved_i = self.timer.warmup, self.timer.iters
        self.timer.warmup, self.timer.iters = 1, iters
        try:
            samples = self.timer.run(submit)
        finally:
            self.timer.warmup, self.timer.iters = saved_w, saved_i

        # verify every timed ballot end to end
        ok = True
        for i, (ct, com, bp, g16, pubs) in results.items():
            ok = ok and bp_verifier.verify_range(com, bp, n_bits, gens)
            ok = ok and g16_verifier.verify(g16_setup, pubs, g16)
            dec = eng.decode(eng.phase(ct, sk), 4)
            want = np.zeros(4, dtype=np.uint64)
            want[choices[i]] = 1
            ok = ok and bool(np.array_equal(dec, want))
        self._record("pipeline", f"ballot_submit_depth{depth}",
                     self._backend("ballot"), depth, samples, 1, bool(ok),
                     batch=1, unit="ballot/s", proof_bytes=0)

    def benchmark_pipeline(self, ballots: int = 64):
        """Encrypted-ballot tally throughput (``batch_add`` of the
        ballots), decode-checked."""
        from ..core.encrypt import EncryptionEngine
        from ..core.keys import KeyManager

        params = self._ballot_params()
        eng = EncryptionEngine(params, device=self.device)
        km = KeyManager(params, eng.ring)
        gen = self._gen(0)
        sk = km.generate_secret_key(gen)
        pk = km.generate_public_key(gen, sk)
        cts = [eng.encrypt(gen, 1, pk) for _ in range(ballots)]
        samples = self.timer.run(lambda: eng.batch_add(cts).c0)
        total = eng.batch_add(cts)
        dec = eng.decode(eng.phase(total, sk))
        self._record("pipeline", f"tally_{ballots}", self._backend("plain"),
                     ballots, samples, ballots,
                     bool(int(dec[0]) == ballots % eng.t), batch=ballots)

    def export_all(self, outdir: str):
        """Write the CSVs, JSON and HTML of the results so far (called
        after every stage, so a cut run keeps the finished stages' rows)."""
        os.makedirs(outdir, exist_ok=True)
        for suite_name, text in self.export_csv().items():
            with open(os.path.join(outdir, f"{suite_name}.csv"), "w") as f:
                f.write(text)
        with open(os.path.join(outdir, "benchmark_results.json"), "w") as f:
            f.write(self.export_json())
        with open(os.path.join(outdir, "benchmark_report.html"), "w") as f:
            f.write(self.export_html())

    def run_full_suite(self, production: bool = True,
                       autodump_dir: str | None = None):
        def stage(name):
            if autodump_dir and self.results:
                self.export_all(autodump_dir)
            print(f"[bench_suite] {name}...", file=sys.stderr, flush=True)

        stage("memory")
        self.benchmark_memory()      # first: later rows use the floor
        stage("modmul")
        self.benchmark_modmul()
        stage("ntt")
        self.benchmark_ntt()
        stage("poly_mul")
        self.benchmark_poly_mul()
        stage("bootstrap")
        self.benchmark_bootstrap(production=production)
        if production and os.environ.get("NFA_BENCH_TFHE256"):
            stage("bootstrap_tfhe256")
            self.benchmark_bootstrap_tfhe256()
        stage("zk")
        self.benchmark_zk(log_constraints=12 if production else 6,
                          msm_points=4096 if production else 64)
        if production:
            stage("zk proof systems (BP + PLONK)")
            self.benchmark_zk_proof_systems()
            stage("ckks")
            self.benchmark_ckks()
        stage("pipeline")
        self.benchmark_pipeline()
        if production and os.environ.get("NFA_BENCH_ZK_BIG"):
            # Groth16 proving at 2^14 (and, with NFA_BENCH_ZK_2E16, 2^16)
            # constraints, last and with fewer timed iterations
            warm, iters = self.timer.warmup, self.timer.iters
            self.timer.warmup, self.timer.iters = 1, 2
            try:
                stage("zk groth16 2^14")
                self.benchmark_zk(log_constraints=14, msm=False)
                if os.environ.get("NFA_BENCH_ZK_2E16"):
                    stage("zk groth16 2^16")
                    self.benchmark_zk(log_constraints=16, msm=False)
            finally:
                self.timer.warmup, self.timer.iters = warm, iters
        if autodump_dir:
            self.export_all(autodump_dir)
        return self.results

    # -- recording / export --------------------------------------------------
    def _record(self, suite, name, backend, size, samples, ops_per_iter,
                correct, batch=1, unit="op/s", proof_bytes=0):
        mean, std = StatisticalAnalyzer.analyze(samples)
        tput = ops_per_iter / mean if mean else 0.0
        base = _BASELINES.get(name, 0.0)
        # floor-adjusted column: only meaningful for one-call thunks; proof
        # rows (many calls) keep the raw mean only
        floor = getattr(self, "dispatch_floor_s", None)
        adj = -1.0
        if floor is not None and suite in ("modmul", "ntt", "poly_mul",
                                           "bootstrap", "ckks", "pipeline"):
            adj = max(mean - floor, 0.0) * 1e6
        self.results.append(BenchmarkResult(
            suite=suite, name=name, backend=backend, size=size, batch=batch,
            mean_us=mean * 1e6, stddev_us=std * 1e6,
            throughput_ops_s=tput,
            speedup_vs_baseline=(tput / base if base else 0.0),
            correct=correct, unit=unit, mean_minus_floor_us=adj,
            proof_bytes=proof_bytes))

    def export_csv(self) -> dict:
        """Per-suite CSVs, the reference's NTT_(degree=1024).csv column
        layout plus batch + speedup columns."""
        out = {}
        suites = {r.suite for r in self.results}
        for s in suites:
            buf = io.StringIO()
            w = csv.writer(buf)
            w.writerow(["name", "backend", "size", "batch", "mean_us",
                        "stddev_us", "throughput_ops_s",
                        "speedup_vs_baseline", "correct", "unit",
                        "mean_minus_floor_us", "proof_bytes"])
            for r in self.results:
                if r.suite == s:
                    w.writerow([r.name, r.backend, r.size, r.batch,
                                f"{r.mean_us:.2f}", f"{r.stddev_us:.2f}",
                                f"{r.throughput_ops_s:.1f}",
                                f"{r.speedup_vs_baseline:.2f}", r.correct,
                                r.unit,
                                f"{r.mean_minus_floor_us:.2f}",
                                r.proof_bytes])
            out[s] = buf.getvalue()
        return out

    def export_json(self) -> str:
        return json.dumps([asdict(r) for r in self.results], indent=2)

    def export_html(self) -> str:
        """Self-contained HTML report (the reference exports CSV/JSON/HTML,
        comprehensive_benchmark.h:237-247)."""
        rows = []
        for r in self.results:
            cls = "ok" if r.correct else "bad"
            rows.append(
                f"<tr class='{cls}'><td>{r.suite}</td><td>{r.name}</td>"
                f"<td>{r.backend}</td><td>{r.size}</td><td>{r.batch}</td>"
                f"<td>{r.mean_us:.2f}</td><td>{r.stddev_us:.2f}</td>"
                f"<td>{r.throughput_ops_s:,.1f}</td>"
                f"<td>{r.speedup_vs_baseline:.2f}</td>"
                f"<td>{r.correct}</td></tr>")
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return (
            "<!doctype html><html><head><meta charset='utf-8'>"
            "<title>node-fhe-accelerate-tpu (PyTorch) benchmarks</title>"
            "<style>"
            "body{font-family:system-ui;margin:2rem}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:4px 8px;text-align:right}th{background:#eee}"
            "td:nth-child(-n+3){text-align:left}"
            "tr.bad{background:#fdd}</style></head><body>"
            f"<h1>Benchmark report</h1><p>device: {kind} "
            f"({self.device.type})</p><table><tr><th>suite</th><th>name</th>"
            "<th>backend</th><th>size</th><th>batch</th><th>mean µs</th>"
            "<th>stddev µs</th><th>ops/s</th><th>vs baseline</th>"
            "<th>correct</th></tr>" + "".join(rows) +
            "</table></body></html>")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else os.path.join("build", "bench_suite")
    runner = ComprehensiveBenchmarkRunner(
        keycache_dir=os.path.join(outdir, "keycache"))
    runner.run_full_suite(autodump_dir=outdir)
    runner.export_all(outdir)
    for r in runner.results:
        print(f"{r.suite:10s} {r.name:28s} {r.throughput_ops_s:14,.1f} ops/s"
              f"  x{r.speedup_vs_baseline:8.2f}  correct={r.correct}")


if __name__ == "__main__":
    main()
