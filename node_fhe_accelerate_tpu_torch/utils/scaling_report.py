"""Multi-device scaling report (counterpart of
node_fhe_accelerate_tpu/utils/scaling_report.py).

``run`` times the sharded bootstrap (parallel/pbs.py: the batch over the
"data" axis, the key replicated) on meshes of 1, 2 and 4 positions with a
FIXED batch a position (weak scaling) and returns the CSV text:

* ``compile_s`` -- the first call, with whatever it builds (the kernels at
  their first launch, an "auto" engine's race);
* ``steady_mean_s`` -- the mean of chained calls (each bootstraps the
  previous output), each closed by a synchronize of the mesh's cards;
* ``ici_bytes_per_step`` -- the bytes one sharded bootstrap moves between
  distinct mesh positions (``collectives.traffic``): 0, since the batch is
  split and the key replicated and nothing in the blind rotate, extract or
  key switch crosses positions.

Positions that share a card run one after another on it, so on one card
the weak-scaling efficiency reads the card's saturation, not a second
card's gain; each row names the mesh's distinct devices.

``collective_rows`` adds the paths that do communicate: the distributed
NTT negacyclic multiply (two all-to-alls a transform) and the sharded MSM
(K - 1 partial points to the first position), each with the bytes it moved
between positions.

Usage (a card, 4 positions on cuda:0 unless the machine has 4 cards):

    python -m node_fhe_accelerate_tpu_torch.utils.scaling_report [outdir]

writes ``<outdir>/scaling.csv`` (default ``build/scaling``).
"""
from __future__ import annotations

import csv
import io
import os
import sys
import time

import numpy as np
import torch

from ..parallel import collectives
from ..parallel.mesh import gather, make_mesh
from .profiling import block_until_ready

__all__ = ["run", "collective_rows", "rows_csv", "default_devices", "main"]

HEADER = ["devices", "batch", "compile_s", "steady_mean_s",
          "bootstraps_per_s", "weak_scaling_efficiency",
          "ici_bytes_per_step", "correct", "platform", "note"]


def default_devices(n: int = 4) -> list:
    """n positions: one a card when the machine has n cards, else the
    first card n times."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(e.g. ['cpu'] * 4) to run on the CPU")
    if count >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _layout(devs) -> str:
    distinct = list(dict.fromkeys(str(d) for d in devs))
    return f"{len(devs)} positions on {'+'.join(distinct)}"


def run(per_device_batch: int = 64, tiny: bool = True, devices=None,
        positions=(1, 2, 4), params=None, backend: str = "mxu",
        iters: int = 3, seed: int = 0) -> str:
    """The scaling CSV text.  ``tiny=True`` uses a small-but-real TFHE
    shape (n=64, N=256); ``params`` overrides it (e.g. TFHE_BOOT_128_K4).
    ``backend`` is the engine's ``ext_backend``; ``devices`` lists one
    device a position (default ``default_devices(max(positions))``)."""
    from ..core.bootstrap import TfheEngine, TfheParams
    from ..parallel.pbs import (replicate_bsk, shard_lwe_batch,
                                sharded_bootstrap_fn)

    if params is None:
        params = TfheParams(n_lwe=64, poly_degree=256, pbs_base_log=8,
                            pbs_level=2, ks_base_log=4, ks_level=8,
                            lwe_noise_std=64.0, glwe_noise_std=4.0) \
            if tiny else TfheParams()
    devs = list(devices) if devices is not None else \
        default_devices(max(positions))
    eng = TfheEngine(params, ext_backend=backend, device=devs[0])
    gen = torch.Generator(device=devs[0]).manual_seed(seed)
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, lwe_sk, glwe_sk)
    tp = eng.default_test_poly()

    rows = []
    base_rate = None
    for d in positions:
        if d > len(devs):
            break
        batch = per_device_batch * d
        mesh = make_mesh(d, data=d, devices=devs[:d])
        msgs = torch.arange(batch, device=devs[0]) % 2
        ct0 = eng.lwe_encrypt(gen, msgs, lwe_sk)
        fpbs = sharded_bootstrap_fn(eng, mesh)
        ct_s = shard_lwe_batch(ct0, mesh)
        bsk_r = replicate_bsk(bsk, mesh)

        collectives.traffic.reset()
        t0 = time.perf_counter()
        out = fpbs(ct_s, bsk_r, tp)
        block_until_ready(out)
        compile_s = time.perf_counter() - t0
        moved = collectives.traffic.bytes

        # steady state: chained calls (the output is the next input)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fpbs(out, bsk_r, tp)
            block_until_ready(out)
        steady = (time.perf_counter() - t0) / iters
        rate = batch / steady
        dec = eng.lwe_decrypt(gather(out, devs[0]), lwe_sk)
        correct = bool(torch.equal(dec, msgs.to(torch.int32)))
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d)
        rows.append((d, batch, compile_s, steady, rate, eff, moved, correct,
                     _layout(devs[:d])))
        print(f"positions={d} batch={batch} first={compile_s:.3f}s "
              f"steady={steady * 1e3:.2f}ms {rate:,.0f} bootstraps/s "
              f"efficiency={eff:.3f} bytes={moved} correct={correct}",
              flush=True)

    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(HEADER)
    note = (f"sharded PBS ({backend}): replicated key, no collective -> 0 "
            "bytes between positions; positions on one card run one after "
            "another")
    for d, batch, compile_s, steady, rate, eff, moved, correct, lay in rows:
        w.writerow([d, batch, f"{compile_s:.4f}", f"{steady:.6f}",
                    f"{rate:.1f}", f"{eff:.3f}", moved, correct, lay,
                    note if d == 1 else ""])
    return buf.getvalue()


def collective_rows(n_devices: int = 4, devices=None,
                    iters: int = 3) -> list:
    """Rows for the communicating paths: the distributed NTT negacyclic
    multiply at N=4096 over Q_40_1 and the sharded BN254 MSM of 24 points,
    each with its first-call and steady times and the bytes it moved
    between positions (``collectives.traffic``)."""
    from ..core.params import Primes
    from ..ops import limbs as lb
    from ..ops.ntt import negacyclic_mul_np
    from ..ops.u64 import u64_from_np, u64_to_np
    from ..parallel.dist_ntt import DistNTT
    from ..parallel.msm import sharded_msm
    from ..zk.curve import _host_pippenger, bn254_g1

    devs = list(devices) if devices is not None else \
        default_devices(n_devices)
    devs = devs[:n_devices]
    mesh = make_mesh(len(devs), data=len(devs), devices=devs)
    lay = _layout(devs)
    rows = []

    # ---- distributed NTT negacyclic multiply, the column axis split ----
    n_ntt, n1 = 4096, 64
    q = Primes.Q_40_1
    dn = DistNTT(n_ntt, q, n1=n1)
    rng = np.random.default_rng(17)
    a = rng.integers(0, q, n_ntt, dtype=np.uint64)
    b = rng.integers(0, q, n_ntt, dtype=np.uint64)

    def split(x):
        g = tuple(p.reshape(n1, n_ntt // n1) for p in u64_from_np(x))
        parts = [torch.chunk(p, len(devs), dim=-1) for p in g]
        return [(lo.contiguous().to(d), hi.contiguous().to(d))
                for lo, hi, d in zip(*parts, devs)]

    ga, gb = split(a), split(b)
    collectives.traffic.reset()
    t0 = time.perf_counter()
    out = dn.negacyclic_mul_local(ga, gb)
    block_until_ready(out)
    compile_s = time.perf_counter() - t0
    moved = collectives.traffic.bytes
    got = u64_to_np(tuple(torch.cat([o[i].cpu() for o in out], dim=-1)
                          for i in (0, 1))).reshape(n_ntt)
    correct = bool(np.array_equal(got, negacyclic_mul_np(a, b, q)))
    t0 = time.perf_counter()
    for _ in range(iters):
        block_until_ready(dn.negacyclic_mul_local(ga, gb))
    steady = (time.perf_counter() - t0) / iters
    rows.append((len(devs), n_ntt, compile_s, steady, 1.0 / steady, -1.0,
                 moved, correct, lay,
                 f"dist-NTT negacyclic multiply N={n_ntt} (4-step, "
                 "all-to-all transposes); bytes moved between positions"))
    print(f"dist-ntt N={n_ntt}: first={compile_s:.3f}s "
          f"steady={steady * 1e3:.2f}ms bytes={moved} correct={correct}",
          flush=True)

    curve = bn254_g1(devs[0])
    n_msm = 24
    ks = [int(rng.integers(1, 1 << 30)) for _ in range(n_msm)]
    pts = curve.fixed_base_mul(ks, backend="host")
    ss = [int(rng.integers(1, 1 << 62)) for _ in range(n_msm)]
    collectives.traffic.reset()
    t0 = time.perf_counter()
    got_pt, moved = sharded_msm(curve, lb.limbs_from_ints(ss, 2, devs[0]),
                                pts, mesh, _want_ici_bytes=True)
    block_until_ready(got_pt)
    compile_s = time.perf_counter() - t0
    want_pt = _host_pippenger(curve.fq.q, ss, curve._points_to_host(pts))
    got_aff = curve.to_affine_ints(tuple(c[None] for c in got_pt))
    want_aff = curve.to_affine_ints(curve._points_from_host([want_pt]))
    correct = (not got_aff[2][0] and not want_aff[2][0]
               and (int(got_aff[0][0]), int(got_aff[1][0]))
               == (int(want_aff[0][0]), int(want_aff[1][0])))
    rows.append((len(devs), n_msm, compile_s, -1.0, -1.0, -1.0, moved,
                 bool(correct), lay,
                 "sharded Pippenger MSM (K - 1 partial points to the "
                 "first position); bytes moved between positions"))
    print(f"sharded-msm n={n_msm}: first={compile_s:.3f}s "
          f"bytes={moved} correct={correct}", flush=True)
    return rows


def rows_csv(rows) -> str:
    """``collective_rows``' rows as CSV lines under ``run``'s header."""
    buf = io.StringIO()
    w = csv.writer(buf)
    for d, size, compile_s, steady, rate, eff, moved, correct, lay, note \
            in rows:
        w.writerow([d, size, f"{compile_s:.4f}",
                    f"{steady:.6f}" if steady >= 0 else "",
                    f"{rate:.1f}" if rate >= 0 else "",
                    f"{eff:.3f}" if eff >= 0 else "",
                    moved, correct, lay, note])
    return buf.getvalue()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else os.path.join("build", "scaling")
    text = run() + rows_csv(collective_rows())
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "scaling.csv")
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
