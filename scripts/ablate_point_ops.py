#!/usr/bin/env python3
"""The point ops of the ZK path on one GPU: K10's point kernel by ablation,
and the MSMs and the range proof against another tree's.

    python3 scripts/ablate_point_ops.py [--iters 50] [--parent DIR]
        [--repeats 2] [--prove] [--seed 7]

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc.  It builds, beside ``csrc/digits.cu``, copies with one choice of the
point kernel changed: one or two lanes a point instead of four (one lane
computes a level's products one after another), and the CIOS product's
rows rolled or fully unrolled instead of unrolled 4 at a time.  Each
computes the same function: every copy is held equal to the plain version
(``jadd_reference``/``jdbl_reference``) on 32 points, then timed in turns,
two rounds, as device time of back-to-back launches (``timing.device_ms``)
of an add and a double of BN254 (D=32) and BLS12-381 (D=48) points at the
MSM tail's widths 1 and 32, beside the device time of an empty kernel
launched back to back (``torch.cuda._sleep(0)``), the launch floor.  The
copies go to build/ablation_point/ (ignored by git).

With ``--parent DIR``: ``DIR`` holds another tree's package, e.g. a commit's
``git archive <commit> node_fhe_accelerate_tpu_torch | tar -x -C DIR``.
Each tree runs in a process of its own (its ``zk/``, ``ops/`` and
``csrc/digits.cu``, its kernels built into its own ``build/``), in the
order parent, this tree, this tree, parent, and times, after one call to
warm up: ``msm_bn254_4096`` as the JAX suite builds it (points [1..4096] G,
62-bit scalars from ``default_rng(seed)``), the BLS12-381 G1 MSM at
n = 1024, and with ``--prove`` one 64-bit Bulletproofs ``prove_range``;
each on the host clock around a call that ends in a synchronize, with the
kernels' launch counts of the call (K9 ``_mul_t_raw``, K10's single product
``pallas_field_mul`` and, where the tree has them, its point kernel
``pallas_jadd``/``pallas_jdbl``) and the result's affine coordinates, which
must agree between the trees.

Prints the card's name and power limit, then one JSON object per variant
and, with ``--parent``, one per run and a last one with the runs side by
side.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ablation_point")
sys.path.insert(0, ROOT)
from chip_smoke import digits_entry, ptxas_summary  # noqa: E402
from node_fhe_accelerate_tpu_torch.ops import _build  # noqa: E402

LOOP = "#pragma unroll 4\n    for (int i = 0; i < L; ++i) cios_row"
LANES = "constexpr int kLanes = 4;"
# name: {text of csrc/digits.cu: replacement}
ABLATIONS = {
    "base": {},
    "one lane a point": {LANES: "constexpr int kLanes = 1;"},
    "two lanes a point": {LANES: "constexpr int kLanes = 2;"},
    "the product's rows rolled": {
        LOOP: LOOP.replace("unroll 4", "unroll 1")},
    "the product's rows unrolled": {
        LOOP: LOOP.replace("unroll 4", "unroll")},
}

# what one tree's process runs: argv = [seed, repeats, prove]
CHILD = r'''
import json, sys, time
import numpy as np
import torch
from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
from node_fhe_accelerate_tpu_torch.ops.limbs import limbs_from_ints
from node_fhe_accelerate_tpu_torch.zk.bulletproofs import (
    BulletproofsGens, BulletproofsProver)
from node_fhe_accelerate_tpu_torch.zk.curve import bls12_381_g1, bn254_g1

seed, repeats, prove = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
dev = torch.device("cuda")
counters = [("K9", dp._mul_t_raw), ("K10 product", dp.pallas_field_mul)]
counters += [(k, getattr(dp, f)) for k, f in (("K10 jadd", "pallas_jadd"),
                                              ("K10 jdbl", "pallas_jdbl"))
             if hasattr(getattr(dp, f), "launches")]


def timed(fn):
    for _, f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: f.launches
                                           for k, f in counters}


def affine(curve, p):
    x, y, inf = curve.to_affine_ints(p)
    return [str(int(v)) for v in (x, y)] + [bool(inf)]


dp.DIGITS_LIB.load()
out = {"tree": dp.__file__}
for name, make, n in (("msm_bn254_4096", bn254_g1, 4096),
                      ("msm_bls12_381_1024", bls12_381_g1, 1024)):
    curve = make(dev)
    pts = curve.fixed_base_mul(list(range(1, n + 1)), backend="host")
    scal = limbs_from_ints([int(v) for v in np.random.default_rng(seed)
                            .integers(1, 1 << 62, n)], 8, dev)
    timed(lambda: curve.msm(scal, pts))
    runs = [timed(lambda: curve.msm(scal, pts)) for _ in range(repeats)]
    out[name] = {"s": [r[1] for r in runs], "launches": runs[0][2],
                 "result": affine(curve, runs[0][0])}
if prove:
    value = int.from_bytes(np.random.default_rng(9).bytes(8), "little")
    curve = bn254_g1(dev)
    gens = BulletproofsGens.generate(curve, 64)
    prover = BulletproofsProver(curve, rng_seed=3)
    blinding = prover.random_scalar()
    prover.commit(value, blinding, gens)
    proof, secs, launches = timed(
        lambda: prover.prove_range(value, blinding, 64, gens))
    out["prove_range_64"] = {"s": [secs], "launches": launches,
                             "result": [str(proof.t_hat), str(proof.mu)]}
print("RESULT " + json.dumps(out), flush=True)
'''


def run_tree(tree: str, args) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(args.seed), str(args.repeats),
         str(int(args.prove))], cwd=tree, env=env, capture_output=True,
        text=True, timeout=3000)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def ablated_source(name: str) -> str:
    """csrc/digits.cu with ablation ``name``'s edits made."""
    return _build.ablated_sources(["digits.cu"], ABLATIONS[name])[0]


def time_variants(args) -> None:
    """Build every variant, hold it equal to the plain version and time
    it; one JSON object per variant."""
    import torch
    from node_fhe_accelerate_tpu_torch.ops import digits_pallas as dp
    from node_fhe_accelerate_tpu_torch.timing import device_ms
    from node_fhe_accelerate_tpu_torch.zk import curve as zc
    os.makedirs(OUT, exist_ok=True)
    libs = {}
    for i, name in enumerate(ABLATIONS):
        path = os.path.join(OUT, f"digits_ablation_{i}.cu")
        with open(path, "w") as f:
            f.write(ablated_source(name))
        libs[name] = _build.KernelLibrary(path, dp.DIGITS_LIB.functions)
    _build.build_all(list(libs.values()))
    dev = torch.device("cuda")
    floor = device_ms(lambda: torch.cuda._sleep(0), args.iters)[0]
    print(json.dumps({"launch floor ms": floor}), flush=True)
    shapes = {}
    for cname in ("bn254_g1", "bls12_381_g1"):
        c = getattr(zc, cname)(device=dev)
        for b in (1, 32):
            shapes[f"{cname} B={b}"] = (c.fq, c.fixed_base_mul(
                list(range(3, 3 + b)), backend="host"), c.fixed_base_mul(
                list(range(1000, 1000 + b)), backend="host"))
    real = dp.DIGITS_LIB
    try:
        for name, lib in libs.items():
            dp.DIGITS_LIB = lib
            for f, P, Q in (v for k, v in shapes.items() if "B=32" in k):
                if not all(torch.equal(x, y) for x, y in zip(
                        dp.pallas_jadd(f, P, Q) + dp.pallas_jdbl(f, P),
                        dp.jadd_reference(f, P, Q)
                        + dp.jdbl_reference(f, P))):
                    raise AssertionError(f"{name}: != the plain version")
        times = {name: {} for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                dp.DIGITS_LIB = lib
                for label, (f, P, Q) in shapes.items():
                    for op, run in (("add", lambda: dp.pallas_jadd(f, P, Q)),
                                    ("double", lambda: dp.pallas_jdbl(f, P))):
                        times[name].setdefault(f"{op} {label}", []).append(
                            device_ms(run, args.iters)[0])
    finally:
        dp.DIGITS_LIB = real
    for name, lib in libs.items():
        ptxas = [x for x in ptxas_summary(lib.info["log"], digits_entry)
                 if x.startswith("point")]
        print(json.dumps({"variant": name, "ptxas": ptxas,
                          "ms": times[name]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--parent",
                    help="a tree whose node_fhe_accelerate_tpu_torch/ is "
                    "timed beside this one's")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--prove", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_point_ops: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    time_variants(args)
    if not args.parent:
        return 0
    trees = {"parent": os.path.abspath(args.parent), "this tree": ROOT}
    runs = []
    for who in ("parent", "this tree", "this tree", "parent"):
        res = run_tree(trees[who], args)
        print(json.dumps({"run": who, **res}), flush=True)
        runs.append((who, res))
    keys = [k for k in runs[0][1] if k != "tree"]
    side = {k: {who: [s for w, r in runs if w == who for s in r[k]["s"]]
                for who in trees} for k in keys}
    equal = all(r[k]["result"] == runs[0][1][k]["result"]
                for _, r in runs for k in keys)
    print(json.dumps({"seconds": side, "results_equal": equal}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
