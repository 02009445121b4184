#!/usr/bin/env python3
"""Where the time of the NTT kernels (csrc/ntt.cu: K6 forward, K7 inverse,
K8 the fused ring product) goes, by ablation, on one GPU, and how they
compare with another tree's.

    python3 scripts/ablate_ntt_kernels.py [--iters 20] [--seed 5]
        [--parent DIR]

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc. No profiler that reads inside a kernel runs there, so this builds,
beside the real kernels, copies of ``csrc/ntt.cu`` with one part switched
off or changed, and times each, in turns, at the shapes of the paths:
N = 4096 over P1 (forward B = 1536, inverse B = 512: TFHE_256 "crt"; the
narrow form, doubles) and over P_EXT (forward B = 1536: the wide form,
Shoup's products, at the same shape), N = 256 over P_EXT (forward
B = 2560, inverse B = 1280: TFHE_BOOT_128_K4 "ntt"), and K8 at N = 4096,
B = 256 over P1 (its narrow form) and P_EXT (its wide form): the CRT ring
product of TFHE_256; and at B = 1536 over P1.  Parts switched off:
the modular product of either form (an add in its place), the lazy
correction of the wide forward butterfly, the reduction of the narrow
inverse's sums, the twiddle loads, the exchanges through shared memory or
only their barriers, the prefetch of the next polynomial, and everything
but the loads and stores (a copy with the kernel's own access pattern,
with the forward's stores staged or straight from registers).  Changed:
a Montgomery product in place of Shoup's, the wide form for every
modulus, the twiddle tables read from global memory instead of shared
memory, the forward's stores straight from registers (16-byte stores at a
64-byte stride across the warp) instead of staged through the exchange
buffer, the inverse's stores staged too; for K8, its tables in global
memory, both in shared memory (one block an SM at N = 4096), a and b
transformed one after the other, the next pair prefetched during this
pair's inverse, no cap of 128 registers (two blocks an SM); K8 also at
B = 1536, where a block has pairs after its first.  The ablated kernels compute wrong results; only their
times mean anything: base minus ablated is what the part costs where it
is not hidden behind the others.  The times are device times of
back-to-back launches (``timing.device_ms``).  Beside them, the device
time of PyTorch copying the same planes (``copy_``), the least a pass
over these bytes takes.  The copies go to build/ablation_ntt/ (ignored by
git).

``--parent DIR`` also times another tree's K6, K7 and K8, e.g. a commit's
``git archive <commit> node_fhe_accelerate_tpu_torch | tar -x -C DIR``:
its ``ops/ntt_pallas.py`` and ``csrc/ntt.cu`` beside this tree's, through
their ``PallasNTT`` entry points, in the order parent, this tree, this
tree, parent, each read as device time back to back and as the time of
a call with the host's wrapper in between (``timing.cuda_ms``).

Prints the card's name and power limit, then one JSON object per
variant (milliseconds per launch at each shape, two rounds each), per
copy shape, and per compared row.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "node_fhe_accelerate_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ablation_ntt")
sys.path.insert(0, ROOT)
from node_fhe_accelerate_tpu_torch.ops import _build  # noqa: E402

SHOUP = "return y * w.x - __umul64hi(y, w.y) * q;"
F64_MUL = """    const double h = __dmul_rn(y, w);
    const double l = __fma_rn(y, w, -h);
    const double quot = __dsub_rn(__fma_rn(h, m.qinv, kRound), kRound);
    return __dadd_rn(__fma_rn(-quot, m.qd, h), l);"""
STAGED = "constexpr bool kStagedStores = !kInverse;"
UNSTAGED = {STAGED: "constexpr bool kStagedStores = false;"}
COPY = {"      inverse_passes<LOGN, G::kPasses - 1, A>(x, buf, t, tw, m, c, "
        "d);": "",
        "      forward_passes<LOGN, 0, A>(x, buf, t, tw, m);": ""}
# name: {text: replacement}; each text occurs once in csrc/ntt.cu
ABLATIONS = {
    "base": {},
    "without the modular product": {
        SHOUP: "return y + w.x;",
        F64_MUL: "    return __dadd_rn(y, w);"},
    "Montgomery in place of Shoup": {SHOUP: """const u64 lo = y * w.x;
  const u64 m = lo * w.y;
  return __umul64hi(y, w.x) + __umul64hi(m, q) + (lo != 0 ? 1ull : 0ull);"""},
    "the wide form for every modulus": {
        "constexpr u64 kF64MaxQ = 1ull << 46;": "constexpr u64 kF64MaxQ = 0;"},
    "without the lazy correction": {
        "const u64 u = sub_if(x, m.q2);": "const u64 u = x;"},
    "without the reduction of the inverse's sums": {
        "x = reduce(__dadd_rn(u, v), m);": "x = __dadd_rn(u, v);"},
    "without the twiddle loads": {
        "const TW w = blk[g << kHb];":
            "TW w;\n      memcpy(&w, &m, sizeof(TW));"},
    "without the exchanges": {
        "      buf[k * kBuf + swz(coeff<LOGN>(t, e, G::c_lo(FROM)))] = x[k][e];":
            "      ;",
        "      x[k][e] = buf[k * kBuf + swz(coeff<LOGN>(t, e, G::c_lo(TO)))];":
            "      ;"},
    "without the exchange barriers": {
        """  if constexpr (Geom<LOGN>::kT <= 32)
    __syncwarp();
  else
    __syncthreads();""": ""},
    "without the prefetch": {
        "constexpr bool kPrefetch = LOGN <= 13;":
            "constexpr bool kPrefetch = false;"},
    "tables in global memory": {
        "constexpr bool transform_smem_tables() {\n  return LOGN <= 13;":
            "constexpr bool transform_smem_tables() {\n  return false;"},
    "the stores straight from registers": UNSTAGED,
    "the inverse's stores staged too": {
        STAGED: "constexpr bool kStagedStores = true;"},
    "only the loads and stores": COPY,
    "only the loads and stores, straight from registers": {**COPY,
                                                           **UNSTAGED},
    "K8: tables in global memory": {
        "kFwdShared = kNarrow<A> ? LOGN <= 13 : LOGN <= 12;":
            "kFwdShared = false;",
        "kInvShared = kNarrow<A> ? false : LOGN <= 12;":
            "kInvShared = false;"},
    "K8: both tables in shared memory": {
        "kInvShared = kNarrow<A> ? false : LOGN <= 12;":
            "kInvShared = LOGN <= 12;"},
    "K8: a and b one after the other": {
        "kPaired = kNarrow<A> && LOGN <= 12;": "kPaired = false;"},
    "K8: with the prefetch of the next pair": {
        "kPrefetch = false;": "kPrefetch = kNarrow<A>;"},
    "K8: no cap of 128 registers": {
        "kMinBlocks = kNarrow<A> && LOGN == 12 ? 2 : 1;": "kMinBlocks = 1;"},
}
# variants in which K8 takes its wide form below 2^46 too (its tables and
# constants then take the wide form's)
K8_WIDE = {"the wide form for every modulus"}
# (kind, N, B, modulus name): the rows compared with --parent
PARENT_ROWS = [("forward", 4096, 1536, "P1"), ("forward", 4096, 1536, "P2"),
               ("inverse", 4096, 512, "P1"), ("inverse", 4096, 512, "P2"),
               ("forward", 256, 2560, "P_EXT"),
               ("inverse", 256, 1280, "P_EXT"),
               ("negacyclic_mul", 4096, 256, "P1"),
               ("negacyclic_mul", 4096, 256, "P2"),
               ("negacyclic_mul", 4096, 256, "P_EXT"),
               ("forward", 1024, 8192, "Q_40_1"),
               ("forward", 16384, 512, "Q_60_1")]


def ablated_source(name: str) -> str:
    """csrc/ntt.cu with ablation ``name``'s edits made."""
    return _build.ablated_sources(["ntt.cu"], ABLATIONS[name])[0]


def load_wrapper(tree: str):
    """The ``ops/ntt_pallas`` module of the package tree under ``tree``,
    its kernels built from that tree's ``csrc/ntt.cu``."""
    pkg = os.path.join(os.path.abspath(tree),
                       "node_fhe_accelerate_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "node_fhe_accelerate_tpu_torch.ops._ntt_pallas_parent",
        os.path.join(pkg, "ops", "ntt_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.NTT_LIB = _build.KernelLibrary(os.path.join(pkg, "csrc", "ntt.cu"),
                                       mod.NTT_LIB.functions)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--parent", help="a tree whose node_fhe_accelerate_"
                    "tpu_torch/ NTT kernels are timed beside this one's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_ntt_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from node_fhe_accelerate_tpu_torch.core.params import Primes
    from node_fhe_accelerate_tpu_torch.core.torus import P1, P2, P_EXT
    from node_fhe_accelerate_tpu_torch.ops.ntt import NTTContext
    from node_fhe_accelerate_tpu_torch.ops.ntt_pallas import (
        F64_MAX_Q, NTT_LIB, PallasNTT)
    from node_fhe_accelerate_tpu_torch.timing import cuda_ms, device_ms

    os.makedirs(OUT, exist_ok=True)
    libs = {}
    for i, name in enumerate(ABLATIONS):
        path = os.path.join(OUT, f"ntt_ablation_{i}.cu")
        with open(path, "w") as f:
            f.write(ablated_source(name))
        libs[name] = _build.KernelLibrary(path, NTT_LIB.functions)
    parent = load_wrapper(args.parent) if args.parent else None
    _build.build_all(list(libs.values()) + [NTT_LIB] +
                     ([parent.NTT_LIB] if parent else []))

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def planes(b, n, q):
        v = torch.randint(0, q, (b, n), generator=gen, dtype=torch.int64,
                          device=dev)
        return v.to(torch.int32), (v >> 32).to(torch.int32)

    shapes = {"K6 N=4096 B=1536 P1": (4096, 1536, P1, 0),
              "K7 N=4096 B=512 P1": (4096, 512, P1, 1),
              "K6 N=4096 B=1536 P_EXT": (4096, 1536, P_EXT, 0),
              "K6 N=256 B=2560 P_EXT": (256, 2560, P_EXT, 0),
              "K7 N=256 B=1280 P_EXT": (256, 1280, P_EXT, 1)}
    calls = {}
    for label, (n, b, q, inverse) in shapes.items():
        pk = PallasNTT(NTTContext(n, q))
        lo, hi = planes(b, n, q)
        olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
        tw = pk._tables(dev)[inverse]
        calls[label] = (lo.data_ptr(), hi.data_ptr(), olo.data_ptr(),
                        ohi.data_ptr(), tw.data_ptr(), q, *pk.last_stage(),
                        inverse, b, pk.logn), (lo, hi, olo, ohi, tw)
    # K8: its arguments in the narrow and the wide form (as the wrapper
    # passes them)
    mul_shapes = {"K8 N=4096 B=256 P1": (4096, 256, P1),
                  "K8 N=4096 B=256 P_EXT": (4096, 256, P_EXT),
                  "K8 N=4096 B=1536 P1": (4096, 1536, P1)}
    mul_calls = {}
    for label, (n, b, q) in mul_shapes.items():
        pk = PallasNTT(NTTContext(n, q))
        bufs = [*planes(b, n, q), *planes(b, n, q)]
        bufs += [torch.empty_like(bufs[0]), torch.empty_like(bufs[1])]
        for wide in (False, True):
            narrow = q < F64_MAX_Q and not wide
            tw = pk._tables(dev, narrow)
            mul_calls[label, wide] = (
                *[x.data_ptr() for x in bufs], tw[0].data_ptr(),
                tw[1].data_ptr(), q, pk.ctx.q_inv_neg,
                *pk.last_stage(1 if narrow else pk.ctx.r_mod_q), b,
                pk.logn), (bufs, tw)

    def ms(name, label):
        if label in mul_shapes:
            fn = libs[name].load().nfa_ntt_negacyclic_mul
            call = mul_calls[label, name in K8_WIDE][0]
        else:
            fn = libs[name].load().nfa_ntt_transform
            call = calls[label][0]
        return device_ms(lambda: _build.launch(fn, name, dev, *call),
                         args.iters)[0]

    labels = list(shapes) + list(mul_shapes)
    times = {name: {label: [] for label in labels} for name in libs}
    for _ in range(2):
        for name in libs:
            print(f"timing {name}", file=sys.stderr, flush=True)
            for label in labels:
                times[name][label].append(ms(name, label))
    for name, row in times.items():
        print(json.dumps({"variant": name, "ms": row}), flush=True)
    for label, (_, (lo, hi, olo, ohi, _)) in calls.items():
        copy = device_ms(lambda: (olo.copy_(lo), ohi.copy_(hi)),
                         args.iters)[0]
        print(json.dumps({"copy_": label, "ms": copy}), flush=True)

    if parent is None:
        return 0
    moduli = {"P1": P1, "P2": P2, "P_EXT": P_EXT,
              "Q_40_1": Primes.Q_40_1, "Q_60_1": Primes.Q_60_1}
    for kind, n, b, qname in PARENT_ROWS:
        q = moduli[qname]
        a, c = planes(b, n, q), planes(b, n, q)
        wrappers = {"parent": parent.PallasNTT(NTTContext(n, q)),
                    "this tree": PallasNTT(NTTContext(n, q))}
        out = {}
        for who in ("parent", "this tree", "this tree", "parent"):
            pk = wrappers[who]
            run = ((lambda: pk.negacyclic_mul(a, c)) if kind ==
                   "negacyclic_mul" else (lambda: getattr(pk, kind)(a)))
            back, host = device_ms(run, args.iters)
            row = out.setdefault(who, {"device_ms": [], "with_host_ms": [],
                                       "host_ms": []})
            row["device_ms"].append(back)
            row["host_ms"].append(host)
            row["with_host_ms"].append(cuda_ms(run, args.iters))
        want = (wrappers["this tree"].negacyclic_mul(a, c)
                if kind == "negacyclic_mul"
                else getattr(wrappers["this tree"], kind)(a))
        got = (wrappers["parent"].negacyclic_mul(a, c)
               if kind == "negacyclic_mul"
               else getattr(wrappers["parent"], kind)(a))
        equal = all(torch.equal(x, y) for x, y in zip(got, want))
        print(json.dumps({"row": f"{kind} N={n} B={b} {qname}",
                          "equal": equal, **out}), flush=True)
        if not equal:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
