// Negacyclic NTT kernels for Hopper (sm_90a), bit-exact with the JAX
// package's NTTContext (node_fhe_accelerate_tpu/ops/ntt.py).
//
// Replaces, in node_fhe_accelerate_tpu/ops/ntt_pallas.py:
//   * K6 `_make_transform(inverse=False)` (pallas_call at :179; body
//     `_forward_body` :149, `_fwd_stage` :125): all log N Cooley-Tukey
//     stages, natural order in, bit-reversed out -> `ntt_transform_kernel`
//     <LOGN, false>;
//   * K7 `_make_transform(inverse=True)` (`_inverse_body` :154, `_inv_stage`
//     :137): Gentleman-Sande stages, then the N^-1 scale -> the same kernel
//     <LOGN, true>, the scale folded into the last stage;
//   * K8 `_make_negacyclic_mul` (pallas_call at :227, kernel :203):
//     forward(a), forward(b), the pointwise product, inverse, in one launch
//     -> `ntt_negacyclic_mul_kernel`, on the same passes.
//
// Arithmetic, in two forms picked by the modulus (q odd, q < 2^62); every
// store subtracts down to the canonical residue, so the bits equal the
// limb-plane reductions of ops/modular.py whatever the form.
//   * The narrow form, q < 2^46 (P1 and P2 of the TFHE_256 "crt" path):
//     integers held exactly in doubles, on the FP64 pipes (`F64Arith`).  A
//     product y w is 6 FP64 operations and no integer multiply: h = y w
//     rounded, l = fma(y, w, -h) exactly, Q = round(h / q) by one fma at
//     1.5 2^52, and y w - Q q = fma(-Q, q, h) + l exactly, at most 0.75 q
//     in size.  The forward needs no correction (values stay below 12 q <
//     2^50 for 14 stages): 8 FP64 operations a butterfly.
//   * The wide form, q < 2^62 (P_EXT, Q_60_1): u64 values, Shoup's product
//     with the quotient w' = floor(w 2^64 / q) of each twiddle, y w - hi64(y
//     w') q mod 2^64 in [0, 2q): about 15 32-bit multiplies (7 for the high
//     half, 4 for each low half) where the first form's Montgomery product
//     took about 20.  Harvey's lazy butterflies keep the forward in [0, 4q)
//     with one conditional subtraction of 2q, the inverse in [0, 2q).
// The inverse folds N^-1 into its last stage: the sum output is multiplied
// by N^-1, the difference output by psi^-bitrev(1) N^-1 (kernel arguments).
// K8 multiplies pointwise in the form of its transforms: below 2^46 by the
// narrow product of a^ by b^ reduced (both factors in its exact domain),
// above by Montgomery's product (both factors vary), which leaves a factor
// 2^-64 its folded constants take back.
//
// What bounds it.  A transform of B polynomials reads and writes two uint32
// planes: 16 B N bytes.  It runs (N/2) log N butterflies a polynomial, each
// one modular product; the least work for one that I know of is 8 32-bit
// multiplies for a modulus of two 32-bit limbs (the 64 x 64 -> 128
// product; this repo's moduli, 2^a - 2^b + 1, reduce by shifts and adds),
// or 6 FP64 operations below 2^46 on the other pipes.  At the path's
// shapes (N = 4096, B = 1536: 100.7 MB against 3.8e7 products) the bytes
// bound it on an H100; the exchanges, the index arithmetic and the
// corrections run on the integer pipes beside the products.
//
// Design.  The TPU kernel keeps a batch tile in VMEM and rolls full-width
// lanes at every stage.  Here each thread holds E = 16 coefficients of one
// polynomial in registers (E = N below N = 16) and runs up to log E stages
// on them without touching shared memory: a pass.  A polynomial takes
// T = N / E threads; log N = 12 is 3 passes of 4 stages with 2 exchanges
// through shared memory (a warp barrier when T <= 32, else the block's).
//   * Pass p holds, in thread t, the coefficients whose index bits
//     [c_lo, c_lo + log E) vary: x = low(t) | e << c_lo | high(t) << (c_lo
//     + log E).  The first forward pass takes the top log N mod log E bits
//     (log E when that is 0) with the window at the top, the others log E
//     bits each down to bit 0; the inverse runs them in reverse.  So the
//     forward reads x = t + e T (32-bit loads, coalesced across the warp)
//     and ends holding 16 consecutive coefficients, which it stores
//     through the exchange buffer, 4 of them a 128-bit store at x = 4 (t +
//     k T), so that each warp writes 512 contiguous bytes; the inverse
//     reads 16 consecutive coefficients a thread (128-bit loads) and
//     stores x = t + e T straight from registers (coalesced).  On an H100
//     80GB HBM3 at 700 W (scripts/ablate_ntt_kernels.py), a copy with the
//     forward's loads and its stores straight from registers (16-byte
//     pieces at a 64-byte stride) took 38% longer than with them staged;
//     the inverse took 10% longer with its stores staged.
//   * The exchange stores coefficient x at x ^ ((x >> 4) & 15) (u64
//     words): every pass's reads and writes then hit 16 distinct bank
//     pairs in each half-warp (N >= 256).
//   * The twiddles: the host lays each stage's block out in the order the
//     threads read it (ops/ntt_pallas.py `twiddle_table`), as (w, w')
//     pairs, one 128-bit load each; threads that share the bits above the
//     window read one address, the last forward pass (the first inverse
//     one) reads consecutive pairs.  The block copies the table into
//     shared memory once (N <= 8192 for the transforms; above, it is read
//     from global memory through the caches).  K8 (`MulPlan`): in the
//     narrow form 8-byte twiddles (w alone), the forward table in shared
//     memory and the inverse one through L1, a and b transformed side by
//     side, stage by stage, so that one twiddle read and one pair of
//     exchange barriers serve both: 96 KB of shared memory at N = 4096, two
//     blocks an SM (the first design staged both 16-byte tables, 163 KB, one
//     block; on an H100 K8 took 0.019 ms at N = 4096, B = 256 over P1, the
//     first design 0.061); in the wide form that first design.
//   * A persistent grid (blocks as many as fit, at most one per group of
//     polynomials) walks the batch; each thread loads the next
//     polynomial's coefficients into registers while it transforms this
//     one (N <= 8192; not K8), so the bytes arrive under the butterflies.
// Largest N: 16384 for the transforms, 8192 for K8 (a and b in shared
// memory); q below 2^62 (the entries return cudaErrorInvalidValue above).
// Later work: fusing the pointwise accumulation of the external product.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kMinLogN = 2;
constexpr int kMaxLogN = 14;
constexpr int kMaxLogNMul = 13;
constexpr u64 kMaxQ = 1ull << 62;

template <int LOGN>
struct Geom {
  static constexpr int kN = 1 << LOGN;
  static constexpr int kEb = LOGN < 4 ? LOGN : 4;   // log2 of E
  static constexpr int kE = 1 << kEb;               // coefficients a thread
  static constexpr int kT = kN / kE;                // threads a polynomial
  static constexpr int kThreads = kT > 128 ? kT : 128;
  static constexpr int kG = kThreads / kT;          // polynomials a block
  static constexpr int kR0 = LOGN % kEb ? LOGN % kEb : kEb;
  static constexpr int kPasses = 1 + (LOGN - kR0) / kEb;
  // lowest window bit and stages of forward pass p
  __host__ __device__ static constexpr int c_lo(int p) {
    return p == 0 ? LOGN - kEb : LOGN - kR0 - p * kEb;
  }
  __host__ __device__ static constexpr int run(int p) {
    return p == 0 ? kR0 : kEb;
  }
};

// The modulus and what the two forms of the arithmetic derive from it.
struct Mod {
  u64 q, q2;           // q, 2q
  double qd, qinv;     // q and 1/q rounded, for the narrow form
};

__device__ __forceinline__ u64 sub_if(u64 v, u64 m) {
  return v >= m ? v - m : v;
}

// y w mod q in [0, 2q) for any y < 2^64 (Shoup; q < 2^63).
__device__ __forceinline__ u64 shoup(u64 y, ulonglong2 w, u64 q) {
  return y * w.x - __umul64hi(y, w.y) * q;
}

// a b 2^-64 mod q for a, b < q (Montgomery; qinv = -q^-1 mod 2^64).
__device__ __forceinline__ u64 mont_mul(u64 a, u64 b, u64 q, u64 qinv) {
  const u64 lo = a * b;
  const u64 hi = __umul64hi(a, b);
  const u64 m = lo * qinv;                 // lo + m q == 0 mod 2^64
  return sub_if(hi + __umul64hi(m, q) + (lo != 0 ? 1ull : 0ull), q);
}

// The wide form (q < 2^62): u64 values, Shoup's products, Harvey's lazy
// butterflies.
struct ShoupArith {
  using V = u64;
  __device__ static V from_u64(u64 v) { return v; }
  // Cooley-Tukey: x, y in [0, 4q) -> x + w y, x - w y in [0, 4q).
  __device__ static void ct(V& x, V& y, ulonglong2 w, const Mod& m) {
    const u64 u = sub_if(x, m.q2);
    const u64 v = shoup(y, w, m.q);
    x = u + v;
    y = u - v + m.q2;
  }
  // Gentleman-Sande: x, y in [0, 2q) -> x + y, (x - y) w in [0, 2q).
  __device__ static void gs(V& x, V& y, ulonglong2 w, const Mod& m) {
    const u64 u = x, v = y;
    x = sub_if(u + v, m.q2);
    y = shoup(u - v + m.q2, w, m.q);
  }
  // The inverse's last stage with the scale folded: (x + y) c, (x - y) d.
  __device__ static void gs_last(V& x, V& y, ulonglong2 c, ulonglong2 d,
                                 const Mod& m) {
    const u64 u = x, v = y;
    x = shoup(u + v, c, m.q);
    y = shoup(u - v + m.q2, d, m.q);
  }
  __device__ static u64 forward_out(V v, const Mod& m) {
    return sub_if(sub_if(v, m.q2), m.q);
  }
  __device__ static u64 inverse_out(V v, const Mod& m) {
    return sub_if(v, m.q);
  }
};

// The narrow form (q < 2^46): values are integers held exactly in doubles,
// on the FP64 pipes, which the integer multiplies of the wide form leave
// idle.  A product y w is h = fl(y w) plus the exact l = fma(y, w, -h); its
// quotient Q = round(h / q), from h (1/q) rounded at 1.5 2^52, is within 1
// of y w / q while |y| < 2^50, so y w - Q q = fma(-Q, q, h) + l is exact
// and at most 0.75 q in size.  The forward grows by at most 0.75 q a stage
// (below 12 q, 2^50, after 14), so it needs no correction; the inverse
// reduces each sum.  The stores reduce once more and add q to a negative.
struct F64Arith {
  using V = double;
  static constexpr double kTwo52 = 4503599627370496.0;
  static constexpr double kRound = 6755399441055744.0;    // 1.5 2^52
  // v < 2^52 as a double, from its bits.
  __device__ static V from_u64(u64 v) {
    return __dsub_rn(__longlong_as_double(
                         static_cast<long long>(v | 0x4330000000000000ull)),
                     kTwo52);
  }
  // y w - round(y w / q) q for |y| < 2^50, w < q: |result| <= 0.75 q.
  __device__ static V mul(V y, V w, const Mod& m) {
    const double h = __dmul_rn(y, w);
    const double l = __fma_rn(y, w, -h);
    const double quot = __dsub_rn(__fma_rn(h, m.qinv, kRound), kRound);
    return __dadd_rn(__fma_rn(-quot, m.qd, h), l);
  }
  // x - round(x / q) q for |x| < 2^50: |result| <= q / 2 + 1.
  __device__ static V reduce(V x, const Mod& m) {
    const double quot = __dsub_rn(__fma_rn(x, m.qinv, kRound), kRound);
    return __fma_rn(-quot, m.qd, x);
  }
  // Butterflies on a twiddle held as a double (K8's 8-byte tables) or as
  // the (w, w') pair of the transforms' tables, of which w is taken.
  __device__ static void ct(V& x, V& y, double w, const Mod& m) {
    const double v = mul(y, w, m);
    const double u = x;
    x = __dadd_rn(u, v);
    y = __dsub_rn(u, v);
  }
  __device__ static void gs(V& x, V& y, double w, const Mod& m) {
    const double u = x, v = y;
    x = reduce(__dadd_rn(u, v), m);
    y = mul(__dsub_rn(u, v), w, m);
  }
  __device__ static void ct(V& x, V& y, ulonglong2 w, const Mod& m) {
    ct(x, y, from_u64(w.x), m);
  }
  __device__ static void gs(V& x, V& y, ulonglong2 w, const Mod& m) {
    gs(x, y, from_u64(w.x), m);
  }
  __device__ static void gs_last(V& x, V& y, ulonglong2 c, ulonglong2 d,
                                 const Mod& m) {
    const double u = x, v = y;
    x = mul(__dadd_rn(u, v), from_u64(c.x), m);
    y = mul(__dsub_rn(u, v), from_u64(d.x), m);
  }
  // The canonical residue of x as u64.
  __device__ static u64 forward_out(V x, const Mod& m) {
    double r = reduce(x, m);
    if (r < 0) r = __dadd_rn(r, m.qd);
    return static_cast<u64>(__double_as_longlong(__dadd_rn(r, kTwo52))) &
           ((1ull << 52) - 1);
  }
  __device__ static u64 inverse_out(V x, const Mod& m) {
    return forward_out(x, m);
  }
};

// Index of coefficient e of thread t in a pass whose window starts at c_lo.
template <int LOGN>
__device__ __forceinline__ int coeff(int t, int e, int c_lo) {
  return (t & ((1 << c_lo) - 1)) | (e << c_lo) |
         ((t >> c_lo) << (c_lo + Geom<LOGN>::kEb));
}

// Where coefficient x lies in the exchange buffer.
__device__ __forceinline__ int swz(int x) { return x ^ ((x >> 4) & 15); }

template <int LOGN>
__device__ __forceinline__ void poly_sync() {
  if constexpr (Geom<LOGN>::kT <= 32)
    __syncwarp();
  else
    __syncthreads();
}

// The stage on window bit JJ of a pass whose window starts at C_LO: pairs
// (e, e + 2^JJ), the twiddle of the bits above JJ (e_hi = e >> (JJ+1)) and
// of the high bits h at e_hi 2^hb + h of the stage's block (forward:
// (N >> (c+1)) - 1, inverse: N - 2 (N >> (c+1)), c = C_LO + JJ); the
// inverse's stage on the top bit takes the folded constants (c, d).
// The stage runs on each of K polynomials held side by side (K8 runs a and
// b together), one twiddle read serving all K.
template <int LOGN, int C_LO, int JJ, bool kInverse, typename A, int K,
          typename TW>
__device__ __forceinline__ void stage(typename A::V (&x)[K][Geom<LOGN>::kE],
                                      int h, const TW* tw, const Mod& m,
                                      ulonglong2 c, ulonglong2 d) {
  using G = Geom<LOGN>;
  constexpr int kBit = C_LO + JJ, kSpan = 1 << JJ;
  constexpr int kHb = LOGN - C_LO - G::kEb;
  if constexpr (kInverse && kBit == LOGN - 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < G::kE; e += 2 * kSpan)
#pragma unroll
        for (int l = 0; l < kSpan; ++l)
          A::gs_last(x[k][e + l], x[k][e + l + kSpan], c, d, m);
  } else {
    const TW* blk =
        tw + (kInverse ? G::kN - (G::kN >> kBit) : (G::kN >> (kBit + 1)) - 1)
        + h;
#pragma unroll
    for (int g = 0; g < G::kE / (2 * kSpan); ++g) {
      const TW w = blk[g << kHb];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int l = 0; l < kSpan; ++l) {
          const int e = 2 * kSpan * g + l;
          if constexpr (kInverse)
            A::gs(x[k][e], x[k][e + kSpan], w, m);
          else
            A::ct(x[k][e], x[k][e + kSpan], w, m);
        }
    }
  }
}

// The stages of pass P from window bit JJ on: the forward goes from the
// window's top bit down to its lowest run bit, the inverse back up.
template <int LOGN, int P, int JJ, bool kInverse, typename A, int K,
          typename TW>
__device__ __forceinline__ void pass_stages(
    typename A::V (&x)[K][Geom<LOGN>::kE], int h, const TW* tw,
    const Mod& m, ulonglong2 c, ulonglong2 d) {
  using G = Geom<LOGN>;
  stage<LOGN, G::c_lo(P), JJ, kInverse, A>(x, h, tw, m, c, d);
  if constexpr (!kInverse && JJ > G::kEb - G::run(P))
    pass_stages<LOGN, P, JJ - 1, kInverse, A>(x, h, tw, m, c, d);
  if constexpr (kInverse && JJ + 1 < G::kEb)
    pass_stages<LOGN, P, JJ + 1, kInverse, A>(x, h, tw, m, c, d);
}

template <int LOGN, int P, bool kInverse, typename A, int K, typename TW>
__device__ __forceinline__ void run_pass(
    typename A::V (&x)[K][Geom<LOGN>::kE], int t, const TW* tw,
    const Mod& m, ulonglong2 c, ulonglong2 d) {
  using G = Geom<LOGN>;
  constexpr int kFirst = kInverse ? G::kEb - G::run(P) : G::kEb - 1;
  pass_stages<LOGN, P, kFirst, kInverse, A>(x, t >> G::c_lo(P), tw, m, c,
                                            d);
}

// Between pass FROM and pass TO: every thread of the polynomial writes its
// coefficients to the exchange buffer and reads those of the next window;
// K polynomials through K buffers (buffer k at buf + k G::kG G::kN) behind
// one pair of barriers.
template <int LOGN, int FROM, int TO, int K, typename V>
__device__ __forceinline__ void exchange(V (&x)[K][Geom<LOGN>::kE], V* buf,
                                         int t) {
  using G = Geom<LOGN>;
  constexpr int kBuf = G::kG * G::kN;
  poly_sync<LOGN>();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < G::kE; ++e)
      buf[k * kBuf + swz(coeff<LOGN>(t, e, G::c_lo(FROM)))] = x[k][e];
  poly_sync<LOGN>();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < G::kE; ++e)
      x[k][e] = buf[k * kBuf + swz(coeff<LOGN>(t, e, G::c_lo(TO)))];
}

template <int LOGN, int P, typename A, int K, typename TW>
__device__ __forceinline__ void forward_passes(
    typename A::V (&x)[K][Geom<LOGN>::kE], typename A::V* buf, int t,
    const TW* tw, const Mod& m) {
  run_pass<LOGN, P, false, A>(x, t, tw, m, ulonglong2{}, ulonglong2{});
  if constexpr (P + 1 < Geom<LOGN>::kPasses) {
    exchange<LOGN, P, P + 1>(x, buf, t);
    forward_passes<LOGN, P + 1, A>(x, buf, t, tw, m);
  }
}

template <int LOGN, int P, typename A, int K, typename TW>
__device__ __forceinline__ void inverse_passes(
    typename A::V (&x)[K][Geom<LOGN>::kE], typename A::V* buf, int t,
    const TW* tw, const Mod& m, ulonglong2 c, ulonglong2 d) {
  run_pass<LOGN, P, true, A>(x, t, tw, m, c, d);
  if constexpr (P > 0) {
    exchange<LOGN, P, P - 1>(x, buf, t);
    inverse_passes<LOGN, P - 1, A>(x, buf, t, tw, m, c, d);
  }
}

// The planes of polynomial `poly` (zeros past the batch) as thread t holds
// them in the first forward pass (x = t + e T; kBottom = false) or in the
// first inverse pass (x = t E + e, 128-bit loads; kBottom = true).
template <int LOGN, bool kBottom>
__device__ __forceinline__ void load_planes(const uint32_t* __restrict__ lo,
                                            const uint32_t* __restrict__ hi,
                                            long long poly, int batch, int t,
                                            uint32_t (&l)[Geom<LOGN>::kE],
                                            uint32_t (&h)[Geom<LOGN>::kE]) {
  using G = Geom<LOGN>;
  if (poly >= batch) {
#pragma unroll
    for (int e = 0; e < G::kE; ++e) l[e] = h[e] = 0;
    return;
  }
  const long long base = poly << LOGN;
  if constexpr (kBottom) {
    const uint4* pl = reinterpret_cast<const uint4*>(lo + base + t * G::kE);
    const uint4* ph = reinterpret_cast<const uint4*>(hi + base + t * G::kE);
#pragma unroll
    for (int k = 0; k < G::kE / 4; ++k) {
      const uint4 a = __ldg(pl + k), b = __ldg(ph + k);
      l[4 * k] = a.x; l[4 * k + 1] = a.y; l[4 * k + 2] = a.z;
      l[4 * k + 3] = a.w;
      h[4 * k] = b.x; h[4 * k + 1] = b.y; h[4 * k + 2] = b.z;
      h[4 * k + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < G::kE; ++e) {
      l[e] = __ldg(lo + base + t + e * G::kT);
      h[e] = __ldg(hi + base + t + e * G::kT);
    }
  }
}

// Canonical x as planes of polynomial `poly`: 128-bit stores of x = t E + e
// (kBottom, the forward's last pass) or x = t + e T (the inverse's).
template <int LOGN, bool kBottom>
__device__ __forceinline__ void store_planes(uint32_t* __restrict__ olo,
                                             uint32_t* __restrict__ ohi,
                                             long long poly, int batch, int t,
                                             const u64 (&x)[Geom<LOGN>::kE]) {
  using G = Geom<LOGN>;
  if (poly >= batch) return;
  const long long base = poly << LOGN;
  if constexpr (kBottom) {
    uint4* pl = reinterpret_cast<uint4*>(olo + base + t * G::kE);
    uint4* ph = reinterpret_cast<uint4*>(ohi + base + t * G::kE);
#pragma unroll
    for (int k = 0; k < G::kE / 4; ++k) {
      const u64* v = x + 4 * k;
      pl[k] = make_uint4(static_cast<uint32_t>(v[0]),
                         static_cast<uint32_t>(v[1]),
                         static_cast<uint32_t>(v[2]),
                         static_cast<uint32_t>(v[3]));
      ph[k] = make_uint4(static_cast<uint32_t>(v[0] >> 32),
                         static_cast<uint32_t>(v[1] >> 32),
                         static_cast<uint32_t>(v[2] >> 32),
                         static_cast<uint32_t>(v[3] >> 32));
    }
  } else {
#pragma unroll
    for (int e = 0; e < G::kE; ++e) {
      olo[base + t + e * G::kT] = static_cast<uint32_t>(x[e]);
      ohi[base + t + e * G::kT] = static_cast<uint32_t>(x[e] >> 32);
    }
  }
}

// Canonical x as planes of polynomial `poly` through the exchange buffer:
// every thread writes its coefficients (x = coeff(t, e, C_LO)) there, then
// stores 4 consecutive ones of each plane at a time, x = 4 (t + k T) + i,
// so that each warp writes 512 contiguous bytes of a plane a store (no
// bank conflict: the swizzle spreads a half-warp's reads over 16 pairs).
template <int LOGN, int C_LO>
__device__ __forceinline__ void store_staged(uint32_t* __restrict__ olo,
                                             uint32_t* __restrict__ ohi,
                                             long long poly, int batch, int t,
                                             const u64 (&x)[Geom<LOGN>::kE],
                                             u64* buf) {
  using G = Geom<LOGN>;
  poly_sync<LOGN>();
#pragma unroll
  for (int e = 0; e < G::kE; ++e) buf[swz(coeff<LOGN>(t, e, C_LO))] = x[e];
  poly_sync<LOGN>();
  if (poly >= batch) return;
  const long long base = poly << LOGN;
#pragma unroll
  for (int k = 0; k < G::kE / 4; ++k) {
    const int j = 4 * (t + k * G::kT);
    u64 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = buf[swz(j + i)];
    *reinterpret_cast<uint4*>(olo + base + j) = make_uint4(
        static_cast<uint32_t>(v[0]), static_cast<uint32_t>(v[1]),
        static_cast<uint32_t>(v[2]), static_cast<uint32_t>(v[3]));
    *reinterpret_cast<uint4*>(ohi + base + j) = make_uint4(
        static_cast<uint32_t>(v[0] >> 32), static_cast<uint32_t>(v[1] >> 32),
        static_cast<uint32_t>(v[2] >> 32), static_cast<uint32_t>(v[3] >> 32));
  }
}

// The table copied once into shared memory (kCount pairs at dst; every
// load of a thread issued before its first store), or the global one.
template <bool kShared, int kCount, int kThreads, typename TW>
__device__ __forceinline__ const TW* stage_table(TW* dst,
                                                 const TW* __restrict__ src) {
  if constexpr (kShared) {
    constexpr int kPer = (kCount + kThreads - 1) / kThreads;
    TW v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kCount) v[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kCount) dst[i] = v[k];
    }
    return dst;
  } else {
    return src;
  }
}

template <int LOGN>
__host__ __device__ constexpr bool transform_smem_tables() {
  return LOGN <= 13;
}

template <int LOGN, bool kInverse, typename A>
__global__ void __launch_bounds__(Geom<LOGN>::kThreads)
ntt_transform_kernel(const uint32_t* __restrict__ lo,
                     const uint32_t* __restrict__ hi,
                     uint32_t* __restrict__ olo, uint32_t* __restrict__ ohi,
                     const ulonglong2* __restrict__ tw_g, Mod m,
                     ulonglong2 c, ulonglong2 d, int batch) {
  using G = Geom<LOGN>;
  using V = typename A::V;
  constexpr bool kShared = transform_smem_tables<LOGN>();
  constexpr bool kPrefetch = LOGN <= 13;
  // the forward's stores through the exchange buffer (its last pass holds
  // 16 consecutive coefficients a thread); the inverse's last pass holds
  // x = t + e T, which it stores straight from registers, coalesced
  constexpr bool kStagedStores = !kInverse;
  constexpr int kTw = kInverse ? G::kN - 2 : G::kN - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  ulonglong2* const s_tw = reinterpret_cast<ulonglong2*>(smem);
  V* const xbuf = reinterpret_cast<V*>(
      smem + (kShared ? kTw * sizeof(ulonglong2) : 0));
  const ulonglong2* const tw =
      stage_table<kShared, kTw, G::kThreads>(s_tw, tw_g);
  if constexpr (kShared) __syncthreads();

  const int slot = threadIdx.x / G::kT, t = threadIdx.x % G::kT;
  V* const buf = xbuf + slot * G::kN;
  const int groups = (batch + G::kG - 1) / G::kG;
  const int stride = gridDim.x;
  uint32_t nl[G::kE], nh[G::kE];
  int g = blockIdx.x;
  if (kPrefetch && g < groups)
    load_planes<LOGN, kInverse>(lo, hi, 1ll * g * G::kG + slot, batch, t,
                                nl, nh);
  for (; g < groups; g += stride) {
    const long long poly = 1ll * g * G::kG + slot;
    if (!kPrefetch) load_planes<LOGN, kInverse>(lo, hi, poly, batch, t, nl, nh);
    V x[1][G::kE];
#pragma unroll
    for (int e = 0; e < G::kE; ++e)
      x[0][e] = A::from_u64(static_cast<u64>(nl[e]) |
                            (static_cast<u64>(nh[e]) << 32));
    if (kPrefetch && g + stride < groups)
      load_planes<LOGN, kInverse>(lo, hi, poly + 1ll * stride * G::kG,
                                  batch, t, nl, nh);
    u64 out[G::kE];
    if constexpr (kInverse) {
      inverse_passes<LOGN, G::kPasses - 1, A>(x, buf, t, tw, m, c, d);
#pragma unroll
      for (int e = 0; e < G::kE; ++e) out[e] = A::inverse_out(x[0][e], m);
    } else {
      forward_passes<LOGN, 0, A>(x, buf, t, tw, m);
#pragma unroll
      for (int e = 0; e < G::kE; ++e) out[e] = A::forward_out(x[0][e], m);
    }
    // the last pass's window: the top bits (inverse) or the bottom ones
    constexpr int kLast = G::c_lo(kInverse ? 0 : G::kPasses - 1);
    if constexpr (kStagedStores)
      store_staged<LOGN, kLast>(olo, ohi, poly, batch, t, out,
                                reinterpret_cast<u64*>(buf));
    else
      store_planes<LOGN, !kInverse>(olo, ohi, poly, batch, t, out);
  }
}

template <typename A>
constexpr bool kNarrow = std::is_same<A, F64Arith>::value;

// How K8 is laid out, by form.  The narrow form (q < 2^46) reads 8-byte
// twiddles (w as a double), keeps the forward table in shared memory and
// reads the inverse one through L1, and transforms a and b side by side,
// stage by stage (one twiddle read and one pair of exchange barriers serve
// both; N <= 4096, where 512 threads would leave it 128 registers): at
// N = 4096 96 KB of shared memory and at most 128 registers a thread, two
// blocks an SM.  It does not load the next pair during this one: on an H100
// 80GB HBM3 at 700 W (scripts/ablate_ntt_kernels.py) that took 26% longer
// at N = 4096, B = 256 (where no block has a second pair) and 21% at
// B = 1536, its registers spilling under the cap.  The wide form is the
// first design: a, then b, both (w, w') tables in shared memory (N <= 4096),
// one exchange buffer.
template <int LOGN, typename A>
struct MulPlan {
  static constexpr bool kPaired = kNarrow<A> && LOGN <= 12;
  static constexpr bool kFwdShared = kNarrow<A> ? LOGN <= 13 : LOGN <= 12;
  static constexpr bool kInvShared = kNarrow<A> ? false : LOGN <= 12;
  static constexpr bool kPrefetch = false;
  static constexpr int kBuffers = kPaired ? 2 : 1;
  static constexpr int kMinBlocks = kNarrow<A> && LOGN == 12 ? 2 : 1;
  using TW = typename std::conditional<kNarrow<A>, double, ulonglong2>::type;
  static constexpr size_t smem() {
    using G = Geom<LOGN>;
    return (kFwdShared ? (G::kN - 1) * sizeof(TW) : 0) +
           (kInvShared ? (G::kN - 2) * sizeof(TW) : 0) +
           static_cast<size_t>(kBuffers) * G::kG * G::kN * 8;
  }
};

// K8: forward(a), forward(b), the pointwise product, inverse.  The narrow
// form's product is mul(a^, reduce(b^)): |a^| < 12 q < 2^50 and |reduce(b^)|
// <= q / 2 + 1 < q, in the domain where F64Arith::mul is exact, at most
// 0.75 q in size, which the inverse takes as it is.  The wide form's is
// Montgomery's on the canonical residues, which leaves a factor 2^-64 that
// its folded constants (c, d) take back.
template <int LOGN, typename A>
__global__ void __launch_bounds__(Geom<LOGN>::kThreads,
                                  MulPlan<LOGN, A>::kMinBlocks)
ntt_negacyclic_mul_kernel(const uint32_t* __restrict__ alo,
                          const uint32_t* __restrict__ ahi,
                          const uint32_t* __restrict__ blo,
                          const uint32_t* __restrict__ bhi,
                          uint32_t* __restrict__ olo,
                          uint32_t* __restrict__ ohi,
                          const typename MulPlan<LOGN, A>::TW* __restrict__ fwd_g,
                          const typename MulPlan<LOGN, A>::TW* __restrict__ inv_g,
                          Mod m, u64 qinv, ulonglong2 c, ulonglong2 d,
                          int batch) {
  using G = Geom<LOGN>;
  using Plan = MulPlan<LOGN, A>;
  using TW = typename Plan::TW;
  using V = typename A::V;
  constexpr int kFwd = G::kN - 1, kInv = G::kN - 2;
  constexpr bool kPrefetch = Plan::kPrefetch;
  extern __shared__ __align__(16) unsigned char smem[];
  TW* const s_fwd = reinterpret_cast<TW*>(smem);
  TW* const s_inv = s_fwd + (Plan::kFwdShared ? kFwd : 0);
  V* const xbuf =
      reinterpret_cast<V*>(s_inv + (Plan::kInvShared ? kInv : 0));
  const TW* const fwd =
      stage_table<Plan::kFwdShared, kFwd, G::kThreads>(s_fwd, fwd_g);
  const TW* const inv =
      stage_table<Plan::kInvShared, kInv, G::kThreads>(s_inv, inv_g);
  if constexpr (Plan::kFwdShared || Plan::kInvShared) __syncthreads();

  const int slot = threadIdx.x / G::kT, t = threadIdx.x % G::kT;
  V* const buf = xbuf + slot * G::kN;
  const int groups = (batch + G::kG - 1) / G::kG;
  const int stride = gridDim.x;
  uint32_t nl[2][G::kE], nh[2][G::kE];
  int g = blockIdx.x;
  if (kPrefetch && g < groups) {
    const long long poly = 1ll * g * G::kG + slot;
    load_planes<LOGN, false>(alo, ahi, poly, batch, t, nl[0], nh[0]);
    load_planes<LOGN, false>(blo, bhi, poly, batch, t, nl[1], nh[1]);
  }
  for (; g < groups; g += stride) {
    const long long poly = 1ll * g * G::kG + slot;
    if (!kPrefetch) {
      load_planes<LOGN, false>(alo, ahi, poly, batch, t, nl[0], nh[0]);
      load_planes<LOGN, false>(blo, bhi, poly, batch, t, nl[1], nh[1]);
    }
    V x[2][G::kE];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < G::kE; ++e)
        x[k][e] = A::from_u64(static_cast<u64>(nl[k][e]) |
                              (static_cast<u64>(nh[k][e]) << 32));
    V (&xa)[1][G::kE] = reinterpret_cast<V (&)[1][G::kE]>(x[0]);
    V (&xb)[1][G::kE] = reinterpret_cast<V (&)[1][G::kE]>(x[1]);
    if constexpr (Plan::kPaired) {
      forward_passes<LOGN, 0, A>(x, buf, t, fwd, m);
    } else {
      forward_passes<LOGN, 0, A>(xa, buf, t, fwd, m);
      forward_passes<LOGN, 0, A>(xb, buf, t, fwd, m);
    }
#pragma unroll
    for (int e = 0; e < G::kE; ++e) {
      if constexpr (kNarrow<A>)
        x[0][e] = A::mul(x[0][e], A::reduce(x[1][e], m), m);
      else
        x[0][e] = mont_mul(A::forward_out(x[0][e], m),
                           A::forward_out(x[1][e], m), m.q, qinv);
    }
    // the next pair arrives under this one's inverse
    if (kPrefetch && g + stride < groups) {
      const long long next = poly + 1ll * stride * G::kG;
      load_planes<LOGN, false>(alo, ahi, next, batch, t, nl[0], nh[0]);
      load_planes<LOGN, false>(blo, bhi, next, batch, t, nl[1], nh[1]);
    }
    inverse_passes<LOGN, G::kPasses - 1, A>(xa, buf, t, inv, m, c, d);
    u64 out[G::kE];
#pragma unroll
    for (int e = 0; e < G::kE; ++e) out[e] = A::inverse_out(x[0][e], m);
    store_planes<LOGN, false>(olo, ohi, poly, batch, t, out);
  }
}

// Blocks of `kernel` that fit on the card, on the current device (cached
// per kernel and device; the dynamic shared memory allowed first).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int* cache, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && cache[dev] > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (dev < 16) cache[dev] = *out;
  return cudaSuccess;
}

// Moduli below this take the narrow form (F64Arith).
constexpr u64 kF64MaxQ = 1ull << 46;

Mod make_mod(u64 q) {
  return Mod{q, 2 * q, static_cast<double>(q), 1.0 / static_cast<double>(q)};
}

struct TransformArgs {
  const uint32_t *lo, *hi;
  uint32_t *olo, *ohi;
  const ulonglong2* tw;
  u64 q;
  ulonglong2 c, d;
  int inverse, batch;
  cudaStream_t stream;
};

template <int LOGN, bool kInverse, typename A>
cudaError_t run_transform(const TransformArgs& a) {
  using G = Geom<LOGN>;
  static int cache[16];
  const size_t tw_bytes =
      transform_smem_tables<LOGN>()
          ? (kInverse ? G::kN - 2 : G::kN - 1) * sizeof(ulonglong2) : 0;
  const size_t smem = tw_bytes + static_cast<size_t>(G::kG) * G::kN * 8;
  auto kernel = ntt_transform_kernel<LOGN, kInverse, A>;
  int resident = 0;
  cudaError_t err =
      resident_blocks(kernel, G::kThreads, smem, cache, &resident);
  if (err != cudaSuccess) return err;
  const int groups = (a.batch + G::kG - 1) / G::kG;
  kernel<<<groups < resident ? groups : resident, G::kThreads, smem,
           a.stream>>>(a.lo, a.hi, a.olo, a.ohi, a.tw, make_mod(a.q), a.c,
                       a.d, a.batch);
  return cudaGetLastError();
}

template <int LOGN, bool kInverse>
cudaError_t run_transform(const TransformArgs& a) {
  return a.q < kF64MaxQ ? run_transform<LOGN, kInverse, F64Arith>(a)
                        : run_transform<LOGN, kInverse, ShoupArith>(a);
}

template <int LOGN>
cudaError_t transform_at(int logn, const TransformArgs& a) {
  if constexpr (LOGN > kMaxLogN) {
    return cudaErrorInvalidValue;
  } else {
    if (logn != LOGN) return transform_at<LOGN + 1>(logn, a);
    return a.inverse ? run_transform<LOGN, true>(a)
                     : run_transform<LOGN, false>(a);
  }
}

struct MulArgs {
  const uint32_t *alo, *ahi, *blo, *bhi;
  uint32_t *olo, *ohi;
  const void *fwd, *inv;
  u64 q, qinv;
  ulonglong2 c, d;
  int batch;
  cudaStream_t stream;
};

template <int LOGN, typename A>
cudaError_t run_mul(const MulArgs& a) {
  using G = Geom<LOGN>;
  using Plan = MulPlan<LOGN, A>;
  using TW = typename Plan::TW;
  static int cache[16];
  constexpr size_t smem = Plan::smem();
  auto kernel = ntt_negacyclic_mul_kernel<LOGN, A>;
  int resident = 0;
  cudaError_t err =
      resident_blocks(kernel, G::kThreads, smem, cache, &resident);
  if (err != cudaSuccess) return err;
  const int groups = (a.batch + G::kG - 1) / G::kG;
  kernel<<<groups < resident ? groups : resident, G::kThreads, smem,
           a.stream>>>(a.alo, a.ahi, a.blo, a.bhi, a.olo, a.ohi,
                       static_cast<const TW*>(a.fwd),
                       static_cast<const TW*>(a.inv), make_mod(a.q), a.qinv,
                       a.c, a.d, a.batch);
  return cudaGetLastError();
}

template <int LOGN>
cudaError_t mul_at(int logn, const MulArgs& a) {
  if constexpr (LOGN > kMaxLogNMul) {
    return cudaErrorInvalidValue;
  } else {
    if (logn != LOGN) return mul_at<LOGN + 1>(logn, a);
    return a.q < kF64MaxQ ? run_mul<LOGN, F64Arith>(a)
                          : run_mul<LOGN, ShoupArith>(a);
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool args_ok(u64 q, int batch, int logn, int max_logn) {
  return batch >= 1 && logn >= kMinLogN && logn <= max_logn && (q & 1) &&
         q > 2 && q < kMaxQ;
}

}  // namespace

// One forward (inverse = 0) or inverse (inverse = 1) negacyclic NTT of
// `batch` polynomials of 2^logn coefficients on `stream`.  lo/hi and
// olo/ohi: uint32 planes (batch, N), canonical residues, 16-byte aligned;
// tw: the pass-ordered (w, w') table of ops/ntt_pallas.py `twiddle_table`
// (N - 1 pairs forward, N - 2 inverse); (c, c'), (d, d'): the inverse's
// folded last stage (`PallasNTT.last_stage`).  q odd, q < 2^62.  Returns a
// cudaError_t (0 on success).
extern "C" int nfa_ntt_transform(const void* lo, const void* hi, void* olo,
                                 void* ohi, const void* tw,
                                 unsigned long long q, unsigned long long c,
                                 unsigned long long cq, unsigned long long d,
                                 unsigned long long dq, int inverse,
                                 int batch, int logn, void* stream) {
  if (!args_ok(q, batch, logn, kMaxLogN) || !aligned(lo) || !aligned(hi) ||
      !aligned(olo) || !aligned(ohi) || !aligned(tw))
    return static_cast<int>(cudaErrorInvalidValue);
  TransformArgs a{static_cast<const uint32_t*>(lo),
                  static_cast<const uint32_t*>(hi),
                  static_cast<uint32_t*>(olo),
                  static_cast<uint32_t*>(ohi),
                  static_cast<const ulonglong2*>(tw),
                  q,
                  make_ulonglong2(c, cq),
                  make_ulonglong2(d, dq),
                  inverse,
                  batch,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(transform_at<kMinLogN>(logn, a));
}

// a * b mod (X^N + 1, q) for `batch` pairs in one launch: forward(a),
// forward(b), the pointwise product, inverse.  Below q = 2^46 (the narrow
// form) fwd_tw and inv_tw hold each twiddle w as a double (N - 1 and N - 2
// of them) and (c, d) is the folded last stage; above, they are the (w, w')
// pair tables and (c, d) the folded last stage scaled by 2^64 mod q, which
// the pointwise Montgomery product takes away.  qinv = -q^-1 mod 2^64.
extern "C" int nfa_ntt_negacyclic_mul(
    const void* alo, const void* ahi, const void* blo, const void* bhi,
    void* olo, void* ohi, const void* fwd_tw, const void* inv_tw,
    unsigned long long q, unsigned long long qinv, unsigned long long c,
    unsigned long long cq, unsigned long long d, unsigned long long dq,
    int batch, int logn, void* stream) {
  if (!args_ok(q, batch, logn, kMaxLogNMul) || !aligned(alo) ||
      !aligned(ahi) || !aligned(blo) || !aligned(bhi) || !aligned(olo) ||
      !aligned(ohi) || !aligned(fwd_tw) || !aligned(inv_tw))
    return static_cast<int>(cudaErrorInvalidValue);
  MulArgs a{static_cast<const uint32_t*>(alo),
            static_cast<const uint32_t*>(ahi),
            static_cast<const uint32_t*>(blo),
            static_cast<const uint32_t*>(bhi),
            static_cast<uint32_t*>(olo),
            static_cast<uint32_t*>(ohi),
            fwd_tw,
            inv_tw,
            q,
            qinv,
            make_ulonglong2(c, cq),
            make_ulonglong2(d, dq),
            batch,
            static_cast<cudaStream_t>(stream)};
  return static_cast<int>(mul_at<kMinLogN>(logn, a));
}
