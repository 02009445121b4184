// Montgomery field-multiply kernels for Hopper (sm_90a) on 8-bit digit
// planes, bit-exact with the JAX package's digit algebra
// (node_fhe_accelerate_tpu/zk/field.py Field.mul, ops/digits.py).
//
// Replaces, in node_fhe_accelerate_tpu/ops/digits_pallas.py:
//   * K9 `_mul_t_raw` (:375; pallas_call at :393, kernel :388, algebra
//     `_KernelFieldT.mul` :355-366): the product on digit-MAJOR (D, B)
//     planes -> `mont_mul_kernel<L, true>`;
//   * K10 `_point_call` (:243; pallas_call at :252, algebra
//     `_KernelField.mul` :208-209), which runs both the single product and
//     the point ops `pallas_jadd`/`pallas_jdbl` (:655, :726; 6 and 4
//     dispatches, one per dataflow level): the product on row-major (B, D)
//     planes -> `mont_mul_kernel<L, false>`, and a whole Jacobian add or
//     double in one launch -> `point_kernel<L, add>`.
// D = 32 (BN254 Fq/Fr, BLS12-381 Fr: L = 8 limbs) or 48 (BLS12-381 Fq:
// L = 12).
//
// Arithmetic.  The TPU kernels run the digit algebra on int32 lanes (its
// VPU has no wide multiply): D rolled multiply-adds for a*b, two constant
// convolutions for m and m*q, four carry resolutions, a digit subtract.
// Here a thread packs its element's D digits into L = D/4 32-bit limbs and
// runs word-serial CIOS Montgomery with R = 2^(32L) = 2^(8D), the digit
// algebra's R, q' = -q^-1 mod 2^32, 32x32->64 products with 64-bit carries,
// then one conditional subtraction, and unpacks to D int32 digits.
//
// Why the bits agree.  Domain: canonical inputs, a, b < q with 2q < R
// (Field.__init__ enforces 2q < R; every element the library stores is
// canonical, and zero rows are canonical).  For such inputs both algorithms
// compute t = (a*b + m*q)/R, with m in [0, R) the unique value making
// a*b + m*q = 0 mod R, so t < 2q < R and one subtraction of q gives the
// canonical result.  The digit algebra truncates carries beyond 2D digits
// where CIOS keeps a carry word, but for canonical inputs nothing is
// truncated.  Outside the domain the two may differ.
//
// What bounds it.  The interface moves int32 per digit: two operand planes
// read and one written, 12 D bytes per element (384 B at D = 32).  One
// CIOS product is 2L^2 + L word products (136 at L = 8), two 32-bit
// multiplies each (low and high halves).  At the MSM's widest shape
// (D = 32, B = 131,072: 50.3 MB against 3.6e7 multiplies) the bytes take
// ~7x longer than the multiplies on an H100, so the bound is memory.
//
// Design.  The product: one thread per field element, L-limb arrays in
// registers, no shared memory.  Digit-major: the thread reads digit i of
// its element at i*B + e, so a warp's loads of one digit coalesce into 128
// bytes.  Row-major: the thread reads its D digits as D/4 int4 vectors (one
// limb each).  Any B >= 1; the last block masks.
//
// The point kernel.  On the TPU a point op is 6 (add) or 4 (double)
// dispatches, one per dataflow level, each a round trip to HBM; the port's
// first form launched one product per multiply and left the additions,
// subtractions and selects between them to ~760 small torch kernels a
// point op, paced by the host (the MSM's Horner tail, 256 doubles and 33
// adds at widths 32 and 1, took 67% of msm_bn254_4096).  Here one launch
// evaluates the whole formula of zk/curve.py jadd_formula (add-2007-bl with
// the doubling and infinity cases selected in its order) or jdbl_formula
// (dbl-2009-l) with every element in registers: the CIOS product, modular
// add and sub with one conditional correction, is_zero and the selects.
// Every op is canonical in and canonical out, so the bits equal the plain
// formula whatever the order of evaluation.  The formula's products fall
// into levels of independent ones (an add: 16 in 6 levels of at most 4; a
// double: 7 in 4; the double's only where p = q); a group of 4 lanes
// evaluates one point, lane k computing product k of a level, and every
// lane reads all of them by warp shuffles and runs the additions between
// levels on the same values.  The bound is latency: at B = 1 one point's
// chain of 6 products.  On an H100 80GB HBM3 at 700 W
// (scripts/ablate_point_ops.py) an add took 8.9 us at D = 32 and 15.2 us
// at D = 48 back to back (a launch alone 2.0 us), one lane a point 17.3 and
// 39.8 us; ptxas: 166 (add) and 108 (double) registers at L = 8, 251 and
// 148 at L = 12, no spill.
// Later work: fewer bytes (the int32-per-digit interface is 4x the
// element's size), and the digit-major point ops (>= 2048 points, K9 with
// its torch glue) as one kernel too.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u32 = uint32_t;
using u64 = unsigned long long;

constexpr int kMaxLimbs = 12;
constexpr int kThreads = 256;

// The modulus as 32-bit limbs and -q^-1 mod 2^32, passed by value (kernel
// parameters live in the constant bank).
struct Modulus {
  u32 q[kMaxLimbs];
  u32 qinv;
};

// One row of the CIOS product: t = (t + x_0 b + m_0 q) / 2^32 with m_0 =
// t_0 q' mod 2^32, then x shifts down one limb, so that the row reads x[0]
// whatever its index and a rolled loop indexes no register at run time.
template <int L>
__device__ __forceinline__ void cios_row(u32 (&x)[L], u32 (&t)[L + 2],
                                         const u32 (&b)[L],
                                         const Modulus& m) {
  const u32 ai = x[0];
  u64 carry = 0;  // t += a_i * b
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const u64 p = static_cast<u64>(ai) * b[j] + t[j] + carry;
    t[j] = static_cast<u32>(p);
    carry = p >> 32;
  }
  u64 s = static_cast<u64>(t[L]) + carry;
  t[L] = static_cast<u32>(s);
  t[L + 1] = static_cast<u32>(s >> 32);
  const u32 mi = t[0] * m.qinv;  // t += m_i * q, then shift one limb
  u64 p = static_cast<u64>(mi) * m.q[0] + t[0];
  carry = p >> 32;
#pragma unroll
  for (int j = 1; j < L; ++j) {
    p = static_cast<u64>(mi) * m.q[j] + t[j] + carry;
    t[j - 1] = static_cast<u32>(p);
    carry = p >> 32;
  }
  s = static_cast<u64>(t[L]) + carry;
  t[L - 1] = static_cast<u32>(s);
  t[L] = t[L + 1] + static_cast<u32>(s >> 32);
#pragma unroll
  for (int j = 0; j + 1 < L; ++j) x[j] = x[j + 1];
}

// r = a * b * R^-1 mod q (word-serial CIOS), its L rows unrolled (kFull:
// the bulk kernels) or 4 at a time: ~8L word products of code instead of
// 2L^2, which keeps a whole point op (16 to 23 products in one launch)
// small for the instruction caches (scripts/ablate_point_ops.py times the
// point kernel with its rows rolled and unrolled).
template <int L, bool kFull>
__device__ __forceinline__ void cios(const u32 (&a)[L], const u32 (&b)[L],
                                     const Modulus& m, u32 (&r)[L]) {
  u32 x[L], t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) {
    if (j < L) x[j] = a[j];
    t[j] = 0;
  }
  if constexpr (kFull) {
#pragma unroll
    for (int i = 0; i < L; ++i) cios_row<L>(x, t, b, m);
  } else {
#pragma unroll 4
    for (int i = 0; i < L; ++i) cios_row<L>(x, t, b, m);
  }
  // t < 2q: subtract q once when t >= q
  u32 d[L];
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const u64 diff = static_cast<u64>(t[j]) - m.q[j] - borrow;
    d[j] = static_cast<u32>(diff);
    borrow = static_cast<u32>(diff >> 63);
  }
  const bool ge = (t[L] != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = ge ? d[j] : t[j];
}

template <int L, bool kDigitMajor>
__device__ __forceinline__ void load(const int* __restrict__ x, long long n,
                                     long long e, u32 (&v)[L]) {
  if (kDigitMajor) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      u32 w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w |= static_cast<u32>(__ldg(x + (4 * k + j) * n + e)) << (8 * j);
      v[k] = w;
    }
  } else {
    const int4* p = reinterpret_cast<const int4*>(x + e * (4 * L));
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int4 q = __ldg(p + k);
      v[k] = static_cast<u32>(q.x) | (static_cast<u32>(q.y) << 8) |
             (static_cast<u32>(q.z) << 16) | (static_cast<u32>(q.w) << 24);
    }
  }
}

template <int L, bool kDigitMajor>
__device__ __forceinline__ void store(int* __restrict__ x, long long n,
                                      long long e, const u32 (&v)[L]) {
  if (kDigitMajor) {
#pragma unroll
    for (int k = 0; k < L; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[(4 * k + j) * n + e] = static_cast<int>((v[k] >> (8 * j)) & 255u);
  } else {
    int4* p = reinterpret_cast<int4*>(x + e * (4 * L));
#pragma unroll
    for (int k = 0; k < L; ++k)
      p[k] = make_int4(static_cast<int>(v[k] & 255u),
                       static_cast<int>((v[k] >> 8) & 255u),
                       static_cast<int>((v[k] >> 16) & 255u),
                       static_cast<int>(v[k] >> 24));
  }
}

// out = a * b * R^-1 mod q for n canonical elements.
template <int L, bool kDigitMajor>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    int* __restrict__ out, long long n, Modulus m) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  u32 x[L], y[L], r[L];
  load<L, kDigitMajor>(a, n, e, x);
  load<L, kDigitMajor>(b, n, e, y);
  cios<L, true>(x, y, m, r);
  store<L, kDigitMajor>(out, n, e, r);
}

// ---------------------------------------------------------------------------
// K10 as the card's point kernel: one launch evaluates a whole Jacobian add
// or double, one thread a point, every field element in registers.
// ---------------------------------------------------------------------------

template <int L>
struct Fe {
  u32 v[L];
};

// The lanes that evaluate one point op together (1, 2 or 4): each level's
// independent products (at most 4 in a level) go round the lanes, every
// lane runs the additions between them on the same values.
constexpr int kLanes = 4;

// r[k] = a[k] * b[k] * R^-1 mod q for K <= 4 independent products: lane
// l of the point's group computes products l, l + kLanes, ... (a lane past
// K repeats the last), then every lane reads all K from their lanes.
// `group` is the mask of the group's lanes: groups of a warp may branch
// apart.
template <int L, int K>
__device__ __forceinline__ void mul_k(Fe<L> (&r)[K], const Fe<L> (&a)[K],
                                      const Fe<L> (&b)[K], const Modulus& m,
                                      unsigned group) {
  constexpr int kRounds = (K + kLanes - 1) / kLanes;
  const int lane = threadIdx.x % kLanes;
  Fe<L> p[kRounds];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    Fe<L> x = a[i * kLanes], y = b[i * kLanes];
#pragma unroll
    for (int k = i * kLanes + 1; k < K && k < (i + 1) * kLanes; ++k)
      if (lane >= k - i * kLanes) x = a[k], y = b[k];
    cios<L, false>(x.v, y.v, m, p[i].v);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < L; ++j)
      r[k].v[j] = __shfl_sync(group, p[k / kLanes].v[j], k % kLanes, kLanes);
}

// a + b mod q for canonical a, b: a + b < 2q < R never carries out, and
// one subtraction of q when a + b >= q.
template <int L>
__device__ __forceinline__ Fe<L> fadd(const Fe<L>& a, const Fe<L>& b,
                                      const Modulus& m) {
  Fe<L> s, d;
  u32 c = 0, borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const u64 x = static_cast<u64>(a.v[j]) + b.v[j] + c;
    s.v[j] = static_cast<u32>(x);
    c = static_cast<u32>(x >> 32);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const u64 x = static_cast<u64>(s.v[j]) - m.q[j] - borrow;
    d.v[j] = static_cast<u32>(x);
    borrow = static_cast<u32>(x >> 63);
  }
  return borrow ? s : d;
}

// a - b mod q for canonical a, b: q added back when a - b borrows.
template <int L>
__device__ __forceinline__ Fe<L> fsub(const Fe<L>& a, const Fe<L>& b,
                                      const Modulus& m) {
  Fe<L> d, e;
  u32 borrow = 0, c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const u64 x = static_cast<u64>(a.v[j]) - b.v[j] - borrow;
    d.v[j] = static_cast<u32>(x);
    borrow = static_cast<u32>(x >> 63);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const u64 x = static_cast<u64>(d.v[j]) + m.q[j] + c;
    e.v[j] = static_cast<u32>(x);
    c = static_cast<u32>(x >> 32);
  }
  return borrow ? e : d;
}

template <int L>
__device__ __forceinline__ bool fzero(const Fe<L>& a) {
  u32 o = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) o |= a.v[j];
  return o == 0;
}

template <int L>
struct Point {
  Fe<L> x, y, z;
};

// dbl-2009-l for a = 0 (zk/curve.py jdbl_formula): 3M + 5S in 4 levels of
// independent products.  Z = 0 gives Z3 = 0.
template <int L>
__device__ __forceinline__ Point<L> jdbl(const Point<L>& p, const Modulus& m,
                                         unsigned group) {
  Fe<L> r3[3];
  {
    const Fe<L> a[3] = {p.x, p.y, fadd(p.y, p.y, m)};
    const Fe<L> b[3] = {p.x, p.y, p.z};
    mul_k<L, 3>(r3, a, b, m, group);
  }
  const Fe<L> A = r3[0], B = r3[1];
  Point<L> o;
  o.z = r3[2];
  Fe<L> r2[2];
  {
    const Fe<L> xb = fadd(p.x, B, m);
    const Fe<L> a[2] = {B, xb};
    mul_k<L, 2>(r2, a, a, m, group);
  }
  const Fe<L> C = r2[0];
  const Fe<L> tac = fsub(fsub(r2[1], A, m), C, m);
  const Fe<L> D = fadd(tac, tac, m);                  // 2 (t - A - C)
  const Fe<L> E = fadd(fadd(A, A, m), A, m);          // 3 A
  Fe<L> r1[1];
  {
    const Fe<L> a[1] = {E};
    mul_k<L, 1>(r1, a, a, m, group);
  }
  o.x = fsub(r1[0], fadd(D, D, m), m);                // F - 2 D
  {
    const Fe<L> a[1] = {E};
    const Fe<L> b[1] = {fsub(D, o.x, m)};
    mul_k<L, 1>(r1, a, b, m, group);
  }
  const Fe<L> c2 = fadd(C, C, m), c4 = fadd(c2, c2, m);
  o.y = fsub(r1[0], fadd(c4, c4, m), m);              // E (D - X3) - 8 C
  return o;
}

// add-2007-bl with the doubling and infinity cases of zk/curve.py
// jadd_formula, selected in its order: 16 products in 6 levels of
// independent ones, and the double's 7 only where p = q.
template <int L>
__device__ __forceinline__ Point<L> jadd(const Point<L>& p,
                                         const Point<L>& q, const Modulus& m,
                                         unsigned group) {
  const Fe<L> zz = fadd(p.z, q.z, m);
  Fe<L> r3[3], r4[4], r2[2];
  {
    const Fe<L> a[3] = {p.z, q.z, zz};
    mul_k<L, 3>(r3, a, a, m, group);
  }
  const Fe<L> z1z1 = r3[0], z2z2 = r3[1];
  const Fe<L> zzm = fsub(fsub(r3[2], z1z1, m), z2z2, m);  // 2 Z1 Z2
  {
    const Fe<L> a[4] = {p.x, q.x, q.z, p.z};
    const Fe<L> b[4] = {z2z2, z1z1, z2z2, z1z1};
    mul_k<L, 4>(r4, a, b, m, group);
  }
  const Fe<L> u1 = r4[0], u2 = r4[1];
  {
    const Fe<L> a[2] = {p.y, q.y};
    const Fe<L> b[2] = {r4[2], r4[3]};
    mul_k<L, 2>(r2, a, b, m, group);
  }
  const Fe<L> s1 = r2[0];
  const Fe<L> h = fsub(u2, u1, m);
  const Fe<L> sms = fsub(r2[1], s1, m);                 // S2 - S1
  const Fe<L> rr = fadd(sms, sms, m);
  {
    const Fe<L> h2 = fadd(h, h, m);
    const Fe<L> a[3] = {h2, rr, zzm};
    const Fe<L> b[3] = {h2, rr, h};
    mul_k<L, 3>(r3, a, b, m, group);
  }
  const Fe<L> I = r3[0], rr2 = r3[1];
  Point<L> o;
  o.z = r3[2];
  {
    const Fe<L> a[2] = {h, u1};
    const Fe<L> b[2] = {I, I};
    mul_k<L, 2>(r2, a, b, m, group);
  }
  const Fe<L> J = r2[0], V = r2[1];
  o.x = fsub(fsub(rr2, J, m), fadd(V, V, m), m);
  {
    const Fe<L> a[2] = {s1, rr};
    const Fe<L> b[2] = {J, fsub(V, o.x, m)};
    mul_k<L, 2>(r2, a, b, m, group);
  }
  o.y = fsub(r2[1], fadd(r2[0], r2[0], m), m);

  const bool same_x = fzero(h), same_y = fzero(sms);
  const bool p_inf = fzero(p.z), q_inf = fzero(q.z);
  if (q_inf) return p;
  if (p_inf) return q;
  if (same_x && same_y) return jdbl(p, m, group);
  if (same_x) o.z = Fe<L>{};                            // q = -p
  return o;
}

template <int L>
__device__ __forceinline__ Point<L> load_point(const int* x, const int* y,
                                               const int* z, long long e) {
  Point<L> p;
  load<L, false>(x, 0, e, p.x.v);
  load<L, false>(y, 0, e, p.y.v);
  load<L, false>(z, 0, e, p.z.v);
  return p;
}

struct PointArgs {
  const int* in[6];  // X1, Y1, Z1 (, X2, Y2, Z2): (n, 4L) row-major
  int* out[3];       // X3, Y3, Z3
  long long n;
};

constexpr int kPointThreads = 32;

// One point a group of kLanes lanes; the lanes past the batch repeat its
// last point (every lane of a group takes part in its shuffles) and store
// nothing; lane c % kLanes of a group stores coordinate c.
template <int L, bool kAdd>
__global__ void __launch_bounds__(kPointThreads)
    point_kernel(PointArgs a, Modulus m) {
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kLanes;
  const long long e = g < a.n ? g : a.n - 1;
  const int lane = threadIdx.x % kLanes;
  const unsigned group = ((1u << kLanes) - 1) << (threadIdx.x % 32 - lane);
  const Point<L> p = load_point<L>(a.in[0], a.in[1], a.in[2], e);
  Point<L> o;
  if constexpr (kAdd)
    o = jadd<L>(p, load_point<L>(a.in[3], a.in[4], a.in[5], e), m, group);
  else
    o = jdbl<L>(p, m, group);
  if (g >= a.n) return;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (c % kLanes == lane)
      store<L, false>(a.out[c], 0, e, (c == 0 ? o.x : c == 1 ? o.y : o.z).v);
}

template <int L>
cudaError_t launch(const void* a, const void* b, void* out, long long n,
                   bool digit_major, const Modulus& m, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const auto* pa = static_cast<const int*>(a);
  const auto* pb = static_cast<const int*>(b);
  auto* po = static_cast<int*>(out);
  if (digit_major)
    mont_mul_kernel<L, true><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(pa, pb, po, n, m);
  else
    mont_mul_kernel<L, false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(pa, pb, po, n, m);
  return cudaGetLastError();
}

}  // namespace

// Montgomery product of n canonical elements on `stream`.  a, b, out: int32
// digit planes, (4 n_limbs, n) digit-major when digit_major != 0, else
// (n, 4 n_limbs) row-major with 16-byte-aligned starts; n_limbs is 8 or 12;
// q_limbs: the n_limbs 32-bit limbs of q (host memory); q_inv = -q^-1 mod
// 2^32.  Returns a cudaError_t (0 on success).
extern "C" int nfa_digits_mont_mul(const void* a, const void* b, void* out,
                                   long long n, int n_limbs, int digit_major,
                                   const unsigned* q_limbs, unsigned q_inv,
                                   void* stream) {
  if (n < 1 || (n_limbs != 8 && n_limbs != 12) || q_limbs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Modulus m{};
  for (int j = 0; j < n_limbs; ++j) m.q[j] = q_limbs[j];
  m.qinv = q_inv;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n_limbs == 8 ? launch<8>(a, b, out, n, digit_major != 0, m, s)
                   : launch<12>(a, b, out, n, digit_major != 0, m, s);
  return static_cast<int>(err);
}

// A Jacobian add (add != 0: P + Q, zk/curve.py jadd_formula) or double
// (2P, jdbl_formula) of n canonical points on `stream`, one launch.  p_in:
// the planes X1, Y1, Z1 and, for an add, X2, Y2, Z2; out: X3, Y3, Z3; each
// (n, 4 n_limbs) int32 row-major with a 16-byte-aligned start; n_limbs is 8
// or 12; q_limbs, q_inv as for nfa_digits_mont_mul.  Returns a cudaError_t.
extern "C" int nfa_digits_point(int add, const void* x1, const void* y1,
                                const void* z1, const void* x2,
                                const void* y2, const void* z2, void* x3,
                                void* y3, void* z3, long long n, int n_limbs,
                                const unsigned* q_limbs, unsigned q_inv,
                                void* stream) {
  if (n < 1 || (n_limbs != 8 && n_limbs != 12) || q_limbs == nullptr ||
      (add && (x2 == nullptr || y2 == nullptr || z2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (n * kLanes + kPointThreads - 1) / kPointThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  Modulus m{};
  for (int j = 0; j < n_limbs; ++j) m.q[j] = q_limbs[j];
  m.qinv = q_inv;
  PointArgs a{{static_cast<const int*>(x1), static_cast<const int*>(y1),
               static_cast<const int*>(z1), static_cast<const int*>(x2),
               static_cast<const int*>(y2), static_cast<const int*>(z2)},
              {static_cast<int*>(x3), static_cast<int*>(y3),
               static_cast<int*>(z3)},
              n};
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (n_limbs == 8) {
    if (add)
      point_kernel<8, true><<<grid, kPointThreads, 0, s>>>(a, m);
    else
      point_kernel<8, false><<<grid, kPointThreads, 0, s>>>(a, m);
  } else {
    if (add)
      point_kernel<12, true><<<grid, kPointThreads, 0, s>>>(a, m);
    else
      point_kernel<12, false><<<grid, kPointThreads, 0, s>>>(a, m);
  }
  return static_cast<int>(cudaGetLastError());
}
