// Montgomery field-multiply kernels for Hopper (sm_90a) on 8-bit digit
// planes, bit-exact with the JAX package's digit algebra
// (node_fhe_accelerate_tpu/zk/field.py Field.mul, ops/digits.py).
//
// Replaces, in node_fhe_accelerate_tpu/ops/digits_pallas.py:
//   * K9 `_mul_t_raw` (:375; pallas_call at :393, kernel :388, algebra
//     `_KernelFieldT.mul` :355-366): the product on digit-MAJOR (D, B)
//     planes -> `mont_mul_kernel<L, true>`;
//   * K10 `_point_call` (:243; pallas_call at :252, algebra
//     `_KernelField.mul` :208-209): the same product on row-major (B, D)
//     planes -> `mont_mul_kernel<L, false>`.
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
// Design (a first form that is right and simple).  One thread per field
// element, L-limb arrays in registers, no shared memory.  Digit-major: the
// thread reads digit i of its element at i*B + e, so a warp's loads of one
// digit coalesce into 128 bytes.  Row-major: the thread reads its D digits
// as D/4 int4 vectors (one limb each).  Any B >= 1; the last block masks.
// Later work: fewer bytes (the int32-per-digit interface is 4x the
// element's size) and fusing a whole Jacobian add into one kernel.

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

template <int L>
__device__ __forceinline__ void cios(const u32 (&a)[L], const u32 (&b)[L],
                                     const Modulus& m, u32 (&r)[L]) {
  u32 t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    u64 carry = 0;  // t += a_i * b
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const u64 p = static_cast<u64>(a[i]) * b[j] + t[j] + carry;
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
  cios<L>(x, y, m, r);
  store<L, kDigitMajor>(out, n, e, r);
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
