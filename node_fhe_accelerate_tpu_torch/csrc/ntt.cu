// Negacyclic NTT kernels for Hopper (sm_90a), bit-exact with the JAX
// package's NTTContext (node_fhe_accelerate_tpu/ops/ntt.py).
//
// Replaces, in node_fhe_accelerate_tpu/ops/ntt_pallas.py:
//   * K6 `_make_transform(inverse=False)` (pallas_call at :179; body
//     `_forward_body` :149, `_fwd_stage` :125): all log N Cooley-Tukey
//     stages, natural order in, bit-reversed out -> `ntt_transform_kernel`
//     with inverse = 0;
//   * K7 `_make_transform(inverse=True)` (`_inverse_body` :154, `_inv_stage`
//     :137): Gentleman-Sande stages, then the N^-1 scale -> the same kernel
//     with inverse = 1;
//   * K8 `_make_negacyclic_mul` (pallas_call at :227, kernel :203):
//     forward(a), forward(b), the pointwise product, inverse, in one launch
//     -> `ntt_negacyclic_mul_kernel`.
//
// Arithmetic.  Values are canonical residues mod an odd q < 2^63, held as
// native u64 (the TPU needs uint32 limb planes; this card has 64-bit
// integer multiplies through `__umul64hi`).  Twiddles are pre-scaled by
// R = 2^64 (w R mod q), so one Montgomery product gives v w mod q exactly:
// t = v (wR), m = (t mod 2^64)(-q^-1) mod 2^64, r = (t + m q) / 2^64 < 2q,
// and one conditional subtraction ends canonical.  K8's pointwise product
// is the plain product mont(mont(a, b), R^2 mod q) = a b mod q.  Every
// result is the canonical residue, so the bits equal the limb-plane
// reductions of ops/modular.py whatever path they take.
//
// What bounds it.  A transform of B polynomials reads and writes two uint32
// planes: 16 B N bytes.  It runs (N/2) log N butterflies per polynomial,
// each one Montgomery product of about 20 32-bit multiplies (a 64x64->128
// product is 8, the low product by -q^-1 4, m q 8).  At the path's shapes
// (N = 4096, B = 1536: 100.7 MB against 7.5e8 multiplies) the multiplies
// take longer than the bytes on an H100, so the bound is operations; at
// N = 256 the two are close.
//
// Design (a first form that is right and simple).  The TPU kernel keeps a
// batch tile in VMEM and uses full-width (log N, N) twiddle vectors and lane
// rolls, so every lane runs a Montgomery product at every stage: twice the
// butterfly's products.  Here a thread indexes its butterfly pair directly:
// N/2 products per stage, from the compact psi^bitrev tables of NTTContext
// (N u64 per direction; stage s reads entries [m, 2m)).
//   * A block holds `per_block` whole polynomials as u64 in shared memory
//     (1 for N >= 2048, 2048/N below), 32 KB at N = 4096 and 128 KB at
//     N = 16384 (dynamic shared memory above 48 KB); K8 holds a and b,
//     64 KB at N = 4096.  The two int32 planes are read once, combined into
//     u64, and written once.
//   * Every thread walks the block's butterflies of a stage with a stride;
//     `__syncthreads()` between stages.  Any batch B >= 1: the last block
//     takes what is left.
//   * No bit-reversal permutation: the CT/GS pairing absorbs it.
// Largest N: 16384 for the transforms, 8192 for K8 (two polynomials in
// 227 KB).  Later work: a register-resident radix-2^k design, warp shuffles
// for the last stages, twiddles in shared memory, fusing the pointwise
// accumulation of the external product.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kMaxThreads = 1024;
constexpr int kBlockElems = 2048;   // coefficients per block below N = 2048
constexpr int kMinLogN = 2;
constexpr int kMaxLogN = 14;

__device__ __forceinline__ u64 mont_mul(u64 a, u64 b, u64 q, u64 qinv) {
  const u64 lo = a * b;
  const u64 hi = __umul64hi(a, b);
  const u64 m = lo * qinv;                 // lo + m q == 0 mod 2^64
  const u64 r = hi + __umul64hi(m, q) + (lo != 0 ? 1ull : 0ull);
  return r >= q ? r - q : r;
}

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
  const u64 s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 q) {
  return a >= b ? a - b : a - b + q;
}

__device__ __forceinline__ void load(const uint32_t* __restrict__ lo,
                                     const uint32_t* __restrict__ hi,
                                     size_t base, int count, u64* x) {
  for (int e = threadIdx.x; e < count; e += blockDim.x)
    x[e] = static_cast<u64>(lo[base + e]) |
           (static_cast<u64>(hi[base + e]) << 32);
}

// Forward CT over `polys` polynomials of 2^logn coefficients in x.  Stage
// s: m = 2^s groups of span t = N >> (s+1); pair (i 2t + j, i 2t + j + t)
// with twiddle tw[m + i].
__device__ void forward_stages(u64* x, int polys, int logn,
                               const u64* __restrict__ tw, u64 q, u64 qinv) {
  const int half_log = logn - 1;
  const int total = polys << half_log;
  for (int s = 0; s < logn; ++s) {
    const int lt = half_log - s;
    const int t = 1 << lt;
    const int m = 1 << s;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int b = k & ((1 << half_log) - 1);
      const int i = b >> lt;
      u64* y = x + (static_cast<size_t>(k >> half_log) << logn) +
               (i << (lt + 1)) + (b & (t - 1));
      const u64 u = y[0];
      const u64 v = mont_mul(y[t], tw[m + i], q, qinv);
      y[0] = add_mod(u, v, q);
      y[t] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse GS: stage s has span t = 2^s and m = N >> (s+1) groups;
// (U, V) -> (U + V, (U - V) itw[m + i]).  The N^-1 scale is left to the
// caller's store.
__device__ void inverse_stages(u64* x, int polys, int logn,
                               const u64* __restrict__ itw, u64 q, u64 qinv) {
  const int half_log = logn - 1;
  const int total = polys << half_log;
  for (int s = 0; s < logn; ++s) {
    const int lt = s;
    const int t = 1 << lt;
    const int m = 1 << (half_log - s);
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int b = k & ((1 << half_log) - 1);
      const int i = b >> lt;
      u64* y = x + (static_cast<size_t>(k >> half_log) << logn) +
               (i << (lt + 1)) + (b & (t - 1));
      const u64 u = y[0];
      const u64 v = y[t];
      y[0] = add_mod(u, v, q);
      y[t] = mont_mul(sub_mod(u, v, q), itw[m + i], q, qinv);
    }
    __syncthreads();
  }
}

// Write x (scaled by `scale` in Montgomery form when `scaled`) as planes.
__device__ __forceinline__ void store(const u64* x, size_t base, int count,
                                      bool scaled, u64 scale, u64 q,
                                      u64 qinv, uint32_t* __restrict__ olo,
                                      uint32_t* __restrict__ ohi) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const u64 v = scaled ? mont_mul(x[e], scale, q, qinv) : x[e];
    olo[base + e] = static_cast<uint32_t>(v);
    ohi[base + e] = static_cast<uint32_t>(v >> 32);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
ntt_transform_kernel(const uint32_t* __restrict__ lo,
                     const uint32_t* __restrict__ hi,
                     uint32_t* __restrict__ olo, uint32_t* __restrict__ ohi,
                     const u64* __restrict__ tw, u64 q, u64 qinv,
                     u64 ninv_r, int inverse, int batch, int logn,
                     int per_block) {
  extern __shared__ __align__(16) u64 x[];
  const long long p0 = static_cast<long long>(blockIdx.x) * per_block;
  const int polys = static_cast<int>(
      min(static_cast<long long>(per_block), batch - p0));
  const size_t base = static_cast<size_t>(p0) << logn;
  const int count = polys << logn;
  load(lo, hi, base, count, x);
  __syncthreads();
  if (inverse)
    inverse_stages(x, polys, logn, tw, q, qinv);
  else
    forward_stages(x, polys, logn, tw, q, qinv);
  store(x, base, count, inverse != 0, ninv_r, q, qinv, olo, ohi);
}

__global__ void __launch_bounds__(kMaxThreads)
ntt_negacyclic_mul_kernel(const uint32_t* __restrict__ alo,
                          const uint32_t* __restrict__ ahi,
                          const uint32_t* __restrict__ blo,
                          const uint32_t* __restrict__ bhi,
                          uint32_t* __restrict__ olo,
                          uint32_t* __restrict__ ohi,
                          const u64* __restrict__ fwd_tw,
                          const u64* __restrict__ inv_tw, u64 q, u64 qinv,
                          u64 ninv_r, u64 r2, int batch, int logn,
                          int per_block) {
  extern __shared__ __align__(16) u64 x[];
  const long long p0 = static_cast<long long>(blockIdx.x) * per_block;
  const int polys = static_cast<int>(
      min(static_cast<long long>(per_block), batch - p0));
  const size_t base = static_cast<size_t>(p0) << logn;
  const int count = polys << logn;
  u64* xa = x;
  u64* xb = x + count;          // b right after a: 2 * polys polynomials
  load(alo, ahi, base, count, xa);
  load(blo, bhi, base, count, xb);
  __syncthreads();
  forward_stages(x, 2 * polys, logn, fwd_tw, q, qinv);
  for (int e = threadIdx.x; e < count; e += blockDim.x)
    xa[e] = mont_mul(mont_mul(xa[e], xb[e], q, qinv), r2, q, qinv);
  __syncthreads();
  inverse_stages(xa, polys, logn, inv_tw, q, qinv);
  store(xa, base, count, true, ninv_r, q, qinv, olo, ohi);
}

bool args_ok(u64 q, int batch, int logn) {
  return batch >= 1 && logn >= kMinLogN && logn <= kMaxLogN && (q & 1) &&
         q > 2 && q < (1ull << 63);
}

// Polynomials per block and threads per block for N = 2^logn.
void geometry(int logn, int* per_block, int* threads) {
  const int n = 1 << logn;
  const int elems = n > kBlockElems ? n : kBlockElems;
  *per_block = elems / n;
  int t = elems / 4;
  *threads = t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// One forward (inverse = 0) or inverse (inverse = 1) negacyclic NTT of
// `batch` polynomials of 2^logn coefficients on `stream`.  lo/hi and
// olo/ohi: uint32 planes (batch, N), canonical residues; tw: u64 (N,),
// the Montgomery-scaled psi^bitrev (forward) or psi^-bitrev (inverse)
// table; qinv = -q^-1 mod 2^64; ninv_r = N^-1 R mod q.  Returns a
// cudaError_t (0 on success).
extern "C" int nfa_ntt_transform(const void* lo, const void* hi, void* olo,
                                 void* ohi, const void* tw,
                                 unsigned long long q,
                                 unsigned long long qinv,
                                 unsigned long long ninv_r, int inverse,
                                 int batch, int logn, void* stream) {
  if (!args_ok(q, batch, logn)) return static_cast<int>(cudaErrorInvalidValue);
  int per_block = 0, threads = 0;
  geometry(logn, &per_block, &threads);
  const size_t smem = (static_cast<size_t>(per_block) << logn) * sizeof(u64);
  cudaError_t err = allow_smem(ntt_transform_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + per_block - 1) / per_block;
  ntt_transform_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<uint32_t*>(olo), static_cast<uint32_t*>(ohi),
      static_cast<const u64*>(tw), q, qinv, ninv_r, inverse, batch, logn,
      per_block);
  return static_cast<int>(cudaGetLastError());
}

// a * b mod (X^N + 1, q) for `batch` pairs in one launch: forward(a),
// forward(b), pointwise product, inverse.  r2 = R^2 mod q.
extern "C" int nfa_ntt_negacyclic_mul(const void* alo, const void* ahi,
                                      const void* blo, const void* bhi,
                                      void* olo, void* ohi,
                                      const void* fwd_tw, const void* inv_tw,
                                      unsigned long long q,
                                      unsigned long long qinv,
                                      unsigned long long ninv_r,
                                      unsigned long long r2, int batch,
                                      int logn, void* stream) {
  if (!args_ok(q, batch, logn)) return static_cast<int>(cudaErrorInvalidValue);
  int per_block = 0, threads = 0;
  geometry(logn, &per_block, &threads);
  const size_t smem =
      2 * (static_cast<size_t>(per_block) << logn) * sizeof(u64);
  cudaError_t err = allow_smem(ntt_negacyclic_mul_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + per_block - 1) / per_block;
  ntt_negacyclic_mul_kernel<<<grid, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(alo), static_cast<const uint32_t*>(ahi),
      static_cast<const uint32_t*>(blo), static_cast<const uint32_t*>(bhi),
      static_cast<uint32_t*>(olo), static_cast<uint32_t*>(ohi),
      static_cast<const u64*>(fwd_tw), static_cast<const u64*>(inv_tw), q,
      qinv, ninv_r, r2, batch, logn, per_block);
  return static_cast<int>(cudaGetLastError());
}
