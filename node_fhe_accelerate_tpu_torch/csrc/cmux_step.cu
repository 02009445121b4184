// One TFHE blind-rotate CMux step on Hopper (sm_90a), bit-exact with the
// JAX package's Pallas kernel.
//
//   out = acc + sum_p 256^p * (digits(X^rot * acc - acc) x Toeplitz(g~_p))
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py `_cmux_kernel_v1`
// (entries `cmux_step_tiles` and `cmux_step_pallas(variant="v1")`).
//
// Bound at TFHE_BOOT_128_K4 (k=4, N=256, l=2, P=4), batch 4096: the
// contraction is B x (l(k+1)N) x ((k+1)PN) = 4096 x 2560 x 5120 =
// 5.37e10 int8 MACs per step, 54.3 us at the H100 SXM's 1,979 dense int8
// TOPS; the acc read + write is 42 MB, 12.5 us at 3.35 TB/s.  So the step
// is bound by operations, and the design keeps everything but acc and the
// step's weights out of device memory:
//
// * One block per tile of `bt` batch rows (blocks are independent: the TPU
//   grid's sequential order is not needed).  The block computes the
//   rotated difference and its balanced int8 gadget digits straight into
//   shared memory -- the rotation is a direct indexed read,
//   x[(i - r) mod 2N] with the sign of the wrapped half, where the TPU
//   needed a ladder of static rolls.
// * The weights are the BSK row's int8 digit planes as stored
//   (lvl, k+1, k+1, P, 2N): 102 KB at K4, copied once per block into
//   shared memory as reversed tables H[y] = g~[(-y) mod 2N].  A Toeplitz
//   entry T[c, r] = g~[(r - c) mod 2N] is then H[(c - r) mod 2N], and four
//   consecutive c are four consecutive bytes of H: an MMA B-fragment
//   register is two aligned 32-bit shared loads and a funnel shift.  The
//   TPU's precomputed diagonal tiles (6.2 GB at K4) are not needed.
// * The contraction runs on the tensor cores as mma.sync m16n8k32
//   s8 x s8 -> s32.  Each warp task is 16 rows x 32 columns of one output
//   component jp, for all P planes at once, so the base-256 plane
//   recombination mod 2^32 happens in registers before the single store.
//
// Exactness: digits |d| <= 2^(base_log-1) and planes |g| <= 128, so each
// int32 sum is at most terms * 2^(base_log-1) * 128 < 2^31 -- the wrapper
// refuses shapes outside that bound.  Recombination and the CMux add wrap
// in uint32 as the reference does.
//
// This is the simple first form (legacy mma.sync, one block per SM).
// wgmma, TMA and a persistent whole-ladder kernel are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = 4;      // 8-column MMA tiles per warp task
constexpr int kMaxPlanes = 4;
constexpr int kRowPad = 16;     // bytes after each digit row: spreads banks
constexpr int kTablePad = 32;   // H runs past 2N so x + 16 + 3 never wraps

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes base[x .. x+3] as one little-endian word, for any alignment of x
// (base itself is 4-byte aligned).
__device__ __forceinline__ uint32_t load_word(const int8_t* base, int x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base) + (x >> 2);
  return __funnelshift_r(w[0], w[1], (x & 3) * 8);
}

__global__ void __launch_bounds__(kThreads)
cmux_step_kernel(const uint32_t* __restrict__ acc,
                 const int32_t* __restrict__ rot,
                 const int8_t* __restrict__ g, uint32_t* __restrict__ out,
                 int batch, int kp1, int lvl, int planes, int n,
                 int base_log, int bt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int two_n = 2 * n;
  const int kdim = lvl * kp1 * n;          // contraction length
  const int rs = kdim + kRowPad;           // digit row stride, bytes
  const int hs = two_n + kTablePad;        // table stride, bytes
  int8_t* dig = reinterpret_cast<int8_t*>(smem);   // [bt][rs]
  int8_t* tab = dig + bt * rs;                     // [lvl][k+1][k+1][P][hs]
  const int b0 = blockIdx.x * bt;
  const int tid = threadIdx.x;

  // 1. Reversed weight tables: tab[t][y] = g[t][(-y) mod 2N].
  const int ntab = lvl * kp1 * kp1 * planes;
  for (int i = tid; i < ntab * hs; i += kThreads) {
    const int t = i / hs;
    const int y = i - t * hs;
    tab[i] = g[t * two_n + ((two_n - y) & (two_n - 1))];
  }

  // 2. Balanced digits of X^rot * acc - acc (TorusRing.decompose).
  const int total = lvl * base_log;
  const uint32_t rounding = total < 32 ? (1u << (31 - total)) : 0u;
  const int top_shift = 32 - total;
  const uint32_t dmask = (1u << base_log) - 1u;
  const uint32_t half = 1u << (base_log - 1);
  for (int i = tid; i < bt * kp1 * n; i += kThreads) {
    const int row = i / (kp1 * n);
    const int rem = i - row * kp1 * n;
    const int j = rem / n;
    const int c = rem - j * n;
    const int b = b0 + row;
    int8_t* drow = dig + row * rs + j * n + c;
    if (b >= batch) {
      for (int l = 0; l < lvl; ++l) drow[l * kp1 * n] = 0;
      continue;
    }
    const uint32_t* a = acc + (static_cast<size_t>(b) * kp1 + j) * n;
    int r = rot[b] % two_n;
    if (r < 0) r += two_n;
    const int idx = (c - r) & (two_n - 1);
    const uint32_t v = idx < n ? a[idx] : 0u - a[idx - n];
    uint32_t y = (v - a[c] + rounding) >> top_shift;
    uint32_t carry = 0u;
    for (int l = lvl - 1; l >= 0; --l) {
      const uint32_t d = (y & dmask) + carry;
      y >>= base_log;
      carry = d >= half ? 1u : 0u;
      drow[l * kp1 * n] = static_cast<int8_t>(
          carry ? static_cast<int>(d) - (1 << base_log)
                : static_cast<int>(d));
    }
  }
  __syncthreads();

  // 3. Tensor-core contraction + in-register plane recombination.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;   // MMA groupID
  const int tq = lane & 3;    // MMA threadID_in_group
  const int m_tiles = bt / 16;
  const int n_groups = n / (8 * kNTiles);
  const int tasks = m_tiles * kp1 * n_groups;
  for (int task = warp; task < tasks; task += kWarps) {
    const int mt = task % m_tiles;
    const int jp = (task / m_tiles) % kp1;
    const int r0 = (task / (m_tiles * kp1)) * (8 * kNTiles);
    int c_frag[kMaxPlanes][kNTiles][4] = {};
    const int8_t* d0 = dig + (mt * 16 + gq) * rs + 4 * tq;
    const int8_t* d1 = d0 + 8 * rs;
    for (int lj = 0; lj < lvl * kp1; ++lj) {
      const int8_t* tb = tab + static_cast<size_t>(lj * kp1 + jp) * planes * hs;
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int q = lj * n + c0;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(d0 + q);
        a[1] = *reinterpret_cast<const uint32_t*>(d1 + q);
        a[2] = *reinterpret_cast<const uint32_t*>(d0 + q + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(d1 + q + 16);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          // B fragment of column r = r0 + 8nt + gq, rows c0 + 4tq (+16):
          // T[c .. c+3, r] = H[x .. x+3] with x = (c - r) mod 2N.
          const int x = (c0 + 4 * tq - (r0 + nt * 8 + gq)) & (two_n - 1);
#pragma unroll
          for (int p = 0; p < kMaxPlanes; ++p) {
            if (p < planes) {
              const int8_t* h = tb + p * hs;
              mma_s8(c_frag[p][nt], a, load_word(h, x), load_word(h, x + 16));
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int col = r0 + nt * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = b0 + mt * 16 + gq + 8 * hh;
        if (b >= batch) continue;
        const size_t o = (static_cast<size_t>(b) * kp1 + jp) * n + col;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t v = 0u;
#pragma unroll
          for (int p = 0; p < kMaxPlanes; ++p) {
            if (p < planes) {
              v += static_cast<uint32_t>(c_frag[p][nt][2 * hh + e]) << (8 * p);
            }
          }
          out[o + e] = acc[o + e] + v;
        }
      }
    }
  }
}

}  // namespace

// Launch one CMux step on `stream`.  acc/out: uint32 bits (B, k+1, N);
// rot: int32 (B,); g: int8 (lvl, k+1, k+1, P, 2N).  The caller has checked
// shapes and the int32 bound.  Returns a cudaError_t (0 on success).
extern "C" int nfa_cmux_step(const void* acc, const void* rot, const void* g,
                             void* out, int batch, int kp1, int lvl,
                             int planes, int n, int base_log, void* stream) {
  if (batch <= 0 || n < 32 || (n & (n - 1)) || planes < 1 ||
      planes > kMaxPlanes || base_log < 1 || base_log > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  int max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t table = static_cast<size_t>(lvl) * kp1 * kp1 * planes *
                       (2 * n + kTablePad);
  const size_t row = static_cast<size_t>(lvl) * kp1 * n + kRowPad;
  int bt = 0;
  for (int cand = 64; cand >= 16; cand /= 2) {
    if (table + cand * row <= static_cast<size_t>(max_smem)) {
      bt = cand;
      break;
    }
  }
  if (bt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(table + bt * row);
  err = cudaFuncSetAttribute(cmux_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + bt - 1) / bt;
  cmux_step_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(rot),
      static_cast<const int8_t*>(g), static_cast<uint32_t*>(out), batch, kp1,
      lvl, planes, n, base_log, bt);
  return static_cast<int>(cudaGetLastError());
}
