// Device code shared by the CMux kernels of the port (cmux_step.cu,
// cmux_step_slabs.cu, ladder_tiles.cu, ladder_steps.cu).  Every kernel
// computes, per batch row and per blind-rotate step,
//
//   out = acc + sum_p 256^(p+drop) * (digits(X^rot * acc - acc) x T(g~_p))
//
// and differs only in where the Toeplitz weights T come from and in how
// many steps one launch runs.  The phases are:
//
// * digit_phase: rotate, difference and balanced int8 gadget digits of a
//   tile of batch rows, written to shared memory as dig[row][(l, j, c)];
// * build_tables + toeplitz_mma_phase: the contraction against reversed
//   tables H[y] = g~[(-y) mod 2N] held in shared memory (weights read from
//   the bootstrap key's row as stored);
// * slab_mma_phase: the contraction against prepared slabs in device
//   memory, W[(l, j, c), (jp, p, r)] with the column axis contiguous.
//
// All contractions are mma.sync m16n8k32 s8 x s8 -> s32 and recombine the
// base-256 planes mod 2^32 in registers before the single store.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace nfa {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = 4;      // 8-column MMA tiles per warp task
constexpr int kMaxPlanes = 4;
constexpr int kRowPad = 16;     // bytes after each digit row: spreads banks
constexpr int kTablePad = 32;   // H runs past 2N so x + 16 + 3 never wraps
constexpr int kBlock = 128;     // block-Toeplitz tile edge of the slabs

static __device__ __forceinline__ void mma_s8(int (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes base[x .. x+3] as one little-endian word, for any alignment of x
// (base itself is 4-byte aligned).
static __device__ __forceinline__ uint32_t load_word(const int8_t* base,
                                                     int x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base) + (x >> 2);
  return __funnelshift_r(w[0], w[1], (x & 3) * 8);
}

// sum_p vals[p] * 256^(p+drop) mod 2^32 over the first `planes` planes.
static __device__ __forceinline__ uint32_t recombine(
    const int (&vals)[kMaxPlanes], int planes, int drop) {
  uint32_t v = 0u;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    if (p < planes) v += static_cast<uint32_t>(vals[p]) << (8 * (p + drop));
  }
  return v;
}

// Digit row stride in bytes for a contraction of lvl * kp1 * n digits.
static __host__ __device__ __forceinline__ size_t digit_row_bytes(int lvl,
                                                                  int kp1,
                                                                  int n) {
  return static_cast<size_t>(lvl) * kp1 * n + kRowPad;
}

// Balanced gadget digits of X^rot * acc - acc (TorusRing.decompose) for the
// batch rows [b0, b0 + bt): dig[row * rs + (l * kp1 + j) * n + c].  Rows at
// or past `batch` get zero digits.  `acc` is read through a plain pointer:
// the ladder kernels update it in place between calls.
static __device__ __forceinline__ void digit_phase(
    const uint32_t* acc, const int32_t* rot, int8_t* dig, int rs, int b0,
    int bt, int batch, int kp1, int lvl, int n, int base_log) {
  const int two_n = 2 * n;
  const int total = lvl * base_log;
  const uint32_t rounding = total < 32 ? (1u << (31 - total)) : 0u;
  const int top_shift = 32 - total;
  const uint32_t dmask = (1u << base_log) - 1u;
  const uint32_t half = 1u << (base_log - 1);
  for (int i = threadIdx.x; i < bt * kp1 * n; i += kThreads) {
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
}

// Reversed weight tables of one bootstrap-key row g (lvl, k+1, k+1, P, 2N):
// tab[t * hs + y] = g[t][(-y) mod 2N], hs = 2N + kTablePad.
static __device__ __forceinline__ void build_tables(const int8_t* g,
                                                    int8_t* tab, int ntab,
                                                    int n) {
  const int two_n = 2 * n;
  const int hs = two_n + kTablePad;
  for (int i = threadIdx.x; i < ntab * hs; i += kThreads) {
    const int t = i / hs;
    const int y = i - t * hs;
    tab[i] = g[t * two_n + ((two_n - y) & (two_n - 1))];
  }
}

// Tensor-core contraction of the digit tile against the reversed tables and
// the CMux add: dst = src + recombined product, for the rows of this tile.
// Each warp task is 16 rows x 32 columns of one output component jp, for
// all planes.  src and dst may be the same buffer: a task reads and writes
// only its own elements.
static __device__ __forceinline__ void toeplitz_mma_phase(
    const int8_t* dig, int rs, const int8_t* tab, const uint32_t* src,
    uint32_t* dst, int b0, int bt, int batch, int kp1, int lvl, int planes,
    int n) {
  const int two_n = 2 * n;
  const int hs = two_n + kTablePad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
          int vals[kMaxPlanes];
#pragma unroll
          for (int p = 0; p < kMaxPlanes; ++p)
            vals[p] = c_frag[p][nt][2 * hh + e];
          dst[o + e] = src[o + e] + recombine(vals, planes, 0);
        }
      }
    }
  }
}

// Four words holding rows k..k+3 of four adjacent columns, byte-transposed
// into four words holding one column each with k contiguous: y[e] is
// (x[0].byte e, x[1].byte e, x[2].byte e, x[3].byte e).
static __device__ __forceinline__ void transpose_4x4(const uint32_t (&x)[4],
                                                     uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Contraction of the digit tile against prepared slabs in device memory,
// and the CMux add.  The slabs keep the layout the reference's build_*
// functions give, W[k, (jp, p, r)] with the column axis contiguous,
// `wide` = kp1 * P * 128 bytes per row:
//
// * kRtMajor = false (build_diag_slabs): slab di = rt - ct + nt - 1 has
//   rows (l, j, c) with c in [0, 128): lvl * kp1 * 128 rows;
// * kRtMajor = true (build_rt_slabs): slab rt has rows (l, j, ct * 128 + c):
//   lvl * kp1 * n rows, the same order as a digit row.
//
// mma.sync wants four consecutive k of one column in a B register, and the
// slab has four consecutive columns in a word.  A thread therefore loads
// the words of rows k..k+3 at columns 4gq..4gq+3 and transposes the 4 x 4
// bytes in registers: that gives the B registers of four 8-column MMA tiles
// whose column n = gq stands for slab column 4gq + e (e the tile).  The
// permutation is undone in the epilogue, where a thread ends up holding
// eight consecutive output columns of two rows.
//
// A warp task is MT 16-row tiles x RG block-rows rt x 32 columns x all
// planes of one output component jp: the B registers serve MT tiles of
// rows, the A registers serve RG block-rows.
template <int MT, int RG, bool kRtMajor>
static __device__ __forceinline__ void slab_mma_phase(
    const int8_t* dig, int rs, const int8_t* __restrict__ w,
    const uint32_t* src, uint32_t* dst, int b0, int bt, int batch, int kp1,
    int lvl, int planes, int n, int drop) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int nt = n / kBlock;
  const size_t wide = static_cast<size_t>(kp1) * planes * kBlock;
  const size_t slab_bytes =
      static_cast<size_t>(lvl) * kp1 * (kRtMajor ? n : kBlock) * wide;
  const int m_groups = bt / (16 * MT);
  const int rt_groups = (nt + RG - 1) / RG;
  const int col_chunks = kBlock / (8 * kNTiles);
  const int tasks = m_groups * col_chunks * kp1 * rt_groups;
  for (int task = warp; task < tasks; task += kWarps) {
    int t = task;
    const int mg = t % m_groups;
    t /= m_groups;
    const int r0 = (t % col_chunks) * (8 * kNTiles);
    t /= col_chunks;
    const int jp = t % kp1;
    const int rt0 = (t / kp1) * RG;
    int c_frag[RG][MT][kMaxPlanes][kNTiles][4] = {};
    const int8_t* drow = dig + (mg * MT * 16 + gq) * rs + 4 * tq;
    const int8_t* wcol = w + static_cast<size_t>(jp) * planes * kBlock + r0 +
                         4 * gq + static_cast<size_t>(4 * tq) * wide;
    for (int lj = 0; lj < lvl * kp1; ++lj) {
      for (int ct = 0; ct < nt; ++ct) {
        for (int c0 = 0; c0 < kBlock; c0 += 32) {
          const int q = lj * n + ct * kBlock + c0;
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int8_t* d0 = drow + m * 16 * rs + q;
            const int8_t* d1 = d0 + 8 * rs;
            a[m][0] = *reinterpret_cast<const uint32_t*>(d0);
            a[m][1] = *reinterpret_cast<const uint32_t*>(d1);
            a[m][2] = *reinterpret_cast<const uint32_t*>(d0 + 16);
            a[m][3] = *reinterpret_cast<const uint32_t*>(d1 + 16);
          }
#pragma unroll
          for (int g = 0; g < RG; ++g) {
            const int rt = rt0 + g;
            if (rt >= nt) continue;
            const int8_t* wk =
                wcol + (kRtMajor
                            ? rt * slab_bytes + static_cast<size_t>(q) * wide
                            : (rt - ct + nt - 1) * slab_bytes +
                                  static_cast<size_t>(lj * kBlock + c0) * wide);
#pragma unroll
            for (int p = 0; p < kMaxPlanes; ++p) {
              if (p < planes) {
                const int8_t* wp = wk + p * kBlock;
                uint32_t x[4], b_lo[4], b_hi[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  x[i] = __ldg(
                      reinterpret_cast<const uint32_t*>(wp + i * wide));
                transpose_4x4(x, b_lo);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  x[i] = __ldg(
                      reinterpret_cast<const uint32_t*>(wp + (16 + i) * wide));
                transpose_4x4(x, b_hi);
#pragma unroll
                for (int e = 0; e < kNTiles; ++e) {
#pragma unroll
                  for (int m = 0; m < MT; ++m)
                    mma_s8(c_frag[g][m][p][e], a[m], b_lo[e], b_hi[e]);
                }
              }
            }
          }
        }
      }
    }
    // Tile e, fragment column 2tq + s is slab column 4(2tq + s) + e, so the
    // thread holds columns r0 + 8tq .. r0 + 8tq + 7 of rows gq and gq + 8.
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const int rt = rt0 + g;
      if (rt >= nt) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = b0 + (mg * MT + m) * 16 + gq + 8 * hh;
          if (b >= batch) continue;
          const size_t o = (static_cast<size_t>(b) * kp1 + jp) * n +
                           rt * kBlock + r0 + 8 * tq;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int e = 0; e < kNTiles; ++e) {
              int vals[kMaxPlanes];
#pragma unroll
              for (int p = 0; p < kMaxPlanes; ++p)
                vals[p] = c_frag[g][m][p][e][2 * hh + s];
              dst[o + 4 * s + e] =
                  src[o + 4 * s + e] + recombine(vals, planes, drop);
            }
          }
        }
      }
    }
  }
}

// Largest tile of batch rows out of `cands` (descending, multiples of 16,
// zero-terminated) whose digit rows fit beside `fixed` bytes in the shared
// memory a block may opt into on the current device; 0 if none fits.
static inline cudaError_t pick_batch_tile(size_t fixed, size_t row,
                                          const int* cands, int* bt,
                                          size_t* smem) {
  int dev = 0;
  int max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *bt = 0;
  for (; *cands; ++cands) {
    if (fixed + *cands * row <= static_cast<size_t>(max_smem)) {
      *bt = *cands;
      break;
    }
  }
  if (*bt == 0) return cudaErrorInvalidValue;
  *smem = fixed + *bt * row;
  return cudaSuccess;
}

static inline bool shape_ok(int batch, int kp1, int lvl, int planes, int n,
                            int base_log) {
  return batch > 0 && kp1 >= 1 && lvl >= 1 && n >= 32 && !(n & (n - 1)) &&
         planes >= 1 && planes <= kMaxPlanes && base_log >= 1 &&
         base_log <= 8;
}

}  // namespace nfa
