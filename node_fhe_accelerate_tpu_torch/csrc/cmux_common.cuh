// Device code shared by the CMux kernels of the port (cmux_step.cu K1,
// cmux_step_slabs.cu K2/K3, ladder_tiles.cu K4, ladder_steps.cu K5).  Every
// kernel computes, per batch row and per blind-rotate step,
//
//   out = acc + sum_p 256^(p+drop) * (digits(X^rot * acc - acc) x T(g~_p))
//
// and differs only in where the Toeplitz weights T come from, in how many
// steps one launch runs and in the order a block walks its tiles.  All of
// them run one body, cmux_hopper_body: a digit phase into a global
// row-major buffer that TMA reads back as the A operand, warpgroup
// wgmma.mma_async s8 x s8 -> s32 fed from a ring of 128-byte-swizzled
// shared tiles under mbarriers, and an epilogue that recombines the
// base-256 planes mod 2^32 in registers before the single store.  B comes
// by TMA from a K-major weight form in device memory (K5's per-step slabs,
// K2/K3's diagonal slabs) or is expanded on chip from the key rows as
// stored (K1, K4).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

namespace nfa {

// The contraction of a tile of kTileM = 128 batch rows against 64 * P
// output columns (64 coefficients of one output component jp, all P planes)
// runs as `wgmma.mma_async` m64n(64P)k32 s8 x s8 -> s32, one 64-row half per
// consumer warpgroup.  wgmma takes 8-bit operands only K-major, so both
// tiles keep the contraction index (l, j, c) contiguous:
//
// * A, the digits, is a global row-major buffer dig[row][(l, j, c)] that
//   the digit phase writes and a TMA load reads back, 128 rows x 128 bytes
//   a stage;
// * B is 64P rows, one per output column, of 128 K bytes a stage, ordered
//   (coefficient block q of 8, plane p, position w): accumulator chunk
//   j = qP + p holds columns 8j + 2(t%4) + {0,1}, so a thread holds every
//   plane of its coefficients and recombines them in registers.
//
// Both tiles sit in shared memory in the 128-byte swizzle that TMA writes
// and the wgmma descriptor reads (16-byte piece i of row r at
// r * 128 + ((i ^ (r % 8)) * 16), rows in 1024-byte atoms of 8).  A stage
// is filled by a producer warpgroup and released by the consumers through
// full/empty mbarriers in a ring of kMaxStages at most.

constexpr int kMaxPlanes = 4;
constexpr int kTileM = 128;          // batch rows of a tile: 2 x 64
constexpr int kChunk = 128;          // K bytes of a stage
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;   // 2 consumers, 1 producer
constexpr int kMaxStages = 4;
constexpr int kConsumerWarps = 8;
constexpr uint32_t kATileBytes = kTileM * kChunk;

// A stage: the A tile, then the B tile of 64P rows.
static __host__ __device__ __forceinline__ uint32_t stage_bytes(int planes) {
  return kATileBytes + 64u * planes * kChunk;
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Expect `bytes` more of asynchronous copies in the current phase, without
// arriving.
static __device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                           uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA load of a 2-D box at (c0 bytes along K, c1 rows).
static __device__ __forceinline__ void tma_load(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy writes (st.shared / st.global) made visible to the async
// proxy (wgmma, TMA) that reads them next.
static __device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

static __device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row atoms 1024 bytes apart; the start address advances by 32 bytes per
// k32 step inside the atom.
static __device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= uint64_t(1) << 16;               // leading offset (unused here)
  d |= uint64_t(1024 >> 4) << 32;       // stride offset: one 8-row atom
  d |= uint64_t(1) << 62;               // 128-byte swizzle
  return d;
}

template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct WgmmaS8<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
        "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
        "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
        "%101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, "
        "%119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <int R>
static __device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The contraction of one tile: `nk` stages of the ring, each four k32
// steps of m64n(64P)k32 for this consumer warpgroup's 64 rows.  The wgmma
// group of a stage stays in flight while the next stage is waited for and
// issued; a stage goes back to the producer once its group has completed.
// `stage` and `phase` walk the ring in the same order as the producer.
template <int P>
static __device__ __forceinline__ void consume_tile(int (&d)[32 * P],
                                                    uint8_t* ring,
                                                    uint64_t* full,
                                                    uint64_t* empty,
                                                    int stages, int nk,
                                                    int& stage,
                                                    uint32_t& phase) {
  const int wg = threadIdx.x / kWgThreads;
  const uint32_t sb = stage_bytes(P);
  const bool signal = (threadIdx.x & 31) == 0;
  int prev = -1;
  fence_operands(d);
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&full[stage], phase);
    uint8_t* st = ring + stage * sb;
    const uint64_t da = sw128_desc(st + wg * (kATileBytes / 2));
    const uint64_t db = sw128_desc(st + kATileBytes);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk)
      WgmmaS8<64 * P>::mma(d, da + 2 * kk, db + 2 * kk, kc | kk);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(d);
  if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
}

// The epilogue's view of a tile: this thread's rows row0 + 16 * warp +
// lane / 4 (+ 8) and coefficients coef0 + 8q + 2 (lane % 4) (+ 1), q < 8, of
// output component jp.
struct TileRows {
  size_t o[2];       // element offset of (row, jp, coefficient) per half
  bool live[2];      // row < batch
};

static __device__ __forceinline__ TileRows tile_rows(int row0, int batch,
                                                     int kp1, int n, int jp,
                                                     int coef0) {
  const int t = threadIdx.x % kWgThreads;
  const int lane = t & 31;
  TileRows r;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * (t >> 5) + (lane >> 2) + 8 * half;
    r.live[half] = row < batch;
    r.o[half] = (static_cast<size_t>(row) * kp1 + jp) * n + coef0 +
                2 * (lane & 3);
  }
  return r;
}

// Load the accumulator values a tile adds to, before its contraction, so
// that the load's latency hides behind the wgmma stages.
static __device__ __forceinline__ void epilogue_load(uint2 (&v)[2][8],
                                                     const uint32_t* src,
                                                     const TileRows& r) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[half][q] = r.live[half]
                       ? *reinterpret_cast<const uint2*>(src + r.o[half] +
                                                         8 * q)
                       : make_uint2(0u, 0u);
  }
}

// The CMux add of one tile: dst = src + sum_p 256^(p+drop) * d.  Accumulator
// chunk j = qP + p holds plane p of coefficients 8q + 2 (lane % 4) + {0, 1}.
// src and dst may be one buffer: a tile reads and writes only its own
// elements.
template <int P>
static __device__ __forceinline__ void epilogue_store(
    const int (&d)[32 * P], const uint2 (&v)[2][8], uint32_t* dst,
    const TileRows& r, int drop) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!r.live[half]) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t w[2] = {v[half][q].x, v[half][q].y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          w[e] += static_cast<uint32_t>(d[4 * (q * P + p) + 2 * half + e])
                  << (8 * (p + drop));
      }
      *reinterpret_cast<uint2*>(dst + r.o[half] + 8 * q) =
          make_uint2(w[0], w[1]);
    }
  }
}

// Balanced gadget digits of X^rot * acc - acc for the batch rows
// [0, batch), written row-major to the global buffer the A tiles come from:
// dig[row * K + (l * kp1 + j) * n + c], K = lvl * kp1 * n.  An item is four
// consecutive coefficients (one 16-byte load of acc, one 4-byte store per
// level); threads tid, tid + nthr, ... share them, U items at a time with
// every load issued before the first store, and the rotations
// of the next group loaded while this group's are used, so that each group
// waits for one round trip to memory.  Offsets are 32-bit (the wrappers
// keep B (k+1) N lvl below 2^31) and an item's row and column advance by
// addition.

struct DigitCursor {
  unsigned row, k;           // k = j * n + c, a multiple of 4
};

static __device__ __forceinline__ void digit_advance(DigitCursor& at,
                                                     unsigned step_rows,
                                                     unsigned step_k,
                                                     unsigned row_words) {
  at.row += step_rows;
  at.k += step_k;
  if (at.k >= row_words) {
    at.k -= row_words;
    ++at.row;
  }
}

template <int U>
static __device__ __forceinline__ void digit_rows(
    const uint32_t* acc, const int32_t* rot, int8_t* dig, int batch, int kp1,
    int lvl, int n, int base_log, unsigned tid, unsigned nthr) {
  const unsigned two_n = 2 * n;
  const unsigned rows = static_cast<unsigned>(batch);
  const unsigned row_words = kp1 * n;          // uint32 words of a row
  const unsigned kdim = lvl * row_words;       // digit bytes of a row
  const int total = lvl * base_log;
  const uint32_t rounding = total < 32 ? (1u << (31 - total)) : 0u;
  const int top_shift = 32 - total;
  const uint32_t dmask = (1u << base_log) - 1u;
  const uint32_t half = 1u << (base_log - 1);
  const unsigned quads = row_words / 4;
  const unsigned step_rows = nthr / quads, step_k = 4 * (nthr % quads);
  DigitCursor at{tid / quads, 4 * (tid % quads)};
  DigitCursor ahead = at;
  unsigned r_next[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    r_next[u] = ahead.row < rows ? static_cast<unsigned>(rot[ahead.row]) : 0u;
    digit_advance(ahead, step_rows, step_k, row_words);
  }
  while (at.row < rows) {
    unsigned r_cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r_cur[u] = r_next[u];
    uint32_t y[U][4];
    unsigned out[U];                // dig offset, or ~0u
#pragma unroll
    for (int u = 0; u < U; ++u) {
      out[u] = ~0u;
      if (at.row < rows) {
        const unsigned c = at.k & (n - 1);
        const uint32_t* a = acc + at.row * row_words + (at.k - c);
        const unsigned r = r_cur[u] & (two_n - 1);
        const uint4 cur = *reinterpret_cast<const uint4*>(a + c);
        const uint32_t own[4] = {cur.x, cur.y, cur.z, cur.w};
        // X^r a at c .. c+3: a[idx] for idx = (c + e - r) mod 2N below N,
        // -a[idx - N] above; the four positions lie in two aligned quads
        const unsigned i0 = (c - r) & (two_n - 1);
        const unsigned p0 = i0 & (n - 1);
        const unsigned sel = p0 & 3u;
        const uint4 lo = *reinterpret_cast<const uint4*>(a + (p0 & ~3u));
        const uint4 hi =
            *reinterpret_cast<const uint4*>(a + ((p0 + 4u) & (n - 4u)));
        const uint32_t w8[8] = {lo.x, lo.y, lo.z, lo.w,
                                hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t m = sel == 0u   ? w8[e]
                             : sel == 1u ? w8[e + 1]
                             : sel == 2u ? w8[e + 2]
                                         : w8[e + 3];
          const bool neg =
              ((i0 + e) & (two_n - 1)) >= static_cast<unsigned>(n);
          const uint32_t v = neg ? 0u - m : m;
          y[u][e] = (v - own[e] + rounding) >> top_shift;
        }
        out[u] = at.row * kdim + at.k;
      }
      digit_advance(at, step_rows, step_k, row_words);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      r_next[u] = ahead.row < rows ? static_cast<unsigned>(rot[ahead.row])
                                   : 0u;
      digit_advance(ahead, step_rows, step_k, row_words);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (out[u] == ~0u) continue;
      uint32_t carry[4] = {0u, 0u, 0u, 0u};
      for (int l = lvl - 1; l >= 0; --l) {
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t dgt = (y[u][e] & dmask) + carry[e];
          y[u][e] >>= base_log;
          carry[e] = dgt >= half ? 1u : 0u;
          const uint32_t b = carry[e] ? dgt - (1u << base_log) : dgt;
          word |= (b & 0xFFu) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(dig + out[u] + l * row_words) = word;
      }
    }
  }
}

// On-chip Toeplitz expansion of one B tile (cmux_step.cu, ladder_tiles.cu):
// the 64P rows of a column tile (coefficients 64 gq + 8q + w, plane p, row
// (qP + p) * 8 + w) over the 128 K bytes of stage kc, from the tables of
// one output component jp in shared memory.  Table (l, j, p) holds
// [g~[2N-16 .. 2N) | g~[0 .. 2N) | g~[0 .. 16)] at stride hs, so table
// position u holds g~[(u - 16) mod 2N] for u < 2N + 32.  Byte m of
// 16-byte piece i of row (q, p, w) is T[c, r] = g~[(x + w - m) mod 2N],
// x = (64 gq + 8q - c0 - 16i) mod 2N: the ascending run [x + w + 1,
// x + w + 17) of the table, reversed.  So one thread takes piece i of the
// eight rows w = 0..7 of (q, p): one 24-byte window [x + 1, x + 25) of the
// table (seven aligned shared loads, aligned to x + 1 by six funnel
// shifts) gives all eight pieces, each four funnel shifts and four byte
// reversals.  Lanes 8a .. 8a + 7 take the eight pieces of one row, so
// each 16-byte store of a warp fills whole rows of the swizzle without
// bank conflicts.
constexpr int kWrap = 16;

template <int P>
static __device__ __forceinline__ void expand_b_tile(uint8_t* bt,
                                                     const uint8_t* tab,
                                                     int hs, int n, int kc,
                                                     int gq, int pt) {
  const int two_n = 2 * n;
  const int k0 = kc * kChunk;
  const int lj = k0 / n;
  const int c0 = k0 - lj * n;
  const uint8_t* tlj = tab + static_cast<size_t>(lj * P) * hs;
  for (int grp = pt; grp < 64 * P; grp += kWgThreads) {
    const int piece = grp & 7;
    const int qp = grp >> 3;                   // q * P + p
    const int q = qp / P;
    const int p = qp - q * P;
    const int u0 = ((64 * gq + 8 * q - c0 - 16 * piece) & (two_n - 1)) + 1;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(tlj + p * hs) + (u0 >> 2);
    uint32_t raw[7], win[6];
#pragma unroll
    for (int i = 0; i < 7; ++i) raw[i] = src[i];
    const uint32_t sh = (u0 & 3) * 8;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      win[i] = __funnelshift_r(raw[i], raw[i + 1], sh);
    uint8_t* row0 = bt + qp * 8 * kChunk;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int b = w >> 2, s = (w & 3) * 8;
      uint4 v;
      v.x = __byte_perm(__funnelshift_r(win[b + 3], win[b + 4], s), 0, 0x0123);
      v.y = __byte_perm(__funnelshift_r(win[b + 2], win[b + 3], s), 0, 0x0123);
      v.z = __byte_perm(__funnelshift_r(win[b + 1], win[b + 2], s), 0, 0x0123);
      v.w = __byte_perm(__funnelshift_r(win[b], win[b + 1], s), 0, 0x0123);
      *reinterpret_cast<uint4*>(row0 + w * kChunk + ((piece ^ w) << 4)) = v;
    }
  }
}

// Spin until the grid-barrier counter reaches `target`: relaxed loads with
// a short sleep between them, then one acquire fence.
static __device__ __forceinline__ void wait_counter(const unsigned* counter,
                                                    unsigned target) {
  while (true) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(counter)
                 : "memory");
    if (v >= target) break;
    __nanosleep(256);
  }
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Consumer threads only: all 256 meet, one adds the block's arrival to the
// counter and waits until it reaches `target`.
static __device__ __forceinline__ void consumers_grid_barrier(
    unsigned* counter, unsigned target) {
  asm volatile("bar.sync 1, %0;" ::"n"(2 * kWgThreads) : "memory");
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    wait_counter(counter, target);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(2 * kWgThreads) : "memory");
}

// Arguments of a Hopper CMux launch (one kernel parameter).
struct HopperArgs {
  const uint32_t* acc;     // (B, k+1, N) input accumulator
  const int32_t* rots;     // (n_steps, B)
  const int8_t* g;         // key rows (n_steps, lvl, k+1, k+1, P, 2N), kExpand
  size_t g_step;           // bytes from one step's key row to the next
  uint32_t* out;           // (B, k+1, N), distinct from acc
  int8_t* dig;             // (ceil(B / 128) * 128, lvl * (k+1) * N)
  unsigned* counter;       // zeroed grid-barrier counter
  int batch, kp1, lvl, n, base_log, drop, n_steps, stages;
};

static __host__ __device__ __forceinline__ size_t table_bytes(int lvl,
                                                              int kp1,
                                                              int planes,
                                                              int n) {
  return static_cast<size_t>(lvl) * kp1 * planes * (2 * n + 2 * kWrap);
}

// Where a block's t-th tile lies: row tile rt and column tile ct
// (jp * N/64 + coefficient block).  Row tiles fastest, so that consecutive
// tiles share one column tile's weights, or column tiles fastest
// (kColumnsFastest), so that they share one row tile's digits.
template <bool kColumnsFastest>
static __device__ __forceinline__ void tile_at(int t, int row_tiles,
                                               int col_tiles, int& rt,
                                               int& ct) {
  if (kColumnsFastest) {
    rt = t / col_tiles;
    ct = t - rt * col_tiles;
  } else {
    ct = t / row_tiles;
    rt = t - ct * row_tiles;
  }
}

// The TMA coordinates (K byte, row) of stage kc's B tile for column tile ct
// = (jp, gq) of step s.  A row of K5's per-step slabs
// (build_all_step_kslabs) holds the whole contraction: the box is at
// (128 kc, the tile's rows in step s).  A row of K2/K3's diagonal slabs
// (build_diag_kslabs, kDiagSlabs) holds one 128-wide coefficient block of
// each (l, j): stage kc is lj = (l, j) = 128 kc / N at input block
// cb = (128 kc mod N) / 128, and the tile lies in output block-row
// rb = gq / 2, half h = gq % 2, on diagonal di = rb - cb + N/128 - 1, whose
// rows (jp, h) start at ((di (k+1) + jp) 2 + h) 64P.
template <int P, bool kDiagSlabs>
static __device__ __forceinline__ int2 b_box(int s, int kc, int ct, int n,
                                             int kp1) {
  if (kDiagSlabs) {
    const int k0 = kc * kChunk;
    const int lj = k0 / n;
    const int cb = (k0 - lj * n) / kChunk;
    const int jp = ct / (n / 64);
    const int gq = ct - jp * (n / 64);
    const int di = gq / 2 - cb + n / kChunk - 1;
    return make_int2(lj * kChunk, ((di * kp1 + jp) * 2 + gq % 2) * 64 * P);
  }
  return make_int2(kc * kChunk, s * kp1 * P * n + ct * 64 * P);
}

// The body of every CMux kernel, one persistent cooperative grid: for
// every step s, (1) all warps of all blocks write the digits of every row
// to h.dig, and each block arrives at a grid barrier; (2) each block walks
// a contiguous range of the tiles (128 rows x 64P columns, in the order of
// tile_at): the producer warpgroup fills the ring -- the A tile by TMA once
// the barrier is complete, the B tile by TMA from a K-major slab form
// (kExpand = false: K5's per-step slabs, or K2/K3's diagonal slabs with
// kDiagSlabs, b_box) or expanded on chip from the tables of a key row
// (kExpand = true) -- and the two consumer warpgroups run wgmma and the
// CMux add; (3) a second grid barrier before the next step reads the
// accumulator.  Step 0 reads h.acc, later steps update h.out in place.
// The roles stay on separate paths for the whole kernel, as setmaxnreg
// needs; they meet only at mbarriers, named barriers and the counter.
//
// The expansion's tables are those of one output component jp of a key
// row.  cmux_step.cu (kStepKeys = false) runs one step on the one row h.g
// and reloads them when jp changes.  ladder_tiles.cu (kStepKeys = true)
// reads step s's row at h.g + s * h.g_step, reloads them when the step or
// jp changes, and issues the next step's first ones as soon as its last
// expansion of the step is done.  The step key is a template argument so
// that cmux_step.cu keeps the registers of a single row.  The B form and
// the tile order are template arguments for the same reason.
template <int P, bool kExpand, bool kStepKeys = false,
          bool kDiagSlabs = false, bool kColumnsFastest = false>
static __device__ __forceinline__ void cmux_hopper_body(
    unsigned char* smem_raw, const CUtensorMap* map_a,
    const CUtensorMap* map_b, const HopperArgs& h) {
  static_assert(kExpand || !kStepKeys, "step keys are expanded on chip");
  static_assert(!kExpand || !kDiagSlabs, "diagonal slabs are read by TMA");
  static_assert(!kExpand || !kColumnsFastest,
                "the expansion reloads its tables whenever jp changes");
  const int n = h.n;
  const int kp1 = h.kp1;
  const int hs = 2 * n + 2 * kWrap;
  const uint32_t sb = stage_bytes(P);
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tab = ring + h.stages * sb;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      tab + (kExpand ? (table_bytes(h.lvl, kp1, P, n) + 15) & ~size_t(15)
                     : 0));
  uint64_t* empty = full + kMaxStages;
  uint64_t* tab_bar = empty + kMaxStages;
  const int nk = h.lvl * kp1 * n / kChunk;
  const int row_tiles = (h.batch + kTileM - 1) / kTileM;
  const int col_tiles = kp1 * (n / 64);
  const int tiles = row_tiles * col_tiles;
  const unsigned nb = gridDim.x;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles /
                                  nb);
  const int t1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * tiles / nb);
  if (threadIdx.x == 0) {
    for (int i = 0; i < h.stages; ++i) {
      mbar_init(&full[i], kExpand ? kWgThreads : 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(tab_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (h.n_steps == 0) {
    const size_t total = static_cast<size_t>(h.batch) * kp1 * n;
    for (size_t i = blockIdx.x * kHopperThreads + threadIdx.x; i < total;
         i += static_cast<size_t>(nb) * kHopperThreads)
      h.out[i] = h.acc[i];
    return;
  }
  if (threadIdx.x >= 2 * kWgThreads) {
    // Producer warpgroup.  The registers setmaxnreg hands out stay within
    // the block's launch allocation, 168 x 384: 128 x 88 + 256 x 208 when
    // the producer expands B, 128 x 56 + 256 x 224 when it only issues TMA
    // loads (and, like every warp, its share of the digit phase).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kExpand ? 88
                                                                    : 56));
    const int pt = threadIdx.x - 2 * kWgThreads;
    const int ntab = h.lvl * kp1 * P;
    const int two_n = 2 * n;
    int stage = 0;
    uint32_t phase = 0, tab_phase = 0;
    int cur_s = -1, cur_jp = -1;
    bool tables_pending = false;
    // Issue the bulk copies of the tables of step s's key row for output
    // component jp once every producer thread is done reading the previous
    // ones.
    auto load_tables = [&](int s, int jp) {
      if (cur_jp >= 0)
        asm volatile("bar.sync 2, %0;" ::"n"(kWgThreads) : "memory");
      if (pt == 0) {
        fence_async_shared();
        mbar_expect_tx(tab_bar, static_cast<uint32_t>(ntab) * hs);
        const int8_t* key = kStepKeys ? h.g + s * h.g_step : h.g;
        for (int i = 0; i < ntab; ++i) {
          const int lj = i / P, p = i - lj * P;
          const int8_t* src =
              key + (static_cast<size_t>(lj * kp1 + jp) * P + p) * two_n;
          uint8_t* dst = tab + static_cast<size_t>(i) * hs;
          bulk_load(dst, src + two_n - kWrap, kWrap, tab_bar);
          bulk_load(dst + kWrap, src, two_n, tab_bar);
          bulk_load(dst + kWrap + two_n, src, kWrap, tab_bar);
        }
      }
      cur_s = s;
      cur_jp = jp;
      tables_pending = true;
    };
    const int first_jp = t0 / row_tiles / (n / 64);
    // The first tables' copies overlap the digit phase.
    if (kExpand && t0 < t1) load_tables(0, first_jp);
    for (int s = 0; s < h.n_steps; ++s) {
      // This warpgroup's share of the digit phase, once the previous
      // step's accumulator is complete everywhere.
      if (s > 0) wait_counter(h.counter, 2u * s * nb);
      digit_rows<4>(s ? h.out : h.acc,
                    h.rots + static_cast<size_t>(s) * h.batch, h.dig,
                    h.batch, kp1, h.lvl, n, h.base_log,
                    blockIdx.x * kHopperThreads + threadIdx.x,
                    nb * kHopperThreads);
      fence_async_global();
      asm volatile("bar.arrive 3, %0;" ::"n"(kHopperThreads) : "memory");
      bool a_ready = false;
      for (int t = t0; t < t1; ++t) {
        int rt, ct;
        tile_at<kColumnsFastest>(t, row_tiles, col_tiles, rt, ct);
        const int jp = ct / (n / 64);
        const int gq = ct - jp * (n / 64);
        if (kExpand && (jp != cur_jp || (kStepKeys && s != cur_s)))
          load_tables(s, jp);
        if (kExpand && tables_pending) {
          mbar_wait(tab_bar, tab_phase);
          tab_phase ^= 1u;
          tables_pending = false;
        }
        for (int kc = 0; kc < nk; ++kc) {
          if (!kExpand && pt != 0) break;
          mbar_wait(&empty[stage], phase ^ 1u);
          uint8_t* st = ring + stage * sb;
          if (kExpand) {
            expand_b_tile<P>(st + kATileBytes, tab, hs, n, kc, gq, pt);
            fence_async_shared();
          }
          if (pt == 0) {
            if (!a_ready) {
              wait_counter(h.counter, (2u * s + 1u) * nb);
              fence_async_global();
              a_ready = true;
            }
            if (kExpand) {
              mbar_expect_tx_only(&full[stage], kATileBytes);
            } else {
              const int2 at = b_box<P, kDiagSlabs>(s, kc, ct, n, kp1);
              mbar_expect_tx(&full[stage], sb);
              tma_load(st + kATileBytes, map_b, &full[stage], at.x, at.y);
            }
            tma_load(st, map_a, &full[stage], kc * kChunk, rt * kTileM);
          }
          if (kExpand) mbar_arrive(&full[stage]);
          if (++stage == h.stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
      // The next step's first tables, as soon as this step's expansions
      // are done; they do not depend on the accumulator.
      if (kStepKeys && s + 1 < h.n_steps && t0 < t1)
        load_tables(s + 1, first_jp);
    }
  } else {
    // Two consumer warpgroups.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kExpand ? 208
                                                                    : 224));
    const int wg = threadIdx.x / kWgThreads;
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < h.n_steps; ++s) {
      const uint32_t* src = s ? h.out : h.acc;
      digit_rows<8>(src, h.rots + static_cast<size_t>(s) * h.batch, h.dig,
                    h.batch, kp1, h.lvl, n, h.base_log,
                    blockIdx.x * kHopperThreads + threadIdx.x,
                    nb * kHopperThreads);
      fence_async_global();
      // The block's digits, the producer's share included, are written:
      // arrive at the grid barrier.
      asm volatile("bar.sync 3, %0;" ::"n"(kHopperThreads) : "memory");
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(h.counter, 1u);
      }
      for (int t = t0; t < t1; ++t) {
        int rt, ct;
        tile_at<kColumnsFastest>(t, row_tiles, col_tiles, rt, ct);
        const int jp = ct / (n / 64);
        const TileRows rows = tile_rows(rt * kTileM + wg * 64, h.batch, kp1,
                                        n, jp, (ct - jp * (n / 64)) * 64);
        uint2 prev[2][8];
        epilogue_load(prev, src, rows);
        int d[32 * P];
        consume_tile<P>(d, ring, full, empty, h.stages, nk, stage, phase);
        epilogue_store<P>(d, prev, h.out, rows, h.drop);
      }
      if (s + 1 < h.n_steps)
        consumers_grid_barrier(h.counter, (2u * s + 2u) * nb);
    }
  }
}

// Shared memory of a Hopper CMux kernel: the ring (1024-byte aligned, as
// the swizzle needs), then `extra` bytes, then the barriers.
static __host__ __device__ __forceinline__ size_t hopper_smem_bytes(
    int planes, int stages, size_t extra) {
  return 1024 + static_cast<size_t>(stages) * stage_bytes(planes) +
         ((extra + 15) & ~size_t(15)) + (2 * kMaxStages + 1) * 8;
}

// Host side: a 2-D uint8 tensor map over a row-major (rows, cols) buffer,
// boxes of 128 bytes x box_rows in the 128-byte swizzle, encoded through
// the driver entry point so no library beyond the runtime is linked.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline cudaError_t make_tile_map(CUtensorMap* map, const void* base,
                                        unsigned long long rows,
                                        unsigned long long cols,
                                        int box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  if (reinterpret_cast<uintptr_t>(base) % 16 || cols % 16)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Largest ring (at most kMaxStages, at least 2 stages) whose shared memory
// fits beside `extra` bytes on the current device; 0 if none.
static inline cudaError_t pick_stages(int planes, size_t extra, int* stages,
                                      size_t* smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  for (*stages = kMaxStages; *stages >= 2; --*stages) {
    *smem = hopper_smem_bytes(planes, *stages, extra);
    if (*smem <= static_cast<size_t>(max_smem)) return cudaSuccess;
  }
  *stages = 0;
  return cudaErrorInvalidValue;
}

// Launch `fn`, a kernel that runs cmux_hopper_body with `extra` bytes of
// shared memory beside the ring, as a persistent cooperative grid: every
// block must be resident for the grid barriers, so the grid is the smaller
// of the tile count and what the device holds at once.
static inline cudaError_t launch_hopper(const void* fn, int planes,
                                        size_t extra,
                                        const CUtensorMap& map_a,
                                        const CUtensorMap& map_b,
                                        HopperArgs& h, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = pick_stages(planes, extra, &h.stages, &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kHopperThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int tiles = (h.batch + kTileM - 1) / kTileM * h.kp1 * (h.n / 64);
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {const_cast<CUtensorMap*>(&map_a),
                  const_cast<CUtensorMap*>(&map_b), &h};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kHopperThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

static inline bool hopper_shape_ok(int batch, int kp1, int lvl, int planes,
                                   int n, int base_log, int drop) {
  return batch > 0 && kp1 >= 1 && lvl >= 1 && n >= kChunk &&
         n % kChunk == 0 && !(n & (n - 1)) && planes >= 1 && drop >= 0 &&
         planes + drop <= kMaxPlanes && base_log >= 1 && base_log <= 8;
}

}  // namespace nfa
