// The whole TFHE blind-rotate ladder in one launch, batch tile outer, on
// Hopper (sm_90a): for every step s, in order,
//
//   acc <- acc + sum_p 256^p * (digits(X^rot[s] * acc - acc) x T(g~[s]_p))
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py
// `_fused_rotate_kernel` (entry `blind_rotate_fused`, the "pallas_fused"
// backend), whose grid is (batch tile, step, column chunk) with the
// accumulator in VMEM scratch per tile: batch rows never interact, so a
// tile of rows runs its whole ladder without waiting for any other tile.
//
// Weights: the bootstrap key's int8 rows as stored, (n_steps, lvl, k+1,
// k+1, P, 2N), 64.5 MB at TFHE_BOOT_128_K4.  No per-key form is needed (the
// steps-outer ladder_steps.cu reads 8.26 GB of K-major slabs).
//
// Bound at K4, batch 4096, 630 steps: 630 x 5.37e10 int8 MACs = 34.2 ms at
// 1,979 TOPS; acc in and out, the rotations and the key rows are 117 MB,
// 35 us at 3.35 TB/s: bound by operations.  Per stage of 128 K bytes a
// block's tensor cores need ~1,024 clocks and its shared memory moves
// ~950 clocks' worth (the on-chip expansion of B beside the wgmma reads,
// as in cmux_step.cu), so tensor cores and shared memory bound it
// together; the digit phase, the epilogue and the barriers of each step
// come on top.
//
// Design (cmux_common.cuh cmux_hopper_body<P, true, true>: K1's core with a
// step loop and a key row per step).  One persistent cooperative grid, one
// block per SM, as K1 and K5:
//
// * per step, all warps of all blocks write the digits of every row to a
//   global row-major buffer (it stays in L2) and arrive at a grid barrier
//   (a counter the wrapper zeroes); each block's producer expands its first
//   B tile, then waits there before its first TMA load of A;
// * each block walks a contiguous range of the tiles of 128 rows x 64P
//   columns (row tile fastest: 640 at K4, batch 4096, 4.85 a block), so it
//   expands B from the tables of two or three output components jp a step.
//   The tables are keyed on (step, jp): the producer reloads them (bulk
//   copies of 21.8 KB at K4 from the step's key row, which every block
//   reads through L2) when either changes, and issues the next step's first
//   ones as soon as its last expansion of the step is done;
// * a second grid barrier closes the step: the next step's digits read
//   accumulator rows that other blocks wrote.
//
// The TPU's "batch tile outer" (a tile of rows runs its whole ladder
// without waiting for another) has a faithful Hopper form: thread-block
// clusters that own their row tiles for every step and meet only at
// barrier.cluster.  It was built and measured (PERF.md): its barriers cost
// nothing measurable, but a cluster must own whole 128-row tiles, and an
// H100 SXM holds 39 clusters of 3 and 30 of 4, so batch 4096's 32 row
// tiles ran as 96 blocks with 7 tiles on the busiest, ~20% slower a step
// than this grid's 4.85 a block.  Splitting every step's tiles over all
// SMs keeps small batches spread too: a batch of 256 rows (40 tiles) runs
// on 40 blocks.
//
// Shared memory at K4: 4 stages of 48 KB and one set of tables (21.8 KB),
// 219 KB of the 227 KB.  A second set, so that a reload never waits on its
// copies, leaves room for 3 stages only, and the lost stage costs more
// than the reloads (PERF.md).
//
// Exactness as cmux_step.cu.  The wrapper keeps B (k+1) N lvl below 2^31
// bytes per launch (ops/cmux.py batch_chunks): the digit offsets are
// 32-bit.

#include "cmux_common.cuh"

namespace {

using namespace nfa;

template <int P>
__global__ void __launch_bounds__(kHopperThreads, 1)
ladder_tiles_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const HopperArgs h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cmux_hopper_body<P, true, true>(smem_raw, &map_a, &map_b, h);
}

}  // namespace

// Launch the ladder on `stream`.  acc/out: uint32 bits (B, k+1, N),
// distinct buffers; rots: int32 (n_steps, B); g: int8
// (n_steps, lvl, k+1, k+1, P, 2N), 16-byte aligned; dig: int8 scratch of
// (ceil(B/128)*128, lvl*(k+1)*N); counter: one zeroed uint32.  The caller
// has checked shapes and the int32 bound.  Returns a cudaError_t.
extern "C" int nfa_ladder_tiles(const void* acc, const void* rots,
                                const void* g, void* out, void* dig,
                                void* counter, int batch, int kp1, int lvl,
                                int planes, int n, int base_log, int n_steps,
                                void* stream) {
  if (!hopper_shape_ok(batch, kp1, lvl, planes, n, base_log, 0) ||
      n_steps < 0 || reinterpret_cast<uintptr_t>(g) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long kdim =
      static_cast<unsigned long long>(lvl) * kp1 * n;
  const unsigned long long rows = (batch + kTileM - 1) / kTileM * kTileM;
  alignas(64) CUtensorMap map_a;
  cudaError_t err = make_tile_map(&map_a, dig, rows, kdim, kTileM);
  if (err != cudaSuccess) return static_cast<int>(err);
  HopperArgs h{static_cast<const uint32_t*>(acc),
               static_cast<const int32_t*>(rots),
               static_cast<const int8_t*>(g),
               static_cast<size_t>(kdim) * kp1 * planes * 2,
               static_cast<uint32_t*>(out), static_cast<int8_t*>(dig),
               static_cast<unsigned*>(counter), batch, kp1, lvl, n,
               base_log, 0, n_steps, 0};
  const void* kernels[] = {
      reinterpret_cast<const void*>(ladder_tiles_kernel<1>),
      reinterpret_cast<const void*>(ladder_tiles_kernel<2>),
      reinterpret_cast<const void*>(ladder_tiles_kernel<3>),
      reinterpret_cast<const void*>(ladder_tiles_kernel<4>)};
  return static_cast<int>(launch_hopper(
      kernels[planes - 1], planes, table_bytes(lvl, kp1, planes, n), map_a,
      map_a, h, static_cast<cudaStream_t>(stream)));
}
