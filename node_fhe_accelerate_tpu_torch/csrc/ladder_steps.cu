// The whole TFHE blind-rotate ladder in one launch, steps outer, against
// prepared rt-major slabs, on Hopper (sm_90a): for every step s, in order,
//
//   acc <- acc + sum_p 256^(p+drop) *
//                (digits(X^rot[s] * acc - acc) x W[s])
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py
// `_fused_steps_kernel` (entry `blind_rotate_fused_steps`, the "mxu_fused"
// backend), whose grid is (step,) with the full-batch accumulator and the
// digits resident in VMEM and each step's slab streamed once.
//
// The weights are the output of `build_all_step_slabs`: int8
// (n_steps, nt, lvl*(k+1)*N, (k+1)*P*128), slab rt of step s holding the
// Toeplitz block-row rt with the diagonal resolved at build time, so the
// contraction index is a digit row's own index (l, j, c in [0, N)).
//
// What does not carry over is the residency: an SM has 227 KB of shared
// memory, not the TPU's many megabytes.  What makes it easy instead is that
// batch rows never interact.  The kernel is persistent: every block runs
// `for step: for each of my batch tiles`, which already is the steps-outer
// order; the accumulator lives in the output buffer in device memory and is
// updated in place (21 MB at TFHE_BOOT_128_K4, batch 4096: it stays in the
// 50 MB L2), and only the digits of one tile are in shared memory.  The
// launch is cooperative and the blocks meet at one grid-wide barrier per
// step.  The barrier is not needed for a right answer; it keeps the blocks
// on the same step, so that a step's slab (13.1 MB at K4) comes from HBM
// once and from L2 for the other blocks.  The grid is sized from the
// occupancy the device reports, and a block loops over tiles when there are
// more tiles than resident blocks.
//
// Bound at K4, batch 4096, 630 steps: 630 x 5.37e10 int8 MACs = 34.2 ms at
// 1,979 TOPS; the slabs are 8.26 GB, which with acc and the rotations is
// 2.48 ms at 3.35 TB/s: bound by operations.  What sets this first form's
// pace is neither: every 32-row tile reads the whole step slab from L2
// (128 tiles x 13.1 MB = 1.68 GB per step).  Larger row tiles per weight
// fragment, or clusters with multicast loads, are later work.

#include <cooperative_groups.h>

#include "cmux_common.cuh"

namespace {

using namespace nfa;
namespace cg = cooperative_groups;

constexpr int kTileRows = 32;

__global__ void __launch_bounds__(kThreads)
ladder_steps_kernel(const uint32_t* __restrict__ acc,
                    const int32_t* __restrict__ rots,
                    const int8_t* __restrict__ slabs, uint32_t* out,
                    int batch, int kp1, int lvl, int planes, int n,
                    int base_log, int drop, int n_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rs = static_cast<int>(digit_row_bytes(lvl, kp1, n));
  int8_t* dig = reinterpret_cast<int8_t*>(smem);   // [kTileRows][rs]
  const int tiles = (batch + kTileRows - 1) / kTileRows;
  const size_t step_bytes = static_cast<size_t>(n / kBlock) * lvl * kp1 * n *
                            kp1 * planes * kBlock;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * kTileRows;
    const int rows = min(kTileRows, batch - b0);
    const size_t base = static_cast<size_t>(b0) * kp1 * n;
    for (int i = threadIdx.x; i < rows * kp1 * n; i += kThreads)
      out[base + i] = acc[base + i];
  }
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b0 = tile * kTileRows;
      digit_phase(out, rots + static_cast<size_t>(s) * batch, dig, rs, b0,
                  kTileRows, batch, kp1, lvl, n, base_log);
      __syncthreads();
      slab_mma_phase<2, 1, true>(dig, rs, slabs + s * step_bytes, out, out,
                                 b0, kTileRows, batch, kp1, lvl, planes, n,
                                 drop);
      __syncthreads();
    }
    grid.sync();
  }
}

}  // namespace

// Launch the ladder on `stream`.  acc/out: uint32 bits (B, k+1, N), distinct
// buffers; rots: int32 (n_steps, B); slabs: int8
// (n_steps, N/128, lvl*(k+1)*N, (k+1)*P*128); plane p weighs 256^(p+drop).
// The caller has checked shapes and the int32 bound.  Returns a cudaError_t.
extern "C" int nfa_ladder_steps(const void* acc, const void* rots,
                                const void* slabs, void* out, int batch,
                                int kp1, int lvl, int planes, int n,
                                int base_log, int drop, int n_steps,
                                void* stream) {
  if (!shape_ok(batch, kp1, lvl, planes, n, base_log) || n % kBlock ||
      n_steps < 0 || drop < 0 || planes + drop > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int cands[] = {kTileRows, 0};
  int bt = 0;
  size_t smem = 0;
  cudaError_t err =
      pick_batch_tile(0, digit_row_bytes(lvl, kp1, n), cands, &bt, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ladder_steps_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ladder_steps_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // Every block of a cooperative grid must be resident at once.
  const int tiles = (batch + bt - 1) / bt;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  const uint32_t* acc_p = static_cast<const uint32_t*>(acc);
  const int32_t* rots_p = static_cast<const int32_t*>(rots);
  const int8_t* slabs_p = static_cast<const int8_t*>(slabs);
  uint32_t* out_p = static_cast<uint32_t*>(out);
  void* args[] = {&acc_p, &rots_p, &slabs_p, &out_p, &batch, &kp1,
                  &lvl,   &planes, &n,       &base_log, &drop, &n_steps};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ladder_steps_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
