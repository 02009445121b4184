// The whole TFHE blind-rotate ladder in one launch, batch tile outer, on
// Hopper (sm_90a): for every step s, in order,
//
//   acc <- acc + sum_p 256^p * (digits(X^rot[s] * acc - acc) x T(g~[s]_p))
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py
// `_fused_rotate_kernel` (entry `blind_rotate_fused`, the "pallas_fused"
// backend), whose grid is (batch tile, step, column chunk) with the
// accumulator in VMEM scratch per tile.
//
// A block owns `bt` batch rows for the whole ladder; batch rows never
// interact, so blocks need no ordering among themselves.  The TPU body
// streams prepared diagonal slabs (made inside its jit, 6.2 GB at
// TFHE_BOOT_128_K4); this kernel does not need them: per step it rebuilds
// the reversed tables of cmux_step.cu in shared memory from the key row as
// stored (102 KB at K4, shared by all blocks through L2) and runs the same
// contraction.
//
// Where the accumulator tile lives: in device memory, in the output buffer,
// updated in place.  A uint32 tile in shared memory beside the tables and
// the digits fits at K4 only for bt = 16 (108,800 + 16 x 2,576 + 16 x 5,120
// = 231,936 of 232,448 bytes) and not at all at k=1, N=1024
// (66,560 + 16 x 4,112 + 16 x 8,192 bytes = 263 KB).  In device memory the
// tile keeps bt at the value cmux_step.cu uses, the whole batch's
// accumulator (21 MB at K4, batch 4096) stays in the 50 MB L2 between
// steps, and it still makes one trip from and to HBM per ladder.  In-place
// is safe: only this block touches its rows, the digit phase (which reads
// rotated positions) is separated from the MMA phase by __syncthreads(),
// and an MMA task reads and writes only its own elements.
//
// Bound at K4, batch 4096, 630 steps: 630 x 5.37e10 int8 MACs = 34.2 ms at
// 1,979 TOPS; acc in and out, the rotations and the 64.5 MB of key rows are
// 117 MB, 35 us at 3.35 TB/s: bound by operations.

#include "cmux_common.cuh"

namespace {

using namespace nfa;

__global__ void __launch_bounds__(kThreads)
ladder_tiles_kernel(const uint32_t* __restrict__ acc,
                    const int32_t* __restrict__ rots,
                    const int8_t* __restrict__ g, uint32_t* out, int batch,
                    int kp1, int lvl, int planes, int n, int base_log,
                    int n_steps, int bt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = static_cast<int>(digit_row_bytes(lvl, kp1, n));
  int8_t* dig = reinterpret_cast<int8_t*>(smem);   // [bt][rs]
  int8_t* tab = dig + bt * rs;                     // [lvl][k+1][k+1][P][hs]
  const int b0 = blockIdx.x * bt;
  const int ntab = lvl * kp1 * kp1 * planes;
  const size_t row_bytes = static_cast<size_t>(ntab) * 2 * n;
  const int rows = min(bt, batch - b0);
  const size_t base = static_cast<size_t>(b0) * kp1 * n;
  for (int i = threadIdx.x; i < rows * kp1 * n; i += kThreads)
    out[base + i] = acc[base + i];
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    build_tables(g + s * row_bytes, tab, ntab, n);
    digit_phase(out, rots + static_cast<size_t>(s) * batch, dig, rs, b0, bt,
                batch, kp1, lvl, n, base_log);
    __syncthreads();
    toeplitz_mma_phase(dig, rs, tab, out, out, b0, bt, batch, kp1, lvl,
                       planes, n);
    __syncthreads();
  }
}

}  // namespace

// Launch the ladder on `stream`.  acc/out: uint32 bits (B, k+1, N), distinct
// buffers; rots: int32 (n_steps, B); g: int8 (n_steps, lvl, k+1, k+1, P, 2N).
// The caller has checked shapes and the int32 bound.  Returns a cudaError_t.
extern "C" int nfa_ladder_tiles(const void* acc, const void* rots,
                                const void* g, void* out, int batch, int kp1,
                                int lvl, int planes, int n, int base_log,
                                int n_steps, void* stream) {
  if (!shape_ok(batch, kp1, lvl, planes, n, base_log) || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table = static_cast<size_t>(lvl) * kp1 * kp1 * planes *
                       (2 * n + kTablePad);
  static const int cands[] = {64, 32, 16, 0};
  int bt = 0;
  size_t smem = 0;
  cudaError_t err = pick_batch_tile(table, digit_row_bytes(lvl, kp1, n),
                                    cands, &bt, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ladder_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + bt - 1) / bt;
  ladder_tiles_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(rots),
      static_cast<const int8_t*>(g), static_cast<uint32_t*>(out), batch, kp1,
      lvl, planes, n, base_log, n_steps, bt);
  return static_cast<int>(cudaGetLastError());
}
