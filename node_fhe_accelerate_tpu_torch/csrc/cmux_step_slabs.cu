// One TFHE blind-rotate CMux step against prepared diagonal slabs, on
// Hopper (sm_90a), in two loop orders.
//
//   out = acc + sum_p 256^p * (digits(X^rot * acc - acc) x Toeplitz(g~_p))
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py `_cmux_kernel_v3`
// (entry `cmux_step_pallas(variant="v3")`) and `_cmux_kernel` ("v2", any
// other variant name).  Both TPU bodies read the weights of
// `build_diag_slabs`: int8 (D = 2nt-1, lvl*(k+1)*128, (k+1)*P*128), slab
// di = rt - ct + nt - 1 holding the 128 x 128 Toeplitz block on diagonal
// rt - ct for every (l, j) row block and (jp, p) column block.  Here they
// are two instantiations of one kernel:
//
// * v3, digit-stationary: a digit fragment (16 rows x 32 of the 128-wide
//   chunk (l, j, ct)) is loaded once and swept over two block-rows rt, whose
//   accumulators are both live (the TPU keeps all nt live in VMEM; the
//   register file holds two);
// * v2, output-stationary: one block-row rt per task, the whole contraction
//   K = lvl*(k+1)*128 per ct run against it, and a weight fragment serves
//   two 16-row tiles.
//
// Integer sums do not depend on their order, so both equal cmux_step.cu bit
// for bit.
//
// Bound at TFHE_BOOT_128_K4, batch 4096: the same 5.37e10 int8 MACs as
// cmux_step.cu (54.3 us at 1,979 TOPS); acc in and out plus the 9.8 MB of
// slabs are 52 MB, 15.5 us at 3.35 TB/s: bound by operations.  What this
// first form pays instead is cache traffic: every 32-row tile streams all
// slabs from L2 (128 tiles x 9.8 MB per step), where cmux_step.cu keeps its
// 102 KB of tables in shared memory.  The weights are read in the layout of
// the reference, column axis contiguous, and byte-transposed in registers
// (cmux_common.cuh, slab_mma_phase).

#include "cmux_common.cuh"

namespace {

using namespace nfa;

constexpr int kTileRows = 32;

template <bool kDigitStationary>
__global__ void __launch_bounds__(kThreads)
cmux_step_slabs_kernel(const uint32_t* __restrict__ acc,
                       const int32_t* __restrict__ rot,
                       const int8_t* __restrict__ slabs,
                       uint32_t* __restrict__ out, int batch, int kp1,
                       int lvl, int planes, int n, int base_log) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = static_cast<int>(digit_row_bytes(lvl, kp1, n));
  int8_t* dig = reinterpret_cast<int8_t*>(smem);   // [kTileRows][rs]
  const int b0 = blockIdx.x * kTileRows;
  digit_phase(acc, rot, dig, rs, b0, kTileRows, batch, kp1, lvl, n, base_log);
  __syncthreads();
  if (kDigitStationary) {
    slab_mma_phase<1, 2>(dig, rs, slabs, acc, out, b0, kTileRows, batch, kp1,
                         lvl, planes, n, 0);
  } else {
    slab_mma_phase<2, 1>(dig, rs, slabs, acc, out, b0, kTileRows, batch, kp1,
                         lvl, planes, n, 0);
  }
}

template <bool kDigitStationary>
int launch(const void* acc, const void* rot, const void* slabs, void* out,
           int batch, int kp1, int lvl, int planes, int n, int base_log,
           void* stream) {
  if (!shape_ok(batch, kp1, lvl, planes, n, base_log) || n % kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int cands[] = {kTileRows, 0};
  int bt = 0;
  size_t smem = 0;
  cudaError_t err =
      pick_batch_tile(0, digit_row_bytes(lvl, kp1, n), cands, &bt, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = cmux_step_slabs_kernel<kDigitStationary>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + bt - 1) / bt;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(rot),
      static_cast<const int8_t*>(slabs), static_cast<uint32_t*>(out), batch,
      kp1, lvl, planes, n, base_log);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one CMux step on `stream`.  acc/out: uint32 bits (B, k+1, N);
// rot: int32 (B,); slabs: int8 (2N/128 - 1, lvl*(k+1)*128, (k+1)*P*128).
// digit_stationary != 0 selects the v3 loop order, 0 the v2 one.  The
// caller has checked shapes and the int32 bound.  Returns a cudaError_t.
extern "C" int nfa_cmux_step_slabs(const void* acc, const void* rot,
                                   const void* slabs, void* out, int batch,
                                   int kp1, int lvl, int planes, int n,
                                   int base_log, int digit_stationary,
                                   void* stream) {
  return digit_stationary
             ? launch<true>(acc, rot, slabs, out, batch, kp1, lvl, planes, n,
                            base_log, stream)
             : launch<false>(acc, rot, slabs, out, batch, kp1, lvl, planes, n,
                             base_log, stream);
}
