// One TFHE blind-rotate CMux step against prepared diagonal slabs, on
// Hopper (sm_90a), in two tile orders.
//
//   out = acc + sum_p 256^p * (digits(X^rot * acc - acc) x Toeplitz(g~_p))
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py `_cmux_kernel_v3`
// (entry `cmux_step_pallas(variant="v3")`) and `_cmux_kernel` ("v2", any
// other variant name).  Both TPU bodies read the weights of
// `build_diag_slabs`: int8 (D = 2nt-1, lvl*(k+1)*128, (k+1)*P*128), slab
// di = rt - ct + nt - 1 holding the 128 x 128 Toeplitz block on diagonal
// rt - ct for every (l, j) row block and (jp, p) column block, with the
// column axis contiguous.
//
// Weights: ops/cmux.py `build_diag_kslabs`, the same bytes K-major, int8
// (D, (k+1)*P*128, lvl*(k+1)*128): per diagonal one row per output column
// of a 128-wide block-row, ordered (jp, h, q, p, w) for coefficient
// 64h + 8q + w, and the contraction index (l, j, c), c < 128, contiguous.
// wgmma reads 8-bit B only K-major, so the form is built once, as K5's
// (ladder_steps.cu), instead of transposing bytes in registers on every
// read.
//
// Bound at TFHE_BOOT_128_K4, batch 4096: the same 5.37e10 int8 MACs as
// cmux_step.cu (54.3 us at 1,979 TOPS); acc in and out plus the 9.8 MB of
// slabs are 52 MB, 15.5 us at 3.35 TB/s: bound by operations.
//
// Design (cmux_common.cuh cmux_hopper_body<P, false, false, true, order>,
// one step): K5's core with the B box taken from the diagonal form
// (b_box): stage kc of the contraction is one (l, j) at one input
// coefficient block cb, and a 64-coefficient column tile in output
// block-row rb reads diagonal rb - cb + nt - 1.  The 9.8 MB of the form
// stay in the 50 MB L2 beside the digits (10.5 MB) and acc, read once from
// device memory per launch.  On the TPU the variants differ in what stays
// in VMEM; on Hopper a tile's accumulators live in registers either way,
// so they become the order in which a block walks its tiles:
//
// * v3, digit-stationary: column tiles fastest, so that consecutive tiles
//   reuse one row tile's digits;
// * v2, output-stationary: row tiles fastest, as K1 and K5 walk them, so
//   that consecutive tiles reuse one column tile's weights.
//
// Integer sums do not depend on their order, so both equal cmux_step.cu bit
// for bit.

#include "cmux_common.cuh"

namespace {

using namespace nfa;

template <int P, bool kDigitStationary>
__global__ void __launch_bounds__(kHopperThreads, 1)
cmux_step_slabs_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const HopperArgs h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cmux_hopper_body<P, false, false, true, kDigitStationary>(smem_raw, &map_a,
                                                            &map_b, h);
}

}  // namespace

// Launch one CMux step on `stream`.  acc/out: uint32 bits (B, k+1, N),
// distinct buffers; rot: int32 (B,); kslabs: int8
// (2N/128 - 1, (k+1)*P*128, lvl*(k+1)*128), 16-byte aligned; dig: int8
// scratch of (ceil(B/128)*128, lvl*(k+1)*N); counter: one zeroed uint32.
// digit_stationary != 0 selects the v3 tile order, 0 the v2 one.  The
// caller has checked shapes and the int32 bound.  Returns a cudaError_t.
extern "C" int nfa_cmux_step_slabs(const void* acc, const void* rot,
                                   const void* kslabs, void* out, void* dig,
                                   void* counter, int batch, int kp1,
                                   int lvl, int planes, int n, int base_log,
                                   int digit_stationary, void* stream) {
  if (!hopper_shape_ok(batch, kp1, lvl, planes, n, base_log, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long kdim =
      static_cast<unsigned long long>(lvl) * kp1 * n;
  const unsigned long long rows = (batch + kTileM - 1) / kTileM * kTileM;
  alignas(64) CUtensorMap map_a, map_b;
  cudaError_t err = make_tile_map(&map_a, dig, rows, kdim, kTileM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long diags = 2 * (n / kChunk) - 1;
  err = make_tile_map(&map_b, kslabs, diags * kp1 * planes * kChunk,
                      static_cast<unsigned long long>(lvl) * kp1 * kChunk,
                      64 * planes);
  if (err != cudaSuccess) return static_cast<int>(err);
  HopperArgs h{static_cast<const uint32_t*>(acc),
               static_cast<const int32_t*>(rot), nullptr, 0,
               static_cast<uint32_t*>(out), static_cast<int8_t*>(dig),
               static_cast<unsigned*>(counter), batch, kp1, lvl, n,
               base_log, 0, 1, 0};
  const void* kernels[2][4] = {
      {reinterpret_cast<const void*>(cmux_step_slabs_kernel<1, false>),
       reinterpret_cast<const void*>(cmux_step_slabs_kernel<2, false>),
       reinterpret_cast<const void*>(cmux_step_slabs_kernel<3, false>),
       reinterpret_cast<const void*>(cmux_step_slabs_kernel<4, false>)},
      {reinterpret_cast<const void*>(cmux_step_slabs_kernel<1, true>),
       reinterpret_cast<const void*>(cmux_step_slabs_kernel<2, true>),
       reinterpret_cast<const void*>(cmux_step_slabs_kernel<3, true>),
       reinterpret_cast<const void*>(cmux_step_slabs_kernel<4, true>)}};
  return static_cast<int>(launch_hopper(
      kernels[digit_stationary != 0][planes - 1], planes, 0, map_a, map_b, h,
      static_cast<cudaStream_t>(stream)));
}
