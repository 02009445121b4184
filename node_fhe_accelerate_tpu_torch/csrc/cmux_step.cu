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
// This is the simple first form (legacy mma.sync, one block per SM); wgmma
// and TMA are later work.  The phases live in cmux_common.cuh, shared with
// the whole-ladder kernels (ladder_tiles.cu, ladder_steps.cu).

#include "cmux_common.cuh"

namespace {

using namespace nfa;

__global__ void __launch_bounds__(kThreads)
cmux_step_kernel(const uint32_t* __restrict__ acc,
                 const int32_t* __restrict__ rot,
                 const int8_t* __restrict__ g, uint32_t* __restrict__ out,
                 int batch, int kp1, int lvl, int planes, int n,
                 int base_log, int bt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = static_cast<int>(digit_row_bytes(lvl, kp1, n));
  int8_t* dig = reinterpret_cast<int8_t*>(smem);   // [bt][rs]
  int8_t* tab = dig + bt * rs;                     // [lvl][k+1][k+1][P][hs]
  const int b0 = blockIdx.x * bt;
  build_tables(g, tab, lvl * kp1 * kp1 * planes, n);
  digit_phase(acc, rot, dig, rs, b0, bt, batch, kp1, lvl, n, base_log);
  __syncthreads();
  toeplitz_mma_phase(dig, rs, tab, acc, out, b0, bt, batch, kp1, lvl, planes,
                     n);
}

}  // namespace

// Launch one CMux step on `stream`.  acc/out: uint32 bits (B, k+1, N);
// rot: int32 (B,); g: int8 (lvl, k+1, k+1, P, 2N).  The caller has checked
// shapes and the int32 bound.  Returns a cudaError_t (0 on success).
extern "C" int nfa_cmux_step(const void* acc, const void* rot, const void* g,
                             void* out, int batch, int kp1, int lvl,
                             int planes, int n, int base_log, void* stream) {
  if (!shape_ok(batch, kp1, lvl, planes, n, base_log))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table = static_cast<size_t>(lvl) * kp1 * kp1 * planes *
                       (2 * n + kTablePad);
  static const int cands[] = {64, 32, 16, 0};
  int bt = 0;
  size_t smem = 0;
  cudaError_t err = pick_batch_tile(table, digit_row_bytes(lvl, kp1, n),
                                    cands, &bt, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cmux_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + bt - 1) / bt;
  cmux_step_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(rot),
      static_cast<const int8_t*>(g), static_cast<uint32_t*>(out), batch, kp1,
      lvl, planes, n, base_log, bt);
  return static_cast<int>(cudaGetLastError());
}
