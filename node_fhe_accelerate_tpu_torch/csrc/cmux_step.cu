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
// is bound by operations.
//
// Design (cmux_common.cuh cmux_hopper_body<P, true>: the core K5 runs,
// with the B operand made on chip).  The weights are the bootstrap key's
// row as stored, (lvl, k+1, k+1, P, 2N) int8 (102 KB at K4): the Toeplitz
// matrix T[c, r] = g~[(r - c) mod 2N] is expanded in shared memory, never
// in device memory (the reference's diagonal tiles are 6.2 GB at K4).  One
// persistent cooperative grid, one block per SM:
//
// * all warps of all blocks write the balanced digits of every row to a
//   global row-major buffer (2,560 bytes a row at K4: 128 rows do
//   not fit in shared memory beside the ring, the buffer stays in L2), then
//   arrive at a grid barrier; the digits are computed once, not once per
//   block that needs them;
// * each block walks a contiguous range of the tiles of 128 rows x 64
//   coefficients x P planes of one output component jp.  Its producer
//   warpgroup loads jp's tables, lvl * (k+1) * P runs of 2N bytes with
//   16 bytes of wrap on either side (21.8 KB at K4), by bulk asynchronous
//   copies under an mbarrier, and reloads them only when jp changes: one
//   jp at a time is what lets a 4-stage ring of 48 KB stages fit beside
//   them (all five would take 109 KB).  Per stage of 128 K bytes it
//   expands the K-major B tile into the 128-byte swizzle: a row of the
//   tile is a descending run of a table, and the rows of eight
//   consecutive coefficients are the same run shifted by a byte, so one
//   thread reads one 24-byte window (seven aligned shared loads) and
//   writes eight 16-byte pieces (funnel shifts and byte reversals in
//   registers); once the barrier is complete, TMA loads the A tile of
//   digits.  The two consumer warpgroups run wgmma m64n256k32 s8 on the
//   stage, 64 rows each, and recombine the planes in registers.
//
// What bounds it: per stage the tensor cores need ~1,024 clocks for
// 128 x 256 x 128 MACs; shared memory moves ~120 KB (the wgmma reads of B
// twice and of A once, the expansion's 32 KB of stores and ~7 KB of loads)
// at 128 bytes a clock, ~950 clocks.  So the expansion, which replaces 13
// MB of weights per step streamed from memory, fits under the tensor
// cores' time; the measured step (PERF.md) is paced by the digit phase
// and the epilogue around the tiles.
//
// Exactness: digits |d| <= 2^(base_log-1) and planes |g| <= 128, so each
// int32 sum is at most terms * 2^(base_log-1) * 128 < 2^31 -- the wrapper
// refuses shapes outside that bound.  Recombination and the CMux add wrap
// in uint32 as the reference does.

#include "cmux_common.cuh"

namespace {

using namespace nfa;

template <int P>
__global__ void __launch_bounds__(kHopperThreads, 1)
cmux_step_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const HopperArgs h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cmux_hopper_body<P, true>(smem_raw, &map_a, &map_b, h);
}

}  // namespace

// Launch one CMux step on `stream`.  acc/out: uint32 bits (B, k+1, N);
// rot: int32 (B,); g: int8 (lvl, k+1, k+1, P, 2N), 16-byte aligned; dig:
// int8 scratch of (ceil(B/128)*128, lvl*(k+1)*N); counter: one zeroed
// uint32.  The caller has checked shapes and the int32 bound.  Returns a
// cudaError_t (0 on success).
extern "C" int nfa_cmux_step(const void* acc, const void* rot, const void* g,
                             void* out, void* dig, void* counter, int batch,
                             int kp1, int lvl, int planes, int n,
                             int base_log, void* stream) {
  if (!hopper_shape_ok(batch, kp1, lvl, planes, n, base_log, 0) ||
      reinterpret_cast<uintptr_t>(g) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long kdim =
      static_cast<unsigned long long>(lvl) * kp1 * n;
  const unsigned long long rows = (batch + kTileM - 1) / kTileM * kTileM;
  alignas(64) CUtensorMap map_a;
  cudaError_t err = make_tile_map(&map_a, dig, rows, kdim, kTileM);
  if (err != cudaSuccess) return static_cast<int>(err);
  HopperArgs h{static_cast<const uint32_t*>(acc),
               static_cast<const int32_t*>(rot),
               static_cast<const int8_t*>(g), 0, static_cast<uint32_t*>(out),
               static_cast<int8_t*>(dig), static_cast<unsigned*>(counter),
               batch, kp1, lvl, n, base_log, 0, 1, 0};
  const void* kernels[] = {
      reinterpret_cast<const void*>(cmux_step_kernel<1>),
      reinterpret_cast<const void*>(cmux_step_kernel<2>),
      reinterpret_cast<const void*>(cmux_step_kernel<3>),
      reinterpret_cast<const void*>(cmux_step_kernel<4>)};
  return static_cast<int>(launch_hopper(
      kernels[planes - 1], planes, table_bytes(lvl, kp1, planes, n), map_a,
      map_a, h, static_cast<cudaStream_t>(stream)));
}
