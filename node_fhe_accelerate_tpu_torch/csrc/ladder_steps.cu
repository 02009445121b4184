// The whole TFHE blind-rotate ladder in one launch, steps outer, against
// the K-major slab form of the bootstrap key, on Hopper (sm_90a): for every
// step s, in order,
//
//   acc <- acc + sum_p 256^(p+drop) *
//                (digits(X^rot[s] * acc - acc) x W[s])
//
// Replaces: node_fhe_accelerate_tpu/ops/pallas_cmux.py
// `_fused_steps_kernel` (entry `blind_rotate_fused_steps`, the "mxu_fused"
// backend), whose grid is (step,) with the full-batch accumulator and the
// digits resident in VMEM and each step's slab streamed once.
//
// Weights: ops/cmux.py `build_all_step_kslabs`, int8
// (n_steps, (k+1) * P * N, lvl * (k+1) * N): per step one row per output
// column, ordered (jp, coefficient block of 64, q, p, w) with coefficient
// 64 * block + 8q + w, and the contraction index (l, j, c) contiguous.
// wgmma takes 8-bit operands only K-major, and the reference's rt-major
// slabs keep the column axis contiguous, so the form is built once per key
// (prepare_bsk) instead of transposing bytes in registers on every read.
//
// Bound at TFHE_BOOT_128_K4, batch 4096, 630 steps: one step is the int8
// GEMM 4096 x 2560 x 5120 (5.37e10 MACs, 54.3 us at 1,979 dense int8 TOPS);
// the ladder is 34.2 ms of operations against 2.5 ms of bytes (8.26 GB of
// weights at 3.35 TB/s): bound by operations.
//
// Design (cmux_common.cuh cmux_hopper_body<P, false>).  A persistent
// cooperative grid (one block per SM) runs, per step:
//
// 1. the digit phase: all warps of every block write the balanced digits
//    of a share of the rows into a global buffer dig (B x 2560 bytes at
//    K4, 10.5 MB: it stays in the 50 MB L2 with acc and the step's 13.1 MB
//    of weights); then a grid barrier;
// 2. the GEMM: tiles of 128 rows x 64P columns (256 at P = 4), a
//    contiguous range of them per block.  A producer thread keeps TMA
//    loads of the A (digits) and B (weights) tiles in flight in a ring of
//    4 stages of 128 K bytes under full/empty mbarriers; two consumer
//    warpgroups run wgmma m64n256k32 s8 on them, 64 rows each, with the
//    128 x 32-bit accumulator in registers (setmaxnreg moves registers
//    from the producer to them), and recombine the planes into acc in
//    place; then a grid barrier.
//
// The barriers are a monotonic counter in device memory (the wrapper zeroes
// it): the cooperative launch keeps every block resident, and the producer
// and consumer roles meet it on separate paths, as setmaxnreg needs.  A
// 128-row A tile is read 20 times per step (once per column tile) and a B
// tile 32 times (once per row tile), ~630 MB of L2 reads a step against
// the 1.68 GB of the mma.sync form, which read the whole step slab per
// 32-row tile.  Clusters with multicast B loads would halve B's share;
// this first wgmma form leaves them out to keep the launch a plain
// cooperative one.
//
// Step 0 reads the input acc and writes out; later steps update out in
// place (acc and out are distinct buffers).  Rows past the batch in the
// last row tile read digits the buffer holds (its rows are padded to 128)
// and are never stored.

#include "cmux_common.cuh"

namespace {

using namespace nfa;

template <int P>
__global__ void __launch_bounds__(kHopperThreads, 1)
ladder_steps_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const HopperArgs h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cmux_hopper_body<P, false>(smem_raw, &map_a, &map_b, h);
}

}  // namespace

// Launch the ladder on `stream`.  acc/out: uint32 bits (B, k+1, N),
// distinct buffers; rots: int32 (n_steps, B); kslabs: int8
// (n_steps, (k+1)*P*N, lvl*(k+1)*N), 16-byte aligned; dig: int8 scratch of
// (ceil(B/128)*128, lvl*(k+1)*N); counter: one zeroed uint32.  Plane p
// weighs 256^(p+drop).  The caller has checked shapes and the int32 bound.
// Returns a cudaError_t.
extern "C" int nfa_ladder_steps(const void* acc, const void* rots,
                                const void* kslabs, void* out, void* dig,
                                void* counter, int batch, int kp1, int lvl,
                                int planes, int n, int base_log, int drop,
                                int n_steps, void* stream) {
  if (!hopper_shape_ok(batch, kp1, lvl, planes, n, base_log, drop) ||
      n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long kdim =
      static_cast<unsigned long long>(lvl) * kp1 * n;
  const unsigned long long rows = (batch + kTileM - 1) / kTileM * kTileM;
  alignas(64) CUtensorMap map_a, map_b;
  cudaError_t err = make_tile_map(&map_a, dig, rows, kdim, kTileM);
  if (err != cudaSuccess) return static_cast<int>(err);
  map_b = map_a;            // n_steps == 0 only copies acc
  if (n_steps > 0) {
    const unsigned long long wrows =
        static_cast<unsigned long long>(n_steps) * kp1 * planes * n;
    err = make_tile_map(&map_b, kslabs, wrows, kdim, 64 * planes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  HopperArgs h{static_cast<const uint32_t*>(acc),
               static_cast<const int32_t*>(rots), nullptr, 0,
               static_cast<uint32_t*>(out), static_cast<int8_t*>(dig),
               static_cast<unsigned*>(counter), batch, kp1, lvl, n,
               base_log, drop, n_steps, 0};
  const void* kernels[] = {
      reinterpret_cast<const void*>(ladder_steps_kernel<1>),
      reinterpret_cast<const void*>(ladder_steps_kernel<2>),
      reinterpret_cast<const void*>(ladder_steps_kernel<3>),
      reinterpret_cast<const void*>(ladder_steps_kernel<4>)};
  return static_cast<int>(launch_hopper(kernels[planes - 1], planes, 0,
                                        map_a, map_b, h,
                                        static_cast<cudaStream_t>(stream)));
}
