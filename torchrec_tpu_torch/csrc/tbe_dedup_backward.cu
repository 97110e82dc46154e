// Ragged dedup fused embedding backward + optimizer for Hopper (sm_90a), all
// eight fused optimizers, bound to Python with ctypes through a plain C
// interface (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at
// first use).
//
//   dedup_fused_update   replaces torchrec_tpu/ops/pallas_tbe_backward.py
//                        ::pallas_dedup_fused_sparse_update
//                        (pallas_fused_sparse_update(dedup=True), kernel body
//                        _dedup_bwd_body, input preparation _sort_by_row)
//
// Input: slots sorted by table row (stable), invalid slots last with the
// sentinel row R.  For each distinct row r, in place:
//
//   g = sum_i grad_seg[seg_i, :] * w_i   (sorted order; mul, then add)
//   g = g + wd * table[r, :]            (only when wd != 0; mul, then add)
//
// then the optimizer, in the op order of the JAX package's XLA path
// (ops/fused_update.py::apply_sparse_update), which _dedup_bwd_body replays
// (pallas_tbe_backward.py:589-757): backward_common.cuh::update_row with
// PER_ID = false, which lists every optimizer's math.  Every product and
// sum is a separately rounded __fmul_rn / __fadd_rn, and every sqrt and
// division __fsqrt_rn / __fdiv_rn.
//
// (1 - b) is rounded on the host from a double, and bc1 = 1 - b1^t,
// bc2 = 1 - b2^t for the caller's step t are computed once on the host
// (pallas_tbe_backward.py:1042-1047).  A bfloat16 table is written back
// with the stochastic rounding of backward_common.cuh when a seed is given.
//
// What bounds it on an H100: bytes.  Each kept slot's gradient row is read
// once (D * 4 bytes) with 12 bytes of row, segment and weight; each distinct
// row reads and writes its table row and its optimizer state (0, 4, D * 4,
// D * 4 + 4 or 2 * D * 4 bytes).  A handful of flops per byte, far below
// the card's f32 ridge.  The design reads each gradient row once and each
// table and state row once, and writes each once.
//
// Design.  The TPU kernel walks the row-sorted slots on a SEQUENTIAL grid and
// keeps the open row's accumulator in VMEM across grid steps.  Blocks on
// Hopper run concurrently, so each row run has exactly one owner warp, as in
// B2 (tbe_backward.cu): both are backward_common.cuh::fused_update_kernel,
// here with PER_ID = false, and that header documents the grid and the walk.
// A persistent grid of the blocks resident on the card claims 32-position
// windows of the sorted stream from an integer work queue; the warp owns
// the runs that start in its window, finds each run's end with a ballot,
// fetches its slots' metadata 32 at a time and keeps kDepth gradient rows
// in flight, adding them in slot order: a Zipf-hot row's run of L slots
// waits about L / kDepth round trips, and other warps take the windows
// behind it meanwhile.  No float atomics, no unique pass, no host sync.
// The accumulator and the row's table and state values stay in registers:
// each lane owns the columns of backward_common.cuh's column<VEC>, 4 for
// D <= 128 (D % 4 == 0), at most 16 otherwise (D <= 512).
//
// Reductions: every mean and norm over D has one fixed order, B2's: each lane
// sums the squares of its own columns in ascending column order, then the
// warp adds the 32 partial sums in an xor butterfly (16, 8, 4, 2, 1); a mean
// divides that by D, a norm takes its square root.  The plain PyTorch
// version (torchrec_tpu_torch/ops/tbe_backward.py
// ::dedup_fused_sparse_update_plain) repeats all of this in the same order,
// so on the card kernel and plain version are bitwise equal.  Built without
// fast math.  Row addresses are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "backward_common.cuh"

using namespace bwd;

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).  `optim` is the code of the Optim enum; `state0` / `state1` are
// the optimizer's state arrays (momentum, or m and v; unused ones may be
// null), each of element type `sdtype` (0 float32, 1 bfloat16, 2 float16;
// 16-bit only for the six optimizers with a state): [R] for a rowwise
// state, [R, D] otherwise.  `queue` is the work
// queue, two uint32 that are 0 (the kernel leaves them at 0).  `dtype` is 0
// for a float32 and 1 for a bfloat16 table; `use_sr` turns on stochastic
// rounding of a bfloat16 write-back with `seed`.  Pointers are device
// pointers; the Python wrapper has checked devices, dtypes, shapes,
// contiguity, V > 0, D <= 512 and the gradient's 16-byte alignment.
int dedup_fused_update(const void* srows, const void* ssegs, const void* sw,
                       const void* grad, void* table, void* state0,
                       void* state1, void* queue, int V, int R, int D,
                       int optim, float lr, float eps, float wd, float b1,
                       float b2, float omb1, float omb2, float bc1, float bc2,
                       int dtype, int sdtype, int use_sr, int seed,
                       void* stream) {
  const Slots sl{(const int32_t*)srows, (const int32_t*)ssegs,
                 (const float*)sw, (const float*)grad, V, R, D};
  const Hyper h{lr, eps, wd, b1, b2, omb1, omb2, bc1, bc2};
  return launch<false>(sl, table, state0, state1, (unsigned*)queue, optim,
                       dtype, sdtype, h, use_sr, seed,
                      (cudaStream_t)stream);
}

// What a launch for (optim, dtype, sdtype, D) over V sorted positions
// takes, in out[4]: registers a thread, blocks, resident blocks per SM, layout (0
// narrow, 1 wide, 2 scalar).  Returns 0 or a CUDA error code.
int dedup_fused_update_info(int optim, int dtype, int sdtype, int D, int V,
                      int* out) {
  return kernel_info<false>(optim, dtype, sdtype, D, V, out);
}

}  // extern "C"
