// Fused embedding backward + optimizer for Hopper (sm_90a), all eight fused
// optimizers, bound to Python with ctypes through a plain C interface
// (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at first use).
//
//   fused_update   replaces torchrec_tpu/ops/pallas_tbe_backward.py
//                  ::pallas_fused_sparse_update (kernel body _bwd_body,
//                  input preparation _sort_by_row, noise _hash_bits)
//
// Input: slots sorted by table row (stable), invalid slots last with the
// sentinel row R.  For each distinct row r, in place:
//
//   g = sum_i w_i * grad_seg[seg_i, :]      (slot order, f32; mul, then add)
//   g = g + wd * table[r, :]                (only when wd != 0)
//
// then one step of the optimizer on the row and its states, in _bwd_body's
// own op order (pallas_tbe_backward.py:229-291), which is not the XLA
// path's that B6 keeps: backward_common.cuh::update_row with PER_ID = true
// lists every optimizer's math.  Where the two orders differ: rowwise
// Adagrad scales g by (-lr) / (sqrt(m) + eps), and the Adam family's
// (1 - b) is 1.f - b rounded in f32 inside the kernel (B6 takes a host
// double).  The Adam family's bias corrections bc1 = 1 - b1^t and
// bc2 = 1 - b2^t for the caller's incremented step t come from the host.
// A bfloat16 table is written back with stochastic rounding when a seed is
// given (the murmur-style hash of (seed, row, column) of _hash_bits,
// pallas_tbe_backward.py:103-118, bit for bit; non-finite values pass
// through and round to nearest), for every optimizer.
//
// What bounds it on an H100: bytes.  Per valid slot it reads one f32
// gradient row (D * 4 bytes) plus 12 bytes of row, segment and weight; per
// distinct row it reads and writes the table row and the optimizer state
// (0, 4, D * 4, D * 4 + 4 or 2 * D * 4 bytes).  A handful of flops per
// byte, far below the card's f32 ridge.  The design touches each gradient
// row once and each table and state row once, with coalesced 16-byte
// gradient loads where D allows.
//
// Design.  The TPU kernel walks the row-sorted slots on a SEQUENTIAL grid
// and keeps the open run's accumulator in VMEM across grid steps, flushing
// it when the row changes (pallas_tbe_backward.py:36-47).  Blocks on Hopper
// run concurrently, so each row run has exactly one owner warp, which sums
// it and updates its row: no float atomics, no unique pass, no host sync.
// The kernel is backward_common.cuh::fused_update_kernel with PER_ID = true;
// that header documents the grid and the walk.  In short: a persistent grid
// of the blocks resident on the card claims 32-position windows of the
// sorted stream from an integer work queue and stops at the sentinel, so
// the padding slots (92% of the table-wise layout's on the MLPerf DLRM-v2
// path) cost no warp; the owner of a run fetches its slots' metadata 32 at
// a time and keeps kDepth gradient rows in flight, adding them in slot
// order, so a long run (a tiny table's, or a Zipf-hot row's) waits about
// L / kDepth round trips.  The accumulator, the row and its states stay in
// registers: each lane owns the columns {b*128 + 4*lane + e} (D % 4 == 0,
// float4 loads) or {lane + 32*k}; 4 columns a lane for D <= 128 (D % 4 ==
// 0), at most 16 otherwise (D <= 512).  The optimizer is a template
// argument: 8 optimizers x {f32, bf16} tables x the three column layouts
// are 48 instantiations with an f32 state, and the six optimizers with a
// state x {f32, bf16} tables x {bf16, f16} states x the three layouts 72
// more (backward_common.cuh: the state's element type).
//
// Rounding: every product and sum is a separately rounded __fmul_rn /
// __fadd_rn, every sqrt and division __fsqrt_rn / __fdiv_rn.  Every mean and
// norm over D has one fixed order: each lane sums the squares of its own
// columns in ascending column order, then the warp adds the 32 partial sums
// in an xor butterfly (offsets 16, 8, 4, 2, 1); a mean divides that by D.
// The plain PyTorch version (torchrec_tpu_torch/ops/tbe_backward.py
// ::fused_sparse_update_plain) repeats this arithmetic in the same order, so
// on the card kernel and plain version are bitwise equal.  Built without
// fast math.  Row and state addresses are 64-bit.

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
int fused_update(const void* srows, const void* ssegs, const void* sw,
                 const void* grad, void* table, void* state0, void* state1,
                 void* queue, int V, int R, int D, int optim, float lr,
                 float eps, float wd, float b1, float b2, float bc1,
                 float bc2, int dtype, int sdtype, int use_sr, int seed,
                 void* stream) {
  const Slots sl{(const int32_t*)srows, (const int32_t*)ssegs,
                 (const float*)sw, (const float*)grad, V, R, D};
  const Hyper h{lr, eps, wd, b1, b2, 0.f, 0.f, bc1, bc2};
  return launch<true>(sl, table, state0, state1, (unsigned*)queue, optim,
                      dtype, sdtype, h, use_sr, seed,
                      (cudaStream_t)stream);
}

// What a launch for (optim, dtype, sdtype, D) over V sorted positions
// takes, in out[4]: registers a thread, blocks, resident blocks per SM, layout (0
// narrow, 1 wide, 2 scalar).  Returns 0 or a CUDA error code.
int fused_update_info(int optim, int dtype, int sdtype, int D, int V,
                      int* out) {
  return kernel_info<true>(optim, dtype, sdtype, D, V, out);
}

}  // extern "C"
