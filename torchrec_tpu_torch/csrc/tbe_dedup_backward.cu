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
// Hopper run concurrently, so each row run has exactly one owner, as in B2
// (tbe_backward.cu): the grid runs one warp per sorted position, and the warp
// at a run's first position (row < R and row != the previous position's)
// finds the run's end with a warp ballot, walks it and writes the row; every
// other warp exits at once.  No atomics, no unique pass, no host sync.  The
// accumulator and the row's table and state values stay in registers: each
// lane owns the columns of backward_common.cuh's column<VEC>, at most 16
// (D <= 512).  A Zipf-hot row is walked by one warp, one slot after another.
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

namespace {

using namespace bwd;

template <typename T, bool VEC, int OPT>
__global__ void dedup_fused_update_kernel(
    const int32_t* __restrict__ srows, const int32_t* __restrict__ ssegs,
    const float* __restrict__ sw, const float* __restrict__ grad,
    T* __restrict__ table, float* __restrict__ s0, float* __restrict__ s1,
    int V, int R, int D, Hyper h, int use_sr, uint32_t seed) {
  const int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= V) return;
  const int row = srows[i];
  // invalid slots carry the sentinel R and sort last; a run has one owner,
  // the warp at its first position (the whole warp leaves together)
  if (row >= R || (i > 0 && srows[i - 1] == row)) return;
  const int n = VEC ? ((D + 127) / 128) * 4 : (D + 31) / 32;

  // the run's end: the first position whose row differs (rows are sorted,
  // so the positions equal to `row` form a prefix of each 32-wide window)
  int64_t end = V;
  for (int64_t base = i + 1; base < V; base += 32) {
    const int64_t j = base + lane;
    const unsigned same = __ballot_sync(kFull, j < V && srows[j] == row);
    if (same != kFull) {
      end = base + (__ffs(~same) - 1);
      break;
    }
  }

  float g[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) g[k] = 0.f;
#pragma unroll 2
  for (int64_t j = i; j < end; ++j) {
    add_slot<VEC>(g, grad + (int64_t)ssegs[j] * D, sw[j], lane, n, D);
  }
  update_row<T, VEC, OPT, false>(g, row, lane, n, D, table, s0, s1, h,
                                 use_sr != 0, seed);
}

template <typename T, bool VEC>
int launch_opt(int optim, const dim3 grid, cudaStream_t st,
               const int32_t* r, const int32_t* s, const float* w,
               const float* g, T* t, float* s0, float* s1, int V, int R,
               int D, Hyper h, int use_sr, uint32_t seed) {
#define TRTPU_LAUNCH(OPT)                                                  \
  dedup_fused_update_kernel<T, VEC, OPT><<<grid, kThreads, 0, st>>>(      \
      r, s, w, g, t, s0, s1, V, R, D, h, use_sr, seed)
  switch (optim) {
    case kSgd: TRTPU_LAUNCH(kSgd); break;
    case kLarsSgd: TRTPU_LAUNCH(kLarsSgd); break;
    case kAdagrad: TRTPU_LAUNCH(kAdagrad); break;
    case kRowwiseAdagrad: TRTPU_LAUNCH(kRowwiseAdagrad); break;
    case kAdam: TRTPU_LAUNCH(kAdam); break;
    case kPartialRowwiseAdam: TRTPU_LAUNCH(kPartialRowwiseAdam); break;
    case kLamb: TRTPU_LAUNCH(kLamb); break;
    case kPartialRowwiseLamb: TRTPU_LAUNCH(kPartialRowwiseLamb); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TRTPU_LAUNCH
  return 0;
}

template <typename T>
int launch(int optim, const void* srows, const void* ssegs, const void* sw,
           const void* grad, void* table, void* s0, void* s1, int V, int R,
           int D, Hyper h, int use_sr, int seed, cudaStream_t st) {
  const dim3 grid((unsigned)((V + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const int32_t* r = (const int32_t*)srows;
  const int32_t* s = (const int32_t*)ssegs;
  const float* w = (const float*)sw;
  const float* g = (const float*)grad;
  if (D % 4 == 0) {  // the wrapper hands a 16-byte aligned gradient
    return launch_opt<T, true>(optim, grid, st, r, s, w, g, (T*)table,
                               (float*)s0, (float*)s1, V, R, D, h, use_sr,
                               (uint32_t)seed);
  }
  return launch_opt<T, false>(optim, grid, st, r, s, w, g, (T*)table,
                              (float*)s0, (float*)s1, V, R, D, h, use_sr,
                              (uint32_t)seed);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).  `optim` is the code of the Optim enum; `state0` / `state1` are
// the optimizer's f32 state arrays (momentum, or m and v; unused ones may be
// null): [R] for a rowwise state, [R, D] otherwise.  `dtype` is 0 for a
// float32 and 1 for a bfloat16 table; `use_sr` turns on stochastic rounding
// of a bfloat16 write-back with `seed`.  Pointers are device pointers; the
// Python wrapper has checked devices, dtypes, shapes, contiguity, V > 0,
// D <= 512 and the gradient's 16-byte alignment.
int dedup_fused_update(const void* srows, const void* ssegs, const void* sw,
                       const void* grad, void* table, void* state0,
                       void* state1, int V, int R, int D, int optim, float lr,
                       float eps, float wd, float b1, float b2, float omb1,
                       float omb2, float bc1, float bc2, int dtype,
                       int use_sr, int seed, void* stream) {
  if (D > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, eps, wd, b1, b2, omb1, omb2, bc1, bc2};
  int err = 0;
  if (V > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
      case 0:
        err = launch<float>(optim, srows, ssegs, sw, grad, table, state0,
                            state1, V, R, D, h, 0, seed, st);
        break;
      case 1:
        err = launch<__nv_bfloat16>(optim, srows, ssegs, sw, grad, table,
                                    state0, state1, V, R, D, h, use_sr, seed,
                                    st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
