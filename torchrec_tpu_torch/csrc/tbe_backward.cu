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
// run concurrently, so each row run has exactly one owner: the grid runs one
// warp per sorted position, and the warp whose position starts a run (the
// first position, or one whose row differs from its predecessor's) walks the
// run to its end; every other warp exits at once.  No atomics, no unique
// pass, no host sync.  The accumulator, the row and its states stay in
// registers: each lane owns the columns {b*128 + 4*lane + e} (D % 4 == 0,
// float4 loads) or {lane + 32*k}, at most 16 per lane (D <= 512).  The
// optimizer is a template argument: 8 optimizers x {f32, bf16} x the two
// column layouts are 32 instantiations.
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

namespace {

using namespace bwd;

template <typename T, bool VEC, int OPT>
__global__ void fused_update_kernel(
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

  float g[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) g[k] = 0.f;
  for (int64_t j = i; j < V && srows[j] == row; ++j) {
    add_slot<VEC>(g, grad + (int64_t)ssegs[j] * D, sw[j], lane, n, D);
  }
  update_row<T, VEC, OPT, true>(g, row, lane, n, D, table, s0, s1, h,
                                use_sr != 0, seed);
}

// the instantiation for an optimizer code, or null for an unknown code
template <typename T, bool VEC>
const void* kernel_for(int optim) {
  switch (optim) {
    case kSgd: return (const void*)fused_update_kernel<T, VEC, kSgd>;
    case kLarsSgd: return (const void*)fused_update_kernel<T, VEC, kLarsSgd>;
    case kAdagrad: return (const void*)fused_update_kernel<T, VEC, kAdagrad>;
    case kRowwiseAdagrad:
      return (const void*)fused_update_kernel<T, VEC, kRowwiseAdagrad>;
    case kAdam: return (const void*)fused_update_kernel<T, VEC, kAdam>;
    case kPartialRowwiseAdam:
      return (const void*)fused_update_kernel<T, VEC, kPartialRowwiseAdam>;
    case kLamb: return (const void*)fused_update_kernel<T, VEC, kLamb>;
    case kPartialRowwiseLamb:
      return (const void*)fused_update_kernel<T, VEC, kPartialRowwiseLamb>;
    default: return nullptr;
  }
}

// dtype 0 = float32, 1 = bfloat16 table; vec: the float4 column layout
const void* kernel_for(int optim, int dtype, bool vec) {
  if (dtype == 0) {
    return vec ? kernel_for<float, true>(optim)
               : kernel_for<float, false>(optim);
  }
  if (dtype == 1) {
    return vec ? kernel_for<__nv_bfloat16, true>(optim)
               : kernel_for<__nv_bfloat16, false>(optim);
  }
  return nullptr;
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
int fused_update(const void* srows, const void* ssegs, const void* sw,
                 const void* grad, void* table, void* state0, void* state1,
                 int V, int R, int D, int optim, float lr, float eps,
                 float wd, float b1, float b2, float bc1, float bc2,
                 int dtype, int use_sr, int seed, void* stream) {
  if (D > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(optim, dtype, D % 4 == 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (V > 0) {
    Hyper h{lr, eps, wd, b1, b2, 0.f, 0.f, bc1, bc2};
    int sr = dtype == 1 ? use_sr : 0;
    uint32_t sd = (uint32_t)seed;
    void* args[] = {(void*)&srows, (void*)&ssegs, (void*)&sw, (void*)&grad,
                    &table, &state0, &state1, &V, &R, &D, &h, &sr, &sd};
    const dim3 grid((unsigned)((V + kWarpsPerBlock - 1) / kWarpsPerBlock));
    const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(kThreads), args,
                                             0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The registers a thread of the instantiation for (optim, dtype, column
// layout) uses, or minus the CUDA error code.
int fused_update_num_regs(int optim, int dtype, int vec) {
  const void* fn = kernel_for(optim, dtype, vec != 0);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  return err == cudaSuccess ? attr.numRegs : -(int)err;
}

}  // extern "C"
