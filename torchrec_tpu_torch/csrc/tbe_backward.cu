// Fused embedding backward + rowwise-Adagrad update for Hopper (sm_90a),
// bound to Python with ctypes through a plain C interface
// (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at first use).
//
//   fused_rowwise_adagrad   replaces torchrec_tpu/ops/pallas_tbe_backward.py
//                           ::pallas_fused_sparse_update with
//                           optim="rowwise_adagrad" (kernel body _bwd_body,
//                           input preparation _sort_by_row, noise _hash_bits)
//
// Input: slots sorted by table row (stable), invalid slots last with the
// sentinel row R.  For each distinct row r it computes
//
//   g      = sum_i w_i * grad_seg[seg_i, :]      (slot order, f32)
//   g      = g + wd * table[r, :]                (only when wd != 0)
//   m_new  = momentum[r] + mean(g * g)
//   table[r, :] = table[r, :] + (-lr / (sqrt(m_new) + eps)) * g
//   momentum[r] = m_new
//
// in place, with the write-back to a bfloat16 table stochastically rounded
// when a seed is given (the murmur-style hash of (seed, row, column) of
// _hash_bits, pallas_tbe_backward.py:103-118, bit for bit; non-finite values
// pass through and round to nearest).  Other optimizers are not ported.
//
// What bounds it on an H100: bytes.  Per valid slot it reads one f32
// gradient row (D * 4 bytes) plus 12 bytes of row, segment and weight; per
// distinct row it reads and writes the table row and the momentum.  About
// 4 flops per byte at most, far below the card's f32 ridge.  The design
// touches each gradient row once and each table row once, with coalesced
// 16-byte loads where D allows.
//
// Design.  The TPU kernel walks the row-sorted slots on a SEQUENTIAL grid
// and keeps the open run's accumulator in VMEM across grid steps, flushing
// it when the row changes (pallas_tbe_backward.py:36-47).  Blocks on Hopper
// run concurrently, so each row run has exactly one owner: the grid runs one
// warp per sorted position, and the warp whose position starts a run (the
// first position, or one whose row differs from its predecessor's) walks the
// run to its end; every other warp exits at once.  No atomics, no unique
// pass, no host sync.  The accumulator stays in registers: each lane owns
// the columns {b*128 + 4*lane + e} (D % 4 == 0, float4 loads) or
// {lane + 32*k}, at most 16 per lane (D <= 512).
//
// Rounding: every product and sum is a separately rounded __fmul_rn /
// __fadd_rn, in slot order.  mean(g * g) has one fixed order: each lane sums
// the squares of its own columns in ascending column order, then the warp
// adds the 32 partial sums in an xor butterfly (offsets 16, 8, 4, 2, 1),
// then divides by D (__fdiv_rn).  The plain PyTorch version
// (torchrec_tpu_torch/ops/tbe_backward.py::fused_sparse_update_plain)
// repeats this arithmetic in the same order, so on the card kernel and plain
// version are bitwise equal.  Row addresses are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "backward_common.cuh"

namespace {

using namespace bwd;

template <typename T, bool VEC>
__global__ void fused_rowwise_adagrad_kernel(
    const int32_t* __restrict__ srows, const int32_t* __restrict__ ssegs,
    const float* __restrict__ sw, const float* __restrict__ grad,
    T* __restrict__ table, float* __restrict__ momentum, int V, int R, int D,
    float lr, float eps, float wd, int use_sr, uint32_t seed) {
  const int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= V) return;
  const int row = srows[i];
  // invalid slots carry the sentinel R and sort last; a run has one owner,
  // the warp at its first position (the whole warp leaves together)
  if (row >= R || (i > 0 && srows[i - 1] == row)) return;
  const int n = VEC ? ((D + 127) / 128) * 4 : (D + 31) / 32;
  // read before any lane can write it back (lane 0 does, at the end)
  const float m_old = momentum[row];

  float g[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) g[k] = 0.f;
  for (int64_t j = i; j < V && srows[j] == row; ++j) {
    const float* gr = grad + (int64_t)ssegs[j] * D;
    const float wj = sw[j];
    if constexpr (VEC) {
#pragma unroll
      for (int b = 0; b < kMaxCols / 4; ++b) {
        const int c = b * 128 + lane * 4;
        if (b * 4 < n && c < D) {
          const float4 v = *reinterpret_cast<const float4*>(gr + c);
          g[4 * b + 0] = __fadd_rn(g[4 * b + 0], __fmul_rn(v.x, wj));
          g[4 * b + 1] = __fadd_rn(g[4 * b + 1], __fmul_rn(v.y, wj));
          g[4 * b + 2] = __fadd_rn(g[4 * b + 2], __fmul_rn(v.z, wj));
          g[4 * b + 3] = __fadd_rn(g[4 * b + 3], __fmul_rn(v.w, wj));
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        const int c = column<false>(lane, k, D);
        if (k < n && c >= 0) g[k] = __fadd_rn(g[k], __fmul_rn(gr[c], wj));
      }
    }
  }

  T* wrow = table + (int64_t)row * D;
  float w[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = column<VEC>(lane, k, D);
    w[k] = (k < n && c >= 0) ? widen(wrow[c]) : 0.f;
  }
  if (wd != 0.f) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int c = column<VEC>(lane, k, D);
      if (k < n && c >= 0) g[k] = __fadd_rn(g[k], __fmul_rn(wd, w[k]));
    }
  }

  // mean(g * g): lane partials in ascending column order, xor butterfly
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = column<VEC>(lane, k, D);
    if (k < n && c >= 0) s = __fadd_rn(s, __fmul_rn(g[k], g[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  }
  const float m_new = __fadd_rn(m_old, __fdiv_rn(s, (float)D));
  const float scale = __fdiv_rn(-lr, __fadd_rn(__fsqrt_rn(m_new), eps));

#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = column<VEC>(lane, k, D);
    if (k < n && c >= 0) {
      store(wrow + c, __fadd_rn(w[k], __fmul_rn(scale, g[k])), use_sr != 0,
            seed, (uint32_t)row, (uint32_t)c);
    }
  }
  if (lane == 0) momentum[row] = m_new;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
void launch(const void* srows, const void* ssegs, const void* sw,
            const void* grad, void* table, void* momentum, int V, int R,
            int D, float lr, float eps, float wd, int use_sr, int seed,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((V + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const int32_t* r = (const int32_t*)srows;
  const int32_t* s = (const int32_t*)ssegs;
  const float* w = (const float*)sw;
  const float* g = (const float*)grad;
  T* t = (T*)table;
  float* m = (float*)momentum;
  const uint32_t sd = (uint32_t)seed;
  if (D % 4 == 0 && aligned16(grad)) {
    fused_rowwise_adagrad_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        r, s, w, g, t, m, V, R, D, lr, eps, wd, use_sr, sd);
  } else {
    fused_rowwise_adagrad_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        r, s, w, g, t, m, V, R, D, lr, eps, wd, use_sr, sd);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).  `dtype` is 0 for a float32 and 1 for a bfloat16 table; the
// momentum is float32 [R].  `use_sr` turns on stochastic rounding of a
// bfloat16 write-back with `seed`.  Pointers are device pointers; the Python
// wrapper has checked devices, dtypes, shapes, contiguity, V > 0 and
// D <= 512.
int fused_rowwise_adagrad(const void* srows, const void* ssegs,
                          const void* sw, const void* grad, void* table,
                          void* momentum, int V, int R, int D, float lr,
                          float eps, float wd, int dtype, int use_sr,
                          int seed, void* stream) {
  if (D > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  if (V > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
      case 0:
        launch<float>(srows, ssegs, sw, grad, table, momentum, V, R, D, lr,
                      eps, wd, 0, seed, st);
        break;
      case 1:
        launch<__nv_bfloat16>(srows, ssegs, sw, grad, table, momentum, V, R,
                              D, lr, eps, wd, use_sr, seed, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
