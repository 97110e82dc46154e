// The pooling walk of the float dedup lookup (B4, tbe_dedup.cu): the
// distinct rows have already been gathered and widened once each into an
// f32 scratch [U, D]; this kernel pools them per segment through the
// inverse index, one row at a time.  (The quantized dedup lookup, B5, has
// its own walk with many row loads in flight, in tbe_quant.cu.)
//
// One warp per output segment walks that segment's slots (CSR offsets from
// the wrapper's stable segment sort) and writes out[s, :] once: no atomics,
// and an empty segment writes zeros.  acc = acc + row * w slot by slot, with
// __fmul_rn / __fadd_rn, as the plain PyTorch versions in
// torchrec_tpu_torch/ops/tbe.py do.  For D % 4 == 0 each lane owns 4
// consecutive columns per 128-column block (float4 loads), otherwise one
// column per lane.  Scratch rows are addressed in 64 bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dedup {

__device__ __forceinline__ float accum(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

__global__ void dedup_pool_kernel(
    const float* __restrict__ rows, const int32_t* __restrict__ ridx,
    const float* __restrict__ w, const int32_t* __restrict__ offsets,
    float* __restrict__ out, int num_segments, int D) {
  const int seg = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= num_segments) return;
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  float* orow = out + (int64_t)seg * D;
  if ((D & 3) == 0) {
    for (int c = lane * 4; c < D; c += 128) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int i = begin; i < end; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(rows + (int64_t)ridx[i] * D + c);
        const float wi = w[i];
        a0 = accum(a0, v.x, wi);
        a1 = accum(a1, v.y, wi);
        a2 = accum(a2, v.z, wi);
        a3 = accum(a3, v.w, wi);
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(a0, a1, a2, a3);
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float a = 0.f;
      for (int i = begin; i < end; ++i) {
        a = accum(a, rows[(int64_t)ridx[i] * D + c], w[i]);
      }
      orow[c] = a;
    }
  }
}

}  // namespace dedup
