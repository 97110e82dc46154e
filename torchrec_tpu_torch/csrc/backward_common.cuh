// Pieces shared by the fused backward kernels (B2 in tbe_backward.cu, B6 in
// tbe_dedup_backward.cu): widening a table element to f32, the
// stochastic-rounding noise, the bf16 write-back, and which columns a lane
// owns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace bwd {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxCols = 16;  // columns per lane: D <= 32 * kMaxCols
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// _hash_bits of pallas_tbe_backward.py (uint32 arithmetic, wrapping).
__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t row,
                                              uint32_t col) {
  uint32_t x = col ^ (seed * 0x9E3779B9u) ^ (row * 0x85EBCA6Bu);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ void store(float* p, float v, bool, uint32_t,
                                      uint32_t, uint32_t) {
  *p = v;
}

// bf16 write-back: with `use_sr`, add the hash noise to the 16 bits bf16
// drops before cutting them; non-finite values pass through and round to
// nearest (pallas_tbe_backward.py:294-306).
__device__ __forceinline__ void store(__nv_bfloat16* p, float v, bool use_sr,
                                      uint32_t seed, uint32_t row,
                                      uint32_t col) {
  if (use_sr && fabsf(v) <= FLT_MAX) {
    const uint32_t noise = hash_bits(seed, row, col) & 0xFFFFu;
    const uint32_t u = (__float_as_uint(v) + noise) & 0xFFFF0000u;
    v = __uint_as_float(u);  // exact in bf16: the low 16 bits are zero
  }
  *p = __float2bfloat16_rn(v);
}

// Column k of this lane (ascending in k), or -1 where the lane has none:
// 4 consecutive columns per 128-column block when D % 4 == 0 (VEC), else
// one column per 32.  torchrec_tpu_torch/ops/tbe_backward.py::lane_columns
// is the same map.
template <bool VEC>
__device__ __forceinline__ int column(int lane, int k, int D) {
  const int c = VEC ? (k >> 2) * 128 + lane * 4 + (k & 3) : lane + 32 * k;
  return c < D ? c : -1;
}

}  // namespace bwd
