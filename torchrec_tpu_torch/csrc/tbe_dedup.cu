// Ragged dedup pooled lookup over float32 / bfloat16 tables for Hopper
// (sm_90a), bound to Python with ctypes through a plain C interface
// (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at first use).
//
//   dedup_pooled   replaces torchrec_tpu/ops/pallas_tbe.py
//                  ::pallas_ragged_dedup_lookup (kernel body _dedup_body,
//                  input preparation _dedup_prepare_inputs)
//
// Input, from the wrapper's dedup_prepare: the distinct valid ids uids[U]
// (sorted, clipped to the table), and the valid slots sorted by segment with
// their index into uids, their weight and the CSR offsets of the segments.
// It computes
//
//   rows[u, :]  = f32(table[uids[u], :])                  (launch A)
//   out[s, :]   = sum_i rows[ridx[i], :] * w_i, slot order (launch B)
//
// out is f32 [S, D]; the wrapper casts it to the table's dtype.
//
// What bounds it on an H100: bytes.  Each distinct row is read once (D * 4
// bytes f32, D * 2 bf16), each valid slot's index and weight once, and the
// f32 output written once; 2 flops per valid slot and column, far below the
// card's f32 ridge.  Launch A reads rows with 16-byte vectors (4 f32 or 8
// bf16 values a lane) and writes them widened; launch B is
// dedup_pool.cuh's one-warp-per-segment walk.
//
// No on-chip buffer.  The TPU kernel gathers the distinct rows into VMEM
// under an 8 MiB budget (DEDUP_VMEM_BUDGET, pallas_tbe.py:715) that its
// _assert_dedup_budget enforces.  Hopper has no on-chip memory shared across
// blocks, so the scratch rows[U, D] lives in device memory and has no
// budget: the wrapper allocates it for whatever U the batch has.  At the
// bucketed training path's U of about 340k rows x 512 bytes it is about
// 174 MB, well past the 50 MB L2, so it makes one extra round trip through
// device memory that the dedup design exists to avoid on the TPU.
//
// Rounding: each row element is widened to f32 first, then multiplied by the
// f32 weight (__fmul_rn) and added (__fadd_rn) in slot order, as _dedup_body
// does (widen at gather, mul and add in separate lane loops).  The plain
// PyTorch version (torchrec_tpu_torch/ops/tbe.py::dedup_pooled_lookup_plain)
// does the same operations in the same order, so on the card kernel and plain
// version are bitwise equal, and for f32 tables so is the per-id lookup
// tbe_pooled (tbe_float.cu): the gathered copy is exact and the order is the
// same.  Row addresses are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dedup_pool.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a table row, widened to f32 into out[0 .. kVec).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
};

// Launch A: one warp per distinct row.  VEC: each lane reads 16-byte
// vectors of the row and writes them widened as float4s; otherwise one
// column per lane.
template <typename T, bool VEC>
__global__ void dedup_gather_kernel(const T* __restrict__ table,
                                    const int32_t* __restrict__ uids,
                                    float* __restrict__ rows, int num_unique,
                                    int D) {
  const int u = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= num_unique) return;
  const T* src = table + (int64_t)uids[u] * D;
  float* dst = rows + (int64_t)u * D;
  if constexpr (VEC) {
    constexpr int kN = Vec<T>::kN;
    for (int c = lane * kN; c < D; c += 32 * kN) {
      float v[kN];
      Vec<T>::load(src + c, v);
#pragma unroll
      for (int j = 0; j < kN; j += 4) {
        *reinterpret_cast<float4*>(dst + c + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) dst[c] = widen(src[c]);
  }
}

inline unsigned blocks_for(int warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
void gather(const void* table, const int32_t* uids, float* rows, int U, int D,
            cudaStream_t stream) {
  const T* t = (const T*)table;
  if (D % Vec<T>::kN == 0 && aligned16(table) && aligned16(rows)) {
    dedup_gather_kernel<T, true><<<blocks_for(U), kThreads, 0, stream>>>(
        t, uids, rows, U, D);
  } else {
    dedup_gather_kernel<T, false><<<blocks_for(U), kThreads, 0, stream>>>(
        t, uids, rows, U, D);
  }
}

}  // namespace

extern "C" {

// Launches A then B on `stream` and returns cudaGetLastError() as an int (0
// = launched).  `dtype` is 0 for a float32 and 1 for a bfloat16 table;
// `rows` is the f32 [U, D] scratch and `out` the f32 [S, D] output.
// Pointers are device pointers; the Python wrapper has checked devices,
// dtypes, shapes and contiguity.
int dedup_pooled(const void* table, const void* uids, const void* ridx,
                 const void* w, const void* offsets, void* rows, void* out,
                 int num_unique, int num_segments, int D, int dtype,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (num_unique > 0) {
    switch (dtype) {
      case 0:
        gather<float>(table, (const int32_t*)uids, (float*)rows, num_unique,
                      D, st);
        break;
      case 1:
        gather<__nv_bfloat16>(table, (const int32_t*)uids, (float*)rows,
                              num_unique, D, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (num_segments > 0) {
    dedup::dedup_pool_kernel<<<blocks_for(num_segments), kThreads, 0, st>>>(
        (const float*)rows, (const int32_t*)ridx, (const float*)w,
        (const int32_t*)offsets, (float*)out, num_segments, D);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
