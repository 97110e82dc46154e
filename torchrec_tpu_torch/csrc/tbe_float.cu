// Pooled embedding lookup over float32 / bfloat16 tables for Hopper
// (sm_90a), bound to Python with ctypes through a plain C interface
// (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at first use).
//
//   tbe_pooled   replaces torchrec_tpu/ops/pallas_tbe.py
//                ::tbe_pooled_forward_sorted (kernel body _tbe_body, input
//                preparation _sort_pad_inputs, wrapper
//                pallas_pooled_embedding_lookup)
//
// It computes out[s, :] = sum_i w_i * table[id_i, :] over the ids of segment
// s, in slot order, accumulating in f32 and writing the table's dtype.
//
// What bounds it on an H100: bytes.  Per id it reads one row (D * 4 bytes
// for f32, D * 2 for bf16) plus 4 bytes of id and 4 of weight, and does
// 2 * D flops; at D = 128 that is under 0.5 flops per byte, far below the
// ~20 flops/byte where the card's f32 rate would take over.  The design aims
// at touching each row byte once with coalesced 16-byte loads, and nothing
// else.
//
// Design.  The TPU kernel walks id chunks on a SEQUENTIAL grid and flushes
// each segment run into HBM with a read-modify-write, which is race-free
// only because TPU grid steps run in order (pallas_tbe.py:16-18).  Blocks on
// Hopper run concurrently, so each output segment has exactly one owner: one
// warp per segment walks that segment's ids (CSR offsets from the wrapper's
// stable sort) and writes out[s, :] once.  No atomics, no cross-block pass;
// an empty segment writes zeros.  When D is a multiple of the vector width
// (4 f32 or 8 bf16 values = 16 bytes) and the buffers are 16-byte aligned,
// each lane owns one 16-byte vector of columns per 32-vector block;
// otherwise one column per lane.
//
// Rounding: each row element is widened to f32, multiplied by the f32 weight
// (__fmul_rn) and added to the accumulator (__fadd_rn), slot by slot, as
// _tbe_body does (pallas_tbe.py:176-180); the sum is rounded once to the
// table's dtype (round to nearest even).  The plain PyTorch version
// (torchrec_tpu_torch/ops/tbe.py::pooled_lookup_plain) does the same
// operations in the same order, so on the card kernel and plain version are
// bitwise equal.  Row addresses are 64-bit (id * D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float accum(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

// One warp per segment.  VEC: each lane loads 16 bytes (N = 16 / sizeof(T)
// consecutive columns) per id and column block of 32 * N.
template <typename T, bool VEC>
__global__ void tbe_pooled_kernel(const T* __restrict__ table,
                                  const int32_t* __restrict__ ids,
                                  const float* __restrict__ w,
                                  const int32_t* __restrict__ offsets,
                                  T* __restrict__ out, int num_segments,
                                  int D) {
  const int seg = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= num_segments) return;
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  T* orow = out + (int64_t)seg * D;
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(T);
    for (int c = lane * N; c < D; c += 32 * N) {
      float acc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = 0.f;
      for (int i = begin; i < end; ++i) {
        const int64_t r = ids[i];
        const float wi = w[i];
        const uint4 raw = *reinterpret_cast<const uint4*>(table + r * D + c);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] = accum(acc[k], widen(v[k]), wi);
      }
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = narrow<T>(acc[k]);
      *reinterpret_cast<uint4*>(orow + c) = packed;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float a = 0.f;
      for (int i = begin; i < end; ++i) {
        a = accum(a, widen(table[(int64_t)ids[i] * D + c]), w[i]);
      }
      orow[c] = narrow<T>(a);
    }
  }
}

inline unsigned blocks_for(int warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* table, const void* ids, const void* w,
           const void* offsets, void* out, int num_segments, int D,
           cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = D % N == 0 && aligned16(table) && aligned16(out);
  const dim3 grid(blocks_for(num_segments));
  const T* t = (const T*)table;
  const int32_t* i = (const int32_t*)ids;
  const float* wt = (const float*)w;
  const int32_t* o = (const int32_t*)offsets;
  T* y = (T*)out;
  if (vec) {
    tbe_pooled_kernel<T, true>
        <<<grid, kThreads, 0, stream>>>(t, i, wt, o, y, num_segments, D);
  } else {
    tbe_pooled_kernel<T, false>
        <<<grid, kThreads, 0, stream>>>(t, i, wt, o, y, num_segments, D);
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).  `dtype` is 0 for float32 and 1 for bfloat16 tables (the output
// has the table's dtype).  Pointers are device pointers; the Python wrapper
// has checked devices, dtypes, shapes and contiguity.
int tbe_pooled(const void* table, const void* ids, const void* w,
               const void* offsets, void* out, int num_segments, int D,
               int dtype, void* stream) {
  if (num_segments > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
      case 0:
        launch<float>(table, ids, w, offsets, out, num_segments, D, st);
        break;
      case 1:
        launch<__nv_bfloat16>(table, ids, w, offsets, out, num_segments, D,
                              st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
