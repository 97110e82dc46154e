// The columns a lane owns of a float32 / bfloat16 / float16 table row,
// shared by the float pooled lookups B1 (tbe_float.cu) and B4
// (tbe_dedup.cu): how a lane loads them, widens them to f32 (exact) and
// adds them into its sums, and how the sums are rounded once to the
// output's dtype (round to nearest even) and stored.  The output is the
// table's dtype, or float32 for a 16-bit table (the serving tables: the
// f32 sums stored as they are, no rounding and no cast kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "pool_walk.cuh"

namespace pool {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// Four consecutive columns of a row, what a lane loads on the vector path:
// 16 bytes of f32, or 8 bytes of bf16 or fp16 (each 32-bit word two values,
// the lower column in its low half).  widen is exact; store rounds each
// value once to T.
template <typename T>
struct Cols4;
template <>
struct Cols4<float> {
  using Raw = uint4;
  __device__ static void widen(Raw r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <>
struct Cols4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static void widen(Raw r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static unsigned int pack(float lo, float hi) {
    return (unsigned int)__bfloat16_as_ushort(narrow<__nv_bfloat16>(lo)) |
           ((unsigned int)__bfloat16_as_ushort(narrow<__nv_bfloat16>(hi))
            << 16);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&a)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(a[0], a[1]),
                                              pack(a[2], a[3]));
  }
};

template <>
struct Cols4<__half> {
  using Raw = uint2;
  __device__ static float low(unsigned int w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  }
  __device__ static float high(unsigned int w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  __device__ static void widen(Raw r, float (&v)[4]) {
    v[0] = low(r.x);
    v[1] = high(r.x);
    v[2] = low(r.y);
    v[3] = high(r.y);
  }
  __device__ static unsigned int pack(float lo, float hi) {
    return (unsigned int)__half_as_ushort(narrow<__half>(lo)) |
           ((unsigned int)__half_as_ushort(narrow<__half>(hi)) << 16);
  }
  __device__ static void store(__half* p, const float (&a)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(a[0], a[1]),
                                              pack(a[2], a[3]));
  }
};

// The VEC columns [c, c + VEC) a lane owns of row r of a table [*, D] of
// T, and of an output row of O (T, or float): VEC = 4 (Cols4, one load;
// D and the output's row stride multiples of 4, the table and output
// aligned to 4 values) or 1 (one column).
template <typename T, int VEC, typename O = T>
struct TableCols {
  using Raw = typename std::conditional<VEC == 1, T,
                                        typename Cols4<T>::Raw>::type;
  __device__ static Raw load(const T* table, int D, int r, int c) {
    const T* p = table + (long long)r * D + c;
    if constexpr (VEC == 1) {
      return *p;
    } else {
      return __ldg(reinterpret_cast<const Raw*>(p));
    }
  }
  // acc[v] += value v of raw, weighted by w (two roundings)
  __device__ static void add(float (&acc)[VEC], Raw raw, float w) {
    if constexpr (VEC == 1) {
      acc[0] = accum(acc[0], widen(raw), w);
    } else {
      float v[4];
      Cols4<T>::widen(raw, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = accum(acc[k], v[k], w);
    }
  }
  __device__ static void store(O* p, const float (&acc)[VEC]) {
    if constexpr (VEC == 1) {
      *p = narrow<O>(acc[0]);
    } else {
      Cols4<O>::store(p, acc);
    }
  }
};

}  // namespace pool
