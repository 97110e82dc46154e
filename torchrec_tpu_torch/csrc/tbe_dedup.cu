// Ragged dedup pooled lookup over float32 / bfloat16 / float16 tables for
// Hopper
// (sm_90a), bound to Python with ctypes through a plain C interface
// (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at first use).
//
//   dedup_pooled   replaces torchrec_tpu/ops/pallas_tbe.py
//                  ::pallas_ragged_dedup_lookup (kernel body _dedup_body,
//                  input preparation _dedup_prepare_inputs)
//
// Input, from the wrapper's dedup_prepare_sized (no host sync): the sorted
// distinct dedup keys ukeys (id + 2^31 of each distinct valid id, then the
// sentinel), and the slots sorted by segment, invalid ones last, with each
// slot's index into ukeys (inv), its weight and the CSR offsets of the
// segments.  One launch computes
//
//   out[s, :] = O( sum_i f32(table[key_row(ukeys[inv[i]]), :]) * w_i )
//
// over the slots i of segment s in slot order, with key_row the key's id
// clipped to [0, R - 1].  O is the table's dtype T, or float32 for a
// bfloat16 or float16 table (the serving tables, read in place, with no
// cast kernel); output row s starts at out + s * ld (ld >= D).  The number of distinct keys stays on the device:
// the kernel reaches the keys only through inv.
//
// What bounds it on an H100: latency, then bytes.  Each slot costs a chain
// of dependent loads (its index, its key, then the row), and a segment of
// the bucketed training path holds 1 to 64 Zipf slots, about 10 on
// average.  The bytes (each distinct row once, each slot's index and
// weight once, the output once) take about 0.08 ms at the bucketed batch;
// 2 flops per slot and column are far below the card's f32 ridge.  So each
// segment has one owner warp that walks its slots with pool_walk.cuh's walk
// (B3 and B5 walk the same way): 32 slots' index, key and weight fetched a
// lane each, the next 32 fetched ahead, and kWalkDepth row loads of 4
// columns a lane (16 bytes of f32, 8 of bf16) issued before the first add.
// With segments this short the waits are hidden by many resident warps
// more than by a deep walk: depth 4 under a 6-blocks-an-SM register bound
// (40 registers) was the fastest of depths 2, 4 and 8 with 1, 6 or 8
// blocks, and 8 bf16 columns a lane (16-byte loads, half the lanes idle at
// D = 128, 77 registers) was slower than 4 (PERF.md section 6).  For D not
// a multiple of 4, or tables or outputs not aligned to 4 values, each lane
// owns one column of a 32-column block.
//
// No scratch.  The TPU kernel gathers the distinct rows into VMEM (under an
// 8 MiB budget, DEDUP_VMEM_BUDGET, pallas_tbe.py:715) so that each is read
// from HBM once however many slots use it.  Hopper has no on-chip memory
// shared across blocks; its counterpart of that reuse is the 50 MB L2,
// which serves the repeat reads of a hot row.  So the warp reads each
// slot's row straight from the table and widens it in registers: f32 -> f32
// and bf16 -> f32 are exact, so an f32 copy of the distinct rows would buy
// nothing for the bits and cost a round trip of U x D x 4 bytes (174 MB at
// the bucketed batch, 3.5x the L2).  The segment-sorted stream is
// feature-major, so the resident warps work on one table's hot rows at a
// time.
//
// Owner warps.  The TPU kernel walks id chunks on a SEQUENTIAL grid and
// flushes each segment run into HBM with a read-modify-write, race-free only
// because TPU grid steps run in order (pallas_tbe.py:16-18).  Here each
// output segment has exactly one owner warp, which writes its output once:
// no atomics, and an empty segment writes zeros.
//
// Rounding: each row element is widened to f32, multiplied by the f32
// weight (__fmul_rn) and added (__fadd_rn) in slot order, as _dedup_body
// does (widen at gather, mul and add in separate lane loops); the sum is
// rounded once to the output's dtype (round to nearest even; none for
// float32), as the per-id lookup tbe_pooled (tbe_float.cu) does.  The plain PyTorch version
// (torchrec_tpu_torch/ops/tbe.py::dedup_pooled_lookup_plain) does the same
// operations in the same order, so on the card kernel, plain version and
// tbe_pooled on the same slots are bitwise equal.  Row addresses are 64-bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_cols.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
// the rows in flight in a warp's walk, and the blocks an SM the kernel's
// registers are bounded for (see above)
constexpr int kWalkDepth = 4;
constexpr int kMinBlocks = 6;

// B4's rows: the table's, through each slot's index into the distinct
// keys.  VEC = 4 (Cols4, one load a lane) or 1 (a column a lane).
template <typename T, int VEC>
struct FloatRows {
  static constexpr int kDepth = kWalkDepth;
  static constexpr int kVec = VEC;
  static constexpr bool kSide = false;
  using Cols = pool::TableCols<T, VEC>;
  using Raw = typename Cols::Raw;
  const long long* inv;
  const long long* ukeys;
  const T* table;
  long long last;  // rows - 1
  int D;
  __device__ long long key(long long i) const {
    return __ldg(ukeys + __ldg(inv + i));
  }
  __device__ int row(long long k) const { return (int)pool::key_row(k, last); }
  __device__ void side(int, float&, float&) const {}
  __device__ Raw load(int r, int c) const { return Cols::load(table, D, r, c); }
  __device__ void add(float (&acc)[VEC], Raw raw, float, float,
                      float w) const {
    Cols::add(acc, raw, w);
  }
};

// One warp per segment: every column block of its output, each walked
// over the segment's slots, then rounded once to O and written.
template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dedup_pooled_kernel(const T* __restrict__ table,
                        const long long* __restrict__ ukeys,
                        const long long* __restrict__ inv,
                        const float* __restrict__ w,
                        const long long* __restrict__ offsets,
                        O* __restrict__ out, long long num_segments, int D,
                        long long rows, long long ld) {
  const long long s = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= num_segments) return;
  const FloatRows<T, VEC> src{inv, ukeys, table, rows - 1, D};
  const pool::Slots sg{offsets[s], offsets[s + 1], 0.f};
  O* orow = out + s * ld;
  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < D;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    pool::walk(src, sg, w, lane, c, active, acc);
    if (active) pool::TableCols<T, VEC, O>::store(orow + c, acc);
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename O>
void launch(const void* table, const void* ukeys, const void* inv,
            const void* w, const void* offsets, void* out,
            long long num_segments, int D, long long rows, long long ld,
            cudaStream_t stream) {
  const unsigned grid =
      (unsigned)((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* t = (const T*)table;
  const long long* k = (const long long*)ukeys;
  const long long* i = (const long long*)inv;
  const float* wt = (const float*)w;
  const long long* o = (const long long*)offsets;
  O* y = (O*)out;
  if (D % 4 == 0 && ld % 4 == 0 && aligned(table, 4 * sizeof(T)) &&
      aligned(out, 4 * sizeof(O))) {
    dedup_pooled_kernel<T, O, 4><<<grid, kThreads, 0, stream>>>(
        t, k, i, wt, o, y, num_segments, D, rows, ld);
  } else {
    dedup_pooled_kernel<T, O, 1><<<grid, kThreads, 0, stream>>>(
        t, k, i, wt, o, y, num_segments, D, rows, ld);
  }
}

using Launcher = void (*)(const void*, const void*, const void*,
                          const void*, const void*, void*, long long, int,
                          long long, long long, cudaStream_t);

// The launcher of a (table dtype, output dtype) pair, as tbe_float.cu's
// kernel_for: the output is the table's type or float32 (0); nullptr for
// any other pair.
Launcher launcher_for(int dtype, int out_dtype) {
  if (out_dtype == dtype) {
    switch (dtype) {
      case 0:
        return launch<float, float>;
      case 1:
        return launch<__nv_bfloat16, __nv_bfloat16>;
      case 2:
        return launch<__half, __half>;
    }
  } else if (out_dtype == 0) {
    switch (dtype) {
      case 1:
        return launch<__nv_bfloat16, float>;
      case 2:
        return launch<__half, float>;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).  `dtype` is 0 for a float32, 1 for a bfloat16 and 2 for a
// float16 table; `out_dtype` the output's, the table's or 0 (float32); the
// output is [S, D] with row stride `ld` (>= D) values; ukeys, inv and
// offsets are int64, w float32.  Pointers are device pointers; the Python
// wrapper has checked devices, dtypes, shapes and contiguity.
int dedup_pooled(const void* table, const void* ukeys, const void* inv,
                 const void* w, const void* offsets, void* out,
                 long long num_segments, int D, long long rows, int dtype,
                 int out_dtype, long long ld, void* stream) {
  const Launcher fn = launcher_for(dtype, out_dtype);
  if (ld < D || fn == nullptr) return (int)cudaErrorInvalidValue;
  if (num_segments > 0)
    fn(table, ukeys, inv, w, offsets, out, num_segments, D, rows, ld,
       (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
