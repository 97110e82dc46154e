// Quantized pooled embedding lookups for Hopper (sm_90a), bound to Python
// with ctypes through a plain C interface (torchrec_tpu_torch/ops/_native.py
// builds this file with nvcc at first use).
//
// Two kernels, each the port of one Pallas TPU kernel:
//
//   tbe_q8_pooled          replaces torchrec_tpu/ops/pallas_tbe.py
//                          ::pallas_quantized_pooled_lookup (_tbe_kernel_q8)
//   dedup_q_gather +       replace torchrec_tpu/ops/pallas_tbe.py
//   dedup_pool             ::pallas_ragged_dedup_quantized_lookup
//                          (_dedup_kernel_q, _unpack_lanes)
//
// Both compute out[s, :] = sum_i w_i * (q[id_i, :] * scale[id_i] + bias[id_i])
// over the ids of segment s, in slot order, in f32.
//
// What bounds them on an H100: bytes.  Per id the int8 lookup reads one row
// (D bytes, or D*bits/8 packed) plus 8 bytes of scale/bias, 4 bytes of id and
// 4 of weight, and does 4*D flops; at D = 128 that is ~4 flops per byte, far
// below the ~20 flops/byte where the card's f32 rate would take over.  So
// the designs below aim at touching each byte once and keeping loads
// coalesced, and nothing else.
//
// Design.  The TPU kernel walks id chunks on a SEQUENTIAL grid and flushes
// each segment run into HBM with a read-modify-write, which is race-free
// only because TPU grid steps run in order (pallas_tbe.py:16-18).  CTAs on
// Hopper run concurrently, so here each output segment has exactly one owner:
// one warp per segment walks that segment's ids (CSR offsets built by the
// wrapper's stable sort) and writes out[s, :] once.  No atomics, no
// cross-CTA reduction, and an empty segment writes zeros.  For D % 4 == 0
// each lane owns 4 consecutive columns (one uchar4 / float4 load per id and
// column block of 128), otherwise one column per lane.
//
// Rounding: every product and sum is a separately rounded __fmul_rn /
// __fadd_rn, in the order v = q*s + b, acc = acc + v*w, slot by slot.  The
// plain PyTorch versions beside the wrappers (torchrec_tpu_torch/ops/tbe.py)
// do the same operations in the same order, so on the card kernel and plain
// version are bitwise equal.
//
// Row addresses are computed in 64 bits: id * D overflows int32 on the
// 40M-row MLPerf tables (40e6 * 128 = 5.1e9).
//
// Dedup scratch.  On the TPU the unique-row buffer lived in VMEM under
// DEDUP_VMEM_BUDGET = 8 MiB (pallas_tbe.py:715), a hard limit.  Hopper has
// no on-chip buffer shared across CTAs, so dedup_q_gather writes the
// dequantized distinct rows to a global f32 scratch [U, D] that dedup_pool
// then reads through the inverse index.  Its size is not limited: the
// wrapper allocates [U, D] for whatever U the batch has.  Up to about
// 32 MiB (U <= 65536 distinct rows at D = 128) the scratch is expected to
// fit the 50 MB L2 between the two launches; that is an expectation about
// the cache, not a checked budget, and it was not measured.  A larger
// scratch gives the same result and round-trips through HBM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dedup_pool.cuh"  // B5 launch B: dedup::dedup_pool_kernel

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float dequant(float code, float s, float b) {
  return __fadd_rn(__fmul_rn(code, s), b);
}

using dedup::accum;

// B3: one warp per segment, rows gathered per id.
__global__ void tbe_q8_pooled_kernel(
    const uint8_t* __restrict__ q, const float* __restrict__ scale,
    const float* __restrict__ bias, const int32_t* __restrict__ ids,
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
        const int64_t r = ids[i];
        const uchar4 v = *reinterpret_cast<const uchar4*>(q + r * D + c);
        const float s = scale[r], b = bias[r], wi = w[i];
        a0 = accum(a0, dequant((float)v.x, s, b), wi);
        a1 = accum(a1, dequant((float)v.y, s, b), wi);
        a2 = accum(a2, dequant((float)v.z, s, b), wi);
        a3 = accum(a3, dequant((float)v.w, s, b), wi);
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(a0, a1, a2, a3);
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float a = 0.f;
      for (int i = begin; i < end; ++i) {
        const int64_t r = ids[i];
        a = accum(a, dequant((float)q[r * D + c], scale[r], bias[r]), w[i]);
      }
      orow[c] = a;
    }
  }
}

// B5 launch A: one warp per distinct row; unpack (interleaved, low bits
// first: element k*(8/BITS)+j is bits [j*BITS, (j+1)*BITS) of byte k, the
// order of quant_ops.unpack_int4 / unpack_int2) and dequantize once.
template <int BITS>
__global__ void dedup_q_gather_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ scale,
    const float* __restrict__ bias, const int32_t* __restrict__ uids,
    float* __restrict__ rows, int num_unique, int D, int Dp) {
  constexpr int kPer = 8 / BITS;
  constexpr int kMask = (1 << BITS) - 1;
  const int u = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= num_unique) return;
  const int64_t r = uids[u];
  const uint8_t* src = packed + r * Dp;
  const float s = scale[r], b = bias[r];
  float* dst = rows + (int64_t)u * D;
  for (int c = lane; c < D; c += 32) {
    const int code = (src[c / kPer] >> ((c % kPer) * BITS)) & kMask;
    dst[c] = dequant((float)code, s, b);
  }
}

inline unsigned blocks_for(int warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers; the Python wrapper has
// checked devices, dtypes, shapes and contiguity.

int tbe_q8_pooled(const void* q, const void* scale, const void* bias,
                  const void* ids, const void* w, const void* offsets,
                  void* out, int num_segments, int D, void* stream) {
  if (num_segments > 0) {
    tbe_q8_pooled_kernel<<<blocks_for(num_segments), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const float*)scale, (const float*)bias,
        (const int32_t*)ids, (const float*)w, (const int32_t*)offsets,
        (float*)out, num_segments, D);
  }
  return (int)cudaGetLastError();
}

int dedup_q_gather(const void* packed, const void* scale, const void* bias,
                   const void* uids, void* rows, int num_unique, int D,
                   int Dp, int bits, void* stream) {
  if (num_unique > 0) {
    const dim3 grid(blocks_for(num_unique));
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* p = (const uint8_t*)packed;
    const float* s = (const float*)scale;
    const float* b = (const float*)bias;
    const int32_t* u = (const int32_t*)uids;
    float* r = (float*)rows;
    switch (bits) {
      case 8:
        dedup_q_gather_kernel<8><<<grid, kThreads, 0, st>>>(p, s, b, u, r,
                                                            num_unique, D, Dp);
        break;
      case 4:
        dedup_q_gather_kernel<4><<<grid, kThreads, 0, st>>>(p, s, b, u, r,
                                                            num_unique, D, Dp);
        break;
      case 2:
        dedup_q_gather_kernel<2><<<grid, kThreads, 0, st>>>(p, s, b, u, r,
                                                            num_unique, D, Dp);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int dedup_pool(const void* rows, const void* ridx, const void* w,
               const void* offsets, void* out, int num_segments, int D,
               void* stream) {
  if (num_segments > 0) {
    dedup::dedup_pool_kernel<<<blocks_for(num_segments), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)rows, (const int32_t*)ridx, (const float*)w,
        (const int32_t*)offsets, (float*)out, num_segments, D);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
