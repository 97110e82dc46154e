// Pieces shared by the fused backward kernels (B2 in tbe_backward.cu, B6 in
// tbe_dedup_backward.cu): widening a table element to f32, the
// stochastic-rounding noise, the bf16 write-back, which columns a lane
// owns, adding one slot's gradient row, and the update of one row by any of
// the eight optimizers (update_row), in either kernel's op order.

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

// the optimizer codes of ops/tbe_backward.py::OPTIMIZERS
enum Optim : int {
  kSgd = 0,
  kLarsSgd = 1,
  kAdagrad = 2,
  kRowwiseAdagrad = 3,
  kAdam = 4,
  kPartialRowwiseAdam = 5,
  kLamb = 6,
  kPartialRowwiseLamb = 7,
};

// omb1, omb2 are (1 - b1), (1 - b2) rounded from a host double; only B6's
// op order reads them (B2 rounds 1 - b in f32 from the f32 b)
struct Hyper {
  float lr, eps, wd, b1, b2, omb1, omb2, bc1, bc2;
};

// g += grad[seg, :] * wj over the lane's columns (mul, then add)
template <bool VEC>
__device__ __forceinline__ void add_slot(float (&g)[kMaxCols],
                                         const float* __restrict__ gr,
                                         float wj, int lane, int n, int D) {
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

// sum over the row of x * x in the fixed lane-then-butterfly order; every
// lane returns the same value
template <bool VEC>
__device__ __forceinline__ float sum_sq(const float (&x)[kMaxCols], int lane,
                                        int n, int D) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    if (k < n && column<VEC>(lane, k, D) >= 0) {
      s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  }
  return s;
}

// the trust ratio of lars_sgd and lamb from two row norms
__device__ __forceinline__ float trust_ratio(float a_norm, float b_norm) {
  return (a_norm > 0.f && b_norm > 0.f)
             ? __fdiv_rn(a_norm, fmaxf(b_norm, 1e-12f))
             : 1.f;
}

// One optimizer step on table row `row` and its states, by the whole warp,
// from the row's summed gradient `g` (the lane's columns), in place: weight
// decay g + wd * w, then the optimizer, then w + delta written back (a bf16
// table stochastically rounded when use_sr).  lr is negated first; every
// product and sum is a separately rounded __fmul_rn / __fadd_rn, every sqrt
// and division __fsqrt_rn / __fdiv_rn:
//
//   sgd              w + (-lr) g
//   lars_sgd         trust = ||w|| / max(||g||, 1e-12) (1 if a norm is 0);
//                    w + ((-lr) trust) g
//   adagrad          m = m + g g;  w + ((-lr) g) / (sqrt(m) + eps)
//   rowwise_adagrad  m = m + mean(g g);
//                    PER_ID (B2):  w + ((-lr) / (sqrt(m) + eps)) g
//                    else   (B6):  s = 1 / (sqrt(m) + eps); w + ((-lr) g) s
//   adam, lamb       m = b1 m + (1-b1) g;  v = b2 v + ((1-b2) g) g
//   partial_rowwise  m as adam;  v = b2 v + (1-b2) mean(g g)  (per row)
//     _adam, _lamb   dir = (m / bc1) / (sqrt(v) / sqrt(bc2) + eps);
//                    lamb: dir = dir * trust(||w||, ||dir||);  w + (-lr) dir
//
// (1 - b) is 1.f - b in f32 when PER_ID (_bwd_body computes it in the
// kernel, pallas_tbe_backward.py:252), else the host-double h.omb.  Every
// state row is read once, before the first warp shuffle, and written once
// at the end (the rowwise state by lane 0).  Addresses are 64-bit.
template <typename T, bool VEC, int OPT, bool PER_ID>
__device__ __forceinline__ void update_row(float (&g)[kMaxCols], int row,
                                           int lane, int n, int D,
                                           T* __restrict__ table,
                                           float* __restrict__ s0,
                                           float* __restrict__ s1,
                                           const Hyper& h, bool use_sr,
                                           uint32_t seed) {
  constexpr bool kElemM = OPT == kAdagrad || OPT == kAdam || OPT == kLamb ||
                          OPT == kPartialRowwiseAdam ||
                          OPT == kPartialRowwiseLamb;
  constexpr bool kElemV = OPT == kAdam || OPT == kLamb;
  constexpr bool kRowV = OPT == kPartialRowwiseAdam ||
                         OPT == kPartialRowwiseLamb;
  constexpr bool kLambTrust = OPT == kLamb || OPT == kPartialRowwiseLamb;

  T* wrow = table + (int64_t)row * D;
  // the element-wise states' rows (absent states are null pointers)
  float* mrow = kElemM ? s0 + (int64_t)row * D : nullptr;
  float* vrow = kElemV ? s1 + (int64_t)row * D : nullptr;
  float row_state = 0.f;  // rowwise_adagrad's m or the partial v
  if constexpr (OPT == kRowwiseAdagrad) row_state = s0[row];
  if constexpr (kRowV) row_state = s1[row];
  float w[kMaxCols], m[kMaxCols], v[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = column<VEC>(lane, k, D);
    const bool own = k < n && c >= 0;
    w[k] = own ? widen(wrow[c]) : 0.f;
    if constexpr (kElemM) m[k] = own ? mrow[c] : 0.f;
    if constexpr (kElemV) v[k] = own ? vrow[c] : 0.f;
  }
  if (h.wd != 0.f) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      g[k] = __fadd_rn(g[k], __fmul_rn(h.wd, w[k]));
    }
  }

  const float neg_lr = -h.lr;
  float delta[kMaxCols];  // per column: the value added to w
  if constexpr (OPT == kSgd) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) delta[k] = __fmul_rn(neg_lr, g[k]);
  } else if constexpr (OPT == kLarsSgd) {
    const float t = trust_ratio(__fsqrt_rn(sum_sq<VEC>(w, lane, n, D)),
                                __fsqrt_rn(sum_sq<VEC>(g, lane, n, D)));
    const float a = __fmul_rn(neg_lr, t);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) delta[k] = __fmul_rn(a, g[k]);
  } else if constexpr (OPT == kAdagrad) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      m[k] = __fadd_rn(m[k], __fmul_rn(g[k], g[k]));
      delta[k] = __fdiv_rn(__fmul_rn(neg_lr, g[k]),
                           __fadd_rn(__fsqrt_rn(m[k]), h.eps));
    }
  } else if constexpr (OPT == kRowwiseAdagrad) {
    const float ss = sum_sq<VEC>(g, lane, n, D);
    row_state = __fadd_rn(row_state, __fdiv_rn(ss, (float)D));
    const float den = __fadd_rn(__fsqrt_rn(row_state), h.eps);
    if constexpr (PER_ID) {
      const float scale = __fdiv_rn(neg_lr, den);
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) delta[k] = __fmul_rn(scale, g[k]);
    } else {
      const float scale = __fdiv_rn(1.f, den);
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        delta[k] = __fmul_rn(__fmul_rn(neg_lr, g[k]), scale);
      }
    }
  } else {  // the adam family
    const float omb1 = PER_ID ? __fsub_rn(1.f, h.b1) : h.omb1;
    const float omb2 = PER_ID ? __fsub_rn(1.f, h.b2) : h.omb2;
    const float sqbc2 = __fsqrt_rn(h.bc2);
    float vpe_row = 0.f;
    if constexpr (kRowV) {
      const float ss = sum_sq<VEC>(g, lane, n, D);
      row_state = __fadd_rn(__fmul_rn(h.b2, row_state),
                            __fmul_rn(omb2, __fdiv_rn(ss, (float)D)));
      vpe_row = __fadd_rn(__fdiv_rn(__fsqrt_rn(row_state), sqbc2), h.eps);
    }
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      m[k] = __fadd_rn(__fmul_rn(h.b1, m[k]), __fmul_rn(omb1, g[k]));
      float vpe = vpe_row;
      if constexpr (kElemV) {
        v[k] = __fadd_rn(__fmul_rn(h.b2, v[k]),
                         __fmul_rn(__fmul_rn(omb2, g[k]), g[k]));
        vpe = __fadd_rn(__fdiv_rn(__fsqrt_rn(v[k]), sqbc2), h.eps);
      }
      delta[k] = __fdiv_rn(__fdiv_rn(m[k], h.bc1), vpe);  // dir
    }
    if constexpr (kLambTrust) {
      const float t = trust_ratio(__fsqrt_rn(sum_sq<VEC>(w, lane, n, D)),
                                  __fsqrt_rn(sum_sq<VEC>(delta, lane, n, D)));
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) delta[k] = __fmul_rn(delta[k], t);
    }
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) delta[k] = __fmul_rn(neg_lr, delta[k]);
  }

#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = column<VEC>(lane, k, D);
    if (k < n && c >= 0) {
      store(wrow + c, __fadd_rn(w[k], delta[k]), use_sr, seed,
            (uint32_t)row, (uint32_t)c);
      if constexpr (kElemM) mrow[c] = m[k];
      if constexpr (kElemV) vrow[c] = v[k];
    }
  }
  if (lane == 0) {
    if constexpr (OPT == kRowwiseAdagrad) s0[row] = row_state;
    if constexpr (kRowV) s1[row] = row_state;
  }
}

}  // namespace bwd
