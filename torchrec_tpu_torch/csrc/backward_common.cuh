// The fused backward kernels (B2 in tbe_backward.cu, B6 in
// tbe_dedup_backward.cu) are one kernel, fused_update_kernel below, in two
// op orders (PER_ID): its grid, its walk of a row run, the update of one row
// by any of the eight optimizers (update_row), widening a table element to
// f32, the stochastic-rounding noise, the bf16 write-back and which columns
// a lane owns.  Each source instantiates it for its own op order and adds
// its C entry points.
//
// Input: the slots sorted by table row (stable), invalid slots last with the
// sentinel row R.  Each run of equal rows is summed and its row updated by
// exactly one warp, its owner.
//
// The grid: persistent, over the valid positions only.  The launch has as
// many blocks as are resident on the card at once (the instantiation's
// occupancy times the SMs, read once per kernel and device and cached), but
// no more warps than 32-position windows.  Each warp claims the next window
// of the sorted stream with an integer atomicAdd on a work queue in device
// memory, finds the runs that START in the window with a ballot over
// srows[p] != srows[p - 1], and owns each of them: it walks the run to its
// end, past the window if need be, and updates the row.  A warp stops at
// the first window that begins past V or on the sentinel: claims only go up
// and the sentinel sorts last, so no work is left for it.  The valid count
// is never read back, and the 92% of padding slots of the table-wise layout
// cost one claim per warp instead of a warp each.  Which warp owns which run
// depends on the claim order, but the run's sum and update do not: results
// are deterministic, and no float atomic is used.
//
// The queue resets itself: two uint32 counters (windows claimed, warps
// finished); the last warp to finish sets both to 0, so the next launch on
// the stream finds them at 0 (stream order) with no memset node and no host
// sync.  The wrapper keeps one queue per (device, stream): two launches on
// one stream never overlap.  The queue measured faster than a static
// grid-stride assignment of windows on the main paths (PERF.md).
//
// The walk of a run (sum_run): a warp loads its window's rows, segments
// and weights together, a lane a slot, so a run that ends inside the
// window (most runs at uniform ids) needs no other metadata load.  A run
// that reaches the window's end goes on 32 slots at a time: each chunk's
// metadata a lane a slot, its end from a ballot over srows[p] == row (rows
// are sorted, so the run is a prefix of every chunk it reaches), the next
// chunk's metadata loaded while the current one is added, and L2 asked
// (prefetch.global.L2, no registers) for the gradient rows kRowsAhead
// chunks ahead and for the metadata 2 kRowsAhead chunks ahead.  Within a
// chunk (add_chunk) the segments and weights of kDepth slots are shuffled
// out, their kDepth gradient rows loaded, then added in slot order, with
// no branch in between: a warp alone on its SM (the owner of a Zipf-hot
// row, once the others have finished) still keeps kDepth loads in flight
// and does not wait out one shuffle's latency per slot.  The table row
// and its state rows are loaded before the walk (load_vals), so their
// latency hides behind it.
//
// Optimizer state in float32, bfloat16 or float16 (S): a state value is
// read, widened to f32 and computed in f32; the stored value is the f32
// result rounded to nearest into S, and the step's scale uses the f32 value
// before that rounding, as the JAX package's XLA update does
// (ops/fused_update.py:200-337: `new_mom` feeds the scale before `.at[].set`
// rounds it).  One more rounding is the reference's own: its Adam family
// multiplies a 16-bit state by a weakly typed Python beta, which JAX
// computes in the state's dtype, the beta first rounded to it (bf16 0.9 is
// 0.8984375, and 0.999 rounds to 1.0), so `b * m` is decay<S> below: the
// product of the two S values (exact in f32) rounded to S.  An S other than
// f32 is instantiated only for the six optimizers that have a state.
//
// Registers by D: the columns a lane owns (column<VEC>) are kept in arrays
// of NC floats.  A table with D <= 128 and D % 4 == 0 takes the narrow
// layout, NC = 4 (one float4 per lane), bounded to two 256-thread blocks
// per SM (<= 128 registers); any other D <= 512 the general one, NC = 16
// (D % 4 == 0: 4 columns of each of 4 128-column blocks; else one column
// of each of 16 32-column blocks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace bwd {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kWindow = 32;  // sorted positions per claim
constexpr int kMaxCols = 16;  // columns per lane: D <= 32 * kMaxCols
constexpr unsigned kFull = 0xffffffffu;
// The three constants below were chosen from the builds timed on the main
// paths (PERF.md's build sweep): walk depth 4, 8, 16 or 32; at least 1, 2 or
// 3 narrow blocks an SM; the L2 prefetch off or 4 chunks ahead.
// gradient rows in flight in a run's walk, narrow layout (the general one
// keeps as many floats in flight: kDepth / 4 rows)
constexpr int kDepth = 8;
// 256-thread blocks of a narrow instantiation resident on an SM at least
// (__launch_bounds__: at most 65,536 / (256 * kMinBlocks) registers)
constexpr int kMinBlocks = 2;
// a long run's walk asks L2 for the gradient rows kRowsAhead chunks of 32
// slots ahead of the chunk it adds, and for the metadata 2 kRowsAhead
// chunks ahead
constexpr int kRowsAhead = 4;
constexpr int kAhead = 2 * kRowsAhead;

// the column layouts, by D (layout_for)
enum Layout : int { kNarrow = 0, kWide = 1, kScalar = 2 };

inline int layout_for(int D) {
  return D % 4 ? kScalar : (D <= 128 ? kNarrow : kWide);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// an optimizer state value stored: rounded to nearest into S
__device__ __forceinline__ void store_state(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_state(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_state(__half* p, float v) {
  *p = __float2half_rn(v);
}

// f32 x rounded to nearest into S and widened back
template <typename S>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (std::is_same<S, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// b * s for a state value s read from S: f32 for an f32 state; else the
// reference's weakly typed product in S, b rounded to S first (the
// product of two S values is exact in f32, then rounded to S once)
template <typename S>
__device__ __forceinline__ float decay(float b, float s) {
  if constexpr (std::is_same<S, float>::value) {
    return __fmul_rn(b, s);
  } else {
    return round_to<S>(__fmul_rn(round_to<S>(b), s));
  }
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

// the sorted slot stream and the upstream gradient
struct Slots {
  const int32_t* rows;  // [V] sorted, the sentinel R last
  const int32_t* segs;  // [V]
  const float* w;       // [V]
  const float* grad;    // [S, D]
  int V, R, D;
};

// the lane's columns of gradient row `gr` where `ok` (0 where the lane has
// none)
template <bool VEC, int NC>
__device__ __forceinline__ void load_row(float (&x)[NC],
                                         const float* __restrict__ gr,
                                         bool ok, int lane, int D) {
  if constexpr (VEC) {
#pragma unroll
    for (int b = 0; b < NC / 4; ++b) {
      const int c = b * 128 + lane * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && c < D) v = __ldg(reinterpret_cast<const float4*>(gr + c));
      x[4 * b + 0] = v.x;
      x[4 * b + 1] = v.y;
      x[4 * b + 2] = v.z;
      x[4 * b + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k;
      x[k] = ok && c < D ? __ldg(gr + c) : 0.f;
    }
  }
}

// Ask L2 for the 128-byte line holding `p`; a load that follows finds it
// there.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The segment of slot q + lane (-1 past V): prefetch_rows asks L2 for its
// gradient row once it has come.
__device__ __forceinline__ int far_segment(const Slots& sl, int64_t q,
                                           int lane) {
  return q + lane < sl.V ? __ldg(sl.segs + q + lane) : -1;
}

__device__ __forceinline__ void prefetch_rows(const Slots& sl, int seg) {
  if (seg >= 0) {
    const float* gr = sl.grad + (int64_t)seg * sl.D;
    for (int c = 0; c < sl.D; c += 32) prefetch_l2(gr + c);
  }
}

// g += grad[seg_j, :] * w_j over the K slots j0, j0 + 1, ... of a 32-slot
// chunk whose segment and weight lane j holds (those below hi when TAIL),
// in slot order (mul, then add), in the lane's columns: the K segments and
// weights are shuffled out first, then the K gradient rows loaded, then
// added, with no branch in between.
template <bool VEC, int NC, int K, bool TAIL>
__device__ __forceinline__ void add_batch(float (&g)[NC], const Slots& sl,
                                          int seg, float wt, int j0, int hi,
                                          int lane) {
  int sk[K];
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sk[k] = __shfl_sync(kFull, seg, (j0 + k) & 31);
    wk[k] = __shfl_sync(kFull, wt, (j0 + k) & 31);
  }
  float x[K][NC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // segments are >= 0: unsigned 64-bit offsets take fewer instructions
    load_row<VEC, NC>(x[k], sl.grad + (uint64_t)(uint32_t)sk[k] * sl.D,
                      !TAIL || j0 + k < hi, lane, sl.D);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float sum = __fadd_rn(g[c], __fmul_rn(x[k][c], wk[k]));
      g[c] = !TAIL || j0 + k < hi ? sum : g[c];
    }
  }
}

// add_batch over the slots [lo, hi) of a chunk: K at a time, kDepth
// gradient rows in flight (the general layout as many floats: kDepth / 4
// rows), the last batch predicated
template <bool VEC, int NC>
__device__ __forceinline__ void add_chunk(float (&g)[NC], const Slots& sl,
                                          int seg, float wt, int lo, int hi,
                                          int lane) {
  constexpr int K = kDepth * 4 / NC > 0 ? kDepth * 4 / NC : 1;
  int j0 = lo;
  for (; j0 + K <= hi; j0 += K) {
    add_batch<VEC, NC, K, false>(g, sl, seg, wt, j0, hi, lane);
  }
  if (j0 < hi) add_batch<VEC, NC, K, true>(g, sl, seg, wt, j0, hi, lane);
}

// g = sum over the run of `row` that starts at lane k of the window at
// `base` of grad[seg_j, :] * w_j, in slot order, in the lane's columns.
// Its slots in the window come from the window's rows r, segments seg and
// weights wt (lane j, slot base + j); if it reaches the window's end, the
// walk goes on 32 slots at a time: each chunk's metadata a lane a slot,
// the next chunk's loaded while the current one is added, and L2 asked for
// the gradient rows kRowsAhead chunks ahead and the metadata kAhead ahead.
template <bool VEC, int NC>
__device__ __forceinline__ void sum_run(float (&g)[NC], const Slots& sl,
                                        int64_t base, int k, int row, int r,
                                        int seg, float wt, int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c) g[c] = 0.f;
  // the lanes below k hold smaller rows: the run ends at the first lane
  // past k whose row differs
  unsigned same = __ballot_sync(kFull, r == row) | ((1u << k) - 1u);
  int cnt = same == kFull ? 32 : __ffs(~same) - 1;
  add_chunk<VEC, NC>(g, sl, seg, wt, k, cnt, lane);
  while (cnt == 32) {
    base += 32;
    int64_t p = base + lane;
    bool in = p < sl.V && __ldg(sl.rows + p) == row;
    seg = p < sl.V ? __ldg(sl.segs + p) : 0;
    wt = p < sl.V ? __ldg(sl.w + p) : 0.f;
    for (;;) {
      // the run is a prefix of the chunk: its length here is the first 0
      same = __ballot_sync(kFull, in);
      cnt = same == kFull ? 32 : __ffs(~same) - 1;
      bool in_next = false;
      int seg_next = 0, seg_far = -1;
      float w_next = 0.f;
      if (cnt == 32) {
        p = base + 32 + lane;
        if (p < sl.V) {
          in_next = __ldg(sl.rows + p) == row;
          seg_next = __ldg(sl.segs + p);
          w_next = __ldg(sl.w + p);
        }
        seg_far = far_segment(sl, base + 32 * kRowsAhead, lane);
        const int64_t q = base + 32 * kAhead;
        if (lane < 3 && q < sl.V) {
          prefetch_l2(lane == 0 ? (const void*)(sl.rows + q)
                      : lane == 1 ? (const void*)(sl.segs + q)
                                  : (const void*)(sl.w + q));
        }
      }
      add_chunk<VEC, NC>(g, sl, seg, wt, 0, cnt, lane);
      if (cnt < 32) return;
      prefetch_rows(sl, seg_far);
      base += 32;
      in = in_next;
      seg = seg_next;
      wt = w_next;
    }
  }
}

// sum over the row of x * x in the fixed lane-then-butterfly order; every
// lane returns the same value
template <bool VEC, int NC>
__device__ __forceinline__ float sum_sq(const float (&x)[NC], int lane,
                                        int D) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (column<VEC>(lane, k, D) >= 0) {
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

// The table row and state values of `row` in the lane's columns (0 where
// it has none), read before the run's walk so their loads overlap it.
template <int NC>
struct RowVals {
  float w[NC], m[NC], v[NC];
  float row_state;  // rowwise_adagrad's m or the partial v
};

template <typename T, typename S, bool VEC, int NC, int OPT>
__device__ __forceinline__ void load_vals(RowVals<NC>& x, int row, int lane,
                                          int D, const T* __restrict__ table,
                                          const S* __restrict__ s0,
                                          const S* __restrict__ s1) {
  constexpr bool kElemM = OPT == kAdagrad || OPT == kAdam || OPT == kLamb ||
                          OPT == kPartialRowwiseAdam ||
                          OPT == kPartialRowwiseLamb;
  constexpr bool kElemV = OPT == kAdam || OPT == kLamb;
  const T* wrow = table + (int64_t)row * D;
  x.row_state = 0.f;
  if constexpr (OPT == kRowwiseAdagrad) x.row_state = widen(s0[row]);
  if constexpr (OPT == kPartialRowwiseAdam || OPT == kPartialRowwiseLamb) {
    x.row_state = widen(s1[row]);
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = column<VEC>(lane, k, D);
    const bool own = c >= 0;
    x.w[k] = own ? widen(wrow[c]) : 0.f;
    if constexpr (kElemM) {
      x.m[k] = own ? widen(s0[(int64_t)row * D + c]) : 0.f;
    }
    if constexpr (kElemV) {
      x.v[k] = own ? widen(s1[(int64_t)row * D + c]) : 0.f;
    }
  }
}

// One optimizer step on table row `row` and its states, by the whole warp,
// from the row's summed gradient `g` and its values `x` (load_vals; the
// lane's columns), in place: weight decay g + wd * w, then the optimizer,
// then w + delta written back (a bf16 table stochastically rounded when
// use_sr).  lr is negated first; every product and sum is a separately
// rounded __fmul_rn / __fadd_rn, every sqrt and division __fsqrt_rn /
// __fdiv_rn:
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
// with a 16-bit state S, `b m` and `b v` are decay<S> and every state is
// stored rounded to S after the step has used its f32 value.
//
// (1 - b) is 1.f - b in f32 when PER_ID (_bwd_body computes it in the
// kernel, pallas_tbe_backward.py:252), else the host-double h.omb.  Every
// state row is read once (load_vals) and written once at the end (the
// rowwise state by lane 0).  Addresses are 64-bit.
template <typename T, typename S, bool VEC, int NC, int OPT, bool PER_ID>
__device__ __forceinline__ void update_row(float (&g)[NC], RowVals<NC>& x,
                                           int row, int lane, int D,
                                           T* __restrict__ table,
                                           S* __restrict__ s0,
                                           S* __restrict__ s1,
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
  S* mrow = kElemM ? s0 + (int64_t)row * D : nullptr;
  S* vrow = kElemV ? s1 + (int64_t)row * D : nullptr;
  float row_state = x.row_state;
  float(&w)[NC] = x.w;
  float(&m)[NC] = x.m;
  float(&v)[NC] = x.v;
  if (h.wd != 0.f) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      g[k] = __fadd_rn(g[k], __fmul_rn(h.wd, w[k]));
    }
  }

  const float neg_lr = -h.lr;
  float delta[NC];  // per column: the value added to w
  if constexpr (OPT == kSgd) {
#pragma unroll
    for (int k = 0; k < NC; ++k) delta[k] = __fmul_rn(neg_lr, g[k]);
  } else if constexpr (OPT == kLarsSgd) {
    const float t = trust_ratio(__fsqrt_rn(sum_sq<VEC>(w, lane, D)),
                                __fsqrt_rn(sum_sq<VEC>(g, lane, D)));
    const float a = __fmul_rn(neg_lr, t);
#pragma unroll
    for (int k = 0; k < NC; ++k) delta[k] = __fmul_rn(a, g[k]);
  } else if constexpr (OPT == kAdagrad) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      m[k] = __fadd_rn(m[k], __fmul_rn(g[k], g[k]));
      delta[k] = __fdiv_rn(__fmul_rn(neg_lr, g[k]),
                           __fadd_rn(__fsqrt_rn(m[k]), h.eps));
    }
  } else if constexpr (OPT == kRowwiseAdagrad) {
    const float ss = sum_sq<VEC>(g, lane, D);
    row_state = __fadd_rn(row_state, __fdiv_rn(ss, (float)D));
    const float den = __fadd_rn(__fsqrt_rn(row_state), h.eps);
    if constexpr (PER_ID) {
      const float scale = __fdiv_rn(neg_lr, den);
#pragma unroll
      for (int k = 0; k < NC; ++k) delta[k] = __fmul_rn(scale, g[k]);
    } else {
      const float scale = __fdiv_rn(1.f, den);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        delta[k] = __fmul_rn(__fmul_rn(neg_lr, g[k]), scale);
      }
    }
  } else {  // the adam family
    const float omb1 = PER_ID ? __fsub_rn(1.f, h.b1) : h.omb1;
    const float omb2 = PER_ID ? __fsub_rn(1.f, h.b2) : h.omb2;
    const float sqbc2 = __fsqrt_rn(h.bc2);
    float vpe_row = 0.f;
    if constexpr (kRowV) {
      const float ss = sum_sq<VEC>(g, lane, D);
      row_state = __fadd_rn(decay<S>(h.b2, row_state),
                            __fmul_rn(omb2, __fdiv_rn(ss, (float)D)));
      vpe_row = __fadd_rn(__fdiv_rn(__fsqrt_rn(row_state), sqbc2), h.eps);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      m[k] = __fadd_rn(decay<S>(h.b1, m[k]), __fmul_rn(omb1, g[k]));
      float vpe = vpe_row;
      if constexpr (kElemV) {
        v[k] = __fadd_rn(decay<S>(h.b2, v[k]),
                         __fmul_rn(__fmul_rn(omb2, g[k]), g[k]));
        vpe = __fadd_rn(__fdiv_rn(__fsqrt_rn(v[k]), sqbc2), h.eps);
      }
      delta[k] = __fdiv_rn(__fdiv_rn(m[k], h.bc1), vpe);  // dir
    }
    if constexpr (kLambTrust) {
      const float t = trust_ratio(__fsqrt_rn(sum_sq<VEC>(w, lane, D)),
                                  __fsqrt_rn(sum_sq<VEC>(delta, lane, D)));
#pragma unroll
      for (int k = 0; k < NC; ++k) delta[k] = __fmul_rn(delta[k], t);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) delta[k] = __fmul_rn(neg_lr, delta[k]);
  }

#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = column<VEC>(lane, k, D);
    if (c >= 0) {
      store(wrow + c, __fadd_rn(w[k], delta[k]), use_sr, seed,
            (uint32_t)row, (uint32_t)c);
      if constexpr (kElemM) store_state(mrow + c, m[k]);
      if constexpr (kElemV) store_state(vrow + c, v[k]);
    }
  }
  if (lane == 0) {
    if constexpr (OPT == kRowwiseAdagrad) store_state(s0 + row, row_state);
    if constexpr (kRowV) store_state(s1 + row, row_state);
  }
}

// The fused backward + optimizer over the sorted stream (the grid and the
// walk above).  queue: the two uint32 counters of the work queue, both 0 at
// launch and again at exit.
template <typename T, typename S, int LAYOUT, int OPT, bool PER_ID>
__global__ void __launch_bounds__(kThreads, LAYOUT == kNarrow ? kMinBlocks : 1)
    fused_update_kernel(Slots sl, T* __restrict__ table,
                        S* __restrict__ s0, S* __restrict__ s1,
                        Hyper h, int use_sr, uint32_t seed,
                        unsigned* __restrict__ queue) {
  constexpr bool VEC = LAYOUT != kScalar;
  constexpr int NC = LAYOUT == kNarrow ? 4 : kMaxCols;
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned claim = 0;
    if (lane == 0) claim = atomicAdd(queue, (unsigned)kWindow);
    const int64_t base = __shfl_sync(kFull, claim, 0);
    if (base >= sl.V) break;
    const int64_t p = base + lane;
    const bool live = p < sl.V;
    const int r = live ? __ldg(sl.rows + p) : sl.R;
    const int seg = live ? __ldg(sl.segs + p) : 0;
    const float wt = live ? __ldg(sl.w + p) : 0.f;
    // the window starts on the sentinel: every later one does too
    if (__shfl_sync(kFull, r, 0) >= sl.R) break;
    int prev = __shfl_up_sync(kFull, r, 1);
    if (lane == 0) prev = base > 0 ? __ldg(sl.rows + base - 1) : -1;
    unsigned starts = __ballot_sync(kFull, r < sl.R && r != prev);
    while (starts) {
      const int k = __ffs(starts) - 1;
      starts &= starts - 1;
      const int row = __shfl_sync(kFull, r, k);
      RowVals<NC> x;
      load_vals<T, S, VEC, NC, OPT>(x, row, lane, sl.D, table, s0, s1);
      float g[NC];
      sum_run<VEC, NC>(g, sl, base, k, row, r, seg, wt, lane);
      update_row<T, S, VEC, NC, OPT, PER_ID>(g, x, row, lane, sl.D, table,
                                             s0, s1, h, use_sr != 0, seed);
    }
  }
  // the last warp out leaves the queue at 0 for the next launch
  if (lane == 0) {
    const unsigned warps = gridDim.x * kWarpsPerBlock;
    if (atomicAdd(queue + 1, 1u) == warps - 1) {
      atomicExch(queue, 0u);
      atomicExch(queue + 1, 0u);
    }
  }
}

// the instantiation for (optimizer, table type T, state type S, layout),
// or null for an unknown code or a 16-bit state of a stateless optimizer
template <typename T, typename S, int LAYOUT, bool PER_ID>
const void* kernel_for(int optim) {
#define TRTPU_CASE(OPT) \
  case OPT: return (const void*)fused_update_kernel<T, S, LAYOUT, OPT, PER_ID>
  if constexpr (std::is_same<S, float>::value) {
    switch (optim) {
      TRTPU_CASE(kSgd);
      TRTPU_CASE(kLarsSgd);
      default: break;
    }
  }
  switch (optim) {
    TRTPU_CASE(kAdagrad);
    TRTPU_CASE(kRowwiseAdagrad);
    TRTPU_CASE(kAdam);
    TRTPU_CASE(kPartialRowwiseAdam);
    TRTPU_CASE(kLamb);
    TRTPU_CASE(kPartialRowwiseLamb);
    default: return nullptr;
  }
#undef TRTPU_CASE
}

template <typename T, typename S, bool PER_ID>
const void* kernel_for(int optim, int layout) {
  switch (layout) {
    case kNarrow: return kernel_for<T, S, kNarrow, PER_ID>(optim);
    case kWide: return kernel_for<T, S, kWide, PER_ID>(optim);
    case kScalar: return kernel_for<T, S, kScalar, PER_ID>(optim);
    default: return nullptr;
  }
}

template <typename T, bool PER_ID>
const void* kernel_for_state(int optim, int sdtype, int layout) {
  switch (sdtype) {
    case 0: return kernel_for<T, float, PER_ID>(optim, layout);
    case 1: return kernel_for<T, __nv_bfloat16, PER_ID>(optim, layout);
    case 2: return kernel_for<T, __half, PER_ID>(optim, layout);
    default: return nullptr;
  }
}

// dtype: the table's, 0 = float32, 1 = bfloat16; sdtype: the optimizer
// state's, 0 = float32, 1 = bfloat16, 2 = float16
template <bool PER_ID>
const void* kernel_for(int optim, int dtype, int sdtype, int D) {
  if (D > 32 * kMaxCols) return nullptr;
  const int layout = layout_for(D);
  if (dtype == 0) return kernel_for_state<float, PER_ID>(optim, sdtype, layout);
  if (dtype == 1) {
    return kernel_for_state<__nv_bfloat16, PER_ID>(optim, sdtype, layout);
  }
  return nullptr;
}

// The blocks of `fn` resident on the current device at once (its occupancy
// at kThreads times the SMs), read once per (kernel, device) and cached;
// 0 on an error.
inline int resident_blocks(const void* fn) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(fn, dev);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return cache[key] = per_sm * sms;
}

// the launch's blocks for V sorted positions: the resident blocks, but no
// more warps than windows
inline int grid_blocks(const void* fn, int V) {
  const int64_t windows = ((int64_t)V + kWindow - 1) / kWindow;
  const int64_t wanted = (windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int most = resident_blocks(fn);
  return (int)(wanted < most ? wanted : most);
}

// Launch the instantiation for (optim, dtype, sdtype, D) on `stream`; returns
// cudaGetLastError() as an int (0 = launched).
template <bool PER_ID>
int launch(const Slots& sl, void* table, void* s0, void* s1,
           unsigned* queue, int optim, int dtype, int sdtype, const Hyper& h,
           int use_sr, int seed, cudaStream_t stream) {
  const void* fn = kernel_for<PER_ID>(optim, dtype, sdtype, sl.D);
  if (fn == nullptr || queue == nullptr) return (int)cudaErrorInvalidValue;
  if (sl.V > 0) {
    const int blocks = grid_blocks(fn, sl.V);
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    int sr = dtype == 1 ? use_sr : 0;
    uint32_t sd = (uint32_t)seed;
    void* args[] = {(void*)&sl, &table, &s0, &s1, (void*)&h, &sr, &sd,
                    &queue};
    const cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)blocks),
                                             dim3(kThreads), args, 0, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// What a launch for (optim, dtype, sdtype, D) over V positions takes: out[0] the
// registers a thread uses, out[1] the blocks, out[2] the resident blocks
// per SM, out[3] the layout (Layout).  Returns 0, or a CUDA error code.
template <bool PER_ID>
int kernel_info(int optim, int dtype, int sdtype, int D, int V, int* out) {
  const void* fn = kernel_for<PER_ID>(optim, dtype, sdtype, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = V > 0 ? grid_blocks(fn, V) : 0;
  out[2] = per_sm;
  out[3] = layout_for(D);
  return 0;
}

}  // namespace bwd
