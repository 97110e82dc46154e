// The owner warp's walks, shared by the pooled lookups that keep row loads
// in flight: walk (one segment's slots) for B3 and B5 (tbe_quant.cu) and
// B4 (tbe_dedup.cu), walk_run (the slots of a run of consecutive
// segments) for B1 (tbe_float.cu).  Each file's header says why the walk
// is shaped so; in short, a segment's output is owned by one warp, and
// each of its slots costs a chain of dependent loads (metadata, then the
// row), so the warp keeps many of them in flight:
//
//   * the lanes fetch a segment's slots 32 at a time, cooperatively: lane j
//     loads slot j's key and weight (and, where the rows have them, the
//     row's scale and bias), and the next 32 slots' keys are loaded before
//     the current ones are consumed;
//   * the warp then issues the row loads of Src::kDepth slots (row
//     indices broadcast with __shfl_sync) before it adds the first;
//   * only the loads overlap: the adds stay in slot order, each a
//     separately rounded __fmul_rn and __fadd_rn.
//
// A row source `Src` says where a slot's row comes from:
//   kDepth          rows in flight (a divisor of 32): a deeper walk holds
//                   more registers, and the card then keeps fewer warps
//                   resident, so each source has its own, the fastest
//                   when it was timed (PERF.md section 6)
//   kVec            columns a lane owns per column block (1 or 4)
//   kSide           whether each row has a scale and a bias
//   Raw             what one lane loads of a row for its kVec columns
//   key(i)          slot i's key (an id, or a dedup key)
//   row(key)        the row the key reads
//   side(r, s, b)   row r's scale and bias (when kSide)
//   load(r, c)      row r's columns [c, c + kVec)
//   add(acc, raw, s, b, w)   acc[v] += value v of raw, weighted by w
//                   (walk_run's sources have no side: add(acc, raw, w))

#pragma once

#include <cuda_runtime.h>

namespace pool {

constexpr unsigned kFull = 0xffffffffu;
// the dedup keys: feature << 32 | id + 2^31 for a valid slot
constexpr long long kIdBias = 1LL << 31;

__device__ __forceinline__ float accum(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

__device__ __forceinline__ long long clip(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// the table row of a dedup key: its id clipped to [0, last]
__device__ __forceinline__ long long key_row(long long key, long long last) {
  return clip((key & 0xffffffffLL) - kIdBias, last);
}

// A segment's slots [begin, end) of the slot stream, and the weight of
// every slot when no per-slot weights are given.
struct Slots {
  long long begin, end;
  float w;
};

// The walk of one segment's slots for the columns [c, c + Src::kVec) of
// one lane (active: the lane has columns in this block).  Every lane of
// the warp calls it together (the shuffles take the full warp).
template <class Src>
__device__ __forceinline__ void walk(const Src& src, const Slots& sg,
                                     const float* __restrict__ w, int lane,
                                     int c, bool active,
                                     float (&acc)[Src::kVec]) {
  constexpr int K = Src::kDepth;
  static_assert(32 % K == 0, "K must divide the warp");
  long long key_next = 0;
  float w_next = 0.f;
  if (sg.begin + lane < sg.end) {
    key_next = src.key(sg.begin + lane);
    w_next = w ? __ldg(w + sg.begin + lane) : sg.w;
  }
  for (long long base = sg.begin; base < sg.end; base += 32) {
    const int n = (int)min(32LL, sg.end - base);
    const int r_mine = src.row(key_next);
    const float w_mine = w_next;
    float s_mine = 0.f, b_mine = 0.f;
    if (Src::kSide && lane < n) src.side(r_mine, s_mine, b_mine);
    const long long nxt = base + 32 + lane;
    if (nxt < sg.end) {
      key_next = src.key(nxt);
      w_next = w ? __ldg(w + nxt) : sg.w;
    }
    for (int j0 = 0; j0 < n; j0 += K) {
      typename Src::Raw raw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = __shfl_sync(kFull, r_mine, j0 + k);
        raw[k] = (active && j0 + k < n) ? src.load(r, c)
                                        : typename Src::Raw{};
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float wi = __shfl_sync(kFull, w_mine, j0 + k);
        float s = 0.f, b = 0.f;
        if (Src::kSide) {
          s = __shfl_sync(kFull, s_mine, j0 + k);
          b = __shfl_sync(kFull, b_mine, j0 + k);
        }
        if (active && j0 + k < n) src.add(acc, raw[k], s, b, wi);
      }
    }
  }
}

// The walk of a run of up to 32 consecutive segments by their owner warp:
// lane j holds segment j's slots [begin, end) (mine: the lane holds a
// segment of the run).  The run's slots are walked as one stream, segment
// after segment, each in slot order, as walk walks one segment's: 32
// stream positions' keys and weights fetched a lane each (the next 32
// ahead), Src::kDepth row loads in flight, the adds in slot order.  After
// a segment's last slot the warp hands its sums to sink(j, acc), and it
// hands zeros to every empty segment.  A slot weighs w[slot], or 1 when w
// is null.  Short segments share the warp: 32 one-slot segments cost one
// fetch of keys and 32 / kDepth row round trips.
template <class Src, class Sink>
__device__ __forceinline__ void walk_run(const Src& src, int begin, int end,
                                         bool mine,
                                         const float* __restrict__ w,
                                         int lane, int c, bool active,
                                         const Sink& sink) {
  constexpr int K = Src::kDepth;
  constexpr int VEC = Src::kVec;
  static_assert(32 % K == 0, "K must divide the warp");
  static_assert(!Src::kSide, "a run's rows carry no scale or bias");
  // stream position p lies in segment j when first_j <= p < last_j
  const int count = end - begin;
  int last = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, last, o);
    if (lane >= o) last += v;
  }
  const int first = last - count;
  const int total = __shfl_sync(kFull, last, 31);
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (unsigned empty = __ballot_sync(kFull, mine && count == 0); empty;
       empty &= empty - 1) {
    sink(__ffs(empty) - 1, acc);
  }
  // lane-wise: the segment and slot of position p (j = the lanes whose
  // segments end at or before p)
  auto locate = [&](int p, int& seg, int& slot) {
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, last, j + step - 1) <= p) j += step;
    }
    seg = j;
    slot = __shfl_sync(kFull, begin, j) + p - __shfl_sync(kFull, first, j);
  };
  long long key_next = 0;
  float w_next = 0.f;
  int seg_next, slot;
  locate(lane, seg_next, slot);
  if (lane < total) {
    key_next = src.key(slot);
    w_next = w ? __ldg(w + slot) : 1.f;
  }
  int cur = -1;  // the segment being summed
  for (int base = 0; base < total; base += 32) {
    const int n = min(32, total - base);
    const int r_mine = src.row(key_next);
    const float w_mine = w_next;
    const int s_mine = seg_next;
    const int nxt = base + 32 + lane;
    locate(nxt, seg_next, slot);
    if (nxt < total) {
      key_next = src.key(slot);
      w_next = w ? __ldg(w + slot) : 1.f;
    }
    for (int j0 = 0; j0 < n; j0 += K) {
      typename Src::Raw raw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = __shfl_sync(kFull, r_mine, j0 + k);
        raw[k] = (active && j0 + k < n) ? src.load(r, c)
                                        : typename Src::Raw{};
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float wi = __shfl_sync(kFull, w_mine, j0 + k);
        const int sj = __shfl_sync(kFull, s_mine, j0 + k);
        if (j0 + k < n) {
          if (sj != cur) {
            if (cur >= 0) sink(cur, acc);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
            cur = sj;
          }
          if (active) src.add(acc, raw[k], wi);
        }
      }
    }
  }
  if (cur >= 0) sink(cur, acc);
}

}  // namespace pool
