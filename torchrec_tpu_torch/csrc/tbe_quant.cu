// Quantized pooled embedding lookups for Hopper (sm_90a), bound to Python
// with ctypes through a plain C interface (torchrec_tpu_torch/ops/_native.py
// builds this file with nvcc at first use).
//
// Two kernels, each the port of one Pallas TPU kernel:
//
//   q8_pooled              replaces torchrec_tpu/ops/pallas_tbe.py
//                          ::pallas_quantized_pooled_lookup (_tbe_kernel_q8)
//   dedup_q_keys +         replace torchrec_tpu/ops/pallas_tbe.py
//   dedup_q_gather +       ::pallas_ragged_dedup_quantized_lookup
//   dedup_q_pool           (_dedup_kernel_q, _unpack_lanes, and the keys of
//                          _dedup_prepare_inputs' sized sort-unique)
//
// Both compute out[s, :] = sum_i w_i * (q[id_i, :] * scale[id_i] + bias[id_i])
// over the slots of segment s, in slot order, in f32, ids clipped to the
// table.
//
// One launch for a group of features.  A served batch looks up every
// feature of the collection; the features that share a kernel, a width and
// a packed type form one group, and one launch serves all of them (at the
// MLPerf DLRM-v2 configuration, all 26: one launch per batch).  The group's
// features travel as a kernel parameter (struct Group, at most kMaxFeatures
// of them, under the 4 KB parameter limit), so the wrapper copies nothing
// to the card and never waits for it.  Segment s = f * B + b is example b of
// feature f.  Its slots are a range of the KeyedJaggedTensor's values
// buffer: the feature's region starts at f.start and holds f.cap slots,
// front-packed in example order, so segment (f, b) is [ends[b-1], ends[b])
// of the region with ends the running sum of the feature's lengths (one
// cumsum, no sort), clipped to the cap.  The output row of segment (f, b) is
// out[b, f.col : f.col + D] of the KeyedTensor's [B, sum D] buffer.  A
// per-table call is a group of one whose "region" is its segment-sorted slot
// stream, with a weight per slot.
//
// What bounds them on an H100: the latency of the longest segment's walk,
// not bytes.  A segment's output is owned by one warp (below), and each of
// its slots costs a chain of dependent loads: the id, then the row (and its
// scale and bias).  The MLPerf DLRM-v2 lengths put 100 ids in every
// cat_20 segment; walked one row at a time with the L2 cold, that warp waits
// about 100 device-memory round trips of 0.6-1 us, some 30x the time the
// bytes need (a batch's bytes take ~1-2 us at 3.35 TB/s).  So the design
// keeps many loads of one warp in flight:
//
//   * the lanes fetch a segment's slots 32 at a time, cooperatively: lane j
//     loads slot j's id and weight (and, in q8_pooled, its row's scale and
//     bias), and the next 32 slots' ids are loaded before the current ones
//     are consumed;
//   * a warp then issues the row loads of K slots (row indices broadcast
//     with __shfl_sync) before it consumes the first: K four-byte loads a
//     lane for int8 rows, K sixteen-byte loads for the f32 scratch.
//     K = kWalkDepth = 8, the fastest of 8, 16 and 32 when they were timed
//     (PERF.md section 6): a deeper walk holds more registers, and the
//     card then keeps fewer warps resident;
//   * only the loads overlap; the adds stay in slot order.
//
// So a 100-id segment waits about 4 x 5 round trips instead of 100.  The
// walk is pool_walk.cuh's, shared with the float dedup lookup (B4,
// tbe_dedup.cu).  A 16-byte-load path for int8 rows (16 columns a lane)
// was not added: at D = 128 a row is one 128-byte line whether 32 lanes
// load 4 bytes or 8 lanes load 16, and the walk's time is its round trips.
//
// Owner warps.  The TPU kernel walks id chunks on a SEQUENTIAL grid and
// flushes each segment run into HBM with a read-modify-write, race-free only
// because TPU grid steps run in order (pallas_tbe.py:16-18).  CTAs on Hopper
// run concurrently, so here each output segment has exactly one owner warp,
// which writes its output once: no atomics, no cross-CTA reduction, and an
// empty segment writes zeros.  For D % 4 == 0 (and 4-byte aligned rows)
// each lane owns 4 consecutive columns of a 128-column block, otherwise one
// column of a 32-column block.
//
// Dedup (B5), no host sync.  The wrapper builds a key per slot
// (feature << 32 | id + 2^31 for a valid slot, INT64_MAX for the others:
// the dedup_q_keys kernel for a group, torch ops for a per-table call, whose
// feature is 0), then one torch.sort of the keys, boundary
// flags and a cumsum give the sorted distinct keys and each slot's index
// into them; the number of distinct keys U stays on the device.  Then
//   dedup_q_gather: each distinct row unpacked and dequantized once into an
//     f32 scratch [N, D] (N, the slot count, is the static size); one thread
//     per 4-byte word of a packed row (4 int8, 8 int4 or 16 int2 codes, in
//     unpack_rows' interleaved low-bits-first order), float4 stores; a
//     grid-stride loop (8 blocks per SM) that stops at the first sentinel
//     key, so its grid is sized by the card, not by U;
//   dedup_q_pool: the walk above over the scratch through each slot's index.
// The scratch has no budget (the TPU kernel's 8 MiB VMEM budget,
// pallas_tbe.py:715, has no counterpart); how much of it stays in the 50 MB
// L2 between the two launches is not measured.  Only its first U rows are
// written.  U is not bounded by the tables' rows: the keys hold the ids
// before clipping, as the reference's unique does, so two out-of-range ids
// are two keys.
//
// Rounding: every product and sum is a separately rounded __fmul_rn /
// __fadd_rn, in the order v = q*s + b, acc = acc + v*w, slot by slot; a MEAN
// feature's weight is __fdiv_rn(1, len), as mean_pooling_weights computes
// it.  The plain PyTorch versions beside the wrappers
// (torchrec_tpu_torch/ops/tbe.py) do the same operations in the same order,
// so on the card kernel and plain version are bitwise equal.
//
// Row addresses are computed in 64 bits: id * D overflows int32 on the
// 40M-row MLPerf tables (40e6 * 128 = 5.1e9).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pool_walk.cuh"

namespace {

using pool::accum;
using pool::clip;
using pool::kIdBias;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxFeatures = 48;
constexpr long long kSentinel = 0x7fffffffffffffffLL;
// the rows in flight in a warp's walk (above)
constexpr int kWalkDepth = 8;
// the grid-stride loops: this many blocks on each SM of the card
constexpr int kBlocksPerSm = 8;

// One feature of a group (9 int64 values per feature from the wrapper).
struct Feature {
  const uint8_t* q;    // its table's packed rows [rows, Dp]
  const float* scale;  // [rows]
  const float* bias;   // [rows]
  long long rows;
  long long start;  // first slot of its region in the slot stream
  long long cap;    // slots in the region
  int lrow;         // its row of ends [*, B]
  int col;          // its first output column
  int mean;         // 1: each slot weighs 1 / the example's length
  int pad_;
};

struct Group {
  Feature f[kMaxFeatures];
  int num_features;
  int B;  // segments per feature (examples)
  int D;  // output columns per feature
  int Dp;  // packed bytes per table row
  long long ld;  // output row stride
};
static_assert(sizeof(Group) <= 4000, "Group must fit the 4 KB parameter space");

__device__ __forceinline__ float dequant(float code, float s, float b) {
  return __fadd_rn(__fmul_rn(code, s), b);
}

// Segment s of the group: its slot range, its weight when no per-slot
// weights are given, its feature and its output row.
struct Segment : pool::Slots {
  int f;
  long long out;  // offset of out[b, f.col]
};

__device__ __forceinline__ Segment segment_of(const Group& g,
                                              const int* __restrict__ ends,
                                              long long s) {
  Segment sg;
  sg.f = (int)(s / g.B);
  const int b = (int)(s - (long long)sg.f * g.B);
  const Feature& ft = g.f[sg.f];
  const int* e = ends + (long long)ft.lrow * g.B;
  const long long hi = e[b];
  const long long lo = b ? e[b - 1] : 0;
  sg.begin = ft.start + min(lo, ft.cap);
  sg.end = ft.start + min(max(hi, lo), ft.cap);
  const long long len = hi - lo;
  sg.w = !ft.mean ? 1.f : (len > 0 ? __fdiv_rn(1.f, (float)len) : 0.f);
  sg.out = (long long)b * g.ld + ft.col;
  return sg;
}

// B3's rows: int8 codes of the feature's table, dequantized per slot.
// key = the slot's id, row = the id clipped to the table.
template <int VEC>
struct Q8Rows {
  static constexpr int kDepth = kWalkDepth;
  static constexpr int kVec = VEC;
  static constexpr bool kSide = true;  // scale and bias per row
  using Raw = uint32_t;
  const long long* ids;
  const uint8_t* q;
  const float* scale;
  const float* bias;
  long long last;  // rows - 1
  int D;
  __device__ long long key(long long i) const { return __ldg(ids + i); }
  __device__ int row(long long k) const { return (int)clip(k, last); }
  __device__ void side(int r, float& s, float& b) const {
    s = __ldg(scale + r);
    b = __ldg(bias + r);
  }
  __device__ Raw load(int r, int c) const {
    const uint8_t* p = q + (long long)r * D + c;
    if constexpr (VEC == 4) {
      return __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      return __ldg(p);
    }
  }
  __device__ void add(float (&acc)[VEC], Raw raw, float s, float b,
                      float w) const {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[v] = accum(acc[v], dequant((float)((raw >> (8 * v)) & 0xffu), s, b),
                     w);
    }
  }
};

// B5's rows: the f32 scratch of distinct rows, through each slot's index.
template <int VEC>
struct ScratchRows {
  static constexpr int kDepth = kWalkDepth;
  static constexpr int kVec = VEC;
  static constexpr bool kSide = false;
  using Raw = typename std::conditional<VEC == 4, float4, float>::type;
  const long long* uidx;
  const float* rows;
  int D;
  __device__ long long key(long long i) const { return __ldg(uidx + i); }
  __device__ int row(long long k) const { return (int)k; }
  __device__ void side(int, float&, float&) const {}
  __device__ Raw load(int r, int c) const {
    return __ldg(reinterpret_cast<const Raw*>(rows + (long long)r * D + c));
  }
  __device__ void add(float (&acc)[VEC], Raw raw, float, float,
                      float w) const {
    if constexpr (VEC == 4) {
      acc[0] = accum(acc[0], raw.x, w);
      acc[1] = accum(acc[1], raw.y, w);
      acc[2] = accum(acc[2], raw.z, w);
      acc[3] = accum(acc[3], raw.w, w);
    } else {
      acc[0] = accum(acc[0], raw, w);
    }
  }
};

// One warp per segment of the group: every column block of the segment's
// output, each walked over the segment's slots.
template <class Src>
__device__ __forceinline__ void pool_segment(const Group& g, Src src,
                                             const int* __restrict__ ends,
                                             const float* __restrict__ w,
                                             float* __restrict__ out) {
  constexpr int VEC = Src::kVec;
  const long long s = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= (long long)g.num_features * g.B) return;
  const Segment sg = segment_of(g, ends, s);
  float* orow = out + sg.out;
  for (int c0 = 0; c0 < g.D; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < g.D;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    pool::walk(src, sg, w, lane, c, active, acc);
    if (active) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) orow[c + v] = acc[v];
    }
  }
}

// B3: int8 rows, dequantized per slot.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    q8_pooled_kernel(const __grid_constant__ Group g,
                     const long long* __restrict__ ids,
                     const float* __restrict__ w,
                     const int* __restrict__ ends, float* __restrict__ out) {
  const long long s = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (s >= (long long)g.num_features * g.B) return;
  const Feature& ft = g.f[(int)(s / g.B)];
  Q8Rows<VEC> src{ids, ft.q, ft.scale, ft.bias, ft.rows - 1, g.D};
  pool_segment(g, src, ends, w, out);
}

// B5, launch 3: the walk over the scratch of distinct rows.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    dedup_q_pool_kernel(const __grid_constant__ Group g,
                        const long long* __restrict__ uidx,
                        const float* __restrict__ w,
                        const int* __restrict__ ends,
                        const float* __restrict__ rows,
                        float* __restrict__ out) {
  ScratchRows<VEC> src{uidx, rows, g.D};
  pool_segment(g, src, ends, w, out);
}

// B5, launch 1: each slot's unique key (sentinel for a slot past its
// example lengths' sum or outside the group's regions).
__global__ void __launch_bounds__(kThreads)
    dedup_q_keys_kernel(const __grid_constant__ Group g,
                        const long long* __restrict__ ids,
                        const int* __restrict__ ends,
                        long long* __restrict__ keys, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long key = kSentinel;
    for (int f = 0; f < g.num_features; ++f) {
      const Feature& ft = g.f[f];
      const long long p = i - ft.start;
      if (p >= 0 && p < ft.cap) {
        const long long total =
            g.B ? ends[(long long)ft.lrow * g.B + g.B - 1] : 0;
        if (p < total) {
          const long long id = min(max(ids[i], -kIdBias), kIdBias - 1);
          key = ((long long)f << 32) + id + kIdBias;
        }
        break;
      }
    }
    keys[i] = key;
  }
}

// B5, launch 2: one thread per packed unit (a 4-byte word, or a byte when
// rows are not 4-byte aligned) of each distinct row; the keys are sorted, so
// a thread stops at its first sentinel.
template <int BITS, bool WORD>
__global__ void __launch_bounds__(kThreads)
    dedup_q_gather_kernel(const __grid_constant__ Group g,
                          const long long* __restrict__ ukeys,
                          float* __restrict__ rows, long long n) {
  constexpr int kUnit = WORD ? 4 : 1;
  constexpr int kCodes = kUnit * 8 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1;
  const int units = g.Dp / kUnit;
  const long long total = n * units;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long u = t / units;
    const int k = (int)(t - u * units);
    const long long key = __ldg(ukeys + u);
    if (key == kSentinel) break;
    const Feature& ft = g.f[(int)(key >> 32)];
    const long long r = pool::key_row(key, ft.rows - 1);
    const float s = __ldg(ft.scale + r), b = __ldg(ft.bias + r);
    const uint8_t* src = ft.q + r * g.Dp + (long long)k * kUnit;
    uint32_t word;
    if constexpr (WORD) {
      word = __ldg(reinterpret_cast<const unsigned int*>(src));
    } else {
      word = __ldg(src);
    }
    float* dst = rows + u * g.D + (long long)k * kCodes;
    if constexpr (kCodes % 4 == 0) {
#pragma unroll
      for (int e = 0; e < kCodes; e += 4) {
        *reinterpret_cast<float4*>(dst + e) = make_float4(
            dequant((float)((word >> (e * BITS)) & kMask), s, b),
            dequant((float)((word >> ((e + 1) * BITS)) & kMask), s, b),
            dequant((float)((word >> ((e + 2) * BITS)) & kMask), s, b),
            dequant((float)((word >> ((e + 3) * BITS)) & kMask), s, b));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kCodes; ++e) {
        dst[e] = dequant((float)((word >> (e * BITS)) & kMask), s, b);
      }
    }
  }
}

// The Group parameter from the wrapper's host array (9 int64 per feature:
// q, scale, bias, rows, start, cap, lengths row, column, mean); false if
// the group is empty or too large.
bool make_group(const long long* feats, int nf, int B, int D, int Dp,
                long long ld, Group* g) {
  if (nf < 1 || nf > kMaxFeatures) return false;
  *g = Group{};
  for (int i = 0; i < nf; ++i) {
    const long long* x = feats + 9 * i;
    Feature& f = g->f[i];
    f.q = reinterpret_cast<const uint8_t*>(x[0]);
    f.scale = reinterpret_cast<const float*>(x[1]);
    f.bias = reinterpret_cast<const float*>(x[2]);
    f.rows = x[3];
    f.start = x[4];
    f.cap = x[5];
    f.lrow = (int)x[6];
    f.col = (int)x[7];
    f.mean = (int)x[8];
  }
  g->num_features = nf;
  g->B = B;
  g->D = D;
  g->Dp = Dp;
  g->ld = ld;
  return true;
}

// every table of the group has rows that start on 4-byte boundaries
bool rows_word_aligned(const Group& g) {
  if (g.Dp % 4) return false;
  for (int i = 0; i < g.num_features; ++i) {
    if (reinterpret_cast<uintptr_t>(g.f[i].q) % 4) return false;
  }
  return true;
}

template <int BITS>
void launch_gather(bool word, unsigned grid, cudaStream_t st, const Group& g,
                   const long long* ukeys, float* rows, long long n) {
  if (word) {
    dedup_q_gather_kernel<BITS, true><<<grid, kThreads, 0, st>>>(g, ukeys,
                                                                 rows, n);
  } else {
    dedup_q_gather_kernel<BITS, false><<<grid, kThreads, 0, st>>>(g, ukeys,
                                                                  rows, n);
  }
}

unsigned blocks_for_warps(long long warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// a grid-stride loop over `threads`: at most kBlocksPerSm blocks per SM of
// the current device
unsigned blocks_for_threads(long long threads) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1) {
    sms = 1;
  }
  const long long most = (long long)sms * kBlocksPerSm;
  const long long b = (threads + kThreads - 1) / kThreads;
  return (unsigned)(b < most ? (b > 0 ? b : 1) : most);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Pointers are device pointers, but `feats`, a host array;
// the Python wrapper has checked devices, dtypes, shapes and contiguity.

// B3: out[b, col_f + c] for every segment (f, b) of the group.  w: a weight
// per slot, or null (then 1, or 1/len for a MEAN feature).
int q8_pooled(const long long* feats, int nf, int B, int D, long long ld,
              const void* ids, const void* w, const void* ends, void* out,
              void* stream) {
  Group g;
  if (!make_group(feats, nf, B, D, D, ld, &g)) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)nf * B;
  if (warps > 0) {
    const unsigned grid = blocks_for_warps(warps);
    cudaStream_t st = (cudaStream_t)stream;
    const long long* i = (const long long*)ids;
    const float* wp = (const float*)w;
    const int* e = (const int*)ends;
    float* o = (float*)out;
    if (D % 4 == 0 && rows_word_aligned(g)) {
      q8_pooled_kernel<4><<<grid, kThreads, 0, st>>>(g, i, wp, e, o);
    } else {
      q8_pooled_kernel<1><<<grid, kThreads, 0, st>>>(g, i, wp, e, o);
    }
  }
  return (int)cudaGetLastError();
}

// B5, launch 1: keys[i] for every slot i < n of the slot stream.
int dedup_q_keys(const long long* feats, int nf, int B, const void* ids,
                 const void* ends, void* keys, long long n, void* stream) {
  Group g;
  if (!make_group(feats, nf, B, 0, 0, 0, &g)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    dedup_q_keys_kernel<<<blocks_for_threads(n), kThreads, 0,
                          (cudaStream_t)stream>>>(
        g, (const long long*)ids, (const int*)ends, (long long*)keys, n);
  }
  return (int)cudaGetLastError();
}

// B5, launch 2: rows[u, :] for every distinct key ukeys[u] (u < n, up to
// the first sentinel).
int dedup_q_gather(const long long* feats, int nf, int D, int Dp, int bits,
                   const void* ukeys, void* rows, long long n, void* stream) {
  Group g;
  if (!make_group(feats, nf, 0, D, Dp, 0, &g)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const bool word = rows_word_aligned(g);
    const unsigned grid = blocks_for_threads(n * (word ? Dp / 4 : Dp));
    cudaStream_t st = (cudaStream_t)stream;
    const long long* k = (const long long*)ukeys;
    float* r = (float*)rows;
    switch (bits) {
      case 8: launch_gather<8>(word, grid, st, g, k, r, n); break;
      case 4: launch_gather<4>(word, grid, st, g, k, r, n); break;
      case 2: launch_gather<2>(word, grid, st, g, k, r, n); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// B5, launch 3: out[b, col_f + c] for every segment (f, b) of the group,
// from the scratch rows through uidx (a unique index per slot).
int dedup_q_pool(const long long* feats, int nf, int B, int D, long long ld,
                 const void* uidx, const void* w, const void* ends,
                 const void* rows, void* out, void* stream) {
  Group g;
  if (!make_group(feats, nf, B, D, 0, ld, &g)) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)nf * B;
  if (warps > 0) {
    const unsigned grid = blocks_for_warps(warps);
    cudaStream_t st = (cudaStream_t)stream;
    const long long* u = (const long long*)uidx;
    const float* wp = (const float*)w;
    const int* e = (const int*)ends;
    const float* r = (const float*)rows;
    float* o = (float*)out;
    if (D % 4 == 0) {
      dedup_q_pool_kernel<4><<<grid, kThreads, 0, st>>>(g, u, wp, e, r, o);
    } else {
      dedup_q_pool_kernel<1><<<grid, kThreads, 0, st>>>(g, u, wp, e, r, o);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
