// Pooled embedding lookup over float32 / bfloat16 / float16 tables for Hopper
// (sm_90a), bound to Python with ctypes through a plain C interface
// (torchrec_tpu_torch/ops/_native.py builds this file with nvcc at first use).
//
//   tbe_pooled   replaces torchrec_tpu/ops/pallas_tbe.py
//                ::tbe_pooled_forward_sorted (kernel body _tbe_body, input
//                preparation _sort_pad_inputs, wrapper
//                pallas_pooled_embedding_lookup)
//
// It computes out[e, :] = O( sum_i f32(table[clip(id_i), :]) * w_i ) over
// the slots i of segment e in slot order, accumulating in f32, with ids
// clipped to [0, R - 1] (pool::clip, on the id as it comes, int32 or int64)
// and w_i = 1 when no weights are given.  O is the table's dtype T, or
// float32 for a bfloat16 or float16 table (the serving tables, read in
// place: the f32 sums are stored as they are, with no cast kernel and no
// float32 copy of the table).  Output row e starts at out + e * ld (ld >=
// D), so a caller can write one feature's columns of a wider buffer.
//
// Input: the caller's own slot layout, no sort.  The TPU kernel walks a
// segment-sorted, chunk-padded stream on a sequential grid; a warp here
// needs only each segment's slot range.  A stream is a set of regions:
// region k is the slots [start_k, start_k + cap_k), front-packed in example
// order by its count_k examples, whose lengths are entries [base_k, base_k
// + count_k) of the lengths array; example e (an index into lengths) is
// output segment e.  `ends` is the running sum of the whole lengths array
// (one cumsum), so example e of region k owns the slots
//
//   [start_k + lo, start_k + max(hi, lo)),  lo = clip(E[e-1] - E[base_k-1]),
//                                           hi = clip(E[e]   - E[base_k-1])
//
// with E[-1] = 0 and clip to [0, cap_k]: the slots that per_slot_segments
// (parallel/sharding/common.py) and KeyedJaggedTensor.segment_ids give the
// example, cut at the cap.  The table-wise layout [N, F, C] is N * F
// regions of cap C; a KeyedJaggedTensor's keys are regions at its
// cap_offsets.  A stream in any order takes the wrapper's stable segment
// sort first and is one region whose ends are the CSR offsets.
//
// What bounds it on an H100: bytes, and the latency of each slot's chain
// of dependent loads (its segment's ends, then its id and weight, then the
// row).  The bytes are each valid slot's row, its id and weight, and the
// output [S, D] written once, zeros included (on the bench's training
// batch, 54 MB of the 83 MB); 2 flops per slot and column are far below
// the card's f32 ridge.  The first design gave a segment one warp with one
// row load outstanding, so on the training and EBC batches (0 or 1 slot a
// segment) each of ~100k warps waited out one chain, half of them only to
// write zeros.
//
// Design: owner warps, two kernels, one launch.  A warp owns a run of `run` consecutive segments of one region,
// run = kRunSlots / the region's slots per segment by its cap (rounded up),
// between 1 and 32.
//   * Runs of more than one (the training and EBC batches, at most one slot
//     a segment: runs of 8): lane j loads segment j's ends, a warp scan of
//     the counts lays the run's slots out as one stream, and walk_run walks
//     it: 32 slots' ids and weights fetched a lane each, the next 32 ahead,
//     kWalkDepth row loads in flight before the first add, the adds in
//     slot order, each segment's sums rounded once to T and written when
//     its last slot is added, zeros for an empty segment.
//   * When every region of a launch has runs of one (the bucketed batch,
//     the multi-hot MLPerf DLRM-v2 stream), one warp per segment adds its
//     slots one by one, under a register bound that keeps the SM's 64
//     warps resident: with segments of ~10 slots, resident warps, not rows
//     in flight, hide the chains (walk with 1 to 4 rows in flight, and
//     fewer resident warps, was 2-14% slower there).
// Each output row is written once by its owner: no atomics.  For D a
// multiple of 4 and table and output aligned to 4 values each lane owns 4
// columns of a 128-column block (one 16-byte load of f32, 8 bytes of
// bf16), otherwise one column of a 32-column block.  The regions travel as
// a kernel parameter (at most kMaxRegions a launch: the wrapper splits a
// longer list and counts each launch),
// block row y of the grid is region y, so nothing is copied to the card
// and the wrapper never waits for it.  The constants below were the
// fastest of a sweep at the four shapes of chip_smoke.py's B1 rows
// (PERF.md section 6).
//
// Rounding: each row element is widened to f32, multiplied by the f32
// weight (__fmul_rn) and added to the accumulator (__fadd_rn), slot by
// slot, as _tbe_body does (pallas_tbe.py:176-180); the sum is rounded once
// to the output's dtype (round to nearest even; none for float32).  The
// widening is exact, so a 16-bit table pooled into float32 gives the bits
// of the same kernel over table.float().  The plain PyTorch versions
// (torchrec_tpu_torch/ops/tbe.py::pooled_lookup_plain and
// pooled_lookup_regions_plain) do the same operations in the same order,
// so on the card kernel and plain versions are bitwise equal.  Row
// addresses are 64-bit (id * D).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_cols.cuh"

namespace {

// the runs kernel: rows in flight in a warp's walk, the slots a run is
// sized for and the blocks an SM its registers are bounded for; the
// segments kernel's blocks an SM; warps a block
constexpr int kWalkDepth = 8;
constexpr int kRunSlots = 8;
constexpr int kMinBlocks = 8;
constexpr int kSegMinBlocks = 16;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxRegions = 128;

struct Region {
  int start;  // its first slot in the slot stream
  int cap;    // its slots
  int base;   // its first example's index in lengths (its first segment)
  int count;  // its examples
  int run;    // segments a warp owns
};

struct Regions {
  Region r[kMaxRegions];
};
static_assert(sizeof(Regions) <= 4000, "Regions must fit 4 KB of parameters");

// B1's rows: the table's, at each slot's id clipped to the table.
template <typename T, int VEC, typename Id>
struct IdRows {
  static constexpr int kDepth = kWalkDepth;
  static constexpr int kVec = VEC;
  static constexpr bool kSide = false;
  using Cols = pool::TableCols<T, VEC>;
  using Raw = typename Cols::Raw;
  const Id* ids;
  const T* table;
  long long last;  // rows - 1
  int D;
  __device__ long long key(long long i) const {
    return (long long)__ldg(ids + i);
  }
  __device__ int row(long long k) const { return (int)pool::clip(k, last); }
  __device__ Raw load(int r, int c) const { return Cols::load(table, D, r, c); }
  __device__ void add(float (&acc)[VEC], Raw raw, float w) const {
    Cols::add(acc, raw, w);
  }
};

// Example e of region rg: its slots, clipped to the region's cap.
template <typename End>
__device__ __forceinline__ void slots_of(const Region& rg,
                                         const End* __restrict__ ends,
                                         long long origin, long long e,
                                         int& begin, int& end) {
  const long long prev = e ? (long long)__ldg(ends + e - 1) : 0;
  const long long lo = pool::clip(prev - origin, rg.cap);
  const long long hi = pool::clip((long long)__ldg(ends + e) - origin,
                                  rg.cap);
  begin = rg.start + (int)lo;
  end = rg.start + (int)max(hi, lo);
}

// RUNS: one warp per run of segments of region blockIdx.y (their slot
// ranges from the ends, then every column block walked over the run's
// slots, walk_run); else one warp per segment, slot by slot, for launches
// whose regions all have runs of one.
template <typename T, typename O, int VEC, typename Id, typename End,
          bool RUNS>
__global__ void __launch_bounds__(kThreads, RUNS ? kMinBlocks : kSegMinBlocks)
    tbe_pooled_kernel(const __grid_constant__ Regions g,
                      const T* __restrict__ table,
                      const Id* __restrict__ ids,
                      const float* __restrict__ w,
                      const End* __restrict__ ends, O* __restrict__ out,
                      int D, long long rows, long long ld) {
  const Region& rg = g.r[blockIdx.y];
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
      (RUNS ? rg.run : 1);
  if (first >= rg.count) return;
  const int lane = threadIdx.x & 31;
  const long long e0 = rg.base + first;
  const long long origin = rg.base ? (long long)__ldg(ends + rg.base - 1) : 0;
  using Cols = pool::TableCols<T, VEC, O>;
  if constexpr (RUNS) {
    const int n = (int)min((long long)rg.run, rg.count - first);
    int begin = rg.start, end = rg.start;
    if (lane < n) slots_of(rg, ends, origin, e0 + lane, begin, end);
    const IdRows<T, VEC, Id> src{ids, table, rows - 1, D};
    O* run_out = out + e0 * ld;
    for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
      const int c = c0 + lane * VEC;
      const bool active = c < D;
      pool::walk_run(src, begin, end, lane < n, w, lane, c, active,
                     [&](int j, const float (&acc)[VEC]) {
                       if (active) {
                         Cols::store(run_out + (long long)j * ld + c, acc);
                       }
                     });
    }
  } else {
    int begin, end;
    slots_of(rg, ends, origin, e0, begin, end);
    const IdRows<T, VEC, Id> src{ids, table, rows - 1, D};
    O* orow = out + e0 * ld;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
      for (int i = begin; i < end; ++i) {
        src.add(acc, src.load(src.row(src.key(i)), c),
                w ? __ldg(w + i) : 1.f);
      }
      Cols::store(orow + c, acc);
    }
  }
}

template <typename T, typename O, int VEC, typename Id, bool RUNS>
const void* pick_end(int end64) {
  return end64
             ? (const void*)tbe_pooled_kernel<T, O, VEC, Id, long long, RUNS>
             : (const void*)tbe_pooled_kernel<T, O, VEC, Id, int, RUNS>;
}

template <typename T, typename O, int VEC, bool RUNS>
const void* pick_id(int id64, int end64) {
  return id64 ? pick_end<T, O, VEC, long long, RUNS>(end64)
              : pick_end<T, O, VEC, int, RUNS>(end64);
}

template <typename T, typename O, bool RUNS>
const void* pick_vec(int vec, int id64, int end64) {
  return vec ? pick_id<T, O, 4, RUNS>(id64, end64)
             : pick_id<T, O, 1, RUNS>(id64, end64);
}

template <typename T, typename O>
const void* pick_runs(int runs, int vec, int id64, int end64) {
  return runs ? pick_vec<T, O, true>(vec, id64, end64)
              : pick_vec<T, O, false>(vec, id64, end64);
}

// The instantiation for a table dtype and an output dtype (0 float32, 1
// bfloat16, 2 float16; the output is the table's dtype or float32), the
// runs kernel or the segments one, the vector path (vec: 4 columns a
// lane), int64 ids and int64 ends; null for another pair of dtypes.
const void* kernel_for(int dtype, int out_dtype, int runs, int vec, int id64,
                       int end64) {
  if (out_dtype == dtype) {
    switch (dtype) {
      case 0:
        return pick_runs<float, float>(runs, vec, id64, end64);
      case 1:
        return pick_runs<__nv_bfloat16, __nv_bfloat16>(runs, vec, id64,
                                                       end64);
      case 2:
        return pick_runs<__half, __half>(runs, vec, id64, end64);
    }
  } else if (out_dtype == 0) {
    switch (dtype) {
      case 1:
        return pick_runs<__nv_bfloat16, float>(runs, vec, id64, end64);
      case 2:
        return pick_runs<__half, float>(runs, vec, id64, end64);
    }
  }
  return nullptr;
}

inline size_t dtype_size(int dtype) { return dtype == 0 ? 4 : 2; }

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// One launch over at most kMaxRegions regions holding at least one
// example, on `stream`; returns the launch error (cudaGetLastError()) as
// an int, 0 when the launch was taken.  `regions` is a host array of 4
// int64 per region: its start, cap, base and count (base is the region's
// first example in the whole lengths array, so a longer list is launched
// in pieces of kMaxRegions).
// `dtype` is 0 for float32, 1 for bfloat16 and 2 for float16 tables;
// `out_dtype` the output's, the table's or 0 (float32); the output is [S,
// D] with row stride `ld` (>= D) values.  id64 / end64 say whether ids /
// ends are int64 (else int32); w is float32 or null (every weight 1).
// Pointers are device pointers; the Python wrapper has checked devices,
// dtypes, shapes and contiguity.
int tbe_pooled(const void* table, const void* ids, int id64, const void* w,
               const void* ends, int end64, const long long* regions,
               int num_regions, void* out, int D, long long rows, int dtype,
               int out_dtype, long long ld, void* stream) {
  if (ld < D) return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && ld % 4 == 0 &&
                  aligned(table, 4 * dtype_size(dtype)) &&
                  aligned(out, 4 * dtype_size(out_dtype));
  if (num_regions < 1 || num_regions > kMaxRegions)
    return (int)cudaErrorInvalidValue;
  Regions g;
  int runs = 0;  // some region has runs of more than one example
  for (int k = 0; k < num_regions; ++k) {
    const long long* f = regions + 4 * (long long)k;
    Region& rg = g.r[k];
    rg.start = (int)f[0];
    rg.cap = (int)f[1];
    rg.base = (int)f[2];
    rg.count = (int)f[3];
    const long long per =
        rg.count ? ((long long)rg.cap + rg.count - 1) / rg.count : 1;
    const long long run = kRunSlots / (per > 0 ? per : 1);
    rg.run = (int)(run < 1 ? 1 : (run > 32 ? 32 : run));
    runs |= rg.count > 0 && rg.run > 1;
  }
  long long blocks = 0;
  for (int k = 0; k < num_regions; ++k) {
    const Region& rg = g.r[k];
    const long long per = runs ? rg.run : 1;
    const long long warps = ((long long)rg.count + per - 1) / per;
    const long long b = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    blocks = b > blocks ? b : blocks;
  }
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(dtype, out_dtype, runs, vec, id64, end64);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&g, (void*)&table, (void*)&ids, (void*)&w,
                  (void*)&ends, &out, &D, &rows, &ld};
  const cudaError_t err =
      cudaLaunchKernel(fn, dim3((unsigned)blocks, (unsigned)num_regions),
                       dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the instantiation for (dtype, out_dtype, runs, vec, id64, end64)
// takes on this card: out[0] the registers a thread uses, out[1] the
// resident blocks per SM.  Returns 0, or a CUDA error code.
int tbe_pooled_info(int dtype, int out_dtype, int runs, int vec, int id64,
                    int end64, int* out) {
  const void* fn = kernel_for(dtype, out_dtype, runs, vec, id64, end64);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  return 0;
}

}  // extern "C"
