// The serving lookups as torch.library operators (namespace trt), so that
// an exported program (torch.export, then AOTInductor) carries the port's
// hand-written Hopper kernels and a C++ process runs them with no Python.
//
// Each operator is the C entry point that ops/tbe.py's grouped serving
// wrappers launched through ctypes, behind a schema:
//
//   q8_pooled       B3, csrc/tbe_quant.cu::q8_pooled (one launch a group)
//   dedup_q_keys    B5, launch 1: the (feature, id) key of every slot
//   dedup_q_gather  B5, launch 2: each distinct row dequantized once
//   dedup_q_pool    B5, launch 3: pooled through the inverse index
//   tbe_pooled      B1, csrc/tbe_float.cu::tbe_pooled over one feature
//   dedup_pooled    B4, csrc/tbe_dedup.cu::dedup_pooled over one feature
//
// The sized sort-unique between B5's launches 1 and 2 stays aten ops
// (tbe.py::sized_unique), in the graph.  The tables go in as Tensor[]; the
// per-feature facts as int[] (5 a feature for the quantized groups: region
// start and cap, key, output column, MEAN).  The host array of the C entry
// points (9 int64 a feature: the tables' pointers and rows, then the facts)
// is built here from the tensors at each call, so no pointer is ever traced.
// The operators that write the KeyedTensor's [B, sum D] buffer mutate it
// (`Tensor(a!) out`): the compiled graph allocates the buffer once and each
// operator writes its columns, with no copy.
//
// The kernels launch on the current stream of the tensors' device.  This
// file includes no CUDA header: the stream comes through c10's device guard
// interface, and the kernel entry points are bound at run time by
// trt_ops_bind (ops/custom_ops.py::load_ops passes the addresses from the
// kernel libraries that ops/_native.py built), so the library builds with
// g++ on a machine with no CUDA toolkit; there the schemas register, and a
// call raises because no kernel is bound.  Each operator counts its launches
// (trt_ops_launches), whoever calls it: eager wrappers or a compiled
// package's proxy executor.
//
// Built by ops/_native.py with g++ against libtorch (-D_GLIBCXX_USE_CXX11_ABI
// as torch was built).  Only CUDA implementations are registered: a CPU
// export traces the plain PyTorch versions instead.

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <atomic>
#include <cstring>
#include <vector>

namespace {

using Q8Pooled = int (*)(const long long*, int, int, int, long long,
                         const void*, const void*, const void*, void*, void*);
using DedupQKeys = int (*)(const long long*, int, int, const void*,
                           const void*, void*, long long, void*);
using DedupQGather = int (*)(const long long*, int, int, int, int,
                             const void*, void*, long long, void*);
using DedupQPool = int (*)(const long long*, int, int, int, long long,
                           const void*, const void*, const void*, const void*,
                           void*, void*);
using TbePooled = int (*)(const void*, const void*, int, const void*,
                          const void*, int, const long long*, int, void*, int,
                          long long, int, int, long long, void*);
using DedupPooled = int (*)(const void*, const void*, const void*,
                            const void*, const void*, void*, long long, int,
                            long long, int, int, long long, void*);

enum Op {
  kQ8Pooled,
  kDedupQKeys,
  kDedupQGather,
  kDedupQPool,
  kTbePooled,
  kDedupPooled,
  kNumOps
};
const char* const kOpNames[kNumOps] = {"q8_pooled",    "dedup_q_keys",
                                       "dedup_q_gather", "dedup_q_pool",
                                       "tbe_pooled",   "dedup_pooled"};
std::atomic<void*> g_entry[kNumOps];
std::atomic<long long> g_launches[kNumOps];

// the facts of one feature of a quantized group
constexpr int kFacts = 5;  // start, cap, key, col, mean
// the C entry points' per-feature host array
constexpr int kFeat = 9;  // q, scale, bias, rows, start, cap, key, col, mean
// the float lookups' dtype codes (ops/_native.py::LOOKUP_DTYPES)
int lookup_dtype(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return 0;
    case at::kBFloat16: return 1;
    case at::kHalf: return 2;
    default: TORCH_CHECK(false, "trt: no float lookup of ", t);
  }
  return -1;
}

template <typename Fn>
Fn entry(Op op) {
  void* fn = g_entry[op].load();
  TORCH_CHECK(fn != nullptr, "trt::", kOpNames[op],
              ": no CUDA kernel bound (ops/custom_ops.py::load_ops binds "
              "the kernel libraries on a card)");
  return reinterpret_cast<Fn>(fn);
}

void* stream_of(const at::Tensor& t) {
  return c10::impl::getDeviceGuardImpl(t.device().type())
      ->getStream(t.device())
      .native_handle();
}

void check_launch(Op op, int err) {
  TORCH_CHECK(err == 0, "CUDA kernel ", kOpNames[op],
              " failed to launch: error ", err);
  g_launches[op].fetch_add(1);
}

void check_on(const at::Tensor& t, const at::Tensor& like, const char* what,
              at::ScalarType dtype) {
  TORCH_CHECK(t.device() == like.device(), "trt: ", what, " on ", t.device(),
              ", expected ", like.device());
  TORCH_CHECK(t.scalar_type() == dtype, "trt: ", what, " must be ", dtype,
              ", got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), "trt: ", what, " must be contiguous");
}

// The 9-int64 host array of a quantized group from its tables and facts.
std::vector<long long> feature_array(at::TensorList q, at::TensorList scale,
                                     at::TensorList bias, at::IntArrayRef facts,
                                     const at::Tensor& like) {
  const size_t nf = q.size();
  TORCH_CHECK(nf > 0 && scale.size() == nf && bias.size() == nf &&
                  facts.size() == nf * kFacts,
              "trt: a group of ", nf, " tables needs ", nf,
              " scales, biases and ", nf * kFacts, " facts");
  std::vector<long long> out(nf * kFeat);
  for (size_t i = 0; i < nf; ++i) {
    check_on(q[i], like, "table", at::kByte);
    check_on(scale[i], like, "scale", at::kFloat);
    check_on(bias[i], like, "bias", at::kFloat);
    TORCH_CHECK(q[i].dim() == 2 && q[i].size(1) == q[0].size(1) &&
                    scale[i].numel() == q[i].size(0) &&
                    bias[i].numel() == q[i].size(0),
                "trt: table ", i, " is not [R, Dp] with [R] scale and bias");
    long long* x = out.data() + kFeat * i;
    x[0] = reinterpret_cast<long long>(q[i].data_ptr());
    x[1] = reinterpret_cast<long long>(scale[i].data_ptr());
    x[2] = reinterpret_cast<long long>(bias[i].data_ptr());
    x[3] = q[i].size(0);
    for (int k = 0; k < kFacts; ++k) x[4 + k] = facts[kFacts * i + k];
  }
  return out;
}

void check_out(const at::Tensor& out, const at::Tensor& ends) {
  TORCH_CHECK(out.scalar_type() == at::kFloat && out.dim() == 2 &&
                  out.stride(1) == 1,
              "trt: out must be a row-major 2-D float32 buffer");
  TORCH_CHECK(ends.dim() == 2 && ends.size(1) == out.size(0),
              "trt: ends must be [keys, B] with B = out rows");
  check_on(ends, out, "ends", at::kInt);
}

const void* optional_ptr(const c10::optional<at::Tensor>& w,
                         const at::Tensor& like) {
  if (!w.has_value()) return nullptr;
  check_on(*w, like, "weights", at::kFloat);
  return w->data_ptr();
}

void q8_pooled(const at::Tensor& out, const at::Tensor& ids,
               const c10::optional<at::Tensor>& weights,
               const at::Tensor& ends, at::TensorList q, at::TensorList scale,
               at::TensorList bias, at::IntArrayRef facts) {
  c10::DeviceGuard guard(out.device());
  check_out(out, ends);
  check_on(ids, out, "ids", at::kLong);
  const auto feats = feature_array(q, scale, bias, facts, out);
  const int B = (int)out.size(0), D = (int)q[0].size(1);
  const int err = entry<Q8Pooled>(kQ8Pooled)(
      feats.data(), (int)q.size(), B, D, out.stride(0), ids.data_ptr(),
      optional_ptr(weights, out), ends.data_ptr(), out.data_ptr(),
      stream_of(out));
  check_launch(kQ8Pooled, err);
}

at::Tensor dedup_q_keys(const at::Tensor& ids, const at::Tensor& ends,
                        at::TensorList q, at::TensorList scale,
                        at::TensorList bias, at::IntArrayRef facts) {
  c10::DeviceGuard guard(ids.device());
  check_on(ids, ids, "ids", at::kLong);
  check_on(ends, ids, "ends", at::kInt);
  TORCH_CHECK(ends.dim() == 2, "trt: ends must be [keys, B]");
  const auto feats = feature_array(q, scale, bias, facts, ids);
  at::Tensor keys = at::empty_like(ids);
  const int err = entry<DedupQKeys>(kDedupQKeys)(
      feats.data(), (int)q.size(), (int)ends.size(1), ids.data_ptr(),
      ends.data_ptr(), keys.data_ptr(), keys.numel(), stream_of(ids));
  check_launch(kDedupQKeys, err);
  return keys;
}

at::Tensor dedup_q_gather(const at::Tensor& ukeys, at::TensorList q,
                          at::TensorList scale, at::TensorList bias,
                          at::IntArrayRef facts, int64_t bits) {
  c10::DeviceGuard guard(ukeys.device());
  check_on(ukeys, ukeys, "ukeys", at::kLong);
  TORCH_CHECK(bits == 8 || bits == 4 || bits == 2, "trt: bits ", bits);
  const auto feats = feature_array(q, scale, bias, facts, ukeys);
  const int Dp = (int)q[0].size(1), D = Dp * (8 / (int)bits);
  at::Tensor rows =
      at::empty({ukeys.numel(), D}, ukeys.options().dtype(at::kFloat));
  const int err = entry<DedupQGather>(kDedupQGather)(
      feats.data(), (int)q.size(), D, Dp, (int)bits, ukeys.data_ptr(),
      rows.data_ptr(), ukeys.numel(), stream_of(ukeys));
  check_launch(kDedupQGather, err);
  return rows;
}

void dedup_q_pool(const at::Tensor& out, const at::Tensor& inv,
                  const c10::optional<at::Tensor>& weights,
                  const at::Tensor& ends, const at::Tensor& rows,
                  at::TensorList q, at::TensorList scale, at::TensorList bias,
                  at::IntArrayRef facts) {
  c10::DeviceGuard guard(out.device());
  check_out(out, ends);
  check_on(inv, out, "inv", at::kLong);
  check_on(rows, out, "rows", at::kFloat);
  const auto feats = feature_array(q, scale, bias, facts, out);
  const int B = (int)out.size(0), D = (int)rows.size(1);
  const int err = entry<DedupQPool>(kDedupQPool)(
      feats.data(), (int)q.size(), B, D, out.stride(0), inv.data_ptr(),
      optional_ptr(weights, out), ends.data_ptr(), rows.data_ptr(),
      out.data_ptr(), stream_of(out));
  check_launch(kDedupQPool, err);
}

// B1 over one feature's region of the KeyedJaggedTensor: facts (start,
// cap, key, col); its examples' running ends are row `key` of ends [K, B].
void tbe_pooled(const at::Tensor& out, const at::Tensor& table,
                const at::Tensor& ids, const c10::optional<at::Tensor>& weights,
                const at::Tensor& ends, at::IntArrayRef facts) {
  c10::DeviceGuard guard(out.device());
  TORCH_CHECK(facts.size() == 4, "trt::tbe_pooled: facts (start, cap, key, col)");
  TORCH_CHECK(out.scalar_type() == at::kFloat && out.dim() == 2 &&
                  out.stride(1) == 1,
              "trt: out must be a row-major 2-D float32 buffer");
  check_on(table, out, "table", table.scalar_type());
  TORCH_CHECK(ids.scalar_type() == at::kInt || ids.scalar_type() == at::kLong,
              "trt: ids must be int32 or int64");
  check_on(ids, out, "ids", ids.scalar_type());
  TORCH_CHECK(ends.dim() == 2 && ends.size(1) == out.size(0) &&
                  (ends.scalar_type() == at::kInt ||
                   ends.scalar_type() == at::kLong),
              "trt: ends must be [keys, B] int32 or int64");
  check_on(ends, out, "ends", ends.scalar_type());
  const long long start = facts[0], cap = facts[1], key = facts[2],
                  col = facts[3];
  const int B = (int)out.size(0), D = (int)table.size(1);
  TORCH_CHECK(key >= 0 && key < ends.size(0) && col >= 0 &&
                  col + D <= out.size(1) && start >= 0 &&
                  start + cap <= ids.numel(),
              "trt::tbe_pooled: key, column or region out of range");
  if (B == 0) return;
  const long long regions[4] = {start, cap, 0, B};
  const char* e = static_cast<const char*>(ends.data_ptr()) +
                  key * B * ends.element_size();
  float* o = out.data_ptr<float>() + col;
  const int err = entry<TbePooled>(kTbePooled)(
      table.data_ptr(), ids.data_ptr(), ids.scalar_type() == at::kLong,
      optional_ptr(weights, out), e, ends.scalar_type() == at::kLong, regions,
      1, o, D, table.size(0), lookup_dtype(table.scalar_type()), 0,
      out.stride(0), stream_of(out));
  check_launch(kTbePooled, err);
}

// B4 over one feature: facts (key, col); its segments are key * B ... of
// the group's sized sort-unique (offsets [K * B + 1]).
void dedup_pooled(const at::Tensor& out, const at::Tensor& table,
                  const at::Tensor& ukeys, const at::Tensor& inv,
                  const at::Tensor& weights, const at::Tensor& offsets,
                  at::IntArrayRef facts) {
  c10::DeviceGuard guard(out.device());
  TORCH_CHECK(facts.size() == 2, "trt::dedup_pooled: facts (key, col)");
  TORCH_CHECK(out.scalar_type() == at::kFloat && out.dim() == 2 &&
                  out.stride(1) == 1,
              "trt: out must be a row-major 2-D float32 buffer");
  check_on(table, out, "table", table.scalar_type());
  check_on(ukeys, out, "ukeys", at::kLong);
  check_on(inv, out, "inv", at::kLong);
  check_on(weights, out, "weights", at::kFloat);
  check_on(offsets, out, "offsets", at::kLong);
  const long long key = facts[0], col = facts[1];
  const long long B = out.size(0);
  const int D = (int)table.size(1);
  TORCH_CHECK(key >= 0 && (key + 1) * B < offsets.numel() && col >= 0 &&
                  col + D <= out.size(1),
              "trt::dedup_pooled: key or column out of range");
  if (B == 0) return;
  const int err = entry<DedupPooled>(kDedupPooled)(
      table.data_ptr(), ukeys.data_ptr(), inv.data_ptr(), weights.data_ptr(),
      offsets.data_ptr<int64_t>() + key * B, out.data_ptr<float>() + col, B,
      D, table.size(0), lookup_dtype(table.scalar_type()), 0, out.stride(0),
      stream_of(out));
  check_launch(kDedupPooled, err);
}

}  // namespace

TORCH_LIBRARY(trt, m) {
  m.def(
      "q8_pooled(Tensor(a!) out, Tensor ids, Tensor? weights, Tensor ends, "
      "Tensor[] q, Tensor[] scale, Tensor[] bias, int[] facts) -> ()");
  m.def(
      "dedup_q_keys(Tensor ids, Tensor ends, Tensor[] q, Tensor[] scale, "
      "Tensor[] bias, int[] facts) -> Tensor");
  m.def(
      "dedup_q_gather(Tensor ukeys, Tensor[] q, Tensor[] scale, "
      "Tensor[] bias, int[] facts, int bits) -> Tensor");
  m.def(
      "dedup_q_pool(Tensor(a!) out, Tensor inv, Tensor? weights, "
      "Tensor ends, Tensor rows, Tensor[] q, Tensor[] scale, Tensor[] bias, "
      "int[] facts) -> ()");
  m.def(
      "tbe_pooled(Tensor(a!) out, Tensor table, Tensor ids, "
      "Tensor? weights, Tensor ends, int[] facts) -> ()");
  m.def(
      "dedup_pooled(Tensor(a!) out, Tensor table, Tensor ukeys, Tensor inv, "
      "Tensor weights, Tensor offsets, int[] facts) -> ()");
}

TORCH_LIBRARY_IMPL(trt, CUDA, m) {
  m.impl("q8_pooled", &q8_pooled);
  m.impl("dedup_q_keys", &dedup_q_keys);
  m.impl("dedup_q_gather", &dedup_q_gather);
  m.impl("dedup_q_pool", &dedup_q_pool);
  m.impl("tbe_pooled", &tbe_pooled);
  m.impl("dedup_pooled", &dedup_pooled);
}

extern "C" {

// Bind the kernel entry point of operator `name` (one of kOpNames) to
// `fn`; returns 0, or -1 for an unknown name.
int trt_ops_bind(const char* name, void* fn) {
  for (int i = 0; i < kNumOps; ++i) {
    if (std::strcmp(name, kOpNames[i]) == 0) {
      g_entry[i].store(fn);
      return 0;
    }
  }
  return -1;
}

// The launches of operator `name` since the last reset; -1 for an unknown
// name.
long long trt_ops_launches(const char* name) {
  for (int i = 0; i < kNumOps; ++i) {
    if (std::strcmp(name, kOpNames[i]) == 0) return g_launches[i].load();
  }
  return -1;
}

void trt_ops_reset_launches() {
  for (int i = 0; i < kNumOps; ++i) g_launches[i].store(0);
}

}  // extern "C"
