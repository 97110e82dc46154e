// Native (no-Python) executor of an exported serving program: an
// AOTInductor package (inference/predict_factory.py::export_native) run by
// torch::inductor::AOTIModelPackageLoader, and the C++ loop that drains the
// batching queue into it.
//
// The port of the JAX package's csrc/native_executor.cpp (the TF C-API
// executor, trec_nx_*, and the loop NativeLoop, trec_nxloop_*) and
// csrc/pjrt_executor.cpp (the PJRT executor, trec_px_*): one executor for
// the CPU and the card, whichever device the package was compiled for.
//
//   trt_aoti_open   opens the package and hands it its constants (the dense
//                   weights and the tables) as user-managed tensors: views of
//                   the caller's buffers, read in place, never copied, so a
//                   package compiled with package_constants_in_so=False holds
//                   no table.  The caller keeps those buffers alive until
//                   trt_aoti_close.  NULL on failure, with the reason in
//                   trt_aoti_last_error.
//   trt_aoti_run    one batch at the package's static shapes, from host
//                   buffers (dense [B, num_dense] f32, values [V] i32,
//                   lengths [F * B] i32) to host scores; catches c10::Error
//                   and std::exception (-1, reason in trt_aoti_run_error).
//   trt_aoti_loop_* the executor loop: dequeue a formed batch, pad it to the
//                   static shapes, regroup request-major -> feature-major,
//                   run, post the scores.  A failed run posts NaN for its
//                   batch and the loop serves the next; a short result fails
//                   the unanswered tail at once.  The queue is the host
//                   library's (csrc/host/batching_queue.cpp): its
//                   trt_bq_dequeue_batch / trt_bq_post_result are passed in
//                   by address, so both sides work on one queue.
//
// Inside the package each lookup is a trt:: operator (csrc/torch_ops.cpp),
// called through the package's proxy executor and the dispatcher: C++ from
// the TCP front end to the kernels.  The loop thread runs under a device
// guard of the package's device, on that device's current stream.
//
// Built by ops/_native.py with g++ against libtorch (-D_GLIBCXX_USE_CXX11_ABI
// as torch was built, torch's include directories, an rpath to torch/lib).

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Executor {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  c10::Device device{c10::kCPU};
  int64_t batch = 0, num_dense = 0, values_len = 0, num_features = 0;
  std::mutex mu;  // one run at a time
  std::string run_error;

  int64_t Run(const float* dense, const int32_t* values,
              const int32_t* lengths, float* out, int64_t out_cap) {
    std::lock_guard<std::mutex> lock(mu);
    try {
      c10::DeviceGuard guard(device);
      auto f32 = at::TensorOptions().dtype(at::kFloat);
      auto i32 = at::TensorOptions().dtype(at::kInt);
      std::vector<at::Tensor> in = {
          at::from_blob(const_cast<float*>(dense), {batch, num_dense}, f32)
              .to(device),
          at::from_blob(const_cast<int32_t*>(values), {values_len}, i32)
              .to(device),
          at::from_blob(const_cast<int32_t*>(lengths),
                        {num_features * batch}, i32)
              .to(device)};
      std::vector<at::Tensor> res = loader->run(in);
      TORCH_CHECK(!res.empty(), "the package returned no output");
      at::Tensor s = res[0].reshape({-1}).to(at::kCPU, at::kFloat).contiguous();
      const int64_t n = std::min<int64_t>(s.numel(), out_cap);
      std::memcpy(out, s.data_ptr<float>(), (size_t)n * sizeof(float));
      return n;
    } catch (const c10::Error& e) {
      run_error = e.what_without_backtrace();
    } catch (const std::exception& e) {
      run_error = e.what();
    }
    return -1;
  }
};

thread_local std::string g_open_error;

using Dequeue = int (*)(void*, int64_t, uint64_t*, float*, int64_t*, int64_t*,
                        int32_t*);
using Post = void (*)(void*, uint64_t, const float*, int);

struct Loop {
  void* queue;
  Dequeue dequeue;
  Post post;
  Executor* ex;
  std::vector<int32_t> caps;     // ids a request may carry, per feature
  std::vector<int64_t> cap_off;  // feature f's region in values
  std::thread thread;
  std::atomic<bool> running{false};
  std::atomic<long long> batches{0}, failed{0};

  void Run() {
    c10::DeviceGuard guard(ex->device);
    const int64_t B = ex->batch, F = ex->num_features, nd = ex->num_dense;
    std::vector<uint64_t> rids(B);
    std::vector<float> dense((size_t)(B * nd));
    std::vector<int32_t> lengths((size_t)(B * F));
    std::vector<int64_t> ids((size_t)std::max<int64_t>(ex->values_len, 1));
    std::vector<float> in_dense((size_t)(B * nd));
    std::vector<int32_t> in_values((size_t)ex->values_len);
    std::vector<int32_t> in_lengths((size_t)(F * B));
    std::vector<float> scores((size_t)B);
    const float nan = std::nanf("");
    while (running.load(std::memory_order_relaxed)) {
      int64_t cap = (int64_t)ids.size();
      const int n = dequeue(queue, 50'000, rids.data(), dense.data(),
                            ids.data(), &cap, lengths.data());
      if (n == -1) return;  // shutdown
      if (n == -2) {        // the ids buffer is too small: grow and retry
        ids.resize((size_t)cap);
        continue;
      }
      if (n <= 0) continue;
      // pad to B examples; lengths [n, F] request-major -> [F, B]; each
      // request's ids, [f0 ids, f1 ids, ...], into feature f's region
      // (front-packed in request order, cut at the region's cap)
      std::fill(in_dense.begin(), in_dense.end(), 0.f);
      std::fill(in_values.begin(), in_values.end(), 0);
      std::fill(in_lengths.begin(), in_lengths.end(), 0);
      std::memcpy(in_dense.data(), dense.data(),
                  (size_t)n * nd * sizeof(float));
      std::vector<int64_t> wr(cap_off.begin(), cap_off.end());
      int64_t pos = 0;
      for (int i = 0; i < n; ++i) {
        for (int64_t f = 0; f < F; ++f) {
          const int32_t len = lengths[(size_t)(i * F + f)];
          const int32_t cnt = std::min(std::max(len, 0), caps[f]);
          for (int32_t k = 0; k < cnt; ++k)
            in_values[(size_t)wr[f]++] = (int32_t)ids[(size_t)(pos + k)];
          in_lengths[(size_t)(f * B + i)] = cnt;
          pos += std::max(len, 0);
        }
      }
      const int64_t got = ex->Run(in_dense.data(), in_values.data(),
                                  in_lengths.data(), scores.data(), B);
      batches.fetch_add(1);
      if (got < 0) {
        // fail the whole batch (NaN) and keep serving
        failed.fetch_add(1);
        for (int i = 0; i < n; ++i) post(queue, rids[i], &nan, 1);
        continue;
      }
      for (int i = 0; i < n && i < got; ++i) post(queue, rids[i], &scores[i], 1);
      // a short result: the unanswered tail fails now (NaN), not at its
      // clients' timeout
      for (int64_t i = got; i < n; ++i) post(queue, rids[i], &nan, 1);
    }
  }
};

}  // namespace

extern "C" {

// Open an AOTInductor package.  device_type 0 = CPU, 1 = CUDA (the
// package's own device), device_index its index.  The n_constants
// constants are named exactly as the package lists them
// (get_constant_fqns), each a contiguous tensor at data[i] on that device,
// of c10::ScalarType dtypes[i] and shape dims[sum(ranks[:i]) :
// sum(ranks[:i+1])].  batch, num_dense, values_len and num_features are
// the flat signature's static shapes.
void* trt_aoti_open(const char* package, int device_type, int device_index,
                    int n_constants, const char* const* names,
                    void* const* data, const int* dtypes, const int* ranks,
                    const int64_t* dims, int64_t batch, int64_t num_dense,
                    int64_t values_len, int64_t num_features) {
  auto ex = std::make_unique<Executor>();
  try {
    ex->device = device_type == 1
                     ? c10::Device(c10::kCUDA, (c10::DeviceIndex)device_index)
                     : c10::Device(c10::kCPU);
    c10::DeviceGuard guard(ex->device);
    ex->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        package, "model", false, 1,
        device_type == 1 ? (c10::DeviceIndex)device_index
                         : (c10::DeviceIndex)-1);
    std::unordered_map<std::string, at::Tensor> constants;
    const int64_t* d = dims;
    for (int i = 0; i < n_constants; ++i) {
      std::vector<int64_t> shape(d, d + ranks[i]);
      d += ranks[i];
      constants.emplace(
          names[i],
          at::from_blob(data[i], shape,
                        at::TensorOptions()
                            .dtype((c10::ScalarType)dtypes[i])
                            .device(ex->device)));
    }
    // user-managed: the package reads these buffers in place
    ex->loader->load_constants(constants, /*use_inactive=*/false,
                               /*check_full_update=*/true,
                               /*user_managed=*/true);
  } catch (const c10::Error& e) {
    g_open_error = e.what_without_backtrace();
    return nullptr;
  } catch (const std::exception& e) {
    g_open_error = e.what();
    return nullptr;
  }
  ex->batch = batch;
  ex->num_dense = num_dense;
  ex->values_len = values_len;
  ex->num_features = num_features;
  return ex.release();
}

const char* trt_aoti_last_error() { return g_open_error.c_str(); }

// One batch; returns the scores written (at most out_cap), or -1 (reason
// in trt_aoti_run_error).
int64_t trt_aoti_run(void* h, const float* dense, const int32_t* values,
                     const int32_t* lengths, float* out, int64_t out_cap) {
  return static_cast<Executor*>(h)->Run(dense, values, lengths, out, out_cap);
}

const char* trt_aoti_run_error(void* h) {
  return static_cast<Executor*>(h)->run_error.c_str();
}

void trt_aoti_close(void* h) { delete static_cast<Executor*>(h); }

// Start the executor loop on a batching queue.  dequeue / post: the host
// library's trt_bq_dequeue_batch / trt_bq_post_result.  caps: ids a request
// may carry, per feature; feature f's region of the values input starts at
// the sum of caps[f'] * batch over f' < f.
void* trt_aoti_loop_start(void* queue, void* dequeue, void* post, void* h,
                          const int32_t* caps) {
  auto* ex = static_cast<Executor*>(h);
  auto* loop = new Loop();
  loop->queue = queue;
  loop->dequeue = reinterpret_cast<Dequeue>(dequeue);
  loop->post = reinterpret_cast<Post>(post);
  loop->ex = ex;
  loop->caps.assign(caps, caps + ex->num_features);
  int64_t off = 0;
  for (int64_t f = 0; f < ex->num_features; ++f) {
    loop->cap_off.push_back(off);
    off += (int64_t)caps[f] * ex->batch;
  }
  if (off != ex->values_len) {
    g_open_error = "caps * batch do not cover the package's values input";
    delete loop;
    return nullptr;
  }
  loop->running.store(true);
  loop->thread = std::thread([loop] { loop->Run(); });
  return loop;
}

// out[0]: batches run, out[1]: of them failed (posted NaN).
void trt_aoti_loop_stats(void* h, int64_t* out) {
  auto* loop = static_cast<Loop*>(h);
  out[0] = loop->batches.load();
  out[1] = loop->failed.load();
}

// Stop and join the loop (the queue's shutdown ends a pending dequeue).
void trt_aoti_loop_stop(void* h) {
  auto* loop = static_cast<Loop*>(h);
  loop->running.store(false);
  if (loop->thread.joinable()) loop->thread.join();
  delete loop;
}

}  // extern "C"
