// Dynamic batching queue for inference serving.
//
// Native counterpart of the reference's inference_legacy/src/BatchingQueue.cpp:
// producers enqueue single requests; a forming policy coalesces them into
// batches of up to `max_batch_size`, flushing early after `max_latency_us`
// so tail latency stays bounded.  Consumers (the model executor thread)
// pop formed batches and later post per-request results.
//
// Exposed as a C ABI for ctypes (no pybind11 in this build).  All memory
// crossing the boundary is caller-owned numpy buffers; the queue copies
// request payloads in and result payloads out.
//
// The port's copy of the JAX package's csrc/batching_queue.cpp, with the
// PyBatchingQueue contract of torchrec_tpu_torch/inference/serving.py
// where the original differs: Enqueue refuses a request after Shutdown
// (returns id 0, never issued otherwise), and the queue counts the
// requests enqueued whose result has not been posted (trt_bq_outstanding),
// so a drain sees a batch that is inside an executor.  The C names carry
// the prefix trt_ so that this library and the JAX package's (trec_) can
// be loaded into one process.
//
// Built by torchrec_tpu_torch/ops/_native.py::load_host_library with
// g++ -O2 -std=c++17 -shared -fPIC -Wl,-Bsymbolic ... -lpthread.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Request {
  uint64_t id;
  std::vector<float> dense;         // [num_dense]
  std::vector<int64_t> ids;         // sparse ids, all features concatenated
  std::vector<int32_t> lengths;     // [num_features]
};

struct Batch {
  std::vector<uint64_t> request_ids;
  std::vector<float> dense;       // [B * num_dense]
  std::vector<int64_t> ids;       // concat per request
  std::vector<int32_t> lengths;   // [B * num_features] request-major
};

struct Result {
  std::vector<float> scores;  // one or more per request
  Clock::time_point posted_at;
};

// results whose client never collects them (timed-out predict) are purged
// after this long so the map stays bounded
constexpr auto kResultTtl = std::chrono::seconds(60);

class BatchingQueue {
 public:
  BatchingQueue(int max_batch, int64_t max_latency_us, int num_dense,
                int num_features)
      : max_batch_(max_batch),
        max_latency_us_(max_latency_us),
        num_dense_(num_dense),
        num_features_(num_features) {}

  uint64_t Enqueue(const float* dense, const int64_t* ids,
                   const int32_t* lengths) {
    std::unique_lock<std::mutex> lk(mu_);
    if (shutdown_) return 0;  // a stopped queue forms no more batches
    uint64_t id = next_id_++;
    ++inflight_;
    Request r;
    r.id = id;
    r.dense.assign(dense, dense + num_dense_);
    int64_t total = 0;
    for (int f = 0; f < num_features_; ++f) total += lengths[f];
    r.ids.assign(ids, ids + total);
    r.lengths.assign(lengths, lengths + num_features_);
    pending_.push_back(std::move(r));
    if (pending_.size() == 1) oldest_ = Clock::now();
    cv_.notify_all();
    return id;
  }

  // Blocks until a batch forms (max size reached or latency deadline) or
  // timeout_us elapses.  Returns batch size, 0 on timeout, -1 on shutdown.
  int DequeueBatch(int64_t timeout_us, uint64_t* request_ids, float* dense,
                   int64_t* ids, int64_t* ids_capacity_inout,
                   int32_t* lengths) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);
    while (true) {
      if (shutdown_) return -1;
      if (!pending_.empty()) {
        bool full = (int)pending_.size() >= max_batch_;
        bool stale = Clock::now() - oldest_ >=
                     std::chrono::microseconds(max_latency_us_);
        if (full || stale) break;
      }
      auto wait_until = deadline;
      if (!pending_.empty()) {
        auto flush_at =
            oldest_ + std::chrono::microseconds(max_latency_us_);
        if (flush_at < wait_until) wait_until = flush_at;
      }
      if (cv_.wait_until(lk, wait_until) == std::cv_status::timeout &&
          Clock::now() >= deadline) {
        if (pending_.empty()) return 0;
        // deadline hit with some pending work: flush what we have
        break;
      }
    }
    int n = std::min<int>(pending_.size(), max_batch_);
    int64_t ids_total = 0;
    for (int i = 0; i < n; ++i) ids_total += (int64_t)pending_[i].ids.size();
    if (ids_total > *ids_capacity_inout) {
      *ids_capacity_inout = ids_total;  // tell caller the needed size
      return -2;
    }
    *ids_capacity_inout = ids_total;
    int64_t ids_pos = 0;
    for (int i = 0; i < n; ++i) {
      Request& r = pending_[i];
      request_ids[i] = r.id;
      std::memcpy(dense + (int64_t)i * num_dense_, r.dense.data(),
                  num_dense_ * sizeof(float));
      std::memcpy(ids + ids_pos, r.ids.data(),
                  r.ids.size() * sizeof(int64_t));
      ids_pos += (int64_t)r.ids.size();
      std::memcpy(lengths + (int64_t)i * num_features_, r.lengths.data(),
                  num_features_ * sizeof(int32_t));
    }
    pending_.erase(pending_.begin(), pending_.begin() + n);
    if (!pending_.empty()) oldest_ = Clock::now();
    return n;
  }

  void PostResult(uint64_t request_id, const float* scores, int n) {
    std::unique_lock<std::mutex> lk(mu_);
    auto now = Clock::now();
    if (inflight_ > 0) --inflight_;
    Result& r = results_[request_id];
    r.scores.assign(scores, scores + n);
    r.posted_at = now;
    // purge abandoned results (client timed out and will never collect)
    for (auto it = results_.begin(); it != results_.end();) {
      if (now - it->second.posted_at > kResultTtl) {
        it = results_.erase(it);
      } else {
        ++it;
      }
    }
    cv_results_.notify_all();
  }

  // Blocks until the request's result is posted; returns count, 0 timeout.
  int WaitResult(uint64_t request_id, int64_t timeout_us, float* scores,
                 int capacity) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);
    while (true) {
      auto it = results_.find(request_id);
      if (it != results_.end()) {
        int n = std::min<int>(it->second.scores.size(), capacity);
        std::memcpy(scores, it->second.scores.data(), n * sizeof(float));
        results_.erase(it);
        return n;
      }
      if (shutdown_) return -1;
      if (cv_results_.wait_until(lk, deadline) == std::cv_status::timeout)
        return 0;
    }
  }

  void Shutdown() {
    std::unique_lock<std::mutex> lk(mu_);
    shutdown_ = true;
    cv_.notify_all();
    cv_results_.notify_all();
  }

  int PendingCount() {
    std::unique_lock<std::mutex> lk(mu_);
    return (int)pending_.size();
  }

  // requests enqueued whose result has not been posted: pending ones and
  // those inside an executor
  int64_t Outstanding() {
    std::unique_lock<std::mutex> lk(mu_);
    return inflight_;
  }

 private:
  const int max_batch_;
  const int64_t max_latency_us_;
  const int num_dense_;
  const int num_features_;

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable cv_results_;
  std::deque<Request> pending_;
  std::unordered_map<uint64_t, Result> results_;
  Clock::time_point oldest_;
  uint64_t next_id_ = 1;
  int64_t inflight_ = 0;
  bool shutdown_ = false;
};

}  // namespace

extern "C" {

void* trt_bq_create(int max_batch, int64_t max_latency_us, int num_dense,
                     int num_features) {
  return new BatchingQueue(max_batch, max_latency_us, num_dense,
                           num_features);
}

void trt_bq_destroy(void* q) { delete static_cast<BatchingQueue*>(q); }

uint64_t trt_bq_enqueue(void* q, const float* dense, const int64_t* ids,
                         const int32_t* lengths) {
  return static_cast<BatchingQueue*>(q)->Enqueue(dense, ids, lengths);
}

int trt_bq_dequeue_batch(void* q, int64_t timeout_us, uint64_t* request_ids,
                          float* dense, int64_t* ids,
                          int64_t* ids_capacity_inout, int32_t* lengths) {
  return static_cast<BatchingQueue*>(q)->DequeueBatch(
      timeout_us, request_ids, dense, ids, ids_capacity_inout, lengths);
}

void trt_bq_post_result(void* q, uint64_t request_id, const float* scores,
                         int n) {
  static_cast<BatchingQueue*>(q)->PostResult(request_id, scores, n);
}

int trt_bq_wait_result(void* q, uint64_t request_id, int64_t timeout_us,
                        float* scores, int capacity) {
  return static_cast<BatchingQueue*>(q)->WaitResult(request_id, timeout_us,
                                                    scores, capacity);
}

void trt_bq_shutdown(void* q) { static_cast<BatchingQueue*>(q)->Shutdown(); }

int trt_bq_pending(void* q) {
  return static_cast<BatchingQueue*>(q)->PendingCount();
}

int64_t trt_bq_outstanding(void* q) {
  return static_cast<BatchingQueue*>(q)->Outstanding();
}

}  // extern "C"
