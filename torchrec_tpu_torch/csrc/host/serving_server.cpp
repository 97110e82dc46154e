// TCP prediction server over the dynamic batching queue.
//
// Native counterpart of the reference's inference/server.cpp (gRPC
// PredictorServiceHandler::Predict :50 over BatchingQueue).  gRPC is not
// available in this build, so the wire protocol is a minimal
// length-prefixed binary frame that mirrors predictor.proto's
// PredictionRequest/PredictionResponse:
//
//   request  := u32 payload_len | payload
//   payload  := u32 num_dense | f32 dense[num_dense]
//             | u32 num_features | { u32 n_ids | i64 ids[n_ids] } per feature
//   response := u32 payload_len(5) | u8 status | f32 score
//     status: 0 ok, 1 timeout/executor failure, 2 malformed request
//
// Requests are validated against the serving capacities BEFORE they enter
// the shared batching queue, so one malformed client cannot poison a
// formed batch.  One detached OS thread per connection (the reference
// serves gRPC from a thread pool the same way), tracked by an active
// counter so Stop() can drain; each connection pipelines one request at a
// time — clients open several connections for concurrency.  All batching
// and result routing stays in the shared BatchingQueue, so network
// requests and in-process predict() calls coalesce into the same batches.
//
// The port's copy of the JAX package's csrc/serving_server.cpp, built into
// one library with batching_queue.cpp (C names prefixed trt_); a request
// that a stopped queue refuses (id 0) is answered with status 1.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <thread>
#include <vector>

// C ABI of batching_queue.cpp (same shared object)
extern "C" {
uint64_t trt_bq_enqueue(void* q, const float* dense, const int64_t* ids,
                         const int32_t* lengths);
int trt_bq_wait_result(void* q, uint64_t request_id, int64_t timeout_us,
                        float* scores, int capacity);
}

namespace {

bool ReadExact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool WriteExact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

class PredictionServer {
 public:
  PredictionServer(void* bq, int num_dense, int num_features,
                   const int32_t* feature_caps, int64_t request_timeout_us)
      : bq_(bq),
        num_dense_(num_dense),
        num_features_(num_features),
        caps_(feature_caps, feature_caps + num_features),
        request_timeout_us_(request_timeout_us) {}

  // binds 127.0.0.1:port (0 = ephemeral); returns bound port or -1
  int Start(int port) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons((uint16_t)port);
    if (::bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) != 0 ||
        ::listen(listen_fd_, 128) != 0) {
      ::close(listen_fd_);
      return -1;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd_, (sockaddr*)&addr, &len);
    port_ = ntohs(addr.sin_port);
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    return port_;
  }

  // Graceful-shutdown phase 1: stop accepting (listener closed, accept
  // thread joined) but leave live connections running until each has
  // finished the request it is mid-way through — no socket is ever
  // torn mid-response.  Bounded by deadline_ms; returns the number of
  // requests still in flight when it gave up (0 == clean quiesce).
  // Call Stop() afterwards for the hard teardown of idle connections.
  int Quiesce(int64_t deadline_ms) {
    accepting_ = false;
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(deadline_ms);
    while (inflight_.load() > 0 &&
           std::chrono::steady_clock::now() < deadline) {
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    return inflight_.load();
  }

  void Stop() {
    running_ = false;
    accepting_ = false;
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    {
      // connections inserted after running_ flipped close themselves in
      // AcceptLoop, so this loop + the flag cover every live fd
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    // connection threads are detached; drain via the active counter
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::seconds(10);
    while (active_.load() > 0 &&
           std::chrono::steady_clock::now() < deadline) {
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  }

  int port() const { return port_; }

 private:
  void AcceptLoop() {
    while (running_ && accepting_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (!running_ || !accepting_) return;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      {
        std::lock_guard<std::mutex> lk(conn_mu_);
        if (!running_) {  // raced with Stop(): it won't see this fd
          ::close(fd);
          return;
        }
        conn_fds_.insert(fd);
      }
      active_.fetch_add(1);
      std::thread([this, fd] {
        ServeConnection(fd);
        {
          std::lock_guard<std::mutex> lk(conn_mu_);
          conn_fds_.erase(fd);
        }
        ::close(fd);
        active_.fetch_sub(1);
      }).detach();
    }
  }

  void SendResponse(int fd, uint8_t status, float score) {
    char buf[4 + 1 + 4];
    uint32_t plen = 5;
    std::memcpy(buf, &plen, 4);
    buf[4] = (char)status;
    std::memcpy(buf + 5, &score, 4);
    WriteExact(fd, buf, sizeof(buf));
  }

  // decrements the in-flight request counter at the end of each
  // request-handling iteration, whatever path (continue / return) it
  // takes — Quiesce() waits on this counter
  struct InflightGuard {
    std::atomic<int>& c;
    ~InflightGuard() { c.fetch_sub(1); }
  };

  void ServeConnection(int fd) {
    std::vector<char> payload;
    while (running_) {
      uint32_t plen;
      if (!ReadExact(fd, &plen, 4)) return;
      // in-flight from the moment the client COMMITS to a request
      // (header read) — counting only after the payload landed would
      // let Quiesce() observe zero while a frame is mid-read and
      // report a clean drain it then tears
      inflight_.fetch_add(1);
      InflightGuard inflight_guard{inflight_};
      if (plen > (64u << 20)) {  // refuse absurd frames
        SendResponse(fd, 2, NAN);
        return;
      }
      payload.resize(plen);
      if (!ReadExact(fd, payload.data(), plen)) return;
      ServeOneRequest(fd, payload);
      if (!accepting_) {
        // answered mid-quiesce (the frame was fully read — refusing
        // would tear the protocol); close so the drain converges
        return;
      }
    }
  }

  void ServeOneRequest(int fd, const std::vector<char>& payload) {
      size_t plen = payload.size();
      const char* p = payload.data();
      const char* end = p + plen;
      auto need = [&](size_t n) { return (size_t)(end - p) >= n; };
      uint32_t nd, nf;
      if (!need(4)) { SendResponse(fd, 2, NAN); return; }
      std::memcpy(&nd, p, 4); p += 4;
      if (nd != (uint32_t)num_dense_ || !need((size_t)nd * 4 + 4)) {
        SendResponse(fd, 2, NAN);
        return;
      }
      std::vector<float> dense(num_dense_);
      std::memcpy(dense.data(), p, (size_t)nd * 4);  // payload may be unaligned
      p += (size_t)nd * 4;
      std::memcpy(&nf, p, 4); p += 4;
      if (nf != (uint32_t)num_features_) {
        SendResponse(fd, 2, NAN);
        return;
      }
      std::vector<int32_t> lengths(num_features_);
      std::vector<int64_t> ids;
      bool ok = true;
      for (uint32_t f = 0; f < nf; ++f) {
        uint32_t n;
        if (!need(4)) { ok = false; break; }
        std::memcpy(&n, p, 4); p += 4;
        // validate against the serving capacity HERE, before the shared
        // queue — an oversized request must not poison a formed batch
        if (n > (uint32_t)caps_[f] || !need((size_t)n * 8)) {
          ok = false;
          break;
        }
        lengths[f] = (int32_t)n;
        size_t old = ids.size();
        ids.resize(old + n);
        std::memcpy(ids.data() + old, p, (size_t)n * 8);  // unaligned-safe
        p += (size_t)n * 8;
      }
      if (!ok) {
        SendResponse(fd, 2, NAN);
        return;
      }
      uint64_t rid =
          trt_bq_enqueue(bq_, dense.data(), ids.data(), lengths.data());
      float score = NAN;
      int got = rid == 0 ? 0
                         : trt_bq_wait_result(bq_, rid, request_timeout_us_,
                                              &score, 1);
      SendResponse(fd, got > 0 ? (uint8_t)(std::isnan(score) ? 1 : 0)
                               : (uint8_t)1,
                   score);
  }

  void* bq_;
  const int num_dense_;
  const int num_features_;
  const std::vector<int32_t> caps_;
  const int64_t request_timeout_us_;
  int listen_fd_ = -1;
  int port_ = -1;
  std::atomic<bool> running_{true};
  std::atomic<bool> accepting_{true};
  std::atomic<int> active_{0};
  std::atomic<int> inflight_{0};
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::set<int> conn_fds_;
};

}  // namespace

extern "C" {

void* trt_srv_create(void* bq, int num_dense, int num_features,
                      const int32_t* feature_caps,
                      int64_t request_timeout_us) {
  return new PredictionServer(bq, num_dense, num_features, feature_caps,
                              request_timeout_us);
}

int trt_srv_start(void* s, int port) {
  return static_cast<PredictionServer*>(s)->Start(port);
}

void trt_srv_stop(void* s) { static_cast<PredictionServer*>(s)->Stop(); }

int trt_srv_quiesce(void* s, int64_t deadline_ms) {
  return static_cast<PredictionServer*>(s)->Quiesce(deadline_ms);
}

void trt_srv_destroy(void* s) { delete static_cast<PredictionServer*>(s); }

int trt_srv_port(void* s) { return static_cast<PredictionServer*>(s)->port(); }

}  // extern "C"
