// Append-log embedding key-value store: the parameter server's durable
// IO backend (``dynamic/kv_store.py``), the same file format as the JAX
// package's ``csrc/kv_store.cpp``, so either package reads the other's
// stores:
//
//   record := u32 magic | i64 key | f32 row[dim]
//
// Last write wins (the index points at the newest record per key); a torn
// tail is truncated, and the log rewritten when more than half of it is
// dead, on open.  Batch calls, C entry points ``trt_kv_*`` for ctypes.

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4b56454du;  // "MEVK"

class KvStore {
 public:
  KvStore(const std::string& path, int dim) : path_(path), dim_(dim) {}

  bool Open() {
    std::lock_guard<std::mutex> lk(mu_);
    f_ = std::fopen(path_.c_str(), "a+b");
    if (!f_) return false;
    if (!LoadIndex()) return false;
    if (records_ > 0 && index_.size() * 2 < records_) Compact();
    return true;
  }

  void Put(const int64_t* keys, const float* rows, int64_t n) {
    std::lock_guard<std::mutex> lk(mu_);
    std::fseek(f_, 0, SEEK_END);
    for (int64_t i = 0; i < n; ++i) {
      int64_t off = std::ftell(f_);
      std::fwrite(&kMagic, 4, 1, f_);
      std::fwrite(&keys[i], 8, 1, f_);
      std::fwrite(rows + i * dim_, 4, dim_, f_);
      index_[keys[i]] = off;
      ++records_;
    }
    std::fflush(f_);
  }

  // rows for found keys are written to out (missing rows untouched);
  // found[i] = 1 if key i present.  Returns number found.
  int64_t Get(const int64_t* keys, int64_t n, float* out, uint8_t* found) {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t hits = 0;
    for (int64_t i = 0; i < n; ++i) {
      auto it = index_.find(keys[i]);
      if (it == index_.end()) {
        found[i] = 0;
        continue;
      }
      std::fseek(f_, it->second + 12, SEEK_SET);
      if (std::fread(out + i * dim_, 4, dim_, f_) != (size_t)dim_) {
        found[i] = 0;
        continue;
      }
      found[i] = 1;
      ++hits;
    }
    return hits;
  }

  // copies up to cap live keys into out; returns the live-key count
  // (callers size out via Size() first)
  int64_t Keys(int64_t* out, int64_t cap) {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t i = 0;
    for (auto& [key, off] : index_) {
      (void)off;
      if (i >= cap) break;
      out[i++] = key;
    }
    return (int64_t)index_.size();
  }

  int64_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return (int64_t)index_.size();
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    if (f_) {
      std::fclose(f_);
      f_ = nullptr;
    }
  }

 private:
  bool LoadIndex() {
    // the file size bounds the committed prefix: a record whose row
    // bytes run past EOF is torn and must NOT be indexed (fseek past
    // EOF succeeds, so skipping the row blindly would index a phantom
    // key — and the too-large `off` would EXTEND the file with zeros
    // below instead of truncating the wreckage)
    std::fseek(f_, 0, SEEK_END);
    const int64_t file_size = std::ftell(f_);
    std::fseek(f_, 0, SEEK_SET);
    int64_t off = 0;
    const int64_t rec = 12 + (int64_t)dim_ * 4;
    while (off + rec <= file_size) {
      uint32_t magic;
      int64_t key;
      if (std::fread(&magic, 4, 1, f_) != 1) break;
      if (magic != kMagic) break;  // truncated/corrupt tail: stop here
      if (std::fread(&key, 8, 1, f_) != 1) break;
      if (std::fseek(f_, dim_ * 4, SEEK_CUR) != 0) break;
      index_[key] = off;
      ++records_;
      off += rec;
    }
    // drop a torn tail so future appends start at a record boundary
    if (file_size != off) {
      (void)!std::freopen(path_.c_str(), "r+b", f_);
      (void)!::truncate(path_.c_str(), off);
    }
    std::fseek(f_, 0, SEEK_END);
    return true;
  }

  void Compact() {
    std::string tmp = path_ + ".compact";
    FILE* out = std::fopen(tmp.c_str(), "wb");
    if (!out) return;
    std::vector<float> row(dim_);
    std::unordered_map<int64_t, int64_t> fresh;
    int64_t off = 0;
    for (auto& [key, rec_off] : index_) {
      std::fseek(f_, rec_off + 12, SEEK_SET);
      if (std::fread(row.data(), 4, dim_, f_) != (size_t)dim_) continue;
      std::fwrite(&kMagic, 4, 1, out);
      std::fwrite(&key, 8, 1, out);
      std::fwrite(row.data(), 4, dim_, out);
      fresh[key] = off;
      off += 12 + (int64_t)dim_ * 4;
    }
    std::fclose(out);
    std::fclose(f_);
    std::rename(tmp.c_str(), path_.c_str());
    f_ = std::fopen(path_.c_str(), "a+b");
    index_ = std::move(fresh);
    records_ = (int64_t)index_.size();
  }

  const std::string path_;
  const int dim_;
  FILE* f_ = nullptr;
  std::mutex mu_;
  std::unordered_map<int64_t, int64_t> index_;
  int64_t records_ = 0;
};

}  // namespace

extern "C" {

void* trt_kv_open(const char* path, int dim) {
  auto* s = new KvStore(path, dim);
  if (!s->Open()) {
    delete s;
    return nullptr;
  }
  return s;
}

void trt_kv_put(void* s, const int64_t* keys, const float* rows, int64_t n) {
  static_cast<KvStore*>(s)->Put(keys, rows, n);
}

int64_t trt_kv_get(void* s, const int64_t* keys, int64_t n, float* out,
                    uint8_t* found) {
  return static_cast<KvStore*>(s)->Get(keys, n, out, found);
}

int64_t trt_kv_size(void* s) { return static_cast<KvStore*>(s)->Size(); }

int64_t trt_kv_keys(void* s, int64_t* out, int64_t cap) {
  return static_cast<KvStore*>(s)->Keys(out, cap);
}

void trt_kv_close(void* s) {
  auto* kv = static_cast<KvStore*>(s);
  kv->Close();
  delete kv;
}

}  // extern "C"
