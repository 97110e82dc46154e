// Global-id -> cache-slot transformer with LRU eviction.
//
// Native counterpart of the reference's dynamic-embedding extension
// (torchrec/csrc/dynamic_embedding/naive_id_transformer.h +
// mixed_lfu_lru_strategy.h): raw unbounded int64 ids map to bounded table
// slots; when full, the least-recently-used slot is evicted and its
// mapping reassigned.  The host runs this ahead of device dispatch so the
// TPU only ever sees in-range rows (the parameter-server fetch/evict hook
// points are the evicted/assigned slot lists).
//
// C ABI for ctypes.  Not thread-safe per instance by design (the input
// pipeline owns one instance per table group); a mutex still guards
// against accidental concurrent use.
//
// The port's copy of the JAX package's csrc/id_transformer.cpp (C names prefixed trt_),
// built into one library with the serving queue by
// torchrec_tpu_torch/ops/_native.py::load_host_library.

#include <cstdint>
#include <list>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

class IdTransformer {
 public:
  explicit IdTransformer(int64_t capacity) : capacity_(capacity) {}

  // Transforms ids[i] -> slots[i]; returns number of NEW assignments.
  // evicted_global/evicted_slot (capacity >= n) receive the mappings that
  // were dropped to make room (for PS write-back); *evicted_count is set.
  int64_t Transform(const int64_t* ids, int64_t n, int64_t* slots,
                    int64_t* evicted_global, int64_t* evicted_slot,
                    int64_t* evicted_count) {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t fresh = 0;
    int64_t n_evict = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t gid = ids[i];
      auto it = map_.find(gid);
      if (it != map_.end()) {
        lru_.splice(lru_.begin(), lru_, it->second.lru_it);
        slots[i] = it->second.slot;
        continue;
      }
      int64_t slot;
      if ((int64_t)map_.size() < capacity_) {
        slot = (int64_t)map_.size();
      } else {
        // evict LRU
        int64_t victim_gid = lru_.back();
        lru_.pop_back();
        auto vit = map_.find(victim_gid);
        slot = vit->second.slot;
        if (evicted_global) {
          evicted_global[n_evict] = victim_gid;
          evicted_slot[n_evict] = slot;
        }
        ++n_evict;
        map_.erase(vit);
      }
      lru_.push_front(gid);
      map_[gid] = Entry{slot, lru_.begin()};
      slots[i] = slot;
      ++fresh;
    }
    if (evicted_count) *evicted_count = n_evict;
    return fresh;
  }

  int64_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return (int64_t)map_.size();
  }

 private:
  struct Entry {
    int64_t slot;
    std::list<int64_t>::iterator lru_it;
  };
  const int64_t capacity_;
  std::mutex mu_;
  std::unordered_map<int64_t, Entry> map_;
  std::list<int64_t> lru_;  // front = most recent
};

}  // namespace

extern "C" {

void* trt_idt_create(int64_t capacity) { return new IdTransformer(capacity); }

void trt_idt_destroy(void* t) { delete static_cast<IdTransformer*>(t); }

int64_t trt_idt_transform(void* t, const int64_t* ids, int64_t n,
                           int64_t* slots, int64_t* evicted_global,
                           int64_t* evicted_slot, int64_t* evicted_count) {
  return static_cast<IdTransformer*>(t)->Transform(
      ids, n, slots, evicted_global, evicted_slot, evicted_count);
}

int64_t trt_idt_size(void* t) {
  return static_cast<IdTransformer*>(t)->Size();
}

}  // extern "C"
