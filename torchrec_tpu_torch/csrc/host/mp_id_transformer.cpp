// Multi-probe hash id transformer (MPZCH).
//
// Native counterpart of the reference's hash-ZCH
// (modules/hash_mc_modules.py HashZchManagedCollisionModule, backed by
// fbgemm faster_hash ops): each id hashes to a fixed probe window of
// `max_probe` slots; lookup probes the window for the id, claims an empty
// slot on miss, and otherwise evicts the least-recently-used occupant of
// the window.  Unlike the LRU transformer (id_transformer.cpp), slot
// assignment is a pure function of the id's hash window — ids keep stable
// locality across restarts and across hosts without sharing the map.
//
// C ABI for ctypes; same calling convention as trt_idt_*.
//
// The port's copy of the JAX package's csrc/mp_id_transformer.cpp (C names prefixed trt_),
// built into one library with the serving queue by
// torchrec_tpu_torch/ops/_native.py::load_host_library.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Entry {
  int64_t gid = -1;  // -1 = empty
  uint64_t tick = 0;
};

class MpIdTransformer {
 public:
  MpIdTransformer(int64_t capacity, int max_probe)
      : capacity_(capacity),
        max_probe_(max_probe < 1
                       ? 1
                       : (max_probe > capacity ? (int)capacity : max_probe)),
        entries_(capacity) {}

  int64_t Transform(const int64_t* ids, int64_t n, int64_t* slots,
                    int64_t* evicted_global, int64_t* evicted_slot,
                    int64_t* evicted_count) {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t fresh = 0;
    int64_t n_evict = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t gid = ids[i];
      uint64_t h = splitmix64((uint64_t)gid) % (uint64_t)capacity_;
      int64_t hit = -1, empty = -1, lru = -1;
      uint64_t lru_tick = ~0ULL;
      for (int p = 0; p < max_probe_; ++p) {
        int64_t s = (int64_t)((h + (uint64_t)p) % (uint64_t)capacity_);
        Entry& e = entries_[s];
        if (e.gid == gid) {
          hit = s;
          break;
        }
        if (e.gid < 0 && empty < 0) empty = s;
        if (e.tick < lru_tick) {
          lru_tick = e.tick;
          lru = s;
        }
      }
      ++tick_;
      int64_t s;
      if (hit >= 0) {
        s = hit;
      } else if (empty >= 0) {
        s = empty;
        entries_[s].gid = gid;
        ++size_;
        ++fresh;
      } else {
        s = lru;
        if (evicted_global) {
          evicted_global[n_evict] = entries_[s].gid;
          evicted_slot[n_evict] = s;
        }
        ++n_evict;
        entries_[s].gid = gid;
        ++fresh;
      }
      entries_[s].tick = tick_;
      slots[i] = s;
    }
    if (evicted_count) *evicted_count = n_evict;
    return fresh;
  }

  int64_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return size_;
  }

 private:
  const int64_t capacity_;
  const int max_probe_;
  std::mutex mu_;
  std::vector<Entry> entries_;
  uint64_t tick_ = 0;
  int64_t size_ = 0;
};

}  // namespace

extern "C" {

void* trt_mpidt_create(int64_t capacity, int max_probe) {
  return new MpIdTransformer(capacity, max_probe);
}

void trt_mpidt_destroy(void* t) { delete static_cast<MpIdTransformer*>(t); }

int64_t trt_mpidt_transform(void* t, const int64_t* ids, int64_t n,
                             int64_t* slots, int64_t* evicted_global,
                             int64_t* evicted_slot, int64_t* evicted_count) {
  return static_cast<MpIdTransformer*>(t)->Transform(
      ids, n, slots, evicted_global, evicted_slot, evicted_count);
}

int64_t trt_mpidt_size(void* t) {
  return static_cast<MpIdTransformer*>(t)->Size();
}

}  // extern "C"
