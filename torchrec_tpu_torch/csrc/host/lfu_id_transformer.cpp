// Frequency-aware id transformers: LFU and DistanceLFU eviction.
//
// Native counterparts of the reference eviction-policy family
// (modules/mc_modules.py LFU_EvictionPolicy :647 and
// DistanceLFU_EvictionPolicy :875; csrc mixed_lfu_lru_strategy.h):
//
//   lfu          — evict the minimum access count; ties break LRU within
//                  the count bucket (the "mixed LFU-LRU" strategy).
//   distance_lfu — evict the minimum count / distance^decay where
//                  distance = iterations since last access.  Exact argmin
//                  scan for small tables; deterministic sampled argmin
//                  (Redis-style, 64 probes) for large ones, trading exact
//                  policy adherence for O(1) eviction.
//
// One Transform call = one iteration (the reference ticks per batch).
// C ABI for ctypes.
//
// The port's copy of the JAX package's csrc/lfu_id_transformer.cpp (C names prefixed trt_),
// built into one library with the serving queue by
// torchrec_tpu_torch/ops/_native.py::load_host_library.

#include <cstdint>
#include <cmath>
#include <list>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kExactScanMax = 4096;
constexpr int kSampleProbes = 64;

class LfuIdTransformer {
 public:
  LfuIdTransformer(int64_t capacity, int policy, double decay)
      : capacity_(capacity), policy_(policy), decay_(decay) {
    entries_.reserve(capacity);
  }

  int64_t Transform(const int64_t* ids, int64_t n, int64_t* slots,
                    int64_t* evicted_global, int64_t* evicted_slot,
                    int64_t* evicted_count) {
    std::lock_guard<std::mutex> lk(mu_);
    ++iter_;
    int64_t fresh = 0;
    int64_t n_evict = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t gid = ids[i];
      auto it = map_.find(gid);
      if (it != map_.end()) {
        Entry& e = entries_[it->second];
        Touch(e);
        slots[i] = e.slot;
        continue;
      }
      int64_t idx;
      if ((int64_t)map_.size() < capacity_) {
        idx = (int64_t)entries_.size();
        entries_.push_back(Entry{});
        entries_[idx].slot = idx;
      } else {
        idx = PickVictim();
        Entry& v = entries_[idx];
        if (evicted_global) {
          evicted_global[n_evict] = v.gid;
          evicted_slot[n_evict] = v.slot;
        }
        ++n_evict;
        if (policy_ == 0) bucket_erase(v);
        map_.erase(v.gid);
      }
      Entry& e = entries_[idx];
      e.gid = gid;
      e.count = 1;
      e.last = iter_;
      if (policy_ == 0) bucket_push(idx);
      map_[gid] = idx;
      slots[i] = e.slot;
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
    int64_t gid = -1;
    int64_t slot = -1;
    int64_t count = 0;
    int64_t last = 0;
    std::list<int64_t>::iterator pos;  // within its count bucket (lfu)
  };

  void Touch(Entry& e) {
    if (policy_ == 0) bucket_erase(e);
    ++e.count;
    e.last = iter_;
    if (policy_ == 0) bucket_push((int64_t)(&e - entries_.data()));
  }

  // lfu: buckets keyed by count, LRU list inside (front = most recent)
  void bucket_push(int64_t idx) {
    Entry& e = entries_[idx];
    auto& lst = buckets_[e.count];
    lst.push_front(idx);
    e.pos = lst.begin();
  }

  void bucket_erase(Entry& e) {
    auto bit = buckets_.find(e.count);
    bit->second.erase(e.pos);
    if (bit->second.empty()) buckets_.erase(bit);
  }

  double Score(const Entry& e) const {
    double dist = (double)(iter_ - e.last);
    if (dist < 1.0) dist = 1.0;
    return (double)e.count / std::pow(dist, decay_);
  }

  // Entries touched in the CURRENT Transform call (last == iter_) are
  // protected, mirroring the reference's batch admission: the incoming
  // batch never churns against itself.  The caller must keep the cache
  // at least as large as a batch's distinct-id working set.
  bool Protected(const Entry& e) const { return e.last == iter_; }

  int64_t PickVictim() {
    if (policy_ == 0) {
      // min count bucket, LRU within it, skipping protected entries
      for (auto& [cnt, lst] : buckets_) {
        for (auto rit = lst.rbegin(); rit != lst.rend(); ++rit) {
          if (!Protected(entries_[*rit])) return *rit;
        }
      }
      return buckets_.begin()->second.back();  // all protected: overflow
    }
    // distance_lfu
    int64_t total = (int64_t)entries_.size();
    if (total <= kExactScanMax) {
      int64_t best = -1;
      double best_s = 0.0;
      for (int64_t j = 0; j < total; ++j) {
        if (Protected(entries_[j])) continue;
        double s = Score(entries_[j]);
        if (best < 0 || s < best_s) {
          best_s = s;
          best = j;
        }
      }
      return best >= 0 ? best : 0;
    }
    // deterministic sampled argmin (LCG)
    int64_t best = -1;
    double best_s = 0.0;
    for (int p = 0; p < kSampleProbes * 4 && best < 0; ) {
      for (int q = 0; q < kSampleProbes; ++q, ++p) {
        seed_ = seed_ * 6364136223846793005ull + 1442695040888963407ull;
        int64_t j = (int64_t)(seed_ % (uint64_t)total);
        if (Protected(entries_[j])) continue;
        double s = Score(entries_[j]);
        if (best < 0 || s < best_s) {
          best_s = s;
          best = j;
        }
      }
    }
    if (best < 0) {
      for (int64_t j = 0; j < total; ++j) {
        if (!Protected(entries_[j])) return j;
      }
      return 0;
    }
    return best;
  }

  const int64_t capacity_;
  const int policy_;  // 0 = lfu, 1 = distance_lfu
  const double decay_;
  std::mutex mu_;
  int64_t iter_ = 0;
  uint64_t seed_ = 0x9e3779b97f4a7c15ull;
  std::unordered_map<int64_t, int64_t> map_;  // gid -> entries_ index
  std::vector<Entry> entries_;
  std::map<int64_t, std::list<int64_t>> buckets_;  // lfu only
};

}  // namespace

extern "C" {

void* trt_lfu_create(int64_t capacity, int policy, double decay) {
  return new LfuIdTransformer(capacity, policy, decay);
}

void trt_lfu_destroy(void* t) { delete static_cast<LfuIdTransformer*>(t); }

int64_t trt_lfu_transform(void* t, const int64_t* ids, int64_t n,
                           int64_t* slots, int64_t* evicted_global,
                           int64_t* evicted_slot, int64_t* evicted_count) {
  return static_cast<LfuIdTransformer*>(t)->Transform(
      ids, n, slots, evicted_global, evicted_slot, evicted_count);
}

int64_t trt_lfu_size(void* t) {
  return static_cast<LfuIdTransformer*>(t)->Size();
}

}  // extern "C"
