// Native host-side batch pipeline: shuffled gather + double-buffered
// prefetch on worker threads.
//
// Plays the role of the reference's torch DataLoader worker pool
// (num_workers args, e.g. helpers/pl_helpers.py:115): while the GPU runs
// step N, workers assemble batch N+1..N+depth on the host so dispatch never
// waits on the gather. Exposed through a plain C ABI consumed via ctypes
// (data/native_loader.py) - no pybind11 dependency. A copy of the JAX
// package's native/batcher.cpp: the same XorShift Fisher-Yates shuffle per
// epoch, so a seed gives the same batches in both packages.
//
// Model: the caller owns a contiguous float32 array of N samples x S floats
// (our datasets are in-memory, data/datasets.py). A Batcher owns a worker
// thread that fills a ring of batch buffers following a per-epoch
// Fisher-Yates permutation (xorshift RNG, seeded). `next` hands back a
// filled slot; `release` recycles it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct XorShift {
  uint64_t state;
  explicit XorShift(uint64_t seed) : state(seed ? seed : 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    state ^= state << 13;
    state ^= state >> 7;
    state ^= state << 17;
    return state;
  }
  // unbiased bounded draw (rejection)
  uint64_t bounded(uint64_t n) {
    uint64_t lim = UINT64_MAX - (UINT64_MAX % n);
    uint64_t v;
    do { v = next(); } while (v >= lim);
    return v % n;
  }
};

struct Batcher {
  const float* data = nullptr;
  int64_t n_samples = 0;
  int64_t sample_size = 0;
  int64_t batch_size = 0;
  bool shuffle = true;
  bool drop_last = true;
  uint64_t seed = 0;

  int64_t batches_per_epoch = 0;

  // ring of prefetched buffers (+ per-slot sample counts: short final
  // batches when drop_last is off)
  std::vector<std::vector<float>> slots;
  std::vector<int64_t> slot_counts;
  std::queue<int> ready;        // filled slots, FIFO
  std::queue<int> free_slots;   // empty slots
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop{false};
  std::thread worker;

  std::vector<int64_t> perm;
  int64_t cursor = 0;           // next sample index within the epoch
  uint64_t epoch = 0;

  void reshuffle() {
    perm.resize(n_samples);
    for (int64_t i = 0; i < n_samples; ++i) perm[i] = i;
    if (shuffle) {
      XorShift rng(seed + 0x1000003 * (epoch + 1));
      for (int64_t i = n_samples - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng.bounded(i + 1));
        std::swap(perm[i], perm[j]);
      }
    }
  }

  // Fills up to batch_size samples WITHOUT crossing an epoch boundary:
  // with drop_last=false the final batch of an epoch is short, exactly
  // like the numpy batch_iterator it stands in for. Returns the count.
  int64_t fill(float* out) {
    if (cursor >= n_samples) {  // start the next epoch
      ++epoch;
      cursor = 0;
      reshuffle();
    }
    int64_t take = std::min(batch_size, n_samples - cursor);
    for (int64_t b = 0; b < take; ++b) {
      const float* src = data + perm[cursor] * sample_size;
      std::memcpy(out + b * sample_size, src,
                  sizeof(float) * static_cast<size_t>(sample_size));
      ++cursor;
    }
    if (drop_last && n_samples - cursor < batch_size) {
      ++epoch;
      cursor = 0;
      reshuffle();
    }
    return take;
  }

  void run() {
    for (;;) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_slots.empty(); });
        if (stop.load()) return;
        slot = free_slots.front();
        free_slots.pop();
      }
      slot_counts[slot] = fill(slots[slot].data());
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(slot);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* batcher_create(const float* data, int64_t n_samples,
                     int64_t sample_size, int64_t batch_size, int shuffle,
                     uint64_t seed, int drop_last, int prefetch_depth) {
  if (n_samples <= 0 || sample_size <= 0 || batch_size <= 0 ||
      prefetch_depth <= 0)
    return nullptr;
  // drop_last with batch_size > n would never emit a batch (and the
  // epoch-bounded fill would spin) - reject it loudly
  if (drop_last != 0 && batch_size > n_samples) return nullptr;
  auto* b = new Batcher();
  b->data = data;
  b->n_samples = n_samples;
  b->sample_size = sample_size;
  b->batch_size = batch_size;
  b->shuffle = shuffle != 0;
  b->drop_last = drop_last != 0;
  b->seed = seed;
  b->batches_per_epoch =
      b->drop_last ? n_samples / batch_size
                   : (n_samples + batch_size - 1) / batch_size;
  b->slots.resize(prefetch_depth);
  b->slot_counts.assign(prefetch_depth, 0);
  for (int i = 0; i < prefetch_depth; ++i) {
    b->slots[i].resize(static_cast<size_t>(batch_size * sample_size));
    b->free_slots.push(i);
  }
  b->reshuffle();
  b->worker = std::thread(&Batcher::run, b);
  return b;
}

int64_t batcher_batches_per_epoch(void* handle) {
  return static_cast<Batcher*>(handle)->batches_per_epoch;
}

// Blocks until a batch is ready; copies it into `out` (up to batch*sample
// floats) and recycles the slot. Returns the number of samples in the
// batch (< batch_size only for a drop_last=false epoch tail), or -1 on
// shutdown.
int64_t batcher_next(void* handle, float* out) {
  auto* b = static_cast<Batcher*>(handle);
  int slot;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_ready.wait(lk, [&] { return b->stop.load() || !b->ready.empty(); });
    if (b->stop.load()) return -1;
    slot = b->ready.front();
    b->ready.pop();
  }
  int64_t count = b->slot_counts[slot];
  std::memcpy(out, b->slots[slot].data(),
              sizeof(float) * static_cast<size_t>(count * b->sample_size));
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->free_slots.push(slot);
  }
  b->cv_free.notify_one();
  return count;
}

void batcher_destroy(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  b->stop.store(true);
  b->cv_free.notify_all();
  b->cv_ready.notify_all();
  if (b->worker.joinable()) b->worker.join();
  delete b;
}

}  // extern "C"
