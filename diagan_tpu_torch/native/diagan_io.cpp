// diagan_io: the port's native host-side data runtime (its own copy of
// diagan_tpu/native/diagan_io.cpp, the same code, so the same seed gives
// the same draws in both packages).
//
// The reference's host data path is torch DataLoader C++ worker processes +
// WeightedRandomSampler (reference train_mimicry_phase1.py:18-24,
// train_mimicry_phase2.py:21-34). The StyleGAN2 trainer keeps its dataset
// on the card unless it is larger than the card's data budget (FFHQ-256 is
// 13.76 GB of uint8); then it streams real batches from the host, and this
// library assembles them:
//   - an O(1) alias-method weighted sampler (Walker 1977) with xoshiro256**
//     RNG, the WeightedRandomSampler equivalent,
//   - a multi-threaded prefetching batch loader over a caller-owned uint8
//     array: gather by sampled indices + dequantize to float32 [-1,1] into
//     a bounded queue of buffers,
//   - a threaded uint8 gather (the trainer's real batches and its sweep),
//   - a parallel uint8 -> float32 [-1,1] normalizer.
// C ABI for ctypes. native/io.py builds it with g++ at first use into
// diagan_tpu_torch/build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---- xoshiro256** ---------------------------------------------------------
struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 init
    uint64_t x = seed;
    for (auto& si : s) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      si = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

// ---- alias-method weighted sampler ---------------------------------------
struct AliasSampler {
  std::vector<double> prob;
  std::vector<int64_t> alias;
  int64_t n = 0;
  Xoshiro rng;

  AliasSampler(const double* w, int64_t n_, uint64_t seed) : rng(seed) {
    n = n_;
    prob.resize(n);
    alias.resize(n);
    double total = 0;
    for (int64_t i = 0; i < n; ++i) total += w[i];
    std::vector<double> scaled(n);
    for (int64_t i = 0; i < n; ++i) scaled[i] = w[i] * n / total;
    std::vector<int64_t> small, large;
    small.reserve(n);
    large.reserve(n);
    for (int64_t i = 0; i < n; ++i)
      (scaled[i] < 1.0 ? small : large).push_back(i);
    while (!small.empty() && !large.empty()) {
      int64_t s = small.back();
      small.pop_back();
      int64_t l = large.back();
      large.pop_back();
      prob[s] = scaled[s];
      alias[s] = l;
      scaled[l] = scaled[l] + scaled[s] - 1.0;
      (scaled[l] < 1.0 ? small : large).push_back(l);
    }
    for (int64_t i : large) prob[i] = 1.0;
    for (int64_t i : small) prob[i] = 1.0;
  }

  int64_t draw() {
    uint64_t r = rng.next();
    int64_t col = (int64_t)(r % (uint64_t)n);
    return rng.uniform() < prob[col] ? col : alias[col];
  }
};

// ---- prefetching batch loader --------------------------------------------
struct Batch {
  std::vector<float> data;
  std::vector<int64_t> idx;
};

struct Loader {
  const uint8_t* src;
  int64_t n, item_elems;
  int batch;
  AliasSampler* sampler;  // nullptr -> uniform
  Xoshiro uniform_rng;
  std::vector<std::thread> workers;
  std::queue<Batch*> queue;
  std::mutex mu, sample_mu;
  std::condition_variable cv_push, cv_pop;
  size_t cap;
  std::atomic<bool> stop{false};

  Loader(const uint8_t* src_, int64_t n_, int64_t item_elems_,
         const double* w, int batch_, int n_threads, int cap_, uint64_t seed)
      : src(src_), n(n_), item_elems(item_elems_), batch(batch_),
        sampler(w ? new AliasSampler(w, n_, seed) : nullptr),
        uniform_rng(seed ^ 0xabcdef), cap(cap_) {
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { work(); });
  }

  void sample_indices(int64_t* out) {
    std::lock_guard<std::mutex> lk(sample_mu);
    for (int i = 0; i < batch; ++i)
      out[i] = sampler ? sampler->draw()
                       : (int64_t)(uniform_rng.next() % (uint64_t)n);
  }

  void work() {
    while (!stop.load()) {
      auto* b = new Batch;
      b->idx.resize(batch);
      b->data.resize((size_t)batch * item_elems);
      sample_indices(b->idx.data());
      for (int i = 0; i < batch; ++i) {
        const uint8_t* it = src + b->idx[i] * item_elems;
        float* dst = b->data.data() + (size_t)i * item_elems;
        for (int64_t j = 0; j < item_elems; ++j)
          dst[j] = it[j] * (1.0f / 127.5f) - 1.0f;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [this] { return queue.size() < cap || stop.load(); });
      if (stop.load()) {
        delete b;
        return;
      }
      queue.push(b);
      cv_pop.notify_one();
    }
  }

  bool next(float* out_data, int64_t* out_idx) {
    Batch* b = nullptr;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_pop.wait(lk, [this] { return !queue.empty() || stop.load(); });
      if (queue.empty()) return false;
      b = queue.front();
      queue.pop();
      cv_push.notify_one();
    }
    std::memcpy(out_data, b->data.data(), b->data.size() * sizeof(float));
    std::memcpy(out_idx, b->idx.data(), b->idx.size() * sizeof(int64_t));
    delete b;
    return true;
  }

  ~Loader() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& w : workers) w.join();
    while (!queue.empty()) {
      delete queue.front();
      queue.pop();
    }
    delete sampler;
  }
};

}  // namespace

extern "C" {

void* ws_create(const double* w, int64_t n, uint64_t seed) {
  return new AliasSampler(w, n, seed);
}
void ws_sample(void* h, int64_t* out, int64_t count) {
  auto* s = static_cast<AliasSampler*>(h);
  for (int64_t i = 0; i < count; ++i) out[i] = s->draw();
}
void ws_destroy(void* h) { delete static_cast<AliasSampler*>(h); }

void* dl_create(const uint8_t* data, int64_t n, int64_t item_elems,
                const double* weights, int batch, int n_threads,
                int queue_cap, uint64_t seed) {
  return new Loader(data, n, item_elems, weights, batch, n_threads,
                    queue_cap, seed);
}
int dl_next(void* h, float* out_data, int64_t* out_idx) {
  return static_cast<Loader*>(h)->next(out_data, out_idx) ? 1 : 0;
}
void dl_destroy(void* h) { delete static_cast<Loader*>(h); }

// Threaded fancy-index gather: out[i] = base[idx[i]] (uint8 items of
// item_elems each). Used by the host-streaming StyleGAN2 data path to
// assemble chunk batch stacks from a memory-mapped dataset.
void gather_u8(const uint8_t* base, int64_t item_elems, const int64_t* idx,
               int64_t count, uint8_t* out, int threads) {
  if (threads < 1) threads = 1;
  std::vector<std::thread> ts;
  int64_t chunk = (count + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(count, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(out + i * item_elems, base + idx[i] * item_elems,
                    item_elems);
    });
  }
  for (auto& t : ts) t.join();
}

void normalize_u8_f32(const uint8_t* in, float* out, int64_t n, int threads) {
  if (threads < 1) threads = 1;
  std::vector<std::thread> ts;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i)
        out[i] = in[i] * (1.0f / 127.5f) - 1.0f;
    });
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
