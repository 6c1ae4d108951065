// Native segment loader: multithreaded MusDB segment server.
//
// The hot host-side path of training is "slice (mixture, target) segment
// pairs out of per-track arrays, augment, batch".  This loader mmaps the
// decode-once `.npy` track cache (zero-copy reads straight from the page
// cache), builds the same (track, stem, segment) index map as the Python
// dataset, and serves shuffled, augmented, batched segments from a producer
// thread pool through a bounded queue, so the device step stays the only
// bottleneck.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment):
//   sl_create(paths, n, segment, batch, seed, threads, augment, random)
//   sl_epoch_size(h)        -> batches per epoch
//   sl_next(h, mix, tgt, stem_idx) -> 1 on success, 0 at epoch end
//   sl_reset(h, epoch_seed) -> start a new (re-shuffled) epoch
//   sl_destroy(h)
//
// Layout contract: each track file is a v1/v2 .npy, float32 C-order,
// shape (5, channels, T) = [mixture, drums, bass, other, vocals].

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Track {
  const float* data = nullptr;   // mmapped payload
  size_t mapped_size = 0;
  void* map_base = nullptr;
  int64_t channels = 0;
  int64_t samples = 0;

  const float* stem(int64_t s) const { return data + s * channels * samples; }
};

bool parse_npy(const char* path, Track* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return false; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return false;
  const unsigned char* p = static_cast<const unsigned char*>(base);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(base, st.st_size);
    return false;
  }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (p[10] << 16)
        | (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  std::string header(reinterpret_cast<const char*>(p) + header_off, header_len);
  if (header.find("'descr': '<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    munmap(base, st.st_size);
    return false;
  }
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) { munmap(base, st.st_size); return false; }
  long long d0 = 0, d1 = 0, d2 = 0;
  if (sscanf(header.c_str() + sp, "'shape': (%lld, %lld, %lld)",
             &d0, &d1, &d2) != 3 || d0 != 5) {
    munmap(base, st.st_size);
    return false;
  }
  // a truncated cache (interrupted write) keeps its intact header but not
  // the payload: reading past the mapping is SIGBUS, so validate the size
  size_t need = header_off + header_len
      + static_cast<size_t>(d0) * d1 * d2 * sizeof(float);
  if (static_cast<size_t>(st.st_size) < need) {
    munmap(base, st.st_size);
    return false;
  }
  out->map_base = base;
  out->mapped_size = st.st_size;
  out->data = reinterpret_cast<const float*>(p + header_off + header_len);
  out->channels = d1;
  out->samples = d2;
  return true;
}

struct Sample { int track; int stem; int64_t seg; };

struct Batch {
  std::vector<float> mixture;   // (batch, 2, segment)
  std::vector<float> target;
  std::vector<int32_t> stem_idx;
};

class Loader {
 public:
  Loader(std::vector<std::string> paths, int64_t segment, int batch,
         uint64_t seed, int n_threads, bool augment, bool random_segments)
      : segment_(segment), batch_(batch), seed_(seed),
        n_threads_(std::max(1, n_threads)), augment_(augment),
        random_(random_segments) {
    for (const auto& p : paths) {
      Track t;
      if (parse_npy(p.c_str(), &t)) {
        tracks_.push_back(t);
      } else {
        // surface corrupt/unparseable caches instead of silently training
        // on a shrunken dataset (the Python path raises on such files)
        std::fprintf(stderr,
                     "segment_loader: skipping unparseable npy: %s\n",
                     p.c_str());
      }
    }
    for (int ti = 0; ti < static_cast<int>(tracks_.size()); ++ti) {
      int64_t n_seg = std::max<int64_t>(
          1, (tracks_[ti].samples + segment_ - 1) / segment_);
      for (int stem = 0; stem < 4; ++stem)
        for (int64_t s = 0; s < n_seg; ++s)
          index_.push_back({ti, stem, s});
    }
    reset(seed_);
  }

  ~Loader() { stop(); for (auto& t : tracks_) munmap(t.map_base, t.mapped_size); }

  int64_t epoch_size() const {
    return static_cast<int64_t>(index_.size()) / batch_;
  }

  int track_count() const { return static_cast<int>(tracks_.size()); }

  void reset(uint64_t epoch_seed) {
    stop();
    std::mt19937_64 rng(epoch_seed);
    order_.resize(index_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    std::shuffle(order_.begin(), order_.end(), rng);
    next_batch_to_produce_ = 0;
    next_batch_to_emit_ = 0;
    stopping_ = false;
    for (int w = 0; w < n_threads_; ++w)
      workers_.emplace_back([this, w, epoch_seed] { work(w, epoch_seed); });
  }

  bool next(float* mix_out, float* tgt_out, int32_t* stem_out) {
    std::unique_lock<std::mutex> lk(mu_);
    consumer_cv_.wait(lk, [this] {
      return !ready_.empty() || done_count_ == n_threads_;
    });
    while (ready_.empty() || ready_.begin()->first != next_batch_to_emit_) {
      if (ready_.empty() && done_count_ == n_threads_) return false;
      consumer_cv_.wait(lk, [this] {
        return (!ready_.empty() &&
                ready_.begin()->first == next_batch_to_emit_) ||
               (ready_.empty() && done_count_ == n_threads_);
      });
      if (ready_.empty() && done_count_ == n_threads_) return false;
    }
    Batch b = std::move(ready_.begin()->second);
    ready_.erase(ready_.begin());
    ++next_batch_to_emit_;
    producer_cv_.notify_all();
    lk.unlock();
    memcpy(mix_out, b.mixture.data(), b.mixture.size() * sizeof(float));
    memcpy(tgt_out, b.target.data(), b.target.size() * sizeof(float));
    memcpy(stem_out, b.stem_idx.data(), b.stem_idx.size() * sizeof(int32_t));
    return true;
  }

 private:
  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stopping_ = true;
    }
    producer_cv_.notify_all();
    for (auto& t : workers_) t.join();
    workers_.clear();
    ready_.clear();
    done_count_ = 0;
  }

  void fill_sample(const Sample& s, std::mt19937_64& rng, float* mix,
                   float* tgt) {
    const Track& t = tracks_[s.track];
    int64_t start;
    if (random_ && t.samples > segment_) {
      std::uniform_int_distribution<int64_t> d(0, t.samples - segment_);
      start = d(rng);
    } else {
      start = std::min(s.seg * segment_, std::max<int64_t>(0, t.samples - 1));
    }
    int64_t avail = std::min(segment_, t.samples - start);
    const float* msrc = t.stem(0);
    const float* tsrc = t.stem(1 + s.stem);
    bool mono = t.channels == 1;
    for (int c = 0; c < 2; ++c) {
      int64_t sc = mono ? 0 : c;
      memcpy(mix + c * segment_, msrc + sc * t.samples + start,
             avail * sizeof(float));
      memcpy(tgt + c * segment_, tsrc + sc * t.samples + start,
             avail * sizeof(float));
      if (avail < segment_) {
        memset(mix + c * segment_ + avail, 0,
               (segment_ - avail) * sizeof(float));
        memset(tgt + c * segment_ + avail, 0,
               (segment_ - avail) * sizeof(float));
      }
    }
    if (augment_) {
      std::uniform_real_distribution<float> u01(0.f, 1.f);
      if (u01(rng) < 0.5f) {  // joint gain in U(0.7, 1.3)
        std::uniform_real_distribution<float> g(0.7f, 1.3f);
        float gain = g(rng);
        for (int64_t i = 0; i < 2 * segment_; ++i) {
          mix[i] *= gain;
          tgt[i] *= gain;
        }
      }
      if (u01(rng) < 0.3f) {  // channel swap
        for (int64_t i = 0; i < segment_; ++i) {
          std::swap(mix[i], mix[segment_ + i]);
          std::swap(tgt[i], tgt[segment_ + i]);
        }
      }
    }
  }

  void work(int worker_id, uint64_t epoch_seed) {
    (void)worker_id;
    const int64_t n_batches = epoch_size();
    while (true) {
      int64_t b = next_batch_to_produce_.fetch_add(1);
      if (b >= n_batches) break;
      // per-BATCH deterministic RNG stream: which worker grabs batch b is
      // scheduling-dependent, so a per-worker stream broke seeded
      // reproducibility across runs; per-batch streams make segment
      // starts and augmentation draws identical for ANY n_threads
      std::mt19937_64 rng(epoch_seed * 0x9E3779B97F4A7C15ull +
                          0xD1B54A32D192ED03ull * static_cast<uint64_t>(b + 1));
      Batch batch;
      batch.mixture.resize(batch_ * 2 * segment_);
      batch.target.resize(batch_ * 2 * segment_);
      batch.stem_idx.resize(batch_);
      for (int i = 0; i < batch_; ++i) {
        const Sample& s = index_[order_[b * batch_ + i]];
        batch.stem_idx[i] = s.stem;
        fill_sample(s, rng, batch.mixture.data() + i * 2 * segment_,
                    batch.target.data() + i * 2 * segment_);
      }
      std::unique_lock<std::mutex> lk(mu_);
      producer_cv_.wait(lk, [this, b] {
        return stopping_ || ready_.size() < kQueueCap ||
               b == next_batch_to_emit_;
      });
      if (stopping_) return;
      ready_.emplace(b, std::move(batch));
      consumer_cv_.notify_all();
    }
    std::lock_guard<std::mutex> lk(mu_);
    ++done_count_;
    consumer_cv_.notify_all();
  }

  static constexpr size_t kQueueCap = 8;

  std::vector<Track> tracks_;
  std::vector<Sample> index_;
  std::vector<size_t> order_;
  int64_t segment_;
  int batch_;
  uint64_t seed_;
  int n_threads_;
  bool augment_;
  bool random_;

  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable consumer_cv_, producer_cv_;
  std::map<int64_t, Batch> ready_;
  std::atomic<int64_t> next_batch_to_produce_{0};
  int64_t next_batch_to_emit_ = 0;
  int done_count_ = 0;
  bool stopping_ = false;
};

}  // namespace

extern "C" {

void* sl_create(const char** paths, int n_paths, long segment, int batch,
                unsigned long seed, int n_threads, int augment,
                int random_segments) {
  std::vector<std::string> ps(paths, paths + n_paths);
  auto* l = new Loader(ps, segment, batch, seed, n_threads, augment != 0,
                       random_segments != 0);
  return l;
}

long sl_epoch_size(void* h) { return static_cast<Loader*>(h)->epoch_size(); }

// tracks that actually parsed — callers compare against the path count to
// surface corrupt caches instead of silently training on a shrunken set
long sl_track_count(void* h) { return static_cast<Loader*>(h)->track_count(); }

int sl_next(void* h, float* mix, float* tgt, int32_t* stem_idx) {
  return static_cast<Loader*>(h)->next(mix, tgt, stem_idx) ? 1 : 0;
}

void sl_reset(void* h, unsigned long epoch_seed) {
  static_cast<Loader*>(h)->reset(epoch_seed);
}

void sl_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
