// host_io: the host-side data-path kernels of crossclr_tpu_torch.
//
// The port's own copy of the JAX package's native/crossclr_io.cc (the port
// imports nothing of that package and builds nothing under native/).
// Contrastive training is fed from pre-extracted feature stores, and the
// host-side cost is assembling batches: gathering shuffled rows out of a
// memory-mapped feature matrix, and optionally converting fp32 -> bf16,
// before the host->device copy.  numpy does both on one thread; these
// kernels run on a PERSISTENT thread pool (spawning threads per batch costs
// more than a 4k-row gather).  The port's prefetch worker calls them with
// the GIL released (ctypes), gathering straight into pinned staging memory
// while the training step runs.
//
// Built with g++ at first use by crossclr_tpu_torch/data/native_io.py into
// crossclr_tpu_torch/data/_build/; a failed build raises there.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

class Pool {
 public:
  static Pool& instance() {
    static Pool pool;
    return pool;
  }

  // Run fn(i) for i in [0, n), blocking until done.  Safe for concurrent
  // callers (ctypes releases the GIL): epochs are serialized by run_m_ —
  // without it a second caller would repoint fn_/counters mid-epoch.
  void run(int64_t n, const std::function<void(int64_t)>& fn, int max_threads) {
    if (n <= 0) return;
    std::lock_guard<std::mutex> serialize(run_m_);
    int active = static_cast<int>(std::min<int64_t>(
        {static_cast<int64_t>(workers_.size() + 1), n,
         static_cast<int64_t>(max_threads > 0 ? max_threads : 1)}));
    if (active <= 1) {
      for (int64_t i = 0; i < n; ++i) fn(i);
      return;
    }
    {
      std::unique_lock<std::mutex> lock(m_);
      fn_ = &fn;
      total_ = n;
      remaining_.store(n, std::memory_order_relaxed);
      next_.store(0, std::memory_order_release);
      max_participants_ = active;  // honor the caller's thread budget
      ++in_work_;  // the caller participates in this epoch too
      ++epoch_;
      cv_.notify_all();
    }
    work(&fn, n);  // caller participates
    std::unique_lock<std::mutex> lock(m_);
    // wait until every task is done AND every worker has left work() —
    // a worker descheduled inside work() must not observe the next
    // epoch's re-initialized counters
    done_cv_.wait(lock, [&] {
      return remaining_.load() <= 0 && in_work_ == 0;
    });
    fn_ = nullptr;
  }

 private:
  Pool() {
    unsigned hw = std::thread::hardware_concurrency();
    int n = static_cast<int>(hw > 16 ? 16 : (hw > 1 ? hw : 1)) - 1;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { worker_loop(); });
    }
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lock(m_);
      stop_ = true;
      cv_.notify_all();
    }
    for (auto& t : workers_) t.join();
  }

  // fn/total are passed in: they were snapshotted under the mutex by the
  // caller, so a late-running worker never reads re-initialized state
  void work(const std::function<void(int64_t)>* fn, int64_t total) {
    int64_t done_here = 0;
    for (;;) {
      int64_t i = next_.fetch_add(1, std::memory_order_relaxed);
      if (i >= total) break;
      (*fn)(i);
      ++done_here;
    }
    bool last_tasks =
        done_here > 0 &&
        remaining_.fetch_sub(done_here, std::memory_order_acq_rel) ==
            done_here;
    {
      std::unique_lock<std::mutex> lock(m_);
      --in_work_;
      if (last_tasks || in_work_ == 0) done_cv_.notify_all();
    }
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      std::unique_lock<std::mutex> lock(m_);
      cv_.wait(lock, [&] { return stop_ || epoch_ != seen; });
      if (stop_) return;
      seen = epoch_;
      if (fn_ == nullptr) continue;
      if (in_work_ >= max_participants_) continue;  // thread budget reached
      const std::function<void(int64_t)>* fn = fn_;  // snapshot under lock
      int64_t total = total_;
      ++in_work_;
      lock.unlock();
      work(fn, total);
    }
  }

  std::vector<std::thread> workers_;
  std::mutex run_m_;  // serializes run() epochs across calling threads
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t)>* fn_ = nullptr;
  std::atomic<int64_t> next_{0};
  std::atomic<int64_t> remaining_{0};
  int64_t total_ = 0;
  int in_work_ = 0;  // workers currently inside work(); guarded by m_
  int max_participants_ = 0;  // caller's thread budget for the epoch
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

// round-to-nearest-even fp32 -> bf16, NaN-preserving (matches XLA /
// ml_dtypes: truncating a NaN whose payload lives in the low mantissa bits
// would otherwise round to +/-Inf)
inline uint16_t to_bf16(uint32_t bits) {
  if ((bits & 0x7fffffffu) > 0x7f800000u) {  // NaN: keep quiet-NaN payload
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  }
  uint32_t rounding = 0x7fff + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

}  // namespace

extern "C" {

// Gather rows: dst[i, :] = src[idx[i], :].  Arbitrary row size in bytes, so
// one entry point serves fp32/bf16/fp16 features of any dim.
// src_row_stride (bytes between consecutive source rows) may exceed
// row_bytes: strided row views (e.g. per-host dataset shards src[p::P])
// keep the native path.  Rows are chunked so each task moves ~256 KiB.
void crossclr_gather_rows(const void* src, void* dst, const int64_t* idx,
                          int64_t n_idx, int64_t row_bytes,
                          int64_t src_row_stride, int n_threads) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  int64_t rows_per_task = (256 * 1024) / (row_bytes > 0 ? row_bytes : 1);
  if (rows_per_task < 1) rows_per_task = 1;
  int64_t tasks = (n_idx + rows_per_task - 1) / rows_per_task;
  Pool::instance().run(
      tasks,
      [&](int64_t task) {
        int64_t start = task * rows_per_task;
        int64_t end = std::min(start + rows_per_task, n_idx);
        for (int64_t i = start; i < end; ++i) {
          std::memcpy(d + i * row_bytes, s + idx[i] * src_row_stride,
                      static_cast<size_t>(row_bytes));
        }
      },
      n_threads);
}

// fp32 -> bf16 with round-to-nearest-even (matches XLA's conversion).
void crossclr_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                          int n_threads) {
  const auto* bits = reinterpret_cast<const uint32_t*>(src);
  const int64_t chunk = 1 << 18;
  int64_t tasks = (n + chunk - 1) / chunk;
  Pool::instance().run(
      tasks,
      [&](int64_t task) {
        int64_t start = task * chunk;
        int64_t end = std::min(start + chunk, n);
        for (int64_t i = start; i < end; ++i) dst[i] = to_bf16(bits[i]);
      },
      n_threads);
}

int crossclr_io_version() { return 5; }

}  // extern "C"
