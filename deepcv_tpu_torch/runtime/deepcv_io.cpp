// deepcv_io — native host-side data runtime of deepcv_tpu_torch.
//
// What stays on the host of the streaming input path is batch ASSEMBLY:
// shuffled gathers from large contiguous arrays (a memmap of the whole
// trainset) into staging buffers that are then copied to the card. This
// library does that part natively:
//
//   * deepcv_gather_batch     — multi-threaded strided gather (one memcpy per
//                               sample row, threads partition the batch)
//   * deepcv_loader_*         — a background-producer ring buffer: a C++
//                               thread keeps `depth` pre-gathered batches
//                               ready (each epoch's order is a Fisher-Yates
//                               shuffle by std::mt19937_64 seeded with
//                               seed + epoch), and Python copies the next
//                               one out.
//
// The same code as the JAX package's runtime, so both packages stream the
// same batches for the same seed. A plain C ABI shared library, bound with
// ctypes (deepcv_tpu_torch/runtime/native.py). Thread count defaults to
// hardware_concurrency.
//
// Built at first use by deepcv_tpu_torch/ops/kernels/_build.py (build_host):
//   g++ -O3 -std=c++17 -fPIC -shared -pthread -o libdeepcv_io-<hash>.so deepcv_io.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Threaded batch gather: out[i] = data[indices[i]] for row-major samples.
// ---------------------------------------------------------------------------
void deepcv_gather_batch(const uint8_t* data, int64_t sample_bytes,
                         const int64_t* indices, int64_t batch,
                         uint8_t* out, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads == 1 || batch < 2 * n_threads) {
    for (int64_t i = 0; i < batch; ++i) {
      std::memcpy(out + i * sample_bytes, data + indices[i] * sample_bytes,
                  static_cast<size_t>(sample_bytes));
    }
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t per = (batch + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(batch, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(out + i * sample_bytes, data + indices[i] * sample_bytes,
                    static_cast<size_t>(sample_bytes));
      }
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Background-producer batch loader (ring buffer of pre-gathered batches).
// ---------------------------------------------------------------------------
namespace {

struct Slot {
  std::vector<uint8_t> images;
  std::vector<uint8_t> targets;
  int64_t epoch = -1;
  int64_t step = -1;
};

struct Loader {
  // immutable dataset views (owned by Python; must outlive the loader)
  const uint8_t* images = nullptr;
  const uint8_t* targets = nullptr;
  int64_t n = 0;
  int64_t image_bytes = 0;
  int64_t target_bytes = 0;
  int64_t batch = 0;
  int64_t steps_per_epoch = 0;
  uint64_t seed = 0;
  bool shuffle = true;

  std::vector<Slot> ring;
  size_t depth = 0;
  // producer/consumer cursors (in absolute step numbers)
  std::atomic<int64_t> produced{0};
  std::atomic<int64_t> consumed{0};
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::thread worker;
  std::vector<int64_t> perm;
  int64_t perm_epoch = -1;

  void ensure_perm(int64_t epoch) {
    if (perm_epoch == epoch) return;
    perm.resize(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) perm[static_cast<size_t>(i)] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      for (int64_t i = n - 1; i > 0; --i) {
        const int64_t j =
            static_cast<int64_t>(rng() % static_cast<uint64_t>(i + 1));
        std::swap(perm[static_cast<size_t>(i)], perm[static_cast<size_t>(j)]);
      }
    }
    perm_epoch = epoch;
  }

  void produce_one(int64_t step) {
    const int64_t epoch = step / steps_per_epoch;
    const int64_t k = step % steps_per_epoch;
    ensure_perm(epoch);
    Slot& s = ring[static_cast<size_t>(step % static_cast<int64_t>(depth))];
    const int64_t* idx = perm.data() + k * batch;
    deepcv_gather_batch(images, image_bytes, idx, batch, s.images.data(), 0);
    deepcv_gather_batch(targets, target_bytes, idx, batch, s.targets.data(), 0);
    s.epoch = epoch;
    s.step = step;
  }

  void run() {
    while (!stop.load(std::memory_order_relaxed)) {
      const int64_t next = produced.load(std::memory_order_relaxed);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_producer.wait(lk, [&] {
          return stop.load(std::memory_order_relaxed) ||
                 next - consumed.load(std::memory_order_relaxed) <
                     static_cast<int64_t>(depth);
        });
      }
      if (stop.load(std::memory_order_relaxed)) return;
      produce_one(next);
      {
        // publish under the mutex: a store+notify outside it can land between
        // the consumer's locked predicate check and its atomic release+sleep,
        // losing the wakeup (deadlocks at depth=1 where no later notify
        // rescues the sleeper)
        std::lock_guard<std::mutex> lk(mu);
        produced.store(next + 1, std::memory_order_release);
      }
      cv_consumer.notify_one();
    }
  }
};

}  // namespace

void* deepcv_loader_create(const uint8_t* images, const uint8_t* targets,
                           int64_t n, int64_t image_bytes, int64_t target_bytes,
                           int64_t batch, int32_t depth, uint64_t seed,
                           int32_t shuffle) {
  if (n <= 0 || batch <= 0 || n < batch) return nullptr;
  auto* L = new (std::nothrow) Loader();
  if (!L) return nullptr;
  L->images = images;
  L->targets = targets;
  L->n = n;
  L->image_bytes = image_bytes;
  L->target_bytes = target_bytes;
  L->batch = batch;
  L->steps_per_epoch = n / batch;
  L->seed = seed;
  L->shuffle = shuffle != 0;
  L->depth = static_cast<size_t>(depth > 0 ? depth : 2);
  L->ring.resize(L->depth);
  for (auto& s : L->ring) {
    s.images.resize(static_cast<size_t>(batch * image_bytes));
    s.targets.resize(static_cast<size_t>(batch * target_bytes));
  }
  L->worker = std::thread([L] { L->run(); });
  return L;
}

int64_t deepcv_loader_steps_per_epoch(void* loader) {
  return loader ? static_cast<Loader*>(loader)->steps_per_epoch : 0;
}

// Blocks until the next batch is ready; copies it into the caller's buffers.
// Returns the absolute step number, or -1 on error.
int64_t deepcv_loader_next(void* loader, uint8_t* images_out,
                           uint8_t* targets_out) {
  if (!loader) return -1;
  auto* L = static_cast<Loader*>(loader);
  const int64_t want = L->consumed.load(std::memory_order_relaxed);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_consumer.wait(lk, [&] {
      return L->stop.load(std::memory_order_relaxed) ||
             L->produced.load(std::memory_order_acquire) > want;
    });
  }
  if (L->stop.load(std::memory_order_relaxed)) return -1;
  Slot& s = L->ring[static_cast<size_t>(want % static_cast<int64_t>(L->depth))];
  std::memcpy(images_out, s.images.data(), s.images.size());
  std::memcpy(targets_out, s.targets.data(), s.targets.size());
  {
    std::lock_guard<std::mutex> lk(L->mu);  // see produced store: same race
    L->consumed.store(want + 1, std::memory_order_release);
  }
  L->cv_producer.notify_one();
  return want;
}

void deepcv_loader_destroy(void* loader) {
  if (!loader) return;
  auto* L = static_cast<Loader*>(loader);
  L->stop.store(true);
  L->cv_producer.notify_all();
  L->cv_consumer.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

int32_t deepcv_io_version() { return 1; }

}  // extern "C"
