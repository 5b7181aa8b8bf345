// Threaded prefetching WAV data loader for the training host path.
//
// N reader threads decode WAV files (via wavio.cpp's wav_read_mono_f32)
// into a bounded queue ahead of the device step, so feature extraction
// (resample / mel / S3 tokenization, all on the device) never waits on disk.
// Built with g++ at first use and bound with ctypes by
// chatterbox_tpu_torch/runtime/__init__.py.
//
// ABI: plain C. A handle owns the thread pool; dl_next copies one decoded
// clip into a caller-owned buffer. Unreadable files are skipped (counted in
// dl_errors). Order is reshuffled every epoch from a seeded PRNG, so runs
// are reproducible.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" int64_t wav_read_mono_f32(const char* path, float* out,
                                     int64_t max_frames);

namespace {

struct Item {
  std::vector<float> data;
  int64_t index;   // position in the (shuffled) global order
  int64_t path_id; // original path index
};

struct Loader {
  std::vector<std::string> paths;
  int64_t max_frames;
  int32_t epochs;          // 0 = loop forever
  size_t queue_cap;
  std::mt19937_64 rng;
  bool shuffle;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Item> queue;
  std::vector<int64_t> order;
  std::atomic<int64_t> cursor{0};   // index into the current epoch's order
  std::atomic<int64_t> emitted{0};
  std::atomic<int64_t> errors{0};
  int32_t epoch = 0;
  bool done = false;          // all epochs CLAIMED (no new work to start)
  bool stopping = false;      // destroy requested (abandon queued/held work)
  int32_t running = 0;        // workers still alive (guarded by mu)
  std::vector<std::thread> workers;

  void reshuffle() {  // caller holds mu
    order.resize(paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int64_t)i;
    if (shuffle) {
      for (size_t i = order.size(); i > 1; --i) {
        size_t j = rng() % i;
        std::swap(order[i - 1], order[j]);
      }
    }
  }

  // claim the next path id, advancing epochs; -1 when exhausted
  int64_t claim(int64_t* global_index) {
    std::lock_guard<std::mutex> lk(mu);
    if (done || stopping) return -1;
    if (cursor >= (int64_t)order.size()) {
      ++epoch;
      if (epochs > 0 && epoch >= epochs) { done = true; cv_pop.notify_all(); return -1; }
      reshuffle();
      cursor = 0;
    }
    int64_t c = cursor++;
    *global_index = (int64_t)(epoch) * (int64_t)order.size() + c;
    return order[c];
  }

  void worker() {
    std::vector<float> buf((size_t)max_frames);
    for (;;) {
      int64_t gidx = 0;
      int64_t pid = claim(&gidx);
      if (pid < 0) break;
      int64_t n = wav_read_mono_f32(paths[(size_t)pid].c_str(), buf.data(),
                                    max_frames);
      if (n <= 0) { ++errors; continue; }
      Item it;
      it.data.assign(buf.begin(), buf.begin() + (size_t)n);
      it.index = gidx;
      it.path_id = pid;
      std::unique_lock<std::mutex> lk(mu);
      // gate ONLY on capacity and destroy: `done` (all paths claimed) must
      // not drop a decoded item — the worker that observed exhaustion in
      // claim() may race a peer still holding its final decode (seen as a
      // 1-in-N flaky missing clip under n_threads=2)
      cv_push.wait(lk, [&] { return queue.size() < queue_cap || stopping; });
      if (stopping) break;
      queue.push_back(std::move(it));
      cv_pop.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu);
    --running;
    cv_pop.notify_all();    // a consumer may be waiting on end-of-stream
  }
};

}  // namespace

extern "C" {

void* dl_create(const char** paths, int64_t n_paths, int32_t n_threads,
                int64_t max_frames, int32_t epochs, uint64_t seed,
                int32_t shuffle, int64_t queue_cap) {
  if (n_paths <= 0 || max_frames <= 0) return nullptr;
  auto* L = new Loader();
  L->paths.reserve((size_t)n_paths);
  for (int64_t i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->max_frames = max_frames;
  L->epochs = epochs;
  L->queue_cap = queue_cap > 0 ? (size_t)queue_cap : 64;
  L->rng.seed(seed);
  L->shuffle = shuffle != 0;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->reshuffle();
  }
  if (n_threads < 1) n_threads = 1;
  int64_t active = n_paths < n_threads ? n_paths : n_threads;
  L->running = (int32_t)active;
  for (int64_t i = 0; i < active; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Copies the next clip into out (capacity max_frames). Returns:
//   1  item delivered (n_frames / path_id / index filled)
//   0  end of stream (all epochs drained)
int32_t dl_next(void* h, float* out, int64_t* n_frames, int64_t* path_id,
                int64_t* index) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  // end-of-stream only when every worker exited AND the queue is empty —
  // a worker finishing its last claimed decode still pushes before exiting
  L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->running == 0; });
  if (L->queue.empty()) return 0;
  Item it = std::move(L->queue.front());
  L->queue.pop_front();
  L->cv_push.notify_one();
  lk.unlock();
  int64_t n = (int64_t)it.data.size();
  std::memcpy(out, it.data.data(), (size_t)n * sizeof(float));
  *n_frames = n;
  *path_id = it.path_id;
  *index = it.index;
  ++L->emitted;
  return 1;
}

int64_t dl_errors(void* h) { return ((Loader*)h)->errors.load(); }
int64_t dl_emitted(void* h) { return ((Loader*)h)->emitted.load(); }

void dl_destroy(void* h) {
  auto* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->done = true;
    L->stopping = true;
  }
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
