// Streaming chain store: append-only binary log for host-offloaded MCMC
// chunks, written by a dedicated background thread so device→host transfers
// and disk IO overlap with the next on-device scan chunk.
//
// This is the framework's native IO runtime (≙ SURVEY.md's note that the
// reference has no native components — the data-path pieces here are new:
// at 10k chains × 100k steps the sample stream is ~10 GB/run and a
// synchronous np.savez in the sampling loop would stall the accelerator
// pipeline).
//
// C API (ctypes-friendly):
//   handle = cs_open(path, n_cols)         // float32 rows of n_cols
//   cs_append(handle, data, n_rows)        // enqueue a copy; returns queued rows
//   cs_flush(handle)                       // block until queue drained+fsynced
//   cs_rows(handle)                        // rows durably written
//   cs_close(handle)                       // flush + close; frees handle
//   cs_last_error(handle)                  // 0 ok, else errno-style code
//
// File format: raw little-endian float32, row-major [rows × n_cols]; the
// Python side records n_cols + dtype in a sidecar json and memory-maps the
// log for reading.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Chunk {
  std::vector<float> data;
};

struct Store {
  FILE* file = nullptr;
  int64_t n_cols = 0;
  std::deque<Chunk> queue;
  std::mutex mu;
  std::condition_variable cv_push;   // signals the writer
  std::condition_variable cv_drain;  // signals flushers
  std::thread writer;
  std::atomic<int64_t> rows_written{0};
  std::atomic<int> error{0};
  bool closing = false;
  bool idle = true;

  void run() {
    for (;;) {
      Chunk chunk;
      {
        std::unique_lock<std::mutex> lock(mu);
        idle = queue.empty();
        if (idle) cv_drain.notify_all();
        cv_push.wait(lock, [&] { return closing || !queue.empty(); });
        if (queue.empty() && closing) return;
        chunk = std::move(queue.front());
        queue.pop_front();
        idle = false;
      }
      size_t n = chunk.data.size();
      if (n > 0 && error.load() == 0) {
        size_t written = fwrite(chunk.data.data(), sizeof(float), n, file);
        if (written != n) {
          error.store(ferror(file) ? ferror(file) : -1);
        } else {
          rows_written.fetch_add(static_cast<int64_t>(n) / n_cols);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* cs_open(const char* path, int64_t n_cols) {
  if (n_cols <= 0) return nullptr;
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* s = new Store();
  s->file = f;
  s->n_cols = n_cols;
  s->writer = std::thread([s] { s->run(); });
  return s;
}

int64_t cs_append(void* handle, const float* data, int64_t n_rows) {
  auto* s = static_cast<Store*>(handle);
  if (!s || n_rows < 0) return -1;
  Chunk c;
  c.data.assign(data, data + n_rows * s->n_cols);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->closing) return -1;
    s->queue.push_back(std::move(c));
    s->idle = false;
  }
  s->cv_push.notify_one();
  return n_rows;
}

int cs_flush(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  {
    std::unique_lock<std::mutex> lock(s->mu);
    s->cv_drain.wait(lock, [&] { return s->idle && s->queue.empty(); });
  }
  // Durability, as documented: libc buffer → kernel → disk.
  if (fflush(s->file) != 0) s->error.store(-2);
  else if (fsync(fileno(s->file)) != 0) s->error.store(-2);
  return s->error.load();
}

int64_t cs_rows(void* handle) {
  auto* s = static_cast<Store*>(handle);
  return s ? s->rows_written.load() : -1;
}

int cs_last_error(void* handle) {
  auto* s = static_cast<Store*>(handle);
  return s ? s->error.load() : -1;
}

int cs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->closing = true;
  }
  s->cv_push.notify_one();
  s->writer.join();
  int err = s->error.load();
  if (fflush(s->file) == 0) fsync(fileno(s->file));
  if (fclose(s->file) != 0) err = err ? err : -3;
  delete s;
  return err;
}

}  // extern "C"
