// Row copies between the cohort pool and its staging buffers, on the host.
//
// The cohort driver (gossipy_tpu_torch/simulation/cohort.py) gathers each
// cohort's rows out of the host pool and scatters its outputs back. Done
// from Python threads, every step needs the GIL, which the eager round's
// thread gives up and takes back at every op: a helper thread then waits
// for the GIL most of the time, or makes the round wait for it. Here the
// copies are plain memcpy's, either called directly (rows_gather,
// rows_scatter, rows_patch: ctypes releases the GIL for the call) or run
// in order on a worker thread of this library (rows_worker_*), which never
// touches the GIL: the round's thread enqueues a job and later waits for
// it, and the worker stamps each job's start and end on CLOCK_MONOTONIC
// (Python's perf_counter clock) for the trace.
//
// Leaves are row-major [rows, row_bytes] arrays; row ids are int64.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <time.h>
#include <unordered_map>

namespace {

constexpr int kMaxLeaves = 64;

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

void gather(int n_leaves, void* const* pool, void* const* buf,
            const int64_t* row_bytes, const int64_t* idx, int64_t n) {
  for (int l = 0; l < n_leaves; ++l) {
    const char* src = static_cast<const char*>(pool[l]);
    char* dst = static_cast<char*>(buf[l]);
    const int64_t rb = row_bytes[l];
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(dst + i * rb, src + idx[i] * rb, rb);
  }
}

int64_t scatter(int n_leaves, void* const* pool, void* const* buf,
                const int64_t* row_bytes, const int64_t* idx, int64_t n,
                uint8_t* touched) {
  for (int l = 0; l < n_leaves; ++l) {
    char* dst = static_cast<char*>(pool[l]);
    const char* src = static_cast<const char*>(buf[l]);
    const int64_t rb = row_bytes[l];
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(dst + idx[i] * rb, src + i * rb, rb);
  }
  int64_t newly = 0;
  if (touched != nullptr) {
    for (int64_t i = 0; i < n; ++i) {
      newly += touched[idx[i]] == 0;
      touched[idx[i]] = 1;
    }
  }
  return newly;
}

struct Job {
  int kind;  // 0: gather, 1: scatter
  int n_leaves;
  void* pool[kMaxLeaves];
  void* buf[kMaxLeaves];
  int64_t row_bytes[kMaxLeaves];
  const int64_t* idx;
  int64_t n;
  uint8_t* touched;
  int64_t id;
};

struct Done {
  int64_t start_ns, end_ns, result;
};

struct Worker {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Job> queue;
  std::unordered_map<int64_t, Done> done;
  int64_t next_id = 1;
  bool stop = false;
  std::thread thread;

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stop || !queue.empty(); });
        if (queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      Done d;
      d.start_ns = now_ns();
      d.result = 0;
      if (job.kind == 0)
        gather(job.n_leaves, job.pool, job.buf, job.row_bytes, job.idx,
               job.n);
      else
        d.result = scatter(job.n_leaves, job.pool, job.buf, job.row_bytes,
                           job.idx, job.n, job.touched);
      d.end_ns = now_ns();
      {
        std::lock_guard<std::mutex> lock(mu);
        done[job.id] = d;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int64_t rows_gather(int n_leaves, void* const* pool, void* const* buf,
                    const int64_t* row_bytes, const int64_t* idx,
                    int64_t n) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return -1;
  gather(n_leaves, pool, buf, row_bytes, idx, n);
  return 0;
}

int64_t rows_scatter(int n_leaves, void* const* pool, void* const* buf,
                     const int64_t* row_bytes, const int64_t* idx, int64_t n,
                     uint8_t* touched) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return -1;
  return scatter(n_leaves, pool, buf, row_bytes, idx, n, touched);
}

// dst rows (ids dst_idx, sorted ascending) that also appear among the src
// rows (ids src_idx, sorted ascending) take the src values; hit[i] is set
// for each dst row written. Returns how many were written.
int64_t rows_patch(int n_leaves, void* const* dst, void* const* src,
                   const int64_t* row_bytes, const int64_t* dst_idx,
                   int64_t n, const int64_t* src_idx, int64_t m,
                   uint8_t* hit) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return -1;
  int64_t count = 0, j = 0;
  for (int64_t i = 0; i < n; ++i) {
    while (j < m && src_idx[j] < dst_idx[i]) ++j;
    if (j == m) break;
    if (src_idx[j] != dst_idx[i]) continue;
    for (int l = 0; l < n_leaves; ++l) {
      const int64_t rb = row_bytes[l];
      std::memcpy(static_cast<char*>(dst[l]) + i * rb,
                  static_cast<const char*>(src[l]) + j * rb, rb);
    }
    if (hit != nullptr) hit[i] = 1;
    ++count;
  }
  return count;
}

void* rows_worker_start() {
  Worker* w = new Worker();
  w->thread = std::thread([w] { w->run(); });
  return w;
}

void rows_worker_stop(void* handle) {
  Worker* w = static_cast<Worker*>(handle);
  {
    std::lock_guard<std::mutex> lock(w->mu);
    w->stop = true;
  }
  w->cv.notify_all();
  w->thread.join();
  delete w;
}

// Queue a gather (kind 0) or a scatter (kind 1); returns the job's id, or
// -1 for too many leaves. The pointers must stay valid until the job is
// waited for.
int64_t rows_worker_enqueue(void* handle, int kind, int n_leaves,
                            void* const* pool, void* const* buf,
                            const int64_t* row_bytes, const int64_t* idx,
                            int64_t n, uint8_t* touched) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return -1;
  Worker* w = static_cast<Worker*>(handle);
  Job job;
  job.kind = kind;
  job.n_leaves = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    job.pool[l] = pool[l];
    job.buf[l] = buf[l];
    job.row_bytes[l] = row_bytes[l];
  }
  job.idx = idx;
  job.n = n;
  job.touched = touched;
  {
    std::lock_guard<std::mutex> lock(w->mu);
    job.id = w->next_id++;
    w->queue.push_back(job);
  }
  w->cv.notify_all();
  return job.id;
}

// Block until job ``id`` has run; out[0..2] = start ns, end ns, result
// (a scatter's newly touched rows). Each job is waited for once.
void rows_worker_wait(void* handle, int64_t id, int64_t* out) {
  Worker* w = static_cast<Worker*>(handle);
  std::unique_lock<std::mutex> lock(w->mu);
  w->cv.wait(lock, [w, id] { return w->done.count(id) > 0; });
  const Done d = w->done[id];
  w->done.erase(id);
  out[0] = d.start_ns;
  out[1] = d.end_ns;
  out[2] = d.result;
}

}  // extern "C"
