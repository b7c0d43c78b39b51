// Collective hang watchdog: the host runtime of
// paddle_tpu_torch/distributed/comm_watchdog.py, a copy of the JAX
// package's native/watchdog.cc.
//
// Reference: CommTaskManager (paddle/phi/core/distributed/comm_task_manager.h:37)
// + CommTask::IsTimeout (comm_task.h:127) — a background thread that tracks
// every in-flight collective and logs rings stuck past the timeout (the
// practical distributed deadlock detector).
//
// The unit tracked is a blocking host region (a collective, a step's input
// copy), registered around it by `comm_task`. The monitor thread marks
// tasks that exceed their deadline; python polls the reports.
//
// Plain C++17 with a C interface, built by framework/native.py with the
// host compiler (no CUDA, no PyTorch header).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>

namespace {

using Clock = std::chrono::steady_clock;

struct Task {
  std::string desc;
  Clock::time_point start;
  long timeout_ms;
  bool reported = false;
};

struct Watchdog {
  std::mutex mu;
  std::condition_variable cv;
  std::map<long long, Task> tasks;
  std::string report;  // accumulated timeout lines
  long long next_id = 1;
  long default_timeout_ms;
  long long n_timeouts = 0;
  bool stopping = false;
  std::thread monitor;
};

void monitor_loop(Watchdog* w) {
  std::unique_lock<std::mutex> g(w->mu);
  while (!w->stopping) {
    w->cv.wait_for(g, std::chrono::milliseconds(50));
    auto now = Clock::now();
    for (auto& [id, t] : w->tasks) {
      if (t.reported) continue;
      auto ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                    now - t.start)
                    .count();
      if (ms > t.timeout_ms) {
        t.reported = true;
        w->n_timeouts++;
        w->report += "[watchdog] task " + std::to_string(id) + " '" + t.desc +
                     "' exceeded " + std::to_string(t.timeout_ms) + "ms (" +
                     std::to_string(ms) + "ms elapsed)\n";
      }
    }
  }
}

}  // namespace

extern "C" {

void* watchdog_create(long default_timeout_ms) {
  auto* w = new Watchdog();
  w->default_timeout_ms = default_timeout_ms;
  w->monitor = std::thread(monitor_loop, w);
  return w;
}

void watchdog_destroy(void* wp) {
  auto* w = static_cast<Watchdog*>(wp);
  {
    std::lock_guard<std::mutex> g(w->mu);
    w->stopping = true;
  }
  w->cv.notify_all();
  if (w->monitor.joinable()) w->monitor.join();
  delete w;
}

long long watchdog_register(void* wp, const char* desc, long timeout_ms) {
  auto* w = static_cast<Watchdog*>(wp);
  std::lock_guard<std::mutex> g(w->mu);
  long long id = w->next_id++;
  w->tasks[id] = Task{desc ? desc : "", Clock::now(),
                      timeout_ms > 0 ? timeout_ms : w->default_timeout_ms};
  return id;
}

void watchdog_complete(void* wp, long long id) {
  auto* w = static_cast<Watchdog*>(wp);
  std::lock_guard<std::mutex> g(w->mu);
  w->tasks.erase(id);
}

long long watchdog_timeout_count(void* wp) {
  auto* w = static_cast<Watchdog*>(wp);
  std::lock_guard<std::mutex> g(w->mu);
  return w->n_timeouts;
}

// drain accumulated report text; returns bytes written (report cleared)
long watchdog_drain_report(void* wp, char* buf, long cap) {
  auto* w = static_cast<Watchdog*>(wp);
  std::lock_guard<std::mutex> g(w->mu);
  long n = static_cast<long>(w->report.size());
  if (n > cap) n = cap;
  memcpy(buf, w->report.data(), n);
  w->report.erase(0, n);
  return n;
}

long long watchdog_inflight(void* wp) {
  auto* w = static_cast<Watchdog*>(wp);
  std::lock_guard<std::mutex> g(w->mu);
  return static_cast<long long>(w->tasks.size());
}

}  // extern "C"
