// The rendezvous store's server and client: the host runtime of
// paddle_tpu_torch/distributed/store.py, a verbatim copy of the JAX
// package's native/tcp_store.cc (below this header).
//
// TCPStore: TCP key-value rendezvous store.
//
// Reference: paddle/phi/core/distributed/store/tcp_store.h:121 +
// tcp_utils.cc — rank 0 hosts a socket server with a string->bytes map;
// clients SET/GET/ADD/WAIT keys to bootstrap process groups.
//
// TPU-native runtime keeps the same role (multi-host bootstrap before
// jax.distributed is up, barrier/elastic bookkeeping). Thread-per-connection
// server, blocking WAIT via condition variable, length-prefixed frames:
//   request:  [u8 op][u32 klen][key][u64 vlen][val]
//   response: [u64 vlen][val]   (ADD returns 8-byte little-endian i64)
// ops: 1=SET 2=GET(blocking until key exists, bounded by client timeout)
//      3=ADD 4=WAIT 5=DELETE

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Server {
  int listen_fd = -1;
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;  // guarded by mu; for shutdown-on-stop
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> kv;
  bool stopping = false;
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_blob(int fd, const std::string& v) {
  uint64_t n = v.size();
  if (!write_full(fd, &n, 8)) return false;
  return v.empty() ? true : write_full(fd, v.data(), v.size());
}

void handle_conn(Server* s, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint8_t op;
    uint32_t klen;
    uint64_t vlen;
    if (!read_full(fd, &op, 1) || !read_full(fd, &klen, 4)) break;
    std::string key(klen, '\0');
    if (klen && !read_full(fd, &key[0], klen)) break;
    if (!read_full(fd, &vlen, 8)) break;
    std::string val(vlen, '\0');
    if (vlen && !read_full(fd, &val[0], vlen)) break;

    if (op == 1) {  // SET
      {
        std::lock_guard<std::mutex> g(s->mu);
        s->kv[key] = val;
      }
      s->cv.notify_all();
      if (!send_blob(fd, "")) break;
    } else if (op == 2 || op == 4) {  // GET (blocking) / WAIT
      std::unique_lock<std::mutex> g(s->mu);
      s->cv.wait(g, [&] { return s->stopping || s->kv.count(key); });
      if (s->stopping) break;
      std::string out = (op == 2) ? s->kv[key] : "";
      g.unlock();
      if (!send_blob(fd, op == 2 ? out : std::string("\x01", 1))) break;
    } else if (op == 3) {  // ADD
      int64_t delta = 0;
      memcpy(&delta, val.data(), std::min<size_t>(8, val.size()));
      int64_t now;
      {
        std::lock_guard<std::mutex> g(s->mu);
        int64_t cur = 0;
        auto it = s->kv.find(key);
        if (it != s->kv.end())
          memcpy(&cur, it->second.data(), std::min<size_t>(8, it->second.size()));
        now = cur + delta;
        s->kv[key] = std::string(reinterpret_cast<char*>(&now), 8);
      }
      s->cv.notify_all();
      if (!send_blob(fd, std::string(reinterpret_cast<char*>(&now), 8))) break;
    } else if (op == 5) {  // DELETE
      {
        std::lock_guard<std::mutex> g(s->mu);
        s->kv.erase(key);
      }
      if (!send_blob(fd, "")) break;
    } else if (op == 6) {  // TRYGET (non-blocking; missing -> 0x00 marker)
      std::string out;
      bool found;
      {
        std::lock_guard<std::mutex> g(s->mu);
        auto it = s->kv.find(key);
        found = it != s->kv.end();
        if (found) out = it->second;
      }
      // prefix byte distinguishes "missing" from "present but empty"
      if (!send_blob(fd, (found ? std::string("\x01", 1) : std::string("\x00", 1)) + out)) break;
    } else {
      // Unknown op (newer client against this server): reply with an error
      // marker instead of dropping the connection, so one unsupported call
      // does not poison the client's cached fd for every later op. The
      // reverse skew (new client, OLD server binary) still drops — rebuild
      // all hosts from the same tree.
      if (!send_blob(fd, std::string("\xff", 1) + "ERR:unknown-op")) break;
    }
  }
  {
    // Remove our fd from conn_fds before closing: stop() shutdowns every fd
    // still listed, and a closed-and-recycled fd number must not be there.
    std::lock_guard<std::mutex> g(s->mu);
    auto it = std::find(s->conn_fds.begin(), s->conn_fds.end(), fd);
    if (it != s->conn_fds.end()) s->conn_fds.erase(it);
  }
  ::close(fd);
}

}  // namespace

extern "C" {

void* tcp_store_server_start(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Server();
  s->listen_fd = fd;
  s->accept_thread = std::thread([s] {
    for (;;) {
      int cfd = ::accept(s->listen_fd, nullptr, nullptr);
      if (cfd < 0) break;  // listen fd closed -> shutdown
      std::lock_guard<std::mutex> g(s->mu);
      if (s->stopping) {
        ::close(cfd);
        break;
      }
      s->conn_fds.push_back(cfd);
      s->conns.emplace_back(handle_conn, s, cfd);
    }
  });
  return s;
}

int tcp_store_server_port(void* sp) {
  auto* s = static_cast<Server*>(sp);
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len) != 0)
    return -1;
  return ntohs(addr.sin_port);
}

void tcp_store_server_stop(void* sp) {
  // Handler threads may be blocked in cv.wait (stopping flag + notify wakes
  // them) or in read() (shutdown on their fd wakes them with EOF). Join —
  // never detach — every thread before freeing the Server, otherwise a
  // mid-process stop races threads still touching s->mu/s->kv.
  auto* s = static_cast<Server*>(sp);
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->stopping = true;
    for (int cfd : s->conn_fds) ::shutdown(cfd, SHUT_RDWR);
  }
  s->cv.notify_all();
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // accept_thread has exited, so no more threads are appended to conns.
  for (auto& t : s->conns)
    if (t.joinable()) t.join();
  delete s;
}

// timeout_ms bounds connect(); io_timeout_ms bounds each blocking
// GET/WAIT/response read (rendezvous waits legitimately run minutes, so this
// is a separate, much longer bound). A timed-out request leaves the
// length-prefixed stream desynchronized — callers must treat failure as
// fatal for the connection, not retry on the same fd.
intptr_t tcp_store_connect(const char* host, int port, int timeout_ms,
                           int io_timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 3000);
  while (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    if (std::chrono::steady_clock::now() > deadline) {
      ::close(fd);
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // Bound GET/WAIT on the connected socket too (the protocol contract
  // above): a key that is never set must raise on the client instead of
  // hanging the rank forever.
  if (io_timeout_ms > 0) {
    timeval tv{};
    tv.tv_sec = io_timeout_ms / 1000;
    tv.tv_usec = (io_timeout_ms % 1000) * 1000;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  }
  return fd;
}

static int request(int fd, uint8_t op, const char* key, const void* val,
                   uint64_t vlen, std::string* out) {
  uint32_t klen = static_cast<uint32_t>(strlen(key));
  if (!write_full(fd, &op, 1) || !write_full(fd, &klen, 4) ||
      !write_full(fd, key, klen) || !write_full(fd, &vlen, 8))
    return -1;
  if (vlen && !write_full(fd, val, vlen)) return -1;
  uint64_t rlen;
  if (!read_full(fd, &rlen, 8)) return -1;
  out->resize(rlen);
  if (rlen && !read_full(fd, &(*out)[0], rlen)) return -1;
  return 0;
}

int tcp_store_set(intptr_t fd, const char* key, const void* val, long vlen) {
  std::string out;
  return request(static_cast<int>(fd), 1, key, val,
                 static_cast<uint64_t>(vlen), &out);
}

long tcp_store_get(intptr_t fd, const char* key, void* buf, long cap) {
  std::string out;
  if (request(static_cast<int>(fd), 2, key, nullptr, 0, &out) != 0) return -1;
  long n = static_cast<long>(out.size());
  memcpy(buf, out.data(), std::min<long>(n, cap));
  return n;
}

// errno-style: returns 0 and writes the new counter into *out, or -1 on
// failure (a plain long long return could not distinguish a legitimate
// counter value of -1 from an error).
int tcp_store_add(intptr_t fd, const char* key, long long delta,
                  long long* out) {
  std::string resp;
  if (request(static_cast<int>(fd), 3, key, &delta, 8, &resp) != 0 ||
      resp.size() < 8)
    return -1;
  memcpy(out, resp.data(), 8);
  return 0;
}

int tcp_store_wait(intptr_t fd, const char* key) {
  std::string out;
  return request(static_cast<int>(fd), 4, key, nullptr, 0, &out);
}

// Non-blocking probe: returns the value length (copied into buf up to cap)
// when present, -2 when the key is missing, -1 on transport failure.
long tcp_store_tryget(intptr_t fd, const char* key, void* buf, long cap) {
  std::string out;
  if (request(static_cast<int>(fd), 6, key, nullptr, 0, &out) != 0) return -1;
  if (out.empty() || out[0] == '\0') return -2;
  // '\xff' is the server's unknown-op error reply (version skew) — a
  // protocol error, not a stored value.
  if (out[0] == '\xff') return -1;
  long n = static_cast<long>(out.size()) - 1;
  memcpy(buf, out.data() + 1, std::min<long>(n, cap));
  return n;
}

int tcp_store_delete(intptr_t fd, const char* key) {
  std::string out;
  return request(static_cast<int>(fd), 5, key, nullptr, 0, &out);
}

void tcp_store_close(intptr_t fd) { ::close(static_cast<int>(fd)); }

}  // extern "C"
