// Host heartbeat / failure detector (the port's own copy of the JAX
// package's native/heartbeat.cc, built by runtime/native.py).
//
// A tiny TCP heartbeat mesh beside the collectives: rank 0 runs the
// coordinator; every rank (0 included) runs a beater thread that
// reconnects-and-pings every interval. The trainer polls `hb_dead_mask`
// between steps and stops instead of hanging in a collective until the
// process group's timeout.
//
// Deliberately not on the NCCL/gloo path: failure detection must stay usable
// exactly when the collectives are wedged, hence plain POSIX sockets.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Ping {
  uint32_t magic;
  uint32_t rank;
};
constexpr uint32_t kMagic = 0x48425431;  // "HBT1"

}  // namespace

struct HBCoordinator {
  int listen_fd = -1;
  int n_ranks = 0;
  std::vector<std::atomic<int64_t>> last_seen;
  std::vector<std::atomic<bool>> seen_once;
  std::atomic<bool> stop{false};
  std::thread acceptor;
  std::vector<std::thread> readers;
  std::mutex readers_mu;

  explicit HBCoordinator(int n) : n_ranks(n), last_seen(n), seen_once(n) {
    // Grace period: treat every rank as "just heard from" at startup so a
    // not-yet-connected peer isn't declared dead until timeout_ms elapses.
    int64_t t0 = now_ms();
    for (auto& t : last_seen) t.store(t0);
    for (auto& s : seen_once) s.store(false);
  }

  void serve_conn(int fd) {
    Ping p;
    while (!stop.load()) {
      ssize_t r = recv(fd, &p, sizeof(p), MSG_WAITALL);
      if (r != sizeof(p) || p.magic != kMagic) break;
      if (p.rank < static_cast<uint32_t>(n_ranks)) {
        last_seen[p.rank].store(now_ms());
        seen_once[p.rank].store(true);
      }
    }
    close(fd);
  }

  void accept_loop() {
    while (!stop.load()) {
      int fd = accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stop.load()) return;
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(readers_mu);
      readers.emplace_back([this, fd] { serve_conn(fd); });
    }
  }
};

struct HBWorker {
  std::string host;
  int port, rank, interval_ms;
  std::atomic<bool> stop{false};
  std::thread beater;

  void run() {
    int fd = -1;
    while (!stop.load()) {
      if (fd < 0) {
        fd = socket(AF_INET, SOCK_STREAM, 0);
        if (fd >= 0) {
          struct addrinfo hints{}, *res = nullptr;
          hints.ai_family = AF_INET;
          hints.ai_socktype = SOCK_STREAM;
          std::string port_s = std::to_string(port);
          if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) == 0 && res) {
            if (connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
              close(fd);
              fd = -1;
            }
            freeaddrinfo(res);
          } else {
            close(fd);
            fd = -1;
          }
        }
      }
      if (fd >= 0) {
        Ping p{kMagic, static_cast<uint32_t>(rank)};
        if (send(fd, &p, sizeof(p), MSG_NOSIGNAL) != sizeof(p)) {
          close(fd);
          fd = -1;  // coordinator gone; retry next tick
        }
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(interval_ms));
    }
    if (fd >= 0) close(fd);
  }
};

extern "C" {

// Returns handle, or nullptr if the port can't be bound. port==0 picks an
// ephemeral port (query with hb_coordinator_port).
HBCoordinator* hb_start_coordinator(int port, int n_ranks) {
  if (n_ranks <= 0 || n_ranks > 4096) return nullptr;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 128) != 0) {
    close(fd);
    return nullptr;
  }
  auto* c = new HBCoordinator(n_ranks);
  c->listen_fd = fd;
  c->acceptor = std::thread([c] { c->accept_loop(); });
  return c;
}

int hb_coordinator_port(HBCoordinator* c) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(c->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len) != 0)
    return -1;
  return ntohs(addr.sin_port);
}

// Bit i set => rank i has NOT pinged within timeout_ms (ranks >= 64 fold into
// bit 63; use hb_rank_age_ms for exact per-rank staleness).
uint64_t hb_dead_mask(HBCoordinator* c, int timeout_ms) {
  uint64_t mask = 0;
  int64_t cutoff = now_ms() - timeout_ms;
  for (int r = 0; r < c->n_ranks; ++r) {
    if (c->last_seen[r].load() < cutoff) mask |= 1ULL << (r < 63 ? r : 63);
  }
  return mask;
}

// ms since rank last pinged; -1 = never seen.
int64_t hb_rank_age_ms(HBCoordinator* c, int rank) {
  if (rank < 0 || rank >= c->n_ranks) return -1;
  if (!c->seen_once[rank].load()) return -1;
  return now_ms() - c->last_seen[rank].load();
}

void hb_stop_coordinator(HBCoordinator* c) {
  if (!c) return;
  c->stop.store(true);
  shutdown(c->listen_fd, SHUT_RDWR);
  close(c->listen_fd);
  if (c->acceptor.joinable()) c->acceptor.join();
  {
    std::lock_guard<std::mutex> lk(c->readers_mu);
    for (auto& t : c->readers)
      if (t.joinable()) t.join();
  }
  delete c;
}

HBWorker* hb_start_worker(const char* host, int port, int rank, int interval_ms) {
  auto* w = new HBWorker();
  w->host = host;
  w->port = port;
  w->rank = rank;
  w->interval_ms = interval_ms > 0 ? interval_ms : 1000;
  w->beater = std::thread([w] { w->run(); });
  return w;
}

void hb_stop_worker(HBWorker* w) {
  if (!w) return;
  w->stop.store(true);
  if (w->beater.joinable()) w->beater.join();
  delete w;
}

}  // extern "C"
