// The port's GCS daemon, copied from tpu_air/_native/gcs_server.cpp: the
// C++ control-plane service (cluster metadata, actor directory, node
// membership, heartbeat failure detection).  Its schema is gcs.proto
// beside it, wire-compatible with the JAX package's, so either package's
// client talks to either daemon.
//
// Design: one acceptor + one thread per connection (control traffic is
// low-rate: registrations, heartbeats, directory lookups — the data plane
// never comes here).  All state lives in-memory behind a single mutex;
// liveness = heartbeat within --dead-after-ms.  Transport is length-prefixed
// protobuf (gcs.proto), the smallest substitute for gRPC; the schema ports
// to gRPC unchanged.
//
// Usage: tpu_air_torch_gcs-<hash> <port> [dead_after_ms]
//   prints "LISTENING <port>" on stdout once accepting (port 0 = ephemeral).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "gcs.pb.h"

namespace {

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct State {
  std::mutex mu;
  int64_t dead_after_ms = 10000;
  std::map<std::string, tpu_air_torch::gcs::NodeInfo> nodes;
  std::map<std::string, tpu_air_torch::gcs::ActorInfo> actors;   // by actor_id
  std::map<std::string, std::string> actor_names;          // name -> actor_id
  std::map<std::string, tpu_air_torch::gcs::ObjectLocation> objects;
  std::map<std::string, std::string> kv;
};

void handle(State& st, const tpu_air_torch::gcs::Request& req,
            tpu_air_torch::gcs::Reply* rep) {
  using namespace tpu_air_torch::gcs;
  std::lock_guard<std::mutex> lock(st.mu);
  rep->set_seq(req.seq());
  rep->set_ok(true);
  switch (req.op_case()) {
    case Request::kRegisterNode: {
      NodeInfo n = req.register_node();
      n.set_last_heartbeat_ms(now_ms());
      n.set_alive(true);
      st.nodes[n.node_id()] = n;
      break;
    }
    case Request::kHeartbeat: {
      auto it = st.nodes.find(req.heartbeat());
      if (it == st.nodes.end()) {
        rep->set_ok(false);
        rep->set_error("unknown node");
      } else {
        it->second.set_last_heartbeat_ms(now_ms());
      }
      break;
    }
    case Request::kListNodes: {
      int64_t cutoff = now_ms() - st.dead_after_ms;
      for (auto& [id, n] : st.nodes) {
        n.set_alive(n.last_heartbeat_ms() >= cutoff);
        *rep->add_nodes() = n;
      }
      break;
    }
    case Request::kRegisterActor: {
      const ActorInfo& a = req.register_actor();
      st.actors[a.actor_id()] = a;
      if (!a.name().empty()) st.actor_names[a.name()] = a.actor_id();
      break;
    }
    case Request::kLookupActor: {
      std::string id = req.lookup_actor();
      auto byname = st.actor_names.find(id);
      if (byname != st.actor_names.end()) id = byname->second;
      auto it = st.actors.find(id);
      if (it == st.actors.end()) {
        rep->set_found(false);
      } else {
        rep->set_found(true);
        *rep->mutable_actor() = it->second;
      }
      break;
    }
    case Request::kMarkActorDead: {
      auto it = st.actors.find(req.mark_actor_dead());
      if (it != st.actors.end()) {
        it->second.set_dead(true);
        // release the name only if it still maps to THIS actor — a live
        // replacement that re-registered the name must stay reachable
        if (!it->second.name().empty()) {
          auto nm = st.actor_names.find(it->second.name());
          if (nm != st.actor_names.end() && nm->second == it->first)
            st.actor_names.erase(nm);
        }
      }
      break;
    }
    case Request::kPublishObject: {
      const ObjectLocation& loc = req.publish_object();
      ObjectLocation& cur = st.objects[loc.object_id()];
      cur.set_object_id(loc.object_id());
      cur.set_size_bytes(loc.size_bytes());
      for (const auto& nid : loc.node_ids()) {
        bool have = false;
        for (const auto& e : cur.node_ids()) have |= (e == nid);
        if (!have) cur.add_node_ids(nid);
      }
      break;
    }
    case Request::kLocateObject: {
      auto it = st.objects.find(req.locate_object());
      rep->set_found(it != st.objects.end());
      if (it != st.objects.end()) *rep->mutable_location() = it->second;
      break;
    }
    case Request::kKvPut:
      st.kv[req.kv_put().key()] = req.kv_put().value();
      break;
    case Request::kKvGet: {
      auto it = st.kv.find(req.kv_get());
      rep->set_found(it != st.kv.end());
      if (it != st.kv.end()) rep->set_value(it->second);
      break;
    }
    case Request::kKvDel:
      st.kv.erase(req.kv_del());
      break;
    default:
      rep->set_ok(false);
      rep->set_error("empty or unknown op");
  }
}

bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

void serve_conn(State* st, int fd) {
  constexpr uint32_t kMaxMsg = 64 * 1024 * 1024;
  for (;;) {
    uint32_t len_be = 0;
    if (!read_exact(fd, &len_be, 4)) break;
    uint32_t len = ntohl(len_be);
    if (len == 0 || len > kMaxMsg) break;
    std::string buf(len, '\0');
    if (!read_exact(fd, buf.data(), len)) break;
    tpu_air_torch::gcs::Request req;
    tpu_air_torch::gcs::Reply rep;
    if (!req.ParseFromString(buf)) {
      rep.set_ok(false);
      rep.set_error("parse error");
    } else {
      handle(*st, req, &rep);
    }
    std::string out;
    rep.SerializeToString(&out);
    uint32_t out_be = htonl((uint32_t)out.size());
    if (!write_exact(fd, &out_be, 4) || !write_exact(fd, out.data(), out.size()))
      break;
  }
  ::close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  ::signal(SIGPIPE, SIG_IGN);
  int port = argc > 1 ? std::atoi(argv[1]) : 0;
  State st;
  if (argc > 2) st.dead_after_ms = std::atoll(argv[2]);

  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(srv, 64) != 0) {
    std::perror("bind/listen");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  for (;;) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) {
      // back off on persistent errors (EMFILE etc.) — a bare continue
      // would spin a core while the daemon "looks" alive
      ::usleep(10000);
      continue;
    }
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(serve_conn, &st, fd).detach();
  }
}
