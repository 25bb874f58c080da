// Concurrency hammer for the port's shm arena store (store.cpp), copied from
// tpu_air/_native/store_hammer.cc: the port's store keeps that layout, so the
// same hammer applies (SURVEY.md §5 race detection: "run the C++ runtime's
// own tests under ASAN/TSAN").  tpu_air_torch._native.build_store_hammer
// builds it under each sanitizer into tpu_air_torch/_build/.
//
// Two modes:
//   store_hammer threads <arena> <writers> <readers> <objs_per_writer>
//     — one process, writer+reader threads on one mapping. TSan instruments
//       every access, so this mode is the data-race detector target.
//   store_hammer procs <arena> <writers> <readers> <objs_per_writer>
//     — fork()ed writer/reader processes each arena_open()ing the file;
//       exercises the true cross-process protocol (ASan target; TSan cannot
//       see across processes).
//
// Writers: alloc → fill payload with a seed pattern → seal. Readers: poll
// lookups for every expected id; once sealed, verify the payload matches the
// pattern (catches seal/publish ordering bugs — a reader must never observe
// a sealed object with a partially-written body). Exit 0 iff every object is
// found and verifies.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/wait.h>
#include <unistd.h>

extern "C" {
int arena_create(const char* path, uint64_t capacity, uint32_t num_slots);
int arena_open(const char* path);
int arena_close(int h);
int64_t arena_alloc(int h, const uint8_t* id, uint64_t size);
int arena_seal(int h, const uint8_t* id);
int arena_lookup(int h, const uint8_t* id, uint64_t* offset, uint64_t* size);
int arena_lookup_pin(int h, const uint8_t* id, uint64_t* offset, uint64_t* size);
int arena_unpin(int h, const uint8_t* id, uint64_t offset);
int arena_delete(int h, const uint8_t* id);
uint64_t arena_live_objects(int h);
uint64_t arena_free_bytes(int h);
}

namespace {

constexpr uint32_t kIdBytes = 32;
constexpr uint64_t kObjSize = 4096;

void make_id(uint8_t* id, int writer, int obj) {
  std::memset(id, 0, kIdBytes);
  std::snprintf(reinterpret_cast<char*>(id), kIdBytes, "w%08d_o%08d", writer, obj);
}

uint8_t pattern_byte(int writer, int obj, uint64_t i) {
  return static_cast<uint8_t>((writer * 131 + obj * 31 + i) & 0xff);
}

// Map the raw file so payload reads/writes go through shared memory exactly
// the way the Python side does it (the .so only owns layout + atomics).
uint8_t* map_file(const char* path, uint64_t* len) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;
  *len = (uint64_t)st.st_size;
  return reinterpret_cast<uint8_t*>(mem);
}

int writer_loop(int h, uint8_t* base, int writer, int nobjs) {
  uint8_t id[kIdBytes];
  for (int o = 0; o < nobjs; ++o) {
    make_id(id, writer, o);
    int64_t off = arena_alloc(h, id, kObjSize);
    if (off < 0) {
      std::fprintf(stderr, "writer %d: alloc(%d) failed: %lld\n", writer, o,
                   (long long)off);
      return 1;
    }
    for (uint64_t i = 0; i < kObjSize; ++i)
      base[(uint64_t)off + i] = pattern_byte(writer, o, i);
    if (arena_seal(h, id) != 0) {
      std::fprintf(stderr, "writer %d: seal(%d) failed\n", writer, o);
      return 1;
    }
    // duplicate re-put must be rejected (and must not leak arena space)
    if (arena_alloc(h, id, kObjSize) != -3) {
      std::fprintf(stderr, "writer %d: duplicate alloc not rejected\n", writer);
      return 1;
    }
  }
  return 0;
}

int reader_loop(int h, const uint8_t* base, int nwriters, int nobjs) {
  uint8_t id[kIdBytes];
  int verified = 0;
  // Poll until every object is observed sealed and byte-exact.
  for (int spin = 0; verified < nwriters * nobjs && spin < 200000; ++spin) {
    verified = 0;
    for (int w = 0; w < nwriters; ++w) {
      for (int o = 0; o < nobjs; ++o) {
        make_id(id, w, o);
        uint64_t off = 0, size = 0;
        int rc = arena_lookup(h, id, &off, &size);
        if (rc != 1) continue;
        if (size != kObjSize) {
          std::fprintf(stderr, "reader: bad size %llu\n", (unsigned long long)size);
          return 1;
        }
        for (uint64_t i = 0; i < kObjSize; i += 97) {
          if (base[off + i] != pattern_byte(w, o, i)) {
            std::fprintf(stderr,
                         "reader: torn read w=%d o=%d i=%llu (sealed object "
                         "with unwritten body)\n",
                         w, o, (unsigned long long)i);
            return 1;
          }
        }
        ++verified;
      }
    }
  }
  if (verified != nwriters * nobjs) {
    std::fprintf(stderr, "reader: only %d/%d objects verified\n", verified,
                 nwriters * nobjs);
    return 1;
  }
  return 0;
}

// Ownership churn: two threads share an id space and race
// alloc/seal/pin/delete/unpin.  The invariant under test (TSan target): a
// PINNED object's bytes never change — even after arena_delete parks it in
// ZOMBIE and other threads' allocations are hungry for reusable blocks.
int churn_loop(int h, uint8_t* base, int pair, int iters, int nobjs) {
  uint8_t id[kIdBytes];
  for (int it = 0; it < iters; ++it) {
    int o = it % nobjs;
    std::memset(id, 0, kIdBytes);
    std::snprintf(reinterpret_cast<char*>(id), kIdBytes, "c%08d_o%08d", pair, o);
    int64_t aoff = arena_alloc(h, id, kObjSize);
    if (aoff >= 0) {
      for (uint64_t i = 0; i < kObjSize; ++i)
        base[(uint64_t)aoff + i] = pattern_byte(1000 + pair, o, i);
      arena_seal(h, id);  // may lose to a concurrent delete; fine
    } else if (aoff != -3) {
      std::fprintf(stderr, "churn %d: alloc failed %lld (reuse broken?)\n",
                   pair, (long long)aoff);
      return 1;
    }
    uint64_t off = 0, size = 0;
    if (arena_lookup_pin(h, id, &off, &size) == 1) {
      for (int round = 0; round < 2; ++round) {
        for (uint64_t i = 0; i < kObjSize; i += 61) {
          if (base[off + i] != pattern_byte(1000 + pair, o, i)) {
            std::fprintf(stderr,
                         "churn %d: pinned bytes changed (o=%d round=%d) — "
                         "reclamation ignored the pin\n",
                         pair, o, round);
            return 1;
          }
        }
        // first round verifies sealed; delete, then verify the ZOMBIE
        if (round == 0) arena_delete(h, id);
      }
      arena_unpin(h, id, off);
    }
  }
  return 0;
}

int run_threads(const char* path, int nwriters, int nreaders, int nobjs) {
  int h = arena_open(path);
  if (h < 0) return 2;
  uint64_t len = 0;
  uint8_t* base = map_file(path, &len);
  if (!base) return 2;

  std::atomic<int> failures{0};
  std::vector<std::thread> ts;
  for (int w = 0; w < nwriters; ++w)
    ts.emplace_back([&, w] { failures += writer_loop(h, base, w, nobjs); });
  for (int r = 0; r < nreaders; ++r)
    ts.emplace_back([&] { failures += reader_loop(h, base, nwriters, nobjs); });
  // ownership churn pairs: 2 threads per shared id space racing
  // alloc/pin/delete/unpin against the reclamation machinery
  for (int p = 0; p < nwriters; ++p)
    for (int t = 0; t < 2; ++t)
      ts.emplace_back(
          [&, p] { failures += churn_loop(h, base, p, 4 * nobjs, nobjs); });
  for (auto& t : ts) t.join();

  uint64_t live = arena_live_objects(h);
  if ((int)live != nwriters * nobjs) {
    std::fprintf(stderr, "live_objects=%llu expected %d\n",
                 (unsigned long long)live, nwriters * nobjs);
    failures += 1;
  }
  ::munmap(base, len);
  arena_close(h);
  return failures.load() ? 1 : 0;
}

// Duplicate-id race over tombstone churn: every round K threads race
// arena_alloc on the SAME id whose previous generation was just deleted
// (its tombstone sits in the probe chain, so one racer can recycle it while
// another claims the end-of-chain EMPTY slot).  Invariant: one
// arena_delete makes the id unfindable — a lookup hit after the delete
// means TWO sealed slots were installed for one id.
int run_dup(const char* path, int nthreads, int iters) {
  int h = arena_open(path);
  if (h < 0) return 2;
  uint64_t len = 0;
  uint8_t* base = map_file(path, &len);
  if (!base) return 2;

  uint8_t id[kIdBytes];
  std::memset(id, 0, kIdBytes);
  std::snprintf(reinterpret_cast<char*>(id), kIdBytes, "dup_target");
  int failures = 0, missed_rounds = 0;
  for (int it = 0; it < iters && !failures; ++it) {
    std::atomic<int> go{0}, sealed{0};
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t] {
        while (!go.load(std::memory_order_acquire)) ::sched_yield();
        int64_t off = arena_alloc(h, id, kObjSize);
        if (off >= 0) {
          for (uint64_t i = 0; i < kObjSize; i += 257)
            base[(uint64_t)off + i] = pattern_byte(t, it, i);
          if (arena_seal(h, id) == 0) sealed.fetch_add(1);
        }
      });
    }
    go.store(1, std::memory_order_release);
    for (auto& t : ts) t.join();
    if (sealed.load() > 1) {
      std::fprintf(stderr, "dup: %d sealed generations in round %d\n",
                   sealed.load(), it);
      ++failures;
    }
    if (sealed.load() == 0) ++missed_rounds;  // all yielded — allowed (file
                                              // fallback), count only
    arena_delete(h, id);
    uint64_t off = 0, size = 0;
    if (arena_lookup(h, id, &off, &size) == 1) {
      std::fprintf(stderr,
                   "dup: id still findable after delete in round %d — "
                   "a duplicate slot survived\n", it);
      ++failures;
    }
  }
  if (missed_rounds)
    std::printf("dup: %d/%d rounds all-yield (fallback path)\n", missed_rounds,
                iters);
  ::munmap(base, len);
  arena_close(h);
  return failures ? 1 : 0;
}

int run_procs(const char* path, int nwriters, int nreaders, int nobjs) {
  std::vector<pid_t> pids;
  for (int w = 0; w < nwriters; ++w) {
    pid_t p = ::fork();
    if (p == 0) {
      int h = arena_open(path);
      uint64_t len = 0;
      uint8_t* base = map_file(path, &len);
      if (h < 0 || !base) _exit(2);
      _exit(writer_loop(h, base, w, nobjs));
    }
    pids.push_back(p);
  }
  for (int r = 0; r < nreaders; ++r) {
    pid_t p = ::fork();
    if (p == 0) {
      int h = arena_open(path);
      uint64_t len = 0;
      uint8_t* base = map_file(path, &len);
      if (h < 0 || !base) _exit(2);
      _exit(reader_loop(h, base, nwriters, nobjs));
    }
    pids.push_back(p);
  }
  int failures = 0;
  for (pid_t p : pids) {
    int st = 0;
    ::waitpid(p, &st, 0);
    if (!WIFEXITED(st) || WEXITSTATUS(st) != 0) ++failures;
  }
  return failures ? 1 : 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 6) {
    std::fprintf(stderr,
                 "usage: %s threads|procs|dup <arena_path> <writers> <readers> "
                 "<objs_per_writer>\n"
                 "  dup mode: <writers> = racing threads, <readers> ignored, "
                 "<objs_per_writer> = rounds\n",
                 argv[0]);
    return 2;
  }
  const std::string mode = argv[1];
  const char* path = argv[2];
  int nwriters = std::atoi(argv[3]);
  int nreaders = std::atoi(argv[4]);
  int nobjs = std::atoi(argv[5]);

  ::unlink(path);
  uint64_t cap = (uint64_t)nwriters * nobjs * kObjSize * 2 + (1 << 20);
  if (arena_create(path, cap, 1 << 16) != 0) {
    std::fprintf(stderr, "arena_create failed\n");
    return 2;
  }
  int rc = mode == "threads" ? run_threads(path, nwriters, nreaders, nobjs)
           : mode == "dup"   ? run_dup(path, nwriters, nobjs)
                             : run_procs(path, nwriters, nreaders, nobjs);
  ::unlink(path);
  if (rc == 0) std::printf("hammer %s: OK\n", mode.c_str());
  return rc;
}
