// The port's native shared-memory object store, copied from
// tpu_air/_native/store.cpp with its layout unchanged, so the two packages'
// arenas read each other's files (the magic below is the layout's, not a
// package name).  Object ownership and reference counts live here, in
// native code, as in the plasma store of the reference stack.
//
// One mmap'd arena file in /dev/shm shared by every process on the host:
//   [Header | free-list entries | index slots | data region]
// - Allocation first tries the shared FREE LIST (first-fit over reclaimed
//   blocks, CAS-claimed), then falls back to a lock-free bump allocator
//   (fetch_add on the header cursor).
// - The index is a fixed-capacity open-addressing hash table; slot state
//   machines (EMPTY→CLAIMED→SEALED→ZOMBIE→TOMBSTONE) use C++11 atomics on
//   the shared mapping, so readers never take a lock and a reader either
//   observes a fully sealed object (acquire on state) or none.
// - Objects are immutable (Overview_of_Ray.ipynb:cc-4).  OWNERSHIP: readers
//   that hold zero-copy views pin the object (arena_lookup_pin/arena_unpin,
//   a cross-process atomic refcount in the slot).  arena_delete on a pinned
//   object parks it in ZOMBIE: invisible to lookups, bytes intact.  The
//   LAST unpin — or delete itself when no pins are out — tombstones the
//   slot and pushes its block onto the free list for reuse.  This is the
//   plasma refcount contract: space is reclaimed exactly when no process
//   can still be reading it.
//
// The Python side maps the same file and does the payload memcpy itself
// (writes go straight into shared memory; reads are memoryview slices of the
// mapping — zero copies end to end). This library owns layout + atomics.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>

#include <errno.h>
#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7470755F61697232ULL;  // "tpu_air2" (layout v2)
// Fixed-width object key. Python passes sha256(object_id) — ids of any
// length map to exactly 32 key bytes (embedded NULs fine; never strlen'd).
constexpr uint32_t kIdBytes = 32;
constexpr uint64_t kAlign = 64;        // block size granularity
constexpr uint64_t kMinFragment = 128; // smallest remainder worth re-listing
constexpr uint32_t kFreeSlots = 4096;  // shared free-list capacity
constexpr uint64_t kFreeBusy = 1;      // sentinel: entry mid-update

enum SlotState : uint32_t {
  kEmpty = 0,
  // RESERVED: slot won by a CAS but id/offset/size not yet written — probers
  // must NOT read the identity bytes (that would race the owner's memcpy).
  // The owner publishes CLAIMED with release order once the fields are in.
  kReserved = 1,
  kClaimed = 2,
  kSealed = 3,
  kTombstone = 4,
  // ZOMBIE: deleted while pinned — invisible to lookups, bytes intact until
  // the last unpin reclaims the block.
  kZombie = 5,
};

struct Slot {
  std::atomic<uint32_t> state;
  std::atomic<uint32_t> pins;  // zero-copy readers holding views (x-process)
  uint8_t id[kIdBytes];
  uint64_t offset;
  uint64_t size;   // payload bytes
  uint64_t block;  // allocated block bytes (>= size; what reclaim returns)
};

// Free-list entry lifecycle: size 0 (empty) → kFreeBusy (being written) →
// block size (available) → kFreeBusy (being claimed) → 0.  offset is only
// read/written by the entry's current owner (the thread that won the CAS).
struct FreeEntry {
  std::atomic<uint64_t> size;
  uint64_t offset;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;      // bytes of data region
  uint64_t data_start;    // file offset of data region
  std::atomic<uint64_t> cursor;  // next free byte in data region (relative)
  uint32_t num_slots;     // power of two
  uint32_t _pad;
  std::atomic<uint64_t> live_objects;
  std::atomic<uint64_t> sealed_bytes;
  std::atomic<uint64_t> free_bytes;    // total bytes sitting in the free list
  std::atomic<uint64_t> leaked_bytes;  // reclaimed blocks the full list dropped
};

struct Arena {
  uint8_t* base = nullptr;
  uint64_t mapped = 0;
  Header* hdr = nullptr;
  FreeEntry* freelist = nullptr;
  Slot* slots = nullptr;
};

constexpr int kMaxArenas = 64;
Arena g_arenas[kMaxArenas];
bool g_used[kMaxArenas] = {};
std::mutex g_handles_mu;  // guards g_used slot assignment (per-process)

uint64_t fnv1a(const uint8_t* id) {
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdBytes; ++i) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

bool id_eq(const uint8_t* a, const uint8_t* b) {
  return std::memcmp(a, b, kIdBytes) == 0;
}

uint64_t round_block(uint64_t size) {
  uint64_t b = (size + kAlign - 1) & ~(kAlign - 1);
  return b ? b : kAlign;
}

// Return a reclaimed block to the shared free list.  A full list leaks the
// block (counted) rather than blocking — correctness over completeness.
void push_free(Arena& a, uint64_t offset, uint64_t block) {
  for (uint32_t i = 0; i < kFreeSlots; ++i) {
    FreeEntry& e = a.freelist[i];
    uint64_t expected = 0;
    if (e.size.load(std::memory_order_relaxed) == 0 &&
        e.size.compare_exchange_strong(expected, kFreeBusy,
                                       std::memory_order_acq_rel)) {
      e.offset = offset;
      e.size.store(block, std::memory_order_release);
      a.hdr->free_bytes.fetch_add(block, std::memory_order_relaxed);
      return;
    }
  }
  a.hdr->leaked_bytes.fetch_add(block, std::memory_order_relaxed);
}

// First-fit claim from the free list.  Returns the data-relative offset and
// sets *block_out, or UINT64_MAX when nothing fits.
uint64_t claim_free(Arena& a, uint64_t need, uint64_t* block_out) {
  for (uint32_t i = 0; i < kFreeSlots; ++i) {
    FreeEntry& e = a.freelist[i];
    uint64_t s = e.size.load(std::memory_order_acquire);
    if (s <= kFreeBusy || s < need) continue;
    if (!e.size.compare_exchange_strong(s, kFreeBusy,
                                        std::memory_order_acq_rel))
      continue;
    uint64_t off = e.offset;
    e.size.store(0, std::memory_order_release);  // entry free for reuse
    a.hdr->free_bytes.fetch_sub(s, std::memory_order_relaxed);
    if (s - need >= kMinFragment) {
      push_free(a, off + need, s - need);
      *block_out = need;
    } else {
      *block_out = s;  // absorb the fragment
    }
    return off;
  }
  return UINT64_MAX;
}


}  // namespace

extern "C" {

// Create + initialize an arena file. Returns 0 on success.
int arena_create(const char* path, uint64_t capacity, uint32_t num_slots) {
  if ((num_slots & (num_slots - 1)) != 0) return -2;  // must be pow2
  uint64_t free_bytes_region = uint64_t(kFreeSlots) * sizeof(FreeEntry);
  uint64_t index_bytes = uint64_t(num_slots) * sizeof(Slot);
  uint64_t meta = sizeof(Header) + free_bytes_region + index_bytes;
  uint64_t data_start = (meta + 4095) & ~4095ULL;
  uint64_t total = data_start + capacity;

  int fd = ::open(path, O_RDWR | O_CREAT | O_EXCL, 0644);
  if (fd < 0) return -1;
  if (::ftruncate(fd, (off_t)total) != 0) {
    ::close(fd);
    ::unlink(path);
    return -3;
  }
  void* mem = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return -4;

  Header* hdr = reinterpret_cast<Header*>(mem);
  std::memset(mem, 0, meta);
  hdr->capacity = capacity;
  hdr->data_start = data_start;
  hdr->cursor.store(0, std::memory_order_relaxed);
  hdr->num_slots = num_slots;
  hdr->live_objects.store(0, std::memory_order_relaxed);
  hdr->sealed_bytes.store(0, std::memory_order_relaxed);
  hdr->free_bytes.store(0, std::memory_order_relaxed);
  hdr->leaked_bytes.store(0, std::memory_order_relaxed);
  // magic last, release: openers spin on it to know init is complete
  reinterpret_cast<std::atomic<uint64_t>*>(&hdr->magic)
      ->store(kMagic, std::memory_order_release);
  ::munmap(mem, total);
  return 0;
}

// Open an existing arena. Returns handle >= 0, or < 0 on error.
int arena_open(const char* path) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return -1;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return -2;
  }
  void* mem =
      ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return -3;
  Header* hdr = reinterpret_cast<Header*>(mem);
  if (reinterpret_cast<std::atomic<uint64_t>*>(&hdr->magic)
          ->load(std::memory_order_acquire) != kMagic) {
    ::munmap(mem, (size_t)st.st_size);
    return -4;
  }
  std::lock_guard<std::mutex> lock(g_handles_mu);
  for (int h = 0; h < kMaxArenas; ++h) {
    if (g_used[h]) continue;
    g_used[h] = true;
    g_arenas[h].base = reinterpret_cast<uint8_t*>(mem);
    g_arenas[h].mapped = (uint64_t)st.st_size;
    g_arenas[h].hdr = hdr;
    g_arenas[h].freelist = reinterpret_cast<FreeEntry*>(
        reinterpret_cast<uint8_t*>(mem) + sizeof(Header));
    g_arenas[h].slots = reinterpret_cast<Slot*>(
        reinterpret_cast<uint8_t*>(mem) + sizeof(Header) +
        uint64_t(kFreeSlots) * sizeof(FreeEntry));
    return h;
  }
  ::munmap(mem, (size_t)st.st_size);  // handle table full — don't leak
  return -5;
}

// Unmap this process's view and free the handle for reuse. Safe while other
// mappings of the file (e.g. Python's own mmap serving zero-copy views)
// remain open.
int arena_close(int h) {
  std::lock_guard<std::mutex> lock(g_handles_mu);
  if (h < 0 || h >= kMaxArenas || !g_used[h]) return -1;
  ::munmap(g_arenas[h].base, (size_t)g_arenas[h].mapped);
  g_arenas[h] = Arena{};
  g_used[h] = false;
  return 0;
}

// Claim an index slot + bump-allocate `size` bytes for object `id`.
// Returns the absolute file offset the caller writes payload to, or:
//   -1 arena full   -2 index full   -3 duplicate id   -4 bad handle
int64_t arena_alloc(int h, const uint8_t* id, uint64_t size) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -4;
  Arena& a = g_arenas[h];
  Header* hdr = a.hdr;

  // Reclaimed space first (ownership/ref-counting made it safe to reuse),
  // bump allocation as the fallback.
  uint64_t need = round_block(size);
  uint64_t block = 0;
  bool from_free = true;
  uint64_t off = claim_free(a, need, &block);
  if (off == UINT64_MAX) {
    from_free = false;
    block = need;
    off = hdr->cursor.fetch_add(need, std::memory_order_relaxed);
  }
  // Undo the reservation on ANY failure path: free-list blocks go back to
  // the list; for bump blocks, if no other allocation landed after ours the
  // cursor CAS restores `off`, otherwise the space is abandoned (the store
  // falls back to the file path for this object anyway).  Without this,
  // repeated re-puts of a duplicate id would permanently consume space.
  auto rollback = [&]() {
    if (from_free) {
      push_free(a, off, block);
    } else {
      uint64_t expect = off + need;
      hdr->cursor.compare_exchange_strong(expect, off, std::memory_order_relaxed);
    }
  };
  if (!from_free && off + need > hdr->capacity) {
    rollback();
    return -1;
  }

  uint32_t mask = hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  // First TOMBSTONE seen on the probe chain: claimable once the duplicate
  // scan has reached kEmpty (without slot reuse, put/delete churn would
  // permanently exhaust the fixed-capacity index).  Zombies are NOT
  // reusable — their block is still pinned by readers.
  uint32_t tomb_idx = UINT32_MAX;
  auto install = [&](Slot& s) {
    std::memcpy(s.id, id, kIdBytes);
    s.offset = off;
    s.size = size;
    s.block = block;
    s.pins.store(0, std::memory_order_relaxed);
    // publish the identity; only now may probers read s.id.  seq_cst (not
    // just release) so the post-install verify scan below forms the SB
    // pattern with a racing writer — see `finish`.
    s.state.store(kClaimed, std::memory_order_seq_cst);
  };
  // Post-install duplicate verify.  Tombstone recycling makes the pre-claim
  // duplicate scan insufficient on its own: writer A can install id X into an
  // early tombstone AFTER writer B's scan probed past it while B claims the
  // end-of-chain EMPTY slot — two live slots for one id.  So after winning a
  // CAS each writer re-scans the chain (SB pattern: the claim is a seq_cst
  // store and these are seq_cst loads — of two racing writers at least one
  // is guaranteed to see the other's claim).  A writer that sees a rival
  // demotes ITS OWN slot and reports duplicate; worst case both yield and the
  // caller's file-store fallback keeps the object durable.
  auto finish = [&](uint32_t my_idx) -> int64_t {
    Slot& mine = a.slots[my_idx];
    uint32_t vidx = (uint32_t)(fnv1a(id)) & mask;
    for (uint32_t probe = 0; probe < hdr->num_slots; ++probe, vidx = (vidx + 1) & mask) {
      if (vidx == my_idx) continue;
      Slot& v = a.slots[vidx];
      uint32_t st = v.state.load(std::memory_order_seq_cst);
      if (st == kEmpty) break;
      for (int spin = 0; st == kReserved && spin < 100000; ++spin) {
        ::sched_yield();
        st = v.state.load(std::memory_order_acquire);
      }
      if ((st == kClaimed || st == kSealed) && id_eq(v.id, id)) {
        // CAS, not a plain store: a concurrent delete may have tombstoned
        // our claimed slot already and an alloc recycled it for another id.
        uint32_t c = kClaimed;
        mine.state.compare_exchange_strong(c, kTombstone,
                                           std::memory_order_acq_rel);
        rollback();
        return -3;
      }
    }
    return (int64_t)(hdr->data_start + off);
  };
  for (uint32_t probe = 0; probe < hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) {
      // end of chain, no duplicate: prefer recycling the earliest tombstone
      if (tomb_idx != UINT32_MAX) {
        Slot& t = a.slots[tomb_idx];
        uint32_t expected = kTombstone;
        if (t.state.compare_exchange_strong(expected, kReserved,
                                            std::memory_order_acq_rel)) {
          install(t);
          return finish(tomb_idx);
        }
        // lost the tombstone to a concurrent alloc — fall through to kEmpty
      }
      uint32_t expected = kEmpty;
      if (s.state.compare_exchange_strong(expected, kReserved,
                                          std::memory_order_acq_rel)) {
        install(s);
        return finish(idx);
      }
      st = s.state.load(std::memory_order_acquire);  // lost race; re-read
    }
    // Identity unknown while RESERVED (owner mid-memcpy); wait, because if
    // the slot turns out to hold our id, skipping would insert a duplicate
    // further down the chain.  The spin is BOUNDED: a process killed between
    // reserve and publish leaves the slot RESERVED forever, and an unbounded
    // wait would hang every alloc whose probe chain crosses it.  After the
    // bound, treat it like a tombstone (worst case: a duplicate of an object
    // that was never published — harmless, it can never seal).
    for (int spin = 0; st == kReserved && spin < 100000; ++spin) {
      ::sched_yield();
      st = s.state.load(std::memory_order_acquire);
    }
    if (st == kReserved) continue;
    if ((st == kClaimed || st == kSealed) && id_eq(s.id, id)) {
      rollback();
      return -3;
    }
    if (st == kTombstone && tomb_idx == UINT32_MAX) tomb_idx = idx;
    // zombie (incl. a deleted generation of our id) / other id → probe on
  }
  // chain never hit kEmpty (full table): a recorded tombstone still works
  if (tomb_idx != UINT32_MAX) {
    Slot& t = a.slots[tomb_idx];
    uint32_t expected = kTombstone;
    if (t.state.compare_exchange_strong(expected, kReserved,
                                        std::memory_order_acq_rel)) {
      install(t);
      return finish(tomb_idx);
    }
  }
  rollback();
  return -2;
}

// Publish a claimed object. Returns 0, or -1 if not found/claimed.
int arena_seal(int h, const uint8_t* id) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -1;
  Arena& a = g_arenas[h];
  uint32_t mask = a.hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  for (uint32_t probe = 0; probe < a.hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return -1;
    if ((st == kClaimed) && id_eq(s.id, id)) {
      a.hdr->live_objects.fetch_add(1, std::memory_order_relaxed);
      a.hdr->sealed_bytes.fetch_add(s.size, std::memory_order_relaxed);
      s.state.store(kSealed, std::memory_order_release);
      return 0;
    }
    if (st == kSealed && id_eq(s.id, id)) return 0;  // idempotent
  }
  return -1;
}

// Look up a sealed object. Returns 1 (sealed; *offset/*size filled),
// 0 (unknown or still being written), or negative on bad handle.
int arena_lookup(int h, const uint8_t* id, uint64_t* offset, uint64_t* size) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -4;
  Arena& a = g_arenas[h];
  uint32_t mask = a.hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  for (uint32_t probe = 0; probe < a.hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return 0;
    if (st == kSealed && id_eq(s.id, id)) {
      *offset = a.hdr->data_start + s.offset;
      *size = s.size;
      return 1;
    }
    if (st == kClaimed && id_eq(s.id, id)) return 0;  // pending
    // tombstone / zombie / other id → continue
  }
  return 0;
}

// Look up AND pin a sealed object: the caller owns one reference, and the
// bytes stay valid (even across arena_delete) until the matching
// arena_unpin.  Returns 1/0/negative like arena_lookup.
//
// Pin/delete race: the pin is published (seq_cst fetch_add) BEFORE the
// state re-check, and delete publishes ZOMBIE (seq_cst) BEFORE reading the
// pin count — so either the deleter observes our pin and defers
// reclamation to our unpin, or we observe its ZOMBIE and back out.
int arena_lookup_pin(int h, const uint8_t* id, uint64_t* offset, uint64_t* size) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -4;
  Arena& a = g_arenas[h];
  uint32_t mask = a.hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  for (uint32_t probe = 0; probe < a.hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return 0;
    if (st == kSealed && id_eq(s.id, id)) {
      s.pins.fetch_add(1, std::memory_order_seq_cst);
      if (s.state.load(std::memory_order_seq_cst) != kSealed) {
        // deleted between find and pin — undo; never resurrect a zombie.
        // NB: offset/block are captured BEFORE the tombstone CAS — the
        // instant the slot turns TOMBSTONE a concurrent alloc may recycle
        // it and overwrite those fields (TSan-verified ordering).
        if (s.pins.fetch_sub(1, std::memory_order_seq_cst) == 1 &&
            s.state.load(std::memory_order_seq_cst) == kZombie) {
          uint64_t blk_off = s.offset, blk = s.block;
          uint32_t z = kZombie;
          if (s.state.compare_exchange_strong(z, kTombstone,
                                              std::memory_order_acq_rel))
            push_free(a, blk_off, blk);
        }
        return 0;
      }
      *offset = a.hdr->data_start + s.offset;
      *size = s.size;
      return 1;
    }
    if (st == kClaimed && id_eq(s.id, id)) return 0;  // pending
  }
  return 0;
}

// Release one pin taken by arena_lookup_pin.  `offset` is the absolute
// offset that call returned — it disambiguates a re-put of the same id
// whose earlier generation is still parked in ZOMBIE.  The last unpin of a
// zombie tombstones it and returns its block to the free list.
int arena_unpin(int h, const uint8_t* id, uint64_t offset) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -4;
  Arena& a = g_arenas[h];
  uint32_t mask = a.hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  for (uint32_t probe = 0; probe < a.hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return -1;
    if ((st == kSealed || st == kZombie) && id_eq(s.id, id) &&
        a.hdr->data_start + s.offset == offset) {
      uint32_t prev = s.pins.fetch_sub(1, std::memory_order_seq_cst);
      if (prev == 1 && s.state.load(std::memory_order_seq_cst) == kZombie) {
        // capture before the CAS: a TOMBSTONE slot is instantly recyclable
        uint64_t blk_off = s.offset, blk = s.block;
        uint32_t z = kZombie;
        if (s.state.compare_exchange_strong(z, kTombstone,
                                            std::memory_order_acq_rel))
          push_free(a, blk_off, blk);
      }
      return 0;
    }
  }
  return -1;
}

// Delete an object.  Unpinned objects are tombstoned and their block is
// reclaimed immediately; pinned objects park in ZOMBIE (invisible, bytes
// intact) until the last reader's unpin reclaims them.
int arena_delete(int h, const uint8_t* id) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -4;
  Arena& a = g_arenas[h];
  uint32_t mask = a.hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  for (uint32_t probe = 0; probe < a.hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return 0;
    if (st == kClaimed && id_eq(s.id, id)) {
      // Never sealed → no readers, but the OWNER may still be memcpy'ing
      // into the block; reusing it would corrupt a future object.  Tombstone
      // without reclaim (rare path: delete of an id that never sealed).
      uint32_t c = kClaimed;
      s.state.compare_exchange_strong(c, kTombstone, std::memory_order_acq_rel);
      return 0;
    }
    if (st == kSealed && id_eq(s.id, id)) {
      uint32_t expected = kSealed;
      if (!s.state.compare_exchange_strong(expected, kZombie,
                                           std::memory_order_seq_cst))
        return 0;  // concurrent deleter won
      a.hdr->live_objects.fetch_sub(1, std::memory_order_relaxed);
      a.hdr->sealed_bytes.fetch_sub(s.size, std::memory_order_relaxed);
      if (s.pins.load(std::memory_order_seq_cst) == 0) {
        // capture before the CAS: a TOMBSTONE slot is instantly recyclable
        uint64_t blk_off = s.offset, blk = s.block;
        uint32_t z = kZombie;
        if (s.state.compare_exchange_strong(z, kTombstone,
                                            std::memory_order_acq_rel))
          push_free(a, blk_off, blk);
      }
      return 0;
    }
  }
  return 0;
}

// Current pin count (diagnostics/tests). -1 when the object is unknown.
int64_t arena_pins(int h, const uint8_t* id) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return -4;
  Arena& a = g_arenas[h];
  uint32_t mask = a.hdr->num_slots - 1;
  uint32_t idx = (uint32_t)(fnv1a(id)) & mask;
  for (uint32_t probe = 0; probe < a.hdr->num_slots; ++probe, idx = (idx + 1) & mask) {
    Slot& s = a.slots[idx];
    uint32_t st = s.state.load(std::memory_order_acquire);
    if (st == kEmpty) return -1;
    if ((st == kSealed || st == kZombie) && id_eq(s.id, id))
      return (int64_t)s.pins.load(std::memory_order_relaxed);
  }
  return -1;
}

uint64_t arena_capacity(int h) {
  return (h >= 0 && h < kMaxArenas && g_arenas[h].hdr) ? g_arenas[h].hdr->capacity : 0;
}

uint64_t arena_used(int h) {
  if (h < 0 || h >= kMaxArenas || !g_arenas[h].hdr) return 0;
  uint64_t c = g_arenas[h].hdr->cursor.load(std::memory_order_relaxed);
  uint64_t cap = g_arenas[h].hdr->capacity;
  return c < cap ? c : cap;
}

uint64_t arena_live_objects(int h) {
  return (h >= 0 && h < kMaxArenas && g_arenas[h].hdr)
             ? g_arenas[h].hdr->live_objects.load(std::memory_order_relaxed)
             : 0;
}

uint64_t arena_sealed_bytes(int h) {
  return (h >= 0 && h < kMaxArenas && g_arenas[h].hdr)
             ? g_arenas[h].hdr->sealed_bytes.load(std::memory_order_relaxed)
             : 0;
}

uint64_t arena_free_bytes(int h) {
  return (h >= 0 && h < kMaxArenas && g_arenas[h].hdr)
             ? g_arenas[h].hdr->free_bytes.load(std::memory_order_relaxed)
             : 0;
}

uint64_t arena_leaked_bytes(int h) {
  return (h >= 0 && h < kMaxArenas && g_arenas[h].hdr)
             ? g_arenas[h].hdr->leaked_bytes.load(std::memory_order_relaxed)
             : 0;
}

}  // extern "C"
