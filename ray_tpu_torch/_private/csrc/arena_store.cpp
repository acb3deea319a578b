// Shared-memory arena object store — the native hot path of the per-node
// store (role-equivalent to plasma's mmap'd arenas + dlmalloc:
// `src/ray/object_manager/plasma/store.cc:1`, `plasma_allocator.h`).
//
// One mmap'd tmpfs file per node holds every object; allocation is a
// first-fit free list with coalescing; metadata (id -> extent, seal/pin
// bits, LRU stamps) lives in the owning raylet process. Clients receive
// (arena path, offset, size) and map the arena once — create/get never
// touch a per-object file, so small-object churn costs an allocator walk
// instead of three syscalls.
//
// Exposed as a C ABI consumed through ctypes (the image has no pybind11).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;
constexpr uint64_t kInvalid = ~0ull;

struct Entry {
  uint64_t offset = 0;
  uint64_t size = 0;
  bool sealed = false;
  bool pinned = false;
  uint32_t refs = 0;  // client mappings (plasma-style: space with live
                      // readers is never reused by evict/spill)
  uint64_t lru = 0;   // monotonic access stamp
};

struct Store {
  // Guards entries/free_list/counters. Callers are nominally the
  // raylet's single event loop, but ctypes releases the GIL around C
  // calls, so any second Python thread would otherwise race.
  std::mutex mu;
  int fd = -1;
  uint8_t* base = nullptr;
  uint64_t capacity = 0;
  uint64_t used = 0;
  uint64_t lru_clock = 0;
  uint64_t num_evictions = 0;
  std::unordered_map<std::string, Entry> entries;
  // free extents keyed by offset -> size (coalescing on release)
  std::map<uint64_t, uint64_t> free_list;

  // One background sweep that commits every arena page at open.
  std::thread toucher;
  std::atomic<bool> closing{false};
  // Highest byte ever allocated; the toucher pre-commits a bounded
  // window ahead of it instead of the whole declared capacity, so a
  // mostly-empty store does not become RAM-resident up front (full
  // residency can OOM memory-tight hosts that lazy faulting spared).
  std::atomic<uint64_t> watermark{0};

  void toucher_main() {
    // RTPU_ARENA_PRECOMMIT: "ahead" (default) commits up to 256MB past
    // the allocation watermark; "full" commits the whole capacity up
    // front (dedicated hosts where the budget is truly reserved);
    // "off" leaves every fault to first touch.
    const char* mode_env = ::getenv("RTPU_ARENA_PRECOMMIT");
    std::string mode = mode_env ? mode_env : "ahead";
    if (mode == "off") return;
    const uint64_t headroom = 256ull << 20;
    uint64_t pos = 0;
    while (pos < capacity && !closing.load(std::memory_order_relaxed)) {
      uint64_t target =
          mode == "full"
              ? capacity
              : std::min<uint64_t>(
                    capacity,
                    watermark.load(std::memory_order_relaxed) + headroom);
      if (pos >= target) {
        ::usleep(10000);
        continue;
      }
      // MADV_POPULATE_WRITE faults pages in WITHOUT modifying content,
      // so racing a client's concurrent write into a just-allocated
      // extent is safe by construction (a plain zero-write would not
      // be). On kernels without it, clients simply pay the faults.
      uint64_t chunk = std::min<uint64_t>(8ull << 20, target - pos);
#ifdef MADV_POPULATE_WRITE
      if (::madvise(base + pos, chunk, MADV_POPULATE_WRITE) != 0) break;
#else
      break;
#endif
      pos += chunk;
    }
  }

  bool can_allocate(uint64_t size) const {
    uint64_t want = (size + kAlign - 1) & ~(kAlign - 1);
    if (want == 0) want = kAlign;
    for (const auto& kv : free_list)
      if (kv.second >= want) return true;
    return false;
  }

  uint64_t allocate(uint64_t size) {
    uint64_t want = (size + kAlign - 1) & ~(kAlign - 1);
    if (want == 0) want = kAlign;
    for (auto it = free_list.begin(); it != free_list.end(); ++it) {
      if (it->second >= want) {
        uint64_t off = it->first;
        uint64_t extent = it->second;
        free_list.erase(it);
        if (extent > want) free_list.emplace(off + want, extent - want);
        used += want;
        uint64_t end = off + want;
        uint64_t seen = watermark.load(std::memory_order_relaxed);
        while (end > seen &&
               !watermark.compare_exchange_weak(seen, end)) {
        }
        return off;
      }
    }
    return kInvalid;
  }

  // Caller holds mu (evict calls this mid-scan; the public delete
  // wraps it with the lock).
  bool delete_unlocked(const std::string& id) {
    auto it = entries.find(id);
    if (it == entries.end()) return false;
    release(it->second.offset, it->second.size);
    entries.erase(it);
    return true;
  }

  void release(uint64_t offset, uint64_t size) {
    uint64_t want = (size + kAlign - 1) & ~(kAlign - 1);
    if (want == 0) want = kAlign;
    used -= want;
    auto next = free_list.lower_bound(offset);
    // coalesce with previous extent
    if (next != free_list.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == offset) {
        offset = prev->first;
        want += prev->second;
        free_list.erase(prev);
      }
    }
    // coalesce with next extent
    if (next != free_list.end() && offset + want == next->first) {
      want += next->second;
      free_list.erase(next);
    }
    free_list.emplace(offset, want);
  }
};

}  // namespace

extern "C" {

void* rtpu_store_open(const char* path, uint64_t capacity) {
  int fd = ::open(path, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, (off_t)capacity) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED,
                      fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<uint8_t*>(base);
  s->capacity = capacity;
  s->free_list.emplace(0, capacity);
  // Background page pre-commit: fresh tmpfs pages cost ~0.4ms/MB to
  // allocate+zero at first touch, capping first-write bandwidth near
  // 2 GB/s however the fault is taken. The toucher stays a bounded
  // window ahead of the allocation watermark by default (see
  // toucher_main / RTPU_ARENA_PRECOMMIT) so a mostly-empty store does
  // not become RAM-resident up front.
  s->toucher = std::thread([s] { s->toucher_main(); });
  return s;
}

void rtpu_store_close(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return;
  s->closing.store(true);
  if (s->toucher.joinable()) s->toucher.join();
  ::munmap(s->base, s->capacity);
  ::close(s->fd);
  delete s;
}

// Returns the object's offset, or UINT64_MAX when allocation fails even
// after evicting every unpinned sealed object (caller then spills).
// Idempotent for an existing id of the same size.
uint64_t rtpu_store_create(void* h, const char* id, uint64_t size) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  if (it != s->entries.end()) {
    if (it->second.size == size) return it->second.offset;
    return kInvalid;
  }
  uint64_t off = s->allocate(size);
  if (off == kInvalid) return kInvalid;
  Entry e;
  e.offset = off;
  e.size = size;
  e.lru = ++s->lru_clock;
  s->entries.emplace(id, e);
  return off;
}

int rtpu_store_seal(void* h, const char* id) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  if (it == s->entries.end()) return -1;
  it->second.sealed = true;
  it->second.lru = ++s->lru_clock;
  return 0;
}

// 0 = found+sealed; 1 = exists but unsealed; -1 = missing.
int rtpu_store_get(void* h, const char* id, uint64_t* offset,
                   uint64_t* size) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  if (it == s->entries.end()) return -1;
  if (!it->second.sealed) return 1;
  it->second.lru = ++s->lru_clock;
  *offset = it->second.offset;
  *size = it->second.size;
  return 0;
}

int rtpu_store_contains(void* h, const char* id) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  return it != s->entries.end() && it->second.sealed ? 1 : 0;
}

int rtpu_store_delete(void* h, const char* id) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->delete_unlocked(id) ? 0 : -1;
}

// Client mapping refcount: objects with refs > 0 are excluded from both
// eviction and spill victim selection (their arena bytes are live in some
// process's address space).
int rtpu_store_addref(void* h, const char* id, int delta) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  if (it == s->entries.end()) return -1;
  int64_t next = (int64_t)it->second.refs + delta;
  it->second.refs = next < 0 ? 0 : (uint32_t)next;
  return (int)it->second.refs;
}

int rtpu_store_pin(void* h, const char* id, int pinned) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  if (it == s->entries.end()) return -1;
  it->second.pinned = pinned != 0;
  return 0;
}

// Evict unpinned sealed objects (LRU-first) until `needed` bytes could be
// allocated. Evicted ids are written as concatenated NUL-terminated hex
// strings into `evicted` (capacity `evicted_cap` bytes). Returns the
// number of evicted objects.
int rtpu_store_evict(void* h, uint64_t needed, char* evicted,
                     uint64_t evicted_cap) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int count = 0;
  uint64_t written = 0;
  while (!s->can_allocate(needed)) {
    const std::string* victim = nullptr;
    uint64_t best = ~0ull;
    for (auto& kv : s->entries) {
      if (kv.second.sealed && !kv.second.pinned && kv.second.refs == 0 &&
          kv.second.lru < best) {
        best = kv.second.lru;
        victim = &kv.first;
      }
    }
    if (!victim) break;
    std::string vid = *victim;
    uint64_t len = vid.size() + 1;
    if (written + len <= evicted_cap) {
      std::memcpy(evicted + written, vid.c_str(), len);
      written += len;
    }
    s->delete_unlocked(vid);  // NOT the public fn: mu is already held
    ++s->num_evictions;
    ++count;
  }
  if (written < evicted_cap) evicted[written] = '\0';
  return count;
}

// Least-recently-used pinned sealed object (spill candidate): writes its
// hex id/offset/size; returns 0, or -1 when none exists.
int rtpu_store_lru_pinned(void* h, char* id_out, uint64_t id_cap,
                          uint64_t* offset, uint64_t* size) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  const std::string* victim = nullptr;
  uint64_t best = ~0ull;
  for (auto& kv : s->entries) {
    if (kv.second.sealed && kv.second.pinned && kv.second.refs == 0 &&
        kv.second.lru < best) {
      best = kv.second.lru;
      victim = &kv.first;
    }
  }
  if (!victim) return -1;
  if (victim->size() + 1 > id_cap) return -1;
  std::memcpy(id_out, victim->c_str(), victim->size() + 1);
  auto& e = s->entries[*victim];
  *offset = e.offset;
  *size = e.size;
  return 0;
}

// Debug introspection for tests/diagnostics: out = {found, sealed,
// pinned, refs}.
void rtpu_store_entry_flags(void* h, const char* id, uint64_t out[4]) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->entries.find(id);
  if (it == s->entries.end()) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  out[0] = 1;
  out[1] = it->second.sealed ? 1 : 0;
  out[2] = it->second.pinned ? 1 : 0;
  out[3] = it->second.refs;
}

void rtpu_store_stats(void* h, uint64_t out[4]) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  out[0] = s->capacity;
  out[1] = s->used;
  out[2] = s->entries.size();
  out[3] = s->num_evictions;
}

}  // extern "C"
