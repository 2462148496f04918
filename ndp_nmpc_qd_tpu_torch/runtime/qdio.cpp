// qdio: shared-memory pub/sub bus + real-time rate executor.
//
// Native runtime replacing the reference's ROS1 transport stack
// (TCPROS pub/sub, per-drone nodes, rospy timers — nmpc_node.py:73-109):
//
//  - Topics are named POSIX shared-memory segments holding a fixed-size
//    ring of messages guarded by a seqlock per slot: single-writer,
//    any-reader, lock-free, latest-value semantics. This matches how the
//    reference actually uses ROS: subscribers keep only the last message
//    (e.g. followers use the last received PredXU, nmpc_follower_node.py:58)
//    and tolerate one-tick staleness.
//  - The rate executor is an absolute-deadline clock_nanosleep loop with
//    overrun accounting — the native analog of rospy.Timer plus the
//    "Control is too slow!" check (nmpc_node.py:216-220).
//
// Message payloads are opaque byte blobs; the Python layer (bus.py) maps
// them to numpy dtypes mirroring the reference's msg/ schemas.
//
// The PyTorch port's own copy of `ndp_nmpc_qd_tpu/runtime/qdio.cpp`: the same
// ring, entry points and shared-memory names, so that processes of either
// package read each other's topics. bus.py builds it at first use with
//   g++ -std=c++17 -O2 -shared -fPIC -o libqdio-<hash>.so qdio.cpp -lrt -pthread

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x7164696f;  // "qdio"

struct SlotHeader {
  std::atomic<uint64_t> seq;  // seqlock: odd while writing
};

struct TopicHeader {
  uint32_t magic;
  uint32_t msg_size;
  uint32_t capacity;           // ring slots
  uint32_t _pad;
  std::atomic<uint64_t> head;  // total messages ever published
};

struct Topic {
  TopicHeader* hdr;
  uint8_t* slots;  // capacity * (SlotHeader + msg_size)
  size_t map_size;
};

inline size_t slot_stride(uint32_t msg_size) {
  size_t s = sizeof(SlotHeader) + msg_size;
  return (s + 63) & ~size_t(63);  // cacheline align
}

inline SlotHeader* slot_at(Topic* t, uint64_t idx) {
  uint64_t i = idx % t->hdr->capacity;
  return reinterpret_cast<SlotHeader*>(t->slots + i * slot_stride(t->hdr->msg_size));
}

}  // namespace

extern "C" {

// Open (creating if needed) a topic. Returns an opaque handle or null.
void* qdio_topic_open(const char* name, uint32_t msg_size, uint32_t capacity) {
  if (capacity == 0) capacity = 8;
  size_t size = sizeof(TopicHeader) + capacity * slot_stride(msg_size);

  int fd = shm_open(name, O_RDWR | O_CREAT, 0600);
  if (fd < 0) return nullptr;
  // Resize only if fresh (size 0); otherwise validate.
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  bool fresh = st.st_size == 0;
  if (fresh && ftruncate(fd, size) != 0) { close(fd); return nullptr; }
  if (!fresh && (size_t)st.st_size < size) { close(fd); return nullptr; }

  void* mem = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  auto* t = new Topic;
  t->hdr = reinterpret_cast<TopicHeader*>(mem);
  t->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(TopicHeader);
  t->map_size = size;

  if (fresh) {
    t->hdr->msg_size = msg_size;
    t->hdr->capacity = capacity;
    t->hdr->head.store(0, std::memory_order_relaxed);
    std::memset(t->slots, 0, capacity * slot_stride(msg_size));
    std::atomic_thread_fence(std::memory_order_release);
    t->hdr->magic = kMagic;
  } else {
    // wait-free validation: publisher may still be initializing
    if (t->hdr->magic != kMagic || t->hdr->msg_size != msg_size) {
      munmap(mem, size);
      delete t;
      return nullptr;
    }
  }
  return t;
}

void qdio_topic_close(void* handle) {
  auto* t = static_cast<Topic*>(handle);
  if (!t) return;
  munmap(t->hdr, t->map_size);
  delete t;
}

void qdio_topic_unlink(const char* name) { shm_unlink(name); }

// Publish one message (single writer per topic).
//
// Seqlock write protocol (Boehm-style): the odd marker must become visible
// BEFORE any payload store (store-store ordering), which needs a full
// barrier after it — a release store/fence only orders EARLIER writes.
// The closing even store after a release fence orders the payload before it.
void qdio_publish(void* handle, const void* data) {
  auto* t = static_cast<Topic*>(handle);
  uint64_t idx = t->hdr->head.load(std::memory_order_relaxed);
  SlotHeader* s = slot_at(t, idx);
  uint64_t seq0 = s->seq.load(std::memory_order_relaxed);
  s->seq.store(seq0 + 1, std::memory_order_relaxed);  // odd: writing
  std::atomic_thread_fence(std::memory_order_seq_cst);
  std::memcpy(reinterpret_cast<uint8_t*>(s) + sizeof(SlotHeader), data,
              t->hdr->msg_size);
  std::atomic_thread_fence(std::memory_order_release);
  s->seq.store(seq0 + 2, std::memory_order_relaxed);  // even: done
  t->hdr->head.store(idx + 1, std::memory_order_release);
}

// Read the latest message. Returns its sequence number (0 = nothing yet,
// -1 = torn after retries). Lock-free seqlock read.
int64_t qdio_read_latest(void* handle, void* out) {
  auto* t = static_cast<Topic*>(handle);
  for (int attempt = 0; attempt < 64; ++attempt) {
    uint64_t head = t->hdr->head.load(std::memory_order_acquire);
    if (head == 0) return 0;
    SlotHeader* s = slot_at(t, head - 1);
    uint64_t s0 = s->seq.load(std::memory_order_acquire);
    if (s0 & 1) continue;  // being written
    std::memcpy(out, reinterpret_cast<uint8_t*>(s) + sizeof(SlotHeader),
                t->hdr->msg_size);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s1 = s->seq.load(std::memory_order_acquire);
    if (s0 == s1) return (int64_t)head;
  }
  return -1;
}

uint64_t qdio_message_count(void* handle) {
  return static_cast<Topic*>(handle)->hdr->head.load(std::memory_order_acquire);
}

// ---- rate executor -------------------------------------------------------

struct Rate {
  struct timespec next;
  long period_ns;
  long last_overrun_ns;
  uint64_t ticks;
  uint64_t overruns;
};

void* qdio_rate_create(double period_s) {
  auto* r = new Rate;
  r->period_ns = (long)(period_s * 1e9);
  clock_gettime(CLOCK_MONOTONIC, &r->next);
  r->last_overrun_ns = 0;
  r->ticks = 0;
  r->overruns = 0;
  return r;
}

// Sleep until the next absolute deadline. Returns the overrun of the
// PREVIOUS period in nanoseconds (0 if on time) — the native analog of
// rospy's timer.last_duration deadline check.
long qdio_rate_sleep(void* handle) {
  auto* r = static_cast<Rate*>(handle);
  r->next.tv_nsec += r->period_ns;
  while (r->next.tv_nsec >= 1000000000L) {
    r->next.tv_nsec -= 1000000000L;
    r->next.tv_sec += 1;
  }
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  long late_ns = (now.tv_sec - r->next.tv_sec) * 1000000000L +
                 (now.tv_nsec - r->next.tv_nsec);
  r->ticks += 1;
  if (late_ns > 0) {
    r->last_overrun_ns = late_ns;
    r->overruns += 1;
    // deadline already missed: re-anchor to now to avoid spiral
    r->next = now;
    return late_ns;
  }
  r->last_overrun_ns = 0;
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &r->next, nullptr) ==
         EINTR) {
  }
  return 0;
}

uint64_t qdio_rate_ticks(void* handle) { return static_cast<Rate*>(handle)->ticks; }
uint64_t qdio_rate_overruns(void* handle) {
  return static_cast<Rate*>(handle)->overruns;
}

void qdio_rate_destroy(void* handle) { delete static_cast<Rate*>(handle); }

double qdio_monotonic_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

}  // extern "C"
