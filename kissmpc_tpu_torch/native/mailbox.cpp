// Native lock-free single-writer mailbox (seqlock) for the host I/O plane.
//
// The reference's transport runtime is ROS 2's rcl/DDS (C/C++): depth-1
// subscriptions deliver the newest odometry/plan message into node state
// (`ros2interface.py:45-49,91-107`).  The framework's Python `LatestValue`
// (io/pubsub.py) covers the semantics with a mutex; this is the native
// equivalent for the real-time path — a classic seqlock so a 100 Hz-1 kHz
// producer never blocks and a reader never observes a torn payload, with no
// mutex and no GIL interaction inside the critical section (ctypes releases
// the GIL for the call).
//
// Protocol: the writer bumps `seq` to odd, copies the payload, bumps to
// even.  Readers snapshot `seq`, copy out, and retry while `seq` was odd or
// changed during the copy.  Versions are `seq / 2` (0 = never written).
//
// Build: compiled into libkissmpc_native-<hash>.so together with edt.cpp
// (kissmpc_tpu_torch/native/__init__.py).  A copy of
// kissmpc_tpu/native/mailbox.cpp, owned by the port.

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

struct Mailbox {
  std::atomic<uint64_t> seq{0};
  int64_t capacity = 0;  // payload doubles
  int64_t size = 0;      // doubles in the last publish
  double* buf = nullptr;
};

}  // namespace

extern "C" {

void* kissmpc_mailbox_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  Mailbox* m = new Mailbox();
  m->capacity = capacity;
  m->buf = new double[capacity];
  return m;
}

void kissmpc_mailbox_destroy(void* h) {
  Mailbox* m = static_cast<Mailbox*>(h);
  if (!m) return;
  delete[] m->buf;
  delete m;
}

// Publish n doubles (n <= capacity).  Single writer assumed (the seqlock
// write side is not multi-producer).  Returns the new version, 0 on error.
uint64_t kissmpc_mailbox_publish(void* h, const double* data, int64_t n) {
  Mailbox* m = static_cast<Mailbox*>(h);
  if (!m || n < 0 || n > m->capacity) return 0;
  uint64_t s = m->seq.load(std::memory_order_relaxed);
  m->seq.store(s + 1, std::memory_order_release);  // odd: write in progress
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(m->buf, data, sizeof(double) * static_cast<size_t>(n));
  m->size = n;
  m->seq.store(s + 2, std::memory_order_release);  // even: consistent
  return (s + 2) / 2;
}

// Read the newest payload into out (capacity >= mailbox capacity).  Returns
// the version (0 = never written); *out_n gets the payload length.  Wait-
// free for the writer; the reader retries while a write is in flight.
uint64_t kissmpc_mailbox_read(void* h, double* out, int64_t* out_n) {
  Mailbox* m = static_cast<Mailbox*>(h);
  if (!m) return 0;
  for (;;) {
    uint64_t s0 = m->seq.load(std::memory_order_acquire);
    if (s0 == 0) return 0;
    if (s0 & 1) continue;  // write in progress
    int64_t n = m->size;
    std::memcpy(out, m->buf, sizeof(double) * static_cast<size_t>(n));
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s1 = m->seq.load(std::memory_order_acquire);
    if (s0 == s1) {
      *out_n = n;
      return s1 / 2;
    }
  }
}

}  // extern "C"
