"""The CPU shims' way of running a block's CUDA threads.

`scripts/ipm_split_cpu_shim.py` and `scripts/riccati_cpu_shim.py` compile a
kernel's source with g++ behind a header in place of `cuda_runtime.h`.
``RUNTIME`` is the part of that header that runs one block: every CUDA
thread of the block is a context of its own, a barrier (`ShimBarrier`)
holds each thread until the block's (or the warp's) threads have all
arrived, and `shim_yield()` lets the others run.

By default the threads are fibers (`ucontext`) on the calling OS thread: a
thread that waits switches to the next one in turn, so a block's thousands
of barrier phases cost microseconds, not a wake-up of 32 or 128 OS threads
each.  Compiled with ``-DSHIM_THREADS`` (the shims do so under a
sanitizer, which does not follow fibers), every CUDA thread is a
`std::thread` and the barrier is `std::barrier`, so ThreadSanitizer sees
the threads' accesses race where a barrier is missing.

The header that includes ``RUNTIME`` defines ``ShimTls`` (what a CUDA
thread keeps to itself: its indices, its warp, its block) and
``shim_tls``, a `thread_local` of that type; in fiber mode the runtime
saves and restores ``shim_tls`` at every switch.  `shim_run_block(threads,
body)` runs ``body(t)`` for t = 0..threads-1 and returns when all have.
"""

RUNTIME = r"""
#ifdef SHIM_THREADS
#include <barrier>
#include <thread>
inline void shim_yield() { std::this_thread::yield(); }
using ShimBarrier = std::barrier<>;
template <class Body> void shim_run_block(int threads, Body body) {
  std::vector<std::thread> lanes;
  for (int t = 0; t < threads; ++t) lanes.emplace_back([&, t] { body(t); });
  for (auto& l : lanes) l.join();
}
#else
#include <functional>
#include <ucontext.h>
struct ShimFibers {
  std::vector<ucontext_t> ctx;
  std::vector<ShimTls> tls;
  std::vector<char> done;
  std::vector<std::unique_ptr<char[]>> stacks;
  ucontext_t main;
  int cur = 0, n = 0, left = 0;
  std::function<void(int)> body;
};
constexpr size_t kShimStack = 256 * 1024;
thread_local ShimFibers* shim_fibers = nullptr;
// The next thread in turn that has not finished after ``from`` (itself if
// none has).
inline int shim_next(const ShimFibers* f, int from) {
  int to = from;
  do to = (to + 1) % f->n; while (f->done[to] && to != from);
  return to;
}
inline void shim_yield() {
  ShimFibers* f = shim_fibers;
  const int from = f->cur, to = shim_next(f, from);
  if (to == from) return;
  f->tls[from] = shim_tls;
  f->cur = to;
  shim_tls = f->tls[to];
  swapcontext(&f->ctx[from], &f->ctx[to]);
}
struct ShimBarrier {
  explicit ShimBarrier(std::ptrdiff_t count) : n(count) {}
  void arrive_and_wait() {
    const unsigned long long g = gen;
    if (++arrived == n) {
      arrived = 0;
      ++gen;
      return;
    }
    while (gen == g) shim_yield();
  }
  std::ptrdiff_t n, arrived = 0;
  unsigned long long gen = 0;
};
inline void shim_fiber_entry() {
  ShimFibers* f = shim_fibers;
  f->body(f->cur);
  f->tls[f->cur] = shim_tls;
  f->done[f->cur] = 1;
  --f->left;
}  // returns to the block's loop (uc_link)
template <class Body> void shim_run_block(int threads, Body body) {
  thread_local ShimFibers fibers;
  ShimFibers& f = fibers;
  shim_fibers = &f;
  f.n = f.left = threads;
  f.ctx.resize(threads);
  f.tls.assign(threads, ShimTls{});
  f.done.assign(threads, 0);
  while (static_cast<int>(f.stacks.size()) < threads)
    f.stacks.push_back(std::make_unique<char[]>(kShimStack));
  f.body = body;
  for (int t = 0; t < threads; ++t) {
    getcontext(&f.ctx[t]);
    f.ctx[t].uc_stack.ss_sp = f.stacks[t].get();
    f.ctx[t].uc_stack.ss_size = kShimStack;
    f.ctx[t].uc_link = &f.main;
    makecontext(&f.ctx[t], shim_fiber_entry, 0);
  }
  const ShimTls caller = shim_tls;
  f.cur = threads - 1;
  while (f.left > 0) {
    f.cur = shim_next(&f, f.cur);
    shim_tls = f.tls[f.cur];
    swapcontext(&f.main, &f.ctx[f.cur]);
  }
  shim_tls = caller;
}
#endif
"""
