#!/usr/bin/env python3
"""The Riccati kernel's source run on the CPU, one thread per CUDA thread,
against its plain version; optionally under AddressSanitizer or
ThreadSanitizer.

    python3 scripts/riccati_cpu_shim.py [--sanitize address|thread] [--drop-barrier]

No GPU and no nvcc are needed, only g++ (C++20).  The script compiles
`kissmpc_tpu_torch/csrc/riccati.cu` into a temporary directory with a small
header in place of `cuda_runtime.h`: every thread of a block is a fiber
(`scripts/shim_runtime.py`; a `std::thread` under a sanitizer, and
`--drop-barrier` is meant for ThreadSanitizer); `__syncthreads()` waits on
the block's barrier; a
`__shfl_sync` writes the lane's value to its warp's slots, waits, reads its
source lane's slot and waits again; the staging primitives between the
source's marks become a plain copy for the bulk (TMA) copy and an atomic
word for each mbarrier, which counts a phase's arrivals and flips its
parity when every warp of the block has arrived, with release and acquire
ordering as the card's barrier gives; `__syncwarp` waits on the warp's
barrier and `__reduce_add_sync` sums through the warp's slots; the block's
dynamic shared memory is a vector of exactly the launch's byte
count with every byte 0xff (a NaN in float and in double), so a read before
a write shows; the launch runs the blocks one after another.  The build's
launcher is called through ctypes on CPU tensors and held against
`ops/lqr.py::solve_lqr` by chip_smoke.py's phase-2 gate (`riccati_gate`):
each output (dx, du, K, k) of each scenario within, in float32, 1e-4 of
its scale plus four times the plain version's own f32-vs-f64 gap there, in
float64 1e-9 of its scale.

With ``--sanitize address`` the build and the run use AddressSanitizer: a
copy past either end of an input tensor (the head and tail a 16-byte unit
may overhang), or past the block's shared memory, is reported.  With
``--sanitize thread`` they use ThreadSanitizer: a thread reading staged
values another thread copied without a barrier between is a data race.
``--drop-barrier`` removes the `__syncthreads()` between the forward
rollout's reads of a buffer and the copies of a later chunk into it, in a
build of two warps per block (a planted race between the warps, seen at
N=100, where the rollout reuses a buffer; ThreadSanitizer must report
it).  The
script re-executes itself with the sanitizer's runtime preloaded and exits
non-zero on a mismatch or a sanitizer report.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from shim_runtime import RUNTIME  # noqa: E402

SHIM = r"""
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct ShimDim { unsigned x; };
struct ShimWarp;
struct ShimBlock;
// What a CUDA thread keeps to itself (the fibers' runtime swaps it).
struct ShimTls {
  ShimDim tid, bid;
  ShimWarp* warp;
  ShimBlock* block;
  unsigned char* smem;
};
thread_local ShimTls shim_tls;
#define threadIdx (shim_tls.tid)
#define blockIdx (shim_tls.bid)
#define shim_warp (shim_tls.warp)
#define shim_block (shim_tls.block)
#define shim_smem (shim_tls.smem)
""" + RUNTIME + r"""
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* device) {
  *device = 0;
  return 0;
}
inline const char* cudaGetErrorString(int) { return "shim"; }
struct ShimWarp {
  ShimBarrier bar{32};
  double slot[32];
};
struct ShimBlock {
  explicit ShimBlock(int n) : bar(n) {}
  ShimBarrier bar;
};
inline void __syncthreads() { shim_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp->bar.arrive_and_wait(); }
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  shim_warp->slot[lane] = static_cast<double>(v);
  shim_warp->bar.arrive_and_wait();
  double sum = 0;
  for (int i = 0; i < 32; ++i) sum += shim_warp->slot[i];
  shim_warp->bar.arrive_and_wait();
  return static_cast<unsigned>(sum);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  shim_warp->slot[lane] = static_cast<double>(v);
  shim_warp->bar.arrive_and_wait();
  const T r = static_cast<T>(shim_warp->slot[lane / width * width + src % width]);
  shim_warp->bar.arrive_and_wait();
  return r;
}
template <class Kern, class... A>
void shim_launch(Kern kernel, int blocks, int threads, size_t bytes, cudaStream_t, A... args) {
  for (int blk = 0; blk < blocks; ++blk) {
    std::vector<double> sm(bytes / sizeof(double), std::nan(""));
    std::memset(sm.data(), 0xff, bytes);
    ShimBlock block(threads);
    std::vector<std::unique_ptr<ShimWarp>> warps;
    for (int w = 0; w < threads / 32; ++w) warps.push_back(std::make_unique<ShimWarp>());
    shim_run_block(threads, [&](int t) {
      shim_tls.tid.x = static_cast<unsigned>(t);
      shim_tls.bid.x = static_cast<unsigned>(blk);
      shim_tls.warp = warps[t / 32].get();
      shim_tls.block = &block;
      shim_tls.smem = reinterpret_cast<unsigned char*>(sm.data());
      kernel(args...);
    });
  }
}
"""
PRIMITIVES = r"""
// A barrier's 8 bytes as two words: this phase's arrivals, and the parity
// of the phases completed, which only the last arriver of a phase writes
// (so a waiter synchronises with that phase's arrivals and no later ones).
// The copies are plain and synchronous, so no transaction bytes are kept.
inline std::atomic_ref<unsigned> shim_word(unsigned long long* bar, int i) {
  return std::atomic_ref<unsigned>(reinterpret_cast<unsigned*>(bar)[i]);
}
inline void bar_init(unsigned long long* bar, unsigned) {
  shim_word(bar, 0).store(0, std::memory_order_relaxed);
  shim_word(bar, 1).store(0, std::memory_order_release);
}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long*) {
  std::memcpy(dst, src, bytes);
}
inline void bar_arrive_expect(unsigned long long* bar, unsigned) {
  // An arrival releases, as mbarrier.arrive does, and acquires nothing; the
  // last one acquires the phase's arrivals before it publishes them.
  if (shim_word(bar, 0).fetch_add(1, std::memory_order_release) + 1 ==
      static_cast<unsigned>(kThreads / 32)) {
    (void)shim_word(bar, 0).load(std::memory_order_acquire);
    shim_word(bar, 0).store(0, std::memory_order_relaxed);
    shim_word(bar, 1).store(shim_word(bar, 1).load(std::memory_order_relaxed) ^ 1u,
                            std::memory_order_release);
  }
}
inline void bar_wait(unsigned long long* bar, unsigned parity) {
  while ((shim_word(bar, 1).load(std::memory_order_acquire) & 1u) == parity)
    shim_yield();
}
"""
def warp_edits(warps):
    """Edits of riccati.cu, (text, replacement), that make a block ``warps``
    warps: each warp's lane 0 arrives on a chunk's barrier with its copies'
    bytes."""
    return [("constexpr int kThreads = 32;      // one warp per block\n",
             f"constexpr int kThreads = {32 * warps};\n"),
            ("    bar_init(&bars[0], 1);\n    bar_init(&bars[1], 1);\n",
             f"    bar_init(&bars[0], {warps});\n    bar_init(&bars[1], {warps});\n"),
            ("  if (threadIdx.x == 0) bar_arrive_expect(bar, bytes);",
             "  if (threadIdx.x % 32 == 0) bar_arrive_expect(bar, bytes);")]


# The rollout's barrier between its reads of a buffer and the copies of a
# later chunk into it.  (The sweep's twin is not planted: its shuffles,
# modelled here as warp barriers, order each warp on their own.)
ROLLOUT_BARRIER = ("    __syncthreads();  // the buffer is read; the copies of chunk c - 2 may "
                   "land in it\n")


def shim_source(text, drop_barrier=False, edits=()):
    """The kernel's source with the shim in place of the CUDA runtime; each
    of ``edits`` is (text, replacement), text occurring once."""
    begin = text.find("// ---- staging primitives")
    end = text.find("// ---- end of staging primitives")
    if begin < 0 or end < 0:
        raise SystemExit("riccati_cpu_shim: the staging primitives' marks are not in riccati.cu")
    text = text[:begin] + PRIMITIVES + text[end:]
    edits = [("#include <cuda_runtime.h>\n", SHIM),
             ("  extern __shared__ __align__(16) unsigned char smem[];\n",
              "  unsigned char* const smem = shim_smem;\n"), *edits]
    if drop_barrier:
        # Two warps per block: within one warp, the staging's own warp
        # barriers would order the reads before the copies.
        edits.extend([(ROLLOUT_BARRIER, ""), *warp_edits(2)])
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"riccati_cpu_shim: {old[:60]!r} is not in riccati.cu once")
        text = text.replace(old, new)
    text, n = re.subn(r"kernel<<<(.*?)>>>\(", r"shim_launch(kernel, \1, ", text, flags=re.S)
    if n != 1:
        raise SystemExit("riccati_cpu_shim: the kernel launch is not in riccati.cu once")
    return text


def build(tmp, sanitize=None, drop_barrier=False, edits=(), name="riccati_shim"):
    """Compile the shimmed source with g++ into ``tmp``; return the bound
    library."""
    from kissmpc_tpu_torch.ops import riccati

    src = Path(tmp) / f"{name}.cpp"
    src.write_text(shim_source(riccati.SOURCE.read_text(), drop_barrier, edits))
    out = Path(tmp) / f"lib{name}.so"
    flags = ["-std=c++20", "-pthread", "-shared", "-fPIC", "-w"]
    if sanitize:  # a sanitizer follows OS threads, not fibers
        flags += ["-O1", "-g", f"-fsanitize={sanitize}", "-DSHIM_THREADS"]
    else:  # the cases run in seconds on fibers: a faster build
        flags.append("-O0")
    subprocess.run(["g++", *flags, str(src), "-o", str(out)], check=True)
    return riccati.bind(ctypes.CDLL(str(out)))


def scenarios_per_block(lib, N):
    out = (ctypes.c_int * 6)()
    if lib.kissmpc_riccati_occupancy(1, N, 4, out) != 0:
        raise SystemExit("riccati_cpu_shim: the occupancy query failed")
    return out[1]


def run(lib, data, reg):
    """The shim build's LQRSolution of ``data`` (CPU tensors)."""
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRSolution

    Bsz, N = data.A.shape[0], data.A.shape[1]
    dtype = data.A.dtype
    dx = torch.empty((Bsz, N + 1, 3), dtype=dtype)
    du = torch.empty((Bsz, N, 2), dtype=dtype)
    gains = torch.empty((Bsz, N, 8), dtype=dtype)
    fn = lib.kissmpc_riccati_f32 if dtype == torch.float32 else lib.kissmpc_riccati_f64
    err = fn(*(x.data_ptr() for x in data), dx.data_ptr(), du.data_ptr(), gains.data_ptr(),
             Bsz, N, float(reg), None)
    if err != 0:
        raise SystemExit(f"riccati_cpu_shim: the launcher returned {err}")
    return LQRSolution(dx=dx, du=du, K=gains[..., :6].unflatten(-1, (2, 3)), k=gains[..., 6:])


def random_data(B, N, seed, dtype):
    """Well-posed LQR data made with numpy (near-identity dynamics, SPD
    costs), as the card tests make it."""
    import numpy as np
    import torch

    from kissmpc_tpu_torch.ops.lqr import LQRData

    rng = np.random.default_rng(seed)

    def spd(n, count):
        m = rng.normal(size=(B, count, n, n))
        return m @ np.swapaxes(m, -1, -2) * 0.3 + np.eye(n) * 0.5

    arrays = dict(
        A=rng.normal(size=(B, N, 3, 3)) * 0.1 + np.eye(3),
        B=rng.normal(size=(B, N, 3, 2)) * 0.5,
        d=rng.normal(size=(B, N, 3)) * 0.1,
        d0=rng.normal(size=(B, 3)) * 0.1,
        Qxx=spd(3, N + 1),
        qx=rng.normal(size=(B, N + 1, 3)),
        Quu=spd(2, N),
        qu=rng.normal(size=(B, N, 2)),
    )
    return LQRData(**{k: torch.tensor(v, dtype=dtype) for k, v in arrays.items()})


def shifted(data):
    """The same data in tensors that start one element past an allocation's
    start, so no tensor begins on 16 bytes (the staging's head peel)."""
    import torch

    def one(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        return view

    return type(data)(*(one(x) for x in data))


def compare(got, data, reg):
    """chip_smoke.py's phase-2 gate of the shim build's solution ``got``:
    {"ok", "err", "outputs"} (see `chip_smoke.riccati_gate`)."""
    import chip_smoke

    return chip_smoke.riccati_gate(got, data, reg)


def describe(gate):
    """The gate's worst output, for a line of the log."""
    name, o = max(gate["outputs"].items(), key=lambda kv: kv[1]["ratio"])
    return (f"max|shim-plain| over dx, du, K, k {gate['err']:.3e}; nearest its limit: {name} of "
            f"scenario {o['scenario']}, {o['err_at']:.3e} against {o['tol_at']:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=("address", "thread"))
    ap.add_argument("--drop-barrier", action="store_true")
    args = ap.parse_args()
    if args.sanitize and "KISSMPC_SHIM_PRELOADED" not in os.environ:
        runtime = subprocess.run(["g++", f"-print-file-name=lib{args.sanitize[0]}san.so"],
                                 capture_output=True, text=True, check=True).stdout.strip()
        env = dict(os.environ, KISSMPC_SHIM_PRELOADED="1", LD_PRELOAD=runtime,
                   ASAN_OPTIONS="detect_leaks=0:halt_on_error=1",
                   TSAN_OPTIONS="halt_on_error=1:report_signal_unsafe=0")
        os.execve(sys.executable, [sys.executable, *sys.argv], env)

    import torch

    torch.set_num_threads(1)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp, args.sanitize, args.drop_barrier)
        S = scenarios_per_block(lib, 12)
        for dtype in (torch.float32, torch.float64):
            # N=100: three chunks or more at B <= 1024, so both sweeps reuse
            # a buffer; B=1025: the kernel's large-batch instance; N=200:
            # in f64 the ring of 32 steps does not fit beside the gains, so
            # a small batch takes chunks of 16; one step above the longest
            # horizon whose gains stay on chip: the global-gains instance.
            above = lib.kissmpc_riccati_max_horizon(4 if dtype == torch.float32 else 8) + 1
            cases = [(12, S + 1, False), (12, 2 * S + 3, True), (50, S - 1, False), (1, S, True),
                     (100, 2 * S + 1, False), (12, 1025, False), (200, S + 1, False),
                     (above, S + 1, True)]
            for N, B, shift in cases:
                data = random_data(B, N, seed=N + B, dtype=dtype)
                if shift:
                    data = shifted(data)
                gate = compare(run(lib, data, 1e-8), data, 1e-8)
                ok = gate["ok"]
                print(f"{str(dtype)[6:]} N={N} B={B}{' (shifted)' if shift else ''}: "
                      f"{describe(gate)} {'passes' if ok else 'FAILS'}", flush=True)
                if not ok:
                    failed.append((str(dtype), N, B))
    if failed:
        raise SystemExit(f"riccati_cpu_shim: the shim build disagrees with the plain version: "
                         f"{failed}")
    print(f"riccati_cpu_shim: done ({args.sanitize or 'no'} sanitizer"
          f"{', the rollout barrier dropped' if args.drop_barrier else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
