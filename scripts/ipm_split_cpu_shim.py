#!/usr/bin/env python3
"""The split solve's kernels and the problem build run on the CPU, one
context per CUDA thread, against their plain versions; optionally under
AddressSanitizer or ThreadSanitizer.

    python3 scripts/ipm_split_cpu_shim.py [--sanitize address|thread]

No GPU and no nvcc are needed, only g++ (C++20).  The script compiles
`kissmpc_tpu_torch/csrc/ipm_split.cu` and `csrc/problem_build.cu` into a
temporary directory with a
small header in place of `cuda_runtime.h`: every CUDA thread of a block
is a fiber (`scripts/shim_runtime.py`; a `std::thread` under a sanitizer);
the lanes of a warp exchange shuffled values through the warp's slots
between two waits on its barrier (`__syncwarp` waits on it once); a launch
runs the blocks one after another, with `blockIdx`, `threadIdx` and
`blockDim` set; `__syncthreads()` waits on the block's barrier, and the
block's dynamic shared memory is exactly the launch's bytes, filled with
NaN.
Each case drives the wrapper's own card path (`ops/ipm_split.py::_condense`
and `_step`) on CPU tensors with the g++ build as the launcher, on a real
iterate (a few plain iterations from the warm start), and holds the
condensation and the step to chip_smoke.py's gates against
`ipm.condense_plain` and `ipm.step_plain` (each field of each scenario
within 1e-4 of its scale plus twice the plain version's own f32-vs-f64 gap
in float32, 1e-9 of its scale in float64; the step's accepted candidate
differs on at most max(1, twice the plain version's own f32-vs-f64 flips)).
Mehrotra cases ("pc", "soc") give both kernels the correction rows of the
plain predictor; two cases at N=40 give every thread several elements.
Each case runs in the wrapper's layout for its batch (a block of several
warps per scenario); cases at N=7 and N=40 also force one warp per
scenario and a block of 2 warps, and one at N=400 takes the step's arena
in global scratch.
The init and diagnostics kernels are held against `ipm.init_plain` and
`ipm.diagnostics_plain` by chip_smoke.py's `once_kernels_check` (cases as
CASES, one at N=40 whose stages fill a chunk of 64), the diagnostics also
in their layouts: a block per scenario at a refine stage's batch, the
node, and horizons and obstacle counts whose stages take several chunks
(K=100: chunks of 4 stages; N=200 and N=400 at K=8: chunks of 64, the
scans' carry across 4 and 7 of them), each launched twice for the same
bits; and the
build kernel against `ops/problem_build.py::build_plain` by its
`build_kernel_check` (repair and completion on and off, K=0, K_all > K, a
shared stride-0 set, the start tiled; one case at N=50, K=8).  Last, a
whole split solve through the shim kernels (init, iterations,
diagnostics) is held against `ipm.solve_plain` at a few iterations
(float64).

With ``--sanitize address`` the build and the run use AddressSanitizer: a
read or write past an input or output row is reported.  With ``--sanitize
thread`` they use ThreadSanitizer (the threads of a block share their
shuffle slots and the block's shared memory, between barriers).  The script re-executes itself with the sanitizer's runtime
preloaded and exits non-zero on a mismatch or a sanitizer report.
"""

import argparse
import ctypes
import dataclasses
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from shim_runtime import RUNTIME  # noqa: E402

SHIM = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
using std::atan2;
using std::fabs;
using std::fma;
using std::max;
using std::min;
using std::pow;
using std::rint;
using std::sqrt;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
struct ShimDim { unsigned x; };
struct ShimWarp;
// What a CUDA thread keeps to itself (the fibers' runtime swaps it).
struct ShimTls {
  ShimDim tid, bid, bdim;
  ShimWarp* warp;
  void* block;  // the block's ShimBarrier
  unsigned char* smem;
};
thread_local ShimTls shim_tls;
#define threadIdx (shim_tls.tid)
#define blockIdx (shim_tls.bid)
#define blockDim (shim_tls.bdim)
#define shim_warp (shim_tls.warp)
#define shim_smem (shim_tls.smem)
""" + RUNTIME + r"""
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> int cudaFuncSetAttribute(F, int, int bytes) {  // sm_90's opt-in
  return bytes <= 232448 ? 0 : cudaErrorInvalidValue;
}
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return 0;
}
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "shim"; }
struct ShimWarp {
  ShimBarrier bar{32};
  unsigned long long slot[32];
};
inline void __syncthreads() { static_cast<ShimBarrier*>(shim_tls.block)->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp->bar.arrive_and_wait(); }
template <class V> V shim_exchange(V v, int src) {
  static_assert(sizeof(V) <= sizeof(unsigned long long));
  const int lane = static_cast<int>(threadIdx.x) % 32;
  std::memcpy(&shim_warp->slot[lane], &v, sizeof(V));
  shim_warp->bar.arrive_and_wait();
  V r;
  std::memcpy(&r, &shim_warp->slot[src], sizeof(V));
  shim_warp->bar.arrive_and_wait();
  return r;
}
template <class V> V __shfl_xor_sync(unsigned, V v, int o) {
  return shim_exchange(v, (static_cast<int>(threadIdx.x) % 32) ^ o);
}
template <class V> V __shfl_sync(unsigned, V v, int src) { return shim_exchange(v, src); }
// A launch runs its blocks one after another; each block's dynamic shared
// memory is exactly the launch's bytes, filled with NaN (as doubles) so
// that a read before a write shows.
template <class Kern, class... A>
void shim_launch(Kern kernel, int blocks, int threads, size_t bytes, cudaStream_t, A... args) {
  std::vector<double> sm((bytes + 7) / 8);
  for (int blk = 0; blk < blocks; ++blk) {
    std::fill(sm.begin(), sm.end(), std::numeric_limits<double>::quiet_NaN());
    ShimBarrier block(threads);
    std::vector<std::unique_ptr<ShimWarp>> warps;
    for (int w = 0; w < (threads + 31) / 32; ++w) warps.push_back(std::make_unique<ShimWarp>());
    shim_run_block(threads, [&](int t) {
      shim_tls.tid.x = static_cast<unsigned>(t);
      shim_tls.bid.x = static_cast<unsigned>(blk);
      shim_tls.bdim.x = static_cast<unsigned>(threads);
      shim_tls.warp = warps[t / 32].get();
      shim_tls.block = &block;
      shim_tls.smem = reinterpret_cast<unsigned char*>(sm.data());
      kernel(args...);
    });
  }
}
"""
SMEM = "  extern __shared__ __align__(16) unsigned char smem[];\n"


# Per source: (kernels with dynamic shared memory, kernel launches).
SOURCES = {"ipm_split.cu": (4, 4), "problem_build.cu": (1, 1)}


def shim_source(text, name="ipm_split.cu"):
    """The kernels' source with the shim in place of the CUDA runtime."""
    smem, launches = SOURCES[name]
    if text.count("#include <cuda_runtime.h>\n") != 1:
        raise SystemExit(f"ipm_split_cpu_shim: cuda_runtime.h is not included once in {name}")
    text = text.replace("#include <cuda_runtime.h>\n", SHIM)
    if text.count(SMEM) != smem:
        raise SystemExit(f"ipm_split_cpu_shim: {name} does not declare {smem} kernels' shared "
                         f"memory once each")
    text = text.replace(SMEM, "  unsigned char* const smem = shim_smem;\n")
    text, n = re.subn(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"shim_launch(\1, \2, ", text)
    if n != launches:
        raise SystemExit(f"ipm_split_cpu_shim: {n} kernel launches in {name}, expected {launches}")
    return text


def _compile(tmp, source, sanitize):
    src = Path(tmp) / f"{source.stem}_shim.cpp"
    src.write_text(shim_source(source.read_text(), source.name))
    out = Path(tmp) / f"lib{source.stem}_shim.so"
    flags = ["-std=c++20", "-pthread", "-shared", "-fPIC", "-w", "-fno-strict-aliasing",
             f"-I{source.parent}"]  # csrc's shared headers
    if sanitize:  # a sanitizer follows OS threads, not fibers
        flags += ["-O1", "-g", f"-fsanitize={sanitize}", "-DSHIM_THREADS"]
    else:  # the cases run in seconds on fibers: a build in a third of the time
        flags.append("-O0")
    subprocess.run(["g++", *flags, str(src), "-o", str(out)], check=True)
    return ctypes.CDLL(str(out))


def build(tmp, sanitize=None):
    """The g++ build of `csrc/ipm_split.cu` (its launchers bound)."""
    from kissmpc_tpu_torch.ops import ipm_split

    return ipm_split.bind(_compile(tmp, ipm_split.SOURCE, sanitize))


def build_problem(tmp, sanitize=None):
    """The g++ build of `csrc/problem_build.cu` (its launchers bound)."""
    from kissmpc_tpu_torch.ops import problem_build

    return problem_build.bind(_compile(tmp, problem_build.SOURCE, sanitize))


# (name, N, K, batch, iterations before the checked one, solver fields,
# cost fields): hard and elastic, K=0 and K=4, with and without the
# curvature term, both cost modes, Mehrotra "pc" and "soc", a longer
# line search, adaptive sigma; each case runs in float32 and float64.
CASES = (
    ("free", 12, 0, 5, 4, {}, {}),
    ("k4", 12, 4, 9, 4, {"mu_sigma_max": 0.7}, {}),
    ("k4_nocurv_ls4", 10, 4, 6, 3, {"obstacle_curvature": False, "ls_iters": 4},
     {"goal_cost_mode": "exclude_terminal", "reverse_penalty_mode": "linear"}),
    ("k4_elastic", 12, 4, 9, 4, {"elastic_obstacles": True, "mu_sigma_max": 0.7}, {}),
    ("k4_pc", 12, 4, 6, 3, {"mehrotra": "pc"}, {}),
    ("k4_soc", 12, 4, 6, 3, {"mehrotra": "soc"}, {}),
)
# Run by the script alone (the tests keep N <= 15): a horizon whose
# elements outnumber every layout's threads, so each thread takes several.
LONG_CASES = (("k3_elastic_n40", 40, 3, 3, 3, {"elastic_obstacles": True}, {}),
              ("k3_n40", 40, 3, 3, 3, {"mu_sigma_max": 0.7}, {}))
# The cases above run in the wrapper's layout for their batch (a block of
# 4 warps per scenario); these force the others on the node's horizon:
# one warp per scenario (as at the benchmark's batches) and 2 warps, hard
# and elastic, K=0 and K=4.
LAYOUT_CASES = (("free_n7", 7, 0, 3, 3, {}, {}),
                ("k4_n7", 7, 4, 3, 3, {"mu_sigma_max": 0.7}, {}),
                ("k4_elastic_n7", 7, 4, 3, 3, {"elastic_obstacles": True}, {}))
LAYOUTS = (1, 2)
# A horizon whose arena does not fit in the card's shared memory: the step
# keeps it in global scratch (the GLOBAL instance).
GLOBAL_CASES = (("k8_n400_global", 400, 8, 2, 2, {"mu_sigma_max": 0.7}, {}),)


def config(n, K, solver, cost):
    from kissmpc_tpu_torch import MPCConfig

    cfg = MPCConfig(horizon=n, time_step=0.1, max_obstacles=K)
    return cfg.replace(solver=dataclasses.replace(cfg.solver, solve_backend="split", **solver),
                       cost=dataclasses.replace(cfg.cost, **cost))


def problems(cfg, batch, dtype, seed=5):
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems

    if cfg.max_obstacles:
        return obstacle_problems(cfg, batch, seed=seed, n_dynamic=1, dtype=dtype, device="cpu")
    return free_problems(cfg, batch, seed=seed, dtype=dtype, device="cpu")


def run_cases(lib, cases=CASES, dtypes=None, warps=None):
    """Each case in each dtype, the step with ``warps`` per scenario (the
    wrapper's choice if None): (ok, a line for the log) per case."""
    import torch

    import chip_smoke

    out = []
    for name, n, K, batch, iters, solver, cost in cases:
        cfg = config(n, K, solver, cost)
        for dtype in dtypes or (torch.float32, torch.float64):
            pr = problems(cfg, batch, dtype)
            res = chip_smoke.split_kernels_check(cfg, pr, iters, lib, 0, warps=warps)
            label = (f"{name} N={n} K={K} B={batch} {str(dtype)[6:]}"
                     + (f" warps={warps}" if warps else ""))
            out.append((res["ok"], f"{label}: {chip_smoke.describe_split_check(res)}"))
    return out


# The init and diagnostics kernels, as CASES (the diagnostics on the iterate
# after the given plain iterations): hard and elastic, K=0 and K=4,
# Mehrotra "pc" (whose first mu is the raw mean complementarity), both cost
# modes; each in float32 and float64.
ONCE_CASES = (
    ("free", 12, 0, 5, 4, {}, {}),
    ("k4", 12, 4, 9, 4, {"mu_sigma_max": 0.7}, {}),
    ("k4_elastic", 12, 4, 9, 4, {"elastic_obstacles": True}, {}),
    ("k4_pc", 12, 4, 6, 3, {"mehrotra": "pc"}, {}),
    ("k4_exclude_linear", 10, 4, 6, 3, {},
     {"goal_cost_mode": "exclude_terminal", "reverse_penalty_mode": "linear"}),
)
# Run by the script alone: 41 stages in one chunk of the diagnostics (64
# stages at K=3), whose stage threads span two warps.
ONCE_LONG_CASES = (("k3_n40", 40, 3, 3, 3, {"mu_sigma_max": 0.7}, {}),)
# The diagnostics kernel's layouts: (name, N, K, batch, iterations before
# the checked one, solver fields).  A block per scenario at a refine
# stage's batch (K=8, N=50: one chunk of 64 stages); the node (N=7, B=1:
# one chunk of 8); K=100 (chunks of 4 stages, 400 obstacle constraints
# each); N=200 and N=400 at K=8 (chunks of 64: the scans' carry across 4
# and 7 chunks, each thread several entries of a family).  Each is held by
# `once_kernels_check`, and a second launch must give the same bits.
DIAG_LAYOUT_CASES = (
    ("k8_b164", 50, 8, 164, 2, {"mu_sigma_max": 0.7}),
    ("node_n7", 7, 4, 1, 3, {}),
    ("k100", 12, 100, 3, 2, {}),
    ("k8_n200", 200, 8, 2, 2, {"mu_sigma_max": 0.7}),
    ("k8_n400", 400, 8, 2, 2, {"mu_sigma_max": 0.7}),
)

# The init kernel's layouts: (name, N, K, batch, solver fields).  At a
# refine stage's batch, hard, elastic and "pc"; and where each thread of
# the block takes several entries of a family (K=100: 1,200 obstacle
# constraints; N=200: 603 state entries, 1,600 obstacle constraints).
# Each is held to `ipm.init_plain` by the gate.
INIT_LAYOUT_CASES = (
    ("k4_b164", 12, 4, 164, {"mu_sigma_max": 0.7}),
    ("k4_elastic_b164", 12, 4, 164, {"elastic_obstacles": True}),
    ("k4_pc_b164", 12, 4, 164, {"mehrotra": "pc"}),
    ("k100", 12, 100, 3, {"elastic_obstacles": True}),
    ("k8_n200", 200, 8, 2, {"mu_sigma_max": 0.7}),
)

# The build kernel: (name, N, K, batch, obstacles per scenario K_all, one set
# shared by all, a warm start along the segment, keywords): repair and
# completion on and off, K_all > K and K_all > 32 (lanes take several
# keys), a shared stride-0 set, the start tiled with the default prediction
# dt, a zero completion threshold, K=0, horizons past a warp's lanes (N=33,
# 64), and ties ("tie", not a keyword of the build: `chip_smoke.build_inputs`'
# tied sensor keys, or tied speed caps in the rollout), and rows past the
# card's 227 KB of shared memory in both dtypes (K=16 from N=668 in
# float64, 1,336 in float32; K=8 from 1,070 and 2,140), which the build
# keeps in global scratch (the GLOBAL instance): a case named "_global"
# must take the scratch, the others must not (its 1,500-step rollout is
# off here; `check_global_rows` holds the rollout through the scratch to
# the shared-memory instance).  The plan's step is BUILD_DT, so that the
# warm path crosses the circles and most scenarios are rolled out.
BUILD_DT = 0.5
BUILD_CASES = (
    ("k4", 12, 4, 8, 4, False, True, {}),
    ("k4_kall7", 12, 4, 8, 7, False, True, {}),
    ("k4_shared", 12, 4, 8, 6, True, True, {}),
    ("k4_no_repair", 12, 4, 8, 4, False, True, {"repair_warm_start_states": False}),
    ("k4_no_completion", 12, 4, 8, 4, False, True, {"complete_warm_start_states": False}),
    ("k4_neither", 12, 4, 8, 4, False, True,
     {"repair_warm_start_states": False, "complete_warm_start_states": False}),
    ("k4_cold", 12, 4, 8, 5, False, False, {"prediction_dt": None}),
    ("k4_threshold0", 10, 4, 6, 4, False, True, {"completion_threshold": 0.0}),
    ("k0", 12, 0, 8, 3, False, True, {}),
    ("k4_kall40", 12, 4, 4, 40, False, True, {}),
    ("k4_n33", 33, 4, 4, 6, False, True, {}),
    ("k4_n64", 64, 4, 8, 6, False, True, {}),
    ("k4_tied_keys", 12, 4, 8, 6, False, True, {"tie": "keys"}),
    ("k4_tied_caps", 12, 4, 8, 6, False, True, {"tie": "caps"}),
    ("k16_n1500_global", 1500, 16, 2, 16, False, True, {"complete_warm_start_states": False}),
)
# Run by the script alone: the pool's shape.
BUILD_LONG_CASES = (("k8_n50", 50, 8, 6, 10, False, True, {}),)


def run_once_cases(lib, cases=ONCE_CASES, dtypes=None):
    """The init and diagnostics kernels on each case in each dtype: (ok, a
    line for the log) per case."""
    import torch

    import chip_smoke

    out = []
    for name, n, K, batch, iters, solver, cost in cases:
        cfg = config(n, K, solver, cost)
        for dtype in dtypes or (torch.float32, torch.float64):
            res = chip_smoke.once_kernels_check(cfg, problems(cfg, batch, dtype), iters, lib, 0)
            label = f"{name} N={n} K={K} B={batch} {str(dtype)[6:]}"
            out.append((res["ok"], f"{label}: {chip_smoke.describe_once_check(res)}"))
    return out


def run_init_layouts(lib, cases=INIT_LAYOUT_CASES, dtypes=None):
    """The init kernel of each case in each dtype: (ok, a line for the log)
    per case."""
    import torch

    import chip_smoke

    out = []
    for name, n, K, batch, solver in cases:
        cfg = config(n, K, solver, {})
        for dtype in dtypes or (torch.float32, torch.float64):
            g = chip_smoke.init_gate(cfg, problems(cfg, batch, dtype), lib, 0)
            out.append((g["ok"], f"init {name} N={n} K={K} B={batch} {str(dtype)[6:]}: "
                                 f"max|kernel-plain| {g['err']:.3e}, nearest its limit "
                                 f"{g['worst']} at {g['fields'][g['worst']]['ratio']:.3f} of it; "
                                 f"{'passes' if g['ok'] else 'FAILS'}"))
    return out


def run_diag_layouts(lib, cases=DIAG_LAYOUT_CASES, dtypes=None):
    """The init and diagnostics kernels of each case in each dtype by
    `once_kernels_check`, the diagnostics launched a second time on the same
    inputs: (ok, a line for the log) per case."""
    import torch

    import chip_smoke
    from kissmpc_tpu_torch.ops import ipm_split

    out = []
    for name, n, K, batch, iters, solver in cases:
        cfg = config(n, K, solver, {})
        for dtype in dtypes or (torch.float32, torch.float64):
            res = chip_smoke.once_kernels_check(cfg, problems(cfg, batch, dtype), iters, lib, 0)
            again = ipm_split._diagnostics(lib, 0, cfg, *res["launched"])
            same = all(torch.equal(x, y) for x, y in zip(res["got"], again))
            ok = res["ok"] and same
            out.append((ok, f"diagnostics {name} N={n} K={K} B={batch} {str(dtype)[6:]}: "
                            f"{chip_smoke.describe_once_check(res)}; a second launch "
                            f"{'gives the same bits' if same else 'DIFFERS'}"))
    return out


def run_build_cases(lib, cases=BUILD_CASES, dtypes=None, seed=7):
    """The build kernel on each case in each dtype: (ok, a line) per case."""
    import torch

    import chip_smoke
    from kissmpc_tpu_torch.ops import problem_build

    out = []
    for name, n, K, batch, k_all, shared, warm, options in cases:
        cfg = config(n, K, {}, {}).replace(time_step=BUILD_DT)
        options = dict(options)
        tie = options.pop("tie", None)
        for dtype in dtypes or (torch.float32, torch.float64):
            inputs = chip_smoke.build_inputs(cfg, batch, seed, k_all=k_all, shared=shared,
                                             warm=warm, tie=tie, dtype=dtype, device="cpu")
            res = chip_smoke.build_kernel_check(cfg, inputs, lib, 0, **options)
            params = problem_build._Params(B=batch, N=n, K=K, K_all=k_all)
            scratch = lib.kissmpc_build_scratch_bytes(ctypes.byref(params),
                                                      torch.finfo(dtype).bits // 8)
            rows = f"rows in {'global scratch' if scratch else 'shared memory'}"
            ok = res["ok"] and bool(scratch) == name.endswith("_global")
            label = f"build {name} N={n} K={K} K_all={k_all} B={batch} {str(dtype)[6:]}"
            out.append((ok, f"{label} ({rows}): {chip_smoke.describe_build_check(res)}"))
    return out


def check_global_rows(lib, tmp, cases=((1500, 16, 2), (700, 16, 3))):
    """The build's GLOBAL instance (``lib``, the g++ build of the source)
    against its shared-memory instance: a
    copy of `csrc/problem_build.cu` whose shared-memory limit is lifted
    keeps rows that pass 227 KB in shared memory; on the same inputs, with
    the repair and the rollout on, both must give the same bits in every
    field.  (ok, a line) per case and dtype."""
    import torch

    import chip_smoke
    from kissmpc_tpu_torch.ops import problem_build

    global SHIM
    old = "constexpr long long kSmemOptin = 232448;"
    text = problem_build.SOURCE.read_text()
    if text.count(old) != 1:
        raise SystemExit("ipm_split_cpu_shim: kSmemOptin is not in problem_build.cu once")
    lifted = Path(tmp) / "lifted"
    lifted.mkdir()
    for header in problem_build.SOURCE.parent.glob("*.cuh"):
        (lifted / header.name).write_text(header.read_text())
    (lifted / "problem_build.cu").write_text(text.replace(old, old.replace("232448", "1LL << 40")))
    shim, SHIM = SHIM, SHIM.replace("bytes <= 232448", "true")
    try:
        libs = (lib, problem_build.bind(_compile(lifted, lifted / "problem_build.cu", None)))
    finally:
        SHIM = shim
    out = []
    for n, K, batch in cases:
        cfg = config(n, K, {}, {}).replace(time_step=BUILD_DT)
        for dtype in (torch.float32, torch.float64):
            params = problem_build._Params(B=batch, N=n, K=K, K_all=K)
            scratch = [lib.kissmpc_build_scratch_bytes(ctypes.byref(params),
                                                       torch.finfo(dtype).bits // 8)
                       for lib in libs]
            start, goal, obstacles, kw = chip_smoke.build_inputs(cfg, batch, 7, k_all=K,
                                                                 dtype=dtype, device="cpu")
            got = [problem_build._launch(lib, 0, cfg, start, goal, obstacles, **kw)
                   for lib in libs]
            same = all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in zip(*got))
            rolled = int((got[1].warm_controls != 0).flatten(1).any(1).sum())
            ok = same and scratch[1] == 0
            out.append((ok, f"build N={n} K={K} B={batch} {str(dtype)[6:]}: rows in "
                            f"{'global scratch' if scratch[0] else 'shared memory'} against "
                            f"shared memory, {rolled} rolled out: "
                            f"{'the same bits' if same else 'DIFFERENT'}; "
                            f"{'passes' if ok else 'FAILS'}"))
    return out


def solve_through(lib, cfg, pr):
    """The split solve with the shim build's kernels in place of the card's."""
    from kissmpc_tpu_torch.ops import ipm_split
    from kissmpc_tpu_torch.ops.lqr import solve_lqr
    from kissmpc_tpu_torch.solver import ipm

    def init(cfg, problem):
        return ipm_split._init(lib, 0, cfg, problem)

    def condense(cfg, problem, it, mu, corr=None):
        return ipm_split._condense(lib, 0, cfg, problem, it, mu, corr)

    def step(cfg, problem, it, mu, data, sol, corr=None):
        return ipm_split._step(lib, 0, cfg, problem, it, mu, data, sol, corr)

    def diagnostics(cfg, problem, it):
        return ipm_split._diagnostics(lib, 0, cfg, problem, it)

    return ipm._solve(cfg, ipm._contiguous(pr), condense, solve_lqr, step, init, diagnostics)


def check_solve(lib, name="k4", iterations=6):
    """A whole float64 solve through the shim kernels (init, the iterations,
    diagnostics) against `solve_plain`: states, controls and every
    diagnostic within 1e-7 of its scale (at least 1), converged equal."""
    import torch

    from kissmpc_tpu_torch.solver import ipm

    _, n, K, batch, _, solver, cost = next(c for c in CASES if c[0] == name)
    cfg = config(n, K, {**solver, "iterations": iterations}, cost)
    pr = problems(cfg, batch, torch.float64)
    got, ref = solve_through(lib, cfg, pr), ipm.solve_plain(cfg, pr)
    pairs = [(got.states, ref.states), (got.controls, ref.controls)]
    pairs += list(zip(got.diagnostics[1:], ref.diagnostics[1:]))
    err = max(float(((g - r).abs() / r.abs().clamp(min=1.0)).max()) for g, r in pairs)
    same = bool(torch.equal(got.diagnostics.converged, ref.diagnostics.converged))
    ok = err <= 1e-7 and same
    return ok, (f"solve {name} float64, {iterations} iterations: max|shim-plain| {err:.3e} "
                f"of the scale (limit 1e-7), converged {'equal' if same else 'DIFFERS'} "
                f"{'passes' if ok else 'FAILS'}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=("address", "thread"))
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
        lib = build(tmp, args.sanitize)
        results = run_cases(lib, CASES + LONG_CASES)
        for warps in LAYOUTS:
            results += run_cases(lib, LAYOUT_CASES + LONG_CASES, warps=warps)
        results += run_cases(lib, GLOBAL_CASES)
        results += run_once_cases(lib, ONCE_CASES + ONCE_LONG_CASES)
        results += run_init_layouts(lib)
        results += run_diag_layouts(lib)
        blib = build_problem(tmp, args.sanitize)
        results += run_build_cases(blib, BUILD_CASES + BUILD_LONG_CASES)
        if not args.sanitize:  # the copy is built without one
            results += check_global_rows(blib, tmp)
        for ok, line in results + [check_solve(lib)]:
            print(line, flush=True)
            if not ok:
                failed.append(line.split(":")[0])
    if failed:
        raise SystemExit(f"ipm_split_cpu_shim: the shim build disagrees with the plain "
                         f"halves: {failed}")
    print(f"ipm_split_cpu_shim: done ({args.sanitize or 'no'} sanitizer)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
