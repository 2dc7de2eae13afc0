#!/usr/bin/env python3
"""The fused kernel's source run on the CPU, one thread per lane, against
its plain version; optionally under AddressSanitizer or ThreadSanitizer.

    python3 scripts/fused_cpu_shim.py [--sanitize address|thread] [--drop-barrier]

No GPU and no nvcc are needed, only g++ (C++20).  The script compiles
`kissmpc_tpu_torch/csrc/ipm_fused.cu` into a temporary directory with a
small header in place of `cuda_runtime.h`: every thread of a block is a
`std::thread`; `__syncwarp()` waits on the warp's `std::barrier` and
`__syncthreads()` on the block's; a shuffle writes the lane's value to the
warp's shared slots, waits, reads its partner's slot and waits again; the
block's dynamic shared memory is a `std::vector<float>` of exactly the
launch's byte count, filled with NaN so that a read before a write shows;
the launch runs the blocks one after another, with `blockDim` set.  The
card's opt-in shared memory per block is sm_90's 227 KB, so a long horizon
takes 2 or 1 warps per block as on the card.  The launcher's width rule
runs as on the card against a stand-in SM: it holds 4 warps (one block of
4 warps), and the SM count is set at run time (`shim_set_sm_count`, 1
unless set), so a batch of B takes 4 warps per scenario where B <= the SM
count, else 1.  The build's launcher is called
through ctypes on CPU tensors packed as `solve_batch_fused` packs them, and
its solution is held against `solve_batch_fused_plain`: at one iteration
within 1e-4 of the solution's scale plus twice the plain version's own
f32-vs-f64 gap (chip_smoke.py phase 4's gate); over 32 iterations the
converged flags and the controls.  Two long-horizon cases (B=3, 2 and 1
warps per block) and the wide cases (B=3 at width 4) are held to the
same gate at a few iterations.

With ``--sanitize address`` the build and the run use AddressSanitizer: an
access past a scenario's shared-memory block, or past an input or output
row, is reported.  With ``--sanitize thread`` they use ThreadSanitizer: a
thread reading a row another thread wrote without a barrier between is
reported as a data race; the run goes on through every case, so a race in
the one-warp instance and one in the wide instance are each reported.
``--drop-barrier`` removes the barrier after the condensation (`sync()`:
`__syncwarp()` at width 1, `__syncthreads()` in the wide instance; a
planted race, which ThreadSanitizer must report in both).  The script
re-executes itself with the sanitizer's runtime preloaded and exits
non-zero on a mismatch or a sanitizer report.
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

SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstddef>
#include <limits>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct ShimDim { unsigned x; };
thread_local ShimDim threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
constexpr int cudaDevAttrMaxSharedMemoryPerBlockOptin = 0;
constexpr int cudaDevAttrMultiProcessorCount = 1;
inline int shim_sm_count = 1;
extern "C" void shim_set_sm_count(int n) { shim_sm_count = n; }
inline int cudaGetDevice(int* device) {
  *device = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* value, int attr, int) {
  // sm_90's opt-in shared memory; the stand-in SM count
  *value = attr == cudaDevAttrMultiProcessorCount ? shim_sm_count : 227 * 1024;
  return 0;
}
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t) {
  *n = 128 / threads;  // the stand-in SM holds 4 warps
  return 0;
}
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "shim"; }
struct ShimWarp {
  std::barrier<> bar{32};
  float slot[32];
};
thread_local ShimWarp* shim_warp;
thread_local std::barrier<>* shim_block;
thread_local float* shim_smem;
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { shim_block->arrive_and_wait(); }
inline float shim_exchange(float v, int src) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  shim_warp->slot[lane] = v;
  shim_warp->bar.arrive_and_wait();
  const float r = shim_warp->slot[src];
  shim_warp->bar.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  return shim_exchange(v, (static_cast<int>(threadIdx.x) % 32) ^ o);
}
inline float __shfl_sync(unsigned, float v, int src) { return shim_exchange(v, src); }
template <class Kern, class... A>
void shim_launch(Kern kernel, int blocks, int threads, size_t bytes, cudaStream_t, A... args) {
  for (int blk = 0; blk < blocks; ++blk) {
    std::vector<float> sm(bytes / sizeof(float), std::numeric_limits<float>::quiet_NaN());
    std::vector<std::unique_ptr<ShimWarp>> warps;
    for (int w = 0; w < threads / 32; ++w) warps.push_back(std::make_unique<ShimWarp>());
    std::barrier<> block(threads);
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = static_cast<unsigned>(t);
        blockIdx.x = static_cast<unsigned>(blk);
        blockDim.x = static_cast<unsigned>(threads);
        shim_warp = warps[t / 32].get();
        shim_block = &block;
        shim_smem = sm.data();
        kernel(args...);
      });
    for (auto& l : lanes) l.join();
  }
}
"""
SYNC_AFTER_CONDENSATION = "      SSQ[3 * T1 + t] = S.Qxy;\n    }\n    sync();\n"


def shim_source(text, drop_barrier=False):
    """The kernel's source with the shim in place of the CUDA runtime."""
    edits = [("#include <cuda_runtime.h>\n", SHIM),
             ("  extern __shared__ float smem[];\n", "  float* const smem = shim_smem;\n")]
    if drop_barrier:
        edits.append((SYNC_AFTER_CONDENSATION, SYNC_AFTER_CONDENSATION.replace(
            "    sync();\n", "")))
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"fused_cpu_shim: {old[:60]!r} is not in ipm_fused.cu once")
        text = text.replace(old, new)
    text, n = re.subn(r"kernel<<<(.*?)>>>\(", r"shim_launch(kernel, \1, ", text)
    if n != 1:
        raise SystemExit("fused_cpu_shim: the kernel launch is not in ipm_fused.cu once")
    return text


def build(tmp, sanitize, drop_barrier):
    from kissmpc_tpu_torch.ops import ipm_fused

    src = Path(tmp) / "ipm_fused_shim.cpp"
    src.write_text(shim_source(ipm_fused.SOURCE.read_text(), drop_barrier))
    out = Path(tmp) / "libipm_fused_shim.so"
    flags = ["-std=c++20", "-O1", "-g", "-pthread", "-shared", "-fPIC", "-w"]
    if sanitize:
        flags.append(f"-fsanitize={sanitize}")
    subprocess.run(["g++", *flags, str(src), "-o", str(out)], check=True)
    lib = ipm_fused.bind(ctypes.CDLL(str(out)))
    lib.shim_set_sm_count.argtypes = [ctypes.c_int]
    lib.shim_set_sm_count.restype = None
    return lib


def run(lib, cfg, problems, iterations):
    """The shim build's solution of ``problems`` (CPU tensors) and the
    launch's width."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_fused

    N, B = cfg.horizon, problems.initial_state.shape[0]
    inp = ipm_fused.pack_inputs(cfg, problems, None, torch.float32)
    rows = [t.contiguous() for t in (inp.scal, inp.warm, inp.tx, inp.ty, inp.obinfo)]
    trips = torch.tensor([iterations], dtype=torch.int32)
    outs = [torch.empty((B, n), dtype=torch.float32) for n in (N + 1, N + 1, N + 1, N, N, 6)]
    params = ipm_fused._params(cfg, B)
    width = ctypes.c_int(0)
    err = lib.kissmpc_ipm_fused_f32(trips.data_ptr(), *(t.data_ptr() for t in rows),
                                    *(t.data_ptr() for t in outs), ctypes.byref(width),
                                    ctypes.byref(params), None)
    if err != 0:
        raise SystemExit(f"fused_cpu_shim: the launcher returned {err}")
    return ipm_fused._solution(inp, *outs), width.value


def gap(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in ((a.states, b.states), (a.controls, b.controls)))


# (N, K, elastic, affine tracks, batch, iterations of the gate, warps per
# block, stand-in SMs, width): ragged against the block's warps at width 1;
# one horizon that takes 2 warps per block and one that takes 1; then the
# wide instance, B=3 on 3 SMs (width 4).
CASES = ((12, 0, False, False, 7, 1, 4, 1, 1), (12, 2, False, True, 9, 1, 4, 1, 1),
         (12, 2, True, True, 9, 1, 4, 1, 1), (12, 8, True, False, 5, 1, 4, 1, 1),
         (50, 8, False, True, 3, 1, 4, 1, 1), (300, 0, False, False, 3, 3, 2, 1, 1),
         (500, 2, True, True, 3, 3, 1, 1, 1),
         (12, 2, False, True, 3, 3, 4, 3, 4), (12, 8, True, False, 3, 3, 4, 3, 4),
         (50, 8, False, True, 3, 1, 4, 3, 4), (50, 8, True, True, 3, 1, 4, 3, 4))


def config(n, K, elastic, affine):
    from kissmpc_tpu_torch import MPCConfig

    cfg = MPCConfig(horizon=n, time_step=0.1 if n < 20 else 0.041, max_obstacles=K)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, mu_sigma_max=0.7 if K else 0.0, fused_affine_tracks=affine,
        elastic_obstacles=elastic))


def problems(cfg, batch):
    """The cases' scenarios: obstacle worlds (one moving obstacle), or free."""
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems

    return (obstacle_problems(cfg, batch, seed=5, n_dynamic=1, device="cpu")
            if cfg.max_obstacles else free_problems(cfg, batch, seed=5, device="cpu"))


def check(lib, n, K, elastic, affine, batch, iterations, warps, sms, width, report_full=True):
    """One case on ``sms`` stand-in SMs: the shim build against the plain
    version after ``iterations`` within 1e-4 of the solution's scale plus
    twice the plain version's own f32-vs-f64 gap, with the launch's width
    and warps per block as expected; at one iteration, with
    ``report_full``, also the flags and controls after 32 (printed, not
    gated).  Returns (ok, a line for the log)."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import launch_shape, solve_batch_fused_plain
    from kissmpc_tpu_torch.solver.problem import Problem

    cfg = config(n, K, elastic, affine)
    pr = problems(cfg, batch)
    lib.shim_set_sm_count(sms)
    shape = launch_shape(lib, cfg, batch)
    got1, got_width = run(lib, cfg, pr, iterations)
    ref1 = solve_batch_fused_plain(cfg, pr, iterations=iterations)
    ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in pr)), iterations=iterations)
    scale = max(1.0, float(ref1.states.abs().max()), float(ref1.controls.abs().max()))
    err1, tol1 = gap(got1, ref1), 1e-4 * scale + 2.0 * gap(ref1, ref64)
    ok = (err1 <= tol1 and bool(torch.isfinite(got1.states).all())
          and (shape["width"], shape["warps_per_block"], got_width) == (width, warps, width))
    line = (f"N={n} K={K} elastic={elastic} affine={affine} B={batch} on {sms} SM(s), width "
            f"{got_width}, {shape['warps_per_block']} warps per block (expected {width}, {warps}):"
            f" {iterations} iteration(s) max|shim-plain| {err1:.3e} (tol {tol1:.3e}) "
            f"{'passes' if ok else 'FAILS'}")
    if report_full and iterations == 1:
        got, ref = run(lib, cfg, pr, 32)[0], solve_batch_fused_plain(cfg, pr, iterations=32)
        flips = int((got.diagnostics.converged != ref.diagnostics.converged).sum())
        line += (f"; 32 iterations: flags differ on {flips} of {batch}, max|du| "
                 f"{float((got.controls - ref.controls).abs().max()):.3e}")
    lib.shim_set_sm_count(1)
    return ok, line


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
                   TSAN_OPTIONS="report_signal_unsafe=0")
        os.execve(sys.executable, [sys.executable, *sys.argv], env)

    import torch

    torch.set_num_threads(1)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp, args.sanitize, args.drop_barrier)
        for case in CASES:
            ok, line = check(lib, *case)
            print(line, flush=True)
            if not ok:
                failed.append(case)
    if failed:
        raise SystemExit(
            f"fused_cpu_shim: the shim build disagrees with the plain version: {failed}")
    print(f"fused_cpu_shim: done ({args.sanitize or 'no'} sanitizer"
          f"{', the barrier after the condensation dropped' if args.drop_barrier else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
