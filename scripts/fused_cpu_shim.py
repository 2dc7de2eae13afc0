#!/usr/bin/env python3
"""The fused kernel's source run on the CPU, one thread per lane, against
its plain version; optionally under AddressSanitizer or ThreadSanitizer.

    python3 scripts/fused_cpu_shim.py [--sanitize address|thread] [--drop-syncwarp]

No GPU and no nvcc are needed, only g++ (C++20).  The script compiles
`kissmpc_tpu_torch/csrc/ipm_fused.cu` into a temporary directory with a
small header in place of `cuda_runtime.h`: every lane of a warp is a
`std::thread`; `__syncwarp()` waits on the warp's `std::barrier`; a shuffle
writes the lane's value to the warp's shared slots, waits, reads its
partner's slot and waits again; the block's dynamic shared memory is a
`std::vector<float>` of exactly the launch's byte count, filled with NaN so
that a read before a write shows; the launch runs the blocks one after
another, with `blockDim` set, and the card's opt-in shared memory per
block is sm_90's 227 KB, so a long horizon takes 2 or 1 warps per block
as on the card.  The build's launcher is called through ctypes on CPU tensors
packed as `solve_batch_fused` packs them, and its solution is held against
`solve_batch_fused_plain`: at one iteration within 1e-4 of the solution's
scale plus twice the plain version's own f32-vs-f64 gap (chip_smoke.py
phase 4's gate); over 32 iterations the converged flags and the controls.
Two long-horizon cases (B=3, 2 and 1 warps per block) are held to the
same gate at 3 iterations.

With ``--sanitize address`` the build and the run use AddressSanitizer: an
access past a scenario's shared-memory block, or past an input or output
row, is reported.  With ``--sanitize thread`` they use ThreadSanitizer: a
lane reading a row another lane wrote without a `__syncwarp()` between is
reported as a data race.  ``--drop-syncwarp`` removes the `__syncwarp()`
after the condensation (a planted race; ThreadSanitizer must report it).
The script re-executes itself with the sanitizer's runtime preloaded and
exits non-zero on a mismatch or a sanitizer report.
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
inline int cudaGetDevice(int* device) {
  *device = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* value, int, int) {  // sm_90's opt-in shared memory
  *value = 227 * 1024;
  return 0;
}
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
inline const char* cudaGetErrorString(int) { return "shim"; }
struct ShimWarp {
  std::barrier<> bar{32};
  float slot[32];
};
thread_local ShimWarp* shim_warp;
thread_local float* shim_smem;
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp->bar.arrive_and_wait(); }
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
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = static_cast<unsigned>(t);
        blockIdx.x = static_cast<unsigned>(blk);
        blockDim.x = static_cast<unsigned>(threads);
        shim_warp = warps[t / 32].get();
        shim_smem = sm.data();
        kernel(args...);
      });
    for (auto& l : lanes) l.join();
  }
}
"""
SYNC_AFTER_CONDENSATION = "      SSQ[3 * T1 + t] = S.Qxy;\n    }\n    __syncwarp();\n"


def shim_source(text, drop_syncwarp=False):
    """The kernel's source with the shim in place of the CUDA runtime."""
    edits = [("#include <cuda_runtime.h>\n", SHIM),
             ("  extern __shared__ float smem[];\n", "  float* const smem = shim_smem;\n")]
    if drop_syncwarp:
        edits.append((SYNC_AFTER_CONDENSATION, SYNC_AFTER_CONDENSATION.replace(
            "    __syncwarp();\n", "")))
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"fused_cpu_shim: {old[:60]!r} is not in ipm_fused.cu once")
        text = text.replace(old, new)
    text, n = re.subn(r"kernel<<<(.*?)>>>\(", r"shim_launch(kernel, \1, ", text)
    if n != 1:
        raise SystemExit("fused_cpu_shim: the kernel launch is not in ipm_fused.cu once")
    return text


def build(tmp, sanitize, drop_syncwarp):
    from kissmpc_tpu_torch.ops import ipm_fused

    src = Path(tmp) / "ipm_fused_shim.cpp"
    src.write_text(shim_source(ipm_fused.SOURCE.read_text(), drop_syncwarp))
    out = Path(tmp) / "libipm_fused_shim.so"
    flags = ["-std=c++20", "-O1", "-g", "-pthread", "-shared", "-fPIC", "-w"]
    if sanitize:
        flags.append(f"-fsanitize={sanitize}")
    subprocess.run(["g++", *flags, str(src), "-o", str(out)], check=True)
    return ipm_fused.bind(ctypes.CDLL(str(out)))


def warps_per_block(lib, cfg):
    """The warps per block the shim build's launcher takes for ``cfg``."""
    from kissmpc_tpu_torch.ops import ipm_fused

    out = (ctypes.c_int * 5)()
    err = lib.kissmpc_ipm_fused_occupancy(cfg.horizon, cfg.max_obstacles,
                                          int(ipm_fused._elastic(cfg)),
                                          int(ipm_fused._affine(cfg)), out)
    if err != 0:
        raise SystemExit(f"fused_cpu_shim: the occupancy query returned {err}")
    return out[0]


def run(lib, cfg, problems, iterations):
    """The shim build's solution of ``problems`` (CPU tensors)."""
    import torch

    from kissmpc_tpu_torch.ops import ipm_fused

    N, B = cfg.horizon, problems.initial_state.shape[0]
    inp = ipm_fused.pack_inputs(cfg, problems, None, torch.float32)
    rows = [t.contiguous() for t in (inp.scal, inp.warm, inp.tx, inp.ty, inp.obinfo)]
    trips = torch.tensor([iterations], dtype=torch.int32)
    outs = [torch.empty((B, n), dtype=torch.float32) for n in (N + 1, N + 1, N + 1, N, N, 6)]
    params = ipm_fused._params(cfg, B)
    err = lib.kissmpc_ipm_fused_f32(trips.data_ptr(), *(t.data_ptr() for t in rows),
                                    *(t.data_ptr() for t in outs), ctypes.byref(params), None)
    if err != 0:
        raise SystemExit(f"fused_cpu_shim: the launcher returned {err}")
    return ipm_fused._solution(inp, *outs)


def gap(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in ((a.states, b.states), (a.controls, b.controls)))


# (N, K, elastic, affine tracks, batch, iterations of the gate, warps per
# block): ragged against the block's warps; then one horizon that takes 2
# warps per block and one that takes 1.
CASES = ((12, 0, False, False, 7, 1, 4), (12, 2, False, True, 9, 1, 4),
         (12, 2, True, True, 9, 1, 4), (12, 8, True, False, 5, 1, 4),
         (50, 8, False, True, 3, 1, 4), (300, 0, False, False, 3, 3, 2),
         (500, 2, True, True, 3, 3, 1))


def config(n, K, elastic, affine):
    from kissmpc_tpu_torch import MPCConfig

    cfg = MPCConfig(horizon=n, time_step=0.1 if n < 20 else 0.041, max_obstacles=K)
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, mu_sigma_max=0.7 if K else 0.0, fused_affine_tracks=affine,
        elastic_obstacles=elastic))


def check(lib, n, K, elastic, affine, batch, iterations, warps, report_full=True):
    """One case: the shim build against the plain version after
    ``iterations`` within 1e-4 of the solution's scale plus twice the plain
    version's own f32-vs-f64 gap, with the block's warps as expected; at
    one iteration, with ``report_full``, also the flags and controls after
    32 (printed, not gated).  Returns (ok, a line for the log)."""
    import torch

    from kissmpc_tpu_torch.ops.ipm_fused import solve_batch_fused_plain
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver.problem import Problem

    cfg = config(n, K, elastic, affine)
    pr = (obstacle_problems(cfg, batch, seed=5, n_dynamic=1, device="cpu") if K
          else free_problems(cfg, batch, seed=5, device="cpu"))
    got1 = run(lib, cfg, pr, iterations)
    ref1 = solve_batch_fused_plain(cfg, pr, iterations=iterations)
    ref64 = solve_batch_fused_plain(cfg, Problem(*(x.double() for x in pr)), iterations=iterations)
    scale = max(1.0, float(ref1.states.abs().max()), float(ref1.controls.abs().max()))
    err1, tol1 = gap(got1, ref1), 1e-4 * scale + 2.0 * gap(ref1, ref64)
    got_warps = warps_per_block(lib, cfg)
    ok = err1 <= tol1 and bool(torch.isfinite(got1.states).all()) and got_warps == warps
    line = (f"N={n} K={K} elastic={elastic} affine={affine} B={batch}, {got_warps} warps per "
            f"block (expected {warps}): {iterations} iteration(s) max|shim-plain| {err1:.3e} "
            f"(tol {tol1:.3e}) {'passes' if ok else 'FAILS'}")
    if report_full and iterations == 1:
        got, ref = run(lib, cfg, pr, 32), solve_batch_fused_plain(cfg, pr, iterations=32)
        flips = int((got.diagnostics.converged != ref.diagnostics.converged).sum())
        line += (f"; 32 iterations: flags differ on {flips} of {batch}, max|du| "
                 f"{float((got.controls - ref.controls).abs().max()):.3e}")
    return ok, line


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=("address", "thread"))
    ap.add_argument("--drop-syncwarp", action="store_true")
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
        lib = build(tmp, args.sanitize, args.drop_syncwarp)
        for case in CASES:
            ok, line = check(lib, *case)
            print(line, flush=True)
            if not ok:
                failed.append(case)
    if failed:
        raise SystemExit(
            f"fused_cpu_shim: the shim build disagrees with the plain version: {failed}")
    print(f"fused_cpu_shim: done ({args.sanitize or 'no'} sanitizer"
          f"{', __syncwarp after the condensation dropped' if args.drop_syncwarp else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
