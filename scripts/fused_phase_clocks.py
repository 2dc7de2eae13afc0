#!/usr/bin/env python3
"""Where one scenario's time goes inside the fused kernel, on one NVIDIA GPU.

    python3 scripts/fused_phase_clocks.py

The card's profilers do not run in this setting, so this script compiles a
copy of `kissmpc_tpu_torch/csrc/ipm_fused.cu` (into a temporary directory;
the checkout is left as it is) with `clock64()` read by every lane at each
phase boundary of the iteration: (a) reduce, (b) condensation, (c, d) the
thread-0 sweep and rollout, (e) fraction to the boundary, (f) the merit line
search, (g) the updates; then the KKT diagnostics.  Thread 0 of scenario 0
and of scenario B/2 store their sums in a device array that the copy
exports (at B=164 the launch takes 4 warps per scenario).
It runs k8_dyn2, k8_dyn2_elastic and free (N=50, float32) at B=8192 x 32
iterations (every SM full) and at the last refine stage, B=164 x 128 (about
one warp per SM), and prints SM cycles per iteration and each phase's
share, then one JSON line.  Cycles are the SM's own clock while the warp
was in the phase, waiting included: under load they measure what the warp
shares with the other warps of its SM.
"""

import ctypes
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("reduce", "condensation", "sweep+rollout", "fraction to boundary",
          "line search", "update", "diagnostics")
# Text before which each phase's clock is read, in order.
MARKS = ("    // --- (b) condensation", "    // --- (c) backward Riccati sweep",
         "    // --- (e) slack / dual steps", "    // --- (f) merit line search",
         "    // --- (g) updates with", "    // Grow reg on genuine",
         "  // --- outputs: each written once")
SHAPES = ((8192, 32), (164, 128))


def instrumented(text):
    """The source with the phase clocks and their exported reader."""
    def tick(k):
        return f"    {{ const long long n_ = clock64(); clk_[{k}] += n_ - t_; t_ = n_; }}\n"

    for k, mark in enumerate(MARKS):
        if text.count(mark) != 1:
            raise SystemExit(f"fused_phase_clocks: {mark!r} is not in ipm_fused.cu once")
        text = text.replace(mark, tick(k) + mark)
    start = "  float reg = p.reg, sig_c = sig_row;\n"
    end = "  const size_t bs = static_cast<size_t>(b) * T1"
    text = text.replace(start, "  long long clk_[8] = {0}, t_ = clock64();\n" + start)
    text = text.replace(end, (
        "  if (tid == 0 && (b == 0 || b == p.B / 2))\n"
        "    for (int k = 0; k < 8; ++k) kissmpc_phase_clocks[b == 0 ? 0 : 1][k] = clk_[k];\n")
        + end)
    text = text.replace("namespace {\n", "__device__ long long kissmpc_phase_clocks[2][8];\n\n"
                        "namespace {\n", 1)
    return text + (
        '\nextern "C" int kissmpc_phase_clocks_read(long long* out) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(out, kissmpc_phase_clocks,\n"
        "                                               sizeof(kissmpc_phase_clocks)));\n}\n")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_phase_clocks: CUDA is not available")

    import chip_smoke as cs
    from fused_gate_faults import build_sources, kernel_library
    from kissmpc_tpu_torch.ops.ipm_fused import SOURCE, solve_batch_fused
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    cfgs = cs.configs("fused")
    pool_obst = obstacle_problems(cfgs["k8_dyn2"], cs.BATCH, seed=0, n_dynamic=2)
    pools = {"free": free_problems(cfgs["free"], cs.BATCH, seed=0),
             "k8_dyn2": pool_obst, "k8_dyn2_elastic": pool_obst}
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        lib, = build_sources(Path(tmp), [instrumented(SOURCE.read_text())])
        lib.kissmpc_phase_clocks_read.argtypes = [ctypes.c_void_p]
        with kernel_library(lib):
            for cell in ("k8_dyn2", "k8_dyn2_elastic", "free"):
                for batch, iters in SHAPES:
                    sub = gather(pools[cell], torch.arange(batch, device="cuda"))
                    solve_batch_fused(cfgs[cell], sub, iterations=iters)
                    torch.cuda.synchronize()
                    clocks = (ctypes.c_longlong * 16)()
                    if lib.kissmpc_phase_clocks_read(clocks) != 0:
                        raise SystemExit("fused_phase_clocks: reading the clocks failed")
                    for which, scenario in enumerate((0, batch // 2)):
                        row = list(clocks[8 * which:8 * which + 7])
                        per_it = {ph: c / iters for ph, c in zip(PHASES[:-1], row[:-1])}
                        loop = sum(row[:-1])
                        results.append({"cell": cell, "B": batch, "iterations": iters,
                                        "scenario": scenario, "cycles_per_iteration": loop / iters,
                                        "phase_cycles_per_iteration": per_it,
                                        "diagnostics_cycles": row[-1]})
                        print(f"{cell:>15} B={batch:5d} x {iters:3d} it., scenario {scenario:5d}: "
                              f"{loop / iters:10.0f} cycles per iteration; " + ", ".join(
                                  f"{ph} {c / loop:.3f}" for ph, c in zip(PHASES, row[:-1])),
                              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
