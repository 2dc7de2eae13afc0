#!/usr/bin/env python3
"""The fused kernel's design choices measured against each other on one
NVIDIA GPU.

    python3 scripts/fused_design_sweep.py

`kissmpc_tpu_torch/csrc/ipm_fused.cu` is written with 4 warps (scenarios)
per block at one warp per scenario, 4 warps per scenario at small
batches, the per-time stage rows condensed in parallel before the sweep,
and the obstacle step stored once per iteration.  This script compiles
the source as written and one edited copy per alternative into a
temporary directory (the checkout is left as it is): 1, 2 and 8 warps per
block; one warp per scenario at every batch; the stage rows condensed
inside the sweep on thread 0 instead (their shared-memory rows dropped;
one warp per scenario at every batch); the obstacle step recomputed where the line
search and the update read it (its rows still written); the warps per
block a compile-time constant in the kernel body instead of read from
blockDim (the body before the launcher chose the count from the horizon).  Each build is
held to chip_smoke.py's phase-4 gates in free, k8_dyn2 and k8_dyn2_elastic
(N=50, B=8192, float32), then timed through the wrapper with CUDA events at
every solve stage's (B, iterations) of one `solve_batch` call of those
cells and of one fleet tick, the builds taken in turns, forward, backward,
forward, backward.  It prints, per build and cell, the median over the
turns of the call's summed stage times with their range, then one JSON
line, and exits non-zero if a build fails a gate.
"""

import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WARPS = "constexpr int kWarps = 4;"
# The launcher's width rule, edited to take one warp per scenario at every batch.
ONE_WARP = ("  if (wide <= static_cast<size_t>(optin)) {\n", "  if (false) {\n", 1)
# name -> [(text of ipm_fused.cu, its replacement, occurrences)].
VARIANTS = {
    "as written (W=4)": [],
    **{f"W={w}": [(WARPS, f"constexpr int kWarps = {w};", 1)] for w in (1, 2, 8)},
    "one warp per scenario at every batch": [ONE_WARP],
    # At one warp per scenario: the wide instance's scratch lies past the
    # stage rows that this variant drops.
    "stage rows condensed in the sweep": [
        ONE_WARP,
        ("  const int sweep = 8 * N + 11 * N + 7 * T1;\n", "  const int sweep = 8 * N;\n", 1),
        ("    for (int t = tid; t < T1; t += NT) {\n      if (!kWide && t < N) dyn_ctrl_rows(t);\n",
         "    if (false)  // condensed inside the sweep instead\n"
         "    for (int t = tid; t < T1; t += NT) {\n      if (!kWide && t < N) dyn_ctrl_rows(t);\n",
         1),
        ("dyn_at(t)", "dyn(t)", 2),
        ("ctrl_at(t)", "ctrl_stage(t, mu, reg)", 1),
        ("state_at(N)", "state_stage(N, mu, reg)", 1),
        ("state_at(t)", "state_stage(t, mu, reg)", 1),
    ],
    "obstacle step recomputed": [
        ("const ObStep st = ob_step_now(r, mu);", "const ObStep st = ob_step(r, mu);", 2),
    ],
    # The kernel body before the launcher chose the warps per block: the
    # count a constant, as every N=50 launch takes it.
    "warps a constant (no blockDim read)": [
        ("  const int warps = static_cast<int>(blockDim.x) / kLanes;\n",
         "  const int warps = kWarps;\n", 1),
    ],
}
TURNS = 4
REPS = 3


def sources(text):
    """One source text per entry of VARIANTS."""
    out = []
    for name, edits in VARIANTS.items():
        src = text
        for old, new, count in edits:
            if src.count(old) != count:
                raise SystemExit(f"fused_design_sweep: {old!r} is not in ipm_fused.cu "
                                 f"{count} time(s) ({name})")
            src = src.replace(old, new)
        out.append(src)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_design_sweep: CUDA is not available")

    import chip_smoke as cs
    from fused_gate_faults import build_sources, kernel_library
    from kissmpc_tpu_torch.ops.ipm_fused import SOURCE, solve_batch_fused
    from kissmpc_tpu_torch.scenarios import free_problems, obstacle_problems
    from kissmpc_tpu_torch.solver.problem import gather

    cfgs = cs.configs("fused")
    pool_obst = obstacle_problems(cfgs["k8_dyn2"], cs.BATCH, seed=0, n_dynamic=2)
    pools = {"free": free_problems(cfgs["free"], cs.BATCH, seed=0),
             "k8_dyn2": pool_obst, "k8_dyn2_elastic": pool_obst}
    refs = {name: cs.plain_reference(cfgs[name], pools[name]) for name in cfgs}
    cells = {name: (cfg, pools[name], cs.BATCH) for name, cfg in cfgs.items()}
    cells["fleet_b4096"] = (cs.fleet_config()[0], pool_obst, cs.FLEET_BATCH)
    results = {name: {} for name in VARIANTS}
    with tempfile.TemporaryDirectory() as tmp:
        libs = dict(zip(VARIANTS, build_sources(Path(tmp), sources(SOURCE.read_text()))))
        for name, lib in libs.items():
            with kernel_library(lib):
                for cell, cfg in cfgs.items():
                    g = cs.fused_gates(
                        refs[cell], solve_batch_fused(cfg, pools[cell], iterations=1),
                        solve_batch_fused(cfg, pools[cell], iterations=cs.FUSED_ITERATIONS),
                        1e-3 if cell == "free" else 2e-3)
                    results[name][cell] = {"ok": g["ok_one"] and g["ok_full"],
                                           "err1": g["err1"], "flips": g["flips"]}
        order = list(libs)
        for cell, (cfg, pool, size) in cells.items():
            stages = cs.stage_shapes(cfg, size)
            subs = [gather(pool, torch.arange(B, device="cuda")) for B, _, _ in stages]
            turns = {name: [] for name in order}   # per turn: [ms per stage]
            for turn in range(TURNS):
                for name in (order if turn % 2 == 0 else order[::-1]):
                    with kernel_library(libs[name]):
                        turns[name].append([cs.cuda_ms(
                            lambda: solve_batch_fused(cfg, sub, iterations=iters,
                                                      mu_sigma=mu_sigma),
                            reps=REPS, warmup=1) for sub, (_, iters, mu_sigma) in zip(subs, stages)])
            for name in order:
                sums = [sum(t) for t in turns[name]]
                r = results[name].setdefault(cell, {})
                r["stages"] = {f"{B}x{iters}": statistics.median(t[i] for t in turns[name])
                               for i, (B, iters, _) in enumerate(stages)}
                r["call_ms"] = statistics.median(sums)
                r["call_ms_range"] = [min(sums), max(sums)]
                gate = r.get("ok", True)
                print(f"{name:>33} {cell:>15}: {r['call_ms']:9.4f} ms per call "
                      f"(turns {min(sums):.4f}-{max(sums):.4f}); stages "
                      + ", ".join(f"{k} {v:.4f}" for k, v in r["stages"].items())
                      + f"; gates {'pass' if gate else 'FAIL'}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "builds": results}), flush=True)
    failed = [n for n, r in results.items() if not all(r[c]["ok"] for c in cfgs)]
    if failed:
        raise SystemExit(f"fused_design_sweep: builds fail phase 4's gates: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
